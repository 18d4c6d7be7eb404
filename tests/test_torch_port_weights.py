"""The port's import of the reference's checkpoints against the JAX package's.

``mr_blip_tpu_torch/models/port.py`` maps the reference's PyTorch state
dicts (LAVIS EVA ViT-g, the BLIP-2 stage-2 Q-Former, HF T5 and OPT, PEFT
LoRA, the finetuned checkpoint) straight to the port's names; every tensor
must be bit-equal to the JAX package's ``port_*`` followed by
``convert.state_dict_from_jax`` on the same dict. The HF and PEFT models are
tiny ones built from a ``transformers`` config (no download); the EVA and
Q-Former dicts are drawn from a numpy seed. Also: the port's T5 options
(``dense_act_fn``, ``is_gated_act``, ``tie_word_embeddings``) against HF's
logits, the port's own safetensors reader, every shard of an HF directory,
and ``python -m mr_blip_tpu_torch.port_weights`` end to end.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from mr_blip_tpu.models import port as jax_port
from mr_blip_tpu_torch.models import port
from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR
from mr_blip_tpu_torch.models.convert import state_dict_from_jax
from mr_blip_tpu_torch.models.t5 import T5Config, T5ForConditionalGeneration

REPO = Path(__file__).resolve().parent.parent
T5_GEOMETRY = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                   num_decoder_layers=2, num_heads=4, relative_attention_num_buckets=8,
                   relative_attention_max_distance=16, dropout_rate=0.0)


def _hf_t5(feed_forward_proj="gated-gelu", tie=False, seed=0, **kw):
    from transformers import T5Config as HFT5Config
    from transformers import T5ForConditionalGeneration as HFT5

    cfg = HFT5Config(**dict(T5_GEOMETRY, **kw), feed_forward_proj=feed_forward_proj,
                     tie_word_embeddings=tie, decoder_start_token_id=0)
    torch.manual_seed(seed)
    return HFT5(cfg).eval()


def _jax_side(tree_at, tree, answerer=None):
    """The JAX route: a ``port_*`` subtree -> ``state_dict_from_jax``."""
    return state_dict_from_jax({tree_at: tree} if tree_at else tree, answerer)


def _assert_bit_equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key


def _prefixed(prefix, sd):
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def _eva_reference(rng, depth=2, d=32, hidden=64, tokens=5):
    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    sd = {"cls_token": draw(1, 1, d), "pos_embed": draw(1, tokens, d),
          "patch_embed.proj.weight": draw(d, 3, 14, 14), "patch_embed.proj.bias": draw(d),
          "norm.weight": draw(d), "head.weight": draw(10, d)}  # not read
    for i in range(depth):
        p = f"blocks.{i}."
        for name, shape in (("norm1.weight", (d,)), ("norm1.bias", (d,)),
                            ("attn.qkv.weight", (3 * d, d)), ("attn.q_bias", (d,)),
                            ("attn.v_bias", (d,)), ("attn.proj.weight", (d, d)),
                            ("attn.proj.bias", (d,)), ("norm2.weight", (d,)),
                            ("norm2.bias", (d,)), ("mlp.fc1.weight", (hidden, d)),
                            ("mlp.fc1.bias", (hidden,)), ("mlp.fc2.weight", (d, hidden)),
                            ("mlp.fc2.bias", (d,))):
            sd[p + name] = draw(*shape)
    return sd


def _qformer_reference(rng, layers=2, h=32, ff=64, width=32, queries=4, d_t5=32):
    """A BLIP-2 stage-2 dict: the Q-Former with its text stream (which the
    port does not read), ``query_tokens``, ``ln_vision`` and ``t5_proj``."""
    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    sd = {"query_tokens": draw(1, queries, h),
          "Qformer.bert.embeddings.LayerNorm.weight": draw(h),
          "Qformer.bert.embeddings.LayerNorm.bias": draw(h),
          "Qformer.bert.embeddings.word_embeddings.weight": draw(50, h),
          "ln_vision.weight": draw(width), "ln_vision.bias": draw(width),
          "t5_proj.weight": draw(d_t5, h), "t5_proj.bias": draw(d_t5)}
    for i in range(layers):
        p = f"Qformer.bert.encoder.layer.{i}."
        blocks = [("attention", h)] + ([("crossattention", width)] if i % 2 == 0 else [])
        for name, kv_width in blocks:
            sd[p + f"{name}.self.query.weight"] = draw(h, h)
            for proj in ("key", "value"):
                sd[p + f"{name}.self.{proj}.weight"] = draw(h, kv_width)
            for proj in ("query", "key", "value"):
                sd[p + f"{name}.self.{proj}.bias"] = draw(h)
            sd[p + f"{name}.output.dense.weight"] = draw(h, h)
            for leaf in ("output.dense.bias", "output.LayerNorm.weight",
                         "output.LayerNorm.bias"):
                sd[p + f"{name}.{leaf}"] = draw(h)
        for stream in ("intermediate", "intermediate_query"):
            sd[p + f"{stream}.dense.weight"] = draw(ff, h)
            sd[p + f"{stream}.dense.bias"] = draw(ff)
        for stream in ("output", "output_query"):
            sd[p + f"{stream}.dense.weight"] = draw(h, ff)
            for leaf in ("dense.bias", "LayerNorm.weight", "LayerNorm.bias"):
                sd[p + f"{stream}.{leaf}"] = draw(h)
    return sd


@pytest.fixture(scope="module")
def peft_sd():
    """A PEFT LoRA T5 (r=2, every Linear and the head), its LoRA factors
    redrawn so the delta is nonzero."""
    import peft

    model = _hf_t5(seed=1)
    lora_cfg = peft.LoraConfig(r=2, lora_alpha=8, lora_dropout=0.0, bias="none",
                               target_modules=["q", "k", "v", "o", "wi_0", "wi_1",
                                               "wo", "lm_head"])
    peft_model = peft.get_peft_model(model, lora_cfg).eval()
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in peft_model.named_parameters():
            if "lora_" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return {k: v.clone() for k, v in peft_model.state_dict().items() if "lora_" in k}


# ------------------------------------------------------ bit-equal to JAX's
@pytest.mark.parametrize("ffn,tie", [("gated-gelu", False), ("relu", False),
                                     ("gelu", True)])
def test_port_t5_hf_bit_equal_to_jax(ffn, tie):
    sd = _hf_t5(ffn, tie).state_dict()
    got = _prefixed("t5", port.port_t5_hf(sd))
    _assert_bit_equal(got, _jax_side("t5", jax_port.port_t5_hf(sd)))
    # a non-gated FFN's "wi" (the JAX tree's ff/wi/Dense_0) reaches the port's name
    assert ("t5.encoder.block.0.ff.wi.weight" in got) == (not ffn.startswith("gated"))


def test_port_t5_hf_keeps_bf16():
    """A bf16 source stays bf16, equal to the JAX package's fp32 copy."""
    sd = {k: v.bfloat16() for k, v in _hf_t5().state_dict().items()}
    got = _prefixed("t5", port.port_t5_hf(sd))
    want = _jax_side("t5", jax_port.port_t5_hf(sd))  # fp32 numpy on the JAX side
    assert set(got) == set(want)
    for key, value in got.items():
        assert value.dtype == torch.bfloat16
        assert torch.equal(value.float(), want[key]), key


def test_port_opt_hf_bit_equal_to_jax():
    from transformers import OPTConfig, OPTForCausalLM

    torch.manual_seed(3)
    hf = OPTForCausalLM(OPTConfig(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                                  ffn_dim=64, num_attention_heads=4,
                                  max_position_embeddings=64, word_embed_proj_dim=32,
                                  do_layer_norm_before=True)).eval()
    sd = hf.state_dict()
    got = _prefixed("opt", port.port_opt_hf(sd))
    _assert_bit_equal(got, _jax_side("opt", jax_port.port_opt_hf(sd)))
    assert "opt.layers.1.fc2.bias" in got and "opt.lm_head.weight" not in got


def test_port_eva_and_qformer_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    eva = _eva_reference(rng)
    got = _prefixed("visual_encoder", port.port_eva_vit(eva))
    _assert_bit_equal(got, _jax_side("visual_encoder", jax_port.port_eva_vit(eva)))
    assert got["visual_encoder.patch_embed.weight"].shape == (32, 3, 14, 14)
    qf = _qformer_reference(rng)
    got = _prefixed("qformer", port.port_qformer(qf))
    _assert_bit_equal(got, _jax_side("qformer", jax_port.port_qformer(qf)))
    assert "qformer.layer.0.cross_attention.key.weight" in got
    assert "qformer.layer.1.cross_attention.key.weight" not in got


def test_port_lora_peft_bit_equal_to_jax(peft_sd):
    got = _prefixed("t5", port.port_lora_peft(peft_sd))
    _assert_bit_equal(got, _jax_side("t5", jax_port.port_lora_peft(peft_sd)))
    assert len(got) == len(peft_sd)  # every factor has its site
    assert got["t5.lm_head.lora_a"].shape == (32, 2)  # (in, r)
    assert port._t5_lora_path("decoder.block.1.layer.1.EncDecAttention.k") == \
        "decoder.block.1.cross_attention.k"
    assert port._t5_lora_path("encoder.block.0.layer.0.Other.q") is None


def test_port_mr_finetuned_bit_equal_to_jax(peft_sd):
    """The finetuned checkpoint's layout: LoRA under ``t5_model.`` and
    ``answerer_model.``, the Q-Former, ``query_tokens``, ``t5_proj``,
    ``ln_vision``."""
    rng = np.random.default_rng(4)
    sd = {f"t5_model.{k}": v for k, v in peft_sd.items()}
    sd.update({f"answerer_model.{k}": v * 2 for k, v in peft_sd.items()})
    sd.update(_qformer_reference(rng))
    got = port.port_mr_finetuned(sd)
    tree = jax_port.port_mr_finetuned(sd)
    answerer = tree.pop("answerer_t5")
    _assert_bit_equal(got, state_dict_from_jax(tree, {"t5": answerer}))
    assert {k.split(".")[0] for k in got} == {"qformer", "t5", "answerer_t5", "t5_proj",
                                              "ln_vision"}


# ------------------------------------------------------- the T5's options
@pytest.mark.parametrize("ffn,tie,act,gated", [
    ("gated-gelu", False, "gelu_new", True),  # HF's gated-gelu is the tanh GELU
    ("relu", False, "relu", False),
    ("gelu", False, "gelu", False),
    ("gated-gelu", True, "gelu_new", True),
])
def test_t5_options_match_hf_logits(ffn, tie, act, gated):
    hf = _hf_t5(ffn, tie, seed=2)
    cfg = T5Config(**T5_GEOMETRY, dense_act_fn=act, is_gated_act=gated,
                   tie_word_embeddings=tie)
    model = T5ForConditionalGeneration(cfg, dtype=torch.float32).eval()
    merged = port.merge_subtree(model.state_dict(), port.port_t5_hf(hf.state_dict()), "")
    model.load_state_dict(merged)
    assert hasattr(model, "lm_head") != tie
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(3, 120, (2, 9)))
    dec = torch.from_numpy(rng.integers(3, 120, (2, 5)))
    mask = torch.ones(2, 9, dtype=torch.long)
    mask[1, 6:] = 0
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask, decoder_input_ids=dec).logits
        enc = model.encode(model.shared(ids), mask=mask)
        got = model.decode(dec, enc, encoder_mask=mask)
        step = model.decode_step(dec[:, :1], 0, model.decoder.init_cache(
            2, 5, torch.float32, "cpu"), model.decoder.cross_kv(enc), mask)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-4
    assert float((step[:, 0] - want[:, 0]).abs().max()) <= 1e-4


def test_w8a8_ffn_refuses_other_activations():
    from mr_blip_tpu_torch.models.t5 import T5FeedForward, t5_tiny_config

    for kw in (dict(is_gated_act=False), dict(dense_act_fn="relu")):
        with pytest.raises(ValueError, match="gated GELU"):
            T5FeedForward(t5_tiny_config(**kw), w8a8=True)
    model = BLIP2_MR(img_size=28, vit_model="tiny", t5_model="tiny", device="cpu")
    import dataclasses

    model.t5_config = dataclasses.replace(model.t5_config, dense_act_fn="relu")
    with pytest.raises(ValueError, match="gated GELU"):
        model.quantize_encoder()


# ---------------------------------------------------------------- files
def test_safetensors_reader_equals_the_library(tmp_path):
    from safetensors.torch import load_file, save_file

    gen = torch.Generator().manual_seed(0)
    tensors = {"a.f32": torch.randn(3, 5, generator=gen),
               "b.bf16": torch.randn(7, 2, generator=gen).bfloat16(),
               "c.f16": torch.randn(4, generator=gen).half(),
               "d.i64": torch.arange(6).reshape(2, 3),
               "e.i8": torch.arange(-3, 3, dtype=torch.int8),
               "f.empty": torch.zeros(0, 4)}
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got, want = port.read_safetensors(path), load_file(path)
    _assert_bit_equal(got, want)
    assert port.load_torch_state_dict(path).keys() == want.keys()


def _write_shards(directory: Path, sd, index=True):
    from safetensors.torch import save_file

    directory.mkdir()
    keys = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": keys[::2],
              "model-00002-of-00002.safetensors": keys[1::2]}
    for name, part in shards.items():
        save_file({k: sd[k].clone() for k in part}, str(directory / name))
    if index:
        (directory / "model.safetensors.index.json").write_text(json.dumps(
            {"metadata": {}, "weight_map": {k: n for n, part in shards.items()
                                            for k in part}}))
    (directory / "config.json").write_text("{}")


def test_hf_directory_reads_every_shard(tmp_path):
    """The JAX script reads ``sorted(cands)[0]`` of a directory
    (``scripts/port_weights.py:122-127``): half of a two-shard model. The
    port reads every shard, by the index where there is one."""
    sd = _hf_t5().state_dict()
    for index in (True, False):
        directory = tmp_path / f"t5_{index}"
        _write_shards(directory, sd, index)
        got = port.load_hf_state_dict(str(directory))
        _assert_bit_equal(got, sd)
        assert len(port.hf_weight_files(str(directory))) == 2
        cands = sorted(f.name for f in directory.iterdir()
                       if f.name.endswith((".bin", ".safetensors")))
        first_only = port.load_torch_state_dict(str(directory / cands[0]))
        assert len(first_only) < len(sd)  # what the JAX script would have read
    # an index naming a tensor no shard holds, and a directory with no weights
    index = json.loads((tmp_path / "t5_True/model.safetensors.index.json").read_text())
    index["weight_map"]["extra.weight"] = "model-00001-of-00002.safetensors"
    (tmp_path / "t5_True/model.safetensors.index.json").write_text(json.dumps(index))
    with pytest.raises(ValueError, match="not found in its shards"):
        port.load_hf_state_dict(str(tmp_path / "t5_True"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no .safetensors or .bin"):
        port.load_hf_state_dict(str(tmp_path / "empty"))


def test_torch_load_reads_the_lavis_layout_weights_only(tmp_path):
    """The LAVIS runner's checkpoint (model, optimizer, config, scaler,
    epoch: tensors and plain containers) loads with ``weights_only=True``;
    an arbitrary object is refused."""
    sd = {"t5_proj.weight": torch.ones(2, 2)}
    torch.save({"model": sd, "optimizer": {"state": {}, "param_groups": [{"lr": 1e-4}]},
                "config": {"run": {"seed": 42}}, "scaler": None, "epoch": 3},
               tmp_path / "ckpt.pth")
    _assert_bit_equal(port.load_torch_state_dict(str(tmp_path / "ckpt.pth")), sd)
    torch.save({"model": sd, "odd": Path("x")}, tmp_path / "odd.pth")
    with pytest.raises(Exception, match="weights_only"):
        port.load_torch_state_dict(str(tmp_path / "odd.pth"))


def test_port_weights_cli_writes_what_from_config_loads(tmp_path, peft_sd):
    """``python -m mr_blip_tpu_torch.port_weights --device cpu`` on the tiny
    model's four sources (a two-shard safetensors T5 directory among them),
    with no JAX, transformers, peft or safetensors imported; then
    ``from_config`` with ``pretrained`` set to its output holds every source
    tensor."""
    rng = np.random.default_rng(7)
    tiny_t5 = dict(vocab_size=4096, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                   num_decoder_layers=2, num_heads=4, relative_attention_num_buckets=32,
                   relative_attention_max_distance=128)
    t5 = _hf_t5(**tiny_t5).state_dict()
    _write_shards(tmp_path / "t5", t5)
    eva = _eva_reference(rng)
    torch.save(eva, tmp_path / "eva_vit_g.pth")
    blip2 = _qformer_reference(rng)
    torch.save({"model": blip2}, tmp_path / "blip2.pth")
    lora = {}
    for key, value in _prefixed("t5_model.base_model.model", {
            "encoder.block.1.layer.1.DenseReluDense.wo.lora_A.default.weight": (8, 64),
            "encoder.block.1.layer.1.DenseReluDense.wo.lora_B.default.weight": (32, 8),
            "decoder.block.0.layer.1.EncDecAttention.v.lora_A.default.weight": (8, 32),
            "decoder.block.0.layer.1.EncDecAttention.v.lora_B.default.weight": (32, 8),
    }).items():
        lora[key] = torch.from_numpy(rng.standard_normal(value).astype(np.float32))
        lora["answerer_model." + key[len("t5_model."):]] = lora[key] + 1.0
    lora["t5_proj.weight"] = blip2["t5_proj.weight"] + 1.0
    lora["t5_proj.bias"] = blip2["t5_proj.bias"] + 1.0
    torch.save({"model": lora, "epoch": 9}, tmp_path / "checkpoint_best.pth")
    out = tmp_path / "ported.pth"
    argv = ["--model-type", "tiny", "--device", "cpu", "--eva-vit",
            str(tmp_path / "eva_vit_g.pth"), "--blip2", str(tmp_path / "blip2.pth"),
            "--t5", str(tmp_path / "t5"), "--lora", str(tmp_path / "checkpoint_best.pth"),
            "--output", str(out)]
    code = ("import runpy, sys\n"
            f"sys.argv = ['port_weights'] + {argv!r}\n"
            "runpy.run_module('mr_blip_tpu_torch.port_weights', run_name='__main__')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', "
            "'mr_blip_tpu', 'transformers', 'peft', 'safetensors')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "inferred vocab_size=4096" in proc.stderr

    model = BLIP2_MR.from_config({"vit_model": "tiny", "t5_model": "tiny", "image_size": 28,
                                  "num_query_token": 4, "compute_dtype": "float32",
                                  "pretrained": str(out)}, device="cpu")
    got = model.state_dict()
    want = {**_prefixed("visual_encoder", port.port_eva_vit(eva)),
            **_prefixed("qformer", port.port_qformer(blip2)),
            "ln_vision.weight": blip2["ln_vision.weight"],
            "ln_vision.bias": blip2["ln_vision.bias"],
            **_prefixed("t5", port.port_t5_hf(t5)),
            **port.port_mr_finetuned({k: v for k, v in lora.items()
                                      if not k.startswith("answerer_model.")})}
    assert not any(k.startswith("answerer_t5.") for k in got)
    for key, value in want.items():
        assert torch.equal(got[key], value.to(got[key].dtype)), key
    # the finetuned projection over the stage-2 one; LoRA the source did not hold kept
    assert torch.equal(got["t5_proj.bias"], lora["t5_proj.bias"])
    assert "t5.encoder.block.0.ff.wo.lora_a" in got
    assert "t5.encoder.block.0.ff.wo.lora_a" not in want
