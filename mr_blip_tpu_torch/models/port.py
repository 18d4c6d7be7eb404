"""The reference's PyTorch checkpoints -> the port's ``state_dict`` names
(counterpart of the checkpoint half of ``mr_blip_tpu/models/port.py``).

The reference's pretrained sources (blip2_mr.py:1466-1495, blip2.py:86-104,
eva_vit.py:429-436) and its finetuned checkpoint:

* EVA ViT-g (LAVIS ``eva_vit_g.pth``)                    -> ``visual_encoder.*``
* BLIP-2 stage 2 (``Qformer.*``, ``query_tokens``,
  ``ln_vision``, ``t5_proj``)                            -> ``qformer.*``, ...
* HF Flan-T5 (a directory of ``.safetensors`` or ``.bin``
  shards, or one state file)                             -> ``t5.*``
* HF OPT (``OPTForCausalLM``)                            -> ``opt.*``
* PEFT LoRA adapters / the finetuned ``checkpoint_best.pth``
  (``t5_model.``/``answerer_model.`` prefixes)           -> ``t5.*`` / ``answerer_t5.*``

Each ``port_*`` function takes a name -> tensor dict and returns the port's
names relative to the subtree (``merge_subtree`` grafts them in). Tensors
keep their dtype: the port's ``nn.Linear`` layout is torch's (out, in), so
only the LoRA factors are transposed, to the (in, r) / (r, out) layout of
``layers.Dense``. Files are read without ``safetensors``, ``transformers``
or ``peft``: ``read_safetensors`` parses the format itself, and ``torch.load``
runs with ``weights_only=True``.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Dict

import torch

StateDict = Dict[str, torch.Tensor]


def _blocks(sd: StateDict, pattern: str):
    """Sorted ints captured by ``pattern`` (one group) over the keys."""
    rx = re.compile(pattern)
    return sorted({int(m.group(1)) for k in sd if (m := rx.match(k))})


def port_eva_vit(state_dict: StateDict) -> StateDict:
    """LAVIS EVA ViT-g state dict -> ``EvaViT`` names (the patch conv is
    OIHW in both)."""
    sd = state_dict
    out = {name: sd[name] for name in ("cls_token", "pos_embed")}
    out["patch_embed.weight"] = sd["patch_embed.proj.weight"]
    out["patch_embed.bias"] = sd["patch_embed.proj.bias"]
    for i in _blocks(sd, r"blocks\.(\d+)\."):
        p = f"blocks.{i}."
        for name in ("norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.q_bias",
                     "attn.v_bias", "attn.proj.weight", "attn.proj.bias", "norm2.weight",
                     "norm2.bias", "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight",
                     "mlp.fc2.bias"):
            out[p + name] = sd[p + name]
    return out


def port_qformer(state_dict: StateDict, prefix: str = "Qformer.") -> StateDict:
    """BLIP-2 Q-Former (the query path; the text stream is not read) ->
    ``QFormer`` names, ``query_tokens`` included when present."""
    sd = state_dict
    out = {}
    if "query_tokens" in sd:
        out["query_tokens"] = sd["query_tokens"]
    emb = prefix + "bert.embeddings.LayerNorm."
    if emb + "weight" in sd:
        out["embeddings_norm.weight"] = sd[emb + "weight"]
        out["embeddings_norm.bias"] = sd[emb + "bias"]
    for i in _blocks(sd, re.escape(prefix) + r"bert\.encoder\.layer\.(\d+)\."):
        p, b = f"{prefix}bert.encoder.layer.{i}.", f"layer.{i}."
        attention = [("attention", "self_attention")]
        if p + "crossattention.self.query.weight" in sd:
            attention.append(("crossattention", "cross_attention"))
        for src, dst in attention:
            for leaf in ("weight", "bias"):
                for proj in ("query", "key", "value"):
                    out[f"{b}{dst}.{proj}.{leaf}"] = sd[f"{p}{src}.self.{proj}.{leaf}"]
                out[f"{b}{dst}.output.{leaf}"] = sd[f"{p}{src}.output.dense.{leaf}"]
                out[f"{b}{dst}.output_norm.{leaf}"] = sd[f"{p}{src}.output.LayerNorm.{leaf}"]
        for leaf in ("weight", "bias"):
            out[f"{b}intermediate_query.{leaf}"] = sd[f"{p}intermediate_query.dense.{leaf}"]
            out[f"{b}output_query.{leaf}"] = sd[f"{p}output_query.dense.{leaf}"]
            out[f"{b}output_query_norm.{leaf}"] = sd[f"{p}output_query.LayerNorm.{leaf}"]
    return out


def port_t5_hf(state_dict: StateDict) -> StateDict:
    """HF ``T5ForConditionalGeneration`` state dict -> ``T5ForConditionalGeneration``
    names; the FFN's ``wi`` or ``wi_0``/``wi_1``, as the checkpoint has them;
    ``lm_head`` when the head is untied."""
    sd = state_dict
    out = {"shared.weight": sd["shared.weight"]}
    if "lm_head.weight" in sd:
        out["lm_head.weight"] = sd["lm_head.weight"]
    for side in ("encoder", "decoder"):
        for i in _blocks(sd, rf"{side}\.block\.(\d+)\."):
            p, b = f"{side}.block.{i}.", f"{side}.block.{i}."
            for w in "qkvo":
                out[f"{b}self_attention.{w}.weight"] = sd[f"{p}layer.0.SelfAttention.{w}.weight"]
            out[b + "self_attn_norm.weight"] = sd[p + "layer.0.layer_norm.weight"]
            if i == 0:
                out[f"{side}.rel_bias.rel_embedding"] = sd[
                    p + "layer.0.SelfAttention.relative_attention_bias.weight"]
            li = 1
            if side == "decoder":
                for w in "qkvo":
                    out[f"{b}cross_attention.{w}.weight"] = sd[
                        f"{p}layer.1.EncDecAttention.{w}.weight"]
                out[b + "cross_attn_norm.weight"] = sd[p + "layer.1.layer_norm.weight"]
                li = 2
            ff = f"{p}layer.{li}.DenseReluDense."
            for w in ("wi_0", "wi_1", "wi", "wo"):
                if f"{ff}{w}.weight" in sd:
                    out[f"{b}ff.{w}.weight"] = sd[f"{ff}{w}.weight"]
            out[b + "ff_norm.weight"] = sd[f"{p}layer.{li}.layer_norm.weight"]
        out[f"{side}.final_norm.weight"] = sd[f"{side}.final_layer_norm.weight"]
    return out


def port_opt_hf(state_dict: StateDict) -> StateDict:
    """HF ``OPTForCausalLM`` state dict -> ``OPTForCausalLM`` names: the
    embeddings (the position table with its offset-2 rows), the pre-LNs,
    q/k/v/out projections, the ReLU FFN and the final LayerNorm. The LM head
    is tied to the token embedding in both, so ``lm_head.weight`` is not read."""
    sd, pre = state_dict, "model.decoder."
    out = {"embed_tokens.weight": sd[pre + "embed_tokens.weight"],
           "embed_positions.weight": sd[pre + "embed_positions.weight"],
           "final_norm.weight": sd[pre + "final_layer_norm.weight"],
           "final_norm.bias": sd[pre + "final_layer_norm.bias"]}
    for i in _blocks(sd, re.escape(pre) + r"layers\.(\d+)\."):
        p, b = f"{pre}layers.{i}.", f"layers.{i}."
        for leaf in ("weight", "bias"):
            for w in ("q_proj", "k_proj", "v_proj", "out_proj"):
                out[f"{b}self_attn.{w}.{leaf}"] = sd[f"{p}self_attn.{w}.{leaf}"]
            out[f"{b}self_attn_norm.{leaf}"] = sd[f"{p}self_attn_layer_norm.{leaf}"]
            out[f"{b}final_norm.{leaf}"] = sd[f"{p}final_layer_norm.{leaf}"]
            for w in ("fc1", "fc2"):
                out[f"{b}{w}.{leaf}"] = sd[f"{p}{w}.{leaf}"]
    return out


# HF T5 submodule -> the port's module name (see port_t5_hf).
_T5_LORA_MODULES = {"SelfAttention": "self_attention",
                    "EncDecAttention": "cross_attention",
                    "DenseReluDense": "ff"}


def _t5_lora_path(hf_path: str) -> str | None:
    """``encoder.block.0.layer.0.SelfAttention.q`` -> ``encoder.block.0.
    self_attention.q``; None for a module that carries no LoRA here."""
    if hf_path == "lm_head":
        return "lm_head"
    m = re.match(
        r"(encoder|decoder)\.block\.(\d+)\.layer\.\d+\.(\w+)\.(q|k|v|o|wi|wi_0|wi_1|wo)$",
        hf_path)
    if not m:
        return None
    side, block, module, leaf = m.groups()
    name = _T5_LORA_MODULES.get(module)
    return None if name is None else f"{side}.block.{block}.{name}.{leaf}"


def port_lora_peft(state_dict: StateDict) -> StateDict:
    """PEFT LoRA tensors -> ``lora_a`` (in, r) / ``lora_b`` (r, out) under
    the T5's names. Keys like ``[t5_model.]base_model.model.encoder.block.0.
    layer.0.SelfAttention.q.lora_A[.default].weight`` (peft's adapter name
    between ``lora_A`` and ``weight`` optional, with or without the
    ``t5_model.`` prefix of the finetuned checkpoint)."""
    pat = re.compile(
        r"(?:^|\.)((?:encoder|decoder)\.block\.\d+\.layer\.\d+\.\w+\.\w+|lm_head)"
        r"\.lora_(A|B)(?:\.[\w-]+)?\.weight$")
    out = {}
    for key, value in state_dict.items():
        m = pat.search(key)
        if not m:
            continue
        path = _t5_lora_path(m.group(1))
        if path is None:
            logging.warning("port_lora_peft: no site for %s", key)
            continue
        out[f"{path}.lora_{m.group(2).lower()}"] = value.t().contiguous()
    return out


def port_mr_finetuned(state_dict: StateDict) -> StateDict:
    """The reference's finetuned ``BLIP2_MR`` checkpoint (its trainable
    tensors only, runner_base.py:572-600: the LoRA of ``t5_model.`` and
    ``answerer_model.``, the Q-Former unless frozen, ``t5_proj``,
    ``query_tokens``) -> names at the model's level (``qformer.*``,
    ``t5.*``, ``answerer_t5.*``, ``t5_proj.*``, ``ln_vision.*``)."""
    out = {f"qformer.{k}": v for k, v in port_qformer(state_dict).items()}
    answerer = {k: v for k, v in state_dict.items() if k.startswith("answerer_model.")}
    main = {k: v for k, v in state_dict.items() if not k.startswith("answerer_model.")}
    out.update({f"t5.{k}": v for k, v in port_lora_peft(main).items()})
    out.update({f"answerer_t5.{k}": v for k, v in port_lora_peft(answerer).items()})
    for name in ("t5_proj", "ln_vision"):
        if f"{name}.weight" in state_dict:
            out[f"{name}.weight"] = state_dict[f"{name}.weight"]
            out[f"{name}.bias"] = state_dict[f"{name}.bias"]
    return out


def merge_subtree(state_dict: StateDict, subtree: StateDict, at: str) -> StateDict:
    """``state_dict`` with ``subtree`` grafted at the prefix ``at`` (e.g.
    ``"t5"``, ``"visual_encoder"``, ``""`` for the model's level): every
    tensor whose name and shape the target has replaces it, cast to the
    target's dtype; the others are skipped and logged (non-strict, as the
    reference loads)."""
    merged, skipped = dict(state_dict), []
    for key, value in subtree.items():
        full = f"{at}.{key}" if at else key
        target = state_dict.get(full)
        if target is None or tuple(value.shape) != tuple(target.shape):
            skipped.append((full, tuple(value.shape),
                            None if target is None else tuple(target.shape)))
            continue
        merged[full] = value.detach().to(target.dtype)
    if skipped:
        logging.warning("port: %d tensors skipped, e.g. %s", len(skipped), skipped[:3])
    logging.info("port: merged %d tensors at %r", len(subtree) - len(skipped), at)
    return merged


def port_checkpoints(state_dict: StateDict, eva_vit: StateDict | None = None,
                     blip2: StateDict | None = None, t5: StateDict | None = None,
                     finetuned: StateDict | None = None) -> StateDict:
    """A model's ``state_dict`` with every given source grafted in, in the
    reference's loading order: the EVA ViT, the BLIP-2 stage-2 checkpoint
    (its Q-Former, ``ln_vision`` and ``t5_proj``), the HF T5, then the
    finetuned checkpoint or LoRA adapters (their ``answerer_model.`` tensors
    only where the model has an answerer)."""
    params = state_dict
    if eva_vit is not None:
        params = merge_subtree(params, port_eva_vit(eva_vit), "visual_encoder")
    if blip2 is not None:
        params = merge_subtree(params, port_qformer(blip2), "qformer")
        params = merge_subtree(params, {k: v for k, v in blip2.items()
                                        if k.split(".")[0] in ("ln_vision", "t5_proj")}, "")
    if t5 is not None:
        params = merge_subtree(params, port_t5_hf(t5), "t5")
    if finetuned is not None:
        tree = port_mr_finetuned(finetuned)
        if not any(k.startswith("answerer_t5.") for k in params):
            tree = {k: v for k, v in tree.items() if not k.startswith("answerer_t5.")}
        params = merge_subtree(params, tree, "")
    return params


# safetensors dtype names -> torch dtypes.
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> StateDict:
    """A ``.safetensors`` file -> name -> CPU tensor: a little-endian u64
    header length, the JSON header, then the raw bytes, each tensor's at its
    ``data_offsets`` from the end of the header."""
    with open(path, "rb") as f:
        size = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(size))
        header.pop("__metadata__", None)
        out = {}
        for name, info in header.items():
            dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: {name} has dtype {info['dtype']}, not read")
            start, end = info["data_offsets"]
            shape = tuple(info["shape"])
            if end == start:
                out[name] = torch.empty(shape, dtype=dtype)
                continue
            f.seek(8 + size + start)
            data = bytearray(f.read(end - start))
            out[name] = torch.frombuffer(data, dtype=dtype).reshape(shape)
    return out


def load_torch_state_dict(path: str) -> StateDict:
    """A ``.safetensors``, ``.pth`` or ``.bin`` file -> name -> tensor. A
    pickle is read with ``weights_only=True``: tensors and plain containers
    only (the LAVIS runner's ``{"model", "optimizer", "config", "scaler",
    "epoch"}`` is one); a file holding other objects raises, naming them.
    ``{"model": ...}`` and ``{"state_dict": ...}`` wrappers are unwrapped."""
    if str(path).endswith(".safetensors"):
        return read_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def hf_weight_files(directory: str) -> list:
    """Every weight file of an HF model directory, in one format: the files
    of ``model.safetensors.index.json`` (or ``pytorch_model.bin.index.json``)
    where an index exists, else ``model.safetensors`` / ``pytorch_model.bin``,
    else every ``.safetensors`` (or ``.bin``) shard. Raises
    ``FileNotFoundError`` for a directory with none."""
    names = sorted(os.listdir(directory))
    for ext, single in ((".safetensors", "model.safetensors"),
                        (".bin", "pytorch_model.bin")):
        index = os.path.join(directory, single + ".index.json")
        if os.path.exists(index):
            with open(index) as f:
                files = sorted(set(json.load(f)["weight_map"].values()))
            return [os.path.join(directory, name) for name in files]
        if single in names:
            return [os.path.join(directory, single)]
        shards = [name for name in names if name.endswith(ext)]
        if shards:
            return [os.path.join(directory, name) for name in shards]
    raise FileNotFoundError(f"no .safetensors or .bin weight file in {directory}")


def load_hf_state_dict(path: str) -> StateDict:
    """An HF model directory (every shard, checked against its index) or one
    state file -> name -> tensor."""
    if not os.path.isdir(path):
        return load_torch_state_dict(path)
    out: StateDict = {}
    for name in hf_weight_files(path):
        out.update(load_torch_state_dict(name))
    for index in ("model.safetensors.index.json", "pytorch_model.bin.index.json"):
        index = os.path.join(path, index)
        if os.path.exists(index):
            with open(index) as f:
                missing = sorted(set(json.load(f)["weight_map"]) - set(out))
            if missing:
                raise ValueError(f"{path}: {len(missing)} tensors of the index not "
                                 f"found in its shards, e.g. {missing[:3]}")
            break
    return out
