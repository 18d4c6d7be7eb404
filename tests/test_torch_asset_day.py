"""The port's offline scorer, metric gates and asset-day chain, on the CPU.

``python -m mr_blip_tpu_torch.standalone_eval`` reproduces the committed
goldens of ``tests/data/golden/`` exactly and the JAX CLI's file
(``standalone_eval/eval.py``); ``mr_blip_tpu_torch.asset_gates`` gives
``scripts/asset_gates.py``'s verdict and printout on every case of
``tests/test_asset_gates.py``; ``python -m mr_blip_tpu_torch.asset_day``
runs its chain on reference-format checkpoints written at the tiny size (as
``tests/test_torch_port_weights.py`` writes them; the T5 directory holds the
JAX fixture's tokenizer) over a synthetic Charades-STA split: steps 1-3 pass
and the random weights end it at the metric gate.
"""

import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mr_blip_tpu_torch import asset_gates
from mr_blip_tpu_torch.datasets.synthetic import make_mr_annotations
from tests.test_torch_port_weights import (
    _eva_reference,
    _hf_t5,
    _prefixed,
    _qformer_reference,
    _write_shards,
)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "data" / "golden"
FIXTURE_T5 = REPO / "tests" / "data" / "torch_tokenizer" / "fixture_t5"

_spec = importlib.util.spec_from_file_location("jax_asset_gates",
                                               REPO / "scripts" / "asset_gates.py")
jax_gates = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_gates)


def _scorer(module_or_script, name, out):
    args = ["--submission_path", str(GOLDEN / f"{name}_submission.jsonl"),
            "--gt_path", str(GOLDEN / f"{name}_gt.jsonl"), "--save_path", str(out),
            "--not_verbose"]
    head = ([sys.executable, "-m", module_or_script] if "." in module_or_script
            and not module_or_script.endswith(".py") else [sys.executable, module_or_script])
    return subprocess.Popen(head + args, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def test_scorer_cli_reproduces_goldens_and_the_jax_cli(tmp_path):
    procs = {("port", name): _scorer("mr_blip_tpu_torch.standalone_eval", name,
                                     tmp_path / f"port_{name}.json")
             for name in ("qvh", "qvh_nosal")}
    procs["jax", "qvh_nosal"] = _scorer("standalone_eval/eval.py", "qvh_nosal",
                                        tmp_path / "jax_qvh_nosal.json")
    for key, proc in procs.items():
        _, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, (key, err[-2000:])
    for name in ("qvh", "qvh_nosal"):
        got = (tmp_path / f"port_{name}.json").read_text()
        assert json.loads(got) == json.loads((GOLDEN / f"{name}_expected.json").read_text())
    assert ((tmp_path / "port_qvh_nosal.json").read_text()
            == (tmp_path / "jax_qvh_nosal.json").read_text())


def _write_eval(tmp_path, tag, r1_05, r1_07, miou_frac, invalid=0.001):
    """``tests/test_asset_gates.py``'s log.txt, with the config dump that
    precedes a training run's metrics."""
    d = tmp_path / tag / "20260820000"
    d.mkdir(parents=True)
    row = {"test_agg_metrics": 52.1, "test_r1": {"0.5": r1_05, "0.55": 65.0, "0.7": r1_07},
           "test_mIoU": miou_frac, "test_invalid_predictions": invalid, "test_total": 3720}
    (d / "log.txt").write_text(json.dumps(row) + "\n")
    return str(tmp_path / tag)


GATE_CASES = {
    "read_parses_and_normalizes": ("read", [(69.4, 49.5, 0.587)]),
    "read_points_scale_miou": ("read", [(69.4, 49.5, 58.7)]),
    "read_empty_dir": ("read", []),
    "baseline_pass_within_tolerance": ("baseline", [(69.4, 48.5, 0.582)]),
    "baseline_fail_below_tolerance": ("baseline", [(67.0, 49.5, 0.587)]),
    "baseline_fail_on_missing": ("baseline", []),
    "int8_pass_small_drift": ("int8", [(69.4, 49.5, 0.587), (69.1, 49.2, 0.584)]),
    "int8_fail_large_drift": ("int8", [(69.4, 49.5, 0.587), (68.0, 49.2, 0.584)]),
    "int8_fail_invalid_rise": ("int8", [(69.4, 49.5, 0.587, 0.001),
                                        (69.4, 49.5, 0.587, 0.01)]),
    "int8_better_is_fine": ("int8", [(69.4, 49.5, 0.587), (70.0, 50.0, 0.60)]),
}
GATE_VERDICTS = {"baseline_pass_within_tolerance": True, "baseline_fail_below_tolerance": False,
                 "baseline_fail_on_missing": False, "int8_pass_small_drift": True,
                 "int8_fail_large_drift": False, "int8_fail_invalid_rise": False,
                 "int8_better_is_fine": True}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gates_equal_the_jax_script(tmp_path, capsys, case):
    kind, rows = GATE_CASES[case]
    dirs = [_write_eval(tmp_path, f"e{i}", *row) for i, row in enumerate(rows)]
    results = []
    for gates in (jax_gates, asset_gates):
        if kind == "read":
            results.append(gates.read_metrics(dirs[0] if dirs else str(tmp_path / "nope")))
        elif kind == "baseline":
            results.append(gates.gate_baseline(dirs[0] if dirs else str(tmp_path / "nope"), 1.0))
        else:
            results.append(gates.gate_int8(*dirs))
        results.append(capsys.readouterr().out)
    assert results[:2] == results[2:]
    if kind == "read" and rows:
        assert abs(results[0]["mIoU"] - 58.7) < 1e-9 and results[0]["R1@0.5"] == 69.4
    if case in GATE_VERDICTS:
        assert results[0] is GATE_VERDICTS[case]


def test_gates_cli_exit_codes(tmp_path):
    d = _write_eval(tmp_path, "e", 69.4, 49.5, 0.587)
    b = _write_eval(tmp_path, "b", 69.4, 49.5, 0.587)
    i = _write_eval(tmp_path, "i", 68.0, 49.2, 0.584)
    cases = [(["baseline", d, "1.0"], 0), (["baseline", str(tmp_path / "nope"), "1.0"], 1),
             (["int8", d, b], 0), (["int8", b, i], 1)]
    procs = [(subprocess.Popen([sys.executable, "-m", "mr_blip_tpu_torch.asset_gates", *argv],
                               cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE),
              want) for argv, want in cases]
    for proc, want in procs:
        proc.communicate(timeout=60)
        assert proc.returncode == want


TINY_EVAL = ["run.device=cpu", "run.num_workers=0", "run.batch_size_eval=2",
             "model.vit_model=tiny", "model.t5_model=tiny", "model.image_size=28",
             "model.num_query_token=4", "model.compute_dtype=float32", "model.num_beams=2",
             "model.max_new_tokens=8",
             "datasets.charades_sta.vis_processor.eval.image_size=28",
             "datasets.charades_sta.vis_processor.eval.n_frms=4",
             "datasets.charades_sta.build_info.videos.storage=synthetic"]


def _reference_files(root: Path):
    """The four reference checkpoints at the tiny size; the T5 directory
    holds two safetensors shards and the fixture tokenizer (1,280 pieces)."""
    rng = np.random.default_rng(7)
    t5 = _hf_t5(vocab_size=1280, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                num_decoder_layers=2, num_heads=4, relative_attention_num_buckets=32,
                relative_attention_max_distance=128).state_dict()
    _write_shards(root / "t5", t5)
    for f in FIXTURE_T5.iterdir():
        shutil.copy(f, root / "t5" / f.name)
    torch.save(_eva_reference(rng), root / "eva_vit_g.pth")
    blip2 = _qformer_reference(rng)
    torch.save({"model": blip2}, root / "blip2.pth")
    lora = {}
    for key, shape in _prefixed("t5_model.base_model.model", {
            "encoder.block.1.layer.1.DenseReluDense.wo.lora_A.default.weight": (8, 64),
            "encoder.block.1.layer.1.DenseReluDense.wo.lora_B.default.weight": (32, 8),
    }).items():
        lora[key] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    lora["t5_proj.weight"] = blip2["t5_proj.weight"] + 1.0
    lora["t5_proj.bias"] = blip2["t5_proj.bias"] + 1.0
    torch.save({"model": lora, "epoch": 9}, root / "checkpoint_best.pth")


def test_asset_day_chain_on_tiny_reference_files(tmp_path):
    _reference_files(tmp_path)
    make_mr_annotations(str(tmp_path / "ann"), n_train=2, n_val=2, n_test=4,
                        n_video_frames=20, height=32, width=32)
    options = TINY_EVAL + [
        f"datasets.charades_sta.build_info.annotations.{split}.storage="
        f"{tmp_path / 'ann' / f'{split}.json'}" for split in ("train", "val", "test")]
    out = tmp_path / "out"
    argv = ["--eva-vit", str(tmp_path / "eva_vit_g.pth"), "--blip2", str(tmp_path / "blip2.pth"),
            "--t5", str(tmp_path / "t5"), "--lora", str(tmp_path / "checkpoint_best.pth"),
            "--out", str(out), "--model-type", "tiny", "--device", "cpu",
            "--options", *options]
    code = ("import runpy, sys\n"
            f"sys.argv = ['asset_day'] + {argv!r}\n"
            "try:\n"
            "    runpy.run_module('mr_blip_tpu_torch.asset_day', run_name='__main__')\n"
            "finally:\n"
            "    bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', "
            "'mr_blip_tpu', 'transformers', 'tokenizers', 'sentencepiece', 'regex', "
            "'safetensors')]\n"
            "    print('FORBIDDEN', bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "FORBIDDEN []", proc.stdout[-3000:]
    assert proc.returncode == 1, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert lines[-2] == "ASSET-DAY: FAIL metric gate (see above)", proc.stdout[-3000:]
    for step in ("[1/5]", "[2/5]", "[3/5]", "[4/5]"):
        assert any(step in line for line in lines), step
    assert "answer ids [71, 272, 205, 309, 262]" in proc.stdout
    assert "tensors skipped" not in (out / "port.log").read_text()
    got = asset_gates.read_metrics(str(out / "eval_charades"))
    assert set(got) == {"R1@0.5", "R1@0.7", "mIoU", "invalid"}
    assert got["R1@0.5"] < 69.31 - 1.0
    vocab = json.loads((out / "vocab.log").read_text())
    assert vocab["failures"] == [] and vocab["annoying"] == [123, 124, 149]


def test_asset_day_refusals(tmp_path, capsys):
    from mr_blip_tpu_torch import asset_day

    assert asset_day.main(["--t5", str(tmp_path)]) == 2
    assert capsys.readouterr().out.strip().endswith(
        "ASSET-DAY: FAIL missing one of --eva-vit --blip2 --t5 --lora (see header)")
    spm = tmp_path / "spm"
    spm.mkdir()
    (spm / "spiece.model").write_bytes(b"\x00")
    args = asset_day.parse_args(["--t5", str(spm), "--out", str(tmp_path / "o")])
    with pytest.raises(asset_day.GateFailed, match="tokenizer.json"):
        (tmp_path / "o").mkdir()
        asset_day._vocab(args)
