"""Asset-day metric gates: the port's copy of ``scripts/asset_gates.py``
(framework-neutral), called by ``python -m mr_blip_tpu_torch.asset_day``.

    python -m mr_blip_tpu_torch.asset_gates baseline <eval_dir> <tolerance>
    python -m mr_blip_tpu_torch.asset_gates int8 <bf16_eval_dir> <int8_eval_dir>

Both read the ``log.txt`` JSON lines an evaluation writes under
``<output_dir>/<job_id>/`` (``runners/runner_base.py``):

* ``baseline``: the Charades-STA bf16 metrics against the reference's
  published numbers (``BASELINE.md``: R1@0.5 69.31, R1@0.7 49.29, mIoU
  58.63); exit 0 iff every metric is at most ``tolerance`` points below.
* ``int8``: each headline metric within 0.5 points of the bf16 run on the
  same checkpoint, and no rise in ``invalid_predictions`` (a rise means the
  decoder emits broken span strings that the span-repair grammar can hide
  in the headline metrics).
"""

import glob
import json
import sys

# Reference Charades-STA test-set numbers (BASELINE.md).
CHARADES_BASELINE = {"R1@0.5": 69.31, "R1@0.7": 49.29, "mIoU": 58.63}


def read_metrics(eval_dir):
    """{R1@0.5, R1@0.7, mIoU, invalid} from every ``log.txt`` under
    ``eval_dir/*/``. The task's metric dict keys r1 by IoU threshold ("0.5",
    "0.7"); mIoU is a fraction (the reference's script reports 0.5863),
    given here in points."""
    got = {}
    for f in sorted(glob.glob(f"{eval_dir}/*/log.txt")):
        with open(f) as lines:
            for line in lines:
                if not line.strip():
                    continue
                row = json.loads(line)
                for k, v in row.items():
                    if k.endswith("_r1") and isinstance(v, dict):
                        got["R1@0.5"] = v.get("0.5")
                        got["R1@0.7"] = v.get("0.7")
                    elif k.endswith("_mIoU"):
                        got["mIoU"] = v * 100 if v <= 1.0 else v
                    elif k.endswith("_invalid_predictions"):
                        got["invalid"] = v
    return got


def gate_baseline(eval_dir, tolerance):
    got, ok = read_metrics(eval_dir), True
    for k, want in CHARADES_BASELINE.items():
        have = got.get(k)
        status = ("MISSING" if have is None
                  else "OK" if have >= want - tolerance else "BELOW")
        print(f"  {k}: got={have} want>={want - tolerance:.2f} "
              f"({want} - {tolerance}) -> {status}")
        ok &= status == "OK"
    return ok


def gate_int8(bf16_dir, int8_dir, max_drift=0.5):
    bf16, int8 = read_metrics(bf16_dir), read_metrics(int8_dir)
    ok = True
    for k in ("R1@0.5", "R1@0.7", "mIoU"):
        if bf16.get(k) is None or int8.get(k) is None:
            print(f"  {k}: MISSING (bf16={bf16.get(k)} int8={int8.get(k)})")
            ok = False
            continue
        drift = bf16[k] - int8[k]
        good = drift <= max_drift
        print(f"  {k}: bf16={bf16[k]} int8={int8[k]} drift={drift:+.2f} "
              f"-> {'OK' if good else 'FAIL'}")
        ok &= good
    if int8.get("invalid", 0) > bf16.get("invalid", 0):
        print(f"  invalid_predictions rose: {bf16.get('invalid')} -> "
              f"{int8.get('invalid')} (decoder emitting broken spans) -> FAIL")
        ok = False
    return ok


def main(argv):
    cmd = argv[1]
    if cmd == "baseline":
        ok = gate_baseline(argv[2], float(argv[3]))
    elif cmd == "int8":
        ok = gate_int8(argv[2], argv[3])
    else:
        raise SystemExit(f"unknown gate {cmd!r}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
