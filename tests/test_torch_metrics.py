"""The port's moment-retrieval metrics (``mr_blip_tpu_torch/metrics/``)
against the JAX package's and the committed goldens, on the CPU.

The port's numpy ``precision_recall_curve`` must equal scikit-learn's array
for array (values, dtype and shape: exact, on seeded inputs with ties), and
``eval_submission`` in both modes must give the JAX package's dict and the
goldens that ``tests/test_metrics_golden.py`` reads, exactly.
"""

import json
import pathlib

import numpy as np
import pytest
from sklearn.metrics import precision_recall_curve as sk_precision_recall_curve

from mr_blip_tpu.metrics import moment_retrieval as jmr
from mr_blip_tpu.metrics import simple as jsimple
from mr_blip_tpu.metrics import span_ops as jspan
from mr_blip_tpu_torch.metrics import moment_retrieval as tmr
from mr_blip_tpu_torch.metrics import simple as tsimple
from mr_blip_tpu_torch.metrics import span_ops as tspan

GOLDEN = pathlib.Path(__file__).parent / "data" / "golden"


def _canon(obj):
    return json.loads(json.dumps(obj, default=float))


def _labels_and_scores(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 60))
    y = rng.integers(0, 2, n)
    if seed % 3 == 0:  # many ties
        s = rng.integers(0, 4, n).astype(np.float64)
    elif seed % 3 == 1:
        s = rng.random(n)
    else:  # ties and float32 scores
        s = np.round(rng.random(n), 1).astype(np.float32)
    return y, s


@pytest.mark.parametrize("seed", range(12))
def test_precision_recall_curve_equals_sklearn(seed):
    y, s = _labels_and_scores(seed)
    if len(set(y.tolist())) == 1:
        y[0] = 1 - y[0]
    for got, want in zip(tspan.precision_recall_curve(y, s),
                         sk_precision_recall_curve(y, s)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_binary_average_precision_equals_jax(seed):
    y, s = _labels_and_scores(seed)
    for point_11 in (False, True):
        assert (tspan.binary_average_precision(y, s, point_11=point_11)
                == jspan.binary_average_precision(y, s, point_11=point_11))
    assert tspan.binary_average_precision([0, 0], [0.1, 0.2]) == 0
    assert tspan.binary_average_precision([1, 1], [0.1, 0.2]) == 1


def test_span_primitives_equal_jax():
    rng = np.random.default_rng(3)
    a = np.sort(rng.random((7, 2)) * 30, axis=1)
    b = np.sort(rng.random((5, 2)) * 30, axis=1)
    np.testing.assert_array_equal(tspan.temporal_iou_paired(a[:5], b),
                                  jspan.temporal_iou_paired(a[:5], b))
    for got, want in zip(tspan.temporal_iou_cross(a, b), jspan.temporal_iou_cross(a, b)):
        np.testing.assert_array_equal(got, want)
    gt = [{"video-id": f"v{i % 3}", "t-start": float(x), "t-end": float(y)}
          for i, (x, y) in enumerate(b)]
    pred = [{"video-id": f"v{i % 3}", "t-start": float(x), "t-end": float(y),
             "score": float(i)} for i, (x, y) in enumerate(a)]
    for scored in (False, True):
        np.testing.assert_array_equal(
            tspan.average_precision_detection(gt, pred, sort_by_score=scored),
            jspan.average_precision_detection(gt, pred, sort_by_score=scored))
    sub = [{"pred_relevant_windows": [[0.0, 5.0], [6.0, 9.0]],
            "relevant_windows": [[1.0, 5.0]]},
           {"pred_relevant_windows": [[-1, -1]], "relevant_windows": [[2.0, 3.0]]}]
    assert tsimple.r1_and_mIoU(sub) == jsimple.r1_and_mIoU(sub)


@pytest.mark.parametrize("name", ["qvh", "qvh_nosal"])
def test_qvh_mode_equals_jax_and_golden(name):
    sub = tmr.load_jsonl(GOLDEN / f"{name}_submission.jsonl")
    gt = tmr.load_jsonl(GOLDEN / f"{name}_gt.jsonl")
    got = _canon(tmr.eval_submission(sub, gt, verbose=False, mode="qvh"))
    assert got == _canon(jmr.eval_submission(sub, gt, verbose=False, mode="qvh"))
    assert got == json.load(open(GOLDEN / f"{name}_expected.json"))


def test_intrain_mode_equals_jax_and_golden():
    results = tmr.load_jsonl(GOLDEN / "intrain_results.jsonl")
    got = _canon(tmr.eval_submission(results, results, verbose=False, mode="intrain"))
    assert got == _canon(jmr.eval_submission(results, results, verbose=False,
                                             mode="intrain"))
    assert got == json.load(open(GOLDEN / "intrain_expected.json"))


def test_intrain_mode_all_invalid():
    """What the evaluation of random weights scores: every span invalid."""
    results = [{"qid": f"q{i}", "pred_relevant_windows": [[-1, -1]],
                "relevant_windows": [[float(i), float(i) + 2.5]]} for i in range(8)]
    got = tmr.eval_submission(results, results, verbose=False, mode="intrain")
    assert _canon(got) == _canon(jmr.eval_submission(results, results, verbose=False,
                                                     mode="intrain"))
    assert got["brief"]["MR-full-invalid_pred_num"] == 8
    assert got["brief"]["MR-full-R1-avg"] == 0.0
