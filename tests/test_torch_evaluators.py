"""The multiclass and regression evaluators of the torch package against the
JAX package's: host copies, so every metric is bit-equal on the same
inputs - weighted precision, recall, F1 and error, the threshold counts
(correct, incorrect, no prediction) for top-1 and top-3 over the 101
thresholds, RMSE, MSE, R2, MAE and the log loss - and so are the
default metric and the selection direction.
"""
import numpy as np
import pytest

from torch_parity import PORT, REF, mod


def _pair(path: str, cls: str, **kw):
    return (getattr(mod(REF, path), cls)(**kw),
            getattr(mod(PORT, path), cls)(**kw))


def _pred(pkg, pred, raw=None, prob=None):
    return mod(pkg, "types.columns").PredictionColumn(pred, raw, prob)


def _classification(seed: int, n: int, K: int):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, K, n).astype(np.float64)
    logits = rng.randn(n, K) * 1.5
    logits[np.arange(n), y.astype(int)] += 1.0
    prob = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    pred = prob.argmax(axis=1).astype(np.float64)
    return y, pred, logits, prob


@pytest.mark.parametrize("seed,n,K,topns", [
    (0, 1000, 3, (1, 3)), (1, 777, 5, (1, 3)), (2, 50, 2, (1, 3)),
    (3, 400, 4, (1, 2, 3)), (4, 300, 3, (1,))])
def test_multiclass_metrics_bit_equal(seed, n, K, topns):
    y, pred, raw, prob = _classification(seed, n, K)
    if seed == 1:
        pred[::7] = K  # a class no row has: precision counts it as 0
    ref, port = _pair("evaluators.multiclass",
                      "OpMultiClassificationEvaluator", topns=topns)
    want = ref.evaluate_arrays(y, _pred(REF, pred, raw, prob)).to_json()
    got = port.evaluate_arrays(y, _pred(PORT, pred, raw, prob)).to_json()
    assert got == want
    tm = got["threshold_metrics"]
    assert len(tm["thresholds"]) == 101 and tm["topns"] == list(topns)
    for t in map(str, topns):
        total = (np.asarray(tm["correct_counts"][t])
                 + tm["incorrect_counts"][t] + tm["no_prediction_counts"][t])
        assert (total == n).all()
    assert port.metric_name == ref.metric_name == "F1"
    assert port.larger_better is ref.larger_better is True
    assert port.default_metric(
        port.evaluate_arrays(y, _pred(PORT, pred, raw, prob))) == want["F1"]


def test_multiclass_without_probabilities_has_no_threshold_metrics():
    y, pred, _, _ = _classification(5, 200, 3)
    ref, port = _pair("evaluators.multiclass",
                      "OpMultiClassificationEvaluator")
    want = ref.evaluate_arrays(y, _pred(REF, pred)).to_json()
    got = port.evaluate_arrays(y, _pred(PORT, pred)).to_json()
    assert got == want and got["threshold_metrics"] == {}


@pytest.mark.parametrize("case", ["noisy", "perfect", "constant_label"])
def test_regression_metrics_bit_equal(case):
    rng = np.random.RandomState(7)
    y = rng.randn(999) * 3.0 + 1.0
    yhat = {"noisy": y + rng.randn(999) * 0.7, "perfect": y.copy(),
            "constant_label": y + 1.0}[case]
    if case == "constant_label":
        y = np.full(999, 2.5)  # ss_tot = 0: R2 is 0
    ref, port = _pair("evaluators.regression", "OpRegressionEvaluator")
    want = ref.evaluate_arrays(y, _pred(REF, yhat)).to_json()
    got = port.evaluate_arrays(y, _pred(PORT, yhat)).to_json()
    assert got == want
    assert port.metric_name == ref.metric_name == "RootMeanSquaredError"
    assert port.larger_better is ref.larger_better is False


def test_log_loss_bit_equal():
    y, pred, raw, prob = _classification(8, 500, 4)
    prob[0] = [1.0, 0.0, 0.0, 0.0]  # a zero probability: clipped at 1e-15
    y[0] = 2.0
    ref, port = _pair("evaluators.regression", "OpLogLossEvaluator")
    want = ref.evaluate_arrays(y, _pred(REF, pred, raw, prob)).to_json()
    got = port.evaluate_arrays(y, _pred(PORT, pred, raw, prob)).to_json()
    assert got == want
    assert port.larger_better is ref.larger_better is False
    with pytest.raises(ValueError, match="needs probabilities"):
        port.evaluate_arrays(y, _pred(PORT, pred))


def test_evaluate_reads_the_dataset_columns():
    """``evaluate`` on a scored dataset: the label and prediction columns
    by name, as the workflow calls it."""
    y, pred, raw, prob = _classification(9, 300, 3)
    out = []
    for pkg in (REF, PORT):
        cols = mod(pkg, "types.columns")
        ds = mod(pkg, "types.dataset").Dataset({
            "label": cols.NumericColumn(y, np.ones(len(y), bool),
                                        mod(pkg, "types.feature_types").RealNN),
            "pred": cols.PredictionColumn(pred, raw, prob)})
        ev = mod(pkg, "evaluators.multiclass").OpMultiClassificationEvaluator()
        out.append(ev.evaluate(ds, "label", "pred").to_json())
    assert out[0] == out[1]
