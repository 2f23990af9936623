"""The CV checkpoint of selector/validator.py and workflow/supervisor.py of
the torch package, against the JAX package's and in its drills.

Checkpoints cross over: the port restores every row of a checkpoint the
reference's validator wrote (a GLM grid and an MLP grid), fits nothing and
gives the reference's ``ValidationResult``; the reference restores the
port's file the same way.  The supervisor drills of the JAX package's
``tests/test_preemption.py:94-192`` run on a port child on the CPU: the
redispatch after a death mid-CV reaches the uninterrupted selection, a
hung worker is killed and redispatched, restarts run out, future mtimes
clamp to zero staleness, legacy keys migrate.  Every child arms its own
120 s alarm, so no drill can hang the suite.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from torch_parity import PORT, REF, mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120


def _cv_data(n=240, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    z = X @ np.linspace(1.0, -1.0, 5)
    return X, z + 0.3 * rng.randn(n), (z + 0.5 * rng.randn(n) > 0).astype(float)


def _models(pkg):
    kw = {"device": "cpu"} if pkg == PORT else {}
    glm = mod(pkg, "models.glm").OpGeneralizedLinearRegression(max_iter=8, **kw)
    mlp = mod(pkg, "models.mlp").OpMultilayerPerceptronClassifier(max_iter=20,
                                                                  **kw)
    return glm, mlp


def _validate(pkg, est, grid, X, y, ckpt, evaluator):
    kw = {"device": "cpu"} if pkg == PORT else {}
    ev = getattr(mod(pkg, f"evaluators.{evaluator[0]}"), evaluator[1])()
    cv = mod(pkg, "selector.validator").OpCrossValidation(
        num_folds=3, evaluator=ev, seed=0, checkpoint_path=ckpt, **kw)
    return cv.validate([(est, grid)], X, y)


CASES = {
    "glm": (0, [{"reg_param": r} for r in (0.0, 0.01, 0.3)],
            ("regression", "OpRegressionEvaluator")),
    "mlp": (1, [{"hidden_layers": (4,)}, {"hidden_layers": (3, 3)}],
            ("binary", "OpBinaryClassificationEvaluator")),
}


def _view(res):
    return (res.best_params, res.best_metric,
            [(r["model_type"], r["params"], r["fold_metrics"])
             for r in res.all_results])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)])
def test_each_package_restores_the_others_checkpoint(case, writer, reader,
                                                     tmp_path, monkeypatch):
    i, grid, evaluator = CASES[case]
    X, yr, yb = _cv_data()
    y = yr if case == "glm" else yb
    ckpt = str(tmp_path / "cv.json")
    written = _validate(writer, _models(writer)[i], grid, X, y, ckpt,
                        evaluator)
    with open(ckpt) as f:
        keys = sorted(json.load(f))
    assert len(keys) == len(grid) and all(k.endswith(":exact") for k in keys)
    assert os.path.exists(ckpt + ".heartbeat")
    est = _models(reader)[i]

    def no_fit(*args, **kw):
        raise AssertionError("a restored candidate was refitted")

    monkeypatch.setattr(type(est), "fit_arrays_folds", no_fit)
    monkeypatch.setattr(type(est), "fit_arrays", no_fit)
    restored = _validate(reader, est, grid, X, y, ckpt, evaluator)
    assert _view(restored) == _view(written)


def test_checkpoint_rows_equal_an_uncheckpointed_run(tmp_path):
    """Checkpointing changes no metric: a run with a checkpoint path and
    one without give the same result, and the file holds every row."""
    X, y, _ = _cv_data()
    _, grid, ev = CASES["glm"]
    with_ckpt = _validate(PORT, _models(PORT)[0], grid, X, y,
                          str(tmp_path / "a.json"), ev)
    without = _validate(PORT, _models(PORT)[0], grid, X, y, None, ev)
    assert _view(with_ckpt) == _view(without)
    assert not os.path.exists(str(tmp_path / "a.json.tmp"))


WORKER = """
import json, os, signal, sys, time
signal.alarm({timeout})  # this child's own limit: no drill hangs the suite
# hang mode wedges before the heavy imports, beating once first: the
# supervisor must detect it by the heartbeat's staleness
if {mode!r} == "hang" and not os.path.exists({marker!r}):
    open({marker!r}, "w").close()
    with open({ckpt!r} + ".heartbeat", "w") as f:
        f.write("beat")
    time.sleep({timeout})
sys.modules["jax"] = None  # the port child never needs jax
sys.path.insert(0, {repo!r})
import numpy as np
from transmogrifai_tpu_torch.evaluators.regression import OpRegressionEvaluator
from transmogrifai_tpu_torch.models.glm import OpGeneralizedLinearRegression
from transmogrifai_tpu_torch.selector.validator import (
    OpCrossValidation, OpValidator)

ckpt, marker, mode = {ckpt!r}, {marker!r}, {mode!r}


class SlowGLM(OpGeneralizedLinearRegression):
    model_type = "SlowGLM"

    def fit_arrays_folds(self, X, y, W):
        time.sleep(0.05)
        return super().fit_arrays_folds(X, y, W)


if mode == "die" and not os.path.exists(marker):
    # first attempt: a hard death after the 3rd checkpointed row
    open(marker, "w").close()
    orig = OpValidator._ckpt_save
    state = {{"n": 0}}

    def dying(self, done):
        orig(self, done)
        state["n"] += 1
        if state["n"] >= 3:
            os._exit(9)

    OpValidator._ckpt_save = dying

rng = np.random.RandomState(0)
n = 400
X = rng.randn(n, 5)
y = X @ np.linspace(1.0, -1.0, 5) + 0.3 * rng.randn(n)
grid = [{{"reg_param": r}} for r in (0.0, 0.001, 0.01, 0.1, 0.3, 1.0)]
cv = OpCrossValidation(num_folds=3, evaluator=OpRegressionEvaluator(),
                       seed=0, checkpoint_path=ckpt, device="cpu")
res = cv.validate([(SlowGLM(max_iter=8, device="cpu"), grid)], X, y)
with open({out!r}, "w") as f:
    json.dump({{"best_params": res.best_params,
               "best_metric": res.best_metric,
               "all": [(r["params"], r["fold_metrics"])
                       for r in res.all_results]}}, f)
"""


def _write_worker(tmp_path, name, mode):
    ckpt = str(tmp_path / f"{name}.ckpt.json")
    marker = str(tmp_path / f"{name}.died")
    out = str(tmp_path / f"{name}.result.json")
    script = tmp_path / f"{name}.py"
    script.write_text(WORKER.format(repo=REPO, ckpt=ckpt, marker=marker,
                                    mode=mode, out=out,
                                    timeout=CHILD_TIMEOUT_S))
    return str(script), ckpt, marker, out


def _supervisor():
    return mod(PORT, "workflow.supervisor")


def test_supervisor_redispatches_after_mid_cv_death(tmp_path):
    script_b, _, _, out_b = _write_worker(tmp_path, "baseline", "never")
    subprocess.run([sys.executable, script_b], check=True,
                   timeout=CHILD_TIMEOUT_S)
    baseline = json.load(open(out_b))
    script, ckpt, marker, out = _write_worker(tmp_path, "dying", "die")
    res = _supervisor().supervise(
        [sys.executable, script], heartbeat_path=ckpt + ".heartbeat",
        stale_after_s=60.0, max_restarts=2, backoff_base_s=0.05)
    assert res.returncode == 0
    assert res.attempts == 2, res.restarts  # died once, resumed once
    assert os.path.exists(marker)
    got = json.load(open(out))
    assert got["best_params"] == baseline["best_params"]
    assert got["best_metric"] == pytest.approx(baseline["best_metric"])
    for (p1, m1), (p2, m2) in zip(got["all"], baseline["all"]):
        assert p1 == p2
        np.testing.assert_allclose(m1, m2)
    assert len(json.load(open(ckpt))) == 6


def test_supervisor_kills_hung_worker_and_redispatches(tmp_path):
    script, ckpt, marker, out = _write_worker(tmp_path, "hung", "hang")
    t0 = time.monotonic()
    res = _supervisor().supervise(
        [sys.executable, script], heartbeat_path=ckpt + ".heartbeat",
        stale_after_s=4.0, grace_s=60.0, max_restarts=1, poll_s=0.2,
        backoff_base_s=0.05)
    assert res.returncode == 0
    assert res.attempts == 2
    assert "stale" in res.restarts[0][1]
    assert time.monotonic() - t0 < 2 * CHILD_TIMEOUT_S
    assert os.path.exists(out)


def test_supervisor_exhausts_restarts_and_fails_fast(tmp_path):
    sup = _supervisor()
    hb = str(tmp_path / "hb")
    cmd = [sys.executable, "-c", "import sys; sys.exit(3)"]
    with pytest.raises(RuntimeError, match="after 2 attempts"):
        sup.supervise(cmd, heartbeat_path=hb, stale_after_s=30.0,
                      max_restarts=1, poll_s=0.1, backoff_base_s=0.01)
    with pytest.raises(RuntimeError, match="fail-fast"):
        sup.supervise(cmd, heartbeat_path=hb, stale_after_s=30.0,
                      max_restarts=5, poll_s=0.1, backoff_base_s=0.01,
                      fail_fast_identical=2)


def test_injected_child_kill_redispatches(tmp_path):
    """The ``supervisor.child_kill`` fault point kills the first attempt;
    the second runs to its end."""
    faults = mod(PORT, "faults")
    faults.configure("supervisor.child_kill:on=1")
    try:
        res = _supervisor().supervise(
            [sys.executable, "-c", "import time; time.sleep(1)"],
            heartbeat_path=str(tmp_path / "hb"), stale_after_s=30.0,
            grace_s=30.0, max_restarts=1, poll_s=0.05, backoff_base_s=0.01)
    finally:
        faults.reset()
    assert res.returncode == 0 and res.attempts == 2
    assert "injected" in res.restarts[0][1]


def test_staleness_clamps_future_mtimes_to_zero(tmp_path):
    sup = _supervisor()
    hb = str(tmp_path / "hb")
    sup.beat(hb)
    future = time.time() + 120.0
    os.utime(hb, (future, future))
    assert sup.staleness(hb) == 0.0
    assert sup.staleness(str(tmp_path / "never-beat")) is None


def test_backoff_matches_reference():
    import random

    ref = mod(REF, "workflow.supervisor")
    for i in range(5):
        assert _supervisor().backoff_delay_s(
            i, 0.5, 4.0, 0.1, random.Random(3)) == ref.backoff_delay_s(
            i, 0.5, 4.0, 0.1, random.Random(3))


def test_legacy_checkpoint_keys_migrate(tmp_path):
    ckpt = tmp_path / "legacy.json"
    legacy_key = 'OpLinearRegression:{"reg_param": 0.1}'
    ckpt.write_text(json.dumps({legacy_key: [0.5, 0.6, 0.7]}))
    cv = mod(PORT, "selector.validator").OpCrossValidation(
        num_folds=3, evaluator=mod(PORT, "evaluators.regression")
        .OpRegressionEvaluator(), checkpoint_path=str(ckpt), device="cpu")
    done = cv._ckpt_load()
    assert done == {legacy_key + ":exact": [0.5, 0.6, 0.7]}
    ckpt.write_text("{torn")
    assert cv._ckpt_load() == {}
