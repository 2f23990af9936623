"""The serving tier of the torch package against the JAX package's.

``serving/`` (the bucketed ``CompiledEndpoint`` with its breaker and NaN
guard, the ``MicroBatchScheduler``, admission control and telemetry) is
held three ways on the CPU:

* the JAX package's own serving contracts (its tests/test_serving.py and
  the serving drills of tests/test_faults.py), run on the torch package
  with ``device="cpu"`` models;
* against the JAX package: the same fitted model (the JAX package trains
  and saves it, ``interop.load_reference_artifact`` loads it) serves rows
  through both packages' endpoints and schedulers on the numpy-fused
  route, bit-equal (tolerance 0), and the telemetry snapshots have the
  same keys;
* device faults: a fused program that raises ``KernelError`` or
  ``torch.AcceleratorError`` makes warm-up, ``score_batch``, the row
  fallback and a scheduler request raise that error itself, where an
  ordinary exception still degrades as in the JAX package; and
  ``LocalScorer``'s torch lowering lets those errors through instead of
  serving numpy-fused.

Left out: the JAX package's wall-clock floors (its RF throughput and
batch-of-1 flat-heap timings; the card phase of chip_smoke.py measures
serving there) and its CLI project-template test (``cli.py`` is not
ported).
"""
import json
import time

import numpy as np
import pytest
import torch

from torch_parity import (
    PORT,
    REF,
    mixed_pipeline,
    mod,
    reference_pair,
    reset_uids,
    tiny_pipeline,
    workflow,
)

from transmogrifai_tpu_torch.faults import injection as faults
from transmogrifai_tpu_torch.local import LocalScorer
from transmogrifai_tpu_torch.models.logistic_regression import (
    OpLogisticRegression,
)
from transmogrifai_tpu_torch.models.trees import (
    OpGBTClassifier,
    OpRandomForestClassifier,
)
from transmogrifai_tpu_torch.parallel.kernels import KernelError
from transmogrifai_tpu_torch.serving import (
    BreakerOpenError,
    CircuitBreaker,
    DeadlineExceededError,
    MicroBatchScheduler,
    QueueFullError,
    RequestTimeoutError,
    RowScoringError,
    ServingTelemetry,
    compile_endpoint,
)

DEVICE_FAULTS = [
    pytest.param(lambda: KernelError("bin_matrix kernel launch failed: "
                                     "CUDA error 700"), id="KernelError"),
    pytest.param(lambda: torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered"),
        id="AcceleratorError"),
]


@pytest.fixture(autouse=True)
def _disarm():
    faults.reset()
    yield
    faults.reset()


def _mixed(est, n=240, seed=0):
    """The JAX package's tests/test_serving.py ``_mixed_pipeline`` on the
    torch package (CPU): (model, records, prediction name)."""
    import transmogrifai_tpu_torch.dsl  # noqa: F401 - feature operators
    from transmogrifai_tpu_torch import FeatureBuilder
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.types import feature_types as ft

    rng = np.random.RandomState(seed)
    data = {
        "y": (rng.rand(n) > 0.5).astype(float).tolist(),
        "a": rng.randn(n).tolist(),
        "b": rng.uniform(0, 10, n).round(3).tolist(),
        "c": [("u", "v", "w")[i % 3] for i in range(n)],
    }
    y = FeatureBuilder(ft.RealNN, "y").as_response()
    a = FeatureBuilder(ft.Real, "a").as_predictor()
    b = FeatureBuilder(ft.Real, "b").as_predictor()
    c = FeatureBuilder(ft.PickList, "c").as_predictor()
    pred = est.set_input(y, transmogrify([a, b, c])).get_output()
    model = workflow(PORT, pred, data).train()
    records = [{"a": data["a"][i], "b": data["b"][i], "c": data["c"][i]}
               for i in range(n)]
    return model, records, pred.name


_models: dict = {}


def _trained(kind: str = "lr"):
    if kind not in _models:
        make = {"lr": lambda: OpLogisticRegression(),
                "rf": lambda: OpRandomForestClassifier(num_trees=10,
                                                       max_depth=4),
                "gbt": lambda: OpGBTClassifier(num_trees=8, max_depth=3)}
        _models[kind] = _mixed(make[kind]())
    return _models[kind]


@pytest.fixture(scope="module")
def served_model():
    """The tiny drill pipeline, trained on the torch package."""
    reset_uids(PORT)
    wf, _data, records, name = tiny_pipeline(PORT)
    return wf.train(), records, name


# -- the JAX package's serving contracts (tests/test_serving.py) -----------------

WINNERS = [
    ("lr", lambda: OpLogisticRegression(reg_param=0.01)),
    ("rf", lambda: OpRandomForestClassifier(num_trees=10, max_depth=4)),
    ("gbt", lambda: OpGBTClassifier(num_trees=8, max_depth=3)),
]


@pytest.mark.parametrize("name,make", WINNERS, ids=[w[0] for w in WINNERS])
def test_batch_of_1_vs_batch_of_n_parity(name, make):
    """Every request scores identically alone (bucket 1) or inside a full
    batch: the bucket padding is invisible (1e-9, the JAX package's)."""
    model, records, pred_name = _mixed(make())
    endpoint = compile_endpoint(model, batch_buckets=(1, 4, 16, 64))
    records = records[:50]
    batched = endpoint.score_batch(records)
    assert not any(isinstance(r, RowScoringError) for r in batched)
    singles = [endpoint(r) for r in records]
    for one, many in zip(singles, batched):
        po, pm = one[pred_name], many[pred_name]
        assert po["prediction"] == pm["prediction"]
        for k in po:
            if k.startswith("probability"):
                assert abs(po[k] - pm[k]) < 1e-9, (name, k)


def test_endpoint_warmup_primes_every_bucket():
    model, _, _ = _trained()
    endpoint = compile_endpoint(model, batch_buckets=(2, 8))
    assert endpoint.warmed_buckets == (2, 8)
    assert endpoint.warm_error is None
    assert endpoint.fused_backend == "numpy"  # a CPU model's program


def test_oversized_batch_chunks_at_largest_bucket():
    model, records, pred_name = _trained()
    endpoint = compile_endpoint(model, batch_buckets=(1, 8))
    out = endpoint.score_batch(records[:20])  # 20 > bucket max 8
    assert len(out) == 20
    ref = compile_endpoint(model, batch_buckets=(32,)).score_batch(
        records[:20])
    for a, b in zip(out, ref):
        assert a[pred_name]["prediction"] == b[pred_name]["prediction"]


def test_shape_miss_fallback_isolates_bad_rows():
    """A malformed record degrades ITS batch to the row path and comes
    back as RowScoringError without failing its batch peers."""
    model, records, pred_name = _trained()
    endpoint = compile_endpoint(model)
    good = records[:3]
    bad = {"a": object(), "b": 1.0, "c": "u"}  # unparseable numeric cell
    out = endpoint.score_batch([good[0], bad, good[1], good[2]])
    assert endpoint.shape_misses == 1
    assert isinstance(out[1], RowScoringError)
    clean = endpoint.score_batch(good)
    for got, want in zip([out[0], out[2], out[3]], clean):
        assert got[pred_name]["prediction"] == want[pred_name]["prediction"]
    assert endpoint.telemetry.snapshot()["rows_fallback"] == 4


def test_queue_overflow_sheds_at_the_front_door():
    model, records, _ = _trained()
    endpoint = compile_endpoint(model)
    sched = MicroBatchScheduler(endpoint, max_queue=4, max_wait_us=0,
                                start=False)
    for i in range(4):
        sched.submit(records[i])
    with pytest.raises(QueueFullError):
        sched.submit(records[4])
    assert endpoint.telemetry.snapshot()["shed_queue_full"] == 1
    assert sched.run_once() == 4  # the queue drains and recovers
    sched.submit(records[4])
    sched.close()


def test_deadline_shed_never_scores_dead_requests():
    model, records, _ = _trained()
    endpoint = compile_endpoint(model)
    fake_now = [100.0]
    sched = MicroBatchScheduler(endpoint, max_wait_us=0, start=False,
                                clock=lambda: fake_now[0])
    dead = sched.submit(records[0], deadline_ms=50.0)
    live = sched.submit(records[1], deadline_ms=10_000.0)
    fake_now[0] += 1.0  # 1 s later: the first deadline (50 ms) long gone
    assert sched.run_once() == 1
    with pytest.raises(DeadlineExceededError):
        dead.wait(0)
    assert live.wait(0) is not None
    snap = endpoint.telemetry.snapshot()
    assert snap["shed_deadline"] == 1
    assert snap["rows_scored"] == 1
    sched.close()


def test_per_request_timeout_surface():
    model, records, _ = _trained()
    endpoint = compile_endpoint(model)
    sched = MicroBatchScheduler(endpoint, start=False)  # nobody drains
    with pytest.raises(RequestTimeoutError):
        sched.score(records[0], timeout_s=0.01)
    assert endpoint.telemetry.snapshot()["request_timeouts"] == 1
    sched.close()


def test_deterministic_batch_fill():
    model, records, _ = _trained()
    tel = ServingTelemetry()
    endpoint = compile_endpoint(model, batch_buckets=(1, 8), telemetry=tel)
    sched = MicroBatchScheduler(endpoint, max_batch_size=8, max_wait_us=0,
                                start=False, telemetry=tel)
    for r in records[:20]:
        sched.submit(r)
    sizes = []
    while True:
        n = sched.run_once()
        if n == 0:
            break
        sizes.append(n)
    assert sizes == [8, 8, 4]
    snap = tel.snapshot()
    assert snap["batches"] >= 3
    assert snap["rows_scored"] == 20
    assert snap["batch_fill_histogram"]["75-100%"] >= 2
    sched.close()


def test_scheduler_results_match_direct_scoring():
    model, records, pred_name = _trained("rf")
    endpoint = compile_endpoint(model)
    direct = endpoint.score_batch(records)
    with MicroBatchScheduler(endpoint, max_wait_us=1000) as sched:
        served = list(sched.score_stream(iter(records), window=64))
    assert len(served) == len(records)
    for s, d in zip(served, direct):
        assert not isinstance(s, RowScoringError)
        assert s[pred_name]["prediction"] == d[pred_name]["prediction"]


def test_score_stream_backpressures_instead_of_dying_on_full_queue():
    model, records, _ = _trained()
    endpoint = compile_endpoint(model)
    with MicroBatchScheduler(endpoint, max_queue=8, max_wait_us=200) as sched:
        out = list(sched.score_stream(iter(records[:100]), window=64))
    assert len(out) == 100
    assert not any(isinstance(r, RowScoringError) for r in out)


def test_score_stream_sheds_row_when_queue_full_of_foreign_requests():
    model, records, _ = _trained()
    endpoint = compile_endpoint(model)
    sched = MicroBatchScheduler(endpoint, max_queue=2, max_wait_us=0,
                                start=False)
    sched.submit(records[0])
    sched.submit(records[1])
    out = list(sched.score_stream([records[2]]))
    assert len(out) == 1
    assert isinstance(out[0], RowScoringError)
    assert "QueueFullError" in out[0].error
    sched.close()


def test_submit_after_close_raises_immediately():
    model, records, _ = _trained()
    endpoint = compile_endpoint(model)
    sched = MicroBatchScheduler(endpoint, start=False)
    sched.close()
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit(records[0])
    with pytest.raises(RuntimeError, match="closed"):
        sched.admission.admit(records[0])


def test_abandoned_request_not_double_counted():
    model, records, _ = _trained()
    endpoint = compile_endpoint(model)
    sched = MicroBatchScheduler(endpoint, max_wait_us=0, start=False)
    with pytest.raises(RequestTimeoutError):
        sched.score(records[0], timeout_s=0.01)
    assert sched.run_once() == 1
    snap = endpoint.telemetry.snapshot()
    assert snap["request_timeouts"] == 1
    assert snap["rows_scored"] == 0
    sched.close()


def test_unscoreable_pad_record_does_not_degrade_batches():
    """A pipeline that cannot score the all-None pad row (warm_error set)
    still serves partial batches through the batch path, unpadded."""
    import transmogrifai_tpu_torch.dsl  # noqa: F401
    from transmogrifai_tpu_torch import FeatureBuilder
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.types import feature_types as ft

    rng = np.random.RandomState(1)
    n = 120
    data = {"y": (rng.rand(n) > 0.5).astype(float).tolist(),
            "a": rng.randn(n).tolist()}
    y = FeatureBuilder(ft.RealNN, "y").as_response()
    a = FeatureBuilder(ft.Real, "a").as_predictor()
    a2 = a.map_values(lambda v: v * 2.0, ft.Real)  # chokes on None
    pred = OpLogisticRegression().set_input(
        y, transmogrify([a2])).get_output()
    model = workflow(PORT, pred, data).train()
    endpoint = compile_endpoint(model, batch_buckets=(1, 32))
    assert endpoint.warm_error is not None
    records = [{"a": data["a"][i]} for i in range(5)]
    out = endpoint.score_batch(records)
    assert len(out) == 5
    assert not any(isinstance(r, RowScoringError) for r in out)
    assert endpoint.shape_misses == 0
    assert endpoint.telemetry.snapshot()["rows_fallback"] == 0


def test_empty_telemetry_snapshot_is_strict_json():
    snap = ServingTelemetry().snapshot()
    text = json.dumps(snap)
    assert "NaN" not in text
    assert json.loads(text)["latency_ms"]["p50"] is None


def test_xla_backend_is_refused_naming_torch():
    model, _, _ = _trained()
    with pytest.raises(ValueError, match="torch"):
        compile_endpoint(model, fused_backend="xla")


def test_torch_backend_on_cpu_tensors_reports_torch():
    """``fused_backend="torch"`` on a CPU model runs the device program on
    CPU tensors (K2's plain version): the endpoint and its telemetry name
    the torch backend, with every bucket's first-call split."""
    model, records, _ = _trained("rf")
    endpoint = compile_endpoint(model, fused_backend="torch")
    assert endpoint.fused_backend == "torch"
    fused = endpoint.telemetry.snapshot()["fused"]
    assert fused["backend"] == "torch"
    assert sorted(map(int, fused["bucket_timings"])) == [1, 8, 32, 128]
    for st in fused["bucket_timings"].values():
        assert set(st) == {"compile_ms", "first_exec_ms"}
    assert fused["cache"] == {"hits": 0, "misses": 0, "stale": 0}
    assert not any(isinstance(r, RowScoringError)
                   for r in endpoint.score_batch(records[:40]))


# -- the serving drills of the JAX package's tests/test_faults.py ----------------

def test_breaker_opens_sheds_and_probe_closes(served_model):
    model, records, _ = served_model
    fake_now = [0.0]
    telemetry = ServingTelemetry()
    breaker = CircuitBreaker(failure_threshold=3, cooldown_s=10.0,
                             clock=lambda: fake_now[0])
    endpoint = compile_endpoint(model, batch_buckets=(4,),
                                telemetry=telemetry, breaker=breaker)
    faults.configure("serving.batch:every=1:times=3")
    for i in range(3):
        out = endpoint.score_batch(records[:2])
        assert not any(isinstance(r, RowScoringError) for r in out), i
        assert breaker.state == ("closed" if i < 2 else "open")
    assert telemetry.snapshot()["rows_fallback"] == 6
    shed = endpoint.score_batch(records[:5])
    assert all(isinstance(r, RowScoringError) and r.shed for r in shed)
    snap = telemetry.snapshot()
    assert snap["breaker"]["opens"] == 1
    assert snap["breaker"]["rows_shed"] == 5
    fake_now[0] = 11.0
    ok = endpoint.score_batch(records[:2])
    assert not any(isinstance(r, RowScoringError) for r in ok)
    assert breaker.state == "closed"
    snap = telemetry.snapshot()
    assert snap["breaker"]["probes"] == 1
    assert snap["breaker"]["closes"] == 1


def test_half_open_probe_failure_reopens(served_model):
    model, records, _ = served_model
    fake_now = [0.0]
    breaker = CircuitBreaker(failure_threshold=1, cooldown_s=5.0,
                             clock=lambda: fake_now[0])
    endpoint = compile_endpoint(model, batch_buckets=(4,), breaker=breaker)
    faults.configure("serving.batch:every=1:times=2")
    endpoint.score_batch(records[:1])
    assert breaker.state == "open"
    fake_now[0] = 6.0
    endpoint.score_batch(records[:1])
    assert breaker.state == "open"
    assert breaker.opens == 2
    fake_now[0] = 12.0
    endpoint.score_batch(records[:1])
    assert breaker.state == "closed"


def test_slow_probe_keeps_ownership_and_closes():
    fake_now = [0.0]
    breaker = CircuitBreaker(failure_threshold=1, cooldown_s=1.0,
                             clock=lambda: fake_now[0])
    breaker.record_failure()
    assert breaker.state == "open"
    fake_now[0] = 1.5
    assert breaker.allow()
    fake_now[0] = 4.0
    assert not breaker.allow()
    breaker.record_success()
    assert breaker.state == "closed"
    fake_now[0] = 5.0
    assert breaker.allow()


def test_stale_success_cannot_close_an_open_breaker():
    breaker = CircuitBreaker(failure_threshold=2, cooldown_s=60.0)
    assert breaker.allow()
    breaker.record_failure()
    breaker.record_failure()
    assert breaker.state == "open"
    breaker.record_success()
    assert breaker.state == "open"
    assert breaker.closes == 0


def test_scheduler_sheds_with_breaker_open_error(served_model):
    model, records, _ = served_model
    telemetry = ServingTelemetry()
    breaker = CircuitBreaker(failure_threshold=1, cooldown_s=60.0)
    endpoint = compile_endpoint(model, batch_buckets=(4,),
                                telemetry=telemetry, breaker=breaker)
    faults.configure("serving.batch:every=1:times=1")
    endpoint.score_batch(records[:1])
    assert breaker.state == "open"
    with MicroBatchScheduler(endpoint, start=False,
                             telemetry=telemetry) as sched:
        req = sched.submit(records[0])
        sched.run_once(wait_timeout_s=0.5)
        with pytest.raises(BreakerOpenError):
            req.wait(1.0)
    assert telemetry.snapshot()["shed_breaker"] == 1


def test_poison_rows_do_not_open_the_breaker(served_model):
    model, records, _ = served_model
    breaker = CircuitBreaker(failure_threshold=2, cooldown_s=60.0)
    endpoint = compile_endpoint(model, batch_buckets=(4,), breaker=breaker)
    bad = {"a": object(), "c": "u"}
    for _ in range(5):
        out = endpoint.score_batch([bad, records[0]])
        assert isinstance(out[0], RowScoringError)
        assert not isinstance(out[1], RowScoringError)
    assert breaker.state == "closed"
    assert breaker.snapshot()["consecutive_failures"] == 0


def test_nan_guard_refuses_nonfinite_scores(served_model):
    model, records, _ = served_model
    telemetry = ServingTelemetry()
    endpoint = compile_endpoint(model, batch_buckets=(4,),
                                telemetry=telemetry)
    faults.configure("serving.nan_scores:on=1")
    out = endpoint.score_batch(records[:3])
    assert all(isinstance(r, RowScoringError) and not r.shed for r in out)
    assert all("non-finite" in r.error for r in out)
    assert telemetry.snapshot()["breaker"]["rows_nonfinite"] == 3
    assert endpoint.breaker.snapshot()["consecutive_failures"] == 1
    clean = endpoint.score_batch(records[:3])
    assert not any(isinstance(r, RowScoringError) for r in clean)
    assert endpoint.breaker.snapshot()["consecutive_failures"] == 0


def test_slow_batch_injection_delays_the_batch(served_model):
    model, records, _ = served_model
    telemetry = ServingTelemetry()
    endpoint = compile_endpoint(model, batch_buckets=(4,),
                                telemetry=telemetry)
    faults.configure("serving.slow_batch:on=1:delay=0.12")
    t0 = time.perf_counter()
    out = endpoint.score_batch(records[:2])
    assert time.perf_counter() - t0 >= 0.12
    assert not any(isinstance(r, RowScoringError) for r in out)
    assert telemetry.batch_wall_s >= 0.12


# -- against the JAX package's endpoint and scheduler ----------------------------

_pairs: dict = {}


def _pair(family: str, tmp_path_factory):
    """(reference model, torch model with its weights, records) of the
    JAX package's ``_mixed_pipeline`` with a ``family`` head."""
    if family not in _pairs:
        path = str(tmp_path_factory.mktemp(f"serve_{family}") / "model")
        ref, port = reference_pair(
            lambda pkg: mixed_pipeline(pkg, family)[0], path)
        _, records, _ = mixed_pipeline(PORT, family)
        _pairs[family] = (ref, port, records)
    return _pairs[family]


def _ref_serving():
    return mod(REF, "serving")


@pytest.mark.parametrize("family", ["lr", "rf", "gbt", "linreg"])
def test_endpoint_rows_bit_equal_to_reference(family, tmp_path_factory):
    """The same fitted model through both packages' ``CompiledEndpoint``
    on the numpy-fused route: rows equal to the bit (tolerance 0) at
    odd batch lengths, past the largest bucket and one at a time."""
    ref, port, records = _pair(family, tmp_path_factory)
    want_ep = _ref_serving().compile_endpoint(ref, fused_backend="numpy")
    got_ep = compile_endpoint(port, fused_backend="numpy")
    assert got_ep.fused_backend == want_ep.fused_backend == "numpy"
    assert got_ep.warmed_buckets == want_ep.warmed_buckets
    for lo, hi in ((0, 1), (1, 8), (8, 45), (0, len(records))):
        assert got_ep.score_batch(records[lo:hi]) == \
            want_ep.score_batch(records[lo:hi]), (lo, hi)
    assert [got_ep(r) for r in records[:5]] == [want_ep(r)
                                                for r in records[:5]]


@pytest.mark.parametrize("family", ["lr", "gbt"])
def test_scheduler_rows_bit_equal_to_reference(family, tmp_path_factory):
    """Both packages' ``MicroBatchScheduler`` streams over the same
    records yield the same rows, in order, to the bit."""
    ref, port, records = _pair(family, tmp_path_factory)
    rs = _ref_serving()
    want_ep = rs.compile_endpoint(ref, fused_backend="numpy")
    got_ep = compile_endpoint(port, fused_backend="numpy")
    with rs.MicroBatchScheduler(want_ep, max_wait_us=500) as s:
        want = list(s.score_stream(records, window=32))
    with MicroBatchScheduler(got_ep, max_wait_us=500) as s:
        got = list(s.score_stream(records, window=32))
    assert got == want


def _keys(doc, prefix=""):
    out = set()
    for k, v in doc.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in (
                "compile_ms_by_bucket", "bucket_timings", "drift_js",
                "violations_by_kind", "batches_by_action", "tuned_knobs"):
            out |= _keys(v, prefix + k + ".")
    return out


def test_telemetry_snapshot_has_the_reference_keys(tmp_path_factory):
    ref, port, records = _pair("lr", tmp_path_factory)
    want_ep = _ref_serving().compile_endpoint(ref, fused_backend="numpy")
    got_ep = compile_endpoint(port, fused_backend="numpy")
    want_ep.score_batch(records[:10])
    got_ep.score_batch(records[:10])
    want, got = want_ep.telemetry.snapshot(), got_ep.telemetry.snapshot()
    assert _keys(got) == _keys(want)
    for k in ("rows_scored", "rows_failed", "rows_fallback", "batches",
              "mean_batch_size", "batch_fill_histogram"):
        assert got[k] == want[k], k
    assert got["fused"]["enabled"] == want["fused"]["enabled"]
    assert got["fused"]["backend"] == want["fused"]["backend"] == "numpy"


# -- device faults are never degraded away ----------------------------------------

def _raising(err):
    def boom(*a, **k):
        raise err()
    return boom


def _no_nvcc(tk, monkeypatch, tmp_path):
    def popen(*a, **k):
        raise AssertionError("nvcc started although it is missing")
    monkeypatch.setattr(tk, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tk, "_nvcc", lambda: str(tmp_path / "bin" / "nvcc"))
    monkeypatch.setattr(tk.subprocess, "Popen", popen)


def _unloadable(tk, monkeypatch, tmp_path):
    def cdll(path):
        raise OSError(f"{path}: cannot open shared object file")
    monkeypatch.setattr(tk, "build", lambda names: {
        n: tmp_path / f"lib{n}.so" for n in names})
    monkeypatch.setattr(tk.ctypes, "CDLL", cdll)


def _no_entry(tk, monkeypatch, tmp_path):
    monkeypatch.setattr(tk, "build", lambda names: {
        n: tmp_path / f"lib{n}.so" for n in names})
    monkeypatch.setattr(tk.ctypes, "CDLL", lambda path: object())


KERNEL_LOAD_FAULTS = [
    pytest.param(_no_nvcc, id="nvcc_missing"),
    pytest.param(_unloadable, id="library_unloadable"),
    pytest.param(_no_entry, id="entry_missing"),
]


@pytest.mark.parametrize("breakage", KERNEL_LOAD_FAULTS)
def test_kernel_build_and_load_failures_are_device_faults(
        breakage, monkeypatch, tmp_path):
    """nvcc missing from the path, a library ctypes cannot load and a
    library without its entry each raise KernelError, so the serving and
    registry catch-alls re-raise them instead of serving cold."""
    from transmogrifai_tpu_torch.parallel import kernels as tk

    monkeypatch.setattr(tk, "_libs", {})
    breakage(tk, monkeypatch, tmp_path)
    with pytest.raises(KernelError) as info:
        tk._load("bin_matrix")
    assert tk.is_device_fault(info.value)


@pytest.mark.parametrize("breakage", KERNEL_LOAD_FAULTS)
def test_kernel_load_failure_escapes_warm_up_and_score_batch(
        breakage, monkeypatch, tmp_path):
    """A fused program whose K2 cannot be built or loaded: warm-up and the
    batch path both raise the KernelError; nothing is served cold and no
    row falls back."""
    from transmogrifai_tpu_torch.parallel import kernels as tk

    model, records, _ = _trained("rf")
    endpoint = compile_endpoint(model, fused_backend="torch", warm=False)
    monkeypatch.setattr(tk, "_libs", {})
    breakage(tk, monkeypatch, tmp_path)
    endpoint._scorer.fused.score_batch = lambda *a, **k: tk._load(
        "bin_matrix")
    with pytest.raises(KernelError):
        endpoint.warm_up()
    assert endpoint.warm_error is None
    with pytest.raises(KernelError):
        endpoint.score_batch(records[:5])
    assert endpoint.telemetry.snapshot()["rows_fallback"] == 0


@pytest.mark.parametrize("err", DEVICE_FAULTS)
def test_device_fault_escapes_warm_up(err):
    model, records, _ = _trained("rf")
    endpoint = compile_endpoint(model, fused_backend="torch", warm=False)
    endpoint._scorer.fused.score_batch = _raising(err)
    with pytest.raises(type(err())):
        endpoint.warm_up()
    assert endpoint.warm_error is None


@pytest.mark.parametrize("err", DEVICE_FAULTS)
def test_device_fault_escapes_score_batch(err):
    """Raised in the batch path it escapes score_batch: no row fallback,
    no RowScoringError, nothing counted as a fallback."""
    model, records, _ = _trained("rf")
    endpoint = compile_endpoint(model, fused_backend="torch")
    endpoint._scorer.fused.score_batch = _raising(err)
    with pytest.raises(type(err())):
        endpoint.score_batch(records[:5])
    assert endpoint.shape_misses == 0
    assert endpoint.telemetry.snapshot()["rows_fallback"] == 0


@pytest.mark.parametrize("err", DEVICE_FAULTS)
def test_device_fault_escapes_the_row_fallback(err):
    """An ordinary batch failure degrades to the row path, and a device
    fault there escapes instead of becoming a RowScoringError."""
    model, records, _ = _trained("rf")
    endpoint = compile_endpoint(model, fused_backend="torch")
    def flaky(batch):
        # the padded batch fails as a shape miss would; each row of the
        # fallback (``LocalScorer.__call__``, one-row batches) hits the card
        if len(batch) > 1:
            raise ValueError("shape miss")
        raise err()

    endpoint._scorer.score_batch = flaky
    with pytest.raises(type(err())):
        endpoint.score_batch(records[:3])


def test_ordinary_batch_failure_still_degrades():
    """A non-device error in the batch path still re-scores row by row,
    as in the JAX package: the rows come back scored."""
    model, records, pred_name = _trained("rf")
    endpoint = compile_endpoint(model, fused_backend="torch")
    want = endpoint.score_batch(records[:3])
    one_row = endpoint._scorer.score_batch

    def flaky(batch):
        if len(batch) > 1:
            raise ValueError("shape miss")
        return one_row(batch)

    endpoint._scorer.score_batch = flaky
    got = endpoint.score_batch(records[:3])
    assert endpoint.shape_misses == 1
    assert endpoint.telemetry.snapshot()["rows_fallback"] == 3
    assert [g[pred_name]["prediction"] for g in got] == [
        w[pred_name]["prediction"] for w in want]


@pytest.mark.parametrize("err", DEVICE_FAULTS)
def test_device_fault_reaches_the_scheduler_caller(err):
    """The caller of every request in the failed batch receives the device
    error itself; the batch loop stops, later submits raise it."""
    model, records, _ = _trained("rf")
    endpoint = compile_endpoint(model, fused_backend="torch")
    endpoint._scorer.fused.score_batch = _raising(err)
    sched = MicroBatchScheduler(endpoint, max_wait_us=0, start=False)
    req = sched.submit(records[0])
    with pytest.raises(type(err())):
        sched.run_once()
    with pytest.raises(type(err())):
        req.wait(1.0)
    sched.close()
    with MicroBatchScheduler(endpoint, max_wait_us=0) as live:
        with pytest.raises(type(err())):
            live.score(records[0], timeout_s=10.0)
        live._worker.join(10.0)
        assert not live._worker.is_alive()
        assert isinstance(live.device_fault, type(err()))
        with pytest.raises(type(err())):
            live.submit(records[1])
    with MicroBatchScheduler(endpoint, max_wait_us=0) as live:
        with pytest.raises(type(err())):
            list(live.score_stream(records[:4], window=2))


@pytest.mark.parametrize("err", DEVICE_FAULTS)
def test_device_fault_escapes_the_torch_lowering(err, monkeypatch):
    """``LocalScorer``'s torch lowering lets a device fault through: the
    model is never served numpy-fused after one.  Any other lowering error
    still degrades to numpy-fused with its reason recorded."""
    from transmogrifai_tpu_torch.local import scorer as scorer_mod

    model, _, _ = _trained("rf")
    monkeypatch.setattr(scorer_mod, "compile_torch_pipeline", _raising(err))
    with pytest.raises(type(err())):
        LocalScorer(model, fused_backend="torch")
    with pytest.raises(type(err())):
        compile_endpoint(model, fused_backend="torch")
    monkeypatch.setattr(scorer_mod, "compile_torch_pipeline",
                        _raising(lambda: ValueError("a lowering bug")))
    s = LocalScorer(model, fused_backend="torch")
    assert s.fused_backend == "numpy"
    assert "ValueError: a lowering bug" in s.fused_reason


def test_scheduler_retune_waits_for_autotune():
    """The autotuner's live knob seam is ported: ``retune`` applies the
    knobs to the live scheduler and records them as tuned in telemetry
    (the endpoint's buckets stay hand-set until then), as the
    reference's does."""
    model, records, _ = _trained("lr")
    endpoint = compile_endpoint(model, fused_backend="numpy")
    assert endpoint.telemetry.snapshot()["knob_source"] == "hand_set"
    with MicroBatchScheduler(endpoint, start=False) as sched:
        applied = sched.retune(max_batch_size=256, max_wait_us=500)
        assert applied == sched.knobs() == {"max_batch_size": 256,
                                            "max_wait_us": 500}
    snap = endpoint.telemetry.snapshot()
    assert snap["knob_source"] == "autotune"
    assert snap["tuned_knobs"]["max_batch_size"] == 256.0
