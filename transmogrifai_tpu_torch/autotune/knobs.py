"""Profiler-trained serving/pipeline knob tuning.

Host copy of ``transmogrifai_tpu/autotune/knobs.py``.  A probe that fails
with a device fault (``parallel.kernels.is_device_fault``: a kernel that
does not build or launch, a CUDA error) re-raises it: only an ordinary
error loses the probe.

tf.data (arXiv 2101.12127) tunes input-pipeline parallelism from
OBSERVED stall/throughput signals rather than fixed constants; this
module applies the same discipline to every hand-set knob in the
system: micro-batch ``max_batch_size``/``max_wait_us``, endpoint shape
buckets, and the input pipeline's ``workers``/``buffer_chunks``.

Two seams:

* **proposal** - pure functions turning obs-plane snapshots into
  candidate knob settings (``propose_pipeline_knobs`` from the
  pipeline's producer/consumer stall counters,
  ``propose_bucket_edges`` from an observed batch-size distribution,
  ``microbatch_candidates`` around the current defaults, ranked by the
  cost model when it has ``serve.batch`` observations);
* **A/B validation** - :meth:`KnobTuner.ab_probe` runs SHORT measured
  probes of the baseline and each candidate (interleaved best-of-N so
  one shared-host spike cannot decide a knob) and only dethrones the
  hand-set default when a candidate beats it by a margin.  Ties keep
  the default - tuned knobs must match or beat hand-set, never regress.

Decisions land in the obs plane (``autotune.knob.*`` gauges +
``autotune.probes`` counter) and in the returned :class:`KnobDecision`
which the runner records in run metrics and serving telemetry.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from ..obs.metrics import metrics_registry
from ..parallel.kernels import is_device_fault
from .cost_model import CostModel, candidate_features

__all__ = [
    "KnobDecision",
    "KnobTuner",
    "microbatch_candidates",
    "propose_bucket_edges",
    "propose_pipeline_knobs",
]


@dataclass
class KnobDecision:
    """Outcome of one A/B knob probe: every candidate's measured value,
    the winner, and whether the hand-set baseline was dethroned."""

    scope: str
    metric: str
    larger_better: bool
    baseline: dict
    winner: dict
    tuned: bool  # True when the winner is not the baseline
    margin: float
    probes: list = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "scope": self.scope,
            "metric": self.metric,
            "larger_better": self.larger_better,
            "baseline": dict(self.baseline),
            "winner": dict(self.winner),
            "tuned": self.tuned,
            "margin": self.margin,
            "probes": [dict(p) for p in self.probes],
        }


class KnobTuner:
    """Short measured A/B probes with cost-model bookkeeping."""

    def __init__(self, cost_model: Optional[CostModel] = None,
                 margin: float = 0.03, repeats: int = 2) -> None:
        self.cost_model = cost_model
        #: a candidate must beat the baseline by this fraction to win -
        #: within the margin the HAND-SET default keeps the knob
        self.margin = float(margin)
        self.repeats = max(int(repeats), 1)

    def ab_probe(
        self,
        scope: str,
        baseline: dict,
        candidates: Sequence[dict],
        measure: Callable[[dict], float],
        metric: str = "rows_per_s",
        larger_better: bool = True,
    ) -> KnobDecision:
        """Measure ``baseline`` and each candidate via ``measure(knobs)
        -> value`` (interleaved, best-of-``repeats`` per arm), pick the
        winner.  The baseline wins ties and anything within ``margin``;
        a candidate failing to measure (exception) is recorded and
        skipped, never crashes the probe run."""
        arms = [dict(baseline)] + [dict(c) for c in candidates
                                   if dict(c) != dict(baseline)]
        best: list[Optional[float]] = [None] * len(arms)
        errors: list[Optional[str]] = [None] * len(arms)
        reg = metrics_registry()
        for _ in range(self.repeats):
            for i, knobs in enumerate(arms):
                if errors[i]:
                    continue
                try:
                    v = float(measure(knobs))
                except Exception as e:  # noqa: BLE001 - a broken
                    # candidate config must lose the probe, not kill it;
                    # the error is recorded in the decision trail.  A
                    # device fault is not a losing probe: it re-raises
                    if is_device_fault(e):
                        raise
                    errors[i] = f"{type(e).__name__}: {e}"
                    continue
                reg.counter(
                    "autotune.probes",
                    help="measured knob A/B probe runs",
                ).inc()
                if best[i] is None or (
                        v > best[i] if larger_better else v < best[i]):
                    best[i] = v
                if self.cost_model is not None and v > 0:
                    # throughput probes enter the cost model as
                    # per-unit walls so later proposals can rank
                    # candidates before spending probe time on them
                    self.cost_model.observe(
                        f"knob:{scope}",
                        candidate_features(0, 0, knobs),
                        1e3 / v if larger_better else v,
                    )
        win_i = 0
        for i in range(1, len(arms)):
            v = best[i]
            if v is None or errors[i]:
                # an arm that errored on ANY repeat is disqualified -
                # a config that threw during probing must never be
                # applied to the live surface, even if another repeat
                # measured well
                continue
            ref = best[win_i]
            if ref is None:
                win_i = i
                continue
            bar = ref * (1.0 + self.margin) if larger_better \
                else ref * (1.0 - self.margin)
            if (v > bar) if larger_better else (v < bar):
                win_i = i
        decision = KnobDecision(
            scope=scope,
            metric=metric,
            larger_better=larger_better,
            baseline=dict(arms[0]),
            winner=dict(arms[win_i]),
            tuned=win_i != 0,
            margin=self.margin,
            probes=[
                {"knobs": dict(k), "value": best[i], "error": errors[i],
                 "is_baseline": i == 0, "is_winner": i == win_i}
                for i, k in enumerate(arms)
            ],
        )
        for name, value in decision.winner.items():
            if isinstance(value, (int, float)) \
                    and not isinstance(value, bool):
                reg.gauge(
                    f"autotune.knob.{scope}.{name}",
                    help="tuner-chosen knob value (baseline when the "
                         "hand-set default held)",
                ).set(float(value))
        reg.gauge(
            f"autotune.knob.{scope}.tuned",
            help="1 when the tuner dethroned the hand-set default",
        ).set(1.0 if decision.tuned else 0.0)
        return decision


def microbatch_candidates(
    baseline: dict,
    cost_model: Optional[CostModel] = None,
    max_candidates: int = 4,
) -> list[dict]:
    """Candidate (max_batch_size, max_wait_us) settings around the
    hand-set defaults: batch sizes one power-of-two either side, waits
    halved/doubled.  When the cost model has ``knob:serving.microbatch``
    observations the candidates are ranked cheapest-predicted-first so
    a bounded probe budget spends itself on the most promising arms."""
    b = int(baseline.get("max_batch_size", 128))
    w = int(baseline.get("max_wait_us", 2000))
    out: list[dict] = []
    for nb in (b * 2, b, max(b // 2, 1)):
        for nw in (w * 2, w, max(w // 2, 0)):
            c = {"max_batch_size": int(nb), "max_wait_us": int(nw)}
            if c != baseline and c not in out:
                out.append(c)
    if cost_model is not None and \
            cost_model.can_predict("knob:serving.microbatch"):
        def pred(c: dict) -> float:
            v = cost_model.predict_wall_ms(
                "knob:serving.microbatch", candidate_features(0, 0, c))
            return v if v is not None else float("inf")

        out.sort(key=pred)
    return out[:max_candidates]


def propose_bucket_edges(
    batch_sizes: Sequence[int],
    max_buckets: int = 5,
    cap: int = 4096,
) -> tuple[int, ...]:
    """Shape-bucket edges from an OBSERVED batch-size distribution:
    powers of two from the smallest observed batch up to the first
    power covering the maximum (each bucket's pad waste is bounded at
    2x), clamped to ``max_buckets`` edges by dropping the densest-free
    low edges first.  Deterministic: same observations, same edges."""
    sizes = sorted({int(s) for s in batch_sizes if int(s) >= 1})
    if not sizes:
        return (1, 8, 32, 128)
    top = 1
    while top < sizes[-1] and top < cap:
        top *= 2
    edges = [1]
    e = 1
    while e < top:
        e *= 2
        edges.append(e)
    # keep 1, the top, and the max_buckets-2 edges closest above the
    # observed size quantiles - buckets nobody hits are pure warm-up
    # and compile cost.  1 and the TOP edge are never dropped (the top
    # is what bounds pad waste at 2x for the largest observed batches);
    # overflow sheds the lowest middle edges first.
    if len(edges) > max_buckets:
        qs = [sizes[min(int(f * (len(sizes) - 1)), len(sizes) - 1)]
              for f in (0.25, 0.5, 0.75, 0.95)]
        keep = {1, top}
        for q in qs:
            # quantiles past the cap clamp to the top edge (observed
            # sizes may exceed cap; the proposal never does)
            keep.add(next((e for e in edges if e >= q), top))
        edges = sorted(keep)
        while len(edges) > max_buckets:
            middle = [e for e in edges if e not in (1, top)]
            if not middle:
                break
            edges.remove(middle[0])
    return tuple(edges)


def propose_pipeline_knobs(
    stats_snapshot: dict,
    current: Optional[dict] = None,
    max_workers: int = 16,
) -> dict:
    """Input-pipeline knob proposal from a ``PipelineStats.snapshot()``:
    the tf.data rule - CONSUMER stalls (parsers cannot keep up) ask for
    more workers and a deeper buffer; PRODUCER stalls (buffer full,
    consumer is the bottleneck) ask for fewer workers so parse threads
    stop oversubscribing the fit.  Balanced pipelines keep the current
    knobs.  Pure + deterministic; A/B probes validate before adoption."""
    cur = dict(current or {})
    workers = int(cur.get("workers", 4))
    buffer_chunks = int(cur.get("buffer_chunks", 8))
    busy = float(stats_snapshot.get("producer_busy_s", 0.0) or 0.0)
    p_stall = float(stats_snapshot.get("producer_stall_s", 0.0) or 0.0)
    c_stall = float(stats_snapshot.get("consumer_stall_s", 0.0) or 0.0)
    denom = max(busy + p_stall, 1e-9)
    p_ratio = p_stall / denom
    c_ratio = c_stall / denom
    new_workers, new_buffer = workers, buffer_chunks
    if c_ratio > 0.2 and c_ratio >= p_ratio:
        # consumer starved: parse is the bottleneck
        new_workers = min(workers * 2, max_workers)
        new_buffer = buffer_chunks * 2
    elif p_ratio > 0.2:
        # producers blocked on a full buffer: consumer is the
        # bottleneck - fewer parse threads, keep the buffer
        new_workers = max(workers // 2, 1)
    return {"workers": int(new_workers),
            "buffer_chunks": int(new_buffer)}



def measure_wall(fn: Callable[[], object]) -> float:
    """Tiny probe helper: wall seconds of one call (perf_counter).  On
    the card ``fn`` should end on a host read (``.item()``, ``.cpu()``)
    or a ``torch.cuda.synchronize()``, or the wall stops at the launch."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0
