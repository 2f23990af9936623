"""Declarative SLOs with multi-window burn-rate alerting over the
observability plane.

Host copy of ``transmogrifai_tpu/obs/slo.py``.

The registry's RollbackPolicy already reads raw signals (breaker opens,
drift JS, p99 ratios) straight off one canary's telemetry; an SLO is
the fleet-shaped version of the same idea: a *declared* objective
("error ratio <= 1%", "p99 <= 50ms") evaluated over the aggregated
metrics plane, with the SRE-workbook multi-window burn-rate rule - an
alert fires only when the error budget is burning too fast over BOTH a
long and a short window (the long window keeps one bad batch from
paging; the short window lets a recovered system clear quickly), and
clears when the short window recovers.

Three objective kinds, each selecting metrics by dotted path into the
registry JSON document (``serving.rows_failed`` walks the first
``serving`` view's snapshot; a ``tx_``-sanitized or exact native series
name matches ``series``):

* ``ratio``     - numerator/denominator counters; burn = windowed
  (d num / d den) / objective.  Error ratios, NaN-guard refusal rates.
* ``rate``      - numerator counter per second; burn = windowed
  (d num / dt) / objective.  Breaker opens, quarantine floods.
* ``threshold`` - point-in-time value; burn = value / objective
  (``op=">="`` inverts).  p99 latency, drift JS maxima.

Counters resolve as the SUM across processes and threshold values as
the MAX (the fleet question is "how much total traffic failed" and
"how slow is the worst replica"), so one config evaluates unchanged
over a single process's registry or many processes' merged docs.

The engine registers itself as a metrics view (kind ``slo``), so alert
states ride every scrape; the runner's ``slo_path`` knob evaluates a
config file live, and ``RollbackPolicy.slo_engine`` consumes firing
alerts as hard rollback signals.

Stdlib-only, like the rest of obs/.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional, Sequence, Union

from .metrics import metrics_registry, sanitize_metric_name

__all__ = [
    "SLOEngine",
    "SLObjective",
    "default_objectives",
    "load_slo_config",
    "resolve_metric",
]

#: bounded alert-transition history (the MeshTelemetry event discipline)
_MAX_EVENTS = 256

#: per-objective sample cap: a RollbackPolicy-driven engine observes
#: once per canary check, and a 300s window at high check rates would
#: otherwise grow (and linearly re-scan) tens of thousands of samples
#: on the serving control loop.  Past the cap the MIDDLE decimates
#: (counter burns only read window-boundary samples; threshold maxima
#: lose at most interleaved points).
_MAX_SAMPLES = 4096


# ---------------------------------------------------------------------------
# metric selection
# ---------------------------------------------------------------------------
def _walk(snap: Any, parts: Sequence[str]) -> Optional[float]:
    node = snap
    for p in parts:
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    if isinstance(node, bool) or not isinstance(node, (int, float)):
        return None
    if node != node or node in (float("inf"), float("-inf")):
        return None
    return float(node)


def resolve_metric(docs: Union[dict, Iterable[dict]],
                   path: str) -> tuple[float, Optional[float], int]:
    """Resolve a dotted metric path over one registry document or many
    (the fleet case): returns ``(sum, max, matches)`` across every
    match - native series by exact or ``tx_``-sanitized name, then
    ``<kind>.<path...>`` into every view of that kind.  Zero matches
    return ``(0.0, None, 0)``; SLO kinds pick sum (counters) or max
    (point-in-time values)."""
    if isinstance(docs, dict):
        docs = (docs,)
    total, mx, n = 0.0, None, 0
    want = sanitize_metric_name(path)
    parts = path.split(".")
    for doc in docs:
        for name, s in doc.get("series", {}).items():
            if name == path or sanitize_metric_name(name) == want:
                v = _walk(s, ("value",))
                if v is None:  # histogram: sum is its counter reading
                    v = _walk(s, ("sum",))
                if v is not None:
                    total += v
                    mx = v if mx is None or v > mx else mx
                    n += 1
        for key, snap in doc.get("views", {}).items():
            if key.partition("/")[0] != parts[0]:
                continue
            v = _walk(snap, parts[1:])
            if v is not None:
                total += v
                mx = v if mx is None or v > mx else mx
                n += 1
    return total, mx, n


def _paths_sum(docs, paths: Union[str, Sequence[str]],
               agg: str = "sum") -> tuple[Optional[float], int]:
    """Sum one-or-many dotted paths (``rows_scored + rows_failed``
    denominators want both); returns (value, matches)."""
    if isinstance(paths, str):
        paths = (paths,)
    total, n = 0.0, 0
    for p in paths:
        s, m, k = resolve_metric(docs, p)
        total += (m if agg == "max" else s) if k else 0.0
        n += k
    return (total if n else None), n


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------
@dataclass
class SLObjective:
    """One declarative objective (see module docstring for the kinds).
    ``windows_s`` is (long, short); the alert fires when the burn rate
    exceeds ``burn_threshold`` in BOTH windows and clears when the
    short window drops back under it."""

    name: str
    kind: str = "ratio"  # ratio | rate | threshold
    metric: Union[str, Sequence[str]] = ""        # threshold kinds
    numerator: Union[str, Sequence[str]] = ""     # ratio/rate kinds
    denominator: Union[str, Sequence[str]] = ""   # ratio kind
    objective: float = 0.01
    op: str = "<="  # threshold only: "<=" (cap) or ">=" (floor)
    windows_s: Sequence[float] = (300.0, 60.0)
    burn_threshold: float = 1.0

    def __post_init__(self) -> None:
        if self.kind not in ("ratio", "rate", "threshold"):
            raise ValueError(
                f"SLO {self.name!r}: unknown kind {self.kind!r}")
        if self.kind == "threshold" and not self.metric:
            raise ValueError(f"SLO {self.name!r}: threshold needs 'metric'")
        if self.kind in ("ratio", "rate") and not self.numerator:
            raise ValueError(f"SLO {self.name!r}: {self.kind} needs "
                             "'numerator'")
        if self.kind == "ratio" and not self.denominator:
            raise ValueError(f"SLO {self.name!r}: ratio needs "
                             "'denominator'")
        if self.objective <= 0:
            raise ValueError(f"SLO {self.name!r}: objective must be > 0")
        if len(self.windows_s) != 2 or self.windows_s[0] < self.windows_s[1]:
            raise ValueError(f"SLO {self.name!r}: windows_s must be "
                             "(long, short) with long >= short")

    def to_json(self) -> dict:
        return {
            "name": self.name, "kind": self.kind,
            "metric": self.metric, "numerator": self.numerator,
            "denominator": self.denominator, "objective": self.objective,
            "op": self.op, "windows_s": list(self.windows_s),
            "burn_threshold": self.burn_threshold,
        }

    @classmethod
    def from_json(cls, doc: dict) -> "SLObjective":
        known = {"name", "kind", "metric", "numerator", "denominator",
                 "objective", "op", "windows_s", "burn_threshold"}
        extra = set(doc) - known
        if extra:
            # a typoed key would silently disable the knob it misspells
            raise ValueError(
                f"SLO config: unknown keys {sorted(extra)} in "
                f"{doc.get('name', '<unnamed>')!r}"
            )
        if "name" not in doc:
            raise ValueError("SLO config: every objective needs a 'name'")
        return cls(**doc)


def load_slo_config(path: str) -> list[SLObjective]:
    """Load a config file: ``{"slos": [{...}, ...]}`` (the runner's
    ``slo_path`` knob's format)."""
    with open(path) as f:
        doc = json.load(f)
    objs = doc.get("slos") if isinstance(doc, dict) else doc
    if not isinstance(objs, list) or not objs:
        raise ValueError(f"{path}: expected {{'slos': [...]}} with at "
                         "least one objective")
    out = [SLObjective.from_json(o) for o in objs]
    names = [o.name for o in out]
    if len(set(names)) != len(names):
        raise ValueError(f"{path}: duplicate SLO names")
    return out


def default_objectives() -> list[SLObjective]:
    """Four objectives over serving telemetry: p99 latency, error
    ratio, drift JS, and breaker opens - a usable starting config."""
    return [
        SLObjective(name="serving-p99-latency", kind="threshold",
                    metric="serving.latency_ms.p99", objective=250.0,
                    windows_s=(300.0, 60.0)),
        SLObjective(name="serving-error-ratio", kind="ratio",
                    numerator="serving.rows_failed",
                    denominator=("serving.rows_scored",
                                 "serving.rows_failed"),
                    objective=0.01, windows_s=(300.0, 60.0),
                    burn_threshold=2.0),
        SLObjective(name="serving-drift-js", kind="threshold",
                    metric="serving.data_contract.drift_js_max",
                    objective=0.25, windows_s=(300.0, 60.0)),
        SLObjective(name="serving-breaker-opens", kind="rate",
                    numerator="serving.breaker.opens",
                    objective=1.0 / 300.0, windows_s=(300.0, 60.0)),
    ]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
class _AlertState:
    __slots__ = ("samples", "state", "since_t", "fired", "cleared",
                 "last")

    def __init__(self) -> None:
        #: (t_perf, numerator, denominator, value) samples; denominator
        #: and value None where the kind does not use them
        self.samples: list[tuple] = []
        self.state = "ok"
        self.since_t: Optional[float] = None
        self.fired = 0
        self.cleared = 0
        self.last: dict = {}


class SLOEngine:
    """Evaluate declarative objectives over registry documents with
    multi-window burn-rate alerting (module docstring).  ``doc_fn``
    produces the evaluation surface per :meth:`observe` call - default
    the live process registry; a caller may pass merged documents of
    many processes.  Registered as a metrics
    view (kind ``slo``) so alert states ride every scrape."""

    def __init__(self, objectives: Optional[Sequence[SLObjective]] = None,
                 doc_fn: Optional[Callable[[], Any]] = None,
                 register: bool = True) -> None:
        self.objectives = list(objectives) if objectives is not None \
            else default_objectives()
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError("duplicate SLO names")
        self._doc_fn = doc_fn or (lambda: metrics_registry().to_json())
        self._lock = threading.Lock()
        self._alerts = {o.name: _AlertState() for o in self.objectives}
        self._events: list[dict] = []
        self._pc_start = time.perf_counter()
        self.evaluations = 0
        if register:
            metrics_registry().register_view("slo", self)

    # -- sampling -----------------------------------------------------------
    def _sample(self, obj: SLObjective, docs) -> tuple:
        t = time.perf_counter()
        if obj.kind == "threshold":
            v, _n = _paths_sum(docs, obj.metric, agg="max")
            return (t, None, None, v)
        num, _n = _paths_sum(docs, obj.numerator, agg="sum")
        den = None
        if obj.kind == "ratio":
            den, _d = _paths_sum(docs, obj.denominator, agg="sum")
        return (t, num, den, None)

    @staticmethod
    def _window(samples: list[tuple], now: float,
                window_s: float) -> list[tuple]:
        cut = now - window_s
        # the newest sample BEFORE the window is the delta baseline:
        # counters need a reference point even when the window holds a
        # single fresh sample
        base = None
        inside = []
        for s in samples:
            if s[0] < cut:
                base = s
            else:
                inside.append(s)
        return ([base] if base is not None else []) + inside

    def _burn(self, obj: SLObjective, samples: list[tuple],
              now: float, window_s: float) -> tuple[float, dict]:
        win = self._window(samples, now, window_s)
        if not win:
            return 0.0, {}
        first, last = win[0], win[-1]
        if obj.kind == "threshold":
            # strictly in-window values only: the prepended baseline is
            # a COUNTER delta reference, not a point-in-time reading - a
            # p99 spike sampled before both windows must age out, never
            # hold (or fire) an alert from stale data.  An empty window
            # burns nothing: no recent data must not page.
            cut = now - window_s
            vals = [s[3] for s in win if s[3] is not None and s[0] >= cut]
            if not vals:
                return 0.0, {}
            v = max(vals)
            if obj.op == ">=":
                burn = obj.objective / v if v > 0 else float("inf")
            else:
                burn = v / obj.objective
            return burn, {"value": v}
        if len(win) == 1:
            # baseline-less (one-shot CLI over a saved artifact, or an
            # engine's very first evaluation): the cumulative totals
            # ARE the window for ratios - a lifetime error ratio past
            # the objective reads as firing.  Rates need a timebase a
            # single sample cannot provide.
            if obj.kind == "rate":
                return 0.0, {"rate_per_s": None}
            dnum, dden = (last[1] or 0.0), (last[2] or 0.0)
        else:
            dnum = (last[1] or 0.0) - (first[1] or 0.0)
            if obj.kind == "rate":
                dt = max(last[0] - first[0], 1e-9)
                rate = max(dnum, 0.0) / dt
                return rate / obj.objective, {"rate_per_s": rate}
            dden = (last[2] or 0.0) - (first[2] or 0.0)
        if dden <= 0:
            return 0.0, {"ratio": None}  # no traffic burns no budget
        ratio = max(dnum, 0.0) / dden
        return ratio / obj.objective, {"ratio": ratio}

    # -- evaluation ---------------------------------------------------------
    def observe(self, docs: Any = None) -> dict:
        """Sample every objective from ``docs`` (default: ``doc_fn()``),
        update burn rates + alert states, return the report.  Called by
        the runner per export and by RollbackPolicy per canary check."""
        if docs is None:
            docs = self._doc_fn()
        now = time.perf_counter()
        report: dict = {"objectives": {}, "firing": []}
        with self._lock:
            self.evaluations += 1
            for obj in self.objectives:
                st = self._alerts[obj.name]
                st.samples.append(self._sample(obj, docs))
                # prune past the long window (plus one baseline sample),
                # and cap by COUNT so high-frequency observers stay O(1)
                # in memory regardless of window length
                cut = now - obj.windows_s[0]
                while len(st.samples) > 2 and st.samples[1][0] < cut:
                    del st.samples[0]
                if len(st.samples) > _MAX_SAMPLES:
                    del st.samples[1:-1:2]
                long_burn, long_info = self._burn(
                    obj, st.samples, now, obj.windows_s[0])
                short_burn, short_info = self._burn(
                    obj, st.samples, now, obj.windows_s[1])
                breach = (long_burn > obj.burn_threshold
                          and short_burn > obj.burn_threshold)
                recovered = short_burn <= obj.burn_threshold
                if st.state == "ok" and breach:
                    st.state, st.since_t = "firing", now
                    st.fired += 1
                    self._event(alert=obj.name, transition="fired",
                                burn_long=round(long_burn, 4),
                                burn_short=round(short_burn, 4))
                elif st.state == "firing" and recovered:
                    st.state, st.since_t = "ok", now
                    st.cleared += 1
                    self._event(alert=obj.name, transition="cleared",
                                burn_short=round(short_burn, 4))
                st.last = {
                    "kind": obj.kind,
                    "objective": obj.objective,
                    "burn_threshold": obj.burn_threshold,
                    "burn_long": round(long_burn, 6),
                    "burn_short": round(short_burn, 6),
                    "state": st.state,
                    "fired": st.fired,
                    "cleared": st.cleared,
                    **{k: (round(v, 6) if isinstance(v, float) else v)
                       for k, v in {**long_info, **short_info}.items()},
                }
                report["objectives"][obj.name] = dict(st.last)
                if st.state == "firing":
                    report["firing"].append(dict(
                        st.last, name=obj.name))
        return report

    def _event(self, **kw) -> None:
        kw["t"] = round(time.perf_counter() - self._pc_start, 3)
        self._events.append(kw)
        if len(self._events) > _MAX_EVENTS:
            del self._events[0]

    # -- reporting ----------------------------------------------------------
    def firing(self) -> list[dict]:
        """The currently-firing alerts (name + burn evidence) - the
        RollbackPolicy input: each entry becomes a hard rollback
        reason."""
        with self._lock:
            return [
                dict(self._alerts[o.name].last, name=o.name)
                for o in self.objectives
                if self._alerts[o.name].state == "firing"
            ]

    def report(self) -> dict:
        with self._lock:
            return {
                "evaluations": self.evaluations,
                "objectives": {
                    o.name: dict(self._alerts[o.name].last,
                                 state=self._alerts[o.name].state)
                    for o in self.objectives
                },
                "firing": [o.name for o in self.objectives
                           if self._alerts[o.name].state == "firing"],
                "events": [dict(e) for e in self._events],
            }

    def snapshot(self) -> dict:
        """Metrics-view shape: alert states as 0/1 gauges plus burn
        rates, so a scrape carries ``tx_slo_alert_firing_<name>``."""
        with self._lock:
            firing = {}
            burns = {}
            for o in self.objectives:
                st = self._alerts[o.name]
                key = sanitize_metric_name(o.name)[3:]  # strip tx_
                firing[key] = 1 if st.state == "firing" else 0
                if st.last:
                    burns[key] = {
                        "burn_long": st.last.get("burn_long"),
                        "burn_short": st.last.get("burn_short"),
                    }
            return {
                "evaluations": self.evaluations,
                "alerts_firing": sum(firing.values()),
                "alert_firing": firing,
                "burn": burns,
            }
