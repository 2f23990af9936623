"""Cross-process observability: trace-context propagation, per-process
metric/span shipping, and fleet aggregation.

Host copy of ``transmogrifai_tpu/obs/fleet.py``:

* **trace-context propagation** - :func:`child_env` packages the
  ambient span's ``<trace_id>:<span_id>`` into the
  ``TX_OBS_TRACE_CONTEXT`` env seam (``trace.TRACE_CONTEXT_ENV``); a
  child's Tracer adopts it at construction, so one trace id follows a
  parent run into every process it spawns (supervisor re-dispatch,
  mesh-peer children).
* **shipping** - :func:`ship_now` / :class:`ObsShipper` write this
  process's whole plane (MetricsRegistry document + tracer span ring)
  to ONE per-process file in an aggregation directory, by tempfile +
  atomic ``os.replace`` so a reader can never observe a torn shard; the
  file's mtime is the process's heartbeat (liveness rides the
  filesystem: a dead process is exactly one that cannot be asked).
* **aggregation** - :class:`FleetAggregator` merges the LIVE shards
  (stale heartbeats age out, torn/partial files are skipped and
  counted, never raised) into one Prometheus exposition with
  per-process ``instance`` labels plus fleet-level sums/maxes, and
  merges the span shards into one trace forest - linkable across pids
  by trace.py's collision-safe span ids.

Every read of a shard or spans.jsonl goes through the torn-read-safe
loaders :func:`read_json_torn_safe` / :func:`read_jsonl_tolerant`
(style-gated in tests/test_torch_style.py): a process killed mid-export
costs the fleet one shard's freshness, never the whole scrape.

Stdlib-only, like the rest of obs/: the measurement plane does not
depend on the stack it measures.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from typing import Iterable, Optional

from .metrics import (
    metrics_registry,
    process_instance,
    prometheus_text_from_json,
    sanitize_metric_name,
    _fmt_value,
    _numeric_leaves,
    _sanitize_instance,
)
from .trace import TRACE_CONTEXT_ENV, build_trees, tracer

log = logging.getLogger("transmogrifai_tpu_torch.obs")

__all__ = [
    "FleetAggregator",
    "ObsShipper",
    "SHARD_SUFFIX",
    "child_env",
    "read_json_torn_safe",
    "read_jsonl_tolerant",
    "serving_views",
    "ship_now",
]

#: per-process shard files in an aggregation dir: ``<instance>`` +
#: this suffix (tempfiles carry ``.tmp`` and are never read)
SHARD_SUFFIX = ".obsshard.json"

#: a shard whose mtime-heartbeat is older than this is a dead process
#: (the PeerHealth staleness convention); env knob for fleets whose
#: shippers beat slower
DEFAULT_STALE_S = 60.0


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# trace-context propagation
# ---------------------------------------------------------------------------
def child_env(env: Optional[dict] = None) -> dict:
    """Environment for a child process that should JOIN this process's
    trace: a copy of ``env`` (default ``os.environ``) with
    ``TX_OBS_TRACE_CONTEXT`` set to the ambient span's context.  With
    no exportable context (tracer disabled, no span open, nothing
    adopted) the var is REMOVED - a stale inherited context must not
    graft a child onto a long-finished trace."""
    out = dict(os.environ if env is None else env)
    ctx = tracer().current_context()
    if ctx:
        out[TRACE_CONTEXT_ENV] = ctx
    else:
        out.pop(TRACE_CONTEXT_ENV, None)
    return out


# ---------------------------------------------------------------------------
# torn-read-safe loaders (THE way fleet files are read; style-gated)
# ---------------------------------------------------------------------------
def read_json_torn_safe(path: str) -> Optional[dict]:
    """Read one JSON document, returning ``None`` for ANY torn state -
    vanished file (shipper replaced it mid-listing), partial/corrupt
    bytes (a writer SIGKILLed mid-write on a filesystem whose rename
    discipline failed), or a non-dict payload.  Callers count the None,
    they never see the exception: one dying process must not take down
    the fleet scrape."""
    try:
        with open(path, "rb") as f:
            doc = json.loads(f.read().decode("utf-8", "replace"))
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def read_jsonl_tolerant(path: str) -> tuple[list[dict], int]:
    """Read a JSONL file skip-and-count style: returns the parseable
    records plus how many lines were skipped (truncated tail from a
    process killed mid-export, corrupt bytes).  Shared by the fleet
    span merger and ``tx obs trace`` - a partial last line must cost
    one span, not the whole trace read."""
    records: list[dict] = []
    skipped = 0
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line.decode("utf-8", "replace"))
            except ValueError:
                skipped += 1
                continue
            if isinstance(rec, dict):
                records.append(rec)
            else:
                skipped += 1
    return records, skipped


def serving_views(metrics_doc: dict):
    """``(view_key, snapshot)`` pairs for every ServingTelemetry view
    registered in one metrics document - THE shared filter for every
    fleet consumer that walks shard serving state (router dispatch
    weights, fleet canary snapshots, ``tx fleet status``,
    ``tx autotune report`` over an aggregation dir), so the view-key
    scheme has one reader, not four copies."""
    for key, snap in (metrics_doc.get("views") or {}).items():
        if key.partition("/")[0] == "serving" and isinstance(snap, dict):
            yield key, snap


# ---------------------------------------------------------------------------
# shipping (per-process -> aggregation dir)
# ---------------------------------------------------------------------------
def ship_now(agg_dir: str, instance: Optional[str] = None,
             extra: Optional[dict] = None) -> str:
    """Export this process's whole observability plane into its
    per-process shard file: the MetricsRegistry document (stamped with
    the process ``instance``) plus the tracer's retained span ring.
    Tempfile + atomic ``os.replace`` - a reader sees the previous
    complete shard or the new complete shard, nothing between; the
    resulting mtime IS the heartbeat."""
    os.makedirs(agg_dir, exist_ok=True)
    # sanitized: the instance becomes a label value AND this filename -
    # a path separator in a caller-supplied replica name must not
    # escape the aggregation dir
    inst = _sanitize_instance(instance) if instance \
        else process_instance()
    doc = {
        "instance": inst,
        "pid": os.getpid(),
        "shipped_at": time.time(),  # epoch stamp (correlation only;
        # liveness is judged from the file's mtime, not this field)
        "metrics": dict(metrics_registry().to_json(), instance=inst),
        "spans": tracer().spans(),
    }
    if extra:
        doc.update(extra)
    path = os.path.join(agg_dir, inst + SHARD_SUFFIX)
    # dumps-then-write, compact separators: one string built in memory
    # is cheaper than a streamed json.dump to the file handle on a full
    # span ring, and the shipper beats once a second for the process's
    # whole life
    payload = json.dumps(doc, separators=(",", ":"), default=str)
    fd, tmp = tempfile.mkstemp(dir=agg_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(payload)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass  # the replace may already have consumed it
        raise
    return path


class ObsShipper:
    """Background thread shipping this process's plane every
    ``interval_s`` (and once more at ``stop()``, so the final state of
    a cleanly-exiting process is never lost).  A failed ship is counted
    and retried next beat, never raised into the process being
    observed.  Context manager; every wait is bounded (the parallel/
    discipline - a shipper must never be the thing that wedges exit)."""

    def __init__(self, agg_dir: str, interval_s: float = 1.0,
                 instance: Optional[str] = None,
                 extra_fn=None) -> None:
        self.agg_dir = agg_dir
        self.interval_s = max(0.01, float(interval_s))
        self.instance = instance or process_instance()
        #: zero-arg callable whose dict is merged into every shipped
        #: shard (a serving replica stamps its per-replica state -
        #: generation, rows scored, in-flight - so the aggregation dir
        #: carries replica state, not just metrics)
        self.extra_fn = extra_fn
        self.ships_ok = 0
        self.ships_failed = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _ship_once(self) -> None:
        extra = None
        if self.extra_fn is not None:
            try:
                extra = dict(self.extra_fn())
            except Exception as e:  # noqa: BLE001 - shipping stays up
                log.warning("obs shipper: extra_fn failed: %s", e)
        try:
            ship_now(self.agg_dir, instance=self.instance, extra=extra)
            self.ships_ok += 1
        except OSError as e:
            self.ships_failed += 1
            log.warning("obs shipper: export to %s failed: %s",
                        self.agg_dir, e)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._ship_once()

    def start(self) -> "ObsShipper":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="tx-obs-shipper")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)
        self._ship_once()  # final state, post-thread

    def __enter__(self) -> "ObsShipper":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# aggregation (aggregation dir -> one scrape / one trace tree)
# ---------------------------------------------------------------------------
class FleetAggregator:
    """Merge the live per-process shards of an aggregation dir.

    *Live* means the shard file's mtime-heartbeat is fresher than
    ``stale_after_s`` (``TX_OBS_FLEET_STALE_S``, default 60): a
    SIGKILLed process stops beating and ages out of the scrape instead
    of serving its last numbers forever.  Torn/partial shards are
    skipped and counted (:func:`read_json_torn_safe` is the only way
    this class touches shard bytes - style-gated)."""

    def __init__(self, agg_dir: str,
                 stale_after_s: Optional[float] = None) -> None:
        self.agg_dir = agg_dir
        self.stale_after_s = (
            _env_float("TX_OBS_FLEET_STALE_S", DEFAULT_STALE_S)
            if stale_after_s is None else float(stale_after_s)
        )
        self.last_report: dict = {}

    # -- collection ---------------------------------------------------------
    def _staleness_s(self, path: str) -> Optional[float]:
        """Seconds since the shard's last heartbeat (mtime), clamped at
        0 for clock skew; None when the file vanished.  Epoch-clock
        subtraction is deliberate: mtimes only exist on the epoch
        timeline (the supervisor.staleness precedent)."""
        try:
            return max(0.0, time.time() - os.path.getmtime(path))
        except OSError:
            return None

    def shards(self) -> list[dict]:
        """The live, readable shard documents (sorted by instance).
        Side effect: ``last_report`` records how many shards were live,
        stale, and torn - silent exclusion is how a half-dead fleet
        reads as healthy."""
        live: list[dict] = []
        stale = torn = 0
        try:
            names = sorted(os.listdir(self.agg_dir))
        except OSError:
            names = []
        for name in names:
            if not name.endswith(SHARD_SUFFIX):
                continue
            path = os.path.join(self.agg_dir, name)
            s = self._staleness_s(path)
            if s is None or s > self.stale_after_s:
                stale += 1
                continue
            doc = read_json_torn_safe(path)
            if doc is None:
                torn += 1
                continue
            doc.setdefault("instance", name[: -len(SHARD_SUFFIX)])
            live.append(doc)
        live.sort(key=lambda d: str(d.get("instance")))
        self.last_report = {
            "shards_live": len(live),
            "shards_stale": stale,
            "shards_torn": torn,
            "instances": [str(d.get("instance")) for d in live],
        }
        return live

    # -- metrics ------------------------------------------------------------
    @staticmethod
    def _flat_series(metrics_doc: dict) -> dict[str, tuple]:
        """Flatten one shard's metrics document to the same sample
        names its exposition carries (``tx_<name>`` /
        ``tx_<kind>_<path>``), each as a ``(sum, max)`` pair - a
        process can hold SEVERAL views of one kind (a deploy's stable +
        canary ServingTelemetry both flatten to
        ``tx_serving_rows_scored``), and last-one-wins would silently
        drop all but one from the fleet rollup."""
        out: dict[str, tuple] = {}

        def _acc(name: str, v: float) -> None:
            prev = out.get(name)
            out[name] = (v, v) if prev is None else (
                prev[0] + v, v if v > prev[1] else prev[1])

        for name, s in metrics_doc.get("series", {}).items():
            pname = sanitize_metric_name(name)
            if s.get("type") == "histogram":
                _acc(pname + "_sum", float(s.get("sum", 0.0)))
                _acc(pname + "_count", float(s.get("count", 0)))
            else:
                _acc(pname, float(s.get("value", 0.0)))
        for key, snap in metrics_doc.get("views", {}).items():
            kind = key.partition("/")[0]
            for path, value in _numeric_leaves(snap):
                _acc(sanitize_metric_name(
                    kind + "_" + "_".join(path)), float(value))
        return out

    def fleet_rollup(self,
                     shards: Optional[Iterable[dict]] = None) -> dict:
        """Fleet-level aggregates over the live shards: per flattened
        sample name, the SUM and the MAX across processes (sum answers
        "how many rows did the fleet score", max answers "what is the
        worst replica's p99"), plus which instances contributed."""
        if shards is None:
            shards = self.shards()
        sums: dict[str, float] = {}
        maxes: dict[str, float] = {}
        instances = []
        for doc in shards:
            instances.append(str(doc.get("instance")))
            for name, (s, m) in self._flat_series(
                    doc.get("metrics", {})).items():
                sums[name] = sums.get(name, 0.0) + s
                if name not in maxes or m > maxes[name]:
                    maxes[name] = m
        return {"instances": instances, "sum": sums, "max": maxes}

    def prometheus_text(self) -> str:
        """One scrape for the whole fleet: every live shard rendered by
        THE shared renderer under its own ``instance`` label (comment
        lines deduplicated - one ``# TYPE`` per metric), then the
        fleet rollup as ``instance="fleet"`` samples with an ``agg``
        label (``sum``/``max``)."""
        shards = self.shards()
        lines: list[str] = []
        seen_comments: set[str] = set()
        for doc in shards:
            text = prometheus_text_from_json(
                doc.get("metrics", {}), instance=str(doc.get("instance"))
            )
            for line in text.splitlines():
                if line.startswith("#"):
                    if line in seen_comments:
                        continue
                    seen_comments.add(line)
                lines.append(line)
        rollup = self.fleet_rollup(shards)
        for agg in ("sum", "max"):
            for name in sorted(rollup[agg]):
                lines.append(
                    f'{name}{{instance="fleet",agg="{agg}"}} '
                    f"{_fmt_value(rollup[agg][name])}")
        return "\n".join(lines) + "\n"

    def merged_metrics_docs(self) -> list[dict]:
        """The live shards' registry documents (each stamped with its
        instance) - the multi-process evaluation surface the SLO engine
        consumes (slo.py resolves sums/maxes across them)."""
        return [
            dict(d.get("metrics", {}), instance=str(d.get("instance")))
            for d in self.shards()
        ]

    # -- spans --------------------------------------------------------------
    def merged_spans(self) -> list[dict]:
        """Every live shard's span records concatenated, each stamped
        with the pid it came from; collision-safe span ids (trace.py)
        mean records from different processes link into one tree when
        the child adopted the parent's exported context."""
        out: list[dict] = []
        for doc in self.shards():
            pid = doc.get("pid")
            for rec in doc.get("spans", ()):
                if isinstance(rec, dict):
                    out.append(dict(rec, pid=pid))
        return out

    def span_trees(self) -> list[dict]:
        """The fleet's merged trace forest (``tx obs trace`` over an
        aggregation dir renders exactly this)."""
        return build_trees(self.merged_spans())

    def to_json(self) -> dict:
        """One document for the whole fleet: shard membership report,
        rollup, and per-instance registry documents."""
        shards = self.shards()
        return {
            "report": dict(self.last_report),
            "fleet": self.fleet_rollup(shards),
            "processes": {
                str(d.get("instance")): d.get("metrics", {})
                for d in shards
            },
        }



def health_views(metrics_doc: dict):
    """``(view_key, snapshot)`` pairs for every ``fleet_health`` view in
    one metrics document (the per-replica failure-detector plane the
    fleet router registers) - the shared filter for consumers that
    surface ejection/readmission state from a router shard (dashboards
    scraping ``tx_fleet_health_*``)."""
    for key, snap in (metrics_doc.get("views") or {}).items():
        if key.partition("/")[0] == "fleet_health" \
                and isinstance(snap, dict):
            yield key, snap


def autoscaler_views(metrics_doc: dict):
    """``(view_key, snapshot)`` pairs for every ``autoscaler`` view in
    one metrics document (an elastic-capacity control loop registers
    exactly one per process) - the shared filter for consumers
    surfacing scale-decision state from a control-plane shard
    (dashboards scraping ``tx_autoscaler_*``)."""
    for key, snap in (metrics_doc.get("views") or {}).items():
        if key.partition("/")[0] == "autoscaler" \
                and isinstance(snap, dict):
            yield key, snap
