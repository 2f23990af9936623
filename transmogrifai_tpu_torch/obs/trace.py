"""Run-scoped trace spans: contextvar propagation, ns timing, ring
buffer, JSONL export.

Host copy of ``transmogrifai_tpu/obs/trace.py``: one trace id follows
a run across every subsystem boundary - the workflow's ``workflow.train``
and ``workflow.ingest`` spans and the reader's ``ingest.read`` span are
parented through :data:`contextvars`, so a run's ingest and training
line up into one tree.  A parent process exports its ambient span's
context through ``TX_OBS_TRACE_CONTEXT`` (``obs.child_env``) and a
child's tracer adopts it, so one trace id follows a run into the
processes it spawns.

Design constraints, in order:

* **hot-path cheap**: a span is two ``time.perf_counter_ns()`` calls, a
  contextvar set/reset, one small dict, and one deque append - no
  string formatting, no I/O, no uuid on the child path (trace ids are
  minted only at roots).  Cheap enough to leave ON in a hot path.
* **bounded**: completed spans land in a ring buffer
  (``collections.deque(maxlen=...)``); evictions are counted
  (``spans_evicted``), never errors - tracing memory must not grow with
  uptime any more than telemetry reservoirs do.
* **stdlib only**: the trace plane does not depend on the stack it
  measures.

Spans feed the always-on :class:`~transmogrifai_tpu_torch.obs.profiler.
SpanProfiler` at completion (EWMA + histogram per span name, p99 tail
exemplars), and export as JSONL (one span per line) for offline tree
reconstruction (``tx obs trace``).
"""
from __future__ import annotations

import contextvars
import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Optional

from .profiler import SpanProfiler

log = logging.getLogger("transmogrifai_tpu_torch.obs")

__all__ = [
    "Span",
    "TRACE_CONTEXT_ENV",
    "Tracer",
    "current_context",
    "parse_context",
    "reset_tracer",
    "set_enabled",
    "span",
    "tracer",
]

#: the cross-process trace-context seam: a parent process
#: exports ``<trace_id>:<span_id>`` of its ambient span into this env
#: var before spawning a child, and the child's Tracer ADOPTS it at
#: construction - every root span the child mints then joins the
#: parent's trace (same trace id, parented to the exporting span), so
#: one trace id follows a run through supervisor re-dispatch, mesh-peer
#: bootstrap, and deploy-drill children.
TRACE_CONTEXT_ENV = "TX_OBS_TRACE_CONTEXT"


def parse_context(value: Optional[str]) -> tuple[Optional[str], Optional[int]]:
    """Parse a ``<trace_id>:<span_id>`` context string (the
    :data:`TRACE_CONTEXT_ENV` format).  Malformed input yields
    ``(None, None)`` - a garbled env var must degrade to a fresh local
    trace, never crash a child at import time."""
    if not value:
        return None, None
    trace_id, sep, span_part = value.strip().rpartition(":")
    if not sep or not trace_id:
        return None, None
    try:
        return trace_id, int(span_part)
    except ValueError:
        return None, None

#: the ambient span (contextvars so nested spans parent correctly per
#: thread/task; a thread started without a copied context roots a new
#: trace - scheduler worker threads are independent traces by design)
_current: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "tx_obs_current_span", default=None
)

#: ring-buffer capacity (completed spans retained for export)
DEFAULT_CAPACITY = 8192

#: max children a LIVE span accumulates for the profiler's exemplar
#: tree: the ring bounds the flat records, but a long-lived root (a
#: run.serve over millions of batches) would otherwise grow its nested
#: tree without bound.  Past the cap, children are counted
#: (``children_dropped`` on the node, ``tree_children_dropped`` on the
#: tracer) instead of retained.
MAX_TREE_CHILDREN = 256


class Span:
    """One timed operation; used as a context manager.  ``attrs`` are
    JSON-safe key/values (bucket sizes, row counts, fused reasons);
    ``set_attr`` adds outcomes discovered mid-span."""

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "attrs", "t_epoch", "_start_ns", "_children",
                 "_children_dropped", "_token", "_root")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: int, parent_id: Optional[int],
                 attrs: dict, root: bool = False) -> None:
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.t_epoch = 0.0
        self._start_ns = 0
        self._children: list[dict] = []
        self._children_dropped = 0
        self._token = None
        # local-rootness is a flag, not ``parent_id is None``: a root
        # that ADOPTED a cross-process context carries the remote parent
        # span id, yet is still this process's tree root
        self._root = root

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        self.t_epoch = time.time()  # wall stamp for cross-process
        # correlation only - durations come from perf_counter_ns below
        self._start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        end_ns = time.perf_counter_ns()
        _current.reset(self._token)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self.tracer._finish(self, end_ns - self._start_ns)
        # never swallow the exception: spans observe, they do not handle


class _NullSpan:
    """The disabled-tracer stand-in: every operation is a no-op so call
    sites never branch on enablement themselves."""

    __slots__ = ()
    trace_id = None
    span_id = None
    attrs: dict = {}

    def set_attr(self, key: str, value: Any) -> None:
        return None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_NULL_SPAN = _NullSpan()


class Tracer:
    """Span factory + bounded store of completed spans.

    ``enabled=False`` (or env ``TX_OBS_OFF=1``) turns every ``span()``
    into a shared no-op - the observability-off arm of the overhead
    bench.  Completed spans are flat dicts in a ring buffer; parents
    additionally accumulate up to :data:`MAX_TREE_CHILDREN` children
    (overflow counted, not retained) so the profiler can retain a full
    tree for p99 outliers without the ring needing to."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: Optional[bool] = None,
                 profiler: Optional[SpanProfiler] = None) -> None:
        if enabled is None:
            enabled = os.environ.get("TX_OBS_OFF", "").strip().lower() \
                not in ("1", "true")
        self.enabled = bool(enabled)
        self.profiler = profiler if profiler is not None else SpanProfiler()
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=int(capacity))
        # span ids count up from a random 63-bit base so they stay
        # collision-safe when span shards from MANY processes merge into
        # one tree (fleet.py): a per-process count-from-1 would collide
        # on the very first merged pair.  Still one C-level next() on
        # the hot path - no per-span entropy or formatting.
        self._ids = itertools.count(
            int.from_bytes(os.urandom(8), "big") >> 1 or 1
        )
        # trace ids are prefix+counter, NOT per-root entropy: one
        # os.urandom at construction (a system call per root would cost
        # far more than a child span) plus a C-level
        # counter keeps root creation as cheap as child creation.  The
        # prefix is pid + an 8-byte start nonce: pid alone is recycled
        # by the kernel, so two sequential processes could mint the same
        # prefix and collide id-for-id.
        self._trace_prefix = f"{os.getpid():x}-{os.urandom(8).hex()}-"
        self._trace_ids = itertools.count(1)
        # cross-process context adoption (the TRACE_CONTEXT_ENV seam):
        # when a parent process exported its ambient span, every root
        # this tracer mints joins that trace instead of starting one
        self._adopted_trace, self._adopted_parent = parse_context(
            os.environ.get(TRACE_CONTEXT_ENV)
        )
        self.contexts_adopted = 1 if self._adopted_trace else 0
        self.spans_recorded = 0
        self.spans_evicted = 0
        self.traces_started = 0
        self.tree_children_dropped = 0

    # -- recording ----------------------------------------------------------
    def span(self, name: str, **attrs: Any):
        """Open a span parented to the ambient one (a new root - and a
        new trace id - when there is none)."""
        if not self.enabled:
            return _NULL_SPAN
        parent = _current.get()
        if parent is None or parent.tracer is not self:
            if self._adopted_trace is not None:
                # adopted cross-process context: this root joins the
                # parent process's trace, parented to the exporting span
                trace_id = self._adopted_trace
                parent_id = self._adopted_parent
            else:
                trace_id = self._trace_prefix + format(
                    next(self._trace_ids), "x")
                parent_id = None
            return Span(self, name, trace_id, next(self._ids),
                        parent_id, attrs, root=True)
        return Span(self, name, parent.trace_id, next(self._ids),
                    parent.span_id, attrs)

    def event(self, name: str, **attrs: Any) -> None:
        """A zero-duration marker span (registry lifecycle events,
        breaker transitions): rides the ambient trace like any child."""
        if not self.enabled:
            return
        with self.span(name, **attrs):
            pass

    def _finish(self, s: Span, wall_ns: int) -> None:
        # no round() here: formatting belongs to export, not to a path
        # that runs once per serving batch
        record = {
            "trace": s.trace_id,
            "span": s.span_id,
            "parent": s.parent_id,
            "name": s.name,
            "t_epoch": s.t_epoch,
            "wall_ms": wall_ns / 1e6,
        }
        if s.attrs:
            record["attrs"] = s.attrs
        # the ring keeps FLAT records; the nested node exists only so a
        # root's full tree can reach the profiler's tail sampler
        node = dict(record, children=s._children) if s._children \
            else record
        if s._children_dropped:
            node = dict(node, children_dropped=s._children_dropped)
        parent = _current.get()  # __exit__ already reset the context
        tree = None
        dropped = 0
        if (s._root or parent is None
                or parent.tracer is not self):
            tree = node
        elif len(parent._children) < MAX_TREE_CHILDREN:
            parent._children.append(node)
        else:
            # bounded tree: keep the first MAX_TREE_CHILDREN exemplar
            # children, count the rest - a long-lived root must not
            # grow memory with every serve batch under it
            parent._children_dropped += 1
            dropped = 1
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.spans_evicted += 1
            self._spans.append(record)
            self.spans_recorded += 1
            self.tree_children_dropped += dropped
            if s._root:
                self.traces_started += 1
        self.profiler.observe(s.name, record["wall_ms"], tree)

    # -- cross-process context ----------------------------------------------
    def adopt_context(self, value: Optional[str]) -> bool:
        """Adopt a foreign trace context IN-PROCESS (the
        :data:`TRACE_CONTEXT_ENV` seam only runs at construction): the
        bulk job's resume path joins the PLANNING process's trace this
        way, so plan -> score -> commit -> resume is one trace across
        kills.  A no-op (False) on a malformed context, when this
        tracer already adopted one, or when a span is open - joining a
        foreign trace mid-span would orphan the open root."""
        trace_id, parent = parse_context(value)
        if trace_id is None or self._adopted_trace is not None:
            return False
        if self.current_context() is not None:
            return False
        self._adopted_trace, self._adopted_parent = trace_id, parent
        self.contexts_adopted += 1
        return True

    def current_context(self) -> Optional[str]:
        """The ambient span's ``<trace_id>:<span_id>`` context string
        (the :data:`TRACE_CONTEXT_ENV` payload), or - with no span open
        - the adopted context this tracer itself inherited, so a
        middle process relays its parent's trace to grandchildren even
        between spans.  None when there is nothing to propagate."""
        cur = _current.get()
        if cur is not None and cur.tracer is self:
            return f"{cur.trace_id}:{cur.span_id}"
        if self._adopted_trace is not None:
            return f"{self._adopted_trace}:{self._adopted_parent}"
        return None

    # -- reading ------------------------------------------------------------
    def spans(self, trace_id: Optional[str] = None) -> list[dict]:
        with self._lock:
            out = list(self._spans)
        if trace_id is not None:
            out = [r for r in out if r["trace"] == trace_id]
        return out

    def span_tree(self, trace_id: str) -> list[dict]:
        """Reconstruct the span tree(s) for one trace from the ring
        buffer: returns root nodes with nested ``children`` (a parent
        evicted from the ring orphans its subtree into a root - the
        bounded-buffer tradeoff, counted in ``spans_evicted``)."""
        return build_trees(self.spans(trace_id))

    def export_jsonl(self, path: str,
                     trace_id: Optional[str] = None) -> int:
        """Write retained spans one JSON object per line (the format
        ``tx obs trace`` reads back); returns the span count."""
        records = self.spans(trace_id)
        with open(path, "w") as f:
            for r in records:
                f.write(json.dumps(r, sort_keys=True, default=str))
                f.write("\n")
        return len(records)

    def snapshot(self) -> dict:
        """Self-metrics view (registered with the metrics registry so a
        scrape reports trace-plane health next to everything else)."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "capacity": self._spans.maxlen,
                "spans_retained": len(self._spans),
                "spans_recorded": self.spans_recorded,
                "spans_evicted": self.spans_evicted,
                "traces_started": self.traces_started,
                "contexts_adopted": self.contexts_adopted,
                "tree_children_dropped": self.tree_children_dropped,
            }


def build_trees(records: list[dict]) -> list[dict]:
    """Link flat span records (ring buffer or JSONL) into root trees,
    grouped by trace; shared by :meth:`Tracer.span_tree` and the
    ``tx obs trace`` CLI."""
    nodes = {r["span"]: dict(r, children=[]) for r in records}
    roots = []
    for r in records:
        node = nodes[r["span"]]
        parent = nodes.get(r.get("parent"))
        if parent is not None and parent["trace"] == r["trace"]:
            parent["children"].append(node)
        else:
            roots.append(node)
    return roots


# ---------------------------------------------------------------------------
# module-level plumbing (the mesh_telemetry()/data_telemetry() pattern)
# ---------------------------------------------------------------------------
_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()


def tracer() -> Tracer:
    """The process-wide tracer every subsystem records spans into."""
    global _tracer
    with _tracer_lock:
        if _tracer is None:
            _tracer = Tracer()
            _register_views(_tracer)
        return _tracer


def reset_tracer(capacity: int = DEFAULT_CAPACITY,
                 enabled: Optional[bool] = None) -> Tracer:
    """Fresh tracer + profiler (test/bench isolation), re-registered
    with the CURRENT metrics registry."""
    global _tracer
    with _tracer_lock:
        _tracer = Tracer(capacity=capacity, enabled=enabled)
        _register_views(_tracer)
        return _tracer


def _register_views(t: Tracer) -> None:
    from .metrics import metrics_registry

    reg = metrics_registry()
    reg.register_view("obs_tracer", t)
    reg.register_view("profiler", t.profiler)


def set_enabled(enabled: bool) -> None:
    """Flip the default tracer on/off (the overhead bench's A/B switch;
    spans already open complete normally)."""
    tracer().enabled = bool(enabled)


def span(name: str, **attrs: Any):
    """Convenience: a span on the default tracer (the call-site idiom:
    ``with obs_trace.span("serve.batch", bucket=b): ...``)."""
    return tracer().span(name, **attrs)


def current_context() -> Optional[str]:
    """The default tracer's exportable trace context (see
    :meth:`Tracer.current_context`); the payload child-process spawners
    put in :data:`TRACE_CONTEXT_ENV` (``obs.fleet.child_env`` wraps
    the env-dict plumbing)."""
    return tracer().current_context()
