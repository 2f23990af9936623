"""Deterministic fault-injection framework (see injection.py).

Host copy of ``transmogrifai_tpu/faults/``: the same named failure points,
armed the same way (``TX_FAULTS`` or :func:`configure`).  The points the
ported modules reach are:

========================== ==================================================
point                      effect at the call site
========================== ==================================================
native.load                the native kernel library reports unavailable
io.save_model.crash        hard process kill mid-artifact-write (tempdir)
io.save_model.crash_window hard kill between the artifact swap renames
reader.malformed_row       a reader row turns malformed/truncated mid-
                           ingest (quarantine/strict drill)
reader.type_flip           a numeric reader cell turns to junk text
                           (type-flip quarantine drill)
collective.delay           a mesh collective straggles ``delay`` seconds
mesh.peer_hang             a mesh peer wedges: the collective stalls on
                           EVERY armed call (the straggler retry stalls
                           too, escalating to shrink-to-survivors)
mesh.peer_die              a mesh peer dies mid-collective (classified
                           dead immediately; no retry, straight to the
                           survivor recompute)
mesh.init_no_coordinator   distributed.initialize: the coordinator never
                           answers (bootstrap-deadline drill)
========================== ==================================================

The mesh points fire in ``parallel/resilience.py`` (the watchdog's
worker, before the guarded step) and ``parallel/distributed.py``
(``initialize``'s connect).  The engine accepts every point name of the
JAX package (serving, io, supervisor, registry, canary, continuous,
drift, bulk, fleet); their call sites come with the subsystems that hold
them (ROADMAP.md queue 1).
"""
from .injection import (
    DEFAULT_KILL_EXIT,
    ENV_VAR,
    FaultPlan,
    FaultSpec,
    FaultSpecError,
    InjectedFault,
    active,
    configure,
    fires,
    inject,
    inject_kill,
    inject_sleep,
    inject_unavailable,
    parse_spec,
    poison_nonfinite,
    reset,
)

__all__ = [
    "DEFAULT_KILL_EXIT",
    "ENV_VAR",
    "FaultPlan",
    "FaultSpec",
    "FaultSpecError",
    "InjectedFault",
    "active",
    "configure",
    "fires",
    "inject",
    "inject_kill",
    "inject_sleep",
    "inject_unavailable",
    "parse_spec",
    "poison_nonfinite",
    "reset",
]
