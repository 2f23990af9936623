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
========================== ==================================================

The engine accepts every point name of the JAX package (serving, io,
supervisor, mesh, registry, canary, continuous, drift, bulk, fleet); their
call sites come with the subsystems that hold them (ROADMAP.md queue 1).
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
