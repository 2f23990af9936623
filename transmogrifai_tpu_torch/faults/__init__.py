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
serving.batch              InjectedFault inside the compiled batch path
serving.nan_scores         batch outputs poisoned to NaN (guard drill)
serving.slow_batch         the batch path sleeps ``delay`` seconds
serving.schema_drift       the endpoint sees a synthetic schema-contract
                           violation (drift_policy drill)
registry.publish_crash     hard kill between the artifact publish and
                           the registry-index commit (the registry must
                           stay loadable at the prior version)
registry.swap_crash        InjectedFault in the deploy swap window (new
                           endpoint built, pointer not yet flipped - the
                           old generation must keep serving)
canary.regression          live canary outputs poisoned to NaN through
                           the guard + breaker accounting (auto-rollback
                           drill)
canary.latency             the canary arm sleeps ``delay`` seconds
                           inside its timed window (latency-SLO drill)
supervisor.child_kill      the supervisor kills its child (preemption)
continuous.refit_crash     hard kill in the continuous trainer between
                           refit completion and the registry publish (the
                           old stable must keep serving; the next cycle
                           recovers)
drift.false_positive       the continuous detect phase reports a forced
                           trigger on a healthy window
========================== ==================================================

The mesh points fire in ``parallel/resilience.py`` (the watchdog's
worker, before the guarded step) and ``parallel/distributed.py``
(``initialize``'s connect); the serving points in ``serving/endpoint.py``,
the registry and canary points in ``registry/``, the continuous and
drift points in ``continuous/trainer.py``; the reader points also fire
inside the sharded pipeline's worker shards (``readers/pipeline.py``).
The engine accepts every point name of the JAX package; the fleet
points fire in ``fleet/`` (``autoscaler.crash`` in the autoscaler's
loop), the bulk points in ``bulk/`` (``bulk.journal_torn``,
``bulk.commit_crash``, ``bulk.output_crash``) and in the replica worker
(``bulk.replica_die_midshard``).
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
