"""The device-mesh parallel runtime on ``torch.distributed``: meshes
(mesh.py), the multi-process bootstrap and row reductions
(distributed.py), the hand-written CUDA kernels (kernels.py), and
degraded-mode resilience (resilience.py - the collective watchdog,
file-based peer health, and shrink-to-survivors recovery).

Counterpart of ``transmogrifai_tpu/parallel/__init__.py``.  Imports stay
lazy on purpose: resilience pulls the fault and supervision stack, and a
caller that needs one piece must not pay for the rest.
"""
from __future__ import annotations

_RESILIENCE = {
    "CollectiveStallError",
    "CollectiveWatchdog",
    "DeadlinePolicy",
    "MeshTelemetry",
    "PeerHealth",
    "default_watchdog",
    "guarded_all_reduce_stats",
    "guarded_collective",
    "mesh_telemetry",
    "reset_mesh_telemetry",
    "survivor_mesh",
    "watchdog_enabled",
}
_DISTRIBUTED = {"MeshBootstrapError", "MeshShapeError"}


def __getattr__(name: str):
    if name in _RESILIENCE:
        from . import resilience

        return getattr(resilience, name)
    if name in _DISTRIBUTED:
        from . import distributed

        return getattr(distributed, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = sorted(_RESILIENCE | _DISTRIBUTED)
