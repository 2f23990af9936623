"""transmogrifai_tpu_torch.fleet: the scale-out serving fleet.

Host copy of ``transmogrifai_tpu/fleet/``: N replica worker processes
(:mod:`.worker`), each serving the registry's model through the
serving stack on its own device (the card by default, every replica
with its own CUDA context), behind a least-loaded front router that
dispatches over bounded per-replica channels with at-least-once
failover and health-gated ejection/readmission (:mod:`.router` /
:mod:`.channel`); the registry drives the fleet's lifecycle - rolling
zero-drop hot-swap and a fleet-wide canary with rollback signals
aggregated through the obs plane and SLO engine (:mod:`.controller`).

    registry = ModelRegistry(root); registry.publish(model, stage="stable")
    with FleetController(root, "myapp:build_workflow", n_replicas=4) as fc:
        results = fc.router.score_batch(records)
        fc.rolling_deploy("v2")          # zero-drop, one replica at a time

``FleetController(..., device="cpu")`` runs a CPU fleet; the default
``"cuda"`` raises without a card.  The channel speaks AF_UNIX on-host
(the fast path) or TCP cross-host (``transport="tcp"`` / any
``host:port`` address), with per-frame CRC32 integrity and an OP_HELLO
handshake either way.

The :mod:`.multimodel` layer turns the fleet into a model-multiplexed
platform: each replica hosts N registry versions in a
:class:`ModelTable` (a weighted LRU over the resident models - evict
cold, rehydrate by re-deploying from the registry), the router
dispatches per ``model_id`` with per-model quotas, a
:class:`PlacementPlanner` decides co-residency from the cost model, and
every hosted model keeps its own canary -> promote / rollback
lifecycle.

Fault points: ``fleet.replica_kill`` (a worker dies mid-serve like a
SIGKILL), ``fleet.router_stall`` (the dispatcher wedges for a beat),
``fleet.model_evict_storm`` and the socket seams - ``fleet.partition``
(both directions dark), ``fleet.half_open`` (accepts, never
responds), ``fleet.slow_peer``, ``channel.corrupt_frame``,
``fleet.reconnect_storm``.

The :mod:`.autoscaler` closes the capacity loop: a
:class:`FleetAutoscaler` control loop grows and shrinks the replica
count against offered load (SLO burn as the trigger, cost-model
sizing, hysteresis via :class:`ScaleGovernor`), with probe-gated
admission, drain-based retirement and a live A/B knob retune over the
workers' ``retune`` verb; every :class:`AutoscaleDecision` carries its
evidence.  New replicas come up on the fleet's device like the first
ones.  Its fault point ``autoscaler.crash`` kills the control loop
only; the data plane keeps serving.
"""
from .autoscaler import (
    AutoscaleDecision,
    FleetAutoscaler,
    ScaleGovernor,
)
from .channel import (
    ChannelClosedError,
    ChannelProtocolError,
    ChannelTimeoutError,
    FleetChannel,
    decode_records,
    decode_results,
    encode_records,
    encode_results,
    parse_address,
)
from .controller import (
    FleetController,
    merge_serving_snapshots,
)
from .multimodel import (
    ModelTable,
    MultiModelError,
    PlacementPlan,
    PlacementPlanner,
    UnhostedModelError,
    UnknownModelError,
    format_models_arg,
    parse_models_arg,
)
from .router import (
    BrownoutShedError,
    FleetBatch,
    FleetDecodeError,
    FleetError,
    FleetResult,
    FleetRouter,
    FleetWorkerError,
    ModelQuotaError,
    ReplicaHandle,
    ReplicaHealth,
)
from .worker import ReplicaWorker

__all__ = [
    "AutoscaleDecision",
    "BrownoutShedError",
    "ChannelClosedError",
    "ChannelProtocolError",
    "ChannelTimeoutError",
    "FleetAutoscaler",
    "FleetBatch",
    "FleetChannel",
    "FleetController",
    "FleetDecodeError",
    "FleetError",
    "FleetResult",
    "FleetRouter",
    "FleetWorkerError",
    "ModelQuotaError",
    "ModelTable",
    "MultiModelError",
    "PlacementPlan",
    "PlacementPlanner",
    "ReplicaHandle",
    "ReplicaHealth",
    "ReplicaWorker",
    "ScaleGovernor",
    "UnhostedModelError",
    "UnknownModelError",
    "decode_records",
    "decode_results",
    "encode_records",
    "encode_results",
    "format_models_arg",
    "merge_serving_snapshots",
    "parse_address",
    "parse_models_arg",
]
