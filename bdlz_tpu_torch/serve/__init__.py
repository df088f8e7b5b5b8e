"""Serving layer over the yield-surface emulator (counterpart of
``bdlz_tpu/serve``, its serving core):

* single service — request queue + dynamic batching (max-batch /
  max-wait), per-request exact fallback for out-of-domain and
  error-gated queries, per-batch ``ServeStats`` rows (``service.py``,
  ``batcher.py``);
* fleet — query replicas on the visible cards (round-robin when there
  are more replicas than cards), least-loaded or round-robin routing,
  admission control and deadline shedding (``fleet.py``);
* health plane — per-replica breakers, bit-identical re-answer,
  registry re-provision and a loud degraded exact mode (``health.py``);
* rollout — stage, warm, atomic cutover and error-budget auto-rollback;
  every response carries the artifact hash that answered
  (``rollout.py``);
* multi-tenant plane — scenario- or hash-routed per-artifact pools with
  cold admission from the registry, autoscaling under a replica ceiling,
  memory-budget eviction answered by the loud ``"pool_evicted"`` exact
  path, and typed ``TenancyError`` skew rejection (``tenancy.py``);
* cross-host fabric — host-lease membership through the shared store,
  lease-fenced routing with whole-host failover, loud
  ``"store_partition"`` exact answers, and idle-host elastic chunk
  stealing (``fabric.py``).

The typed errors (``QueueFull``, ``DeadlineExceeded``,
``ServiceUnavailable``, ``RolloutError``) export here.  Entry point:
``python -m bdlz_tpu_torch.serve``."""
from bdlz_tpu_torch.serve.batcher import (  # noqa: F401
    BatchResult,
    DeadlineExceeded,
    MicroBatcher,
    QueueFull,
    ServiceUnavailable,
    drain_results,
)
from bdlz_tpu_torch.serve.fabric import (  # noqa: F401
    REASON_STORE_PARTITION,
    FabricError,
    FabricHost,
    FabricPartitionError,
    GlobalRouter,
    ServingFabric,
)
from bdlz_tpu_torch.serve.fleet import (  # noqa: F401
    FleetResponse,
    FleetService,
    ReplicaSet,
)
from bdlz_tpu_torch.serve.health import (  # noqa: F401
    BreakerPolicy,
    HealthPlane,
    resolve_health_policy,
)
from bdlz_tpu_torch.serve.rollout import (  # noqa: F401
    ArtifactRollout,
    RolloutError,
    looks_like_content_hash,
)
from bdlz_tpu_torch.serve.service import (  # noqa: F401
    REASON_DEGRADED,
    REASON_OOD,
    REASON_PREDICTED_ERROR,
    ExactFallback,
    ServeAnswer,
    YieldService,
    gate_fallback_masks,
    resolve_error_gate,
    resolve_service_static,
)
from bdlz_tpu_torch.serve.tenancy import (  # noqa: F401
    REASON_POOL_EVICTED,
    MultiTenantService,
    PoolState,
    TenancyError,
)
