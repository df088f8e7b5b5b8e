"""Parallelism layer: device meshes, the mesh-split sweep engine with
checkpoint/resume, the process group of multi-process runs, and the
elastic work-stealing fleet over a shared store.

Counterpart of ``bdlz_tpu/parallel``.  Scale comes from a mesh of torch
devices (``mesh.py``):

* **dp** — the batch (parameter-grid) axis: each chunk of the flattened
  sweep is split over the members, each evaluating its rows on its own
  device and CUDA stream, with no communication until the gather;
* **sp** — the intra-point axis: for giant-grid convergence studies one
  point's y-quadrature is split over the members (``gridshard.py``) and
  the partial sums are added, in member order and by one all-reduce.

Past one process, ``init_multihost`` joins a ``torch.distributed`` group
(``gloo`` for the host control plane, NCCL for device tensors on first
use), the mesh spans every process's members, and the sweep, the
samplers and the serving rollout agree where JAX's do.
"""
from bdlz_tpu_torch.parallel.mesh import batch_sharding, make_mesh, replicated_sharding
from bdlz_tpu_torch.parallel.multihost import (  # noqa: F401
    elect_coordinator,
    init_multihost,
    process_count,
    process_index,
    process_local_bounds,
    shard_global_chunk,
)
from bdlz_tpu_torch.parallel.scheduler import (  # noqa: F401
    CommitMismatchError,
    ElasticError,
    ElasticPlan,
    LeasePlane,
    ManualClock,
    WallClock,
    ensure_job_record,
    plan_elastic_sweep,
    publish_chunk,
    run_sweep_elastic,
)
from bdlz_tpu_torch.parallel.sweep import (  # noqa: F401
    SweepPlan,
    SweepResult,
    build_grid,
    plan_sweep,
    run_sweep,
    sweep_step,
)
from bdlz_tpu_torch.parallel.worker import Worker, WorkerCrashError, run_worker_loop

__all__ = [
    "init_multihost",
    "process_local_bounds",
    "shard_global_chunk",
    "elect_coordinator",
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "build_grid",
    "sweep_step",
    "run_sweep",
    "SweepResult",
    "ElasticError",
    "CommitMismatchError",
    "ElasticPlan",
    "LeasePlane",
    "ManualClock",
    "WallClock",
    "plan_elastic_sweep",
    "publish_chunk",
    "run_sweep_elastic",
    "Worker",
    "WorkerCrashError",
    "run_worker_loop",
]
