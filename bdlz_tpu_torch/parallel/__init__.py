"""The sweep engine on one device, and the elastic work-stealing fleet
over a shared store.  Multi-device meshes are ROADMAP D9."""
from bdlz_tpu_torch.parallel.multihost import elect_coordinator  # noqa: F401
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
)
from bdlz_tpu_torch.parallel.worker import Worker, WorkerCrashError, run_worker_loop  # noqa: F401
