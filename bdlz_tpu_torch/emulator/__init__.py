"""Yield-surface emulator: an error-controlled tensor-grid surrogate of
the exact pipeline, built by driving the sweep engine and queried by
batched log-space interpolation on the device.  Counterpart of
``bdlz_tpu/emulator``; artifacts and bundles are the same on disk."""
from bdlz_tpu_torch.emulator.artifact import (  # noqa: F401
    FIELDS,
    SCHEMA_VERSION,
    EmulatorArtifact,
    EmulatorArtifactError,
    artifact_hash,
    build_identity,
    check_identity,
    load_artifact,
    save_artifact,
)
from bdlz_tpu_torch.emulator.build import (  # noqa: F401
    AxisSpec,
    BuildReport,
    EmulatorBuildError,
    build_emulator,
    cell_error_estimates,
    make_exact_evaluator,
)
from bdlz_tpu_torch.emulator.grid import (  # noqa: F401
    artifact_hull,
    domain_artifacts,
    domain_error_table,
    error_floor,
    has_error_grid,
    in_domain,
    interp_log_fields,
    make_domain_fn,
    make_error_fn,
    make_query_fn,
    predicted_error,
    select_domains,
)
from bdlz_tpu_torch.emulator.multidomain import (  # noqa: F401
    MULTI_SCHEMA_VERSION,
    MultiDomainArtifact,
    MultiDomainBuildError,
    MultiDomainBuildReport,
    build_seam_split_emulator,
    load_any_artifact,
    load_multidomain_artifact,
    save_multidomain_artifact,
    seam_band_for_box,
)
