"""Content identities and the content-addressed store (counterpart of
``bdlz_tpu/provenance``; the artifact registry and leases come with
serving, ROADMAP D7)."""
from bdlz_tpu_torch.provenance.identity import (  # noqa: F401
    MCMC_RNG_STREAM,
    SCHEMA_VERSION,
    Identity,
    array_part,
    config_payload,
    emulator_artifact_identity,
    mcmc_segment_identity,
    multidomain_artifact_identity,
    static_payload,
    sweep_chunk_identity,
    sweep_identity,
)
from bdlz_tpu_torch.provenance.store import (  # noqa: F401
    Store,
    StoreStats,
    StoreUntrustedError,
    default_store_root,
    resolve_store,
)
