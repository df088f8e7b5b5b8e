"""Content identities, the content-addressed store and the artifact
registry (counterpart of ``bdlz_tpu/provenance``)."""
from bdlz_tpu_torch.provenance.identity import (  # noqa: F401
    MCMC_RNG_STREAM,
    SCHEMA_VERSION,
    Identity,
    array_part,
    config_payload,
    emulator_artifact_identity,
    mcmc_segment_identity,
    multidomain_artifact_identity,
    refcache_identity,
    reference_code_fingerprint,
    static_payload,
    sweep_chunk_identity,
    sweep_identity,
    traffic_snapshot_identity,
)
from bdlz_tpu_torch.provenance.registry import (  # noqa: F401
    ARTIFACT_KIND,
    LEASE_KIND,
    ArtifactCache,
    create_lease,
    fetch_artifact,
    fetch_artifact_with_retry,
    lease_entry_name,
    publish_artifact,
    read_lease,
    reset_fetch_counter,
    write_lease,
)
from bdlz_tpu_torch.provenance.store import (  # noqa: F401
    Store,
    StoreStats,
    StoreUntrustedError,
    default_store_root,
    resolve_store,
)
