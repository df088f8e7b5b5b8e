"""Content-addressed emulator-artifact registry.

Counterpart of ``bdlz_tpu/provenance/registry.py``: the same store
layout, validation chain, fault site and lease primitives, so an
artifact one package publishes is fetched by the other.

The serving tier's rollout story (``serve/rollout.py``) needs a way to
move artifact builds between hosts that is as tamper-evident as the
artifacts themselves: a build host PUBLISHES an artifact into the shared
store under its content hash, and every serving host STAGES it by hash —
the fetch re-verifies the full artifact validation chain (schema version,
content hash, finite/positive tables) plus that the entry actually IS
the requested hash, so a registry entry can never impersonate another
build.

Entries are directories ``<root>/emulator_artifact/<hash>/`` holding the
standard ``artifact.npz`` + ``manifest.json`` pair (written by
``emulator.artifact.save_artifact``).  Publication is atomic: the pair
is written into a temp directory in the store root and renamed into
place; a loser of a publish race simply discards its temp copy — the
content under a hash is identical by construction.  A corrupt entry is
deleted on fetch (one re-publish, never a poisoned stage).
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile

from bdlz_tpu_torch.provenance.store import Store

ARTIFACT_KIND = "emulator_artifact"


def publish_artifact(store: Store, artifact) -> str:
    """Publish an :class:`~bdlz_tpu_torch.emulator.artifact.EmulatorArtifact`,
    a seam-split :class:`~bdlz_tpu_torch.emulator.multidomain.MultiDomainArtifact`
    bundle, or an artifact/bundle directory path into ``store``; returns
    the content hash it is addressable by (the COMPOSITE hash for a
    bundle — the whole bundle moves as one unit)."""
    from bdlz_tpu_torch.emulator.artifact import EmulatorArtifact, save_artifact
    from bdlz_tpu_torch.emulator.multidomain import (
        MultiDomainArtifact,
        load_any_artifact,
        save_multidomain_artifact,
    )

    if not isinstance(artifact, (EmulatorArtifact, MultiDomainArtifact)):
        artifact = load_any_artifact(str(artifact))
    content_hash = artifact.content_hash
    dest = os.path.join(store.root, ARTIFACT_KIND, content_hash)
    os.makedirs(os.path.join(store.root, ARTIFACT_KIND), mode=0o700,
                exist_ok=True)
    if os.path.isdir(dest):
        store.stats.hits += 1
        return content_hash  # same hash = same bytes; nothing to do
    tmp = tempfile.mkdtemp(dir=store.root, suffix=".tmp")
    try:
        if isinstance(artifact, MultiDomainArtifact):
            save_multidomain_artifact(tmp, artifact)
        else:
            save_artifact(tmp, artifact)
        try:
            os.rename(tmp, dest)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
            # benign ONLY if a concurrent publisher won the rename
            # (identical content under the same hash); any other rename
            # failure must surface — returning a hash that was never
            # published would strand every later fetch
            if not os.path.isdir(dest):
                raise
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    store.stats.writes += 1
    return content_hash


def reset_fetch_counter(store: Store = None) -> None:
    """Reset the ``registry_fetch`` fault-key counter.

    The counter is scoped PER-STORE (the ``store_read`` pattern —
    :meth:`Store.arm_faults`): every :class:`Store` instance starts at
    zero, so two stores in one process (the multi-tenant plane's
    registry + a test's scratch store) can no longer perturb each
    other's fault keys the way the old process-global counter did.
    With a ``store`` the counter is reset on that instance; without one
    the call is a no-op kept for pre-scoping callers (a fresh store IS
    a fresh counter)."""
    if store is not None:
        store._fetches = 0


def _inject_fetch_fault(fault_plan, key: int, path: str) -> None:
    """Apply an armed ``registry_fetch`` fault to the entry BEFORE the
    load: ``torn`` truncates its payload (the corrupt-entry eviction
    path must detect-and-delete), ``corrupt`` flips one byte (the
    content-hash verification must refuse it).  The damaged file is the
    entry's ``artifact.npz`` when present, its ``manifest.json``
    otherwise (a multi-domain bundle's top level)."""
    for name in ("artifact.npz", "manifest.json"):
        target = os.path.join(path, name)
        if os.path.isfile(target):
            fault_plan.corrupt_file("registry_fetch", key, target)
            fault_plan.corrupt_bytes("registry_fetch", key, target)
            return


def fetch_artifact(store: Store, content_hash: str, fault_plan=None):
    """Load + fully validate the published artifact ``content_hash``
    (kind-dispatched: a single artifact or a multi-domain bundle).

    Raises :class:`~bdlz_tpu_torch.emulator.artifact.EmulatorArtifactError`
    when the entry is absent, fails any load-time validation, or its
    verified hash is not the requested one (an impersonating or
    renamed entry); a corrupt entry is deleted first, so the next
    publish starts clean.  ``fault_plan`` (site ``registry_fetch``,
    keyed by the PER-STORE fetch call counter) exercises exactly
    those refusal paths deterministically — see bdlz_tpu_torch/faults.py."""
    from bdlz_tpu_torch.emulator.artifact import EmulatorArtifactError
    from bdlz_tpu_torch.emulator.multidomain import load_any_artifact

    fetch_key = getattr(store, "_fetches", 0)
    store._fetches = fetch_key + 1
    path = os.path.join(store.root, ARTIFACT_KIND, str(content_hash))
    if fault_plan is not None and os.path.isdir(path):
        _inject_fetch_fault(fault_plan, fetch_key, path)
    if not os.path.isdir(path):
        store.stats.misses += 1
        raise EmulatorArtifactError(
            f"no published emulator artifact {content_hash!r} in store "
            f"{store.root}"
        )
    try:
        artifact = load_any_artifact(path)
    except EmulatorArtifactError:
        print(
            f"[registry] published artifact entry {path} failed validation; "
            "deleting the corrupt entry",
            file=sys.stderr,
        )
        shutil.rmtree(path, ignore_errors=True)
        store.stats.dropped_corrupt += 1
        raise
    if artifact.content_hash != str(content_hash):
        raise EmulatorArtifactError(
            f"registry entry {path} verifies as {artifact.content_hash!r}, "
            f"not the requested {content_hash!r}: refusing the impersonating "
            "entry"
        )
    store.stats.hits += 1
    return artifact


def fetch_artifact_with_retry(
    store: Store, content_hash: str, fault_plan=None, retry=None,
    label: str = "registry_fetch",
):
    """:func:`fetch_artifact` under the shared :class:`RetryPolicy`
    (``utils/retry.py`` — bounded attempts, deterministic backoff,
    injectable sleep).

    The serving tier's registry fetches — the health plane's replica
    re-provision and the multi-tenant plane's cold-artifact admission —
    were single-attempt: one torn read or one lost publish race failed
    the whole re-provision cycle.  A corrupt entry is still deleted on
    the failing attempt (so a retry sees a clean absent entry, never
    the same poisoned bytes), and a publish that lands between attempts
    is admitted — the fetch-vs-publish race resolves to a validated
    artifact or a typed :class:`EmulatorArtifactError`, never a torn
    read.  ``retry=None`` keeps the old single-attempt semantics
    exactly (zero behavior change for callers that do not opt in)."""
    from bdlz_tpu_torch.utils.retry import call_with_retry

    if retry is None:
        return fetch_artifact(store, content_hash, fault_plan=fault_plan)
    from bdlz_tpu_torch.emulator.artifact import EmulatorArtifactError

    return call_with_retry(
        lambda: fetch_artifact(store, content_hash, fault_plan=fault_plan),
        retry,
        label=f"{label}:{content_hash}",
        retryable=(EmulatorArtifactError, OSError),
    )


class ArtifactCache:
    """Local pull-through cache in front of :func:`fetch_artifact`.

    Content addressing makes this trivial: an artifact's hash IS its
    identity, so a locally cached copy can be fully re-validated on
    every hit without talking to the shared store at all.  The cache is
    itself a :class:`Store` (reusing ``publish_artifact`` /
    ``fetch_artifact`` wholesale), so a local hit runs the exact same
    validation chain a registry stage does — a *validated* hit, never a
    trusted one.  A corrupt local entry is evicted loudly on the failing
    hit (the registry's corrupt-entry path: stderr line +
    ``dropped_corrupt``) and re-fetched from the shared store — the
    cache can degrade availability, never poison an answer.

    The serving fabric fronts every cold admission with one of these per
    host: whole-host failover re-admits a dead host's tenants by hash,
    so the second host to serve an artifact pays a local validated load
    instead of a shared-store round trip.  ``counters()`` lands on
    ``ServeStats.extras`` (the opt-in summary extension seam).
    """

    def __init__(self, root: str):
        self.store = Store(root)
        self.hits = 0
        self.misses = 0

    @property
    def evictions(self) -> int:
        """Corrupt local entries evicted (and re-fetched) so far."""
        return self.store.stats.dropped_corrupt

    def fetch(self, store: Store, content_hash: str, fault_plan=None,
              retry=None):
        """Fetch-by-hash through the cache: validated local hit, or
        pull-through from ``store`` (under ``fault_plan``/``retry``
        exactly as :func:`fetch_artifact_with_retry`) + local fill."""
        from bdlz_tpu_torch.emulator.artifact import EmulatorArtifactError

        local = os.path.join(self.store.root, ARTIFACT_KIND,
                             str(content_hash))
        if os.path.isdir(local):
            try:
                artifact = fetch_artifact(self.store, content_hash)
                self.hits += 1
                return artifact
            except EmulatorArtifactError:
                # corrupt (already deleted + counted by fetch_artifact)
                # or impersonating (delete here) — either way the local
                # copy is gone and the shared store is authoritative
                shutil.rmtree(local, ignore_errors=True)
        artifact = fetch_artifact_with_retry(
            store, content_hash, fault_plan=fault_plan, retry=retry,
        )
        publish_artifact(self.store, artifact)
        self.misses += 1
        return artifact

    def counters(self) -> dict:
        """Hit/miss/eviction counters (``ServeStats.extras`` payload)."""
        return {
            "hits": self.hits,
            "misses": self.misses,
            "corrupt_evictions": self.evictions,
        }


# ---- lease records (the elastic scheduler's claim plane) ----------------
#
# One small JSON record per (job, chunk) under ``lease/`` in the shared
# store.  The *policy* (TTLs, steal-on-expiry, distinct-failure
# quarantine) lives in ``parallel/scheduler.py``; this layer provides
# only the storage primitives, with the one property the policy cannot
# build for itself: an EXCLUSIVE create (``os.link`` of a temp file —
# atomic on POSIX, fails with EEXIST when another worker claimed first).
# Overwrites (heartbeat, steal, complete) go through the store's atomic
# durable JSON write; a lost overwrite race is safe because the commit
# protocol (first ``put_npz`` wins, later commits verify bitwise) — not
# the lease record — is what makes results correct.  A torn/corrupt
# record reads as None (``Store.get_json`` drops it), which the policy
# treats as a free chunk: the worst case is a double-computation the
# commit protocol resolves.

LEASE_KIND = "lease"


def lease_entry_name(job: str, chunk: int) -> str:
    """Store entry name of the lease record for ``(job, chunk)``."""
    return f"{LEASE_KIND}/{job}_{int(chunk):05d}.json"


def read_lease(store: Store, job: str, chunk: int):
    """The lease record dict, or None when absent/torn (torn records are
    evicted by the store and re-claimable — see module comment)."""
    return store.get_json(lease_entry_name(job, chunk))


def write_lease(store: Store, job: str, chunk: int, record) -> str:
    """Atomically overwrite the lease record (heartbeat/steal/complete)."""
    return store.put_json(lease_entry_name(job, chunk), record)


def create_lease(store: Store, job: str, chunk: int, record) -> bool:
    """Atomically create the lease record IFF absent; True when this
    caller won the claim.  mkstemp + ``os.link`` (not ``os.replace``,
    which would silently overwrite a racing winner): the link fails with
    EEXIST when any other worker already holds the name."""
    import json as jsonlib
    import tempfile

    path = store.path_for(lease_entry_name(job, chunk))
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            jsonlib.dump(record, f)
        try:
            os.link(tmp, path)
        except FileExistsError:
            return False
        store.stats.writes += 1
        return True
    finally:
        try:
            os.remove(tmp)
        except OSError:
            pass
