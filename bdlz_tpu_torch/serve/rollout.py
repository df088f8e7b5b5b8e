"""Zero-downtime artifact rollout: blue/green over the serving fleet.

Counterpart of ``bdlz_tpu/serve/rollout.py``: stage, warm, cutover,
abort and error-budget auto-rollback, with the same records; across
processes the cutover is agreed as there (the coordinator's staged hash
broadcast, one ``allreduce_min`` vote), the identity in one process.

A production fleet must be able to adopt a rebuilt emulator artifact
(finer refinement, a widened box) without dropping a request or ever
answering from a half-loaded surface.  The protocol is classic
blue/green, riding the PR-3 artifact identity so every way a rollout
can go wrong is loud:

1. **stage** — load artifact N+1 beside the active N.  The load itself
   already rejects schema-version skew, content-hash mismatches, and
   non-finite tables (:func:`~bdlz_tpu_torch.emulator.artifact.load_artifact`);
   staging additionally rejects IDENTITY skew — an artifact built for
   different physics (config knobs, engine, n_y, y-quadrature) than the
   service's exact fallback can never become active.  A fresh
   :class:`~bdlz_tpu_torch.serve.fleet.ReplicaSet` is built on the same
   devices/buckets as the active one.
2. **warm** — compile the staged kernels on every device (recorded as
   ``warmup_seconds`` in the shared ``ServeStats``).  The cutover
   REFUSES an unwarmed stage: no request may pay the compile.
3. **cutover** — fleet-wide agreement first (multi-host runs only; the
   single-process path is the identity): the coordinator broadcasts its
   staged hash and every process compares — any skew (a host staged a
   different build) raises on the host that sees it; then an
   ``allreduce_min`` readiness vote confirms every host reached the
   cutover warmed.  Finally the active replica set is swapped
   atomically under the service's dispatch lock.  Batches already in
   flight on N resolve normally and carry N's hash; batches dispatched
   after the swap carry N+1's — a batch NEVER mixes surfaces, which the
   rollout tests pin via the per-batch ``artifact_hash`` stats rows.

The old replica set is returned from :meth:`ArtifactRollout.cutover`
(and kept as ``.previous``) so an operator can roll back by staging it
again — its kernels are still warm.

**Post-cutover observation + error-budget auto-rollback** (step 4,
``cutover(observe_s=...)``): for ``observe_s`` clock-seconds after the
swap the rollout watches the new artifact's per-batch ``ServeStats``
rows — per-request errors, predicted-error-gated fallbacks, and
(optionally) latency-SLO-breaching batches all charge the budget.  When
more than ``rollback_budget`` of the observed requests are bad, the
retained previous replica set (still warm) is swapped back
AUTOMATICALLY, atomically, with the reason recorded on
``stats.extras["rollbacks"]`` — a bad build costs one observation
window, not an operator page.  The whole loop runs on the service's
injectable clock (the observer fires after every resolved batch), so
tier-1 pins the rollback with a fake clock and the per-batch hash rows.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from bdlz_tpu_torch.emulator.artifact import EmulatorArtifact, check_identity
from bdlz_tpu_torch.emulator.multidomain import MultiDomainArtifact, load_any_artifact
from bdlz_tpu_torch.serve.fleet import FleetService, ReplicaSet

#: Fixed width of the hash-agreement broadcast (content hashes are 16 hex
#: characters; the headroom is the JAX package's wire format).
HASH_WIRE_WIDTH = 64


class RolloutError(RuntimeError):
    """A rollout step that must not proceed: nothing staged, staged
    kernels cold, or hash/identity skew across the fleet.  Typed so
    operators can tell a refused cutover (the service keeps serving N,
    nothing was lost) from a serving failure."""


class ArtifactRollout:
    """Blue/green rollout controller for one :class:`FleetService`.

    Holds at most one staged replica set at a time.  All methods are
    host-side orchestration — the serving hot path never checks rollout
    state; it only ever sees an atomic replica-set swap.
    """

    def __init__(self, service: FleetService, store=None):
        from bdlz_tpu_torch.provenance import resolve_store

        self.service = service
        #: Optional provenance store (docs/provenance.md): when set, a
        #: bare content hash can be staged directly — the artifact is
        #: fetched from the shared registry with the full validation
        #: chain (schema/content-hash/identity) re-verified, which is
        #: how a serving fleet adopts a build another host published.
        self.store = resolve_store(store, label="rollout")
        self._staged: Optional[ReplicaSet] = None
        #: The replica set retired by the last cutover (rollback seam).
        self.previous: Optional[ReplicaSet] = None
        #: The active post-cutover observation window (None = not
        #: observing): new/old hashes, budget, clock bounds, counters.
        self.observation: Optional[Dict[str, Any]] = None
        #: The replica set evicted by the last AUTO-rollback (the bad
        #: build, kept for forensics; its device tables free with it).
        self.rolled_back: Optional[ReplicaSet] = None

    # ---- introspection ----------------------------------------------

    @property
    def active_hash(self) -> str:
        return self.service.artifact_hash

    @property
    def staged_hash(self) -> Optional[str]:
        return None if self._staged is None else self._staged.artifact_hash

    def ready(self) -> bool:
        """True when a staged, warmed replica set awaits cutover."""
        return self._staged is not None and self._staged.warmed

    # ---- the protocol ----------------------------------------------

    def stage(self, artifact, warm: bool = True) -> str:
        """Load/validate artifact N+1 and build its replicas beside N.

        ``artifact`` is an :class:`EmulatorArtifact`, a directory path
        (loaded with full validation), or — when the rollout was
        constructed with a ``store`` — a bare 16-hex content hash, which
        is fetched from the provenance registry
        (:func:`bdlz_tpu_torch.provenance.fetch_artifact`: the entry must
        verify as exactly that hash).  Identity skew — physics the
        service's exact fallback was not built for — raises
        ``EmulatorArtifactError`` here, loudly, before a single replica
        exists.  Re-staging replaces any previous stage.  Returns the
        staged content hash.
        """
        if (
            isinstance(artifact, str)
            and self.store is not None
            and _looks_like_content_hash(artifact)
        ):
            from bdlz_tpu_torch.provenance import fetch_artifact

            artifact = fetch_artifact(self.store, artifact)
        if not isinstance(artifact, (EmulatorArtifact, MultiDomainArtifact)):
            # kind-dispatching load: a staged directory may hold a
            # single artifact or a seam-split bundle
            artifact = load_any_artifact(str(artifact))
        # the PR-3 identity check: N+1 must be valid for the SAME
        # physics/engine/quadrature the service (and its exact fallback)
        # was constructed for — content (axes, values, hash) may differ
        check_identity(artifact, self.service.expected_identity)
        active = self.service.replica_set
        staged = ReplicaSet(
            artifact,
            field=active.field,
            n_replicas=active.n_replicas,
            devices=[r.device for r in active.replicas],
            max_batch_size=active.max_batch_size,
            routing=active.routing,
            warm=False,
            stats=self.service.stats,
            error_gate=getattr(active, "error_gate", True),
            # the staged set inherits the service's armed fault plan, so
            # injected replica faults (and the health plane watching
            # them) survive a cutover
            fault_plan=getattr(active, "_faults", None),
        )
        if warm:
            staged.warm()
        self._staged = staged
        return staged.artifact_hash

    def warm(self) -> float:
        """Warm the staged kernels (idempotent); seconds spent."""
        if self._staged is None:
            raise RolloutError("nothing staged; call stage() first")
        return self._staged.warm()

    def abort(self) -> None:
        """Drop the staged replica set (its device tables are freed with
        it); the active artifact keeps serving untouched."""
        self._staged = None

    def cutover(
        self,
        observe_s: Optional[float] = None,
        budget: Optional[float] = None,
        latency_slo_s: Optional[float] = None,
    ) -> Tuple[str, str]:
        """Atomically make the staged artifact the active surface.

        Refuses (typed :class:`RolloutError`, service untouched) when
        nothing is staged, the stage is cold, or the fleet disagrees on
        WHICH build is being activated.  Returns ``(old_hash,
        new_hash)``.

        ``observe_s`` arms the post-cutover observation window: for
        that many clock-seconds the new artifact's batches are watched
        and, if more than ``budget`` (default: the service's
        ``rollback_budget`` config knob) of its requests are bad —
        per-request errors, predicted-error-gated fallbacks, batches
        served degraded because every breaker opened, or fallback-free
        batches slower than ``latency_slo_s`` — the
        previous replica set is swapped back automatically
        (:meth:`auto_rollback`).  ``None`` (the default) keeps the
        manual-only behavior.
        """
        staged = self._staged
        if staged is None:
            raise RolloutError("nothing staged; call stage() first")
        # kwarg twins of validated config knobs get the same range
        # checks (budget=0 would roll back on the first gated request,
        # budget<0 on a fully CLEAN batch; observe_s<=0 records the
        # window as already passed)
        if observe_s is not None and not float(observe_s) > 0.0:
            raise ValueError(f"observe_s must be > 0, got {observe_s!r}")
        if budget is not None and not (0.0 < float(budget) <= 1.0):
            raise ValueError(
                f"budget must be a fraction in (0, 1], got {budget!r}"
            )
        if latency_slo_s is not None and not float(latency_slo_s) > 0.0:
            raise ValueError(
                f"latency_slo_s must be > 0, got {latency_slo_s!r}"
            )
        _agree_cutover(staged.artifact_hash, staged.warmed)
        old = self.service.swap_replica_set(staged)
        self._staged = None
        self.previous = old
        if observe_s is not None:
            self._arm_observation(
                staged, old, float(observe_s), budget, latency_slo_s
            )
        return old.artifact_hash, staged.artifact_hash

    # ---- post-cutover observation / auto-rollback -------------------

    def _arm_observation(
        self, new_set, old_set, observe_s, budget, latency_slo_s,
    ) -> None:
        svc = self.service
        self.observation = {
            "new_hash": new_set.artifact_hash,
            "old_hash": old_set.artifact_hash,
            "started_at": float(svc._clock()),
            "window_s": float(observe_s),
            "budget": (
                svc.rollback_budget if budget is None else float(budget)
            ),
            "latency_slo_s": (
                None if latency_slo_s is None else float(latency_slo_s)
            ),
            "start_row": len(svc.stats.rows),
            # incremental scan cursor + running tallies: the observer
            # fires after EVERY resolved batch, so re-scanning from
            # start_row each time would be O(batches^2) on the serving
            # hot path
            "next_row": len(svc.stats.rows),
            "requests": 0,
            "bad": 0,
        }
        svc._observer = self._observe

    def _observe(self, now: float) -> None:
        """The service calls this after every resolved batch (the
        observer hook): tally the new artifact's post-cutover rows and
        roll back the moment the budget is blown; disarm once the
        window elapses clean."""
        obs = self.observation
        if obs is None:  # defensive: a stale hook after disarm
            self.service._observer = None
            return
        rows = self.service.stats.rows
        slo = obs["latency_slo_s"]
        for row in rows[obs["next_row"]:]:
            if row.artifact_hash != obs["new_hash"]:
                continue
            obs["requests"] += row.size
            # per-row charge is clamped at the row's request count: a
            # degraded or SLO-breaching batch makes EVERY request in it
            # bad (a superset of its errors/gated — never
            # double-charged), so the bad fraction stays a true
            # fraction <= 1
            if row.replica == -1:
                # degraded exact serving: every breaker on the new
                # artifact's set was open, so the artifact itself
                # answered NOTHING — the whole batch charges the
                # budget, however well the exact pipeline coped
                obs["bad"] += row.size
            elif slo is not None and row.seconds > slo and row.n_fallback == 0:
                # latency charges only rows the replica kernel answered
                # alone: a fallback-carrying row's seconds include
                # host-side exact-pipeline time (not the artifact's
                # fault — its gated share is already charged above)
                obs["bad"] += row.size
            else:
                obs["bad"] += min(row.n_error + row.n_gated, row.size)
        obs["next_row"] = len(rows)
        requests, bad = obs["requests"], obs["bad"]
        if now - obs["started_at"] >= obs["window_s"]:
            # the window elapsed: the rollout sticks.  Checked BEFORE
            # the budget so a batch resolving long after the window
            # officially ended can never revert a rollout that already
            # stuck (any in-window budget blow fired on ITS OWN
            # resolution — the observer runs after every batch).
            self.observation = None
            self.service._observer = None
            self.service.stats.extras.setdefault(
                "rollout_observations", []
            ).append({
                "artifact_hash": obs["new_hash"],
                "passed": True,
                "requests": requests,
                "bad": bad,
            })
            return
        if requests and bad / requests > obs["budget"]:
            self.auto_rollback(
                f"error budget exceeded: {bad}/{requests} bad requests "
                f"> budget {obs['budget']:.3g} within "
                f"{obs['window_s']:.3g}s observation window",
                now=now,
            )

    def auto_rollback(self, reason: str, now: Optional[float] = None) -> str:
        """Swap the retained previous replica set back in (it is still
        warm — zero compile cost), record WHY on
        ``stats.extras["rollbacks"]``, and disarm the observation.
        Batches in flight on the bad set drain with its hash (the usual
        drain guarantee).  Returns the hash serving again."""
        prev = self.previous
        if prev is None:
            raise RolloutError(
                "no previous replica set retained; cannot roll back"
            )
        obs, self.observation = self.observation, None
        self.service._observer = None
        bad_set = self.service.swap_replica_set(prev)
        self.rolled_back = bad_set
        self.previous = None
        self.service.stats.extras.setdefault("rollbacks", []).append({
            "from": bad_set.artifact_hash,
            "to": prev.artifact_hash,
            "reason": reason,
            "at": float(
                now if now is not None else self.service._clock()
            ),
            "requests": None if obs is None else obs["requests"],
            "bad": None if obs is None else obs["bad"],
        })
        return prev.artifact_hash


def looks_like_content_hash(s: str) -> bool:
    """Pure format check: is ``s`` shaped like a 16-hex artifact
    content hash?  The tenant-map parser (serve/tenancy.py + the CLI's
    ``--tenant-map``) validates its hash values with this — no
    filesystem exception there, a map entry is never a path."""
    return len(s) == 16 and all(c in "0123456789abcdef" for c in s)


def _looks_like_content_hash(s: str) -> bool:
    """A 16-hex artifact content hash (vs a filesystem path).  A path
    that happens to exist always wins — an operator staging a directory
    literally named like a hash should get the directory."""
    import os

    return looks_like_content_hash(s) and not os.path.exists(s)


def _agree_cutover(staged_hash: str, warmed: bool) -> None:
    """Fleet-wide agreement that every process activates the same build,
    warmed.  The coordinator's staged hash is broadcast and compared on
    every process, and one ``allreduce_min`` vote carries each process's
    verdict (hash matches and stage warmed).  Every process joins both
    collectives before any of them raises, so no peer is left blocked in
    the next one; a failed vote then raises on every process, each naming
    its own cause.  In one process both collectives are the identity.
    Callers sequence stage()/cutover() alike on every process."""
    from bdlz_tpu_torch.parallel.multihost import allreduce_min, broadcast_text

    agreed = broadcast_text(staged_hash, width=HASH_WIRE_WIDTH)
    hash_ok = agreed == staged_hash
    ready = allreduce_min(np.asarray([1 if (hash_ok and warmed) else 0], dtype=np.int64))
    if int(np.asarray(ready).min()) == 1:
        return
    if not warmed:
        raise RolloutError(
            "staged replicas are cold; warm() them before cutover so "
            "no request pays the compile"
        )
    if not hash_ok:
        raise RolloutError(
            f"rollout hash skew: this process staged {staged_hash!r} but "
            f"the coordinator is activating {agreed!r} — every host must "
            "stage the same artifact build before cutover"
        )
    raise RolloutError(
        "rollout refused: another process reported hash skew or a cold "
        "stage"
    )


__all__ = [
    "ArtifactRollout",
    "RolloutError",
    "HASH_WIRE_WIDTH",
    "looks_like_content_hash",
]
