"""Elastic work-stealing sweep scheduler.

Counterpart of ``bdlz_tpu/parallel/scheduler.py``.  The chunked sweep
(``parallel/sweep.py``) runs one job in one loop; this module spreads its
chunks over a fleet of workers that may join, die or stall, through one
shared :class:`~bdlz_tpu_torch.provenance.Store`.  Every point is
deterministic, so any worker can compute any chunk and land on the same
bits: elasticity costs availability, never correctness.

* **lease plane** (:class:`LeasePlane`, records through
  ``provenance.registry``): one JSON record per ``(job, chunk)``.  A fresh
  chunk is claimed by exclusive create; a lease carries ``expires_at`` and
  is extended while its worker computes.  An expired lease is stolen with
  a generation bump and its holder lands on the record's distinct
  ``failures`` list; a chunk that kills ``quarantine_after`` distinct
  workers is quarantined fleet-wide.  A torn record reads as free.
* **publish-then-commit** (:func:`publish_chunk`): results land under the
  chunk's content key (``SweepPlan.entry_name``, the chunk cache's name).
  The first commit wins; a later one verifies bitwise identity and raises
  :class:`CommitMismatchError` on any drift.
* **fold plane** (:func:`run_sweep_elastic`): the coordinator folds
  committed chunks as they land (``on_chunk``); the result is bitwise the
  port's ``run_sweep`` of the same spec.

Every role derives its plan from the same ``(base, axes, static, knobs)``
through ``parallel.sweep.plan_sweep``, the resolution ``run_sweep`` runs.
The job record in the store carries the cross-checked fields, and the
``platform`` of the chunk keys (``"torch-cuda"`` or ``"torch-cpu"``): a
role of the JAX package, or of the port on the other device, commits
under other keys, so it is refused at :func:`ensure_job_record` instead
of leaving the coordinator waiting for entries that never land.

The churn plan (sites ``worker_crash``, ``lease``, ``store_read``) is
kept apart from the identity-joined ``fault_plan`` (site ``step``): churn
never changes bits, so it joins no key.  All waiting goes through
injectable clocks.  Bounce profiles are not shipped to workers: a
scenario ``lz_mode`` sweep goes through ``run_sweep``.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from bdlz_tpu_torch.config import Config, StaticChoices
from bdlz_tpu_torch.ops.kjma_kernel import REDUCE_DEFAULT
from bdlz_tpu_torch.parallel.sweep import SweepPlan
from bdlz_tpu_torch.utils.clock import ManualClock, WallClock  # noqa: F401
from bdlz_tpu_torch.utils.profiling import span, spanned


class ElasticError(RuntimeError):
    """Elastic protocol failure (job drift, no store, deadlock)."""


class CommitMismatchError(ElasticError):
    """A re-commit of an already-committed chunk produced different bits:
    a broken engine, a corrupt store or a drifted resolution — never
    something to paper over."""


@dataclass
class ElasticPlan(SweepPlan):
    """A :class:`SweepPlan` with its chunk keys computed once; ``job`` (the
    grid hash) is the store namespace of its leases and job record."""

    chunk_keys: List[str] = field(repr=False, default_factory=list)

    @property
    def job(self) -> str:
        return self.hash

    def chunk_key(self, ci: int) -> str:
        return self.chunk_keys[ci]

    def job_record(self) -> Dict[str, Any]:
        return {
            "schema": 1,
            "hash": self.job,
            "n_total": int(self.n_total),
            "chunk_size": int(self.chunk_size),
            "n_chunks": int(self.n_chunks),
            "n_y": int(self.n_y),
            "impl": self.impl,
            "platform": self.platform,
        }


def plan_elastic_sweep(
    base: Config,
    axes,
    static: StaticChoices,
    *,
    chunk_size: int = 4096,
    n_y: int = 8000,
    impl: str = "tabulated",
    table_nodes: int = 16384,
    fuse_exp: bool = False,
    reduce: bool = REDUCE_DEFAULT,
    device=None,
    fault_plan=None,
    retry=None,
) -> ElasticPlan:
    """Resolve the elastic sweep exactly as ``run_sweep`` resolves it
    (``plan_sweep``): every role derives the same engine, chunk bounds
    and content keys from the same inputs."""
    from bdlz_tpu_torch.parallel.sweep import plan_sweep

    if getattr(static, "lz_mode", "two_channel") != "two_channel":
        raise ElasticError(
            f"lz_mode={static.lz_mode!r} needs a bounce profile per point; "
            "elastic mode does not ship profiles — use run_sweep"
        )
    sp = plan_sweep(
        base, axes, static, chunk_size=chunk_size, n_y=n_y, impl=impl,
        fuse_exp=fuse_exp, reduce=reduce, device=device, table_nodes=table_nodes,
        fault_plan=fault_plan, retry=retry, label="elastic",
    )
    plan = ElasticPlan(**{f.name: getattr(sp, f.name) for f in dataclasses.fields(sp)})
    plan.chunk_keys = [SweepPlan.chunk_key(plan, ci) for ci in range(plan.n_chunks)]
    return plan


def ensure_job_record(store, plan: ElasticPlan) -> Dict[str, Any]:
    """Publish, or check against, the job record ``elastic/<job>.json``.
    A role launched with drifted inputs, or on another platform, fails
    here loudly instead of computing chunks nobody can fold.  A torn
    record is rewritten."""
    name = f"elastic/{plan.job}.json"
    want = plan.job_record()
    have = store.get_json(name)
    if have is None:
        store.put_json(name, want)
        return want
    if have != want:
        raise ElasticError(
            f"elastic job record {name} does not match this invocation's "
            f"resolved plan (store: {have}, local: {want}); every role "
            "must run the identical (config, axes, static, knobs) on one "
            "platform"
        )
    return have


# ---- lease plane --------------------------------------------------------

_LEASE_FREE = "queued"


class LeasePlane:
    """Claim / heartbeat / complete / fail / requeue over the registry's
    lease records, with TTL expiry, distinct-failure tracking and fleet
    quarantine.  ``clock`` is injectable (default ``time.time``: expiry
    must compare across processes); ``faults`` is the churn plan (site
    ``lease``)."""

    def __init__(self, store, job: str, n_chunks: int, *, ttl_s: float = 60.0,
                 quarantine_after: int = 3, clock: Callable[[], float] = time.time,
                 faults=None):
        self.store = store
        self.job = job
        self.n_chunks = int(n_chunks)
        self.ttl_s = float(ttl_s)
        self.quarantine_after = int(quarantine_after)
        self.clock = clock
        self.faults = faults

    def read(self, ci: int) -> Optional[Dict[str, Any]]:
        from bdlz_tpu_torch.provenance.registry import read_lease

        return read_lease(self.store, self.job, ci)

    def _write(self, ci: int, rec: Dict[str, Any]) -> None:
        from bdlz_tpu_torch.provenance.registry import write_lease

        write_lease(self.store, self.job, ci, rec)

    def _record(self, ci, worker, state, generation, failures):
        return {
            "schema": 1,
            "job": self.job,
            "chunk": int(ci),
            "state": state,
            "worker": worker,
            "generation": int(generation),
            "expires_at": float(self.clock()) + self.ttl_s,
            "failures": list(failures),
        }

    def claim(self, ci: int, worker: str) -> bool:
        """Try to lease chunk ``ci`` for ``worker``; True when won.  A
        fresh chunk is an exclusive create; an expired or queued one is
        stolen with a generation bump (an expired holder joins the
        distinct ``failures`` first, and at ``quarantine_after`` the chunk
        is quarantined instead).  Injected ``lease`` faults: raise and
        transient fail the claim; ``torn`` tears the record after a won
        claim, forcing a double claim the commit protocol must resolve."""
        from bdlz_tpu_torch.faults import FaultError
        from bdlz_tpu_torch.provenance.registry import create_lease, lease_entry_name

        if self.faults is not None:
            try:
                self.faults.fire("lease", ci)
            except FaultError:
                return False  # a flaky claim: the chunk stays claimable
        rec = self.read(ci)
        if rec is None:
            fresh = self._record(ci, worker, "leased", 0, [])
            if not create_lease(self.store, self.job, ci, fresh):
                return False  # lost the create race
            self._claim_tear(ci, lease_entry_name(self.job, ci))
            return True
        state = rec.get("state")
        if state in ("done", "quarantined"):
            return False
        failures = [str(w) for w in rec.get("failures", [])]
        if state == "leased":
            if float(rec.get("expires_at", 0.0)) > float(self.clock()):
                return False  # a live lease
            holder = rec.get("worker")
            if holder is not None and holder not in failures:
                failures.append(str(holder))
        if len(failures) >= self.quarantine_after:
            self._write(ci, self._record(ci, None, "quarantined",
                                         rec.get("generation", 0) + 1, failures))
            return False
        self._write(ci, self._record(ci, worker, "leased",
                                     rec.get("generation", 0) + 1, failures))
        self._claim_tear(ci, lease_entry_name(self.job, ci))
        return True

    def _claim_tear(self, ci: int, entry: str) -> None:
        if self.faults is not None:
            self.faults.corrupt_file("lease", ci, self.store.path_for(entry))

    def heartbeat(self, ci: int, worker: str) -> bool:
        """Extend ``worker``'s live lease on ``ci``; False when the lease is
        gone, stolen or torn (the commit protocol owns correctness)."""
        rec = self.read(ci)
        if rec is None or rec.get("state") != "leased" or rec.get("worker") != worker:
            return False
        rec["expires_at"] = float(self.clock()) + self.ttl_s
        self._write(ci, rec)
        return True

    def complete(self, ci: int, worker: str, entry: Optional[str] = None) -> None:
        """Mark ``ci`` done after its commit; ``entry`` names a result that
        must not live under the content-addressed name (a real quarantine)."""
        rec = self.read(ci) or self._record(ci, worker, "leased", 0, [])
        done = self._record(ci, worker, "done", rec.get("generation", 0),
                            rec.get("failures", []))
        if entry is not None:
            done["entry"] = entry
        self._write(ci, done)

    def fail(self, ci: int, worker: str, err: Any = None) -> None:
        """Record a failure of ``worker`` and requeue, or quarantine at the
        distinct-failure threshold."""
        rec = self.read(ci) or self._record(ci, worker, "leased", 0, [])
        failures = [str(w) for w in rec.get("failures", [])]
        if worker not in failures:
            failures.append(str(worker))
        state = "quarantined" if len(failures) >= self.quarantine_after else _LEASE_FREE
        nxt = self._record(ci, None, state, rec.get("generation", 0) + 1, failures)
        if err is not None:
            nxt["error"] = repr(err)
        self._write(ci, nxt)

    def requeue(self, ci: int) -> None:
        """Make ``ci`` claimable again (the fold found its entry torn)."""
        rec = self.read(ci) or self._record(ci, None, _LEASE_FREE, 0, [])
        self._write(ci, self._record(ci, None, _LEASE_FREE, rec.get("generation", 0) + 1,
                                     rec.get("failures", [])))

    def requeue_expired(self) -> List[int]:
        """Requeue every expired lease (its holder joins the failures);
        a lost worker costs only its in-flight chunks, until their TTL."""
        now = float(self.clock())
        out: List[int] = []
        for ci in range(self.n_chunks):
            rec = self.read(ci)
            if (rec is None or rec.get("state") != "leased"
                    or float(rec.get("expires_at", 0.0)) > now):
                continue
            self.fail(ci, rec.get("worker"), err="lease expired")
            out.append(ci)
        return out

    def state(self, ci: int) -> str:
        rec = self.read(ci)
        return _LEASE_FREE if rec is None else str(rec.get("state"))


# ---- publish-then-commit ------------------------------------------------

def _bitwise_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def publish_chunk(store, plan: ElasticPlan, ci: int, host: Dict[str, np.ndarray], *,
                  n_retries: int = 0, qmask: Optional[np.ndarray] = None,
                  name: Optional[str] = None) -> bool:
    """Commit chunk ``ci``'s results: the first commit wins; a later one
    verifies every field (and the quarantine mask) bitwise against the
    committed entry and raises :class:`CommitMismatchError` on drift.
    ``n_retries`` is history, not identity, and is not compared.  True
    when this call's bytes became the entry."""
    from bdlz_tpu_torch.parallel.sweep import chunk_entry_arrays, chunk_entry_ok

    entry = name if name is not None else plan.entry_name(ci)
    lo, hi = plan.chunk_bounds(ci)
    fresh = chunk_entry_arrays(host, n_retries=n_retries, qmask=qmask)
    existing = store.get_npz(entry)
    if chunk_entry_ok(existing, hi - lo):
        for f in (*plan.fields, "failed"):
            if not _bitwise_equal(existing[f], fresh[f]):
                raise CommitMismatchError(
                    f"chunk {ci} re-commit disagrees with the committed "
                    f"entry on field {f!r} (entry {entry}): the chunk "
                    "engine is non-deterministic or the store is corrupt"
                )
        q_old, q_new = existing.get("quarantined"), fresh.get("quarantined")
        if (q_old is None) != (q_new is None) or (
                q_old is not None and not _bitwise_equal(q_old, q_new)):
            raise CommitMismatchError(
                f"chunk {ci} re-commit disagrees with the committed entry "
                f"on the quarantine mask (entry {entry})"
            )
        return False
    store.put_npz(entry, fresh)
    return True


# ---- the in-process elastic driver --------------------------------------

@spanned("sweep")
def run_sweep_elastic(
    base: Config,
    axes,
    static: StaticChoices,
    *,
    store,
    chunk_size: int = 4096,
    n_y: int = 8000,
    impl: str = "tabulated",
    table_nodes: int = 16384,
    fuse_exp: bool = False,
    reduce: bool = REDUCE_DEFAULT,
    device=None,
    fault_plan=None,
    retry=None,
    n_workers: int = 2,
    lease_ttl_s: float = 60.0,
    quarantine_after: int = 3,
    churn_plan=None,
    churn_schedule: Optional[Sequence[Tuple[int, str]]] = None,
    clock: Optional[ManualClock] = None,
    tick_s: float = 1.0,
    on_chunk: Optional[Callable[[int, int, int, Dict[str, np.ndarray]], Any]] = None,
    max_rounds: Optional[int] = None,
    keep_outputs: bool = True,
    event_log=None,
):
    """Run a sweep on an elastic in-process fleet; the returned
    ``SweepResult``'s outputs are bitwise the port's ``run_sweep``.

    A deterministic round loop: each round requeues expired leases, steps
    every live worker once (claim → compute or heal → publish → commit →
    complete), folds every newly committed chunk (``on_chunk(ci, lo, hi,
    entry)`` sees each fold), applies the scripted ``churn_schedule``
    (``(round, "spawn"|"kill")``) and advances ``clock`` by ``tick_s``.
    A torn entry at the fold requeues its chunk; a fleet-quarantined chunk
    folds as NaN with its mask; a dead fleet with work left gets a
    replacement worker; past ``max_rounds`` the protocol is declared stuck
    (:class:`ElasticError`).  ``device`` is the card unless the caller
    asks for the CPU; ``impl="kernel"`` runs P1, P2, P3 or P4 by its ``reduce`` and
    ``fuse_exp`` tiers.  The spans are ``run_sweep``'s: ``sweep``, its
    planning, the engine's build and, around the rounds, ``sweep.loop``
    with each worker's ``chunk.*``."""
    from bdlz_tpu_torch.faults import FaultPlan
    from bdlz_tpu_torch.parallel.sweep import SweepResult, chunk_entry_ok
    from bdlz_tpu_torch.parallel.worker import Worker
    from bdlz_tpu_torch.provenance import resolve_store

    store = resolve_store(store, base, label="elastic")
    if store is None:
        raise ElasticError(
            "elastic mode needs a trusted store (the lease/commit plane "
            "lives there); pass store=/path or a Store"
        )
    churn = FaultPlan.from_json(churn_plan) if isinstance(churn_plan, str) else churn_plan
    if churn is not None:
        store.arm_faults(churn)  # site "store_read": torn reads

    plan = plan_elastic_sweep(
        base, axes, static, chunk_size=chunk_size, n_y=n_y, impl=impl,
        table_nodes=table_nodes, fuse_exp=fuse_exp, reduce=reduce, device=device,
        fault_plan=fault_plan, retry=retry,
    )
    ensure_job_record(store, plan)
    if clock is None:
        clock = ManualClock()
    leases = LeasePlane(store, plan.job, plan.n_chunks, ttl_s=lease_ttl_s,
                        quarantine_after=quarantine_after, clock=clock, faults=churn)

    # one engine shared by every in-process worker, built on first use
    engine_box: Dict[str, Any] = {}
    t0 = time.perf_counter()
    out = {f: np.full(plan.n_total, np.nan) for f in plan.fields}
    failed = np.zeros(plan.n_total, dtype=bool)
    quarantined = np.zeros(plan.n_total, dtype=bool)
    folded = np.zeros(plan.n_chunks, dtype=bool)
    n_retries = 0
    cache_hits = 0

    def _fold(ci: int, ent: Dict[str, np.ndarray]) -> None:
        nonlocal n_retries
        lo, hi = plan.chunk_bounds(ci)
        for f in plan.fields:
            out[f][lo:hi] = ent[f]
        failed[lo:hi] = np.asarray(ent["failed"], dtype=bool)
        if "quarantined" in ent:
            quarantined[lo:hi] = np.asarray(ent["quarantined"], dtype=bool)
        n_retries += int(ent.get("n_retries", 0))
        folded[ci] = True
        if on_chunk is not None:
            on_chunk(ci, lo, hi, ent)
        if event_log is not None:
            event_log.emit("elastic_fold", chunk=ci,
                           n_failed=int(np.asarray(ent["failed"]).sum()))

    def _fold_quarantined(ci: int) -> None:
        lo, hi = plan.chunk_bounds(ci)
        ent = {f: np.full(hi - lo, np.nan) for f in plan.fields}
        ent["failed"] = np.ones(hi - lo, dtype=bool)
        ent["quarantined"] = np.ones(hi - lo, dtype=bool)
        _fold(ci, ent)
        if event_log is not None:
            event_log.emit("elastic_quarantine", chunk=ci, lo=lo, hi=hi)

    # a warm store folds at once and never builds the engine
    for ci in range(plan.n_chunks):
        lo, hi = plan.chunk_bounds(ci)
        ent = store.get_npz(plan.entry_name(ci))
        if chunk_entry_ok(ent, hi - lo):
            leases.complete(ci, "prescan")
            _fold(ci, ent)
            cache_hits += 1

    workers: List[Worker] = []
    spawned = 0

    def _spawn() -> Worker:
        nonlocal spawned
        w = Worker(f"w{spawned}", plan, leases, store, engine_box=engine_box,
                   churn=churn, event_log=event_log)
        spawned += 1
        workers.append(w)
        return w

    for _ in range(max(int(n_workers), 1)):
        _spawn()
    schedule = sorted((int(r), str(action)) for r, action in (churn_schedule or []))
    # every chunk may be requeued quarantine_after times, each needing a
    # TTL's worth of rounds: beyond that bound the protocol is stuck
    ttl_rounds = max(int(np.ceil(lease_ttl_s / max(tick_s, 1e-9))), 1)
    if max_rounds is None:
        max_rounds = (10 + plan.n_chunks * (quarantine_after + 1) * (ttl_rounds + 2)
                      + 2 * len(schedule))

    with span("sweep.loop"):
        round_i = 0
        while not folded.all():
            if round_i >= max_rounds:
                raise ElasticError(
                    f"elastic sweep made no full progress after {round_i} rounds "
                    f"({int(folded.sum())}/{plan.n_chunks} chunks folded); "
                    "protocol deadlock"
                )
            for r, action in schedule:
                if r != round_i:
                    continue
                if action == "spawn":
                    _spawn()
                elif action == "kill" and workers:
                    workers.pop(0).kill()
                else:
                    raise ElasticError(f"unknown churn action {action!r}")
            leases.requeue_expired()
            live = [w for w in workers if w.alive]
            if not live:
                live = [_spawn()]
                if event_log is not None:
                    event_log.emit("elastic_respawn", round=round_i)
            for w in live:
                w.step()
            workers[:] = [w for w in workers if w.alive]
            for ci in range(plan.n_chunks):
                if folded[ci]:
                    continue
                rec = leases.read(ci)
                if rec is None:
                    continue
                if rec.get("state") == "quarantined":
                    _fold_quarantined(ci)
                    continue
                if rec.get("state") != "done":
                    continue
                lo, hi = plan.chunk_bounds(ci)
                ent = store.get_npz(rec.get("entry") or plan.entry_name(ci))
                if not chunk_entry_ok(ent, hi - lo):
                    leases.requeue(ci)  # torn or vanished: recompute
                    continue
                _fold(ci, ent)
            clock.advance(tick_s)
            round_i += 1

        if plan.device.type == "cuda":
            import torch

            torch.cuda.synchronize(plan.device)
        seconds = time.perf_counter() - t0
    quad_impl, n_quad = plan.quad_report()
    return SweepResult(
        n_points=plan.n_total,
        n_failed=int(failed.sum()),
        seconds=seconds,
        points_per_sec=plan.n_total / max(seconds, 1e-9),
        chunks=plan.n_chunks,
        quad_impl=quad_impl,
        n_quad_nodes=n_quad,
        impl=plan.impl,
        outputs=dict(out) if keep_outputs else None,
        failed_mask=failed,
        n_quarantined=int(quarantined.sum()),
        n_retries=n_retries,
        cache_hits=cache_hits,
        cache_misses=plan.n_chunks - cache_hits,
        quarantined_mask=quarantined,
    )
