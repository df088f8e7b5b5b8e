"""Elastic sweep worker: claim → compute or heal → publish → commit.

Counterpart of ``bdlz_tpu/parallel/worker.py``.  A :class:`Worker` scans
the lease plane for the lowest claimable chunk, computes it with the
engine ``run_sweep`` builds (``SweepPlan.build_engine`` and
``SweepPlan.compute``: the same resolved knobs, the same padding, the same
bits), heals failures through the sweep's retry → bisect → quarantine
(``heal_range``, ``heal_budget``), and commits through
:func:`~bdlz_tpu_torch.parallel.scheduler.publish_chunk`.

The in-process driver steps workers one chunk at a time, so churn tests
are deterministic; :func:`run_worker_loop` is the external entry
(``sweep_cli --elastic worker``), running the same protocol on wall-clock
leases until the job drains.  An injected ``worker_crash`` kills the
worker at compute start: its lease dangles until TTL expiry requeues the
chunk with the dead worker on the failure list.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np

from bdlz_tpu_torch.ops.kjma_kernel import REDUCE_DEFAULT
from bdlz_tpu_torch.parallel.scheduler import ElasticPlan, LeasePlane, publish_chunk


class WorkerCrashError(RuntimeError):
    """An injected whole-worker death; recovery is the lease plane's job."""


class Worker:
    """One elastic fleet member.  ``engine_box`` is a dict an in-process
    fleet shares, so the engine is built once; ``churn`` is the
    operational fault plan (sites ``worker_crash``, ``lease``,
    ``store_read``), apart from the identity-joined ``plan.faults``."""

    def __init__(self, name: str, plan: ElasticPlan, leases: LeasePlane, store, *,
                 engine_box: Optional[Dict[str, Any]] = None, churn=None,
                 event_log=None):
        self.name = str(name)
        self.plan = plan
        self.leases = leases
        self.store = store
        self.engine_box = engine_box if engine_box is not None else {}
        self.churn = churn
        self.event_log = event_log
        self.alive = True
        self.chunks_done = 0

    def _engine(self):
        if "engine" not in self.engine_box:
            self.engine_box["engine"] = self.plan.build_engine()
        return self.engine_box["engine"]

    def _attempt(self, ci, lo, hi):
        """One evaluation of [lo, hi), extending the lease first so a long
        compute does not let it lapse under its own worker."""
        try:
            self.leases.heartbeat(ci, self.name)
            if self.plan.faults is not None:
                self.plan.faults.fire("step", ci)
                self.plan.faults.check_range("step", lo, hi)
            return 1, self.plan.compute(self._engine(), lo, hi), None
        except FloatingPointError:
            raise  # enable_nan_debugging aborts, as in run_sweep
        except Exception as exc:  # noqa: BLE001 — the healing path decides
            return 0, None, exc

    def _attempt_healed(self, ci, lo, hi):
        ok, host, err = self._attempt(ci, lo, hi)
        if ok:
            host = self.plan.apply_nan_faults(host, lo, hi)
        return ok, host, err

    def _quarantine(self, ci, lo, hi, err):
        if self.event_log is not None:
            self.event_log.emit("chunk_quarantine", chunk=ci, lo=lo, hi=hi,
                                n_points=hi - lo, error=repr(err), worker=self.name)
        return ({f: np.full(hi - lo, np.nan) for f in self.plan.fields},
                np.ones(hi - lo, dtype=bool))

    def _compute(self, ci):
        """``(host, qmask, retries_paid)`` of chunk ``ci``; raises
        :class:`WorkerCrashError` when a ``worker_crash`` fault fires."""
        from bdlz_tpu_torch.faults import FaultError
        from bdlz_tpu_torch.parallel.sweep import heal_budget, heal_range

        if self.churn is not None:
            try:
                self.churn.fire("worker_crash", ci)
            except FaultError as exc:
                raise WorkerCrashError(str(exc)) from exc
        lo, hi = self.plan.chunk_bounds(ci)
        ok, host, err = self._attempt(ci, lo, hi)
        if ok:
            return self.plan.apply_nan_faults(host, lo, hi), np.zeros(hi - lo, bool), 0
        policy = self.plan.retry_policy
        if policy is None:
            raise err
        paid = [0]
        host, qmask = heal_range(
            ci, lo, hi, err, attempt=self._attempt_healed, quarantine=self._quarantine,
            policy=policy, budget=[heal_budget(hi - lo, policy.max_attempts)],
            paid=paid, fields=self.plan.fields,
        )
        return host, qmask, paid[0]

    def step(self) -> bool:
        """Claim and finish one chunk; True when work was done.  A crash
        leaves the lease dangling (TTL recovery); any other error fails
        the lease so the chunk requeues at once."""
        if not self.alive:
            return False
        ci = self._claim_next()
        if ci is None:
            return False
        try:
            host, qmask, paid = self._compute(ci)
        except WorkerCrashError as exc:
            self.alive = False
            if self.event_log is not None:
                self.event_log.emit("worker_crash", worker=self.name, chunk=ci,
                                    error=repr(exc))
            return True
        except FloatingPointError:
            raise
        except Exception as exc:  # noqa: BLE001 — the lease plane requeues
            self.leases.fail(ci, self.name, err=exc)
            return True
        entry = None
        if qmask.any() and self.plan.faults is None:
            # a real quarantine never lives under the content-addressed
            # name: the next clean run recomputes instead of replaying NaN
            entry = f"elastic_scratch/{self.plan.job}_{int(ci):05d}.npz"
        publish_chunk(self.store, self.plan, ci, host, n_retries=paid, qmask=qmask,
                      name=entry)
        self.leases.complete(ci, self.name, entry=entry)
        self.chunks_done += 1
        return True

    def _claim_next(self) -> Optional[int]:
        for ci in range(self.plan.n_chunks):
            if self.leases.claim(ci, self.name):
                return ci
        return None

    def kill(self) -> None:
        """Scripted churn: leave the fleet now; held leases dangle."""
        self.alive = False


def run_worker_loop(
    base,
    axes,
    static,
    *,
    store,
    worker_id: str,
    chunk_size: int = 4096,
    n_y: int = 8000,
    impl: str = "tabulated",
    table_nodes: int = 16384,
    fuse_exp: bool = False,
    reduce: bool = REDUCE_DEFAULT,
    device=None,
    fault_plan=None,
    retry=None,
    lease_ttl_s: float = 60.0,
    quarantine_after: int = 3,
    churn_plan=None,
    poll_s: float = 1.0,
    max_idle_s: float = 600.0,
    sleep=time.sleep,
    clock=time.time,
    event_log=None,
) -> Dict[str, Any]:
    """The external worker (``sweep_cli --elastic worker``): derive the
    plan from the same inputs as every other role, check it against the
    job record (platform included), then claim, compute and commit until
    every chunk is done or quarantined.  Idle waits go through ``sleep``;
    ``max_idle_s`` idle with the job undrained raises."""
    from bdlz_tpu_torch.faults import FaultPlan
    from bdlz_tpu_torch.parallel.scheduler import (
        ElasticError,
        ensure_job_record,
        plan_elastic_sweep,
    )
    from bdlz_tpu_torch.provenance import resolve_store

    store = resolve_store(store, base, label="elastic-worker")
    if store is None:
        raise ElasticError("elastic worker needs a trusted store; pass store=/path")
    churn = FaultPlan.from_json(churn_plan) if isinstance(churn_plan, str) else churn_plan
    if churn is not None:
        store.arm_faults(churn)
    plan = plan_elastic_sweep(
        base, axes, static, chunk_size=chunk_size, n_y=n_y, impl=impl,
        table_nodes=table_nodes, fuse_exp=fuse_exp, reduce=reduce, device=device,
        fault_plan=fault_plan, retry=retry,
    )
    ensure_job_record(store, plan)
    leases = LeasePlane(store, plan.job, plan.n_chunks, ttl_s=lease_ttl_s,
                        quarantine_after=quarantine_after, clock=clock, faults=churn)
    worker = Worker(worker_id, plan, leases, store, churn=churn, event_log=event_log)
    idle_since = None
    while worker.alive:
        # any worker may requeue expired leases: liveness needs no
        # coordinator, only the fold does
        leases.requeue_expired()
        if worker.step():
            idle_since = None
            continue
        if all(leases.state(ci) in ("done", "quarantined") for ci in range(plan.n_chunks)):
            break
        now = float(clock())
        if idle_since is None:
            idle_since = now
        elif now - idle_since >= float(max_idle_s):
            raise ElasticError(
                f"worker {worker_id} idle {max_idle_s}s with the job undrained "
                f"(job {plan.job}); leases are stuck or the fleet is misconfigured"
            )
        sleep(float(poll_s))
    return {
        "worker": worker_id,
        "job": plan.job,
        "alive": worker.alive,
        "chunks_done": worker.chunks_done,
        "n_chunks": plan.n_chunks,
    }
