"""Dynamic micro-batching for the query service.

Counterpart of ``bdlz_tpu/serve/batcher.py``: the same dispatch policy,
typed errors and stats rows, so both packages shed, admit and batch the
same requests at the same instants of an injected clock.

Single-point queries are the natural unit for callers (one user, one
parameter point) but the worst unit for the accelerator: the batched
interpolation answers 4096 points for barely more than it
answers one.  The batcher sits between the two — requests enqueue from
any thread, and a dispatch fires when EITHER

* ``max_batch_size`` requests are waiting (full batch, zero added
  latency), OR
* the OLDEST waiting request has aged ``max_wait_s`` (latency bound:
  a lone request never waits longer than the knob).

Design for testability: the dispatch POLICY is a pure function of
(queue state, now) — :meth:`MicroBatcher.ready_at` / the collection in
:meth:`run_once` take an injectable ``clock``, so tier-1 unit-tests
drive batching decisions with a fake clock and never sleep.  The
background thread (:meth:`start`/:meth:`stop`) is a thin loop around
``run_once`` guarded by a condition variable; it is exercised by the
CLI, not by tier-1.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Deque, NamedTuple, Optional, Sequence

import numpy as np

from bdlz_tpu_torch.utils.profiling import ServeStats


class _Pending(NamedTuple):
    theta: np.ndarray
    enqueued_at: float
    future: Future


class DeadlineExceeded(RuntimeError):
    """A request aged past the service deadline before its dispatch.

    Typed so callers can tell "the service shed my request under load"
    from an evaluation failure; delivered through the request's future
    at dispatch time instead of letting the stale request age the batch.
    """


class QueueFull(RuntimeError):
    """Admission control rejected a request: the queue is at its bound.

    Raised synchronously at :meth:`MicroBatcher.submit` (and the fleet's
    ``FleetService.submit``) when ``queue_bound`` requests are already
    waiting — the caller finds out *immediately* that the service is
    overloaded, instead of parking a future that a deadline will kill
    seconds later.  Typed so load generators and the CLI can count shed
    traffic apart from evaluation failures.
    """


class ServiceUnavailable(RuntimeError):
    """The service cannot answer this request at all.

    Delivered through futures when (a) a service is
    :meth:`~bdlz_tpu_torch.serve.fleet.FleetService.close`\\ d with the
    request still pending/in flight — shutdown must FAIL futures, never
    leave a caller blocked on ``result()`` forever — or (b) every
    replica's circuit breaker is open AND the degraded exact-serving
    path itself failed (the loud end of the degradation ladder,
    docs/robustness.md).  Typed so callers/load-balancers can tell
    "this instance is down, resubmit elsewhere" from an evaluation
    failure.
    """


class BatchResult(NamedTuple):
    """What a process_batch callback returns: per-request values plus
    how many of them took the exact-pipeline fallback.

    ``errors`` (optional, same length as ``values``) carries per-request
    failures — a request with a non-None entry gets its exception
    instead of a value, while its batchmates' results still deliver
    (error isolation: one poisoned request must not fail the batch).
    ``n_retries`` counts evaluation retries the batch paid (degraded-
    mode accounting for :class:`~bdlz_tpu_torch.utils.profiling.ServeStats`).
    ``n_gated`` is the subset of ``n_fallback`` the predicted-error gate
    routed (the rest missed the domain), and ``reasons`` (optional, same
    length as ``values``) carries each request's fallback reason —
    ``"ood"`` | ``"predicted_error"`` | None — for fronts that surface
    it per answer (the serve CLI's JSONL records).
    """

    values: Sequence[float]
    n_fallback: int = 0
    errors: Optional[Sequence[Optional[BaseException]]] = None
    n_retries: int = 0
    n_gated: int = 0
    reasons: Optional[Sequence[Optional[str]]] = None


class MicroBatcher:
    """Request queue + dynamic batcher in front of a batch evaluator.

    ``process_batch`` maps a ``(B, d)`` float64 array to a
    :class:`BatchResult` (or a bare value sequence).  Exceptions it
    raises are delivered to every future in the failing batch — a bad
    batch never wedges the queue.
    """

    def __init__(
        self,
        process_batch: Callable,
        max_batch_size: int = 256,
        max_wait_s: float = 0.005,
        clock: Callable[[], float] = time.monotonic,
        stats: Optional[ServeStats] = None,
        deadline_s: Optional[float] = None,
        fault_plan=None,
        queue_bound: Optional[int] = None,
        lz_mode: Optional[str] = None,
    ):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if max_wait_s < 0.0:
            raise ValueError("max_wait_s must be >= 0")
        if queue_bound is not None and queue_bound < max_batch_size:
            # a bound below one batch would cap every dispatch below
            # max_batch_size — occupancy could never reach 1.0 and the
            # knob would silently act as a smaller max_batch
            raise ValueError(
                f"queue_bound ({queue_bound}) must be >= max_batch_size "
                f"({max_batch_size}) or None (unbounded)"
            )
        if deadline_s is not None and deadline_s <= 0.0:
            raise ValueError("deadline_s must be > 0 (or None)")
        if deadline_s is not None and deadline_s <= max_wait_s:
            # a lone request only dispatches once it has aged max_wait_s,
            # so this configuration would deterministically shed 100% of
            # sparse traffic — reject it instead of silently serving
            # nothing
            raise ValueError(
                f"deadline_s ({deadline_s}) must exceed max_wait_s "
                f"({max_wait_s}): the wait policy ages every "
                "non-full batch to max_wait_s before dispatch"
            )
        self._process = process_batch
        self.max_batch_size = int(max_batch_size)
        self.max_wait_s = float(max_wait_s)
        #: Per-request deadline: a request older than this at dispatch is
        #: answered with DeadlineExceeded instead of aging the batch.
        #: Measured on the SAME injectable clock as the wait policy, so
        #: tier-1 drives expiry with a fake clock and never sleeps.
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        #: Admission control: submit raises :class:`QueueFull` once this
        #: many requests are waiting (None = unbounded, the pre-fleet
        #: behavior).  Overload then degrades to a measured reject rate
        #: at the front door instead of unbounded queue latency.
        self.queue_bound = None if queue_bound is None else int(queue_bound)
        #: Injected "slow collection" faults (bdlz_tpu_torch.faults, site
        #: "clock", keyed by batch index): the delay is applied THROUGH
        #: the clock at dispatch — requests look older, deadlines fire —
        #: never as a real sleep.
        self._faults = fault_plan
        #: The LZ physics scenario the backing service serves
        #: (docs/scenarios.md) — stamped on every stats row so mode
        #: audits read straight off the serving telemetry.  None when
        #: this batcher fronts a bare process function with no service
        #: (unit-test harnesses).
        self.lz_mode = None if lz_mode is None else str(lz_mode)
        self._clock = clock
        self.stats = stats if stats is not None else ServeStats()
        self._queue: Deque[_Pending] = deque()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._batch_index = 0

    # ---- enqueue ----------------------------------------------------

    def submit(self, theta) -> Future:
        """Enqueue one d-dimensional query; resolves to its value.

        Raises :class:`QueueFull` (synchronously — the request never
        enters the queue) when admission control is configured and the
        queue is at its bound.
        """
        theta = np.asarray(theta, dtype=np.float64).reshape(-1)
        fut: Future = Future()
        with self._wake:
            if (
                self.queue_bound is not None
                and len(self._queue) >= self.queue_bound
            ):
                self.stats.record_admission_rejects(1)
                raise QueueFull(
                    f"queue at its admission bound ({self.queue_bound} "
                    "requests waiting); retry later or raise queue_bound"
                )
            self._queue.append(_Pending(theta, self._clock(), fut))
            self.stats.record_accepted(1)
            self._wake.notify()
        return fut

    # ---- dispatch policy (pure in queue state + now) ----------------

    def ready_at(self, now: Optional[float] = None) -> bool:
        """Would a dispatch fire at time ``now``?  (No side effects.)"""
        now = self._clock() if now is None else now
        with self._lock:
            return self._ready_locked(now)

    def _ready_locked(self, now: float) -> bool:
        if not self._queue:
            return False
        if len(self._queue) >= self.max_batch_size:
            return True
        return (now - self._queue[0].enqueued_at) >= self.max_wait_s

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    # ---- one dispatch (the unit tier-1 tests) -----------------------

    def run_once(self, force: bool = False) -> int:
        """Collect and evaluate one batch if the policy says so.

        Returns the number of requests served (0 = policy said wait).
        ``force=True`` drains a partial batch regardless of age — the
        shutdown path, so no request is ever dropped.
        """
        now = self._clock()
        if self._faults is not None:
            now += self._faults.delay_s("clock", self._batch_index)
        with self._lock:
            if not self._queue or not (force or self._ready_locked(now)):
                return 0
            # Expired requests are an age-ordered PREFIX of the queue:
            # drain them before slicing the batch, so dead requests never
            # consume dispatch slots that still-live ones behind them
            # need (shedding load must not add latency to the survivors).
            expired = []
            if self.deadline_s is not None:
                while self._queue and (
                    now - self._queue[0].enqueued_at > self.deadline_s
                ):
                    expired.append(self._queue.popleft())
            batch = [
                self._queue.popleft()
                for _ in range(min(len(self._queue), self.max_batch_size))
            ]
        n_expired = len(expired)
        for p in expired:
            age = now - p.enqueued_at
            p.future.set_exception(DeadlineExceeded(
                f"request aged {age:.6f}s past the "
                f"{self.deadline_s:.6f}s service deadline before dispatch"
            ))
        if n_expired:
            self.stats.record_deadline_kills(n_expired)
        if not batch:
            return n_expired
        wait_s = max(now - p.enqueued_at for p in batch)
        t0 = self._clock()
        try:
            # the stack itself can fail (ragged request dimensions) and
            # must be delivered to the futures like any process failure
            # — an escape here would kill the background loop and hang
            # every pending result() forever
            thetas = np.stack([p.theta for p in batch])
            result = self._process(thetas)
        except Exception as exc:  # noqa: BLE001 — delivered per-request
            for p in batch:
                p.future.set_exception(exc)
            return len(batch) + n_expired
        if not isinstance(result, BatchResult):
            result = BatchResult(values=result)
        values = list(result.values)
        errors = (
            list(result.errors) if result.errors is not None
            else [None] * len(values)
        )
        if len(values) != len(batch) or len(errors) != len(batch):
            err = RuntimeError(
                f"process_batch returned {len(values)} values for a "
                f"{len(batch)}-request batch"
            )
            for p in batch:
                p.future.set_exception(err)
            return len(batch) + n_expired
        seconds = self._clock() - t0
        self.stats.record_batch(
            batch_index=self._batch_index,
            size=len(batch),
            occupancy=len(batch) / self.max_batch_size,
            wait_s=float(wait_s),
            n_fallback=int(result.n_fallback),
            seconds=float(seconds),
            n_retries=int(result.n_retries),
            n_error=sum(e is not None for e in errors),
            n_gated=int(result.n_gated),
            lz_mode=self.lz_mode,
        )
        # the refinement daemon's traffic trace (a no-op unless armed)
        self.stats.record_queries(thetas, result.reasons)
        self._batch_index += 1
        for p, v, e in zip(batch, values, errors):
            # per-request error isolation: a poisoned request gets its
            # exception, its batchmates still get their values
            if e is not None:
                p.future.set_exception(e)
            else:
                p.future.set_result(v)
        return len(batch) + n_expired

    # ---- background loop (CLI only; not exercised by tier-1) --------

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("batcher already started")
        self._stopping = False
        self._thread = threading.Thread(
            target=self._loop, name="bdlz-serve-batcher", daemon=True
        )
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        """Stop the loop; ``drain=True`` serves whatever is still queued."""
        if self._thread is None:
            return
        with self._wake:
            self._stopping = True
            self._wake.notify()
        self._thread.join()
        self._thread = None
        if drain:
            while self.run_once(force=True):
                pass

    def _loop(self) -> None:  # pragma: no cover — threaded; CLI-driven
        while True:
            with self._wake:
                if self._stopping:
                    return
                if not self._queue:
                    self._wake.wait(timeout=0.1)
                    continue
                age = self._clock() - self._queue[0].enqueued_at
                timeout = max(self.max_wait_s - age, 0.0)
                if len(self._queue) < self.max_batch_size and timeout > 0:
                    self._wake.wait(timeout=timeout)
            self.run_once()


def drain_results(futures: Sequence[Future]) -> "list[Any]":
    """Resolve submitted futures in order (re-raising any failure)."""
    return [f.result() for f in futures]
