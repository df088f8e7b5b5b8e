"""Sharded serving fleet: per-device query replicas + overload control.

Counterpart of ``bdlz_tpu/serve/fleet.py``, with its routing, admission
control, deadline shedding, health plane, bit-identical re-answer,
registry re-provision, degraded exact path, rollout seam and in-place
resize (the multi-tenant autoscaler's hook).

* :class:`ReplicaSet` — one artifact's tables resident on each replica's
  device; one dispatch per batch runs interpolation, the domain test and
  the predicted error through the shared
  :func:`~bdlz_tpu_torch.emulator.grid.select_domains` rule.  Replicas
  above the device count wrap round-robin onto the devices, so two
  replicas on one card share it on two streams.
* Asynchronous dispatch: JAX's async dispatch and ``is_ready()`` become
  one CUDA stream per replica, a non-blocking copy of the results into
  pinned host memory and a ``torch.cuda.Event`` whose ``query()`` is the
  readiness probe.  On the CPU a dispatch completes before it returns.
* :class:`FleetService` — per-request futures over the micro-batcher's
  dispatch policy on an injectable clock; every response is a
  :class:`FleetResponse` carrying the hash of the artifact that answered.

``devices=None`` means every visible CUDA device; with no card it raises.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import (
    Any,
    Callable,
    Deque,
    Dict,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np
import torch

from bdlz_tpu_torch.backend import resolve_device
from bdlz_tpu_torch.emulator.grid import (
    artifact_hull,
    device_tables,
    domain_artifacts,
    domain_error_table,
    in_domain,
    interp_log_fields,
    predicted_error,
    select_domains,
)
from bdlz_tpu_torch.serve.batcher import (
    DeadlineExceeded,
    QueueFull,
    ServiceUnavailable,
)
from bdlz_tpu_torch.serve.health import (
    CAUSE_DISPATCH_ERROR,
    CAUSE_GATHER_ERROR,
    CAUSE_NAN,
    HealthPlane,
    resolve_health_policy,
)
from bdlz_tpu_torch.serve.service import (
    REASON_DEGRADED,
    ExactFallback,
    _pad_rows,
    artifact_lz_mode,
    gate_fallback_masks,
    resolve_error_gate,
    resolve_service_profile,
    resolve_service_static,
    theta_from_mapping,
)
from bdlz_tpu_torch.utils.profiling import ServeStats

ROUTING_POLICIES = ("round_robin", "least_loaded")


def resolve_devices(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The replica devices: every visible CUDA device for None (raising
    without a card), else each entry resolved (``"cpu"`` on request)."""
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("ReplicaSet needs at least one device")
    return out


class FleetResponse(NamedTuple):
    """One answered request: the value, the artifact hash that computed
    it (stamped at dispatch), the replica that ran the batch, and the
    fallback reason (None = the emulator answered).  ``degraded=True``
    (replica ``-1``) marks an answer of the exact pipeline because every
    replica breaker was open."""

    value: float
    artifact_hash: str
    replica: int
    fallback_reason: Optional[str] = None
    degraded: bool = False
    lz_mode: Optional[str] = None
    #: The fabric host that answered (None on a single-host service).
    host_id: Optional[str] = None


class _Replica:
    """One device-resident copy of the artifact's tables and the fused
    batch function over them.

    ``error_gate=False`` skips the error tables: the function returns a
    constant 0 estimate, so a gate-off fleet pays no error gathers."""

    def __init__(self, artifact, device: torch.device, field: str, index: int,
                 error_gate: bool = True):
        doms = domain_artifacts(artifact)
        for dom in doms:
            if field not in dom.values:
                raise KeyError(
                    f"field {field!r} not in artifact (has {sorted(dom.values)})"
                )
        self.device = device
        self.index = int(index)
        #: Batches dispatched but not yet gathered (least-loaded signal).
        self.in_flight = 0
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.field = field
        self.tables = [
            (device_tables(dom, (field,), device),
             domain_error_table(dom, device) if error_gate else None)
            for dom in doms
        ]
        if self.stream is not None:
            # the tables were written on the default stream
            self.stream.wait_stream(torch.cuda.current_stream(device))

    def _eval(self, thetas: torch.Tensor):
        field = self.field

        def eval_one(table, th):
            dom, err_table = table
            v = torch.pow(10.0, interp_log_fields(th, dom)[field])
            e = (predicted_error(th, dom.nodes, *err_table)
                 if err_table is not None else torch.zeros_like(v))
            return (v, e), in_domain(th, dom.nodes)

        (value, err), inside = select_domains(thetas, self.tables, eval_one)
        return value, inside, err

    def dispatch(self, padded: np.ndarray):
        """Launch one padded batch on this replica's stream; returns
        ``(values, inside, pred_err, event)`` host tensors that are valid
        once ``event`` (None on the CPU) has completed."""
        host = torch.from_numpy(np.ascontiguousarray(padded, dtype=np.float64))
        if self.stream is None:
            return (*self._eval(host), None)
        with torch.cuda.stream(self.stream):
            thetas = host.pin_memory().to(self.device, non_blocking=True)
            outs = self._eval(thetas)
            pinned = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                           for o in outs)
            for dst, src in zip(pinned, outs):
                dst.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        return (*pinned, event)


class _Handle(NamedTuple):
    """An in-flight micro-batch: host buffers, readiness and provenance."""

    replica: _Replica
    values: Any          # (bucket,) f64 host tensor
    inside: Any          # (bucket,) bool host tensor
    pred_err: Any        # (bucket,) f64 host tensor
    event: Any           # torch.cuda.Event, or None (complete)
    n: int               # live rows (bucket - n = padding)
    #: An armed ``replica_dispatch``/``nan`` fault fired at dispatch:
    #: gather NaN-poisons the values.
    nan_injected: bool = False

    def done(self) -> bool:
        """True when the device work finished (no blocking)."""
        return self.event is None or bool(self.event.query())

    def gather(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Block for the batch's ``(values, inside, pred_err)`` host arrays
        (values writable), releasing the replica's in-flight slot even
        when the wait raises."""
        try:
            if self.event is not None:
                self.event.synchronize()
            values = np.array(self.values.numpy(), dtype=np.float64)[: self.n]
            inside = self.inside.numpy()[: self.n]
            pred_err = self.pred_err.numpy()[: self.n]
        finally:
            self.replica.in_flight -= 1
        if self.nan_injected:
            values[:] = np.nan
        return values, inside, pred_err


class ReplicaSet:
    """One artifact's query replicated across devices.

    ``n_replicas`` defaults to one per device; more replicas than devices
    wrap round-robin.  ``routing`` is ``round_robin`` or ``least_loaded``
    (fewest in-flight batches, lowest index on ties; the default).
    Construction warms every replica unless ``warm=False`` (a rollout
    stages its next set cold and warms it before the cutover).
    """

    def __init__(
        self,
        artifact,
        field: str = "DM_over_B",
        n_replicas: Optional[int] = None,
        devices: Optional[Sequence] = None,
        max_batch_size: int = 256,
        routing: str = "least_loaded",
        warm: bool = True,
        stats: Optional[ServeStats] = None,
        error_gate: bool = True,
        fault_plan=None,
    ):
        if routing not in ROUTING_POLICIES:
            raise ValueError(f"routing={routing!r} is not one of {ROUTING_POLICIES}")
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        devices = resolve_devices(devices)
        n = len(devices) if n_replicas is None else int(n_replicas)
        if n < 1:
            raise ValueError("n_replicas must be >= 1 (or None = all devices)")
        self.artifact = artifact
        self.artifact_hash = artifact.content_hash
        self.field = field
        self.max_batch_size = int(max_batch_size)
        self.routing = routing
        self.stats = stats
        self.error_gate = bool(error_gate)
        #: Injected replica faults (site ``replica_dispatch``, keyed by
        #: replica index); None = the zero-overhead default.
        self._faults = fault_plan
        self.replicas: List[_Replica] = [
            _Replica(artifact, devices[i % len(devices)], field, i,
                     error_gate=self.error_gate)
            for i in range(n)
        ]
        self._rr = 0
        self.warmed = False
        self.warmup_seconds = 0.0
        if warm:
            self.warm()

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def n_devices(self) -> int:
        """Distinct devices behind the replicas."""
        return len({str(r.device) for r in self.replicas})

    def _probe(self) -> np.ndarray:
        lower, _hi = artifact_hull(self.artifact)
        return np.tile(lower, (self.max_batch_size, 1))

    def warm(self) -> float:
        """Run the padded batch once on every replica and wait for it.
        Idempotent; records the seconds in the shared ``stats``."""
        if self.warmed:
            return 0.0
        t0 = time.monotonic()
        probe = self._probe()
        for r in self.replicas:
            *_, event = r.dispatch(probe)
            if event is not None:
                event.synchronize()
        self.warmup_seconds = time.monotonic() - t0
        self.warmed = True
        if self.stats is not None:
            self.stats.record_warmup(self.warmup_seconds)
        return self.warmup_seconds

    # ---- routing ----------------------------------------------------

    def pick(self, allowed: Optional[Sequence[int]] = None) -> _Replica:
        """The replica the next micro-batch routes to; ``allowed``
        restricts the pool (the health plane's breaker exclusion)."""
        if self.routing == "round_robin":
            for _ in range(len(self.replicas)):
                r = self.replicas[self._rr % len(self.replicas)]
                self._rr += 1
                if allowed is None or r.index in allowed:
                    return r
            raise ValueError("no routable replica (allowed pool is empty)")
        pool = self.replicas if allowed is None else [self.replicas[i] for i in allowed]
        if not pool:
            raise ValueError("no routable replica (allowed pool is empty)")
        return min(pool, key=lambda r: (r.in_flight, r.index))

    def dispatch(
        self,
        thetas,
        allowed: Optional[Sequence[int]] = None,
        target: Optional[int] = None,
    ) -> _Handle:
        """Route one micro-batch (padded to the bucket) to a replica and
        launch it; ``target`` bypasses the policy (probe and re-answer)."""
        thetas = np.atleast_2d(np.asarray(thetas, dtype=np.float64))
        b = thetas.shape[0]
        if b > self.max_batch_size:
            raise ValueError(
                f"micro-batch of {b} rows exceeds max_batch_size "
                f"{self.max_batch_size}; split it upstream"
            )
        if thetas.shape[1] != len(self.artifact.axis_names):
            raise ValueError(
                f"queries must have {len(self.artifact.axis_names)} "
                f"coordinates ({', '.join(self.artifact.axis_names)}), "
                f"got shape {thetas.shape}"
            )
        padded = _pad_rows(thetas, self.max_batch_size)
        replica = self.replicas[int(target)] if target is not None else self.pick(allowed)
        if self._faults is not None:
            self._faults.fire("replica_dispatch", replica.index)
        # the slot counts only once the launch succeeded (the matching
        # decrement is in _Handle.gather)
        values, inside, pred_err, event = replica.dispatch(padded)
        replica.in_flight += 1
        nan_injected = (
            self._faults is not None
            and self._faults.nan_batch("replica_dispatch", replica.index)
        )
        return _Handle(replica=replica, values=values, inside=inside,
                       pred_err=pred_err, event=event, n=b,
                       nan_injected=nan_injected)

    def reprovision(self, index: int, artifact=None) -> None:
        """Rebuild replica ``index`` from ``artifact`` (same content hash)
        on its own device: fresh tables, warmed here."""
        art = self.artifact if artifact is None else artifact
        if art.content_hash != self.artifact_hash:
            raise ValueError(
                f"re-provision artifact verifies as {art.content_hash!r}, "
                f"this set serves {self.artifact_hash!r}: a re-provision "
                "must not change the surface (that is a rollout)"
            )
        old = self.replicas[index]
        replica = _Replica(art, old.device, self.field, index, error_gate=self.error_gate)
        *_, event = replica.dispatch(self._probe())
        if event is not None:
            event.synchronize()
        self.replicas[index] = replica


class _Pending(NamedTuple):
    theta: np.ndarray
    enqueued_at: float
    future: Future


class _InFlight(NamedTuple):
    batch: "list[_Pending]"
    thetas: np.ndarray
    handle: _Handle
    artifact_hash: str
    wait_s: float
    dispatched_at: float
    batch_index: int
    #: The ReplicaSet the batch was dispatched on (a re-answer runs on
    #: the same surface even if a rollout swapped the active set).
    rset: "Optional[ReplicaSet]" = None
    #: Replica index this batch is the half-open probe of.
    probe_of: Optional[int] = None


class FleetService:
    """Per-request serving over a :class:`ReplicaSet`, with overload
    control: admission (``queue_bound``, typed :class:`QueueFull` at
    submit), deadline shedding at dispatch (typed ``DeadlineExceeded``),
    the shared exact fallback, the replica health plane (on by default),
    the rollout seam :meth:`swap_replica_set` and :meth:`resize`.  Dispatches are
    asynchronous: :meth:`run_once` launches, :meth:`poll` resolves.

    ``n_replicas`` / ``queue_bound`` default from the base config.  The
    exact fallback runs on the first replica's device, or split over the
    members of ``mesh``.
    """

    def __init__(
        self,
        artifact,
        base,
        static=None,
        field: str = "DM_over_B",
        max_batch_size: int = 256,
        n_replicas: Optional[int] = None,
        devices: Optional[Sequence] = None,
        routing: str = "least_loaded",
        queue_bound: Optional[int] = None,
        max_wait_s: float = 0.005,
        deadline_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        retry=None,
        fault_plan=None,
        stats: Optional[ServeStats] = None,
        warm: bool = True,
        error_gate_tol=None,
        health=None,
        store=None,
        lz_profile=None,
        bounce=None,
        host_id: Optional[str] = None,
        mesh=None,
    ):
        from bdlz_tpu_torch.emulator.artifact import build_identity
        from bdlz_tpu_torch.provenance import resolve_store

        devices = resolve_devices(devices)
        static, n_y, impl = resolve_service_static(artifact, base, static)
        self.lz_mode = artifact_lz_mode(artifact)
        self.host_id = host_id
        lz_profile = resolve_service_profile(artifact, lz_profile, bounce, devices[0])
        self.error_gate_tol = resolve_error_gate(artifact, base, error_gate_tol)
        if n_replicas is None:
            n_replicas = getattr(base, "n_replicas", None)
        if queue_bound is None:
            queue_bound = getattr(base, "queue_bound", None)
        if queue_bound is not None and queue_bound < max_batch_size:
            raise ValueError(
                f"queue_bound ({queue_bound}) must be >= max_batch_size "
                f"({max_batch_size}) or None (unbounded)"
            )
        if max_wait_s < 0.0:
            raise ValueError("max_wait_s must be >= 0")
        if deadline_s is not None and deadline_s <= max_wait_s:
            raise ValueError(
                f"deadline_s ({deadline_s}) must exceed max_wait_s "
                f"({max_wait_s}): the wait policy ages every "
                "non-full batch to max_wait_s before dispatch"
            )
        self.field = field
        self.max_batch_size = int(max_batch_size)
        self.queue_bound = None if queue_bound is None else int(queue_bound)
        self.max_wait_s = float(max_wait_s)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self._clock = clock
        self.stats = stats if stats is not None else ServeStats()
        #: The identity every artifact this service will ever serve must
        #: match (the rollout layer's skew check).
        self.expected_identity = build_identity(base, static, n_y, impl)
        self._fallback = ExactFallback(
            base, static, n_y=n_y, impl=impl, chunk_size=self.max_batch_size,
            retry=retry, fault_plan=fault_plan, lz_profile=lz_profile,
            device=devices[0], mesh=mesh,
        )
        #: The engine the exact fallback runs ("kernel" = the CUDA point kernel P1).
        self.exact_engine = self._fallback.engine
        self._faults = self._fallback.fault_plan
        #: The retry policy the registry-facing paths share.
        self.registry_retry = self._fallback._retry
        self.replica_set = ReplicaSet(
            artifact, field=field, n_replicas=n_replicas, devices=devices,
            max_batch_size=self.max_batch_size, routing=routing,
            warm=warm, stats=self.stats,
            error_gate=self.error_gate_tol is not None,
            fault_plan=self._faults,
        )
        self._devices = devices
        policy = resolve_health_policy(health, base)
        self._health_policy = policy
        self.health = (
            HealthPlane(self.replica_set.n_replicas, policy, stats=self.stats)
            if policy is not None else None
        )
        #: Optional provenance store: a persistently sick replica is
        #: re-provisioned from the registry's copy of the active artifact.
        self.store = resolve_store(store, base=base, label="fleet")
        self.rollback_budget = float(getattr(base, "rollback_budget", 0.1))
        #: Rollout observation hook (called after every resolved batch).
        self._observer: Optional[Callable[[float], None]] = None
        self._closed = False
        self._queue: Deque[_Pending] = deque()
        self._inflight: Deque[_InFlight] = deque()
        self._lock = threading.Lock()
        self._batch_index = 0

    @property
    def artifact(self):
        return self.replica_set.artifact

    @property
    def artifact_hash(self) -> str:
        return self.replica_set.artifact_hash

    # ---- rollout seam ----------------------------------------------

    def swap_replica_set(self, replica_set: ReplicaSet) -> ReplicaSet:
        """Atomically make ``replica_set`` the active surface (same field
        and bucket, warmed, same width under a health plane).  Returns the
        previous set; batches in flight on it resolve with its hash."""
        if replica_set.field != self.field:
            raise ValueError(
                f"staged replica set serves field {replica_set.field!r}, "
                f"service serves {self.field!r}"
            )
        if replica_set.max_batch_size != self.max_batch_size:
            raise ValueError(
                f"staged replica set bucket {replica_set.max_batch_size} "
                f"!= service bucket {self.max_batch_size}"
            )
        if not replica_set.warmed:
            raise ValueError(
                "staged replica set is not warmed; warm() it before the "
                "cutover so no request pays the compile"
            )
        if self.health is not None and replica_set.n_replicas != self.replica_set.n_replicas:
            raise ValueError(
                f"staged replica set has {replica_set.n_replicas} "
                f"replicas, the health plane tracks "
                f"{self.replica_set.n_replicas}: a rollout must keep "
                "the fleet shape (resize via a new service)"
            )
        with self._lock:
            old, self.replica_set = self.replica_set, replica_set
        return old

    def resize(self, n_replicas: int) -> int:
        """Rebuild the fleet at ``n_replicas`` replicas in place: the
        multi-tenant autoscaler's hook (``serve/tenancy.py``), and the one
        way to change the fleet's shape on a live service.  The new set is
        built from the same artifact on the same devices and warmed before
        the cutover, so no request pays the first call; it refuses while
        batches are in flight.  The health plane is rebuilt at the new
        width with the same policy (breaker state resets: a breaker of a
        replica index that no longer exists would lie).  Replica count
        never changes served bits.  Returns the new replica count."""
        n = int(n_replicas)
        if n < 1:
            raise ValueError("n_replicas must be >= 1")
        if self._closed:
            raise ServiceUnavailable("service is closed; cannot resize")
        if n == self.replica_set.n_replicas:
            return n
        if self.in_flight():
            raise ValueError(
                "resize with batches in flight; poll() them to completion "
                "first (the autoscaler rebalances only between dispatches)"
            )
        replica_set = ReplicaSet(
            self.replica_set.artifact, field=self.field, n_replicas=n,
            devices=self._devices, max_batch_size=self.max_batch_size,
            routing=self.replica_set.routing, warm=True, stats=self.stats,
            error_gate=self.replica_set.error_gate, fault_plan=self._faults,
        )
        health = (HealthPlane(replica_set.n_replicas, self._health_policy, stats=self.stats)
                  if self._health_policy is not None else None)
        with self._lock:
            self.replica_set = replica_set
            self.health = health
        return n

    # ---- enqueue (admission control) --------------------------------

    def submit(self, theta) -> Future:
        """Enqueue one query; resolves to a :class:`FleetResponse`.
        Raises :class:`QueueFull` at the admission bound and
        :class:`ServiceUnavailable` after :meth:`close`."""
        theta = np.asarray(theta, dtype=np.float64).reshape(-1)
        d = len(self.artifact.axis_names)
        if theta.shape != (d,):
            raise ValueError(
                f"queries must have {d} coordinates "
                f"({', '.join(self.artifact.axis_names)}), got {theta.shape[0]}"
            )
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise ServiceUnavailable("service is closed; resubmit to a live fleet")
            if self.queue_bound is not None and len(self._queue) >= self.queue_bound:
                self.stats.record_admission_rejects(1)
                raise QueueFull(
                    f"queue at its admission bound ({self.queue_bound} "
                    "requests waiting); retry later or raise queue_bound"
                )
            self._queue.append(_Pending(theta, self._clock(), fut))
            self.stats.record_accepted(1)
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

    def in_flight(self) -> int:
        """Micro-batches dispatched to replicas but not yet resolved."""
        with self._lock:
            return len(self._inflight)

    # ---- dispatch (async) -------------------------------------------

    def run_once(self, force: bool = False) -> int:
        """Shed the expired prefix and launch one batch if the policy says
        so, without waiting for the device.  Returns requests consumed."""
        now = self._clock()
        if self._faults is not None:
            now += self._faults.delay_s("clock", self._batch_index)
        with self._lock:
            if not self._queue or not (force or self._ready_locked(now)):
                return 0
            expired = []
            if self.deadline_s is not None:
                while self._queue and now - self._queue[0].enqueued_at > self.deadline_s:
                    expired.append(self._queue.popleft())
            batch = [self._queue.popleft()
                     for _ in range(min(len(self._queue), self.max_batch_size))]
            replica_set = self.replica_set
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
        thetas = np.stack([p.theta for p in batch])
        probe_of = None
        if self.health is None:
            try:
                handle = replica_set.dispatch(thetas)
            except Exception as exc:  # noqa: BLE001 — delivered per-request
                for p in batch:
                    p.future.set_exception(exc)
                return len(batch) + n_expired
        else:
            handle, probe_of = self._dispatch_healed(replica_set, thetas, now)
            if handle is None:
                self._answer_degraded(batch, thetas, replica_set, now, float(wait_s))
                return len(batch) + n_expired
        with self._lock:
            closed = self._closed
            if not closed:
                self._inflight.append(_InFlight(
                    batch=batch, thetas=thetas, handle=handle,
                    artifact_hash=replica_set.artifact_hash,
                    wait_s=float(wait_s), dispatched_at=self._clock(),
                    batch_index=self._batch_index,
                    rset=replica_set, probe_of=probe_of,
                ))
                self._batch_index += 1
        if closed:
            try:
                handle.gather()  # release the in-flight slot
            except Exception:  # noqa: BLE001 — the batch is failed anyway
                pass
            for p in batch:
                p.future.set_exception(ServiceUnavailable(
                    "service closed with the request in flight; "
                    "resubmit to a live fleet"
                ))
        return len(batch) + n_expired

    def _dispatch_healed(self, replica_set, thetas, now):
        """Dispatch with the health plane in the loop: open breakers are
        excluded, a probe-due replica takes this batch as its half-open
        probe, a dispatch failure is scored and re-routed.  ``(None,
        None)`` = no replica could take the batch (degraded mode)."""
        allowed, probe = self.health.routable(now)
        tried: set = set()
        while True:
            if probe is not None and probe not in tried:
                target = probe
                self.health.probe_started(target, now)
            else:
                avail = [i for i in allowed if i not in tried]
                if not avail:
                    return None, None
                target = replica_set.pick(avail).index
            try:
                handle = replica_set.dispatch(thetas, target=target)
            except Exception:  # noqa: BLE001 — scored, batch re-routed
                self.health.record_outcome(
                    target, ok=False, now=now, cause=CAUSE_DISPATCH_ERROR,
                    probe=(target == probe),
                )
                self._maybe_reprovision(target, now)
                tried.add(target)
                if target == probe:
                    probe = None
                continue
            return handle, (target if target == probe else None)

    # ---- resolve ----------------------------------------------------

    def poll(self, block: bool = False) -> int:
        """Resolve the oldest in-flight batch if it is done (always when
        ``block``).  With the health plane on, a batch whose gather raised
        or whose values are non-finite is scored and re-answered on a
        healthy replica of the same set, else answered degraded."""
        with self._lock:
            if not self._inflight:
                return 0
            if not block and not self._inflight[0].handle.done():
                return 0
            item = self._inflight.popleft()
        replica_index = item.handle.replica.index
        heal_cause = None
        values = inside = pred_err = None
        if self.health is None:
            values, inside, pred_err = item.handle.gather()  # blocks
        else:
            try:
                values, inside, pred_err = item.handle.gather()
            except Exception:  # noqa: BLE001 — scored, batch re-answered
                heal_cause = CAUSE_GATHER_ERROR
            if heal_cause is None and not self._replica_values_ok(values, inside, pred_err):
                heal_cause = CAUSE_NAN
        now = self._clock()
        # replica work ended here: the gate and exact fallback below run
        # on the host and are never charged to the replica's latency SLO
        gathered_at = now
        if heal_cause is not None:
            self.health.record_outcome(
                replica_index, ok=False, now=now, cause=heal_cause,
                probe=item.probe_of == replica_index,
            )
            self._maybe_reprovision(replica_index, now)
            healed = self._reanswer(item, now)
            if healed is None:
                self._answer_degraded(
                    item.batch, item.thetas,
                    item.rset if item.rset is not None else self.replica_set,
                    now, item.wait_s, batch_index=item.batch_index,
                )
                return len(item.batch)
            values, inside, pred_err, replica_index = healed
            self.health.note_healed_batch()
        b = len(item.batch)
        fallback, gated, reasons = gate_fallback_masks(inside, pred_err, self.error_gate_tol)
        n_fallback = int(fallback.sum())
        errors: "list[Optional[BaseException]]" = [None] * b
        retries_box = [0]
        if n_fallback:
            ood = _pad_rows(item.thetas[fallback], self.max_batch_size)
            axes = {name: ood[:, k] for k, name in enumerate(self.artifact.axis_names)}
            try:
                exact_fields = self._fallback(axes, retries_box)
                values[fallback] = exact_fields[self.field][:n_fallback]
            except Exception as exc:  # noqa: BLE001 — isolated per request
                for i in np.flatnonzero(fallback):
                    errors[int(i)] = exc
                    values[int(i)] = np.nan
        now = self._clock()
        seconds = float(now - item.dispatched_at)
        replica_seconds = float(gathered_at - item.dispatched_at)
        if self._faults is not None:
            # injected slow-replica faults surface through the clock seam
            delay = self._faults.delay_s("replica_dispatch", replica_index)
            seconds += delay
            replica_seconds += delay
        self.stats.record_batch(
            batch_index=item.batch_index, size=b, occupancy=b / self.max_batch_size,
            wait_s=item.wait_s, n_fallback=n_fallback, seconds=seconds,
            n_retries=retries_box[0], n_error=sum(e is not None for e in errors),
            n_gated=int(gated.sum()), artifact_hash=item.artifact_hash,
            replica=replica_index, lz_mode=self.lz_mode, host_id=self.host_id,
        )
        # the refinement daemon's traffic trace (a no-op unless armed)
        self.stats.record_queries(item.thetas, reasons)
        if self.health is not None and heal_cause is None:
            self.health.record_outcome(
                replica_index, ok=True, now=now, seconds=replica_seconds,
                probe=item.probe_of == replica_index,
            )
        for p, v, e, reason in zip(item.batch, values, errors, reasons):
            self.stats.record_latency(now - p.enqueued_at)
            if e is not None:
                p.future.set_exception(e)
            else:
                p.future.set_result(FleetResponse(
                    value=float(v), artifact_hash=item.artifact_hash,
                    replica=replica_index, fallback_reason=reason,
                    lz_mode=self.lz_mode, host_id=self.host_id,
                ))
        if self._observer is not None:
            self._observer(now)
        return b

    def _replica_values_ok(self, values, inside, pred_err) -> bool:
        """False when the replica emitted a non-finite value for a request
        the emulator path answers (fallback rows are overwritten)."""
        fallback, _, _ = gate_fallback_masks(inside, pred_err, self.error_gate_tol)
        return bool(np.isfinite(values[~fallback]).all())

    def _reanswer(self, item: _InFlight, now: float):
        """Re-run a failed/NaN batch on a healthy replica of its own set
        (bit-identical: the same function on the same table bytes).
        ``(values, inside, pred_err, replica_index)`` or None."""
        rset = item.rset if item.rset is not None else self.replica_set
        tried = {item.handle.replica.index}
        while True:
            allowed, _probe = self.health.routable(now)
            avail = [i for i in allowed if i not in tried and i < rset.n_replicas]
            if not avail:
                return None
            idx = rset.pick(avail).index
            try:
                handle = rset.dispatch(item.thetas, target=idx)
                values, inside, pred_err = handle.gather()
            except Exception:  # noqa: BLE001 — scored, next replica tried
                self.health.record_outcome(idx, ok=False, now=now, cause=CAUSE_DISPATCH_ERROR)
                self._maybe_reprovision(idx, now)
                tried.add(idx)
                continue
            if not self._replica_values_ok(values, inside, pred_err):
                self.health.record_outcome(idx, ok=False, now=now, cause=CAUSE_NAN)
                self._maybe_reprovision(idx, now)
                tried.add(idx)
                continue
            return values, inside, pred_err, idx

    def _answer_degraded(self, batch, thetas, replica_set, now, wait_s,
                         batch_index=None) -> None:
        """Every breaker is open: answer through the exact pipeline,
        loudly (``degraded=True``, reason ``"degraded"``, replica ``-1``),
        or with a typed :class:`ServiceUnavailable` when that path fails."""
        b = len(batch)
        padded = _pad_rows(np.atleast_2d(np.asarray(thetas, dtype=np.float64)),
                           self.max_batch_size)
        axes = {name: padded[:, k] for k, name in enumerate(self.artifact.axis_names)}
        retries_box = [0]
        err: Optional[BaseException] = None
        values = np.full(b, np.nan)
        try:
            exact_fields = self._fallback(axes, retries_box)
            values = np.asarray(exact_fields[self.field][:b], dtype=np.float64)
        except Exception as exc:  # noqa: BLE001 — typed per-request below
            err = exc
        self.health.note_degraded_batch()
        if batch_index is None:
            with self._lock:
                batch_index = self._batch_index
                self._batch_index += 1
        done = self._clock()
        self.stats.record_batch(
            batch_index=batch_index, size=b, occupancy=b / self.max_batch_size,
            wait_s=float(wait_s), n_fallback=b, seconds=float(done - now),
            n_retries=retries_box[0], n_error=b if err is not None else 0,
            n_gated=0, artifact_hash=replica_set.artifact_hash, replica=-1,
            lz_mode=self.lz_mode, host_id=self.host_id,
        )
        self.stats.record_queries(thetas, REASON_DEGRADED)
        for p, v in zip(batch, values):
            self.stats.record_latency(done - p.enqueued_at)
            if err is not None:
                unavailable = ServiceUnavailable(
                    f"all {replica_set.n_replicas} replicas are "
                    f"circuit-open and the degraded exact path failed: "
                    f"{type(err).__name__}: {err}"
                )
                unavailable.__cause__ = err
                p.future.set_exception(unavailable)
            else:
                p.future.set_result(FleetResponse(
                    value=float(v), artifact_hash=replica_set.artifact_hash,
                    replica=-1, fallback_reason=REASON_DEGRADED, degraded=True,
                    lz_mode=self.lz_mode, host_id=self.host_id,
                ))
        if self._observer is not None:
            self._observer(done)

    def _maybe_reprovision(self, index: int, now: float) -> None:
        """Re-provision a persistently sick replica from the registry by
        content hash (under the registry retry policy); a failed fetch is
        counted and the breaker stays open."""
        if self.store is None or not self.health.needs_reprovision(index):
            return
        from bdlz_tpu_torch.provenance import fetch_artifact_with_retry

        try:
            artifact = fetch_artifact_with_retry(
                self.store, self.replica_set.artifact_hash,
                fault_plan=self._faults, retry=self.registry_retry,
            )
            self.replica_set.reprovision(index, artifact)
        except Exception:  # noqa: BLE001 — counted, breaker stays open
            self.health.note_reprovision(index, ok=False, now=now)
            return
        self.health.note_reprovision(index, ok=True, now=now)

    def drain(self) -> int:
        """Dispatch everything queued and resolve every in-flight batch,
        keeping up to two batches in flight per replica.  Returns
        requests resolved."""
        depth = 2 * self.replica_set.n_replicas
        resolved = 0
        while True:
            launched = self.run_once(force=True)
            while self.in_flight() > depth:
                resolved += self.poll(block=True)
            if launched == 0 and self.pending() == 0:
                break
        while self.in_flight():
            resolved += self.poll(block=True)
        return resolved

    # ---- shutdown ---------------------------------------------------

    def close(self) -> int:
        """Fail every pending and in-flight request with a typed
        :class:`ServiceUnavailable`; later submits raise.  Idempotent;
        returns the number of futures failed (call :meth:`drain` first
        to finish instead)."""
        with self._lock:
            self._closed = True
            pending = list(self._queue)
            self._queue.clear()
            inflight = list(self._inflight)
            self._inflight.clear()
        n = 0
        for item in inflight:
            try:
                item.handle.gather()
            except Exception:  # noqa: BLE001 — the batch is failed anyway
                pass
            for p in item.batch:
                p.future.set_exception(ServiceUnavailable(
                    "service closed with the request in flight; "
                    "resubmit to a live fleet"
                ))
                n += 1
        for p in pending:
            p.future.set_exception(ServiceUnavailable(
                "service closed before the request was dispatched; "
                "resubmit to a live fleet"
            ))
            n += 1
        return n

    def theta_from_mapping(self, point: Dict[str, float]) -> np.ndarray:
        """(d,) query vector from an {axis_name: value} mapping."""
        return theta_from_mapping(self.artifact, point)


__all__ = ["FleetResponse", "FleetService", "ReplicaSet", "resolve_devices"]
