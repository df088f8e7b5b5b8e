"""Cross-host serving fabric.

Counterpart of ``bdlz_tpu/serve/fabric.py``: the control plane that makes
a set of hosts, each with a
:class:`~bdlz_tpu_torch.serve.tenancy.MultiTenantService`, one serving
surface, over the shared provenance store.

* **host-lease membership** (``parallel/multihost.py`` over the registry's
  lease records): each :class:`FabricHost` keeps a TTL'd lease
  advertising its pools, capacity and artifact hashes, extended every
  fabric tick.  A lease that stops extending — a dead host or a
  live-but-silent one (``heartbeat_loss``) — expires and the host is
  fenced: the router refuses it even if it still answers.
* **global routing and whole-host failover** (:class:`GlobalRouter`): a
  request goes to a live host advertising its scenario or hash, else to
  the least-loaded live host, whose cold admission (a fetch by content
  hash through its local :class:`ArtifactCache`) is the failover.
* **whole-host death** (fault site ``host_crash``): the host's serving
  plane closes — every queued and in-flight request resolves with a typed
  ``ServiceUnavailable`` — and its lease dangles until TTL expiry.
* **partition-tolerant serving** (fault site ``store_partition``): a host
  that cannot reach the store after a bounded retry marks itself
  partitioned, stops heartbeating, and answers what it still receives
  through the pool's retained exact pipeline on the pool's device (the
  card; P1 for an ``impl="kernel"`` artifact): ``degraded=True``, reason
  ``"store_partition"``, replica ``-1``.  The first heartbeat that lands
  clears the partition.
* **idle-host chunk stealing**: a host whose serving plane is idle leases
  elastic sweep chunks through an ordinary
  :class:`~bdlz_tpu_torch.parallel.worker.Worker` named after the host,
  bitwise the serial ``run_sweep`` by the commit protocol.

All of it is orchestration: none of it changes served bits, and every
fault site is off by default.
"""
from __future__ import annotations

import time
from concurrent.futures import Future
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from bdlz_tpu_torch.faults import FaultError, FaultPlan
from bdlz_tpu_torch.parallel.multihost import publish_host_lease, read_host_lease
from bdlz_tpu_torch.serve.batcher import ServiceUnavailable
from bdlz_tpu_torch.serve.fleet import FleetResponse
from bdlz_tpu_torch.serve.service import _pad_rows
from bdlz_tpu_torch.serve.tenancy import MultiTenantService

#: Loud degraded-answer reason of a store-partitioned host (the
#: ``"pool_evicted"``/``"degraded"`` family).
REASON_STORE_PARTITION = "store_partition"

HOST_LEASE_SCHEMA = 1


class FabricError(RuntimeError):
    """Fabric protocol failure (seat collision, store partition)."""


class FabricPartitionError(FabricError):
    """The shared store stayed unreachable through the bounded retry."""


class FabricHost:
    """One fabric member: a :class:`MultiTenantService` plus the lease /
    heartbeat / crash / partition / chunk-stealing control loop.

    ``tenant_map`` should be the FULL fabric map (every scenario →
    hash): which scenarios a host actually serves is decided by routing
    and lazy cold admission, which is exactly what makes whole-host
    failover a fetch-by-hash instead of a reconfiguration.
    ``cache_root`` arms a host-local pull-through
    :class:`~bdlz_tpu_torch.provenance.ArtifactCache` in front of every
    admission fetch.  ``**tenancy_kw`` passes through to
    :class:`MultiTenantService` (batch size, replicas, profiles, ...).
    """

    def __init__(
        self,
        base,
        *,
        fabric: str,
        host_id: str,
        host_index: int,
        store,
        tenant_map: Optional[Mapping[str, str]] = None,
        clock=time.time,
        ttl_s: float = 60.0,
        cache_root: Optional[str] = None,
        fault_plan=None,
        partition_retries: int = 3,
        steal_chunks_per_tick: int = 1,
        **tenancy_kw: Any,
    ):
        from bdlz_tpu_torch.provenance import ArtifactCache

        self.fabric = str(fabric)
        self.host_id = str(host_id)
        self.host_index = int(host_index)
        self.store = store
        self.clock = clock
        self.ttl_s = float(ttl_s)
        if partition_retries < 1:
            raise FabricError("partition_retries must be >= 1")
        self.partition_retries = int(partition_retries)
        self.steal_chunks_per_tick = int(steal_chunks_per_tick)
        #: ONE resolved plan shared with the serving plane, so the
        #: fabric sites (host_crash / heartbeat_loss / store_partition)
        #: and the serve sites spend budgets off the same counters.
        self._faults = FaultPlan.resolve(fault_plan, base)
        self.artifact_cache = (
            ArtifactCache(cache_root) if cache_root is not None else None
        )
        self.service = MultiTenantService(
            base,
            tenant_map=tenant_map,
            store=store,
            clock=clock,
            fault_plan=self._faults,
            host_id=self.host_id,
            artifact_cache=self.artifact_cache,
            **tenancy_kw,
        )
        self.alive = True
        self.partitioned = False
        self.generation = 0
        #: ``host_crash`` fault key: a plan kills this host at a chosen
        #: tick of ITS control loop, not at a global instant.
        self.ticks = 0
        self.heartbeats = 0
        self.heartbeats_lost = 0
        self.chunks_stolen = 0
        self.degraded_partition_answers = 0
        #: Per-host ``store_partition`` fault-key counter (the
        #: ``registry_fetch`` per-store pattern).
        self._store_calls = 0
        self._sweep_worker = None
        self._sweep_leases = None

    # ---- store access under partition faults ------------------------

    def _store_op(self, fn, *args: Any, **kw: Any):
        """Run one store-facing operation under the bounded partition
        retry: each attempt consumes one ``store_partition`` fire (keyed
        by the per-host call counter); exhaustion raises
        :class:`FabricPartitionError` — loud, typed, never a hang."""
        last: Optional[BaseException] = None
        for _ in range(self.partition_retries):
            key = self._store_calls
            self._store_calls += 1
            if self._faults is not None:
                try:
                    self._faults.fire("store_partition", key)
                except FaultError as exc:
                    last = exc
                    continue
            return fn(*args, **kw)
        raise FabricPartitionError(
            f"host {self.host_id}: store unreachable after "
            f"{self.partition_retries} attempts"
        ) from last

    # ---- membership -------------------------------------------------

    def lease_record(self) -> Dict[str, Any]:
        """This host's membership advertisement: live pools (scenario →
        hash, the router's failover inventory), capacity, and the TTL'd
        expiry the whole fencing story hangs off."""
        svc = self.service
        pools = {
            p.scenario or content_hash: content_hash
            for content_hash, p in svc.pools.items()
        }
        return {
            "schema": HOST_LEASE_SCHEMA,
            "fabric": self.fabric,
            "host_index": self.host_index,
            "host_id": self.host_id,
            "generation": self.generation,
            "expires_at": float(self.clock()) + self.ttl_s,
            "pools": pools,
            "artifact_hashes": sorted(svc.pools),
            "capacity": {
                "n_pools": len(svc.pools),
                "total_replicas": svc.total_replicas(),
                "replica_budget": svc.replica_budget,
            },
            "stealing": self._sweep_worker is not None,
        }

    def register(self) -> None:
        """Claim this host's membership seat (exclusive create, or steal
        an expired/torn seat).  A LIVE seat under a different host_id is
        an identity collision and raises typed :class:`FabricError`."""
        won = self._store_op(
            publish_host_lease, self.store, self.fabric, self.host_index,
            self.lease_record(), clock=self.clock,
        )
        if not won:
            raise FabricError(
                f"fabric {self.fabric} seat {self.host_index} is held by a "
                f"live lease under a different host_id; refusing the "
                f"collision (candidate {self.host_id})"
            )

    def heartbeat(self) -> bool:
        """Extend the lease + refresh the advertisement.  False when the
        heartbeat did NOT land: dead host, an injected ``heartbeat_loss``
        (the lease silently stops extending while the host keeps
        answering — the router must fence it), or a store partition
        (which additionally flips the host into degraded-exact serving
        until a later heartbeat lands)."""
        if not self.alive:
            return False
        if self._faults is not None:
            try:
                self._faults.fire("heartbeat_loss", self.host_index)
            except FaultError:
                # SILENT by design: the host believes it is healthy;
                # only the router's TTL arithmetic can catch this
                self.heartbeats_lost += 1
                return False
        try:
            won = self._store_op(
                publish_host_lease, self.store, self.fabric,
                self.host_index, self.lease_record(), clock=self.clock,
            )
        except FabricPartitionError:
            if not self.partitioned:
                self.partitioned = True
            return False
        if not won:
            raise FabricError(
                f"fabric {self.fabric} seat {self.host_index} was stolen "
                f"from {self.host_id} (a replacement registered after our "
                "lease expired); this instance must stand down"
            )
        if self.partitioned:
            # rejoin: the partition healed and the lease extends again —
            # routing resumes on the router's next read
            self.partitioned = False
        self.generation += 1
        self.heartbeats += 1
        return True

    # ---- death ------------------------------------------------------

    def crash(self) -> int:
        """Whole-host death: the serving plane closes (every in-flight
        and queued request gets typed ``ServiceUnavailable`` — never
        silent loss), the lease stops extending, and TTL expiry hands
        this host's tenants to the survivors.  Returns futures failed."""
        if not self.alive:
            return 0
        self.alive = False
        return self.service.close()

    # ---- serving ----------------------------------------------------

    def submit(
        self,
        theta,
        scenario: Optional[str] = None,
        artifact_hash: Optional[str] = None,
    ) -> Future:
        """Enqueue one request on this host.  Dead host → synchronous
        typed ``ServiceUnavailable`` (the router's ladder re-routes);
        partitioned host → loud degraded-exact answer (reason
        ``"store_partition"``); healthy host → the tenancy plane."""
        if not self.alive:
            raise ServiceUnavailable(
                f"host {self.host_id} is dead; resubmit via the router"
            )
        if self.partitioned:
            return self._submit_partition_degraded(
                theta, scenario, artifact_hash
            )
        return self.service.submit(
            theta, scenario=scenario, artifact_hash=artifact_hash
        )

    def _submit_partition_degraded(
        self, theta, scenario, artifact_hash,
    ) -> Future:
        """Serve one request on a store-partitioned host: an already-
        admitted pool answers through its retained exact pipeline —
        correct, loud (``degraded=True``, reason ``"store_partition"``,
        replica ``-1``), and slow — because a fenced host must not hand
        out possibly stale-routed emulator answers.  A scenario this
        host never admitted needs the registry, which is exactly what
        is unreachable: typed ``ServiceUnavailable``."""
        svc = self.service
        fut: Future = Future()
        key = scenario if scenario is not None else artifact_hash
        try:
            pool = svc.pool(key)
        except KeyError:
            fut.set_exception(ServiceUnavailable(
                f"host {self.host_id} is store-partitioned and has no "
                f"admitted pool for {key!r}; cold admission needs the "
                "registry — resubmit via the router"
            ))
            return fut
        if pool.fallback is None:
            fut.set_exception(ServiceUnavailable(
                f"host {self.host_id} is store-partitioned and pool "
                f"{pool.artifact_hash} has no retained exact path"
            ))
            return fut
        t0 = self.clock()
        theta_row = np.atleast_2d(np.asarray(theta, dtype=np.float64))
        padded = _pad_rows(theta_row, svc.max_batch_size)
        axes = {
            name: padded[:, k] for k, name in enumerate(pool.axis_names)
        }
        retries_box = [0]
        err: Optional[BaseException] = None
        value = float("nan")
        try:
            exact_fields = pool.fallback(axes, retries_box)
            value = float(np.asarray(exact_fields[svc.field])[0])
        except Exception as exc:  # noqa: BLE001 — typed below
            err = exc
        done = self.clock()
        pool.stats.record_accepted(1)
        pool.stats.record_batch(
            batch_index=pool._batch_index,
            size=1,
            occupancy=1.0 / svc.max_batch_size,
            wait_s=0.0,
            n_fallback=1,
            seconds=float(done - t0),
            n_retries=retries_box[0],
            n_error=1 if err is not None else 0,
            n_gated=0,
            artifact_hash=pool.artifact_hash,
            replica=-1,
            lz_mode=pool.lz_mode,
            host_id=self.host_id,
        )
        pool.stats.record_queries(theta_row, REASON_STORE_PARTITION)
        pool.stats.record_latency(float(done - t0))
        pool._batch_index += 1
        if err is not None:
            unavailable = ServiceUnavailable(
                f"host {self.host_id} is store-partitioned and the "
                f"degraded exact path failed: {type(err).__name__}: {err}"
            )
            unavailable.__cause__ = err
            fut.set_exception(unavailable)
        else:
            self.degraded_partition_answers += 1
            fut.set_result(FleetResponse(
                value=value,
                artifact_hash=pool.artifact_hash,
                replica=-1,
                fallback_reason=REASON_STORE_PARTITION,
                degraded=True,
                lz_mode=pool.lz_mode,
                host_id=self.host_id,
            ))
        return fut

    # ---- idle-cycle chunk stealing ----------------------------------

    def attach_sweep(self, plan, leases, *, engine_box=None, churn=None):
        """Hook an elastic sweep job (``parallel/scheduler.py``) to this
        host: whenever the serving plane is provably idle, the fabric
        tick claims/computes/commits chunks through an ordinary elastic
        :class:`Worker` named after the host — same leases, same
        publish-then-commit, bitwise-identical results by construction."""
        from bdlz_tpu_torch.parallel.worker import Worker

        self._sweep_leases = leases
        self._sweep_worker = Worker(
            self.host_id, plan, leases, self.store,
            engine_box=engine_box if engine_box is not None else {},
            churn=churn,
        )

    def serving_idle(self) -> bool:
        """True when every pool is idle (no queued, in-flight, or
        degraded-pending work) — the ONLY state the host may spend its
        cycles on stolen sweep chunks in."""
        return all(p.idle() for p in self.service.pools.values())

    def _maybe_steal_chunks(self) -> int:
        """One stealing pass of the fabric tick: claim and finish up to
        ``steal_chunks_per_tick`` chunks, but ONLY while the serving
        plane stays idle — re-checked before every claim, so admission
        pressure releases the queue within a single tick (each stolen
        chunk completes inside its own step; nothing is held across
        ticks)."""
        if (
            self._sweep_worker is None
            or not self.alive
            or self.partitioned
        ):
            return 0
        done = 0
        for _ in range(max(self.steal_chunks_per_tick, 0)):
            if not self.serving_idle():
                break
            self._sweep_leases.requeue_expired()
            if not self._sweep_worker.step():
                break
            done += 1
        self.chunks_stolen += done
        return done

    # ---- the fabric tick --------------------------------------------

    def tick(self) -> None:
        """One control-plane turn: injected whole-host death →
        heartbeat → pump the serving plane → steal idle cycles."""
        if not self.alive:
            return
        tick_key = self.ticks
        self.ticks += 1
        if self._faults is not None:
            try:
                self._faults.fire("host_crash", tick_key)
            except FaultError:
                self.crash()
                return
        self.heartbeat()
        self.service.run_once()
        self.service.poll(block=False)
        self._maybe_steal_chunks()

    # ---- lifecycle / telemetry --------------------------------------

    def drain(self) -> int:
        return self.service.drain() if self.alive else 0

    def close(self) -> int:
        if not self.alive:
            return 0
        self.alive = False
        return self.service.close()

    def summary(self) -> Dict[str, Any]:
        return {
            "host_id": self.host_id,
            "host_index": self.host_index,
            "alive": self.alive,
            "partitioned": self.partitioned,
            "heartbeats": self.heartbeats,
            "heartbeats_lost": self.heartbeats_lost,
            "chunks_stolen": self.chunks_stolen,
            "degraded_partition_answers": self.degraded_partition_answers,
            "service": self.service.summary(),
        }


class GlobalRouter:
    """Scenario/hash → live host, over the membership leases alone.

    The router never talks to a host to decide liveness: the lease IS
    the health signal, which is what makes ``heartbeat_loss`` fencing
    work — a host that still answers but stopped extending its lease is
    indistinguishable (deliberately) from a dead one.  ``n_slots`` is
    the fabric's membership width; absent/torn/expired records simply
    read as fenced seats."""

    def __init__(self, store, fabric: str, n_slots: int, clock=time.time):
        self.store = store
        self.fabric = str(fabric)
        self.n_slots = int(n_slots)
        self.clock = clock

    def members(self) -> List[Optional[Dict[str, Any]]]:
        """Every seat's current record (None = absent or torn)."""
        return [
            read_host_lease(self.store, self.fabric, i)
            for i in range(self.n_slots)
        ]

    def live(self) -> List[Dict[str, Any]]:
        """Unexpired member records — the routable set."""
        now = float(self.clock())
        return [
            rec for rec in self.members()
            if rec is not None and float(rec.get("expires_at", 0.0)) > now
        ]

    def route(
        self,
        scenario: Optional[str] = None,
        artifact_hash: Optional[str] = None,
        exclude: Sequence[int] = (),
    ) -> Dict[str, Any]:
        """The lease record of the host to send this request to: a live
        host already advertising the scenario/hash if any (least-loaded
        wins ties), else the least-loaded live host (whose cold
        admission IS the failover re-admit).  ``exclude`` removes seats
        the ladder already found dead this submit.  Raises typed
        ``ServiceUnavailable`` when no live host remains."""
        live = [
            rec for rec in self.live()
            if int(rec.get("host_index", -1)) not in set(exclude)
        ]
        if not live:
            raise ServiceUnavailable(
                f"fabric {self.fabric}: no live host lease "
                f"({self.n_slots} seats, {len(list(exclude))} excluded); "
                "every seat is dead, fenced, or partitioned"
            )
        def _serves(rec) -> bool:
            pools = rec.get("pools", {})
            if scenario is not None and scenario in pools:
                return True
            return (
                artifact_hash is not None
                and artifact_hash in pools.values()
            )

        serving = [rec for rec in live if _serves(rec)]
        candidates = serving if serving else live
        # deterministic least-loaded: fewest admitted pools, then the
        # lowest seat index — every router replica picks the same host
        return min(
            candidates,
            key=lambda rec: (
                int(rec.get("capacity", {}).get("n_pools", 0)),
                int(rec.get("host_index", 0)),
            ),
        )


class ServingFabric:
    """The in-process fabric: hosts and one router over one shared store
    and clock, with the submit failover ladder and one ``tick`` driving
    every member."""

    def __init__(self, hosts: Sequence[FabricHost], router: GlobalRouter):
        self.hosts = list(hosts)
        self.router = router
        self._by_index = {h.host_index: h for h in self.hosts}
        self.failovers = 0

    def register_all(self) -> None:
        for h in self.hosts:
            h.register()

    def submit(
        self,
        theta,
        scenario: Optional[str] = None,
        artifact_hash: Optional[str] = None,
    ) -> Future:
        """Route + submit with the failover ladder: a routed host that
        refuses synchronously (dead between heartbeat and TTL) is
        excluded and the next live host tried; only an empty live set
        surfaces as typed ``ServiceUnavailable``."""
        tried: List[int] = []
        while True:
            rec = self.router.route(
                scenario=scenario, artifact_hash=artifact_hash,
                exclude=tried,
            )
            idx = int(rec["host_index"])
            host = self._by_index.get(idx)
            if host is None:
                tried.append(idx)
                continue
            try:
                return host.submit(
                    theta, scenario=scenario, artifact_hash=artifact_hash
                )
            except ServiceUnavailable:
                # dead-but-not-yet-expired seat: ladder to a survivor
                tried.append(idx)
                self.failovers += 1

    def tick(self) -> None:
        for h in self.hosts:
            h.tick()

    def drain(self) -> int:
        return sum(h.drain() for h in self.hosts)

    def close(self) -> int:
        return sum(h.close() for h in self.hosts)

    def summary(self) -> Dict[str, Any]:
        return {
            "fabric": self.router.fabric,
            "n_hosts": len(self.hosts),
            "failovers": self.failovers,
            "hosts": [h.summary() for h in self.hosts],
        }


__all__ = [
    "REASON_STORE_PARTITION",
    "FabricError",
    "FabricPartitionError",
    "FabricHost",
    "GlobalRouter",
    "ServingFabric",
]
