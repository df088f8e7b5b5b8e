"""Multi-tenant scenario-routed serving plane.

Counterpart of ``bdlz_tpu/serve/tenancy.py``.  One process, many
emulator artifacts: a :class:`MultiTenantService` routes each request —
tagged with a scenario label (through a tenant map) or an artifact
content hash — to a per-artifact :class:`PoolState`, each with its own
:class:`FleetService` (replicas, queue, admission bound, breakers,
``ServeStats``).  A noisy tenant saturates its own queue and sheds its
own traffic, never a neighbour's.

On top of the pools:

* **cold admission** — the first request for an unknown hash fetches the
  artifact from the registry by content hash under the shared retry
  policy, derives the pool's physics config from the artifact identity's
  ``lz_scenario`` key (potential fingerprints for ``bounce=`` pools are
  checked by the fleet), builds a warmed fleet and probes it at the
  domain hull's corner before it joins rotation;
* **autoscaling** — every ``autoscale_interval_s`` on the service's
  clock, per-pool occupancy from new stats rows feeds streak hysteresis
  (sustained high occupancy grows a pool by one replica, sustained
  idleness shrinks it to ``pool_min_replicas``) under the fleet-wide
  ``replica_budget`` ceiling; a pool with batches in flight defers;
* **memory-pressure eviction** — a budget over the resident pools' table
  bytes LRU-evicts idle pools; an evicted pool's requests are answered
  by the loud degraded exact path (``degraded=True``, reason
  ``"pool_evicted"``, replica ``-1``) on the pool's device — the card,
  through P1 for an ``impl="kernel"`` artifact — until :meth:`readmit`;
* **typed skew rejection** — a request whose stated ``lz_mode``
  disagrees with its pool's is refused with :class:`TenancyError`.

Per-artifact answers are bitwise those of a single-tenant
:class:`FleetService` of the same artifact, whatever the routing,
autoscaling or evict/readmit cycles.  The fault sites ``pool_evict``
(forced eviction, keyed by the eviction counter) and ``autoscale``
(skipped pass, keyed by the pass counter) act as in the JAX package.
``pool_bytes_per_replica`` keeps the JAX formula, so both packages take
the same eviction decisions.  ``devices`` are the card's unless the
caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import (
    Callable,
    Deque,
    Dict,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np

from bdlz_tpu_torch.config import VALID_LZ_MODES, VALID_TENANT_ROUTING
from bdlz_tpu_torch.emulator.grid import artifact_hull, domain_artifacts
from bdlz_tpu_torch.faults import FaultError, FaultPlan
from bdlz_tpu_torch.serve.batcher import DeadlineExceeded, QueueFull, ServiceUnavailable
from bdlz_tpu_torch.serve.fleet import FleetResponse, FleetService, resolve_devices
from bdlz_tpu_torch.serve.service import _pad_rows, artifact_lz_mode, theta_from_mapping
from bdlz_tpu_torch.utils.profiling import ServeStats

#: ``FleetResponse.fallback_reason`` for an answer the exact pipeline
#: produced because the request's pool was memory-evicted — the pool
#: analogue of the all-breakers-open ``"degraded"`` reason.
REASON_POOL_EVICTED = "pool_evicted"

#: Autoscaler hysteresis: occupancy at/above which a pass counts toward
#: growing, at/below which it counts toward shrinking, and how many
#: CONSECUTIVE passes each decision needs.  Streaks reset on any pass
#: that breaks them (and on a completed resize), so an oscillating load
#: never flaps the replica count.
OCC_HIGH = 0.85
OCC_LOW = 0.25
UP_PASSES = 2
DOWN_PASSES = 3


class TenancyError(ValueError):
    """A request or tenant map the multi-tenant plane refuses: unknown
    scenario, missing/conflicting routing tags, cross-scenario skew, a
    replica budget that cannot fit another pool.  Typed so callers can
    tell a routing refusal from an overload signal (``QueueFull``) or a
    dead service (``ServiceUnavailable``)."""


def pool_base(base, artifact):
    """The per-pool physics config ``artifact``'s fleet must run with.

    The fleet's identity check (``resolve_service_static`` →
    ``check_identity``) is strict on the ``lz_scenario`` key, so a pool
    serving a chain artifact needs ``lz_mode="chain"`` (etc.) in its
    base — derived here from the artifact identity's own payload, with
    the off-scenario knobs reset to their defaults (``Config.validate``
    rejects, e.g., a thermal bath on a chain config).  Everything else
    is shared: the tenant map's artifacts must have been built from
    the same physics/engine base, differing only in scenario knobs.
    """
    scen = dict(artifact.identity).get("lz_scenario")
    mode = str(scen["mode"]) if scen else "two_channel"
    return dataclasses.replace(
        base,
        lz_mode=mode,
        lz_n_levels=int(scen["n_levels"]) if mode == "chain" else 2,
        lz_bath_eta=float(scen["eta"]) if mode == "thermal" else 0.0,
        lz_bath_omega_c=float(scen["omega_c"]) if mode == "thermal" else 0.0,
    )


def pool_bytes_per_replica(
    artifact, field: str = "DM_over_B", error_gate: bool = True
) -> int:
    """Estimated device bytes ONE replica of ``artifact`` keeps resident
    (the eviction budget's unit): per domain, the axis-node vectors plus
    the served field's log-value table, doubled when the error gate adds
    its same-shape predicted-error table.  An estimate — padding and
    per-device layout are ignored — but monotone in the real footprint,
    which is all the LRU budget needs."""
    total = 0
    for dom in domain_artifacts(artifact):
        total += sum(np.asarray(n).nbytes for n in dom.axis_nodes)
        v = np.asarray(dom.values[field]).nbytes
        total += v + (v if error_gate else 0)
    return int(total)


class _DegradedPending:
    """One request accepted while its pool was evicted (answered by the
    exact path at the next dispatch tick)."""

    __slots__ = ("theta", "enqueued_at", "future")

    def __init__(self, theta, enqueued_at: float, future: Future):
        self.theta = theta
        self.enqueued_at = enqueued_at
        self.future = future


class PoolState:
    """One tenant pool: which artifact it serves, its live fleet (None
    while evicted), its service-owned stats (SURVIVES evict/readmit
    cycles — the pool's telemetry is continuous), and the retained
    exact-path kit that answers requests during eviction."""

    def __init__(self, scenario: Optional[str], artifact_hash: str):
        self.scenario = scenario
        self.artifact_hash = artifact_hash
        #: "two_channel" | "chain" | "thermal" (set at admission).
        self.lz_mode: Optional[str] = None
        self.axis_names: Tuple[str, ...] = ()
        self.fleet: Optional[FleetService] = None
        self.stats = ServeStats()
        self.evicted = False
        #: Service-clock stamp of the last submit (the LRU key).
        self.last_used = 0.0
        self.bytes_per_replica = 0
        #: Wall-clock seconds of every (re)admission (fetch, build, warm, probe).
        self.admission_seconds: List[float] = []
        #: The retained ExactFallback — answers ``pool_evicted``
        #: requests after the fleet (and its device tables) are gone.
        self.fallback = None
        self._degraded: Deque[_DegradedPending] = deque()
        self._batch_index = 0
        # autoscaler state: cursor into stats.rows + hysteresis streaks
        self._row_seen = 0
        self._up = 0
        self._down = 0

    @property
    def n_replicas(self) -> int:
        return 0 if self.fleet is None else self.fleet.replica_set.n_replicas

    @property
    def resident_bytes(self) -> int:
        """Estimated device bytes this pool holds right now (0 while
        evicted — eviction is exactly what releases them)."""
        return self.bytes_per_replica * self.n_replicas

    def idle(self) -> bool:
        """No queued, in-flight, or degraded-pending work — the only
        state a pool may be evicted or donate a replica from."""
        if self._degraded:
            return False
        if self.fleet is None:
            return True
        return self.fleet.pending() == 0 and self.fleet.in_flight() == 0


class MultiTenantService:
    """Scenario-routed serving over per-artifact pools (the module
    docstring has the semantics).

    ``tenant_map`` maps scenario labels to artifact content hashes;
    ``tenant_routing`` (explicit ▸ ``Config.tenant_routing`` ▸ engine
    decides) picks how requests name their pool.  Pools are built
    lazily on first request (cold admission) from the provenance
    ``store`` — required: a multi-tenant plane with no registry could
    never admit anything.  ``fault_scenarios`` restricts the replica/
    exact-path fault sites of an armed plan to the named pools
    (scenario labels or hashes; None = every pool): "one pool's
    replicas are sick"; the service-level ``pool_evict``/``autoscale``
    sites always read the shared plan.  ``devices`` are the pools'
    replica devices (the cards; ``["cpu"]`` on request).
    """

    def __init__(
        self,
        base,
        tenant_map: Optional[Mapping[str, str]] = None,
        store=None,
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
        fault_scenarios: Optional[Sequence[str]] = None,
        warm: bool = True,
        error_gate_tol=None,
        health=None,
        lz_profile=None,
        bounce=None,
        tenant_routing: Optional[str] = None,
        memory_budget_bytes: Optional[int] = None,
        autoscale_interval_s: Optional[float] = None,
        pool_min_replicas: Optional[int] = None,
        replica_budget: Optional[int] = None,
        host_id: Optional[str] = None,
        artifact_cache=None,
    ):
        from bdlz_tpu_torch.provenance import resolve_store
        from bdlz_tpu_torch.serve.rollout import looks_like_content_hash
        from bdlz_tpu_torch.utils.retry import resolve_engine_retry

        self.base = base
        self.field = field
        self.max_batch_size = int(max_batch_size)
        self.routing = routing
        self.queue_bound = None if queue_bound is None else int(queue_bound)
        self.max_wait_s = float(max_wait_s)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self._clock = clock
        self._devices = resolve_devices(devices)
        self._retry = retry
        self._warm = bool(warm)
        self._error_gate_tol = error_gate_tol
        self._health = health
        self._lz_profile = lz_profile
        self._bounce = bounce
        self._store = resolve_store(store, base=base, label="tenancy")
        if self._store is None:
            raise TenancyError(
                "multi-tenant serving needs a resolvable provenance store "
                "(cold admission fetches artifacts by content hash); pass "
                "store= or set cache_root/BDLZ_CACHE_ROOT"
            )
        self._faults = FaultPlan.resolve(fault_plan, base)
        #: The shared registry retry policy (cold admission + readmit
        #: fetches run under it — bounded deterministic backoff).
        self.registry_retry = resolve_engine_retry(retry, base)
        #: The cross-host fabric's host identity (None = single-host
        #: plane): stamped on every pool fleet's rows/responses and on
        #: degraded answers, so cross-host traces are attributable.
        self.host_id = host_id
        #: Optional local pull-through :class:`ArtifactCache`
        #: (provenance/registry.py): cold admission and readmit fetch
        #: THROUGH it, so whole-host failover re-admits a dead host's
        #: tenants from a validated local copy when one exists —
        #: fetch-by-hash, never a rebuild.  None = direct store fetch.
        self.artifact_cache = artifact_cache

        # ---- tenant map + routing policy ----------------------------
        self._tenant_map: Dict[str, str] = {}
        if tenant_map:
            for scenario, content_hash in dict(tenant_map).items():
                if not scenario or not isinstance(scenario, str):
                    raise TenancyError(
                        f"tenant-map scenario label {scenario!r} must be a "
                        "non-empty string"
                    )
                if not looks_like_content_hash(str(content_hash)):
                    raise TenancyError(
                        f"tenant-map entry {scenario!r} -> "
                        f"{content_hash!r} is not a 16-hex artifact "
                        "content hash"
                    )
                self._tenant_map[scenario] = str(content_hash)
        #: hash -> scenario label (first label wins on aliases).
        self._scenario_of: Dict[str, str] = {}
        for scenario, content_hash in self._tenant_map.items():
            self._scenario_of.setdefault(content_hash, scenario)
        if tenant_routing is None:
            tenant_routing = getattr(base, "tenant_routing", None)
        if tenant_routing is None:
            tenant_routing = "scenario" if self._tenant_map else "hash"
        if tenant_routing not in VALID_TENANT_ROUTING:
            raise TenancyError(
                f"tenant_routing={tenant_routing!r} is not one of "
                f"{VALID_TENANT_ROUTING}"
            )
        if tenant_routing == "scenario" and not self._tenant_map:
            raise TenancyError(
                "tenant_routing='scenario' needs a tenant map (scenario "
                "label -> artifact content hash)"
            )
        self.tenant_routing = tenant_routing
        self._fault_pools = (
            None if fault_scenarios is None else set(fault_scenarios)
        )

        # ---- budgets -------------------------------------------------
        if memory_budget_bytes is None:
            memory_budget_bytes = getattr(base, "memory_budget_bytes", None)
        if memory_budget_bytes is not None and memory_budget_bytes < 1:
            raise TenancyError("memory_budget_bytes must be >= 1 or None")
        self.memory_budget_bytes = (
            None if memory_budget_bytes is None else int(memory_budget_bytes)
        )
        if autoscale_interval_s is None:
            autoscale_interval_s = getattr(base, "autoscale_interval_s", 5.0)
        if not autoscale_interval_s > 0.0:
            raise TenancyError("autoscale_interval_s must be > 0")
        self.autoscale_interval_s = float(autoscale_interval_s)
        if pool_min_replicas is None:
            pool_min_replicas = getattr(base, "pool_min_replicas", 1)
        if pool_min_replicas < 1:
            raise TenancyError("pool_min_replicas must be >= 1")
        self.pool_min_replicas = int(pool_min_replicas)
        if replica_budget is not None and replica_budget < self.pool_min_replicas:
            raise TenancyError(
                f"replica_budget ({replica_budget}) cannot fit even one "
                f"pool at pool_min_replicas ({self.pool_min_replicas})"
            )
        self.replica_budget = (
            None if replica_budget is None else int(replica_budget)
        )
        n0 = self.pool_min_replicas if n_replicas is None else int(n_replicas)
        if n0 < self.pool_min_replicas:
            raise TenancyError(
                f"n_replicas ({n0}) is below pool_min_replicas "
                f"({self.pool_min_replicas})"
            )
        self._initial_replicas = n0

        # ---- state ---------------------------------------------------
        self._pools: Dict[str, PoolState] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._last_autoscale = self._clock()
        self.evictions = 0
        self.forced_evictions = 0
        self.admissions = 0
        self.readmissions = 0
        self.autoscale_passes = 0
        self.autoscale_skipped = 0
        self.resizes = 0
        #: One record per (re)admission: hash, scenario, wall-clock
        #: seconds (fetch + build + warm + probe), readmit flag.
        self.admission_events: List[Dict] = []

    # ---- introspection ----------------------------------------------

    @property
    def pools(self) -> Dict[str, PoolState]:
        """Live view of the pool table (artifact hash -> PoolState)."""
        return self._pools

    def pool(self, key: str) -> PoolState:
        """The pool for a scenario label or artifact hash (KeyError if
        neither names an admitted pool)."""
        content_hash = self._tenant_map.get(key, key)
        return self._pools[content_hash]

    def scenario_for(self, content_hash: str) -> Optional[str]:
        """The tenant map's scenario label for an artifact hash (first
        label wins on aliases; None when unmapped) — the serve CLI's
        answer/error-record annotation hook."""
        return self._scenario_of.get(str(content_hash))

    def total_replicas(self) -> int:
        return sum(p.n_replicas for p in self._pools.values())

    def resident_bytes(self) -> int:
        return sum(p.resident_bytes for p in self._pools.values())

    # ---- routing -----------------------------------------------------

    def _route(
        self, scenario: Optional[str], artifact_hash: Optional[str]
    ) -> Tuple[str, Optional[str]]:
        """Resolve a request's (scenario tag, hash tag) to the pool's
        content hash + scenario label, enforcing the routing policy and
        tag agreement.  Pure; raises :class:`TenancyError`."""
        if scenario is not None:
            if not self._tenant_map:
                raise TenancyError(
                    f"request names scenario {scenario!r} but this service "
                    "has no tenant map"
                )
            mapped = self._tenant_map.get(scenario)
            if mapped is None:
                raise TenancyError(
                    f"unknown scenario {scenario!r}; the tenant map serves "
                    f"{sorted(self._tenant_map)}"
                )
            if artifact_hash is not None and str(artifact_hash) != mapped:
                raise TenancyError(
                    f"request names scenario {scenario!r} (-> {mapped}) AND "
                    f"artifact {artifact_hash!r}: conflicting routing tags"
                )
            return mapped, scenario
        if self.tenant_routing == "scenario":
            raise TenancyError(
                "tenant_routing='scenario': every request must carry a "
                "scenario tag (the tenant map is the routing table)"
            )
        if artifact_hash is None:
            raise TenancyError(
                "tenant_routing='hash': every request must carry an "
                "artifact content hash (or a scenario tag through the "
                "tenant map)"
            )
        content_hash = str(artifact_hash)
        return content_hash, self._scenario_of.get(content_hash)

    def _check_skew(
        self, pool: PoolState, scenario: Optional[str], lz_mode: Optional[str]
    ) -> None:
        """Cross-scenario skew is refused LOUDLY: a stated mode (or a
        scenario label that IS a mode name) must match the pool's."""
        if (
            scenario in VALID_LZ_MODES
            and pool.lz_mode is not None
            and scenario != pool.lz_mode
        ):
            raise TenancyError(
                f"scenario label {scenario!r} names an LZ mode but its "
                f"pool {pool.artifact_hash} serves "
                f"lz_mode={pool.lz_mode!r} — cross-scenario tenant-map "
                "skew"
            )
        if lz_mode is not None and str(lz_mode) != pool.lz_mode:
            raise TenancyError(
                f"request states lz_mode={str(lz_mode)!r} but pool "
                f"{pool.artifact_hash} serves lz_mode={pool.lz_mode!r} "
                "— cross-scenario artifact/request skew"
            )

    def _theta_for_pool(self, pool: PoolState, theta):
        """Mapping requests resolve against the pool's own axis order
        (with the shared ``lz_mode``-statement skew check); vectors pass
        through (the fleet re-validates shape)."""
        if isinstance(theta, Mapping):
            if pool.fleet is not None:
                return theta_from_mapping(pool.fleet.artifact, theta)
            point = dict(theta)
            stated = point.pop("lz_mode", None)
            if stated is not None and str(stated) != pool.lz_mode:
                raise TenancyError(
                    f"request states lz_mode={str(stated)!r} but pool "
                    f"{pool.artifact_hash} serves "
                    f"lz_mode={pool.lz_mode!r} — cross-scenario "
                    "artifact/request skew"
                )
            missing = [n for n in pool.axis_names if n not in point]
            if missing:
                raise TenancyError(f"query is missing axes {missing}")
            unknown = sorted(set(point) - set(pool.axis_names))
            if unknown:
                raise TenancyError(
                    f"query has unknown axes {unknown}; pool "
                    f"{pool.artifact_hash} takes {list(pool.axis_names)}"
                )
            return np.asarray([float(point[n]) for n in pool.axis_names])
        return np.asarray(theta, dtype=np.float64).reshape(-1)

    # ---- request plane ----------------------------------------------

    def submit(
        self,
        theta,
        scenario: Optional[str] = None,
        artifact_hash: Optional[str] = None,
        lz_mode: Optional[str] = None,
    ) -> Future:
        """Enqueue one query on its pool; resolves to a
        :class:`FleetResponse`.  ``theta`` is a (d,) vector or an
        {axis: value} mapping (which may state ``"lz_mode"``).  Raises
        :class:`TenancyError` on routing/skew refusal, ``QueueFull`` at
        the pool's own admission bound (neighbors unaffected), and
        :class:`ServiceUnavailable` after :meth:`close`."""
        with self._lock:
            if self._closed:
                raise ServiceUnavailable(
                    "multi-tenant service is closed; resubmit to a live one"
                )
        content_hash, scenario = self._route(scenario, artifact_hash)
        pool = self._pools.get(content_hash)
        if pool is None:
            pool = self._admit(content_hash, scenario)
        self._check_skew(pool, scenario, lz_mode)
        theta = self._theta_for_pool(pool, theta)
        pool.last_used = self._clock()
        if pool.evicted:
            if (
                self.queue_bound is not None
                and len(pool._degraded) >= self.queue_bound
            ):
                pool.stats.record_admission_rejects(1)
                raise QueueFull(
                    f"evicted pool {content_hash} at its admission bound "
                    f"({self.queue_bound} degraded requests waiting); "
                    "readmit() it or retry later"
                )
            fut: Future = Future()
            pool._degraded.append(
                _DegradedPending(theta, self._clock(), fut)
            )
            pool.stats.record_accepted(1)
            return fut
        return pool.fleet.submit(theta)

    # ---- cold admission ---------------------------------------------

    def _pool_fault_plan(self, scenario: Optional[str], content_hash: str):
        """The fault plan a pool's fleet is armed with: the shared plan,
        unless ``fault_scenarios`` restricts it to other pools."""
        if self._faults is None:
            return None
        if self._fault_pools is None:
            return self._faults
        if scenario in self._fault_pools or content_hash in self._fault_pools:
            return self._faults
        return None

    def _admit(
        self, content_hash: str, scenario: Optional[str]
    ) -> PoolState:
        """Fetch + validate + build + warm + probe one pool (cold
        admission and :meth:`readmit` share this path).  The fetch runs
        under the shared registry retry policy; the probe dispatches a
        full bucket at the domain hull's lower corner and refuses
        non-finite answers — a pool never joins rotation unproven."""
        from bdlz_tpu_torch.provenance import fetch_artifact_with_retry

        t0 = time.monotonic()
        if self.artifact_cache is not None:
            artifact = self.artifact_cache.fetch(
                self._store, content_hash, fault_plan=self._faults,
                retry=self.registry_retry,
            )
        else:
            artifact = fetch_artifact_with_retry(
                self._store, content_hash, fault_plan=self._faults,
                retry=self.registry_retry,
            )
        mode = artifact_lz_mode(artifact)
        if scenario in VALID_LZ_MODES and scenario != mode:
            raise TenancyError(
                f"scenario label {scenario!r} names an LZ mode but artifact "
                f"{content_hash} serves lz_mode={mode!r} — cross-scenario "
                "tenant-map skew"
            )
        prior = self._pools.get(content_hash)
        n0 = prior.n_replicas or self._initial_replicas if prior else (
            self._initial_replicas
        )
        n0 = max(n0, self.pool_min_replicas)
        self._make_replica_headroom(n0, keep=prior)
        base_p = pool_base(self.base, artifact)
        # a chain/thermal pool REQUIRES the (one) shared bounce profile
        # (fingerprint-checked against its artifact by the fleet); a
        # two-channel pool must not receive one — the fleet rejects it
        profile = self._lz_profile if mode != "two_channel" else None
        # --bounce pools derive the shared profile in-framework; the
        # fleet checks the potential fingerprint against each artifact
        bounce = self._bounce if mode != "two_channel" else None
        pool = prior if prior is not None else PoolState(
            scenario, content_hash
        )
        fleet = FleetService(
            artifact, base_p, field=self.field,
            max_batch_size=self.max_batch_size, n_replicas=n0,
            devices=self._devices, routing=self.routing,
            queue_bound=self.queue_bound, max_wait_s=self.max_wait_s,
            deadline_s=self.deadline_s, clock=self._clock,
            retry=self._retry,
            fault_plan=self._pool_fault_plan(pool.scenario, content_hash),
            stats=pool.stats, warm=self._warm,
            error_gate_tol=self._error_gate_tol, health=self._health,
            store=self._store, lz_profile=profile, bounce=bounce,
            host_id=self.host_id,
        )
        if self._warm:
            # a full bucket at the hull's lower corner, gathered and
            # checked before rotation
            lower, _hi = artifact_hull(artifact)
            probe = np.tile(lower, (self.max_batch_size, 1))
            handle = fleet.replica_set.dispatch(probe, target=0)
            values, inside, _err = handle.gather()
            if not (
                np.isfinite(values).all() and bool(np.asarray(inside).all())
            ):
                fleet.close()
                raise TenancyError(
                    f"cold-admission health probe failed for {content_hash}: "
                    "non-finite (or out-of-domain) answers at the hull "
                    "corner; the pool never joined rotation"
                )
        pool.fleet = fleet
        pool.lz_mode = mode
        pool.axis_names = tuple(artifact.axis_names)
        pool.fallback = fleet._fallback
        pool.bytes_per_replica = pool_bytes_per_replica(
            artifact, field=self.field,
            error_gate=fleet.replica_set.error_gate,
        )
        pool.evicted = False
        pool.last_used = self._clock()
        seconds = time.monotonic() - t0
        pool.admission_seconds.append(seconds)
        with self._lock:
            self._pools[content_hash] = pool
            if prior is not None:
                self.readmissions += 1
            else:
                self.admissions += 1
            self.admission_events.append({
                "artifact_hash": content_hash,
                "scenario": pool.scenario,
                "lz_mode": mode,
                "seconds": seconds,
                "readmit": prior is not None,
            })
        if self.artifact_cache is not None:
            # host-wide pull-through counters, snapshotted at this
            # pool's (re)admission — the extras seam keeps the summary
            # schema byte-identical whenever no cache is armed
            pool.stats.extras["artifact_cache"] = (
                self.artifact_cache.counters()
            )
        self._enforce_memory_budget(keep=pool)
        return pool

    def _make_replica_headroom(
        self, needed: int, keep: Optional[PoolState]
    ) -> None:
        """Shrink provably idle donors until ``needed`` more replicas
        fit under the fleet-wide ceiling; refuse typed if they cannot."""
        if self.replica_budget is None:
            return
        while self.total_replicas() + needed > self.replica_budget:
            donors = [
                p for p in self._pools.values()
                if p is not keep and p.fleet is not None and p.idle()
                and p.n_replicas > self.pool_min_replicas
            ]
            if not donors:
                raise TenancyError(
                    f"replica budget exhausted: {self.total_replicas()} "
                    f"replicas live, {needed} more needed, ceiling "
                    f"{self.replica_budget}, and no idle pool can donate"
                )
            donor = min(donors, key=lambda p: p.last_used)
            donor.fleet.resize(donor.n_replicas - 1)
            self.resizes += 1

    def readmit(self, key: str) -> PoolState:
        """Bring an evicted pool back into rotation: flush its degraded
        queue (those requests were accepted under eviction and are
        answered by the exact path), then re-fetch, re-warm and
        re-probe through the cold-admission path.  The pool's stats —
        and therefore its answer history — are continuous across the
        cycle; pre/post-eviction answers are bit-identical (pinned)."""
        pool = self.pool(key)
        if not pool.evicted:
            return pool
        while pool._degraded:
            self._serve_degraded(pool, force=True)
        return self._admit(pool.artifact_hash, pool.scenario)

    # ---- eviction ----------------------------------------------------

    def _enforce_memory_budget(
        self, keep: Optional[PoolState] = None
    ) -> int:
        """LRU-evict idle pools while the resident-byte estimate
        exceeds the budget (or a ``pool_evict`` fault — keyed by the
        eviction counter — forces the next candidate out regardless).
        The just-touched pool (``keep``) is never the victim.  Returns
        pools evicted."""
        forced = False
        if self._faults is not None:
            try:
                self._faults.fire("pool_evict", self.evictions)
            except FaultError:
                forced = True
        evicted = 0
        while True:
            over = (
                self.memory_budget_bytes is not None
                and self.resident_bytes() > self.memory_budget_bytes
            )
            if not (over or forced):
                break
            candidates = [
                p for p in self._pools.values()
                if p is not keep and p.fleet is not None and p.idle()
            ]
            if not candidates:
                break  # nothing safely evictable; try again next tick
            victim = min(candidates, key=lambda p: p.last_used)
            self._evict(victim, forced=forced)
            evicted += 1
            forced = False
        return evicted

    def _evict(self, pool: PoolState, forced: bool = False) -> None:
        """Release an idle pool's device tables: close its fleet and
        flip it to degraded-exact answering (reason ``"pool_evicted"``)
        until :meth:`readmit`.  The per-pool stats object and the
        retained exact kit survive — eviction changes WHO answers,
        never the answer's bits."""
        fleet, pool.fleet = pool.fleet, None
        if fleet is not None:
            fleet.close()  # idle by precondition: zero futures failed
        pool.evicted = True
        self.evictions += 1
        if forced:
            self.forced_evictions += 1

    def _serve_degraded(self, pool: PoolState, force: bool = False) -> int:
        """Answer one micro-batch of an evicted pool's queue through its
        retained exact fallback (the fleet's degraded template: replica
        ``-1``, ``degraded=True``, reason ``"pool_evicted"``; a dead
        exact path raises typed ``ServiceUnavailable`` per request).
        Applies the same dispatch policy (full batch / oldest-age /
        deadline shedding) as a live pool.  Returns requests consumed."""
        q = pool._degraded
        if not q:
            return 0
        now = self._clock()
        ready = (
            force
            or len(q) >= self.max_batch_size
            or (now - q[0].enqueued_at) >= self.max_wait_s
        )
        if not ready:
            return 0
        expired: List[_DegradedPending] = []
        if self.deadline_s is not None:
            while q and (now - q[0].enqueued_at > self.deadline_s):
                expired.append(q.popleft())
        for p in expired:
            age = now - p.enqueued_at
            p.future.set_exception(DeadlineExceeded(
                f"request aged {age:.6f}s past the "
                f"{self.deadline_s:.6f}s service deadline before dispatch"
            ))
        if expired:
            pool.stats.record_deadline_kills(len(expired))
        batch = [
            q.popleft()
            for _ in range(min(len(q), self.max_batch_size))
        ]
        if not batch:
            return len(expired)
        b = len(batch)
        wait_s = max(now - p.enqueued_at for p in batch)
        thetas = np.stack([
            np.asarray(p.theta, dtype=np.float64) for p in batch
        ])
        padded = _pad_rows(thetas, self.max_batch_size)
        axes = {
            name: padded[:, k] for k, name in enumerate(pool.axis_names)
        }
        retries_box = [0]
        err: Optional[BaseException] = None
        values = np.full(b, np.nan)
        try:
            exact_fields = pool.fallback(axes, retries_box)
            values = np.asarray(
                exact_fields[self.field][:b], dtype=np.float64
            )
        except Exception as exc:  # noqa: BLE001 — typed per-request below
            err = exc
        done = self._clock()
        pool.stats.record_batch(
            batch_index=pool._batch_index,
            size=b,
            occupancy=b / self.max_batch_size,
            wait_s=float(wait_s),
            n_fallback=b,
            seconds=float(done - now),
            n_retries=retries_box[0],
            n_error=b if err is not None else 0,
            n_gated=0,
            artifact_hash=pool.artifact_hash,
            replica=-1,
            lz_mode=pool.lz_mode,
            host_id=self.host_id,
        )
        pool.stats.record_queries(thetas, REASON_POOL_EVICTED)
        pool._batch_index += 1
        for p, v in zip(batch, values):
            pool.stats.record_latency(done - p.enqueued_at)
            if err is not None:
                unavailable = ServiceUnavailable(
                    f"pool {pool.artifact_hash} is evicted and its "
                    f"degraded exact path failed: "
                    f"{type(err).__name__}: {err}"
                )
                unavailable.__cause__ = err
                p.future.set_exception(unavailable)
            else:
                p.future.set_result(FleetResponse(
                    value=float(v),
                    artifact_hash=pool.artifact_hash,
                    replica=-1,
                    fallback_reason=REASON_POOL_EVICTED,
                    degraded=True,
                    lz_mode=pool.lz_mode,
                    host_id=self.host_id,
                ))
        return b + len(expired)

    # ---- autoscaler --------------------------------------------------

    def _maybe_autoscale(self) -> None:
        """One rebalance pass if the interval elapsed on the service
        clock.  An ``autoscale`` fault (keyed by the pass counter)
        skips the pass — pools keep their current replica counts."""
        now = self._clock()
        if now - self._last_autoscale < self.autoscale_interval_s:
            return
        self._last_autoscale = now
        key = self.autoscale_passes
        self.autoscale_passes += 1
        if self._faults is not None:
            try:
                self._faults.fire("autoscale", key)
            except FaultError:
                self.autoscale_skipped += 1
                return
        live = [p for p in self._pools.values() if p.fleet is not None]
        for pool in live:
            rows = pool.stats.rows[pool._row_seen:]
            pool._row_seen = len(pool.stats.rows)
            occ = (
                float(np.mean([
                    getattr(r, "occupancy", 0.0) for r in rows
                ])) if rows else 0.0
            )
            if rows and occ >= OCC_HIGH:
                pool._up += 1
                pool._down = 0
            elif not rows or occ <= OCC_LOW:
                pool._down += 1
                pool._up = 0
            else:
                pool._up = 0
                pool._down = 0
        for pool in live:
            if pool._up >= UP_PASSES:
                self._grow(pool)
            elif (
                pool._down >= DOWN_PASSES
                and pool.n_replicas > self.pool_min_replicas
            ):
                if pool.fleet.in_flight():
                    continue  # defer; the streak survives to next pass
                pool.fleet.resize(pool.n_replicas - 1)
                pool._down = 0
                self.resizes += 1

    def _grow(self, pool: PoolState) -> None:
        """Grow one replica within the fleet ceiling, stealing from a
        provably idle sustained-cold donor at the ceiling.  Defers
        (streak intact) while the pool has batches in flight or no
        donor exists."""
        if pool.fleet.in_flight():
            return
        if (
            self.replica_budget is not None
            and self.total_replicas() + 1 > self.replica_budget
        ):
            donors = [
                p for p in self._pools.values()
                if p is not pool and p.fleet is not None and p.idle()
                and p._down >= DOWN_PASSES
                and p.n_replicas > self.pool_min_replicas
            ]
            if not donors:
                return  # ceiling reached, nobody to shrink: defer
            donor = min(donors, key=lambda p: p.last_used)
            donor.fleet.resize(donor.n_replicas - 1)
            donor._down = 0
            self.resizes += 1
        pool.fleet.resize(pool.n_replicas + 1)
        pool._up = 0
        self.resizes += 1

    # ---- dispatch/resolve plumbing ----------------------------------

    def run_once(self, force: bool = False) -> int:
        """One service tick: every live pool's dispatch policy, every
        evicted pool's degraded queue, then the memory budget and (when
        due) an autoscale pass.  Returns requests consumed."""
        consumed = 0
        for pool in list(self._pools.values()):
            if pool.fleet is not None:
                consumed += pool.fleet.run_once(force)
            if pool._degraded:
                consumed += self._serve_degraded(pool, force=force)
        self._enforce_memory_budget()
        self._maybe_autoscale()
        return consumed

    def poll(self, block: bool = False) -> int:
        """Resolve completed batches across every live pool."""
        resolved = 0
        for pool in list(self._pools.values()):
            if pool.fleet is not None:
                resolved += pool.fleet.poll(block)
        return resolved

    def drain(self) -> int:
        """Dispatch and resolve EVERYTHING queued on every pool (the
        finish path — no request dropped, degraded queues included)."""
        resolved = 0
        for pool in list(self._pools.values()):
            if pool.fleet is not None:
                resolved += pool.fleet.drain()
            while pool._degraded:
                resolved += self._serve_degraded(pool, force=True)
        return resolved

    def close(self) -> int:
        """Shut every pool down: pending, in-flight AND degraded-queued
        futures all fail with typed :class:`ServiceUnavailable` — a
        closed multi-tenant service never parks a caller (the fleet
        close contract, per pool).  Idempotent; returns futures
        failed."""
        with self._lock:
            if self._closed:
                return 0
            self._closed = True
        n = 0
        for pool in self._pools.values():
            if pool.fleet is not None:
                n += pool.fleet.close()
            while pool._degraded:
                p = pool._degraded.popleft()
                p.future.set_exception(ServiceUnavailable(
                    "multi-tenant service closed before the request was "
                    "dispatched; resubmit to a live service"
                ))
                n += 1
        return n

    # ---- telemetry ---------------------------------------------------

    def summary(self) -> Dict:
        """Per-pool ServeStats summaries (keyed by artifact hash, each
        annotated with scenario/mode/shape/eviction state) plus the
        service-level admission/eviction/autoscale counters."""
        pools = {}
        for content_hash, p in self._pools.items():
            s = p.stats.summary()
            s.update({
                "scenario": p.scenario,
                "lz_mode": p.lz_mode,
                "artifact_hash": content_hash,
                "n_replicas": p.n_replicas,
                "evicted": p.evicted,
                "resident_bytes": p.resident_bytes,
                "admission_seconds": list(p.admission_seconds),
            })
            pools[content_hash] = s
        out = {
            "pools": pools,
            "tenant_routing": self.tenant_routing,
            "total_replicas": self.total_replicas(),
            "replica_budget": self.replica_budget,
            "resident_bytes": self.resident_bytes(),
            "memory_budget_bytes": self.memory_budget_bytes,
            "admissions": self.admissions,
            "readmissions": self.readmissions,
            "evictions": self.evictions,
            "forced_evictions": self.forced_evictions,
            "autoscale_passes": self.autoscale_passes,
            "autoscale_skipped": self.autoscale_skipped,
            "resizes": self.resizes,
        }
        # fabric extensions — absent entirely when nothing armed them
        # (the extras schema pin, service level)
        if self.host_id is not None:
            out["host_id"] = self.host_id
        if self.artifact_cache is not None:
            out["artifact_cache"] = self.artifact_cache.counters()
        return out


__all__ = [
    "MultiTenantService",
    "PoolState",
    "TenancyError",
    "REASON_POOL_EVICTED",
    "pool_base",
    "pool_bytes_per_replica",
]
