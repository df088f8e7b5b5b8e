"""Deterministic fault injection for the sweep, the emulator build and
the serving plane.

Counterpart of ``bdlz_tpu/faults.py``: the same plan format, sites,
kinds, rejections and decisions, so one plan (from the config, the
``BDLZ_FAULT_PLAN`` environment variable or an argument) injects the
same faults into either package.  A :class:`FaultPlan` is a list of
:class:`FaultSpec` keyed on ``(site, index)``; every decision is a pure
function of the plan and a per-spec fire counter.

The sites this package acts on:

``step``
    The sweep's per-chunk dispatch.  ``key`` = chunk index for kinds
    ``raise`` (persistent) and ``transient`` (fails ``times`` attempts,
    then recovers); ``point`` = global flat grid index for ``poison``
    (the dispatch raises whenever its range holds the point — what the
    bisect isolates) and ``nan`` (the point's outputs become NaN after a
    successful step).
``chunk_write``
    The chunk ``.npz`` of a sweep directory; kind ``torn`` truncates the
    file after its atomic write, which resume must detect.
``probe``
    The emulator's exact evaluator; ``key`` = its chunk-call counter.
``store_read``
    The provenance store's reads (``Store.arm_faults``); kinds ``torn``
    and ``corrupt`` damage the entry just before it is loaded.
``serve_exact``
    The serving plane's exact fallback; ``key`` = its logical call
    counter (retries share it).
``replica_dispatch``
    A fleet replica's dispatch; ``key`` = replica index.  ``raise`` /
    ``transient`` fail the launch, key-addressed ``nan`` poisons the
    gathered values, ``slow`` adds its delay to the batch's seconds.
``registry_fetch``
    The artifact registry's fetch; ``key`` = the store's fetch counter;
    ``torn`` / ``corrupt`` damage the entry before it is loaded.
``clock``
    The micro-batchers' dispatch clock; ``key`` = batch index; ``slow``
    ages the queue through the clock, never by sleeping.

The other sites (``lease``, ``worker_crash``, ``pool_evict``,
``autoscale``, ``host_crash``, ``heartbeat_loss``, ``store_partition``)
parse and validate here and belong to tenancy and the elastic sweep
(ROADMAP D7b).

Resolution is the tri-state pattern: ``Config.fault_injection`` None
enables injection iff a plan is configured, False forces it off, True
requires a plan.  The default is off, and every hook is guarded on the
plan being present.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, NamedTuple, Optional

VALID_SITES = (
    "step", "chunk_write", "probe", "serve_exact", "clock",
    "replica_dispatch", "registry_fetch", "store_read", "lease",
    "worker_crash", "pool_evict", "autoscale", "host_crash",
    "heartbeat_loss", "store_partition",
)
VALID_KINDS = ("raise", "transient", "poison", "nan", "torn", "slow", "corrupt")

#: Environment variable a plan is read from when neither the caller nor
#: the config carries one (JSON text, or a path to a JSON file).
FAULT_PLAN_ENV = "BDLZ_FAULT_PLAN"


class FaultError(RuntimeError):
    """An injected (non-transient) infrastructure fault."""


class TransientFaultError(FaultError):
    """An injected fault that recovers after its ``times`` budget."""


class FaultPlanError(ValueError):
    """A malformed fault plan (unknown site or kind, missing keys)."""


class FaultSpec(NamedTuple):
    """One injected fault: where it fires, how, and how often."""

    site: str
    kind: str
    key: Optional[int] = None     # chunk or call index; None = every index
    point: Optional[int] = None   # global point index (poison, nan)
    times: Optional[int] = None   # transient budget; None = persistent
    delay_s: float = 0.0          # kind "slow"


def _spec_from_obj(obj: Dict[str, Any]) -> FaultSpec:
    site = obj.get("site")
    kind = obj.get("kind")
    if site not in VALID_SITES:
        raise FaultPlanError(f"fault site {site!r} is not one of {VALID_SITES}")
    if kind not in VALID_KINDS:
        raise FaultPlanError(f"fault kind {kind!r} is not one of {VALID_KINDS}")
    if kind == "poison" and obj.get("point") is None:
        raise FaultPlanError("kind 'poison' needs a 'point' (global index)")
    if kind == "nan" and obj.get("point") is None and site != "replica_dispatch":
        raise FaultPlanError(
            "kind 'nan' needs a 'point' (global index) outside "
            "site 'replica_dispatch'"
        )
    if kind == "transient" and obj.get("times") is None:
        raise FaultPlanError("kind 'transient' needs 'times' (fail budget)")
    known = {"site", "kind", "key", "point", "times", "delay_s", "chunk", "call"}
    unknown = sorted(set(obj) - known)
    if unknown:
        raise FaultPlanError(f"unknown fault-spec key(s) {unknown}")
    key = obj.get("key", obj.get("chunk", obj.get("call")))
    return FaultSpec(
        site=site,
        kind=kind,
        key=None if key is None else int(key),
        point=None if obj.get("point") is None else int(obj["point"]),
        times=None if obj.get("times") is None else int(obj["times"]),
        delay_s=float(obj.get("delay_s", 0.0)),
    )


class FaultPlan:
    """A deterministic set of injected faults (see the module docstring)."""

    def __init__(self, specs: List[FaultSpec]):
        self.specs = list(specs)
        # per-spec fire counters, the only mutable state
        self._fired = [0] * len(self.specs)

    @classmethod
    def from_obj(cls, obj: Any) -> "FaultPlan":
        if isinstance(obj, dict):
            obj = obj.get("faults", [])
        if not isinstance(obj, list):
            raise FaultPlanError(
                "fault plan must be a list of specs or {'faults': [...]}"
            )
        return cls([_spec_from_obj(dict(s)) for s in obj])

    @classmethod
    def from_json(cls, text_or_path: str) -> "FaultPlan":
        """Parse a plan from JSON text, or from a path to a JSON file."""
        text = text_or_path
        if not text_or_path.lstrip().startswith(("{", "[")):
            with open(text_or_path, "r", encoding="utf-8") as f:
                text = f.read()
        try:
            return cls.from_obj(json.loads(text))
        except json.JSONDecodeError as exc:
            raise FaultPlanError(f"fault plan is not valid JSON: {exc}") from exc

    @classmethod
    def resolve(cls, explicit=None, base=None) -> "Optional[FaultPlan]":
        """Explicit ▸ config ▸ environment; None when injection is off.
        ``explicit`` is a FaultPlan, JSON text or a path; ``base`` (a
        Config) gives ``fault_injection`` and ``fault_plan``."""
        gate = None if base is None else getattr(base, "fault_injection", None)
        if gate is False:
            return None
        plan = explicit
        if plan is None and base is not None:
            plan = getattr(base, "fault_plan", None)
        if plan is None:
            plan = os.environ.get(FAULT_PLAN_ENV) or None
        if isinstance(plan, str):
            plan = cls.from_json(plan)
        if gate is True and plan is None:
            raise FaultPlanError(
                "fault_injection=true but no fault plan is configured "
                f"(set fault_plan or {FAULT_PLAN_ENV})"
            )
        return plan

    def _matches(self, spec: FaultSpec, site: str, key: int) -> bool:
        return spec.site == site and (spec.key is None or spec.key == int(key))

    def fire(self, site: str, key: int) -> None:
        """Raise if a ``raise``/``transient`` spec matches (site, key)."""
        for i, spec in enumerate(self.specs):
            if spec.kind not in ("raise", "transient"):
                continue
            if not self._matches(spec, site, key):
                continue
            if spec.kind == "transient":
                if self._fired[i] >= int(spec.times):
                    continue  # budget spent: recovered
                self._fired[i] += 1
                raise TransientFaultError(
                    f"injected transient fault at {site}[{key}] "
                    f"({self._fired[i]}/{spec.times})"
                )
            raise FaultError(f"injected fault at {site}[{key}]")

    def check_range(self, site: str, lo: int, hi: int) -> None:
        """Raise if a ``poison`` point lies inside [lo, hi)."""
        for spec in self.specs:
            if spec.site == site and spec.kind == "poison":
                p = int(spec.point)
                if lo <= p < hi:
                    raise FaultError(f"injected poison point {p} in {site}[{lo}:{hi}]")

    def nan_batch(self, site: str, key: int) -> bool:
        """True when a key-addressed ``nan`` spec fires at (site, key),
        budgeted by ``times`` like a transient."""
        for i, spec in enumerate(self.specs):
            if spec.kind != "nan" or spec.point is not None:
                continue
            if not self._matches(spec, site, key):
                continue
            if spec.times is not None and self._fired[i] >= int(spec.times):
                continue
            self._fired[i] += 1
            return True
        return False

    def corrupt_bytes(self, site: str, key: int, path: str) -> bool:
        """Flip one byte in the middle of ``path`` if a ``corrupt`` spec
        matches; fires once per spec."""
        for i, spec in enumerate(self.specs):
            if spec.kind != "corrupt" or not self._matches(spec, site, key):
                continue
            if self._fired[i]:
                continue
            self._fired[i] += 1
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.seek(size // 2)
                byte = f.read(1)
                f.seek(size // 2)
                f.write(bytes([byte[0] ^ 0xFF]) if byte else b"\xff")
            return True
        return False

    def nan_points(self, site: str, lo: int, hi: int) -> List[int]:
        """Global indices in [lo, hi) whose outputs become NaN."""
        return sorted(
            int(spec.point)
            for spec in self.specs
            if spec.site == site and spec.kind == "nan"
            and lo <= int(spec.point) < hi
        )

    def corrupt_file(self, site: str, key: int, path: str) -> bool:
        """Truncate ``path`` to half if a ``torn`` spec matches; fires once
        per spec (a rewritten file is left whole, so resume can heal it)."""
        for i, spec in enumerate(self.specs):
            if spec.kind != "torn" or not self._matches(spec, site, key):
                continue
            if self._fired[i]:
                continue
            self._fired[i] += 1
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(max(size // 2, 1))
            return True
        return False

    def delay_s(self, site: str, key: int) -> float:
        """Seconds the ``slow`` specs add at (site, key), for a call site's
        injectable clock."""
        total = 0.0
        for spec in self.specs:
            if spec.kind == "slow" and self._matches(spec, site, key):
                total += float(spec.delay_s)
        return total

    def describe(self) -> List[Dict[str, Any]]:
        """The plan as plain dicts (event logs and identities)."""
        out = []
        for spec in self.specs:
            d: Dict[str, Any] = {"site": spec.site, "kind": spec.kind}
            for k in ("key", "point", "times"):
                if getattr(spec, k) is not None:
                    d[k] = getattr(spec, k)
            if spec.delay_s:
                d["delay_s"] = spec.delay_s
            out.append(d)
        return out
