"""The parameter-sweep engine, on one CUDA device or over a device mesh.

Counterpart of ``bdlz_tpu/parallel/sweep.py``: flatten the sweep axes
into a grid of points, then evaluate it chunk by chunk — each chunk
padded to one fixed size by repeating its last point, moved to the
device, run through the batched pipeline, and its valid rows brought
back.  Failed points (non-finite outputs) are masked and counted, never
fatal.  With a ``mesh`` (``parallel/mesh.py``) the chunk is padded to a
multiple of its members, each process takes its rows, each member its
share on its own device and CUDA stream, and the rows are gathered.

Engines (``impl``):

* ``"kernel"`` — the hand-written CUDA interpolate-and-reduce kernels
  (``ops/kjma_kernel.py``), the counterpart of the JAX ``"pallas"``
  engine; its tier is the explicit ``reduce`` / ``fuse_exp`` arguments,
  with no preflight and no degrade; trapezoid only, as there;
* ``"tabulated"`` — the same quadrature in plain PyTorch, on the
  trapezoid or the audited snapped-panel Gauss–Legendre rule;
* ``"direct"`` — the exact (n_y × n_z) KJMA integrand, forced when I_p
  is swept (the F-table is per-I_p);
* ``"esdirk"`` — the lane-repacking stiff Boltzmann engine, forced when
  σv, washout or depletion is active; ``"esdirk_lockstep"`` — the same
  stepper run to completion over the whole chunk, kept for A/B.

With a bounce profile (``lz_profile``) or a potential (``bounce``, shot
once into a profile), every point's P is derived from its own wall speed
through the LZ layer on the run's device before the chunk loop.

The chunk loop double-buffers, as JAX's does (``overlap_chunks``): each
chunk is shipped from pinned host staging, enqueued, and its results'
copies back started with one CUDA event per member
(:meth:`SweepPlan.dispatch_local`); the host waits on those events only
when it collects the chunk (:meth:`SweepPlan.collect_local`), after the
next chunk has been enqueued.  :func:`make_chunk_runner` is the padded,
clamped chunk runner the measurement tools and the tiered population
gate stand on.

Robustness, as in the JAX engine: resume directories (``manifest.json``
and ``chunk_{ci:05d}.npz``, the JAX package's format), retry → bisect →
quarantine under deterministic fault injection, the content-addressed
chunk cache, and the JSON-lines event log.  Across processes
(``parallel/multihost.py``) the fleet agrees where JAX's does: the chunk
size is broadcast, the kernels' library digest is agreed by
``allreduce_min`` (a fleet with mixed builds raises on every process),
the coordinator owns the manifest, the chunk files and the store and
broadcasts the resume and cache plans, and every attempt's outcome is
agreed, so that healing is one plan for the whole fleet.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from bdlz_tpu_torch.backend import resolve_device
from bdlz_tpu_torch.config import (
    Config,
    PointParams,
    StaticChoices,
    needs_ode_path,
    point_params_from_config,
)
from bdlz_tpu_torch.constants import GEV_TO_KG
from bdlz_tpu_torch.ops.kjma_kernel import REDUCE_DEFAULT
from bdlz_tpu_torch.utils.profiling import nan_debugging_enabled

#: Config-key → PointParams-field mapping for sweep axes.
AXIS_MAP: Dict[str, str] = {
    "m_chi_GeV": "m_chi_GeV",
    "g_chi": "g_chi",
    "T_p_GeV": "T_p_GeV",
    "beta_over_H": "beta_over_H",
    "v_w": "v_w",
    "I_p": "I_p",
    "g_star": "g_star",
    "g_star_s": "g_star_s",
    "P_chi_to_B": "P",
    "source_shape_sigma_y": "sigma_y",
    "incident_flux_scale": "flux_scale",
    "Y_chi_init": "Y_chi_init",
    "m_B_GeV": "m_B_kg",
    "T_max_over_Tp": "T_max_over_Tp",
    "T_min_over_Tp": "T_min_over_Tp",
    "sigma_v_chi_GeV_m2": "sigma_v",
    "Gamma_wash_over_H": "Gamma_wash_over_H",
}

IMPLS = ("kernel", "tabulated", "direct", "esdirk", "esdirk_lockstep")


def build_grid(
    base: Config,
    axes: Mapping[str, Sequence[float]],
    P_base: Optional[float] = None,
    product: bool = True,
) -> PointParams:
    """Flatten sweep axes into a PointParams of host float64 arrays.

    ``product=True`` takes the cartesian product in C order (the first
    axis varies slowest); ``product=False`` zips equal-length axes.
    """
    unknown = sorted(set(axes) - set(AXIS_MAP))
    if unknown:
        raise ValueError(f"Unknown sweep axes {unknown}; valid: {sorted(AXIS_MAP)}")

    pp0 = point_params_from_config(base, base.P_chi_to_B if P_base is None else P_base)

    values = [np.asarray(v, dtype=np.float64) for v in axes.values()]
    if product:
        mesh_vals = np.meshgrid(*values, indexing="ij")
        cols = [m.reshape(-1) for m in mesh_vals]
    else:
        n = len(values[0])
        if any(len(v) != n for v in values):
            raise ValueError("product=False requires equal-length axes")
        cols = values
    n_points = len(cols[0]) if cols else 1

    fields = {f: np.full(n_points, getattr(pp0, f), dtype=np.float64)
              for f in PointParams._fields}
    for key, col in zip(axes.keys(), cols):
        if key == "m_B_GeV":
            col = col * GEV_TO_KG
        fields[AXIS_MAP[key]] = np.asarray(col, dtype=np.float64)
    return PointParams(**fields)


@dataclass
class SweepResult:
    n_points: int
    n_failed: int
    #: Host seconds of the chunk loop, ending after the device synchronised
    #: (set-up — the F-table build and the kernel build — is excluded).
    seconds: float
    points_per_sec: float
    chunks: int
    #: Quadrature scheme that ran ("trap" or "panel_gl") and its nodes per
    #: point; None for the stiff engines, which have no y-quadrature.
    quad_impl: Optional[str]
    n_quad_nodes: Optional[int]
    #: The engine that ran, after routing.
    impl: str = "tabulated"
    outputs: Optional[Dict[str, np.ndarray]] = field(default=None, repr=False)
    #: Per-point failure mask (True = non-finite output, quarantined points
    #: included), full grid order.
    failed_mask: Optional[np.ndarray] = field(default=None, repr=False)
    #: Per-chunk round counters of the repacked stiff engine.
    esdirk_stats: Optional[List[Any]] = field(default=None, repr=False)
    #: What keys the LZ derivation of P, as the JAX sweep's manifest
    #: ``hash_extra`` holds it (profile and potential fingerprints, the
    #: two-channel estimator and Γ_φ); None without a profile.
    lz_identity: Optional[Dict[str, Any]] = None
    #: Host seconds of the LZ pre-pass (the bounce shoot and the per-point
    #: P), outside ``seconds``.
    lz_seconds: float = 0.0
    #: The sweep directory (chunk files and manifest), or None.
    out_dir: Optional[str] = None
    #: Chunks read back from ``out_dir`` instead of computed.
    resumed_chunks: int = 0
    #: Points quarantined by the healing path (a persistent failure
    #: bisected down to its irreducible range): NaN outputs, counted in
    #: ``n_failed`` too.
    n_quarantined: int = 0
    #: Extra dispatches the healing path paid (retries and bisect probes).
    n_retries: int = 0
    #: Chunks served from the content-addressed store and chunks that had
    #: to compute; None without a store.
    cache_hits: Optional[int] = None
    cache_misses: Optional[int] = None
    #: Per-point quarantine mask (a subset of ``failed_mask``).
    quarantined_mask: Optional[np.ndarray] = field(default=None, repr=False)


def grid_hash(
    base: Config, axes: Mapping[str, Sequence[float]], n_y: int, impl: str = "tabulated",
    extra: Optional[Mapping[str, Any]] = None,
) -> str:
    """The sweep's resume identity: config, axes, n_y, engine and the
    resolved ``extra`` blocks.  Byte-equal to the JAX package's for the
    engines the two share, so a directory resumes in either."""
    from bdlz_tpu_torch.provenance import sweep_identity

    return sweep_identity(base, axes, n_y, impl, extra=extra).digest(16)


def engine_identity_extra(
    static: StaticChoices,
    impl: str,
    *,
    esdirk_knobs: Optional[Dict[str, bool]] = None,
    faults=None,
    fuse_exp: bool = False,
    kernel_reduce: Optional[bool] = None,
) -> Dict[str, Any]:
    """The resolved knobs that change results, as identity ``extra``
    blocks, one home for the manifest hash and the chunk-cache keys:
    ``lz_scenario`` (a chain or thermal mode), ``quad`` (the panel rule,
    omitted for the trapezoid), ``esdirk`` (the repacked engine's knob
    dict), ``kernel`` (the CUDA kernels' tier, the port's counterpart of
    the JAX ``pallas`` block) and ``fault_plan`` (an armed plan)."""
    from bdlz_tpu_torch.lz.sweep_bridge import scenario_identity

    extra: Dict[str, Any] = {}
    scen = scenario_identity(static)
    if scen is not None:
        extra["lz_scenario"] = scen
    if impl == "tabulated" and static.quad_panel_gl is True:
        from bdlz_tpu_torch.solvers.panels import N_PANELS_DEFAULT, NODES_PER_PANEL_DEFAULT

        extra["quad"] = {"panel_gl": True, "n_panels": N_PANELS_DEFAULT,
                         "n_nodes": NODES_PER_PANEL_DEFAULT}
    if impl == "esdirk":
        extra["esdirk"] = {"strategy": "repack", **(esdirk_knobs or {})}
    if impl == "kernel":
        extra["kernel"] = {
            "fuse_exp": bool(fuse_exp),
            "reduce": bool(REDUCE_DEFAULT if kernel_reduce is None else kernel_reduce),
        }
    if faults is not None:
        extra["fault_plan"] = faults.describe()
    return extra


def device_platform(device) -> str:
    """The ``platform`` of a chunk-cache key: ``"torch-cuda"`` or
    ``"torch-cpu"``.  It never equals a JAX platform, so an entry of one
    package is never served to the other, nor a CPU entry to the card."""
    return f"torch-{torch.device(device).type}"


def chunk_cache_key(
    base: Config,
    static: StaticChoices,
    pp: PointParams,
    lo: int,
    hi: int,
    *,
    n_y: int,
    impl: str,
    platform: str,
    table_nodes: int = 16384,
    extra: Optional[Mapping[str, Any]] = None,
    fault_ctx: Optional[tuple] = None,
) -> str:
    """Content key of one chunk's result: the engine core (config and
    static identity, n_y, engine, F-table size, ``platform``, the
    resolved ``extra`` blocks) and the bytes of the unpadded point slice
    [lo, hi) — not the axes nor the chunk's position, so a rebuild that
    repeats a slice hits.  ``fault_ctx`` ``(site, index, lo, hi)`` joins
    the key whenever a fault plan is armed."""
    from bdlz_tpu_torch.provenance import config_payload, static_payload, sweep_chunk_identity

    core: Dict[str, Any] = {
        "schema": 1,
        "base": config_payload(base),
        "static": static_payload(static, normalize_quad=True),
        "n_y": int(n_y),
        "impl": str(impl),
        "table_nodes": int(table_nodes),
        "platform": str(platform),
    }
    if extra:
        core["extra"] = dict(extra)
    if fault_ctx is not None:
        core["fault_window"] = [v if isinstance(v, str) else int(v) for v in fault_ctx]
    arrays = [np.asarray(f)[lo:hi] for f in pp]
    return sweep_chunk_identity(core, arrays).digest(32)


def chunk_entry_ok(ent, n_valid: int) -> bool:
    """A store entry holds every YieldsResult field and the failure mask
    at the slice length."""
    from bdlz_tpu_torch.models.yields_pipeline import YieldsResult

    if ent is None or ent.get("failed") is None:
        return False
    return all(ent.get(f) is not None and ent[f].shape == (n_valid,)
               for f in YieldsResult._fields)


def chunk_entry_arrays(
    host: Mapping[str, np.ndarray], *, n_retries: int = 0,
    qmask: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """One store entry from a chunk's host results: the fields, ``failed``,
    the retry counter and, when any point was quarantined, its mask."""
    from bdlz_tpu_torch.models.yields_pipeline import YieldsResult

    arrays: Dict[str, np.ndarray] = {f: host[f] for f in YieldsResult._fields}
    arrays["failed"] = ~np.isfinite(host["DM_over_B"])
    arrays["n_retries"] = np.int64(n_retries)
    if qmask is not None and qmask.any():
        arrays["quarantined"] = qmask
    return arrays


def heal_budget(n: int, max_attempts: int) -> int:
    """Attempts allowed for healing one chunk of ``n`` points: enough to
    retry and bisect out a few poison points (~log2 n probes each), but
    bounded, so a chunk where everything fails is quarantined whole after
    O(log n) probes."""
    attempts = max(int(max_attempts), 1)
    return attempts * 4 * (1 + max(int(n) - 1, 1).bit_length())


def heal_range(ci, lo, hi, first_err, *, attempt, quarantine, policy, budget, paid,
               fields, on_retry=None):
    """Retry → bisect → quarantine over [lo, hi), the JAX engine's
    semantics.  ``attempt(ci, a, b) -> (ok, host, err)`` evaluates [a, b);
    ``quarantine(ci, a, b, err) -> (host, qmask)`` fills an irreducible
    range with NaN.  Retries sleep the deterministic backoff keyed on
    ``chunk<ci>:<lo>``; a persistent failure is halved, the surviving
    halves kept.  ``budget`` (a one-element list) is shared by the whole
    heal tree of a chunk and quarantines the rest when spent; ``paid``
    (a one-element list) counts every extra attempt; ``on_retry(ci, lo,
    hi, attempt, err)`` observes same-range retries."""
    from bdlz_tpu_torch.utils.retry import backoff_delay

    err = first_err
    attempts = max(int(policy.max_attempts), 1)
    for att in range(1, attempts):
        if budget[0] <= 0:
            break
        if on_retry is not None:
            on_retry(ci, lo, hi, att, err)
        policy.sleep(backoff_delay(policy, f"chunk{ci}:{lo}", att - 1))
        paid[0] += 1
        budget[0] -= 1
        ok, host, err2 = attempt(ci, lo, hi)
        if ok:
            return host, np.zeros(hi - lo, dtype=bool)
        err = err2 if err2 is not None else err
    if hi - lo <= 1 or budget[0] <= 0:
        return quarantine(ci, lo, hi, err)
    mid = lo + (hi - lo) // 2
    parts = []
    for a, b in ((lo, mid), (mid, hi)):
        if budget[0] <= 0:
            parts.append(quarantine(ci, a, b, err))
            continue
        paid[0] += 1
        budget[0] -= 1
        ok, host, err_h = attempt(ci, a, b)
        if ok:
            parts.append((host, np.zeros(b - a, dtype=bool)))
        else:
            parts.append(heal_range(
                ci, a, b, err_h, attempt=attempt, quarantine=quarantine,
                policy=policy, budget=budget, paid=paid, fields=fields,
                on_retry=on_retry,
            ))
    return (
        {f: np.concatenate([p[0][f] for p in parts]) for f in fields},
        np.concatenate([p[1] for p in parts]),
    )


def _pad_chunk(pp: PointParams, lo: int, hi: int, chunk: int) -> PointParams:
    """Slice [lo:hi] padded to ``chunk`` by repeating the last point."""
    def cut(a):
        seg = a[lo:hi]
        if len(seg) < chunk:
            seg = np.concatenate([seg, np.repeat(seg[-1:], chunk - len(seg), axis=0)])
        return seg
    return PointParams(*(cut(np.asarray(f)) for f in pp))


def make_sweep_step(
    static: StaticChoices,
    n_y: int = 8000,
    impl: str = "tabulated",
    fuse_exp: bool = False,
    reduce: bool = REDUCE_DEFAULT,
    esdirk_knobs: Optional[Dict[str, bool]] = None,
    esdirk_stats_sink=None,
    mesh=None,
):
    """The per-chunk step: ``step(pp_chunk, aux) -> YieldsResult`` of (P,)
    tensors on the chunk's device.  ``aux`` is the device F-table
    (``kernel``, ``tabulated``) or the KJMA z-grid (``direct`` and both
    stiff engines).  The quadrature tri-state in ``static`` must already
    be resolved.

    With a ``mesh`` the step takes the padded chunk as host arrays and
    ``aux`` as ``{device: aux}`` over this process's members, and
    returns this process's rows as host arrays (:func:`gather_to_host`
    brings the rest): each member's rows run on its device and its own
    CUDA stream.  The repacked stiff engine takes the mesh itself and
    splits each round's lanes over the members."""
    step = _sweep_step_one_device(static, n_y, impl, fuse_exp, reduce, esdirk_knobs,
                                  esdirk_stats_sink, mesh)
    if mesh is None:
        return step
    return _MeshStep(step, mesh, one_call=(impl == "esdirk"))


class _MeshStep:
    """The mesh step: ``mstep(pp_np, auxes) -> YieldsResult`` of this
    process's rows as host arrays, split into :meth:`dispatch` and
    :meth:`collect`.  Each local member's contiguous rows (the batch plan
    of ``batch_sharding``) are shipped, launched and copied back on its
    device and stream, with one event per member; collection waits on
    those events in member order.  ``one_call`` hands the whole chunk to
    ``step`` on the first member (the repacked stiff engine, which splits
    its rounds over the mesh itself; single-process only)."""

    def __init__(self, step, mesh, one_call: bool):
        from bdlz_tpu_torch.parallel.mesh import batch_sharding

        self.step, self.mesh, self.one_call = step, mesh, one_call
        self.sharding = batch_sharding(mesh)

    def dispatch(self, pp_np, auxes) -> list:
        from bdlz_tpu_torch.parallel.mesh import on_stream

        n = len(np.asarray(pp_np.m_chi_GeV))
        if self.one_call:
            home = self.mesh.local_devices[0]
            ppd = ship_point_params(pp_np, home)
            return [fetch_rows(self.step(ppd, auxes[home]), n, home, ppd)]
        flat = self.mesh.devices.reshape(-1)
        parts = []
        for k, (lo, hi) in zip(self.mesh.local_members, self.sharding.local_bounds(n)):
            dev, s = flat[k], self.mesh.stream(k)
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(dev))
            with on_stream(s):
                ppm = ship_point_params(
                    PointParams(*(np.asarray(f)[lo:hi] for f in pp_np)), dev)
                parts.append(fetch_rows(self.step(ppm, auxes[dev]), hi - lo, dev, ppm))
        return parts

    def collect(self, pending: list):
        from bdlz_tpu_torch.models.yields_pipeline import YieldsResult

        return YieldsResult(*collect_chunk(pending).values())

    def __call__(self, pp_np, auxes):
        return self.collect(self.dispatch(pp_np, auxes))


class _PinnedStaging:
    """Two pinned host slots for one device's chunk inputs: the
    PointParams rows as one (17, n) float64 block, shipped by one
    non-blocking copy.  A slot is refilled only after the event of its
    last host-to-device copy has passed, so the next chunk's inputs never
    overwrite what an earlier copy still reads."""

    def __init__(self):
        self._slots: List[list] = [[None, None], [None, None]]  # [buffer, event]
        self._turn = 0

    def ship(self, pp_np, device: torch.device) -> PointParams:
        cols = [np.asarray(getattr(pp_np, f), dtype=np.float64).reshape(-1)
                for f in PointParams._fields]
        shape = (len(cols), len(cols[0]))
        slot = self._slots[self._turn]
        self._turn ^= 1
        if slot[1] is not None:
            slot[1].synchronize()
        if slot[0] is None or tuple(slot[0].shape) != shape:
            slot[0] = torch.empty(shape, dtype=torch.float64, pin_memory=True)
        rows = slot[0].numpy()
        for i, c in enumerate(cols):
            rows[i] = c
        on_device = slot[0].to(device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record(torch.cuda.current_stream(device))
        return PointParams(*on_device.unbind(0))


_STAGING = threading.local()


def ship_point_params(pp_np, device) -> PointParams:
    """A host chunk's PointParams on ``device``: on the card through this
    thread's two pinned staging slots of that device, asynchronously on
    the current stream; on the CPU as ``interop.point_params_from_numpy``."""
    device = torch.device(device)
    if device.type != "cuda" or nan_debugging_enabled():
        from bdlz_tpu_torch.interop import point_params_from_numpy

        return point_params_from_numpy(pp_np, device)
    per_device = getattr(_STAGING, "slots", None)
    if per_device is None:
        per_device = _STAGING.slots = {}
    staging = per_device.get(device)
    if staging is None:
        staging = per_device[device] = _PinnedStaging()
    return staging.ship(pp_np, device)


def fetch_rows(res, n_keep: int, device, keep=None):
    """Start bringing the first ``n_keep`` rows of a step's YieldsResult
    back: ``(rows, event, keep)``, one member's part of a dispatched
    chunk.  On the card ``rows`` is a pinned (5, n) host block that a
    non-blocking copy fills and ``event`` marks its end, and ``keep``
    holds the member's device tensors until then; on the CPU ``rows``
    are the result tensors and ``event`` is None."""
    rows = [f[:n_keep] for f in res]
    if torch.device(device).type != "cuda":
        return rows, None, None
    out = torch.stack(rows)
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    # under NaN debugging every op scans its output: a pinned block still
    # being filled must not be scanned
    host.copy_(out, non_blocking=not nan_debugging_enabled())
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return host, event, (out, keep)


def dispatch_chunk(engine, pp_np: PointParams, n_valid: int, device, mesh=None) -> list:
    """Launch one engine evaluation of a padded host chunk and start
    copying its first ``n_valid`` rows back (with a ``mesh``, this
    process's rows of the whole padded chunk): the pending chunk, one
    :func:`fetch_rows` part per member, which :func:`collect_chunk`
    waits for.  On the CPU the work is done on return."""
    if mesh is not None:
        return engine[0].dispatch(pp_np, engine[1])
    ppd = ship_point_params(pp_np, device)
    return [fetch_rows(engine[0](ppd, engine[1]), n_valid, device, ppd)]


def collect_chunk(pending: list) -> Dict[str, np.ndarray]:
    """A dispatched chunk's rows as fresh host arrays, members in order:
    waits on each member's event only, never on the device."""
    from bdlz_tpu_torch.models.yields_pipeline import YieldsResult

    parts = []
    for rows, event, _keep in pending:
        if event is not None:
            event.synchronize()
        parts.append([r.numpy().copy() for r in rows])
    if len(parts) == 1:
        return dict(zip(YieldsResult._fields, parts[0]))
    return {f: np.concatenate([p[i] for p in parts])
            for i, f in enumerate(YieldsResult._fields)}


def sweep_step(pp_chunk: PointParams, static: StaticChoices, table, mesh=None,
               n_y: int = 8000):
    """One-shot wrapper around :func:`make_sweep_step` (the tabulated
    engine).  Without a mesh ``pp_chunk`` and ``table`` are on one
    device; with one, ``pp_chunk`` is host arrays (its length a multiple
    of the mesh's members), ``table`` a host ``KJMATable``, and the
    result every process's rows as host arrays."""
    if mesh is None:
        return make_sweep_step(static, n_y=n_y)(pp_chunk, table)
    from bdlz_tpu_torch.ops.kjma_table import table_to_device
    from bdlz_tpu_torch.parallel.multihost import gather_to_host

    auxes = {dev: table_to_device(table, dev) for dev in mesh.local_devices}
    local = make_sweep_step(static, n_y=n_y, mesh=mesh)(pp_chunk, auxes)
    return type(local)(*gather_to_host(list(local)))


def evaluate_chunk(engine, pp_np: PointParams, n_valid: int, device, mesh=None
                   ) -> Dict[str, np.ndarray]:
    """One engine evaluation of a padded host chunk: its first ``n_valid``
    rows as host arrays.  ``engine`` is :func:`build_chunk_engine`'s;
    with a ``mesh`` the rows are split over the members and gathered
    across processes (a collective)."""
    local = collect_chunk(dispatch_chunk(engine, pp_np, n_valid, device, mesh))
    if mesh is None:
        return local
    from bdlz_tpu_torch.parallel.multihost import gather_to_host

    return {f: v[:n_valid] for f, v in gather_to_host(local).items()}


def mesh_pad(n: int, mesh) -> int:
    """``n`` rounded up to a multiple of the mesh's members (``n`` without
    a mesh)."""
    return n if mesh is None else -(-int(n) // mesh.size) * mesh.size


def _sweep_step_one_device(static, n_y, impl, fuse_exp, reduce, esdirk_knobs,
                           esdirk_stats_sink, mesh):
    if impl not in IMPLS:
        raise ValueError(f"unknown sweep impl {impl!r}; expected one of {IMPLS}")
    if fuse_exp and impl != "kernel":
        raise ValueError("fuse_exp requires impl='kernel'")
    if impl == "kernel":
        from bdlz_tpu_torch.ops.kjma_kernel import point_yields_kernel

        def step(pp, table):
            return point_yields_kernel(
                pp, static, table, n_y, fuse_exp=fuse_exp, reduce=reduce
            )
        return step
    if impl == "tabulated":
        from bdlz_tpu_torch.models.yields_pipeline import point_yields_fast

        def step(pp, table):
            return point_yields_fast(pp, static, table, n_y=n_y)
        return step
    if impl == "direct":
        from bdlz_tpu_torch.models.yields_pipeline import point_yields

        def step(pp, grid):
            return point_yields(pp, static, grid)
        return step
    if impl == "esdirk":
        from bdlz_tpu_torch.solvers.batching import make_batched_esdirk_step

        return make_batched_esdirk_step(
            static, stats_sink=esdirk_stats_sink, knobs=esdirk_knobs, mesh=mesh,
        )
    from bdlz_tpu_torch.models.yields_pipeline import YieldsResult, present_day
    from bdlz_tpu_torch.solvers.batching import initial_yields
    from bdlz_tpu_torch.solvers.sdirk import solve_boltzmann_esdirk

    def step(pp, grid):  # esdirk_lockstep
        T_hi = pp.T_max_over_Tp * pp.T_p_GeV
        T_lo = pp.T_min_over_Tp * pp.T_p_GeV
        sol = solve_boltzmann_esdirk(
            pp, static, grid, initial_yields(pp, static), T_lo, T_hi
        )
        res = present_day(sol.y[:, 1], sol.y[:, 0], pp.m_chi_GeV, pp.m_B_kg)
        return YieldsResult(*(torch.where(sol.success, f, torch.nan) for f in res))
    return step


def _clamp_chunk_to_memory(
    chunk_size: int, n_y: int, device: torch.device, impl: str,
    quad_nodes: Optional[int] = None, mesh=None, double_buffer: bool = False,
) -> int:
    """Clamp the chunk so its temporaries fit the device's free memory.

    Per-engine footprint models, the JAX engine's: the fast paths keep
    ~20 live float64 buffers per node (n_y nodes, or the panel scheme's
    nodes); the direct engine ~3 copies of its (n_y × 1200) integrand;
    the stiff engines ~32 of the (1200,) z-integral per lane.  The budget
    is 90% of what ``torch.cuda.mem_get_info`` reports free.  CPU runs
    are never clamped.  On a mesh each member holds ``1/size`` of the
    chunk, and members that share a card share its budget.

    ``double_buffer``: the overlapped chunk loop keeps a second chunk's
    input and output rows (17 PointParams and 5 YieldsResult fields) in
    flight while the current chunk computes, so each point costs 22 more
    float64 values; the working set itself is not doubled, since the
    device runs the chunks one after the other.
    """
    if device.type != "cuda":
        return chunk_size
    free, _ = torch.cuda.mem_get_info(device)
    n_dev, share = 1, 1
    if mesh is not None:
        n_dev = mesh.size
        share = sum(1 for d in mesh.local_devices if d == device)
    nz = 1200
    if impl == "direct":
        per_point_bytes = 3 * max(int(n_y), 1) * nz * 8
    elif impl in ("esdirk", "esdirk_lockstep"):
        per_point_bytes = 32 * nz * 8
    elif quad_nodes:
        per_point_bytes = 20 * max(int(quad_nodes), 1) * 8
    else:
        per_point_bytes = 20 * max(int(n_y), 1) * 8
    if double_buffer:
        per_point_bytes += (len(PointParams._fields) + 5) * 8
    max_chunk = max(int(0.9 * free) // per_point_bytes // share, 1) * n_dev
    if chunk_size > max_chunk:
        print(
            f"[sweep] chunk_size {chunk_size} would need "
            f"~{chunk_size * per_point_bytes / 1e9:.1f} GB for the {impl!r} "
            f"engine at n_y={n_y}, {free / 1e9:.1f} GB free; clamping to "
            f"{max_chunk}",
            file=sys.stderr,
        )
        return max_chunk
    return chunk_size


def route_impl(base: Config, axes: Mapping[str, Sequence[float]], impl: str,
               fuse_exp: bool = False, label: str = "sweep",
               multiprocess: bool = False) -> str:
    """The engine a sweep runs, as the JAX sweep routes it: the stiff
    regime goes to ``esdirk`` unless ``esdirk_lockstep`` was asked for; a
    swept I_p sends the table engines to ``direct``; a multi-process run
    takes ``esdirk_lockstep`` for ``esdirk`` (the repacking compacts lanes
    on the host, so it needs every lane in one process).  A forced change
    is announced on stderr; ``fuse_exp`` on a forced non-kernel engine
    raises."""
    if impl not in IMPLS:
        raise ValueError(f"unknown sweep impl {impl!r}; expected one of {IMPLS}")
    needs_ode = needs_ode_path(base) or any(
        np.any(np.asarray(axes[k], dtype=np.float64) != 0.0)
        for k in ("sigma_v_chi_GeV_m2", "Gamma_wash_over_H") if k in axes
    )
    requested, reason = impl, None
    if needs_ode and impl != "esdirk_lockstep":
        impl = "esdirk"
        reason = "stiff regime: sigma_v/washout/depletion active"
    if "I_p" in axes and impl in ("tabulated", "kernel"):
        impl = "direct"
        reason = "I_p swept: per-I_p table unavailable"
    if impl == "esdirk" and multiprocess:
        impl = "esdirk_lockstep"
        reason = "multi-controller run: host lane-compaction needs addressable lanes"
    if impl != requested:
        print(
            f"[{label}] impl {requested!r} is invalid for this configuration; "
            f"using {impl!r} ({reason})",
            file=sys.stderr,
        )
        if fuse_exp:
            raise ValueError(
                "fuse_exp requires the kernel engine, but this configuration "
                f"forces impl={impl!r}"
            )
    return impl


def build_chunk_engine(
    base: Config,
    static: StaticChoices,
    *,
    n_y: int,
    impl: str,
    device,
    fuse_exp: bool = False,
    reduce: bool = REDUCE_DEFAULT,
    table_np=None,
    table_nodes: int = 16384,
    esdirk_knobs: Optional[Dict[str, bool]] = None,
    esdirk_stats_sink=None,
    mesh=None,
):
    """``(step, aux)`` of one engine on ``device``: the F-table shipped
    once (``table_np`` reuses a host-built table) or the KJMA z-grid, and
    on the card the kernels' libraries built and loaded.  Every
    identity-affecting knob must already be resolved.  With a ``mesh``,
    ``aux`` is ``{device: aux}`` over this process's distinct members
    and ``step`` is the mesh step of :func:`make_sweep_step`."""
    from bdlz_tpu_torch.ops.kjma_table import make_f_table, table_to_device
    from bdlz_tpu_torch.physics.percolation import make_kjma_grid

    devices = [torch.device(device)] if mesh is None else list(dict.fromkeys(mesh.local_devices))
    if impl in ("kernel", "tabulated") and table_np is None:
        table_np = make_f_table(float(base.I_p), n=table_nodes)
    auxes = {dev: (table_to_device(table_np, dev) if impl in ("kernel", "tabulated")
                   else make_kjma_grid(dev)) for dev in devices}
    if impl == "kernel" and any(dev.type == "cuda" for dev in devices):
        from bdlz_tpu_torch.ops.kjma_kernel import load_library, load_point_library

        load_library()
        load_point_library()
    step = make_sweep_step(static, n_y, impl, fuse_exp, reduce, esdirk_knobs=esdirk_knobs,
                           esdirk_stats_sink=esdirk_stats_sink, mesh=mesh)
    return step, (auxes[devices[0]] if mesh is None else auxes)


def make_chunk_runner(
    pp_all: PointParams,
    chunk: int,
    static: StaticChoices,
    table,
    impl: str = "tabulated",
    n_y: int = 8000,
    fuse_exp: bool = False,
    reduce: bool = REDUCE_DEFAULT,
    device=None,
    mesh=None,
):
    """``(run_chunk, chunk)``: padded chunk evaluation over ``pp_all``, the
    engine runner behind the measurement tools and the tiered population
    gate, so what they measure is what the sweep runs.

    ``chunk`` is memory-clamped as in :func:`run_sweep` (and, with a
    ``mesh``, rounded up to a multiple of its members): callers step
    their loops by the returned size.  ``table`` is a ``KJMATable`` on any
    device (shipped to each member's device; unused by ``direct`` and the
    stiff engines, which build the KJMA z-grid) or, with a ``mesh``,
    ``{device: aux}`` as :func:`build_chunk_engine` builds it.
    ``impl="kernel"`` (the JAX ``"pallas"``) runs the kernel tier of
    ``fuse_exp``/``reduce``.  ``run_chunk(lo, hi)`` pads [lo, hi) to the
    chunk, splits it over the members, and returns the padded
    ``DM_over_B`` as a host array.  ``device`` defaults to the card."""
    from bdlz_tpu_torch.solvers.panels import N_PANELS_DEFAULT, NODES_PER_PANEL_DEFAULT

    dev = resolve_device(device) if mesh is None else mesh.local_devices[0]
    quad_nodes = (N_PANELS_DEFAULT * NODES_PER_PANEL_DEFAULT
                  if impl == "tabulated" and static.quad_panel_gl is True else None)
    chunk = mesh_pad(_clamp_chunk_to_memory(int(chunk), n_y, dev, impl, quad_nodes, mesh),
                     mesh)
    if isinstance(table, dict):
        engine = (make_sweep_step(static, n_y, impl, fuse_exp, reduce, mesh=mesh), table)
    else:
        # the table is given, so the engine needs no config to build one
        engine = build_chunk_engine(None, static, n_y=n_y, impl=impl, device=dev,
                                    fuse_exp=fuse_exp, reduce=reduce, table_np=table,
                                    mesh=mesh)

    def run_chunk(lo: int, hi: int) -> np.ndarray:
        padded = _pad_chunk(pp_all, lo, hi, chunk)
        return evaluate_chunk(engine, padded, chunk, dev, mesh)["DM_over_B"]

    return run_chunk, chunk


@dataclass
class SweepPlan:
    """The resolved spec of one sweep: the engine after routing, the
    quadrature tri-state, the memory-clamped chunk size, the identity and
    the content key of every chunk.  :func:`run_sweep` and the elastic
    scheduler (``parallel/scheduler.py``) both take it from
    :func:`plan_sweep`, so the two cannot drift apart: a drifted key would
    read as a cache miss, not as an error."""

    base: Config
    axes: Dict[str, Any]
    static: StaticChoices          # quadrature tri-state resolved
    device: torch.device
    faults: Any                    # the identity-joined FaultPlan, or None
    retry_policy: Any
    pp_all: PointParams            # the full flattened grid
    lz_identity: Optional[Dict[str, Any]]
    lz_seconds: float
    impl: str
    n_total: int
    #: The requested chunk size after the memory clamp (the manifest's).
    chunk_size: int
    n_chunks: int
    n_y: int
    table_np: Any
    table_nodes: int
    quad_on: bool
    quad_nodes: Optional[int]
    esdirk_knobs: Optional[Dict[str, bool]]
    fuse_exp: bool
    reduce: bool
    hash_extra: Dict[str, Any]
    #: The resume identity (:func:`grid_hash`).
    hash: str
    #: The device mesh the chunks are split over, or None (one device).
    mesh: Any = None
    #: Whether the chunk loop double-buffers (the clamp then counts a
    #: second chunk's input and output rows).
    overlap: bool = False

    @property
    def pad_size(self) -> int:
        """Every chunk is padded to this many points: no more than the
        grid, rounded up to a multiple of the mesh's members."""
        pad = min(self.chunk_size, self.n_total)
        if self.mesh is not None:
            pad = -(-pad // self.mesh.size) * self.mesh.size
        return pad

    @property
    def fields(self):
        from bdlz_tpu_torch.models.yields_pipeline import YieldsResult

        return YieldsResult._fields

    @property
    def platform(self) -> str:
        return device_platform(self.device)

    def chunk_bounds(self, ci: int):
        lo = int(ci) * self.chunk_size
        return lo, min(lo + self.chunk_size, self.n_total)

    def chunk_key(self, ci: int) -> str:
        """Chunk ``ci``'s content key in the store (:func:`chunk_cache_key`)."""
        lo, hi = self.chunk_bounds(ci)
        chunk_extra = {k: v for k, v in self.hash_extra.items()
                       if k in ("quad", "esdirk", "kernel", "fault_plan")}
        return chunk_cache_key(
            self.base, self.static, self.pp_all, lo, hi, n_y=self.n_y, impl=self.impl,
            platform=self.platform, table_nodes=self.table_nodes, extra=chunk_extra,
            fault_ctx=("step", ci, lo, hi) if self.faults is not None else None)

    def entry_name(self, ci: int) -> str:
        """Chunk ``ci``'s store entry: the chunk cache's name, shared by
        ``run_sweep`` and the elastic commit plane."""
        return f"sweep_chunk/{self.chunk_key(ci)}.npz"

    def quad_report(self):
        """``(quad_impl, n_quad_nodes)`` of the result: the scheme that ran
        and its nodes per point; None for the stiff engines."""
        if self.impl in ("esdirk", "esdirk_lockstep"):
            return None, None
        if self.quad_on:
            return "panel_gl", self.quad_nodes
        return "trap", max(int(self.n_y), 2000)

    def build_engine(self, esdirk_stats_sink=None):
        """``(step, aux)`` of the plan's engine on its device."""
        return build_chunk_engine(
            self.base, self.static, n_y=self.n_y, impl=self.impl, device=self.device,
            fuse_exp=self.fuse_exp, reduce=self.reduce, table_np=self.table_np,
            table_nodes=self.table_nodes, esdirk_knobs=self.esdirk_knobs,
            esdirk_stats_sink=esdirk_stats_sink, mesh=self.mesh)

    def dispatch_local(self, engine, lo: int, hi: int) -> list:
        """Launch this process's share of one engine evaluation over
        [lo, hi), padded to :attr:`pad_size`: the inputs shipped from
        pinned staging, the step enqueued, and the results' copies back
        started, one event per member (:func:`dispatch_chunk`).  The
        chunk step is the JAX engine's jitted program: no sanitizer
        checkpoint inside it."""
        from bdlz_tpu_torch import sanitize

        padded = _pad_chunk(self.pp_all, lo, hi, self.pad_size)
        with sanitize.opaque():
            return dispatch_chunk(engine, padded, hi - lo, self.device, self.mesh)

    def collect_local(self, pending: list) -> Dict[str, np.ndarray]:
        """A dispatched chunk's rows as host arrays (:func:`collect_chunk`):
        without a mesh the valid rows, with one the process's rows of the
        padded chunk (:meth:`gather` brings the rest)."""
        return collect_chunk(pending)

    def compute_local(self, engine, lo: int, hi: int, trace_dir: Optional[str] = None
                      ) -> Dict[str, np.ndarray]:
        """:meth:`dispatch_local` then :meth:`collect_local`, inside one
        profiler trace per call."""
        from bdlz_tpu_torch.utils.profiling import trace as profiler_trace

        with profiler_trace(trace_dir):
            return self.collect_local(self.dispatch_local(engine, lo, hi))

    def gather(self, local: Dict[str, np.ndarray], lo: int, hi: int
               ) -> Dict[str, np.ndarray]:
        """Every process's rows of :meth:`compute_local`, tiled in process
        order and cut to the valid [lo, hi) (a collective on a mesh)."""
        if self.mesh is None:
            return local
        from bdlz_tpu_torch.parallel.multihost import gather_to_host

        full = gather_to_host(local)
        return {f: full[f][: hi - lo] for f in self.fields}

    def compute(self, engine, lo: int, hi: int, trace_dir: Optional[str] = None
                ) -> Dict[str, np.ndarray]:
        """One engine evaluation over [lo, hi): the valid rows as host
        arrays."""
        return self.gather(self.compute_local(engine, lo, hi, trace_dir), lo, hi)

    def apply_nan_faults(self, host: Dict[str, np.ndarray], lo: int, hi: int
                         ) -> Dict[str, np.ndarray]:
        """The plan's ``nan`` faults in [lo, hi): those points' outputs
        become NaN after a successful step."""
        pts = self.faults.nan_points("step", lo, hi) if self.faults is not None else []
        if pts:
            for f in self.fields:
                arr = np.array(host[f])
                for p in pts:
                    arr[p - lo] = np.nan
                host[f] = arr
        return host


def plan_sweep(
    base: Config,
    axes: Mapping[str, Sequence[float]],
    static: StaticChoices,
    *,
    chunk_size: int = 4096,
    n_y: int = 8000,
    impl: str = "tabulated",
    fuse_exp: bool = False,
    reduce: bool = REDUCE_DEFAULT,
    device=None,
    table_nodes: int = 16384,
    lz_profile=None,
    lz_method: str = "local",
    lz_gamma_phi: float = 0.0,
    bounce=None,
    fault_plan=None,
    retry=None,
    label: str = "sweep",
    mesh=None,
    overlap_chunks: bool = True,
) -> SweepPlan:
    """Resolve a sweep as :func:`run_sweep` runs it: the device, the fault
    plan and retry policy, the grid (with each point's P from the LZ layer
    when there is a profile), the engine routing, the quadrature
    tri-state (the audit needs the host table, built once and shipped),
    the repacked engine's knobs, the memory clamp and the identity.

    With a ``mesh`` the chunk size is rounded up to a multiple of its
    members and the device is its first local member.  Across processes
    the chunk size is the coordinator's and the kernels' library digest
    is agreed (:func:`agree_kernel_digest`).  ``overlap_chunks`` asks
    for the double-buffered loop, which every engine but ``esdirk`` runs
    (the clamp then adds one chunk's IO rows)."""
    from bdlz_tpu_torch.faults import FaultPlan
    from bdlz_tpu_torch.ops.kjma_table import make_f_table
    from bdlz_tpu_torch.solvers.panels import N_PANELS_DEFAULT, NODES_PER_PANEL_DEFAULT
    from bdlz_tpu_torch.utils.retry import resolve_engine_retry
    from bdlz_tpu_torch.validation import resolve_quad_panel_gl

    from bdlz_tpu_torch.parallel.multihost import broadcast_from_coordinator, process_count

    dev = resolve_device(device) if mesh is None else mesh.local_devices[0]
    if mesh is not None and device is not None and resolve_device(device).type != dev.type:
        raise ValueError(f"device={str(device)!r} but the mesh's members are {dev.type}")
    faults = FaultPlan.resolve(fault_plan, base)
    retry_policy = resolve_engine_retry(retry, base, static)
    t_lz = time.perf_counter()
    pp_all, lz_identity = _grid_with_lz(base, axes, static, lz_profile, lz_method,
                                        lz_gamma_phi, bounce, dev)
    lz_seconds = time.perf_counter() - t_lz if lz_identity is not None else 0.0
    impl = route_impl(base, axes, impl, fuse_exp, label=label,
                      multiprocess=process_count() > 1)
    n_total = len(pp_all.m_chi_GeV)
    if mesh is not None:
        # the batch axis must divide evenly across the mesh
        n_dev = mesh.size
        chunk_size = ((max(int(chunk_size), n_dev) + n_dev - 1) // n_dev) * n_dev
    table_np = (make_f_table(float(base.I_p), n=table_nodes)
                if impl == "tabulated" and static.quad_panel_gl is None else None)
    quad_on, _ = resolve_quad_panel_gl(pp_all, static, impl, n_y, table=table_np,
                                       label=label)
    static = static._replace(quad_panel_gl=quad_on)
    quad_nodes = N_PANELS_DEFAULT * NODES_PER_PANEL_DEFAULT if quad_on else None
    esdirk_knobs = _engine_knobs(static, pp_all) if impl == "esdirk" else None
    overlap = bool(overlap_chunks) and impl != "esdirk"
    chunk_size = _clamp_chunk_to_memory(int(chunk_size), n_y, dev, impl, quad_nodes, mesh,
                                        double_buffer=overlap)
    # a per-host clamp must not split the fleet on chunk counts
    chunk_size = int(np.asarray(broadcast_from_coordinator(np.array([chunk_size])))[0])
    if impl == "kernel":
        agree_kernel_digest()
    hash_extra = dict(lz_identity) if lz_identity else {}
    hash_extra.update(engine_identity_extra(
        static, impl, esdirk_knobs=esdirk_knobs, faults=faults, fuse_exp=fuse_exp,
        kernel_reduce=reduce))
    return SweepPlan(
        base=base, axes=dict(axes), static=static, device=dev, faults=faults,
        retry_policy=retry_policy, pp_all=pp_all, lz_identity=lz_identity,
        lz_seconds=lz_seconds, impl=impl, n_total=n_total, chunk_size=chunk_size,
        n_chunks=(n_total + chunk_size - 1) // chunk_size, n_y=int(n_y),
        table_np=table_np, table_nodes=int(table_nodes), quad_on=bool(quad_on),
        quad_nodes=quad_nodes, esdirk_knobs=esdirk_knobs, fuse_exp=bool(fuse_exp),
        reduce=bool(reduce), hash_extra=hash_extra,
        hash=grid_hash(base, axes, n_y, impl, extra=hash_extra or None), mesh=mesh,
        overlap=overlap,
    )


def agree_kernel_digest() -> None:
    """The fleet's agreement on what keys the kernels' numerics: the
    library digests of both kernel sources, ``kjma_interp.cu`` and
    ``kjma_point.cu`` (``ops/kjma_kernel.SOURCE`` and ``POINT_SOURCE``,
    their text and nvcc flags, ``ops/kjma_kernel.kernel_digest``), the port's counterpart of JAX's
    ``COL_BLOCK``/``TABLE_SPLIT3`` knobs.  One ``allreduce_min`` over
    ``[v, -v]`` gives ``[min, -max]``; min ≠ max raises on every process
    together, so a fleet with mixed builds never splices mixed-kernel
    chunks.  The identity in one process."""
    from bdlz_tpu_torch.ops import kjma_kernel
    from bdlz_tpu_torch.parallel.multihost import allreduce_min

    local = int(kjma_kernel.kernel_digest()[:15], 16)
    lo, neg_hi = (int(v) for v in np.asarray(
        allreduce_min(np.array([local, -local], dtype=np.int64))))
    if lo != -neg_hi:
        raise RuntimeError(
            f"the kernel library digest differs across hosts (min {lo:015x}, max "
            f"{-neg_hi:015x}; this host {local:015x}); build one "
            f"{kjma_kernel.SOURCE} and one {kjma_kernel.POINT_SOURCE} with one set of "
            "flags fleet-wide"
        )


def run_sweep(
    base: Config,
    axes: Mapping[str, Sequence[float]],
    static: StaticChoices,
    chunk_size: int = 4096,
    n_y: int = 8000,
    out_dir: Optional[str] = None,
    keep_outputs: bool = True,
    table_nodes: int = 16384,
    event_log=None,
    impl: str = "tabulated",
    fuse_exp: bool = False,
    reduce: bool = REDUCE_DEFAULT,
    device=None,
    lz_profile=None,
    lz_method: str = "local",
    lz_gamma_phi: float = 0.0,
    bounce=None,
    fault_plan=None,
    retry=None,
    cache=None,
    trace_dir: Optional[str] = None,
    mesh=None,
    overlap_chunks: bool = True,
) -> SweepResult:
    """Run a full sweep on one device or a mesh: route the engine, resolve
    the quadrature, then evaluate chunk by chunk — resuming, healing and
    caching as the JAX engine does.

    **Double buffering.** With ``overlap_chunks`` (the default, as in the
    JAX engine) chunk k+1 is padded, shipped from pinned staging and
    enqueued while chunk k still runs; the host blocks only when it
    collects chunk k, on that chunk's events.  At most one chunk is in
    flight and chunks are collected in index order, so events, fault
    hooks, chunk files, the manifest, the store and the counters are the
    serial loop's.  A resumed or cached chunk drains the buffer first; a
    failed dispatch drains it and heals the chunk serially; a failure
    that surfaces at collection (an asynchronous device error) is healed
    there.  ``trace_dir`` and ``impl="esdirk"`` run the serial loop.  The
    argument does not join the grid hash.

    ``mesh`` (``parallel/mesh.make_mesh``) splits every chunk over its
    members: the chunk size is rounded up to a multiple of them, each
    process computes its rows (``process_local_bounds``), each member its
    share on its own device and CUDA stream, and the rows are gathered
    to every process.  ``mesh=None`` is the one-device path.  In a
    multi-process run (``multihost.init_multihost``) the coordinator
    owns the manifest, the chunk files and the store and broadcasts the
    resume and cache plans; the other processes read the same files, so
    the directory and the store root must be on shared storage.

    ``lz_profile`` (a CSV path or a ``BounceProfile``) derives each
    point's P from its own wall speed by ``lz_method`` (``lz_gamma_phi``
    for the dephased estimator), or by the scenario of ``static.lz_mode``;
    ``bounce`` (a potential spec, mapping or JSON path) is shot once into
    such a profile and excludes ``lz_profile``.  ``P_chi_to_B`` may not be
    swept then.

    ``device`` defaults to the first CUDA card and raises without one;
    ``device="cpu"`` runs the plain PyTorch versions of the kernels.
    ``static.quad_panel_gl`` is the tri-state of the JAX sweep: None runs
    the population audit over the full grid (tabulated engine only) and
    turns the panel rule on only when it passes, loudly either way.
    ``impl`` defaults to ``"tabulated"``, the JAX sweep's default, so a
    default call reports the same scheme and ``grid_hash`` there and here.
    The manifest records the requested ``chunk_size`` (after the memory
    clamp), as the JAX engine does; a chunk is padded to no more points
    than the grid has.

    **Resume.** With ``out_dir`` every chunk lands in ``chunk_{ci:05d}.npz``
    (atomically) and ``manifest.json`` records it under the sweep's
    :func:`grid_hash`; a rerun skips the recorded chunks whose files load,
    recomputes a torn or missing one, and starts over on a hash or
    ``chunk_size`` mismatch.  The files and manifest are the JAX
    package's, so a directory resumes in either package for the engines
    they share.

    **Self-healing.** With the retry policy on (``retry`` ▸
    ``retry_enabled``, on by default here), a chunk whose dispatch raises
    is retried with deterministic backoff, then bisected — every probe at
    the sweep's one padded chunk shape — and its irreducible points are
    quarantined: NaN outputs, counted in ``n_failed`` and
    ``quarantined_mask``, ``chunk_retry``/``chunk_quarantine`` events.
    The same engine is retried: nothing falls back to another path.
    ``fault_plan`` ▸ ``Config.fault_plan`` ▸ ``BDLZ_FAULT_PLAN`` inject
    deterministic faults (``faults.py``); an armed plan joins the hash.

    **Chunk cache.** With a store (``cache`` ▸ ``cache_root`` /
    ``cache_enabled`` ▸ ``BDLZ_CACHE_ROOT``; off by default) each chunk's
    result is keyed by :func:`chunk_cache_key` and read before dispatch;
    a resumed chunk wins over a cached one, a fully warm run builds no
    engine, and quarantined chunks of a run without a fault plan are
    never stored.  ``event_log`` (an ``EventLog``) receives
    ``sweep_start``, ``chunk_done``, ``chunk_retry``,
    ``chunk_quarantine`` and ``esdirk_rounds`` with the JAX engine's
    fields.

    **Debugging.** ``trace_dir`` writes one ``torch.profiler`` Chrome
    trace per chunk step.  A ``FloatingPointError`` from
    ``enable_nan_debugging`` aborts the sweep instead of being healed.
    Sanitizer checkpoints inside the chunk step check nothing (the JAX
    step is jitted); the CLI checks the outputs.
    """
    from bdlz_tpu_torch.parallel.multihost import (
        broadcast_from_coordinator,
        is_coordinator,
        process_count,
    )
    from bdlz_tpu_torch.provenance import resolve_store
    from bdlz_tpu_torch.utils.io import atomic_savez, atomic_write_json

    plan = plan_sweep(
        base, axes, static, chunk_size=chunk_size, n_y=n_y, impl=impl, fuse_exp=fuse_exp,
        reduce=reduce, device=device, table_nodes=table_nodes, lz_profile=lz_profile,
        lz_method=lz_method, lz_gamma_phi=lz_gamma_phi, bounce=bounce,
        fault_plan=fault_plan, retry=retry, mesh=mesh,
        overlap_chunks=overlap_chunks and trace_dir is None)
    dev, faults, impl = plan.device, plan.faults, plan.impl
    overlap = plan.overlap
    n_total, chunk_size, n_chunks = plan.n_total, plan.chunk_size, plan.n_chunks
    fields = plan.fields
    h = plan.hash
    coordinator = is_coordinator()
    multiproc = process_count() > 1
    stats: List[Any] = []
    manifest: Dict[str, Any] = {}
    manifest_path = None
    if out_dir is not None:
        if coordinator:
            os.makedirs(out_dir, exist_ok=True)
        manifest_path = f"{out_dir}/manifest.json"
        if coordinator and os.path.exists(manifest_path):
            with open(manifest_path) as f:
                manifest = json.load(f)
            if manifest.get("hash") != h:
                manifest = {}
            elif manifest.get("chunk_size") not in (None, chunk_size):
                print(f"[sweep] resume: manifest chunk_size {manifest.get('chunk_size')} "
                      f"!= current {chunk_size}; recomputing from scratch", file=sys.stderr)
                manifest = {}
        manifest.setdefault("hash", h)
        manifest.setdefault("impl", impl)
        manifest.setdefault("n_total", n_total)
        manifest.setdefault("chunk_size", chunk_size)
        manifest.setdefault("chunks", {})

    def _load_chunk(ci: int) -> Dict[str, np.ndarray]:
        chunk_file = f"{out_dir}/chunk_{ci:05d}.npz"
        with np.load(chunk_file) as data:
            got = {f: np.asarray(data[f]) for f in fields}
            got["failed"] = np.asarray(
                data["failed"] if "failed" in data.files
                else ~np.isfinite(data["DM_over_B"]), dtype=bool)
            got["quarantined"] = (
                np.asarray(data["quarantined"], dtype=bool)
                if "quarantined" in data.files else np.zeros(len(got["failed"]), bool))
        return got

    # ---- the resume plan: the coordinator owns the manifest and the
    # chunk files, and broadcasts [done, n_failed, n_quarantined] per
    # chunk, so that every process skips and computes the same chunks
    rplan = np.zeros((n_chunks, 3), dtype=np.int64)
    resumed_data: Dict[int, Dict[str, np.ndarray]] = {}
    for ci, rec in list(manifest.get("chunks", {}).items() if coordinator else []):
        ci = int(ci)
        try:
            got = _load_chunk(ci)
        except Exception as exc:  # noqa: BLE001 — a torn file is recomputed
            print(f"[sweep] resume: chunk {ci} listed in manifest but "
                  f"{out_dir}/chunk_{ci:05d}.npz is missing/unreadable ({exc!r}); "
                  "recomputing", file=sys.stderr)
            del manifest["chunks"][str(ci)]
            continue
        if ci < n_chunks:
            resumed_data[ci] = got
            rplan[ci] = (1, int(rec["n_failed"]), int(rec.get("n_quarantined", 0)))
    rplan = broadcast_from_coordinator(rplan)
    for ci in np.flatnonzero(rplan[:, 0]):
        ci = int(ci)
        if ci not in resumed_data:
            # another process's plan: the files are on shared storage
            try:
                resumed_data[ci] = _load_chunk(ci)
            except Exception as exc:  # noqa: BLE001 — re-raised with the cause
                raise RuntimeError(
                    f"resumed chunk file {out_dir}/chunk_{ci:05d}.npz unreadable on "
                    f"this process ({exc!r}); multi-process resume requires shared "
                    "storage") from exc
        resumed_data[ci]["n_failed"] = int(rplan[ci, 1])
        resumed_data[ci]["n_quarantined"] = int(rplan[ci, 2])

    # ---- the chunk cache's hit plan (a resumed chunk wins), decided by
    # the coordinator and broadcast as [hit, n_retries] per chunk
    store = resolve_store(cache, base, label="sweep")
    cache_data: Dict[int, Dict[str, np.ndarray]] = {}
    cplan = np.zeros((n_chunks, 2), dtype=np.int64)
    if store is not None and coordinator:
        for ci in range(n_chunks):
            if rplan[ci, 0]:
                continue
            lo, hi = plan.chunk_bounds(ci)
            ent = store.get_npz(plan.entry_name(ci))
            if chunk_entry_ok(ent, hi - lo):
                cache_data[ci] = ent
                cplan[ci] = (1, int(ent.get("n_retries", 0)))
    cplan = broadcast_from_coordinator(cplan)
    for ci in np.flatnonzero(cplan[:, 0]):
        ci = int(ci)
        if ci not in cache_data:
            lo, hi = plan.chunk_bounds(ci)
            ent = store.get_npz(plan.entry_name(ci)) if store is not None else None
            if not chunk_entry_ok(ent, hi - lo):
                raise RuntimeError(
                    f"chunk {ci} was cache-planned by the coordinator but its entry "
                    "is unreadable on this process; multi-process cached sweeps "
                    "require a shared cache root (like chunk-file resume)")
            cache_data[ci] = ent

    # the engine is built only if some chunk computes; before the clock
    engine = None
    if len(resumed_data) + len(cache_data) < n_chunks:
        engine = plan.build_engine(esdirk_stats_sink=stats.append)

    if event_log is not None:
        event_log.emit("sweep_start", n_points=n_total, chunks=n_chunks,
                       chunk_size=chunk_size, hash=h, use_table="I_p" not in axes,
                       impl=impl)

    collected: Dict[str, list] = {f: [] for f in fields}
    masks: List[np.ndarray] = []
    qmasks: List[np.ndarray] = []
    totals = {"failed": 0, "quarantined": 0, "retries": 0}
    n_stats_seen = [0]
    retry_policy = plan.retry_policy
    heal_on = retry_policy is not None

    def _agree_ok(ok_local: int) -> int:
        # one outcome fleet-wide: a one-sided failure puts every process
        # on the healing path (the identity in one process)
        if not multiproc:
            return int(ok_local)
        from bdlz_tpu_torch.parallel.multihost import allreduce_min

        return int(np.asarray(allreduce_min(np.array([ok_local], dtype=np.int64)))[0])

    def _attempt(ci, lo_r, hi_r):
        local, err = None, None
        try:
            if faults is not None:
                faults.fire("step", ci)
                faults.check_range("step", lo_r, hi_r)
            local = plan.compute_local(engine, lo_r, hi_r, trace_dir=trace_dir)
        except FloatingPointError:
            raise  # enable_nan_debugging aborts the sweep; never healed
        except Exception as exc:  # noqa: BLE001 — the healing path decides
            err = exc
        if not _agree_ok(err is None):
            return 0, None, err or RuntimeError("chunk dispatch failed on another process")
        host = plan.gather(local, lo_r, hi_r)
        return 1, plan.apply_nan_faults(host, lo_r, hi_r), None

    def _quarantine(ci, lo_r, hi_r, err):
        if event_log is not None:
            event_log.emit("chunk_quarantine", chunk=ci, lo=lo_r, hi=hi_r,
                           n_points=hi_r - lo_r, error=repr(err))
        return ({f: np.full(hi_r - lo_r, np.nan) for f in fields},
                np.ones(hi_r - lo_r, dtype=bool))

    def _on_retry(ci, lo_r, hi_r, attempt, err):
        if event_log is not None:
            event_log.emit("chunk_retry", chunk=ci, lo=lo_r, hi=hi_r, attempt=attempt,
                           error=repr(err))

    def _collect(ci, lo, hi, host, q, t_chunk, paid=0, cached=False):
        """Count, log, persist and keep one chunk's results; ``paid`` is
        its retries (for a cache hit, the ones the entry recorded).  Only
        the coordinator writes."""
        n_valid = hi - lo
        if not cached:
            host = plan.apply_nan_faults(host, lo, hi)
        totals["quarantined"] += int(q.sum())
        totals["retries"] += int(paid)
        bad = ~np.isfinite(host["DM_over_B"])
        totals["failed"] += int(bad.sum())
        if event_log is not None:
            event_log.emit(
                "chunk_done", chunk=ci, n_valid=n_valid, n_failed=int(bad.sum()),
                n_quarantined=int(q.sum()), seconds=round(time.time() - t_chunk, 4),
                **({"cached": True} if cached else {}))
            for cs in stats[n_stats_seen[0]:]:
                event_log.emit("esdirk_rounds", chunk=ci, **cs.summary(),
                               per_round=cs.as_rows())
        n_stats_seen[0] = len(stats)
        if out_dir is not None and coordinator:
            chunk_file = f"{out_dir}/chunk_{ci:05d}.npz"
            atomic_savez(chunk_file, **host, failed=bad,
                         **({"quarantined": q} if q.any() else {}))
            rec = {"file": chunk_file, "n_valid": n_valid, "n_failed": int(bad.sum())}
            if q.any():
                rec["n_quarantined"] = int(q.sum())
                idx = np.flatnonzero(q)
                if len(idx) <= 128:
                    rec["quarantined"] = [int(i) for i in idx]
                else:
                    rec["quarantined_truncated"] = True
            manifest["chunks"][str(ci)] = rec
            atomic_write_json(manifest_path, manifest)
            if faults is not None:
                # torn storage after the atomic write: resume must detect it
                faults.corrupt_file("chunk_write", ci, chunk_file)
        # a real quarantine is never cached; an armed plan's is (keyed)
        if (store is not None and coordinator and not cached
                and (not q.any() or faults is not None)):
            store.put_npz(plan.entry_name(ci),
                          chunk_entry_arrays(host, n_retries=paid, qmask=q))
        if keep_outputs:
            for f in fields:
                collected[f].append(host[f])
        masks.append(bad)
        qmasks.append(q)

    def _heal(ci, lo, hi, err, paid):
        return heal_range(
            ci, lo, hi, err, attempt=_attempt, quarantine=_quarantine,
            policy=retry_policy, budget=[heal_budget(hi - lo, retry_policy.max_attempts)],
            paid=paid, fields=fields, on_retry=_on_retry)

    def _finish(entry):
        """Collect one dispatched chunk (healing a failure that surfaces
        here, agreed fleet-wide first), then count, log and keep it."""
        ci, lo, hi = entry["ci"], entry["lo"], entry["hi"]
        paid = entry["paid"]
        host, q = entry.get("host"), entry.get("q")
        if host is None:
            local, err = entry.get("local"), None
            if local is None:
                try:
                    local = plan.collect_local(entry.pop("pending"))
                except Exception as exc:  # noqa: BLE001 — healed below
                    if not heal_on or isinstance(exc, FloatingPointError):
                        raise
                    err = exc
                if heal_on and multiproc and not _agree_ok(err is None) and err is None:
                    err = RuntimeError("chunk gather failed on another process")
            if err is None:
                host = plan.gather(local, lo, hi)
            else:
                host, q = _heal(ci, lo, hi, err, paid)
        if q is None:
            q = np.zeros(hi - lo, dtype=bool)
        _collect(ci, lo, hi, host, q, entry["t0"], paid=paid[0])

    # at most one dispatched, uncollected chunk; collected in index order
    inflight: List[Dict[str, Any]] = []

    def _drain():
        while inflight:
            _finish(inflight.pop())

    resumed = 0
    t0 = time.perf_counter()
    for ci in range(n_chunks):
        lo, hi = plan.chunk_bounds(ci)
        if ci in resumed_data:
            _drain()
            got = resumed_data[ci]
            resumed += 1
            totals["failed"] += got["n_failed"]
            totals["quarantined"] += got["n_quarantined"]
            masks.append(got["failed"])
            qmasks.append(got["quarantined"])
            if keep_outputs:
                for f in fields:
                    collected[f].append(got[f])
            continue
        t_chunk = time.time()
        if ci in cache_data:
            _drain()
            ent = cache_data[ci]
            qm = ent.get("quarantined")
            _collect(ci, lo, hi, {f: ent[f] for f in fields},
                     np.zeros(hi - lo, bool) if qm is None else np.asarray(qm, bool),
                     t_chunk, paid=int(ent.get("n_retries", 0)), cached=True)
            continue
        entry: Dict[str, Any] = {"ci": ci, "lo": lo, "hi": hi, "t0": t_chunk, "paid": [0]}
        err = None
        try:
            if faults is not None:
                faults.fire("step", ci)
                faults.check_range("step", lo, hi)
            if overlap:
                entry["pending"] = plan.dispatch_local(engine, lo, hi)
            else:
                entry["local"] = plan.compute_local(engine, lo, hi, trace_dir=trace_dir)
        except Exception as exc:  # noqa: BLE001 — healed below
            if not heal_on or isinstance(exc, FloatingPointError):
                raise
            err = exc
        if heal_on and multiproc and not _agree_ok(err is None) and err is None:
            err = RuntimeError("chunk dispatch failed on another process")
        # chunk k-1 is collected while chunk k runs; a failed dispatch
        # drains the buffer to serial before its chunk heals
        _drain()
        if err is not None:
            entry.pop("pending", None)
            entry["host"], entry["q"] = _heal(ci, lo, hi, err, entry["paid"])
        if overlap and err is None:
            inflight.append(entry)
        else:
            _finish(entry)
    _drain()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    quad_impl, n_quad = plan.quad_report()
    cache_hits = cache_misses = None
    if store is not None:
        cache_hits = len(cache_data)
        cache_misses = n_chunks - len(cache_data) - len(resumed_data)
    failed_mask = np.concatenate(masks) if masks else np.zeros(0, bool)
    return SweepResult(
        n_points=n_total,
        n_failed=totals["failed"],
        seconds=seconds,
        points_per_sec=n_total / max(seconds, 1e-9),
        chunks=n_chunks,
        quad_impl=quad_impl,
        n_quad_nodes=n_quad,
        impl=impl,
        outputs=({f: np.concatenate(collected[f]) for f in fields}
                 if keep_outputs else None),
        failed_mask=failed_mask,
        esdirk_stats=stats if impl == "esdirk" else None,
        lz_identity=plan.lz_identity,
        lz_seconds=plan.lz_seconds,
        out_dir=out_dir,
        resumed_chunks=resumed,
        n_quarantined=totals["quarantined"],
        n_retries=totals["retries"],
        cache_hits=cache_hits,
        cache_misses=cache_misses,
        quarantined_mask=np.concatenate(qmasks) if qmasks else np.zeros(0, bool),
    )


def _grid_with_lz(base: Config, axes, static: StaticChoices, lz_profile, lz_method,
                  lz_gamma_phi, bounce, dev):
    """The grid, with each point's P derived from the profile when there is
    one (``bdlz_tpu/parallel/sweep.py:1031-1128``): ``(pp_all,
    lz_identity)``.  The bounce is shot once; a scenario mode owns the
    estimator."""
    bounce_fp = None
    if bounce is not None:
        if lz_profile is not None:
            raise ValueError(
                "pass either bounce or lz_profile, not both — the bounce "
                "solver derives the profile the lz_profile seam would load"
            )
        from bdlz_tpu_torch.bounce import as_potential_spec, bounce_profile, potential_fingerprint

        bounce = as_potential_spec(bounce)
        bounce_fp = potential_fingerprint(bounce)
        lz_profile = bounce_profile(bounce, device=dev)

    # with a profile the config's P is irrelevant (and may be None): a
    # placeholder that the per-point probabilities overwrite
    P_base = 0.0 if (lz_profile is not None and base.P_chi_to_B is None) else None
    pp_all = build_grid(base, axes, P_base=P_base)
    lz_mode = getattr(static, "lz_mode", "two_channel")
    if lz_mode != "two_channel":
        if lz_profile is None:
            raise ValueError(
                f"lz_mode={lz_mode!r} derives P per point from a bounce "
                "profile; pass lz_profile"
            )
        if lz_gamma_phi:
            raise ValueError(
                f"lz_gamma_phi has no effect with lz_mode={lz_mode!r} "
                "(the scenario derives its own dephasing)"
            )
        if lz_method != "local":
            raise ValueError(
                f"lz_method={lz_method!r} has no effect with "
                f"lz_mode={lz_mode!r} (the scenario owns the kernel)"
            )
    if lz_profile is None:
        return pp_all, None
    if "P_chi_to_B" in axes:
        raise ValueError(
            "P_chi_to_B cannot be swept when lz_profile derives P per "
            "point; sweep v_w instead"
        )
    from bdlz_tpu_torch.lz.profile import load_profile_csv
    from bdlz_tpu_torch.lz.sweep_bridge import (
        probabilities_for_points,
        profile_fingerprint,
        scenario_probabilities_for_points,
    )

    if isinstance(lz_profile, str):
        lz_profile = load_profile_csv(lz_profile)
    identity = {"lz_profile": profile_fingerprint(lz_profile)}
    if lz_mode != "two_channel":
        # the scenario itself is keyed by its own identity home
        # (sweep_bridge.scenario_identity), as in the JAX package
        P_pts = scenario_probabilities_for_points(
            lz_profile, static, np.asarray(pp_all.v_w),
            T_p_GeV=np.asarray(pp_all.T_p_GeV), device=dev,
        )
    else:
        P_pts = probabilities_for_points(
            lz_profile, np.asarray(pp_all.v_w), method=lz_method,
            T_p_GeV=np.asarray(pp_all.T_p_GeV),
            m_chi_GeV=np.asarray(pp_all.m_chi_GeV),
            gamma_phi=lz_gamma_phi, device=dev,
        )
        identity["lz_method"] = lz_method
        if lz_method == "dephased":
            identity["lz_gamma_phi"] = float(lz_gamma_phi)
    if bounce_fp is not None:
        identity["bounce"] = bounce_fp
    return pp_all._replace(P=np.asarray(P_pts, dtype=np.float64)), identity


def _engine_knobs(static: StaticChoices, pp_all: PointParams) -> Dict[str, bool]:
    """The repacked engine's knobs, resolved ONCE over the full grid's I_p
    column, so that chunk boundaries never change which RHS runs."""
    from bdlz_tpu_torch.solvers.batching import resolve_engine_knobs

    return resolve_engine_knobs(static, np.asarray(pp_all.I_p))
