"""The parameter-sweep engine on one CUDA device.

Counterpart of the single-device path of ``bdlz_tpu/parallel/sweep.py``:
flatten the sweep axes into a grid of points, then evaluate it chunk by
chunk — each chunk padded to one fixed size by repeating its last point,
moved to the device, run through the batched pipeline, and its valid
rows brought back.  Failed points (non-finite outputs) are masked and
counted, never fatal.

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

Not ported yet: resume directories and manifests, retry → bisect →
quarantine, the chunk cache and event log, LZ profiles, and multi-device
meshes (ROADMAP D).
"""
from __future__ import annotations

import sys
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
    impl: str = "kernel"
    outputs: Optional[Dict[str, np.ndarray]] = field(default=None, repr=False)
    #: Per-point failure mask (True = non-finite output), full grid order.
    failed_mask: Optional[np.ndarray] = field(default=None, repr=False)
    #: Per-chunk round counters of the repacked stiff engine.
    esdirk_stats: Optional[List[Any]] = field(default=None, repr=False)


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
    impl: str = "kernel",
    fuse_exp: bool = False,
    reduce: bool = REDUCE_DEFAULT,
    esdirk_knobs: Optional[Dict[str, bool]] = None,
    esdirk_stats_sink=None,
):
    """The per-chunk step: ``step(pp_chunk, aux) -> YieldsResult`` of (P,)
    tensors on the chunk's device.  ``aux`` is the device F-table
    (``kernel``, ``tabulated``) or the KJMA z-grid (``direct`` and both
    stiff engines).  The quadrature tri-state in ``static`` must already
    be resolved."""
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
            static, stats_sink=esdirk_stats_sink, knobs=esdirk_knobs,
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
    quad_nodes: Optional[int] = None,
) -> int:
    """Clamp the chunk so its temporaries fit the device's free memory.

    Per-engine footprint models, the JAX engine's: the fast paths keep
    ~20 live float64 buffers per node (n_y nodes, or the panel scheme's
    nodes); the direct engine ~3 copies of its (n_y × 1200) integrand;
    the stiff engines ~32 of the (1200,) z-integral per lane.  The budget
    is 90% of what ``torch.cuda.mem_get_info`` reports free.  CPU runs
    are never clamped.
    """
    if device.type != "cuda":
        return chunk_size
    free, _ = torch.cuda.mem_get_info(device)
    nz = 1200
    if impl == "direct":
        per_point_bytes = 3 * max(int(n_y), 1) * nz * 8
    elif impl in ("esdirk", "esdirk_lockstep"):
        per_point_bytes = 32 * nz * 8
    elif quad_nodes:
        per_point_bytes = 20 * max(int(quad_nodes), 1) * 8
    else:
        per_point_bytes = 20 * max(int(n_y), 1) * 8
    max_chunk = max(int(0.9 * free) // per_point_bytes, 1)
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
               fuse_exp: bool = False) -> str:
    """The engine a sweep runs, as the JAX sweep routes it: the stiff
    regime goes to ``esdirk`` unless ``esdirk_lockstep`` was asked for; a
    swept I_p sends the table engines to ``direct``.  A forced change is
    announced on stderr; ``fuse_exp`` on a forced non-kernel engine
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
    if impl != requested:
        print(
            f"[sweep] impl {requested!r} is invalid for this configuration; "
            f"using {impl!r} ({reason})",
            file=sys.stderr,
        )
        if fuse_exp:
            raise ValueError(
                "fuse_exp requires the kernel engine, but this configuration "
                f"forces impl={impl!r}"
            )
    return impl


def run_sweep(
    base: Config,
    axes: Mapping[str, Sequence[float]],
    static: StaticChoices,
    chunk_size: int = 4096,
    n_y: int = 8000,
    keep_outputs: bool = True,
    table_nodes: int = 16384,
    impl: str = "kernel",
    fuse_exp: bool = False,
    reduce: bool = REDUCE_DEFAULT,
    device=None,
) -> SweepResult:
    """Run a full sweep on one device: route the engine, resolve the
    quadrature, then evaluate chunk by chunk.

    ``device`` defaults to the first CUDA card and raises without one;
    ``device="cpu"`` runs the plain PyTorch versions of the kernels.
    ``static.quad_panel_gl`` is the tri-state of the JAX sweep: None runs
    the population audit over the full grid (tabulated engine only) and
    turns the panel rule on only when it passes, loudly either way.
    Chunks never hold more points than the grid has.
    """
    from bdlz_tpu_torch.interop import point_params_from_numpy
    from bdlz_tpu_torch.models.yields_pipeline import YieldsResult
    from bdlz_tpu_torch.ops.kjma_table import make_f_table, table_to_device
    from bdlz_tpu_torch.physics.percolation import make_kjma_grid
    from bdlz_tpu_torch.solvers.panels import N_PANELS_DEFAULT, NODES_PER_PANEL_DEFAULT
    from bdlz_tpu_torch.validation import resolve_quad_panel_gl

    dev = resolve_device(device)
    impl = route_impl(base, axes, impl, fuse_exp)
    pp_all = build_grid(base, axes)
    n_total = len(pp_all.m_chi_GeV)

    table_np = (make_f_table(float(base.I_p), n=table_nodes)
                if impl in ("kernel", "tabulated") else None)
    quad_on, _ = resolve_quad_panel_gl(pp_all, static, impl, n_y, table=table_np)
    static = static._replace(quad_panel_gl=quad_on)
    quad_nodes = N_PANELS_DEFAULT * NODES_PER_PANEL_DEFAULT if quad_on else None
    stats: List[Any] = []
    step = make_sweep_step(
        static, n_y, impl, fuse_exp, reduce,
        esdirk_knobs=(_engine_knobs(static, pp_all) if impl == "esdirk" else None),
        esdirk_stats_sink=stats.append,
    )

    chunk_size = min(int(chunk_size), n_total)
    chunk_size = _clamp_chunk_to_memory(chunk_size, n_y, dev, impl, quad_nodes)
    n_chunks = (n_total + chunk_size - 1) // chunk_size
    if table_np is None:
        aux = make_kjma_grid(dev)
    else:
        aux = table_to_device(table_np, dev)
    if impl == "kernel" and dev.type == "cuda":
        from bdlz_tpu_torch.ops.kjma_kernel import load_library

        load_library()  # build/load before the clock starts

    fields = YieldsResult._fields
    collected: Dict[str, list] = {f: [] for f in fields}
    masks = []
    t0 = time.perf_counter()
    for ci in range(n_chunks):
        lo, hi = ci * chunk_size, min((ci + 1) * chunk_size, n_total)
        ppc = point_params_from_numpy(_pad_chunk(pp_all, lo, hi, chunk_size), dev)
        res = step(ppc, aux)
        host = {f: getattr(res, f)[: hi - lo].cpu().numpy() for f in fields}
        masks.append(~np.isfinite(host["DM_over_B"]))
        if keep_outputs:
            for f in fields:
                collected[f].append(host[f])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    failed_mask = np.concatenate(masks)
    if impl in ("esdirk", "esdirk_lockstep"):
        quad_impl, n_quad = None, None
    else:
        quad_impl = "panel_gl" if quad_on else "trap"
        n_quad = quad_nodes if quad_on else max(int(n_y), 2000)
    return SweepResult(
        n_points=n_total,
        n_failed=int(failed_mask.sum()),
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
    )


def _engine_knobs(static: StaticChoices, pp_all: PointParams) -> Dict[str, bool]:
    """The repacked engine's knobs, resolved ONCE over the full grid's I_p
    column, so that chunk boundaries never change which RHS runs."""
    from bdlz_tpu_torch.solvers.batching import resolve_engine_knobs

    return resolve_engine_knobs(static, np.asarray(pp_all.I_p))
