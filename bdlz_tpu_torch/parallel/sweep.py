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
  with no preflight and no degrade;
* ``"tabulated"`` — the same quadrature in plain PyTorch.

Not ported yet, and refused loudly: the stiff (ODE) regime, a swept
``I_p`` (the direct engine), and the panel Gauss–Legendre quadrature.
Neither resume directories, self-healing, the chunk cache, LZ profiles
nor multi-device meshes are ported yet.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence

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

IMPLS = ("kernel", "tabulated")


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
    #: Quadrature scheme that ran ("trap") and its nodes per point.
    quad_impl: str
    n_quad_nodes: int
    outputs: Optional[Dict[str, np.ndarray]] = field(default=None, repr=False)
    #: Per-point failure mask (True = non-finite output), full grid order.
    failed_mask: Optional[np.ndarray] = field(default=None, repr=False)


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
):
    """The per-chunk step: ``step(pp_chunk, table) -> YieldsResult`` of (P,)
    tensors on the chunk's device."""
    if impl == "kernel":
        from bdlz_tpu_torch.ops.kjma_kernel import point_yields_kernel

        def step(pp, table):
            return point_yields_kernel(
                pp, static, table, n_y, fuse_exp=fuse_exp, reduce=reduce
            )
        return step
    if impl == "tabulated":
        if fuse_exp:
            raise ValueError("fuse_exp requires impl='kernel'")
        from bdlz_tpu_torch.models.yields_pipeline import point_yields_fast

        def step(pp, table):
            return point_yields_fast(pp, static, table, n_y=n_y)
        return step
    raise ValueError(f"unknown sweep impl {impl!r}; expected one of {IMPLS}")


def _clamp_chunk_to_memory(chunk_size: int, n_y: int, device: torch.device) -> int:
    """Clamp the chunk so its temporaries fit the device's free memory.

    The fast paths keep ~20 live float64 (n_y,)-buffers per point (the
    JAX engine's measured footprint model); the budget is 90% of what
    ``torch.cuda.mem_get_info`` reports free.  CPU runs are never clamped.
    """
    if device.type != "cuda":
        return chunk_size
    free, _ = torch.cuda.mem_get_info(device)
    per_point_bytes = 20 * max(int(n_y), 1) * 8
    max_chunk = max(int(0.9 * free) // per_point_bytes, 1)
    if chunk_size > max_chunk:
        print(
            f"[sweep] chunk_size {chunk_size} would need "
            f"~{chunk_size * per_point_bytes / 1e9:.1f} GB at n_y={n_y}, "
            f"{free / 1e9:.1f} GB free; clamping to {max_chunk}",
            file=sys.stderr,
        )
        return max_chunk
    return chunk_size


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
    """Run a full sweep on one device: grid build → per-chunk evaluation.

    ``device`` defaults to the first CUDA card and raises without one;
    ``device="cpu"`` runs the plain PyTorch versions of the kernels.
    """
    from bdlz_tpu_torch.models.yields_pipeline import YieldsResult
    from bdlz_tpu_torch.ops.kjma_table import make_f_table, table_to_device
    from bdlz_tpu_torch.interop import point_params_from_numpy

    dev = resolve_device(device)
    if needs_ode_path(base) or any(
        np.any(np.asarray(axes[k], dtype=np.float64) != 0.0)
        for k in ("sigma_v_chi_GeV_m2", "Gamma_wash_over_H") if k in axes
    ):
        raise NotImplementedError(
            "stiff regime (sigma_v/washout/depletion active) needs the ESDIRK "
            "engines, which are not ported yet"
        )
    if "I_p" in axes:
        raise NotImplementedError(
            "a swept I_p needs the direct (n_y x n_z) engine, which is not "
            "ported yet (the F-table is per-I_p)"
        )
    if static.quad_panel_gl is True:
        raise NotImplementedError(
            "quad_panel_gl=True needs the snapped-panel Gauss-Legendre rule, "
            "which is not ported yet"
        )
    step = make_sweep_step(static, n_y, impl, fuse_exp, reduce)

    pp_all = build_grid(base, axes)
    n_total = len(pp_all.m_chi_GeV)
    chunk_size = _clamp_chunk_to_memory(chunk_size, n_y, dev)
    n_chunks = (n_total + chunk_size - 1) // chunk_size
    table = table_to_device(make_f_table(float(base.I_p), n=table_nodes), dev)
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
        res = step(ppc, table)
        host = {f: getattr(res, f)[: hi - lo].cpu().numpy() for f in fields}
        masks.append(~np.isfinite(host["DM_over_B"]))
        if keep_outputs:
            for f in fields:
                collected[f].append(host[f])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    failed_mask = np.concatenate(masks)
    return SweepResult(
        n_points=n_total,
        n_failed=int(failed_mask.sum()),
        seconds=seconds,
        points_per_sec=n_total / max(seconds, 1e-9),
        chunks=n_chunks,
        quad_impl="trap",
        n_quad_nodes=max(int(n_y), 2000),
        outputs=({f: np.concatenate(collected[f]) for f in fields}
                 if keep_outputs else None),
        failed_mask=failed_mask,
    )
