"""The sweep's KJMA interpolate-and-reduce hot loop on hand-written CUDA kernels.

Counterpart of ``bdlz_tpu/ops/kjma_pallas.py``.  The host side
(``prepare_streams``) keeps the TPU engine's algebra and its order: per
point, every power law of the integrand folds into closed-form scalars
(``KK``, ``bf_ratio``); the A/V e^{clamp(y)}, the Gaussian window and the
Maxwell–Boltzmann exponent merge into ONE exponent per node, normalised
by its analytic per-point peak ``A_max``; the trapezoid weights fold into
the stream; and the finish is ``Y_B = KK·e^{A_max}·gscale·Σ``, exactly 0
for an empty window.

What was dropped, and why.  The Pallas engine casts the streams to f32,
splits the exponent into two f32 pieces (``split_f64``), pads nodes into
(ncol, 128) tiles (``_to_tiles``), ships the table as a (512, 128)
stencil-shifted transposed f32 matrix (optionally a bf16x3 split of it)
and finishes Kahan partial sums on the host.  All of that exists because
the TPU has no gather and Mosaic has no f64 (``kjma_pallas.py:1-47``).
Hopper has native f64 and indexed shared-memory loads, so the port
ships f64 (P, n_y) streams, an int32 index stream and the plain (n,)
f64 table, and each kernel reads its four taps by direct index
(``csrc/kjma_interp.cu``).

Four kernels, one per TPU kernel, each with a plain PyTorch version of the
same function beside its wrapper.  A wrapper given CPU tensors runs the
plain version (the CPU tests); given CUDA tensors it launches its kernel
or raises — it never falls back.  ``LAUNCHES`` counts kernel launches per
wrapper, so a run can show that it went through the kernels.  Under
``enable_nan_debugging`` a launch checks what it wrote, since the mode's
op-level check cannot see inside a kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from bdlz_tpu_torch.backend import F64, I32
from bdlz_tpu_torch.config import PointParams, StaticChoices
from bdlz_tpu_torch.constants import PI
from bdlz_tpu_torch.ops.kjma_table import Y_CLAMP, KJMATable, interp_taps
from bdlz_tpu_torch.physics.thermo import relativistic_density_coeff
from bdlz_tpu_torch.solvers.quadrature import linspace_rows, quadrature_bounds
from bdlz_tpu_torch.utils.profiling import check_kernel_output

#: Default tier: the in-kernel reduction (``kjma_pallas.REDUCE_DEFAULT``).
REDUCE_DEFAULT = True

SOURCE = "kjma_interp.cu"

#: Kernel launches per wrapper since the last ``reset_launches()``.
LAUNCHES = {"reduce": 0, "stream": 0, "fused_reduce": 0, "fused_stream": 0}

#: C entry point and the TPU kernel it replaces, per wrapper.
KERNELS = {
    "reduce": ("kjma_interp_reduce", "bdlz_tpu/ops/kjma_pallas.py:403"),
    "stream": ("kjma_interp_stream", "bdlz_tpu/ops/kjma_pallas.py:365"),
    "fused_reduce": ("kjma_interp_fused_reduce", "bdlz_tpu/ops/kjma_pallas.py:422"),
    "fused_stream": ("kjma_interp_fused_stream", "bdlz_tpu/ops/kjma_pallas.py:369"),
}

#: Dynamic shared memory one block may use on Hopper (227 KB), and the
#: kernel's reduction scratch beside the table (32 doubles).
SMEM_LIMIT_BYTES = 232448
_SCRATCH_BYTES = 32 * 8


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_digest() -> str:
    """What keys the kernels' numerics across a fleet: the library digest
    of their source and nvcc flags (the sweep agrees on it before a
    multi-process run computes)."""
    from bdlz_tpu_torch.ops._build import library_digest

    return library_digest(SOURCE)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (or reuse) and load the kernels' shared library."""
    from bdlz_tpu_torch.ops._build import build

    lib = ctypes.CDLL(str(build(SOURCE).path))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, _ in KERNELS.values():
        fn = getattr(lib, name)
        n_ptr = 5 if "fused" in name else 4  # g, [a,] i1, sfrac, table
        fn.argtypes = [p] * n_ptr + [i, i, i, p, i, p]
        fn.restype = i
    lib.kjma_error_string.argtypes = [i]
    lib.kjma_error_string.restype = ctypes.c_char_p
    return lib


# ---- plain versions ----------------------------------------------------

def interp_stream_plain(g, i1, sfrac, values):
    return g * interp_taps(i1, sfrac, values)


def interp_reduce_plain(g, i1, sfrac, values):
    return interp_stream_plain(g, i1, sfrac, values).sum(dim=-1)


def interp_fused_stream_plain(g, a, i1, sfrac, values):
    return g * torch.exp(a) * interp_taps(i1, sfrac, values)


def interp_fused_reduce_plain(g, a, i1, sfrac, values):
    return interp_fused_stream_plain(g, a, i1, sfrac, values).sum(dim=-1)


# ---- kernel wrappers ---------------------------------------------------

def _launch(name: str, reduce: bool, g, a, i1, sfrac, values) -> torch.Tensor:
    streams = [g, i1, sfrac] + ([a] if a is not None else [])
    dev = g.device
    for t in streams + [values]:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if g.dim() != 2 or any(t.shape != g.shape for t in streams):
        raise ValueError(f"{name}: streams must share one (P, n_y) shape")
    if any(t.dtype != F64 for t in (g, sfrac, values)) or i1.dtype != I32 or (
        a is not None and a.dtype != F64
    ):
        raise TypeError(f"{name}: streams and table are float64, i1 is int32")
    n_table = values.shape[0]
    if values.dim() != 1 or n_table < 4:
        raise ValueError(f"{name}: the table must be 1-D with >= 4 entries")
    if n_table * 8 + _SCRATCH_BYTES > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"{name}: a {n_table}-entry f64 table does not fit one block's "
            f"{SMEM_LIMIT_BYTES} B of shared memory"
        )
    P, n_y = g.shape
    out = torch.empty((P,) if reduce else (P, n_y), dtype=F64, device=dev)
    if P == 0 or n_y == 0:
        return out.zero_()
    lib = load_library()
    entry, _ = KERNELS[name]
    with torch.cuda.device(dev):
        n_blocks = min(P, torch.cuda.get_device_properties(dev).multi_processor_count)
        args = [g] + ([a] if a is not None else []) + [i1, sfrac, values]
        ptrs = [t.data_ptr() for t in args]
        err = getattr(lib, entry)(
            *ptrs, n_table, P, n_y, out.data_ptr(), n_blocks,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{entry} failed to launch: CUDA error {err} "
            f"({lib.kjma_error_string(err).decode()})"
        )
    LAUNCHES[name] += 1
    check_kernel_output(entry, out)
    return out


def interp_reduce(g, i1, sfrac, values) -> torch.Tensor:
    """K1: per point, Σ_j g·F(i1 + sfrac); (P,)."""
    if g.device.type == "cpu":
        return interp_reduce_plain(g, i1, sfrac, values)
    return _launch("reduce", True, g, None, i1, sfrac, values)


def interp_stream(g, i1, sfrac, values) -> torch.Tensor:
    """K2: per node, g·F(i1 + sfrac); (P, n_y)."""
    if g.device.type == "cpu":
        return interp_stream_plain(g, i1, sfrac, values)
    return _launch("stream", False, g, None, i1, sfrac, values)


def interp_fused_reduce(g, a, i1, sfrac, values) -> torch.Tensor:
    """K3: per point, Σ_j g·e^a·F(i1 + sfrac); (P,)."""
    if g.device.type == "cpu":
        return interp_fused_reduce_plain(g, a, i1, sfrac, values)
    return _launch("fused_reduce", True, g, a, i1, sfrac, values)


def interp_fused_stream(g, a, i1, sfrac, values) -> torch.Tensor:
    """K4: per node, g·e^a·F(i1 + sfrac); (P, n_y)."""
    if g.device.type == "cpu":
        return interp_fused_stream_plain(g, a, i1, sfrac, values)
    return _launch("fused_stream", False, g, a, i1, sfrac, values)


# ---- host side ---------------------------------------------------------

class KernelStreams(NamedTuple):
    """What the host prepares for one batch of points."""

    g: torch.Tensor            # ghat (unfused) or g2 (fused), (P, n_y), peak-normalised
    a: Optional[torch.Tensor]  # A − A_max per node (fused only), (P, n_y)
    i1: torch.Tensor           # table base index, int32 (P, n_y)
    sfrac: torch.Tensor        # fractional offset from i1, (P, n_y)
    scale: torch.Tensor        # KK·e^{A_max}·gscale, (P,)
    nonempty: torch.Tensor     # y_hi > y_lo, (P,) bool


def prepare_streams(
    pp: PointParams, chi_stats: str, table: KJMATable, n_y: int = 8000,
    fuse_exp: bool = False,
) -> KernelStreams:
    """The kernel's input streams for a (P,) batch (``kjma_pallas.py:597-692``).

    The map T = T_p·d^{-1/2} with d = 1 + 2y/(β/H) folds every power law
    into per-point scalars: on the relativistic branch n_eq·v̄·|dT/dy|/(s·H·T)
    collapses to a constant (the Hubble factors cancel against the β of the
    A/V prefactor), on the Maxwell–Boltzmann branch to one √d and the
    exponent −(m/T_p)√d.
    """
    n_y = max(int(n_y), 2000)
    y_lo, y_hi = quadrature_bounds(pp)
    ys = linspace_rows(y_lo, y_hi, n_y)

    B_safe = torch.clamp_min(pp.beta_over_H, 1e-30)
    d = torch.clamp_min(1.0 + 2.0 * ys / B_safe[:, None], 1e-12)
    sqrt_d = torch.sqrt(d)

    # --- per-point scalars ---
    g_chi = pp.g_chi
    c_n = relativistic_density_coeff(1.0, chi_stats) * g_chi
    m_eff = torch.clamp_min(pp.m_chi_GeV, 1e-20)  # mean-speed mass floor
    c_m = g_chi * (pp.m_chi_GeV / (2.0 * PI)) ** 1.5 * torch.sqrt(8.0 / (PI * m_eff))
    KK = (
        pp.P
        * pp.flux_scale
        * 0.25
        * c_n
        * (table.I_p / 2.0)
        * (45.0 / (2.0 * PI**2 * pp.g_star_s))
        / torch.clamp_min(pp.v_w, 1e-12)
    )
    bf_ratio = c_m / (c_n * pp.T_p_GeV)

    # --- merged exponent (one exp per node) ---
    sig = torch.clamp_min(pp.sigma_y, 1e-6)[:, None]
    yc = torch.clamp(ys, -Y_CLAMP, Y_CLAMP)
    aw = yc - (ys * ys) / (2.0 * sig * sig)
    # branch predicate T > m/3 as 3·T_p > m·√d; −m/T = −(m/T_p)·√d
    rel = 3.0 * pp.T_p_GeV[:, None] > pp.m_chi_GeV[:, None] * sqrt_d
    mb_arg = (pp.m_chi_GeV / pp.T_p_GeV)[:, None] * sqrt_d
    A = aw - torch.where(rel, 0.0, mb_arg)
    # analytic maximum of aw over the window: aw rises up to
    # min(σ², +clamp) and falls after, so the argmax is that point clipped
    # into [y_lo, y_hi], and its value applies the same e^y clamp
    y_star = torch.clamp(torch.clamp_max(sig[:, 0] ** 2, Y_CLAMP), y_lo, y_hi)
    A_max = torch.clamp(y_star, -Y_CLAMP, Y_CLAMP) - (y_star * y_star) / (
        2.0 * sig[:, 0] ** 2
    )

    bf = torch.where(rel, 1.0, bf_ratio[:, None] * sqrt_d)

    # trapezoid weights on the uniform grid, folded into the stream
    dy = (y_hi - y_lo) / (n_y - 1)
    w = torch.ones(n_y, dtype=F64, device=ys.device)
    w[0] = 0.5
    w[-1] = 0.5
    wtrap = w * dy[:, None]

    t = (yc - table.y0) * table.inv_dy
    n = table.values.shape[0]
    i1 = torch.clamp(torch.floor(t).to(I32), 1, n - 3)
    sfrac = t - i1

    if fuse_exp:
        g = bf * wtrap
        a = A - A_max[:, None]
    else:
        g = torch.exp(A - A_max[:, None]) * bf * wtrap
        a = None
    g = torch.where(ys > Y_CLAMP, 0.0, g)  # hard A/V = 0 cut (reference :159)
    gscale = torch.amax(torch.abs(g), dim=-1, keepdim=True)
    g = g / torch.clamp_min(gscale, 1e-300)
    return KernelStreams(
        g=g, a=a, i1=i1, sfrac=sfrac,
        scale=KK * torch.exp(A_max) * gscale[:, 0],
        nonempty=y_hi > y_lo,
    )


def finish(streams: KernelStreams, total: torch.Tensor) -> torch.Tensor:
    """Y_B per point from the kernel's sums (exactly 0 for an empty window)."""
    return torch.where(streams.nonempty, streams.scale * total, 0.0)


def integrate_YB_kernel(
    pp: PointParams, chi_stats: str, table: KJMATable, n_y: int = 8000, *,
    fuse_exp: bool = False, reduce: bool = REDUCE_DEFAULT,
) -> torch.Tensor:
    """Batched fast-path Y_B through the kernels (``integrate_YB_pallas``);
    ``pp`` holds (P,) tensors on the device the kernels run on."""
    st = prepare_streams(pp, chi_stats, table, n_y, fuse_exp)
    v = table.values
    if fuse_exp and reduce:
        total = interp_fused_reduce(st.g, st.a, st.i1, st.sfrac, v)
    elif fuse_exp:
        total = interp_fused_stream(st.g, st.a, st.i1, st.sfrac, v).sum(dim=-1)
    elif reduce:
        total = interp_reduce(st.g, st.i1, st.sfrac, v)
    else:
        total = interp_stream(st.g, st.i1, st.sfrac, v).sum(dim=-1)
    return finish(st, total)


def point_yields_kernel(
    pp: PointParams, static: StaticChoices, table: KJMATable, n_y: int = 8000,
    *, fuse_exp: bool = False, reduce: bool = REDUCE_DEFAULT,
):
    """Batched flagship pipeline on the kernel path (``point_yields_pallas``):
    the same YieldsResult fields and regime semantics as ``point_yields_fast``."""
    from bdlz_tpu_torch.models.yields_pipeline import (
        final_Y_chi_quadrature,
        present_day,
    )

    Y_B = integrate_YB_kernel(
        pp, static.chi_stats, table, n_y, fuse_exp=fuse_exp, reduce=reduce
    )
    Y_chi = final_Y_chi_quadrature(pp, static)
    return present_day(Y_B, Y_chi, pp.m_chi_GeV, pp.m_B_kg)
