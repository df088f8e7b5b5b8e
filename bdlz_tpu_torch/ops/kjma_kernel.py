"""The sweep's KJMA interpolate-and-reduce hot loop on hand-written CUDA kernels.

Counterpart of ``bdlz_tpu/ops/kjma_pallas.py``.  Both keep the TPU
engine's algebra and its order: per point, every power law of the
integrand folds into closed-form scalars (``KK``, ``bf_ratio``); the A/V
e^{clamp(y)}, the Gaussian window and the Maxwell–Boltzmann exponent merge
into ONE exponent per node, normalised by its analytic per-point peak
``A_max``; the trapezoid weights fold into the node's value; and the
finish is ``Y_B = KK·e^{A_max}·Σ``, exactly 0 for an empty window.

The reduce tiers (the default, and ``fuse_exp``) run the whole function
in one kernel per point batch (``csrc/kjma_point.cu``): the host computes
K scalars per point (:func:`point_scalars`, ~25 ops on (P,) tensors), the
kernel builds every node's integrand in registers from them and returns
one f64 sum per point.  The stream tiers (``reduce=False``) keep the TPU
engine's split: the host prepares (P, n_y) streams (:func:`prepare_streams`)
and a kernel of ``csrc/kjma_interp.cu`` interpolates and multiplies them.

What was dropped, and why.  The Pallas engine runs the per-node prep
outside its kernel, casts the streams to f32 after a per-point peak
normalisation (``gscale``), splits the exponent into two f32 pieces
(``split_f64``), pads nodes into (ncol, 128) tiles (``_to_tiles``), ships
the table as a (512, 128) stencil-shifted transposed f32 matrix
(optionally a bf16x3 split of it) and finishes Kahan partial sums on the
host.  All of that exists because the TPU has no gather and Mosaic has no
f64 (``kjma_pallas.py:1-47``).  Hopper has native f64 and indexed
shared-memory loads, so the point kernels compute the f64 prep in
registers, with no cast and no normalisation; the stream kernels read f64
(P, n_y) streams and an int32 index stream; every kernel reads its four
taps from the plain (n,) f64 table by direct index.

Six kernels, each with a plain PyTorch version of the same function beside
its wrapper.  A wrapper given CPU tensors runs the plain version (the CPU
tests); given CUDA tensors it launches its kernel or raises — it never
falls back.  ``LAUNCHES`` counts kernel launches per wrapper, so a run can
show that it went through the kernels.  Under ``enable_nan_debugging`` a
launch checks what it wrote, since the mode's op-level check cannot see
inside a kernel.
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
from bdlz_tpu_torch.solvers.quadrature import quadrature_bounds
from bdlz_tpu_torch.utils.profiling import check_kernel_output

#: Default tier: the in-kernel reduction (``kjma_pallas.REDUCE_DEFAULT``).
REDUCE_DEFAULT = True

#: The stream-input kernels (K1-K4) and the point kernels.
SOURCE = "kjma_interp.cu"
POINT_SOURCE = "kjma_point.cu"

#: Kernel launches per wrapper since the last ``reset_launches()``.
LAUNCHES = {"reduce": 0, "stream": 0, "fused_reduce": 0, "fused_stream": 0,
            "point_reduce": 0, "point_fused_reduce": 0}

#: C entry point and the TPU kernel it replaces, per wrapper.
KERNELS = {
    "reduce": ("kjma_interp_reduce", "bdlz_tpu/ops/kjma_pallas.py:403"),
    "stream": ("kjma_interp_stream", "bdlz_tpu/ops/kjma_pallas.py:365"),
    "fused_reduce": ("kjma_interp_fused_reduce", "bdlz_tpu/ops/kjma_pallas.py:422"),
    "fused_stream": ("kjma_interp_fused_stream", "bdlz_tpu/ops/kjma_pallas.py:369"),
    "point_reduce": ("kjma_point_reduce", "bdlz_tpu/ops/kjma_pallas.py:563 (+:403)"),
    "point_fused_reduce": ("kjma_point_fused_reduce",
                           "bdlz_tpu/ops/kjma_pallas.py:563 (+:422)"),
}
STREAM_KERNELS = ("reduce", "stream", "fused_reduce", "fused_stream")

#: Columns of :func:`point_scalars`' (P, K) block, in the order of
#: ``csrc/kjma_point.cu``'s ``Column``.  ``KK`` is read by the host's finish only.
POINT_COLUMNS = ("y_lo", "y_hi", "B_safe", "two_sig2", "three_Tp", "m",
                 "m_over_Tp", "bf_ratio", "A_max", "KK")
_COL = {name: i for i, name in enumerate(POINT_COLUMNS)}

#: The scheme's floor on the trapezoid's node count (``kjma_pallas.py:597``).
N_Y_FLOOR = 2000

#: Dynamic shared memory one block may use on Hopper (227 KB), and the
#: kernels' reduction scratch beside the table (one double per warp of
#: ``kjma_point.cu``'s 1024-thread block; ``kjma_interp.cu`` uses fewer).
SMEM_LIMIT_BYTES = 232448
_SCRATCH_BYTES = 32 * 8


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_digest() -> str:
    """What keys the kernels' numerics across a fleet: 16 hex digits over
    the library digests of both sources and their nvcc flags (the sweep
    agrees on it before a multi-process run computes)."""
    import hashlib

    from bdlz_tpu_torch.ops._build import library_digest

    both = library_digest(SOURCE) + library_digest(POINT_SOURCE)
    return hashlib.sha256(both.encode()).hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (or reuse) and load the kernels' shared library."""
    from bdlz_tpu_torch.ops._build import build

    lib = ctypes.CDLL(str(build(SOURCE).path))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, _ in (KERNELS[k] for k in STREAM_KERNELS):
        fn = getattr(lib, name)
        n_ptr = 5 if "fused" in name else 4  # g, [a,] i1, sfrac, table
        fn.argtypes = [p] * n_ptr + [i, i, i, p, i, p]
        fn.restype = i
    lib.kjma_error_string.argtypes = [i]
    lib.kjma_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_point_library() -> ctypes.CDLL:
    """Build (or reuse) and load the point kernels' shared library."""
    from bdlz_tpu_torch.ops._build import build

    lib = ctypes.CDLL(str(build(POINT_SOURCE).path))
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for k in ("point_reduce", "point_fused_reduce"):
        fn = getattr(lib, KERNELS[k][0])
        # scalars, n_cols, table, n_table, y0, inv_dy, n_points, n_y, out, n_blocks, stream
        fn.argtypes = [p, i, p, i, d, d, i, i, p, i, p]
        fn.restype = i
    lib.kjma_point_error_string.argtypes = [i]
    lib.kjma_point_error_string.restype = ctypes.c_char_p
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


#: Nodes per slice of the point kernels' plain versions: (P, n_y)
#: intermediates are built a slice of rows at a time.
_PLAIN_NODES_PER_SLICE = 1 << 22


def _n_nodes(n_y) -> int:
    return max(int(n_y), N_Y_FLOOR)


def _point_rows_plain(s: torch.Tensor, table: KJMATable, n_y: int, fused: bool):
    """The point kernel's sums for rows ``s``, on (R, n_y) tensors."""
    nd = _nodes(s, table, n_y)
    e = torch.exp(nd.a)
    g = nd.bf * nd.w * e if fused else e * nd.bf * nd.w
    v = g * interp_taps(nd.i1, nd.sfrac, table.values)
    v = torch.where(nd.y > Y_CLAMP, 0.0, v)  # hard A/V = 0 cut (reference :159)
    return torch.where(s[:, _COL["y_hi"]] > s[:, _COL["y_lo"]], v.sum(dim=-1), 0.0)


def _point_sums_plain(scalars, table: KJMATable, n_y, fused: bool) -> torch.Tensor:
    n_y = _n_nodes(n_y)
    rows = max(1, _PLAIN_NODES_PER_SLICE // n_y)
    parts = [_point_rows_plain(scalars[i:i + rows], table, n_y, fused)
             for i in range(0, scalars.shape[0], rows)]
    if not parts:
        return torch.zeros(0, dtype=F64, device=scalars.device)
    return torch.cat(parts)


def point_reduce_plain(scalars, table: KJMATable, n_y) -> torch.Tensor:
    return _point_sums_plain(scalars, table, n_y, fused=False)


def point_fused_reduce_plain(scalars, table: KJMATable, n_y) -> torch.Tensor:
    return _point_sums_plain(scalars, table, n_y, fused=True)


# ---- kernel wrappers ---------------------------------------------------

def _table_entries(name: str, values) -> int:
    """The table's length, once it is known to fit one block's shared memory."""
    n_table = values.shape[0]
    if values.dim() != 1 or n_table < 4:
        raise ValueError(f"{name}: the table must be 1-D with >= 4 entries")
    if n_table * 8 + _SCRATCH_BYTES > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"{name}: a {n_table}-entry f64 table does not fit one block's "
            f"{SMEM_LIMIT_BYTES} B of shared memory"
        )
    return n_table


def _launched(name: str, entry: str, err: int, error_string, out: torch.Tensor):
    """Raise on a refused launch; else count it and check what it wrote."""
    if err != 0:
        raise RuntimeError(
            f"{entry} failed to launch: CUDA error {err} ({error_string(err).decode()})"
        )
    LAUNCHES[name] += 1
    check_kernel_output(entry, out)
    return out


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
    n_table = _table_entries(name, values)
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
    return _launched(name, entry, err, lib.kjma_error_string, out)


def _launch_point(name: str, scalars, table: KJMATable, n_y) -> torch.Tensor:
    values = table.values
    dev = scalars.device
    if values.device != dev:
        raise ValueError(f"{name}: the table must be on {dev}, got {values.device}")
    if not (scalars.is_contiguous() and values.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if scalars.dtype != F64 or values.dtype != F64:
        raise TypeError(f"{name}: the scalars and the table are float64")
    if scalars.dim() != 2 or scalars.shape[1] != len(POINT_COLUMNS):
        raise ValueError(f"{name}: the scalars must be (P, {len(POINT_COLUMNS)})")
    n_table = _table_entries(name, values)
    P = scalars.shape[0]
    out = torch.empty(P, dtype=F64, device=dev)
    if P == 0:
        return out
    lib = load_point_library()
    entry, _ = KERNELS[name]
    with torch.cuda.device(dev):
        n_blocks = min(P, torch.cuda.get_device_properties(dev).multi_processor_count)
        err = getattr(lib, entry)(
            scalars.data_ptr(), scalars.shape[1], values.data_ptr(), n_table,
            float(table.y0), float(table.inv_dy), P, _n_nodes(n_y), out.data_ptr(),
            n_blocks, torch.cuda.current_stream(dev).cuda_stream,
        )
    return _launched(name, entry, err, lib.kjma_point_error_string, out)


def point_reduce(scalars, table: KJMATable, n_y) -> torch.Tensor:
    """Per point, the trapezoid sum of e^{A−A_max}·bf·w·F over the window's
    n_y nodes, from :func:`point_scalars`' rows; (P,)."""
    if scalars.device.type == "cpu":
        return point_reduce_plain(scalars, table, n_y)
    return _launch_point("point_reduce", scalars, table, n_y)


def point_fused_reduce(scalars, table: KJMATable, n_y) -> torch.Tensor:
    """:func:`point_reduce` in the fused tier's order, (bf·w)·e^{A−A_max}·F; (P,)."""
    if scalars.device.type == "cpu":
        return point_fused_reduce_plain(scalars, table, n_y)
    return _launch_point("point_fused_reduce", scalars, table, n_y)


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


def point_scalars(pp: PointParams, chi_stats: str, table: KJMATable,
                  n_y: int = 8000) -> torch.Tensor:
    """The per-point scalars of ``POINT_COLUMNS`` for a (P,) batch, as one
    contiguous (P, K) float64 block: the point kernels' input, and the
    per-point half of :func:`prepare_streams` (``kjma_pallas.py:597-692``).

    The map T = T_p·d^{-1/2} with d = 1 + 2y/(β/H) folds every power law
    into per-point scalars: on the relativistic branch n_eq·v̄·|dT/dy|/(s·H·T)
    collapses to a constant (the Hubble factors cancel against the β of the
    A/V prefactor), on the Maxwell–Boltzmann branch to one √d and the
    exponent −(m/T_p)√d.  An empty window (y_hi <= y_lo) is collapsed to
    its lower end, so that none of its nodes can overflow; its Y_B is 0
    all the same.
    """
    n_y = _n_nodes(n_y)
    y_lo, y_hi = quadrature_bounds(pp)
    y_hi = torch.where(y_hi > y_lo, y_hi, y_lo)

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
    # analytic maximum of the merged exponent's window part over the
    # window: it rises up to min(σ², +clamp) and falls after, so the argmax
    # is that point clipped into [y_lo, y_hi], and its value applies the
    # same e^y clamp
    sig = torch.clamp_min(pp.sigma_y, 1e-6)
    y_star = torch.clamp(torch.clamp_max(sig ** 2, Y_CLAMP), y_lo, y_hi)
    A_max = torch.clamp(y_star, -Y_CLAMP, Y_CLAMP) - (y_star * y_star) / (2.0 * sig ** 2)
    columns = {
        "y_lo": y_lo, "y_hi": y_hi,
        "B_safe": torch.clamp_min(pp.beta_over_H, 1e-30), "two_sig2": 2.0 * sig * sig,
        "three_Tp": 3.0 * pp.T_p_GeV, "m": pp.m_chi_GeV, "m_over_Tp": pp.m_chi_GeV / pp.T_p_GeV,
        "bf_ratio": c_m / (c_n * pp.T_p_GeV), "A_max": A_max, "KK": KK,
    }
    return torch.stack([columns[c] for c in POINT_COLUMNS], dim=1).contiguous()


class _Nodes(NamedTuple):
    """The per-node terms of rows of :func:`point_scalars`, (R, n_y) each."""

    y: torch.Tensor      # the node
    a: torch.Tensor      # A − A_max, the merged exponent below its peak
    bf: torch.Tensor     # 1 (T > m/3) or bf_ratio·√d (Maxwell–Boltzmann)
    w: torch.Tensor      # the trapezoid weight
    i1: torch.Tensor     # table base index, int32
    sfrac: torch.Tensor  # fractional offset from i1


def _nodes(s: torch.Tensor, table: KJMATable, n_y: int) -> _Nodes:
    """The node arithmetic the point kernel does in registers
    (``csrc/kjma_point.cu``), in its order."""
    def col(name):
        return s[:, _COL[name], None]

    # a true division on every device, as the kernel divides (a divisor
    # held as a Python number may become a reciprocal multiply on CUDA)
    y_lo = col("y_lo")
    dy = (col("y_hi") - y_lo) / torch.full_like(y_lo, n_y - 1)
    y = torch.arange(n_y, dtype=F64, device=s.device) * dy + y_lo
    y[:, -1] = s[:, _COL["y_hi"]]
    d = torch.clamp_min(1.0 + 2.0 * y / col("B_safe"), 1e-12)
    sqrt_d = torch.sqrt(d)
    yc = torch.clamp(y, -Y_CLAMP, Y_CLAMP)
    aw = yc - (y * y) / col("two_sig2")
    # branch predicate T > m/3 as 3·T_p > m·√d; −m/T = −(m/T_p)·√d
    rel = col("three_Tp") > col("m") * sqrt_d
    A = aw - torch.where(rel, 0.0, col("m_over_Tp") * sqrt_d)
    w = torch.ones(n_y, dtype=F64, device=s.device)
    w[0] = 0.5
    w[-1] = 0.5
    t = (yc - table.y0) * table.inv_dy
    i1 = torch.clamp(torch.floor(t).to(I32), 1, table.values.shape[0] - 3)
    return _Nodes(y=y, a=A - col("A_max"),
                  bf=torch.where(rel, 1.0, col("bf_ratio") * sqrt_d),
                  w=w * dy, i1=i1, sfrac=t - i1)


def prepare_streams(
    pp: PointParams, chi_stats: str, table: KJMATable, n_y: int = 8000,
    fuse_exp: bool = False,
) -> KernelStreams:
    """The stream kernels' input streams for a (P,) batch: the node terms
    of :func:`point_scalars`' rows, with the trapezoid weights folded in
    and each point's stream normalised by its peak (``gscale``), as the
    TPU engine ships them (``kjma_pallas.py:597-692``)."""
    n_y = _n_nodes(n_y)
    s = point_scalars(pp, chi_stats, table, n_y)
    nd = _nodes(s, table, n_y)
    if fuse_exp:
        g = nd.bf * nd.w
        a = nd.a
    else:
        g = torch.exp(nd.a) * nd.bf * nd.w
        a = None
    g = torch.where(nd.y > Y_CLAMP, 0.0, g)  # hard A/V = 0 cut (reference :159)
    gscale = torch.amax(torch.abs(g), dim=-1, keepdim=True)
    g = g / torch.clamp_min(gscale, 1e-300)
    return KernelStreams(
        g=g, a=a, i1=nd.i1, sfrac=nd.sfrac,
        scale=s[:, _COL["KK"]] * torch.exp(s[:, _COL["A_max"]]) * gscale[:, 0],
        nonempty=s[:, _COL["y_hi"]] > s[:, _COL["y_lo"]],
    )


def point_finish(scalars: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """Y_B per point from the point kernel's sums (exactly 0 for an empty window)."""
    s = scalars
    nonempty = s[:, _COL["y_hi"]] > s[:, _COL["y_lo"]]
    return torch.where(nonempty, s[:, _COL["KK"]] * torch.exp(s[:, _COL["A_max"]]) * total, 0.0)


def finish(streams: KernelStreams, total: torch.Tensor) -> torch.Tensor:
    """Y_B per point from the kernel's sums (exactly 0 for an empty window)."""
    return torch.where(streams.nonempty, streams.scale * total, 0.0)


def integrate_YB_kernel(
    pp: PointParams, chi_stats: str, table: KJMATable, n_y: int = 8000, *,
    fuse_exp: bool = False, reduce: bool = REDUCE_DEFAULT,
) -> torch.Tensor:
    """Batched fast-path Y_B through the kernels (``integrate_YB_pallas``);
    ``pp`` holds (P,) tensors on the device the kernels run on.  The
    reduce tiers run the point kernels on :func:`point_scalars`; the
    stream tiers run K2/K4 on :func:`prepare_streams` and sum on the host."""
    if reduce:
        s = point_scalars(pp, chi_stats, table, n_y)
        total = (point_fused_reduce if fuse_exp else point_reduce)(s, table, n_y)
        return point_finish(s, total)
    st = prepare_streams(pp, chi_stats, table, n_y, fuse_exp)
    v = table.values
    if fuse_exp:
        total = interp_fused_stream(st.g, st.a, st.i1, st.sfrac, v).sum(dim=-1)
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
