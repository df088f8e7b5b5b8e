"""The sweep's KJMA interpolate-and-reduce hot loop on hand-written CUDA kernels.

Counterpart of ``bdlz_tpu/ops/kjma_pallas.py``.  Both keep the TPU
engine's algebra and its order: per point, every power law of the
integrand folds into closed-form scalars (``KK``, ``bf_ratio``); the A/V
e^{clamp(y)}, the Gaussian window and the Maxwell–Boltzmann exponent merge
into ONE exponent per node, normalised by its analytic per-point peak
``A_max``; the trapezoid weights fold into the node's value; and the
finish is ``Y_B = KK·e^{A_max}·Σ``, exactly 0 for an empty window.

Every tier runs the whole function in one kernel per point batch
(``csrc/kjma_point.cu``): the host computes K scalars per point
(:func:`point_scalars`, ~25 ops on (P,) tensors) and the kernel builds
every node's integrand in registers from them.  The reduce tiers (the
default, and ``fuse_exp``) return one f64 sum per point; the stream tiers
(``reduce=False``) return the (P, n_y) f64 integrand, which the host sums
per row, as JAX sums outside its kernel.

What was dropped, and why.  The Pallas engine runs the per-node prep
outside its kernel, casts the streams to f32 after a per-point peak
normalisation (``gscale``), splits the exponent into two f32 pieces
(``split_f64``), pads nodes into (ncol, 128) tiles (``_to_tiles``), ships
the table as a (512, 128) stencil-shifted transposed f32 matrix
(optionally a bf16x3 split of it) and finishes Kahan partial sums on the
host.  All of that exists because the TPU has no gather and Mosaic has no
f64 (``kjma_pallas.py:1-47``).  Hopper has native f64 and indexed
shared-memory loads, so the point kernels compute the f64 prep in
registers, with no cast and no normalisation, and read their four taps
from the plain (n,) f64 table by direct index.

Four kernels, one per tier, each with a plain PyTorch version of the same
function beside its wrapper.  A wrapper given CPU tensors runs the plain
version (the CPU tests); given CUDA tensors it launches its kernel or
raises — it never falls back.  ``LAUNCHES`` counts kernel launches per
wrapper, so a run can show that it went through the kernels.  Under
``enable_nan_debugging`` a launch checks what it wrote, since the mode's
op-level check cannot see inside a kernel.

The kernel engine's chunk step (:func:`kernel_step`) runs on one card as
one replay of a captured CUDA graph (:class:`ChunkGraph`, cached by
:func:`chunk_graph`, which the sweep's one-device step asks for): the ~70
small launches of the prep and the finish around the point kernel cost
the host more than the card's work.  ``GRAPH_STATS`` counts how often.
"""
from __future__ import annotations

import ctypes
import functools
import threading
import weakref
from collections import OrderedDict
from typing import NamedTuple, Optional

import torch

from bdlz_tpu_torch.backend import F64, I32
from bdlz_tpu_torch.config import PointParams, StaticChoices
from bdlz_tpu_torch.constants import PI
from bdlz_tpu_torch.ops.kjma_table import Y_CLAMP, KJMATable, interp_taps
from bdlz_tpu_torch.physics.thermo import relativistic_density_coeff
from bdlz_tpu_torch.solvers.quadrature import quadrature_bounds
from bdlz_tpu_torch.utils.profiling import check_kernel_output, nan_debugging_enabled, span

#: Default tier: the in-kernel reduction (``kjma_pallas.REDUCE_DEFAULT``).
REDUCE_DEFAULT = True

#: The point kernels' source.
POINT_SOURCE = "kjma_point.cu"

#: Kernel launches per wrapper since the last ``reset_launches()``.
LAUNCHES = {"point_reduce": 0, "point_fused_reduce": 0,
            "point_stream": 0, "point_fused_stream": 0}

#: C entry point and the TPU kernel it replaces, per wrapper.
KERNELS = {
    "point_reduce": ("kjma_point_reduce", "bdlz_tpu/ops/kjma_pallas.py:563 (+:403)"),
    "point_fused_reduce": ("kjma_point_fused_reduce",
                           "bdlz_tpu/ops/kjma_pallas.py:563 (+:422)"),
    "point_stream": ("kjma_point_stream", "bdlz_tpu/ops/kjma_pallas.py:563 (+:365)"),
    "point_fused_stream": ("kjma_point_fused_stream",
                           "bdlz_tpu/ops/kjma_pallas.py:563 (+:369)"),
}

#: Columns of :func:`point_scalars`' (P, K) block, in the order of
#: ``csrc/kjma_point.cu``'s ``Column``.  ``KK`` is read by the host's finish only.
POINT_COLUMNS = ("y_lo", "y_hi", "B_safe", "two_sig2", "three_Tp", "m",
                 "m_over_Tp", "bf_ratio", "A_max", "KK")
_COL = {name: i for i, name in enumerate(POINT_COLUMNS)}

#: The scheme's floor on the trapezoid's node count (``kjma_pallas.py:597``).
N_Y_FLOOR = 2000

#: Dynamic shared memory one block may use on Hopper (227 KB), and the
#: kernels' reduction scratch beside the table (one double per warp of
#: ``kjma_point.cu``'s 1024-thread block).
SMEM_LIMIT_BYTES = 232448
_SCRATCH_BYTES = 32 * 8


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_digest() -> str:
    """What keys the kernels' numerics across a fleet: 16 hex digits over
    the point kernels' source and its nvcc flags (the sweep agrees on it
    before a multi-process run computes)."""
    from bdlz_tpu_torch.ops._build import library_digest

    return library_digest(POINT_SOURCE)


@functools.lru_cache(maxsize=None)
def load_point_library() -> ctypes.CDLL:
    """Build (or reuse) and load the point kernels' shared library."""
    from bdlz_tpu_torch.ops._build import build

    lib = ctypes.CDLL(str(build(POINT_SOURCE).path))
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for entry, _ in KERNELS.values():
        fn = getattr(lib, entry)
        # scalars, n_cols, table, n_table, y0, inv_dy, n_points, n_y, out, n_blocks, stream
        fn.argtypes = [p, i, p, i, d, d, i, i, p, i, p]
        fn.restype = i
    lib.kjma_point_error_string.argtypes = [i]
    lib.kjma_point_error_string.restype = ctypes.c_char_p
    return lib


# ---- plain versions ----------------------------------------------------

#: Nodes per slice of the point kernels' plain versions: (P, n_y)
#: intermediates are built a slice of rows at a time.
_PLAIN_NODES_PER_SLICE = 1 << 22


def _n_nodes(n_y) -> int:
    return max(int(n_y), N_Y_FLOOR)


def _point_rows_plain(s: torch.Tensor, table: KJMATable, n_y: int, fused: bool):
    """The point kernel's node values for rows ``s``, (R, n_y); rows of
    empty windows are 0."""
    nd = _nodes(s, table, n_y)
    e = torch.exp(nd.a)
    g = nd.bf * nd.w * e if fused else e * nd.bf * nd.w
    v = g * interp_taps(nd.i1, nd.sfrac, table.values)
    v = torch.where(nd.y > Y_CLAMP, 0.0, v)  # hard A/V = 0 cut (reference :159)
    return torch.where((s[:, _COL["y_hi"]] > s[:, _COL["y_lo"]])[:, None], v, 0.0)


def _point_plain(scalars, table: KJMATable, n_y, fused: bool, reduce: bool) -> torch.Tensor:
    """A point kernel's plain version: per point the sum over the nodes
    (``reduce``, (P,)) or every node (P, n_y), built a slice of rows at
    a time."""
    n_y = _n_nodes(n_y)
    rows = max(1, _PLAIN_NODES_PER_SLICE // n_y)
    parts = []
    for i in range(0, scalars.shape[0], rows):
        v = _point_rows_plain(scalars[i:i + rows], table, n_y, fused)
        parts.append(v.sum(dim=-1) if reduce else v)
    if not parts:
        return torch.zeros((0,) if reduce else (0, n_y), dtype=F64, device=scalars.device)
    return torch.cat(parts)


def point_reduce_plain(scalars, table: KJMATable, n_y) -> torch.Tensor:
    return _point_plain(scalars, table, n_y, fused=False, reduce=True)


def point_fused_reduce_plain(scalars, table: KJMATable, n_y) -> torch.Tensor:
    return _point_plain(scalars, table, n_y, fused=True, reduce=True)


def point_stream_plain(scalars, table: KJMATable, n_y) -> torch.Tensor:
    return _point_plain(scalars, table, n_y, fused=False, reduce=False)


def point_fused_stream_plain(scalars, table: KJMATable, n_y) -> torch.Tensor:
    return _point_plain(scalars, table, n_y, fused=True, reduce=False)


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


def _launched(name: str, entry: str, err: int, error_string, out: torch.Tensor,
              captured: bool = False):
    """Raise on a refused launch; else count it and check what it wrote.
    A launch ``captured`` (its stream was capturing) into a
    :class:`ChunkGraph` runs only when the graph replays: the capture
    records it, and each replay counts it."""
    if err != 0:
        raise RuntimeError(
            f"{entry} failed to launch: CUDA error {err} ({error_string(err).decode()})"
        )
    if captured:
        recorded = getattr(_CAPTURE, "launches", None)
        if recorded is None:
            raise RuntimeError(f"{entry} launched into a capture that is not a chunk "
                               "graph's: its replays would go uncounted")
        recorded[name] += 1
        return out
    LAUNCHES[name] += 1
    check_kernel_output(entry, out)
    return out


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
    P, n_y = scalars.shape[0], _n_nodes(n_y)
    out = torch.empty((P,) if name.endswith("reduce") else (P, n_y), dtype=F64, device=dev)
    if P == 0:
        return out
    lib = load_point_library()
    entry, _ = KERNELS[name]
    with torch.cuda.device(dev):
        n_blocks = min(P, torch.cuda.get_device_properties(dev).multi_processor_count)
        err = getattr(lib, entry)(
            scalars.data_ptr(), scalars.shape[1], values.data_ptr(), n_table,
            float(table.y0), float(table.inv_dy), P, n_y, out.data_ptr(),
            n_blocks, torch.cuda.current_stream(dev).cuda_stream,
        )
        # the launch's own stream, which need not be the current device's
        captured = torch.cuda.is_current_stream_capturing()
    return _launched(name, entry, err, lib.kjma_point_error_string, out, captured)


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


def point_stream(scalars, table: KJMATable, n_y) -> torch.Tensor:
    """Per point and node, e^{A−A_max}·bf·w·F over the window's n_y nodes
    (0 past the cut and for an empty window), from :func:`point_scalars`'
    rows; (P, max(n_y, 2000))."""
    if scalars.device.type == "cpu":
        return point_stream_plain(scalars, table, n_y)
    return _launch_point("point_stream", scalars, table, n_y)


def point_fused_stream(scalars, table: KJMATable, n_y) -> torch.Tensor:
    """:func:`point_stream` in the fused tier's order, (bf·w)·e^{A−A_max}·F;
    (P, max(n_y, 2000))."""
    if scalars.device.type == "cpu":
        return point_fused_stream_plain(scalars, table, n_y)
    return _launch_point("point_fused_stream", scalars, table, n_y)


# ---- host side ---------------------------------------------------------

def point_scalars(pp: PointParams, chi_stats: str, table: KJMATable,
                  n_y: int = 8000) -> torch.Tensor:
    """The per-point scalars of ``POINT_COLUMNS`` for a (P,) batch, as one
    contiguous (P, K) float64 block: the point kernels' input, and the
    per-point half of the TPU engine's prep (``kjma_pallas.py:597-692``).

    The map T = T_p·d^{-1/2} with d = 1 + 2y/(β/H) folds every power law
    into per-point scalars: on the relativistic branch n_eq·v̄·|dT/dy|/(s·H·T)
    collapses to a constant (the Hubble factors cancel against the β of the
    A/V prefactor), on the Maxwell–Boltzmann branch to one √d and the
    exponent −(m/T_p)√d.  An empty window (y_hi <= y_lo) is collapsed to
    its lower end, so that none of the plain version's nodes can overflow;
    its Y_B is 0 all the same.
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


def point_finish(scalars: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """Y_B per point from the point kernel's sums (exactly 0 for an empty window)."""
    s = scalars
    nonempty = s[:, _COL["y_hi"]] > s[:, _COL["y_lo"]]
    return torch.where(nonempty, s[:, _COL["KK"]] * torch.exp(s[:, _COL["A_max"]]) * total, 0.0)


def integrate_YB_kernel(
    pp: PointParams, chi_stats: str, table: KJMATable, n_y: int = 8000, *,
    fuse_exp: bool = False, reduce: bool = REDUCE_DEFAULT,
) -> torch.Tensor:
    """Batched fast-path Y_B through the kernels (``integrate_YB_pallas``);
    ``pp`` holds (P,) tensors on the device the kernels run on.  Every
    tier runs its point kernel on :func:`point_scalars`; the stream tiers'
    kernels write the (P, n_y) integrand, which is summed here per row."""
    s = point_scalars(pp, chi_stats, table, n_y)
    if reduce:
        total = (point_fused_reduce if fuse_exp else point_reduce)(s, table, n_y)
    else:
        total = (point_fused_stream if fuse_exp else point_stream)(s, table, n_y).sum(dim=-1)
    return point_finish(s, total)


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


# ---- the chunk step as one CUDA graph ------------------------------------

#: How the kernel engine's chunk steps ran since the last
#: ``reset_graph_stats()``: graphs captured, chunks replayed (a capture's
#: own chunk included), and steps run eagerly.
GRAPH_STATS = {"captures": 0, "replays": 0, "eager": 0}

#: Captured graphs a process keeps; the least recently used goes first.
#: A sweep uses one key, ``torch_tier_chunk_ms.py`` and the impl shoot-out
#: one per tier (four).
GRAPH_CACHE_SIZE = 8

#: Keys seen once and not captured that a process remembers.
SEEN_KEYS = 64

_GRAPHS: "OrderedDict[tuple, ChunkGraph]" = OrderedDict()
_SEEN: "OrderedDict[tuple, None]" = OrderedDict()
_GRAPHS_LOCK = threading.Lock()
_CAPTURE = threading.local()  # .launches: what the capture under way launched


def reset_graph_stats() -> None:
    for k in GRAPH_STATS:
        GRAPH_STATS[k] = 0


def clear_graphs() -> None:
    """Drop every cached graph with its device buffers, and the keys seen."""
    with _GRAPHS_LOCK:
        _GRAPHS.clear()
        _SEEN.clear()


def tier_kernel(fuse_exp: bool, reduce: bool) -> str:
    """The wrapper, and ``LAUNCHES`` key, of a tier's point kernel."""
    return ("point_fused_" if fuse_exp else "point_") + ("reduce" if reduce else "stream")


def graph_route(device, n_points: int) -> bool:
    """Whether a one-device chunk step of the kernel engine may run as a
    replayed CUDA graph: on a CUDA device, with NaN debugging off (it
    checks every op), for a non-empty chunk.  Everything else runs the
    eager step; so does the mesh, whose members run on streams of their
    own and never ask."""
    return (torch.device(device).type == "cuda" and not nan_debugging_enabled()
            and int(n_points) > 0)


def graph_key(device, n_points: int, n_y: int, fuse_exp: bool, reduce: bool,
              static: StaticChoices, table: KJMATable, stream: int, thread: int) -> tuple:
    """Everything a capture bakes in: the device, the padded chunk's
    length, the node count, the tier, the ``StaticChoices`` fields the
    step reads, the table's length and the scalars that reach the kernels
    as Python numbers, and the stream and thread whose buffers the graph
    owns.  Never the points' values."""
    dev = torch.device(device)
    return (dev.type, dev.index, int(n_points), _n_nodes(n_y), bool(fuse_exp), bool(reduce),
            static.chi_stats, static.regime, float(table.I_p), float(table.y0),
            float(table.inv_dy), int(table.values.shape[0]), int(stream), int(thread))


class ChunkGraph:
    """The kernel engine's chunk step on one device, captured as a CUDA
    graph: from a (17, P) block of PointParams rows (the sweep's pinned
    staging layout) and its own copy of the F table, :func:`point_scalars`,
    the tier's point kernel, :func:`point_finish`, the Y_χ quadrature and
    ``present_day``, stacked into a (5, P) block of YieldsResult rows.

    The blocks and the table are the graph's own: a caller fills
    :attr:`inputs` and enqueues the copy back of :meth:`run`'s block on
    the current stream before the next run, which stream order then
    keeps from overwriting either early."""

    def __init__(self, device, n_points: int, n_y: int, static: StaticChoices,
                 table: KJMATable, fuse_exp: bool, reduce: bool):
        from bdlz_tpu_torch.models.yields_pipeline import YieldsResult

        self.device = torch.device(device)
        self.inputs = torch.empty((len(PointParams._fields), n_points), dtype=F64,
                                  device=self.device)
        self.out = torch.empty((len(YieldsResult._fields), n_points), dtype=F64,
                               device=self.device)
        self.kernel = tier_kernel(fuse_exp, reduce)
        self._table = table._replace(values=torch.empty(
            table.values.shape, dtype=table.values.dtype, device=self.device))
        self._loaded = (None, -1)  # (weak reference, version) of the table copied in
        self._args = (static, n_y, fuse_exp, reduce)
        self._graph = None
        self._launches = {}  # per replay, what the capture launched

    def _compute(self) -> None:
        static, n_y, fuse_exp, reduce = self._args
        res = point_yields_kernel(PointParams(*self.inputs.unbind(0)), static, self._table,
                                  n_y, fuse_exp=fuse_exp, reduce=reduce)
        torch.stack(list(res), out=self.out)

    def _capture(self) -> None:
        """Capture the step on a stream of the graph's own device (torch's
        shared capture stream belongs to the device of the process's first
        capture), recording the kernels it launches: exactly one of the
        tier's.  The step ran eagerly on this key before, which warmed it
        up and opted the kernel into its shared memory."""
        graph = torch.cuda.CUDAGraph()
        launches = _CAPTURE.launches = dict.fromkeys(LAUNCHES, 0)
        try:
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(self.device),
                                  capture_error_mode="thread_local"):
                self._compute()
        finally:
            _CAPTURE.launches = None
        launched = {k: n for k, n in launches.items() if n}
        if launched != {self.kernel: 1}:
            raise RuntimeError(f"the chunk graph captured {launched}, "
                               f"not one launch of {self.kernel}")
        self._graph, self._launches = graph, launched
        GRAPH_STATS["captures"] += 1

    def _load_table(self, values: torch.Tensor) -> None:
        """Copy the table in when it is another tensor than the last one,
        or that one was written since: the graph never reads the caller's."""
        ref, version = self._loaded
        if ref is None or ref() is not values or values._version != version:
            self._table.values.copy_(values)
            self._loaded = (weakref.ref(values), values._version)

    def run(self, table: KJMATable) -> torch.Tensor:
        """The chunk in :attr:`inputs` through the step, on the current
        stream: the (5, P) output block.  The first run captures the
        graph; every run replays it and counts the launches it holds."""
        with torch.cuda.device(self.device):
            self._load_table(table.values)
            if self._graph is None:
                self._capture()
            with span("chunk.replay"):
                self._graph.replay()
        for name, n in self._launches.items():
            LAUNCHES[name] += n
        GRAPH_STATS["replays"] += 1
        return self.out


def kernel_step(static: StaticChoices, n_y: int, fuse_exp: bool, reduce: bool):
    """The kernel engine's chunk step run eagerly: ``step(pp, table) ->
    YieldsResult`` (:func:`point_yields_kernel`), each call counted in
    ``GRAPH_STATS["eager"]``."""
    def step(pp: PointParams, table: KJMATable):
        GRAPH_STATS["eager"] += 1
        return point_yields_kernel(pp, static, table, n_y, fuse_exp=fuse_exp, reduce=reduce)
    return step


def chunk_graph(n_points: int, device, table: KJMATable, static: StaticChoices, n_y: int,
                fuse_exp: bool, reduce: bool) -> Optional[ChunkGraph]:
    """The graph that runs :func:`kernel_step`'s padded chunk of
    ``n_points`` on ``device`` with ``table``, from this process's cache.
    None off the route, for a table on another device (the eager step
    refuses it), and the first time a key is seen: that chunk runs
    eagerly and builds nothing, so a shape used once (an emulator round,
    a gate's population) never pays a capture."""
    dev = torch.device(device)
    if not graph_route(dev, n_points):
        return None
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if table.values.device != dev:
        return None
    key = graph_key(dev, n_points, n_y, fuse_exp, reduce, static, table,
                    torch.cuda.current_stream(dev).cuda_stream, threading.get_ident())
    with _GRAPHS_LOCK:
        g = _GRAPHS.get(key)
        if g is not None:
            _GRAPHS.move_to_end(key)
            return g
        if key not in _SEEN:
            _SEEN[key] = None
            while len(_SEEN) > SEEN_KEYS:
                _SEEN.popitem(last=False)
            return None
        del _SEEN[key]
        g = _GRAPHS[key] = ChunkGraph(dev, n_points, n_y, static, table, fuse_exp, reduce)
        while len(_GRAPHS) > GRAPH_CACHE_SIZE:
            _GRAPHS.popitem(last=False)
    return g
