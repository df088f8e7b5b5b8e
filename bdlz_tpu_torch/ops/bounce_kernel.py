"""The O(4) bounce shoot on hand-written CUDA kernels: a depth-k bisection
tree per lane.

The JAX package runs the shoot as one jitted XLA program per lane width
(``bdlz_tpu/bounce/shooting.py:105``, ``_bounce_program``): a
``fori_loop`` of bisection halvings, each a ``while_loop`` over segments,
each a full adaptive ESDIRK solve, then an RK4 ``scan``.  That is about
45,000 sequential attempted steps per shoot, and the eager ESDIRK solver
of the port dispatches on the order of a thousand small kernels per step,
so on the card the whole shoot is one kernel, ``csrc/bounce_shoot.cu``.

Entry points, each with the plain PyTorch version of the same function in
``bounce/shooting.py``:

* :func:`bounce_shoot` — the solver's main path: one block per lane
  classifies the 2^d − 1 midpoints of a depth-d subtree of the bracket at
  once and walks it with their verdicts, then runs the dense pass.  The
  depth is derived from W, the SM count and the kernel's registers
  (:func:`tree_plan`); the outputs do not depend on it;
* :func:`bounce_shoot_serial` — the same shoot one thread per lane, one
  classification per halving: the witness the tree is held against;
* :func:`bounce_classify` — one release point's verdict, used to hold the
  kernel's classify against its plain version;
* :func:`f64_latency_probe` — cycles of dependent f64 operations, for the
  shoot's bound (a measurement, not a kernel of the path: not counted).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from bdlz_tpu_torch.backend import F64

SOURCE = "bounce_shoot.cu"

#: Kernel launches per wrapper since the last ``reset_launches()``.
LAUNCHES = {"shoot": 0, "shoot_serial": 0, "classify": 0}

#: C entry point and the TPU-side program it replaces, per wrapper.
KERNELS = {
    "shoot": ("bounce_shoot",
              "bdlz_tpu/bounce/shooting.py:105 (XLA program, no pallas_call)"),
    "shoot_serial": ("bounce_shoot_serial",
                     "bdlz_tpu/bounce/shooting.py:105 (XLA program, no pallas_call)"),
    "classify": ("bounce_classify",
                 "bdlz_tpu/bounce/shooting.py:149 (XLA program, no pallas_call)"),
}

#: Columns of the tree kernel's per-lane stats (int64).
STATS_FIELDS = ("critical_steps", "total_steps", "depth", "rounds")

#: f64 operations the latency probe times, in its order.
PROBE_OPS = ("add", "mul", "div", "sqrt", "pow")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (or reuse) and load the kernels' shared library."""
    from bdlz_tpu_torch.ops._build import build

    lib = ctypes.CDLL(str(build(SOURCE).path))
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.bounce_shoot.argtypes = [p, i, d, d, i, i, d, i, d, i] + [p] * 9 + [p]
    lib.bounce_shoot.restype = i
    lib.bounce_shoot_serial.argtypes = [p, i, d, d, i, i, d, i, d] + [p] * 8 + [p]
    lib.bounce_shoot_serial.restype = i
    lib.bounce_tree_plan.argtypes = [i, i] + [ctypes.POINTER(i)] * 4
    lib.bounce_tree_plan.restype = i
    lib.bounce_classify.argtypes = [p, p, i, d, d, i] + [p] * 6 + [p]
    lib.bounce_classify.restype = i
    lib.bounce_latency_probe.argtypes = [i, p, p, p]
    lib.bounce_latency_probe.restype = i
    lib.bounce_probe_unroll.restype = i
    lib.bounce_error_string.argtypes = [i]
    lib.bounce_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, params: torch.Tensor, *others: torch.Tensor) -> None:
    if params.dim() != 2 or params.shape[1] != 6:
        raise ValueError(f"{name}: params must be (W, 6), got {tuple(params.shape)}")
    for t in (params,) + others:
        if t.dtype != F64:
            raise TypeError(f"{name}: inputs must be float64, got {t.dtype}")
        if t.device != params.device:
            raise ValueError(f"{name}: all tensors must be on {params.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _raise_on(lib, entry: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"{entry} failed to launch: CUDA error {err} "
            f"({lib.bounce_error_string(err).decode()})"
        )


def _empty_shoot(W: int, knobs, dev):
    from bdlz_tpu_torch.bounce.shooting import ShootOut

    def empty(*shape, dtype=F64):
        return torch.empty(shape, dtype=dtype, device=dev)

    n1 = knobs.n_dense + 1
    return ShootOut(empty(W), empty(W), empty(W), empty(W, dtype=torch.uint8),
                    empty(W, n1), empty(W, n1), empty(W, dtype=torch.int64),
                    empty(W, dtype=torch.int64))


def tree_plan(n_lanes: int, n_bisect: int, device=None) -> dict:
    """The tree kernel's depth for ``n_lanes`` lanes on the card, with the
    registers, blocks per SM and SM count it was derived from."""
    lib = load_library()
    vals = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        err = lib.bounce_tree_plan(int(n_lanes), int(n_bisect), *map(ctypes.byref, vals))
    _raise_on(lib, "bounce_tree_plan", err)
    return dict(zip(("depth", "registers", "blocks_per_sm", "sms"), (v.value for v in vals)))


def bounce_shoot(params: torch.Tensor, knobs, stats: bool = False, depth=None):
    """Shoot W lanes: ``ShootOut`` (φ₀, r_wall, action, converged, φ, φ′,
    attempted steps, segment solves), and with ``stats`` also a (W, 4)
    int64 tensor of ``STATS_FIELDS``.  ``params`` is (W, 6) = (λ₄, v, ε,
    φ_false, φ_top, φ_true); ``knobs`` a ``shooting.Knobs``.  ``depth``
    (None: derived, 1 on the CPU) changes nothing in the outputs; it is
    set only to show that."""
    from bdlz_tpu_torch.bounce.shooting import TWO_PI_SQ, shoot_plain

    _check("bounce_shoot", params)
    if depth is not None and not 1 <= int(depth) <= 9:
        raise ValueError(f"bounce_shoot: depth must be in 1..9, got {depth}")
    if params.device.type == "cpu":
        return shoot_plain(params, knobs, depth=int(depth or 1), stats=stats)
    W, dev = params.shape[0], params.device
    out = _empty_shoot(W, knobs, dev)
    st = torch.zeros((W, len(STATS_FIELDS)), dtype=torch.int64, device=dev)
    if W > 0:
        lib = load_library()
        with torch.cuda.device(dev):
            err = lib.bounce_shoot(
                params.data_ptr(), W, knobs.rho0, knobs.h_seg, knobs.n_segments,
                knobs.n_bisect, knobs.h_dense, knobs.n_dense, TWO_PI_SQ, int(depth or 0),
                *(t.data_ptr() for t in out), st.data_ptr() if stats else None,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _raise_on(lib, "bounce_shoot", err)
        LAUNCHES["shoot"] += 1
    out = out._replace(converged=out.converged.bool())
    return (out, st) if stats else out


def bounce_shoot_serial(params: torch.Tensor, knobs):
    """The same ``ShootOut`` by the one-thread-per-lane kernel."""
    from bdlz_tpu_torch.bounce.shooting import TWO_PI_SQ, shoot_plain

    _check("bounce_shoot_serial", params)
    if params.device.type == "cpu":
        return shoot_plain(params, knobs)
    W, dev = params.shape[0], params.device
    out = _empty_shoot(W, knobs, dev)
    if W > 0:
        lib = load_library()
        with torch.cuda.device(dev):
            err = lib.bounce_shoot_serial(
                params.data_ptr(), W, knobs.rho0, knobs.h_seg, knobs.n_segments,
                knobs.n_bisect, knobs.h_dense, knobs.n_dense, TWO_PI_SQ,
                *(t.data_ptr() for t in out), torch.cuda.current_stream(dev).cuda_stream,
            )
        _raise_on(lib, "bounce_shoot_serial", err)
        LAUNCHES["shoot_serial"] += 1
    return out._replace(converged=out.converged.bool())


def bounce_classify(params: torch.Tensor, phi0: torch.Tensor, knobs):
    """Classify the release points ``phi0`` (W,): ``ClassifyOut`` (verdict,
    state after the first segment, state after the last, segments,
    attempted steps, ok)."""
    from bdlz_tpu_torch.bounce.shooting import ClassifyOut, classify_plain

    _check("bounce_classify", params, phi0)
    if phi0.shape != (params.shape[0],):
        raise ValueError("bounce_classify: phi0 must be (W,)")
    if params.device.type == "cpu":
        return classify_plain(params, phi0, knobs)
    W, dev = params.shape[0], params.device

    def empty(*shape, dtype=F64):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = ClassifyOut(empty(W, dtype=torch.int64), empty(W, 2), empty(W, 2),
                      empty(W, dtype=torch.int64), empty(W, dtype=torch.int64),
                      empty(W, dtype=torch.uint8))
    if W == 0:
        return out._replace(ok=out.ok.bool())
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.bounce_classify(
            params.data_ptr(), phi0.data_ptr(), W, knobs.rho0, knobs.h_seg,
            knobs.n_segments, *(t.data_ptr() for t in out),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, "bounce_classify", err)
    LAUNCHES["classify"] += 1
    return out._replace(ok=out.ok.bool())


def f64_latency_probe(device, reps: int = 4096) -> dict:
    """Cycles per dependent f64 operation on the card (one thread,
    ``clock64()``), by name in ``PROBE_OPS``; built with the shoot's flags
    (``-fmad=false``)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("f64_latency_probe: the probe runs on a CUDA device only")
    lib = load_library()
    cycles = torch.zeros(len(PROBE_OPS), dtype=torch.int64, device=device)
    sink = torch.zeros(len(PROBE_OPS), dtype=F64, device=device)
    with torch.cuda.device(device):
        err = lib.bounce_latency_probe(int(reps), cycles.data_ptr(), sink.data_ptr(),
                                       torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, "bounce_latency_probe", err)
    # the probe reads the card's cycle counters: waiting for them is its job
    torch.cuda.synchronize(device)  # bdlz-lint: disable=R3
    n_ops = int(reps) * lib.bounce_probe_unroll()
    # the counters' values are the probe's host result
    return {name: c / n_ops for name, c in zip(PROBE_OPS, cycles.tolist())}  # bdlz-lint: disable=R3
