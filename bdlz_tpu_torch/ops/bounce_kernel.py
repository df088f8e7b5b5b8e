"""The O(4) bounce shoot on a hand-written CUDA kernel, one thread per lane.

The JAX package runs the shoot as one jitted XLA program per lane width
(``bdlz_tpu/bounce/shooting.py:105``, ``_bounce_program``): a
``fori_loop`` of bisection halvings, each a ``while_loop`` over segments,
each a full adaptive ESDIRK solve, then an RK4 ``scan``.  That is about
45,000 sequential attempted steps per shoot, and the eager ESDIRK solver
of the port dispatches on the order of a thousand small kernels per step,
so on the card the whole shoot is one kernel, ``csrc/bounce_shoot.cu``.

Two entry points, each with the plain PyTorch version of the same
function in ``bounce/shooting.py``:

* :func:`bounce_shoot` — bisection plus dense pass, the solver's main path;
* :func:`bounce_classify` — one release point's verdict, used to hold the
  kernel against its plain version.

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
LAUNCHES = {"shoot": 0, "classify": 0}

#: C entry point and the TPU-side program it replaces, per wrapper.
KERNELS = {
    "shoot": ("bounce_shoot",
              "bdlz_tpu/bounce/shooting.py:105 (XLA program, no pallas_call)"),
    "classify": ("bounce_classify",
                 "bdlz_tpu/bounce/shooting.py:149 (XLA program, no pallas_call)"),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (or reuse) and load the kernel's shared library."""
    from bdlz_tpu_torch.ops._build import build

    lib = ctypes.CDLL(str(build(SOURCE).path))
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.bounce_shoot.argtypes = [p, i, d, d, i, i, d, i, d] + [p] * 8 + [p]
    lib.bounce_shoot.restype = i
    lib.bounce_classify.argtypes = [p, p, i, d, d, i] + [p] * 6 + [p]
    lib.bounce_classify.restype = i
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


def bounce_shoot(params: torch.Tensor, knobs):
    """Shoot W lanes: ``ShootOut`` (φ₀, r_wall, action, converged, φ, φ′,
    attempted steps, segment solves).  ``params`` is (W, 6) =
    (λ₄, v, ε, φ_false, φ_top, φ_true); ``knobs`` a ``shooting.Knobs``."""
    from bdlz_tpu_torch.bounce.shooting import TWO_PI_SQ, ShootOut, shoot_plain

    _check("bounce_shoot", params)
    if params.device.type == "cpu":
        return shoot_plain(params, knobs)
    W, n1, dev = params.shape[0], knobs.n_dense + 1, params.device

    def empty(*shape, dtype=F64):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = ShootOut(empty(W), empty(W), empty(W), empty(W, dtype=torch.uint8),
                   empty(W, n1), empty(W, n1), empty(W, dtype=torch.int64),
                   empty(W, dtype=torch.int64))
    if W == 0:
        return out._replace(converged=out.converged.bool())
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.bounce_shoot(
            params.data_ptr(), W, knobs.rho0, knobs.h_seg, knobs.n_segments,
            knobs.n_bisect, knobs.h_dense, knobs.n_dense, TWO_PI_SQ,
            *(t.data_ptr() for t in out), torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, "bounce_shoot", err)
    LAUNCHES["shoot"] += 1
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
