"""The dephased Landau–Zener transport on one hand-written CUDA kernel.

The JAX package propagates the Bloch vector as plain XLA
(``bdlz_tpu/lz/kernel.py:192``, ``propagate_bloch``): every segment's SO(3)
rotation times its coherence decay, staged as a (B, 2^k, 3, 3) leaf array
and composed by a pairwise tree, with no ``pallas_call``.  On the card the
same tree wrote 75 MB of leaves a pass and ran its ten levels of batched
3×3 products through cuBLAS, so on CUDA tensors the transport is one
kernel, ``csrc/bloch_transport.cu``: each lane's segments are cut into
slices, each slice composed in registers, the slices combined in order
inside the block (the design and its bound are in the source's note).  A
lane is a speed at its own rate: one rate for every speed (the dephased
estimator) or a rate per speed (the thermal scenario's lanes, every
distinct (Γ_φ, v_w) pair of a sweep in one launch).

:func:`bloch_transport` given CPU tensors runs the plain version,
``lz/kernel.propagate_bloch_plain`` (the tree), as it takes them; given
CUDA tensors it checks them, then launches the kernel or raises — it
never falls back.  ``LAUNCHES`` counts
launches, each of which is the span ``lz.dephase.kernel``; under
``enable_nan_debugging`` a launch checks what it wrote.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from bdlz_tpu_torch.backend import F64
from bdlz_tpu_torch.utils.profiling import check_kernel_output, span

SOURCE = "bloch_transport.cu"

#: Kernel launches per wrapper since the last ``reset_launches()``.
LAUNCHES = {"bloch": 0}

#: C entry point and the TPU-side program it replaces, per wrapper.
KERNELS = {
    "bloch": ("bloch_transport",
              "bdlz_tpu/lz/kernel.py:192 propagate_bloch (XLA, no pallas_call)"),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (or reuse) and load the kernel's shared library."""
    from bdlz_tpu_torch.ops._build import build

    lib = ctypes.CDLL(str(build(SOURCE).path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bloch_transport.argtypes = [p, p, p, p, i, i, p, p, p]
    lib.bloch_transport.restype = i
    lib.bloch_error_string.argtypes = [i]
    lib.bloch_error_string.restype = ctypes.c_char_p
    return lib


def _check(a, b, dxi, v, gamma) -> None:
    for name, t in (("a", a), ("b", b), ("dxi", dxi), ("v", v), ("gamma_phi", gamma)):
        if t.dtype != F64:
            raise TypeError(f"bloch_transport: {name} must be float64, got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"bloch_transport: {name} must be 1-D, got {tuple(t.shape)}")
        if t.device != v.device:
            raise ValueError(f"bloch_transport: {name} is on {t.device}, v on {v.device}")
        if not t.is_contiguous():
            raise ValueError(f"bloch_transport: {name} must be contiguous")
    if not a.shape == b.shape == dxi.shape:
        raise ValueError("bloch_transport: a, b and dxi must hold one value per segment, "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}, {tuple(dxi.shape)}")
    if gamma.shape != v.shape:
        raise ValueError("bloch_transport: gamma_phi must hold one rate per speed, "
                         f"got {tuple(gamma.shape)} for {tuple(v.shape)} speeds")


def bloch_transport(a, b, dxi, v, gamma_phi):
    """The final Bloch vector from r₀ = ẑ per lane, (B,) → (B, 3): the
    segments ``a``, ``b``, ``dxi`` (S,) crossed at the speeds ``v`` (B,),
    each lane's coherences decaying at its own rate ``gamma_phi`` (B,)
    (float64, on ``v``'s device); a rate < 0 is taken as 0."""
    gamma = torch.clamp_min(gamma_phi, 0.0)
    if v.device.type == "cpu":
        from bdlz_tpu_torch.lz.kernel import propagate_bloch_plain

        return propagate_bloch_plain(a, b, dxi, v, gamma)
    _check(a, b, dxi, v, gamma)
    out = torch.empty((v.shape[0], 3), dtype=F64, device=v.device)
    if v.shape[0] == 0:
        return out
    lib = load_library()
    with span("lz.dephase.kernel"), torch.cuda.device(v.device):
        err = lib.bloch_transport(
            a.data_ptr(), b.data_ptr(), dxi.data_ptr(), v.data_ptr(), a.shape[0],
            v.shape[0], gamma.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(v.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bloch_transport failed to launch: CUDA error {err} "
                           f"({lib.bloch_error_string(err).decode()})")
    LAUNCHES["bloch"] += 1
    check_kernel_output("bloch_transport", out)
    return out
