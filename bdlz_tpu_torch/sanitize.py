"""Runtime sanitizer layer (the ``--sanitize`` flag on the CLIs).

Counterpart of ``bdlz_tpu/sanitize.py``, with the same boundary names,
error type and messages:

* finiteness assertions at the layer boundaries of the yields pipeline —
  L1 thermo → L2 percolation → L3 source → L4 solver → output — so a NaN
  names the layer that produced it;
* a dtype-drift check asserting the float64 contract on tensors and
  arrays (a stray float32 erodes the 1e-6 accuracy contract long before
  it is visibly wrong);
* with ``enable(nans=True)``, the op-level NaN check of
  :func:`bdlz_tpu_torch.utils.profiling.enable_nan_debugging`, the
  stand-in for ``jax_debug_nans``.

Disabled (the default), every hook is one dict lookup, so every run is
bitwise unchanged.  Enabled, a checked tensor is read on the host: on the
card that is a device sync per checkpoint, paid only under the flag.

The JAX engines run their chunks and likelihoods jitted, where a
checkpoint sees a tracer and checks nothing.  The port's counterparts of
those compiled programs (the sweep's chunk step, the samplers'
likelihood) run inside :func:`opaque`, which makes every checkpoint in
them a no-op the same way; their outputs are checked at the CLI's output
boundary, as in JAX.
"""
from __future__ import annotations

import contextlib
from typing import Any, Iterable, Tuple

import numpy as np
import torch

#: The canonical layer-boundary names (ARCHITECTURE.md layer map).
BOUNDARY_THERMO = "L1:thermo -> L2:percolation"
BOUNDARY_PERCOLATION = "L2:percolation -> L3:source"
BOUNDARY_SOURCE = "L3:source -> L4:solver"
BOUNDARY_SOLVER = "L4:solver -> output"

_STATE = {"enabled": False, "opaque": 0}


class SanitizerError(RuntimeError):
    """A finiteness or dtype violation, tagged with its layer boundary."""

    def __init__(self, boundary: str, name: str, detail: str) -> None:
        self.boundary = boundary
        self.name = name
        super().__init__(
            f"sanitizer tripped at layer boundary [{boundary}]: "
            f"quantity {name!r} {detail}"
        )


def enable(nans: bool = True) -> None:
    """Arm the sanitizer; ``nans`` also arms the op-level NaN check."""
    _STATE["enabled"] = True
    if nans:
        from bdlz_tpu_torch.utils.profiling import enable_nan_debugging

        enable_nan_debugging(True)


def disable() -> None:
    """Disarm every checkpoint (does not touch the op-level NaN check)."""
    _STATE["enabled"] = False


def is_enabled() -> bool:
    return _STATE["enabled"]


@contextlib.contextmanager
def opaque():
    """Run a region as a compiled program: checkpoints inside it check
    nothing (a JAX checkpoint under ``jit`` sees only tracers)."""
    _STATE["opaque"] += 1
    try:
        yield
    finally:
        _STATE["opaque"] -= 1


def _host_view(value: Any) -> np.ndarray:
    """A host ndarray of ``value`` (a tensor is copied off its device)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _dtype_name(value: Any, arr: np.ndarray) -> str:
    return str(value.dtype).removeprefix("torch.") if isinstance(value, torch.Tensor) \
        else str(arr.dtype)


def _check_leaf(boundary: str, name: str, value: Any, allow_nan: bool) -> None:
    """The one home of the dtype + finiteness contract for one quantity."""
    if isinstance(value, torch.Tensor) and value.dtype == torch.bfloat16:
        raise SanitizerError(boundary, name,
                             "drifted to dtype bfloat16 (float64 contract)")
    arr = _host_view(value)
    if arr.dtype.kind == "f" and arr.dtype != np.float64:
        raise SanitizerError(
            boundary, name,
            f"drifted to dtype {_dtype_name(value, arr)} (float64 contract)",
        )
    if not allow_nan and arr.dtype.kind in "fc" and not np.all(np.isfinite(arr)):
        n_bad = int(np.size(arr) - np.count_nonzero(np.isfinite(arr)))
        raise SanitizerError(
            boundary, name,
            f"contains {n_bad} non-finite element(s) "
            f"(shape {arr.shape}, dtype {_dtype_name(value, arr)})",
        )


def checkpoint(boundary: str, **named: Any) -> None:
    """Assert every named quantity is finite f64 at a layer boundary.
    No-op unless :func:`enable` ran, and inside :func:`opaque`."""
    if not _STATE["enabled"] or _STATE["opaque"]:
        return
    for name, value in named.items():
        _check_leaf(boundary, name, value, allow_nan=False)


def check_tree(boundary: str, tree: Any, allow_nan: bool = False) -> None:
    """Checkpoint every leaf of a NamedTuple/dict/sequence of arrays.

    ``allow_nan=True`` keeps the dtype-drift check but skips finiteness —
    the sweep engine reports failed points as in-band NaN by design.
    """
    if not _STATE["enabled"] or _STATE["opaque"]:
        return
    for name, leaf in _named_leaves(tree):
        _check_leaf(boundary, name, leaf, allow_nan)


def _named_leaves(tree: Any) -> Iterable[Tuple[str, Any]]:
    if hasattr(tree, "_asdict"):
        yield from tree._asdict().items()
    elif isinstance(tree, dict):
        yield from tree.items()
    elif isinstance(tree, (list, tuple)):
        for i, leaf in enumerate(tree):
            yield f"[{i}]", leaf
    else:
        yield "value", tree
