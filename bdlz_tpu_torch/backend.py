"""Device resolution and the working dtype of the port.

The JAX package picks an array namespace (``numpy`` or ``jax.numpy``);
the port always computes in PyTorch and picks a *device* instead:

* ``resolve_device(None)`` is the first CUDA card, and raises when there
  is none — the port never carries on silently on the CPU;
* ``resolve_device("cpu")`` is the plain-PyTorch CPU path, taken only on
  request (the tests do).

Every tensor constructor in the port pins ``dtype=F64`` (or ``I32`` for
table indices) explicitly: torch defaults to float32, and the reference
once lost ~3e-9 to an implicitly f32 table.  The global default dtype is
never changed.
"""
from __future__ import annotations

import torch

F64 = torch.float64
I32 = torch.int32

#: Config ``backend`` values the JAX package accepts, by kind.  The port
#: keeps the classification for ``config.validate``: every device
#: backend is strict about unknown regimes.
_DEVICE_BACKENDS = ("jax", "tpu", "gpu", "cpu-jax")
_NUMPY_BACKENDS = ("numpy", "reference", "cpu")
VALID_BACKENDS = _NUMPY_BACKENDS + _DEVICE_BACKENDS


def is_device_backend(backend: str) -> bool:
    """True for the strict (device) backends, False for the NumPy ones."""
    b = str(backend).lower()
    if b in _DEVICE_BACKENDS:
        return True
    if b in _NUMPY_BACKENDS:
        return False
    raise ValueError(
        f"Unknown backend {backend!r}; expected one of {VALID_BACKENDS}"
    )


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device an entry point runs on: ``cuda:0`` unless the caller
    asks for the CPU.  Raises ``RuntimeError`` when a CUDA device is
    wanted and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card and does "
            "not fall back — pass device='cpu' to run the plain PyTorch path"
        )
    return torch.device("cuda", 0 if dev.index is None else dev.index)


def device_label(device) -> str:
    """The card a result came from, as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` names it, or ``"cpu"`` for the host.

    The row is found by the card's UUID, not by torch's index, which
    ``CUDA_VISIBLE_DEVICES`` renumbers; a card nvidia-smi does not list
    raises ``RuntimeError``."""
    import subprocess

    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    uuid = f"GPU-{torch.cuda.get_device_properties(dev.index or 0).uuid}"
    rows = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    for row in rows:
        row_uuid, _, label = row.partition(",")
        if row_uuid.strip() == uuid:
            return label.strip()
    raise RuntimeError(f"nvidia-smi lists no card {uuid} (cuda:{dev.index or 0})")
