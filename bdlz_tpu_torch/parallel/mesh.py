"""Device meshes over torch devices, and the two canonical placements.

Counterpart of ``bdlz_tpu/parallel/mesh.py``.  A :class:`DeviceMesh` is a
(dp, sp) array of ``torch.device`` members spanning every process of the
run (process-major, as ``jax.devices()`` orders a multi-process runtime):
each process contributes the same list of local members, and its rows of
the array are the ones it computes.

A mesh may name one physical device more than once.  ``[cuda:0, cuda:0]``
is a two-member mesh on one card (each member launches on a CUDA stream
of its own), and ``["cpu"] * 8`` mirrors the eight forced host devices
of the JAX package's tests.

The JAX shardings become plans: :func:`batch_sharding` says which
contiguous rows of a batch each member holds (in JAX's row order, the
batch split over dp and sp flattened), :func:`replicated_sharding` that
every member holds every row.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class DeviceMesh:
    """A (dp, sp) array of torch devices over all processes of the run.

    ``devices`` is the global member array (process-major); ``shape``
    maps each axis name to its size, as JAX's ``Mesh.shape`` does.  This
    process holds members ``[process_index · n_local, … + n_local)``.
    """

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], n_local: int,
                 process_index: int):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))
        self.n_local = int(n_local)
        self.process_index = int(process_index)
        self._streams: Dict[int, "torch.cuda.Stream"] = {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def local_members(self) -> range:
        """Global (row-major) indices of the members this process holds."""
        lo = self.process_index * self.n_local
        return range(lo, lo + self.n_local)

    @property
    def local_devices(self) -> List[torch.device]:
        flat = self.devices.reshape(-1)
        return [flat[k] for k in self.local_members]

    def stream(self, member: int):
        """Member ``member``'s own CUDA stream (made on first use), or None
        for a CPU member."""
        dev = self.devices.reshape(-1)[member]
        if dev.type != "cuda":
            return None
        if member not in self._streams:
            self._streams[member] = torch.cuda.Stream(device=dev)
        return self._streams[member]

    def __repr__(self) -> str:
        return (f"DeviceMesh({dict(self.shape)}, local={[str(d) for d in self.local_devices]}, "
                f"process={self.process_index})")


def on_stream(stream):
    """The context that makes a member's ``stream`` current; nothing for
    a CPU member (``stream`` None)."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _local_cards() -> List[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card and does "
            "not fall back — pass devices=['cpu'] to build a mesh on the host"
        )
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Sequence[str] = ("dp", "sp"),
    devices=None,
) -> DeviceMesh:
    """Build a 2-D (dp × sp) mesh over every process's members.

    ``devices`` lists this process's members (default: every visible
    card; ``["cpu"]`` for the host); every process of the run contributes
    the same number, so the mesh has ``len(devices) · process_count()``
    members.  Default shape: all of them on dp, sp = 1, the layout for
    parameter sweeps.  A shape that does not hold the members raises
    JAX's error.
    """
    from bdlz_tpu_torch.backend import resolve_device
    from bdlz_tpu_torch.parallel.multihost import process_count, process_index

    local = _local_cards() if devices is None else [resolve_device(d) for d in devices]
    nproc = process_count()
    n = len(local) * nproc
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    flat = np.empty(n, dtype=object)
    for k in range(n):
        flat[k] = local[k % len(local)]
    return DeviceMesh(flat.reshape(tuple(shape)), axis_names, len(local), process_index())


def split_rows(n: int, parts: int) -> List[Tuple[int, int]]:
    """``parts`` contiguous [lo, hi) pieces of ``n`` rows, in order, equal
    when ``parts`` divides ``n``."""
    return [((k * n) // parts, ((k + 1) * n) // parts) for k in range(parts)]


class BatchSharding:
    """The leading batch axis split over every member (dp and sp
    flattened, row-major): member ``k`` holds rows ``bounds(n)[k]``."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh

    def bounds(self, n: int) -> List[Tuple[int, int]]:
        return split_rows(int(n), self.mesh.size)

    def local_bounds(self, n: int) -> List[Tuple[int, int]]:
        """This process's members' rows, in member order."""
        b = self.bounds(n)
        return [b[k] for k in self.mesh.local_members]


class ReplicatedSharding:
    """Every member holds every row."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh

    def bounds(self, n: int) -> List[Tuple[int, int]]:
        return [(0, int(n))] * self.mesh.size

    def local_bounds(self, n: int) -> List[Tuple[int, int]]:
        return [(0, int(n))] * self.mesh.n_local


def batch_sharding(mesh: DeviceMesh) -> BatchSharding:
    """Shard a leading batch axis across every mesh axis (dp and sp)."""
    return BatchSharding(mesh)


def replicated_sharding(mesh: DeviceMesh) -> ReplicatedSharding:
    return ReplicatedSharding(mesh)
