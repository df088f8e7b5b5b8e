"""Processes and hosts: the torch.distributed process group, and the
store-lease membership of the elastic sweep and the serving fabric.

Counterpart of ``bdlz_tpu/parallel/multihost.py``.  The process-group
half carries JAX's helpers onto ``torch.distributed``:

* :func:`init_multihost` joins the process group from its arguments, or
  from JAX's env vars (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
  ``JAX_PROCESS_ID``), or from torchrun's (``MASTER_ADDR``/``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``) where JAX's are absent; with nothing
  configured it is the one-process fast path;
* :func:`process_local_bounds`, :func:`shard_global_chunk` and
  :func:`gather_to_host` place a chunk's rows on this process's mesh
  members and bring the results back tiled in process order;
* :func:`allreduce_min`, :func:`broadcast_from_coordinator` and
  :func:`broadcast_text` are the fleet's agreements, :func:`is_coordinator`
  names the process that owns the files.

Every helper is the identity in one process.  The control plane is a
``gloo`` group over host tensors: JAX's helpers move host arrays too, and
gloo works whether or not two processes share a card.  Device tensors (a
CUDA tensor passed to a collective, the ``sp`` partial sums of
``gridshard``) go through a NCCL group opened on first use.  Two processes
on one card must never reach it: NCCL refuses them, and nothing quietly
takes its place.

The store-lease half (coordinator election for the elastic sweep, the
fabric's host leases) is TTL'd records in the shared provenance store:
exclusive create, steal on expiry, a torn record reads as free.
"""
from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from bdlz_tpu_torch.provenance.registry import create_lease, read_lease, write_lease

#: The NCCL group of device collectives, opened on first use.
_NCCL: dict = {}


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def init_multihost(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the run's process group if a multi-process run is configured.

    Resolution order, per value: the argument ▸ JAX's env vars
    (``JAX_COORDINATOR_ADDRESS`` ``host:port``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``) ▸ torchrun's (``MASTER_ADDR``:``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).  Returns True when a process group is up,
    False for the one-process fast path (nothing configured).  A second
    call is a no-op that returns True.  The group is ``gloo`` over
    ``tcp://<coordinator>``; device collectives open NCCL on first use.
    """
    if coordinator is None:
        coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    num_processes = (num_processes or _env_int("JAX_NUM_PROCESSES")
                     or _env_int("WORLD_SIZE"))
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID")
    if process_id is None:
        process_id = _env_int("RANK")

    if coordinator is None and num_processes is None:
        return False  # one process: nothing to join
    if _dist() is not None:
        return True
    missing = [name for name, v in (("coordinator", coordinator),
                                    ("num_processes", num_processes),
                                    ("process_id", process_id)) if v is None]
    if missing:
        raise ValueError(
            f"init_multihost: {', '.join(missing)} not configured (pass it, or set "
            "JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/JAX_PROCESS_ID)")
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes), rank=int(process_id))
    return True


def process_count() -> int:
    """Processes in the run (1 without a process group)."""
    d = _dist()
    return d.get_world_size() if d is not None else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    d = _dist()
    return d.get_rank() if d is not None else 0


def is_coordinator() -> bool:
    """True on the process that owns filesystem side effects (index 0)."""
    return process_index() == 0


def backend_names() -> dict:
    """The backends in use: ``host`` (the control plane) and ``device``
    (the NCCL group, once opened); None where there is none."""
    d = _dist()
    if d is None:
        return {"host": None, "device": None}
    g = _NCCL.get("group")
    return {"host": str(d.get_backend()),
            "device": None if g is None else str(d.get_backend(g))}


def _group_for(t: torch.Tensor):
    """The process group of a collective on ``t``: the default (gloo)
    group for host tensors, the NCCL group, opened on first use, for
    CUDA tensors."""
    if t.device.type != "cuda":
        return None
    if "group" not in _NCCL:
        import torch.distributed as dist

        torch.cuda.set_device(t.device)
        _NCCL["group"] = dist.new_group(backend="nccl")
    return _NCCL["group"]


def process_local_bounds(n_global: int) -> Tuple[int, int]:
    """[lo, hi) of a length-``n_global`` batch owned by this process: the
    batch is split uniformly across processes in process order (the rows
    ``batch_sharding`` gives this process's members).  ``n_global`` must
    divide evenly; sweep chunks are padded to a multiple of the mesh."""
    nproc = process_count()
    if n_global % nproc:
        raise ValueError(f"batch {n_global} not divisible by {nproc} processes")
    per = n_global // nproc
    lo = process_index() * per
    return lo, lo + per


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def shard_global_chunk(chunk, sharding) -> list:
    """Place a host pytree of (n_global, …) arrays on this process's
    members: one pytree per local member, holding the member's rows of
    ``sharding`` as tensors on the member's device.  In one process the
    pieces, concatenated in member order, are the chunk bit for bit."""
    mesh = sharding.mesh
    n = int(np.shape(next(iter(_leaves(chunk))))[0])
    out = []
    for dev, (lo, hi) in zip(mesh.local_devices, sharding.local_bounds(n)):
        out.append(_tree_map(
            # each leaf keeps its own dtype (float64 values, bool masks, int64 indices)
            lambda a, lo=lo, hi=hi, dev=dev: torch.as_tensor(  # bdlz-lint: disable=R13
                np.asarray(a)[lo:hi], device=dev),
            chunk))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _allgather_host(a: np.ndarray) -> np.ndarray:
    """Tile equal-shaped host arrays of every process in process order."""
    d = _dist()
    a = np.ascontiguousarray(a)
    wire = a.view(np.uint8) if a.dtype == np.bool_ else a
    t = torch.from_numpy(np.array(wire, copy=True))
    parts = [torch.empty_like(t) for _ in range(d.get_world_size())]
    d.all_gather(parts, t)
    out = np.concatenate([p.numpy() for p in parts]) if a.ndim else np.stack(
        [p.numpy() for p in parts])
    return out.view(np.bool_) if a.dtype == np.bool_ else out


def allgather_ragged(a: np.ndarray, counts) -> np.ndarray:
    """Every process's leading rows of ``a`` tiled in process order, where
    process ``p`` holds ``counts[p]`` rows (known to every process): the
    pieces travel padded to the largest.  A host copy without a process
    group."""
    a = _host(a)
    if _dist() is None:
        return a
    width = max(int(c) for c in counts)
    pad = np.zeros((width,) + a.shape[1:], dtype=a.dtype)
    pad[: a.shape[0]] = a
    full = _allgather_host(pad)
    return np.concatenate([full[p * width: p * width + int(c)] for p, c in enumerate(counts)])


def gather_to_host(tree):
    """Bring a result pytree (this process's rows, tensors or arrays) to
    host NumPy holding every process's rows, tiled in process order.  The
    identity (a host copy) without a process group."""
    if _dist() is None:
        return _tree_map(_host, tree)
    return _tree_map(lambda a: _allgather_host(_host(a)), tree)


def allreduce_min(arr):
    """Elementwise min of a small array across processes, the fleet's
    conservative agreement.  A host array rides the gloo group and comes
    back as NumPy; a CUDA tensor rides NCCL and comes back as a tensor.
    The identity in one process."""
    d = _dist()
    if isinstance(arr, torch.Tensor):
        if d is None:
            return arr
        out = arr.clone()
        d.all_reduce(out, op=d.ReduceOp.MIN, group=_group_for(out))
        return out
    a = np.asarray(arr)
    if d is None:
        return a
    t = torch.from_numpy(np.array(a, copy=True))
    d.all_reduce(t, op=d.ReduceOp.MIN)
    return t.numpy()


def allreduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Elementwise sum of a tensor across processes (NCCL for a CUDA
    tensor, gloo for a host one); the identity in one process."""
    d = _dist()
    if d is None:
        return t
    out = t.clone()
    d.all_reduce(out, op=d.ReduceOp.SUM, group=_group_for(out))
    return out


def broadcast_from_coordinator(arr):
    """Replicate a small array from process 0 to all processes (a host
    array over gloo, a CUDA tensor over NCCL).  Shapes and dtypes must
    match on every caller: callers pass fixed-size plan arrays.  The
    identity in one process."""
    d = _dist()
    if isinstance(arr, torch.Tensor):
        if d is None:
            return arr
        out = arr.clone()
        d.broadcast(out, src=0, group=_group_for(out))
        return out
    a = np.asarray(arr)
    if d is None:
        return a
    t = torch.from_numpy(np.array(a, copy=True))
    d.broadcast(t, src=0)
    return t.numpy()


def broadcast_text(s: str, width: int = 64) -> str:
    """Replicate a short control string from process 0 to all processes,
    as a fixed-``width`` zero-padded uint8 array (variable-length
    payloads would deadlock).  The identity in one process."""
    payload = s.encode("utf-8")
    if len(payload) > width:
        raise ValueError(
            f"control string of {len(payload)} bytes exceeds the "
            f"{width}-byte broadcast width"
        )
    arr = np.zeros(width, dtype=np.uint8)
    arr[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    out = np.asarray(broadcast_from_coordinator(arr), dtype=np.uint8)
    return bytes(out.tobytes()).rstrip(b"\x00").decode("utf-8")


def elect_coordinator(store, job: str, candidate: str, ttl_s: float = 60.0,
                      clock=None) -> bool:
    """Store-based coordinator election for the elastic sweep: a TTL'd
    lease on the job's ``<job>_coord`` record.  The first candidate to win
    the exclusive create is coordinator; a later one takes the seat only
    once the lease expired, or when it already holds it (re-election
    extends it).  True when ``candidate`` holds the seat.  ``clock`` is
    wall time by default: liveness must compare across processes."""
    if clock is None:
        clock = time.time
    coord_job = f"{job}_coord"
    now = float(clock())
    rec = {
        "schema": 1,
        "job": job,
        "role": "coordinator",
        "worker": str(candidate),
        "expires_at": now + float(ttl_s),
        "failures": [],
    }
    if create_lease(store, coord_job, 0, rec):
        return True
    cur = read_lease(store, coord_job, 0)
    if (cur is None or float(cur.get("expires_at", 0.0)) <= now
            or cur.get("worker") == str(candidate)):
        write_lease(store, coord_job, 0, rec)
        return True
    return False


# ---- host-lease membership (the serving fabric) --------------------------
#
# One record per membership slot under the job ``fabric_<fabric>``: slot
# ``i`` is host ``i``'s seat, and only its holder heartbeats it.  The
# policy (cadence, fencing, failover) lives in serve/fabric.py.

def host_lease_job(fabric: str) -> str:
    """The lease-plane job name of a fabric's membership records."""
    return f"fabric_{fabric}"


def read_host_lease(store, fabric: str, host_index: int):
    """Host ``host_index``'s membership record, or None when absent or
    torn (a torn record reads as a fenced host)."""
    return read_lease(store, host_lease_job(fabric), int(host_index))


def publish_host_lease(store, fabric: str, host_index: int, record, clock=None) -> bool:
    """Register or extend one host's membership lease; True when
    ``record`` holds the slot.  A fresh slot is an exclusive create; the
    own slot (same ``host_id``) is extended; an expired or torn slot is
    stolen with a generation bump.  A live slot under another ``host_id``
    refuses (False): two hosts on one seat is an identity collision."""
    if clock is None:
        clock = time.time
    job = host_lease_job(fabric)
    now = float(clock())
    if create_lease(store, job, int(host_index), record):
        return True
    cur = read_lease(store, job, int(host_index))
    if cur is not None and float(cur.get("expires_at", 0.0)) > now and (
            cur.get("host_id") != record.get("host_id")):
        return False
    if cur is not None and cur.get("host_id") != record.get("host_id"):
        # a stolen seat: the bump shows routers the replacement
        record = dict(record)
        record["generation"] = int(cur.get("generation", 0)) + 1
    write_lease(store, job, int(host_index), record)
    return True
