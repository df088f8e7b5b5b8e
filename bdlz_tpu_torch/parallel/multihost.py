"""Store-lease membership across processes and hosts.

Counterpart of the store-lease half of ``bdlz_tpu/parallel/multihost.py``:
coordinator election for the elastic sweep and the host-lease records of
the serving fabric, both TTL'd records in the shared provenance store
(exclusive create, steal on expiry, a torn record reads as free).  The
process-group half of that module — ``init_multihost``,
``process_local_bounds``, ``shard_global_chunk``, ``gather_to_host`` and
``broadcast_from_coordinator`` — is ROADMAP D9, multi-GPU.
"""
from __future__ import annotations

import time

from bdlz_tpu_torch.provenance.registry import create_lease, read_lease, write_lease


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
