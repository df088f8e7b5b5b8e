"""Grid-sharded (sequence-parallel analog) quadrature.

Counterpart of ``bdlz_tpu/parallel/gridshard.py``.  For giant-grid
convergence studies one point's y-grid is split into contiguous pieces
over the mesh's ``sp`` axis: each member evaluates the tabulated
integrand on its nodes and dots them with its trapezoid weights
(dy, ½·dy at the two global ends), the partial sums are added in member
order within a process and by one all-reduce across processes.  That is
the trapezoid up to summation order.  JAX computes this outside any
Pallas kernel, so it is plain PyTorch here too.
"""
from __future__ import annotations

import torch

from bdlz_tpu_torch.backend import F64
from bdlz_tpu_torch.config import StaticChoices


def _sp_row(mesh):
    """``[(member, sp index)]`` of the dp row this process evaluates (the
    row of its first member), the local members in that row only."""
    n_sp = mesh.shape["sp"]
    row = mesh.local_members[0] // n_sp
    return [(k, k - row * n_sp) for k in mesh.local_members if k // n_sp == row], row


def make_sp_quadrature(static: StaticChoices, mesh, n_y: int = 8192):
    """Build the sp-sharded Y_B quadrature: ``fn(pp, table) -> Y_B``.

    ``n_y`` must be divisible by the mesh's sp size.  ``pp`` is one
    point (a PointParams of scalars) and ``table`` a ``KJMATable``; both
    are replicated on every member, only the y-grid is split.  Returns a
    0-d float64 tensor on the first local member's device: 0 where the
    window is empty (y_hi ≤ y_lo).
    """
    from bdlz_tpu_torch.interop import point_params_from_numpy
    from bdlz_tpu_torch.ops.kjma_table import table_to_device
    from bdlz_tpu_torch.parallel.mesh import on_stream
    from bdlz_tpu_torch.parallel.multihost import (
        _dist,
        allreduce_sum,
        process_count,
        process_index,
    )
    from bdlz_tpu_torch.solvers.quadrature import quadrature_bounds, yb_integrand_tabulated

    n_sp = mesh.shape["sp"]
    if n_y % n_sp != 0:
        raise ValueError(f"n_y={n_y} not divisible by sp={n_sp}")
    n_local = n_y // n_sp
    members, row = _sp_row(mesh)
    flat = mesh.devices.reshape(-1)
    home = mesh.local_devices[0]
    tables: dict = {}

    def local_piece(k, idx, pp, table):
        dev = flat[k]
        if dev not in tables:
            tables[dev] = table_to_device(table, dev)
        ppd = point_params_from_numpy(pp, dev)
        y_lo, y_hi = quadrature_bounds(ppd)
        dy = (y_hi - y_lo) / (n_y - 1)
        gidx = idx * n_local + torch.arange(n_local, dtype=torch.int64, device=dev)
        ys = y_lo[:, None] + gidx.to(F64)[None, :] * dy[:, None]
        f = yb_integrand_tabulated(ys, ppd, static.chi_stats, tables[dev])[0]
        ends = ((gidx == 0) | (gidx == n_y - 1)).to(F64)
        w = (1.0 - 0.5 * ends) * dy[0]
        return torch.sum(f * w), y_lo[0], y_hi[0]

    def fn(pp, table):
        tables.clear()
        launched = []
        for k, idx in members:
            s = mesh.stream(k)
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(flat[k]))
            with on_stream(s):
                launched.append((s, local_piece(k, idx, pp, table)))
        total = None
        for s, (part, y_lo, y_hi) in launched:
            if s is not None:
                torch.cuda.current_stream(home).wait_stream(s)
            part = part.to(home)
            total = part if total is None else total + part
        y_lo, y_hi = launched[0][1][1].to(home), launched[0][1][2].to(home)
        if _dist() is not None:  # a process group, even a world of one
            # one slot per process, zeros elsewhere: the all-reduce adds
            # nothing but exact zeros to a slot, then each process adds
            # its own row's partials in process order
            slots = torch.zeros(process_count(), dtype=F64, device=home)
            slots[process_index()] = total
            slots = allreduce_sum(slots)
            rows = [k * mesh.n_local // n_sp for k in range(process_count())]
            total = None
            for p in range(process_count()):
                if rows[p] == row:
                    total = slots[p] if total is None else total + slots[p]
        return torch.where(y_hi > y_lo, total, torch.zeros((), dtype=F64, device=home))

    return fn
