"""Tabulated KJMA shape function — the sweep engine's fast path.

Counterpart of ``bdlz_tpu/ops/kjma_table.py``.  The KJMA area-to-volume
kernel factorises as

    [A/V](y) = (I_p/2)·(β/v_w)·e^y · F(y; I_p),
    F(y; I_p) = ∫ z² e^{−z} exp(−(I_p/6) e^{clamp(y)} γ₄(z)) dz,

with the z-integral defined as the trapezoid on the fixed grid
linspace(0, 30, 1200) — the scheme is the spec.  F is built once per
sweep as a dense table over y ∈ [−50, 50]; every (point, y) evaluation
is then a 4-point Lagrange interpolation.

The table VALUES are computed with host NumPy, exactly as the reference
computes them, and only then shipped to the device as float64: they are
bitwise equal to the JAX package's table.  The lookups below use tensor
indexing in place of the XLA gather.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bdlz_tpu_torch.backend import F64
from bdlz_tpu_torch.physics.percolation import make_kjma_grid_numpy
from bdlz_tpu_torch.physics.thermo import hubble_rate

Y_CLAMP = 50.0  # e^y clamp of the reference kernel (:161)


class KJMATable(NamedTuple):
    """Dense F(y) table for one I_p: float scalars plus the (n,) value array
    (NumPy on the host, a float64 tensor on a device)."""

    y0: float
    inv_dy: float
    values: "np.ndarray | torch.Tensor"
    I_p: float


def make_f_table(I_p: float, n: int = 16384) -> KJMATable:
    """Build the F(y) table on the host with the exact reference z-trapezoid
    (one (n × 1200) NumPy tensor, paid once per sweep)."""
    z, weight, gamma4 = make_kjma_grid_numpy()
    ys = np.linspace(-Y_CLAMP, Y_CLAMP, n)
    expy = np.exp(ys)
    integrand = weight * np.exp(-(float(I_p) / 6.0) * expy[:, None] * gamma4)
    F = np.trapezoid(integrand, z, axis=-1)
    dy = (2.0 * Y_CLAMP) / (n - 1)
    return KJMATable(y0=-Y_CLAMP, inv_dy=1.0 / dy, values=F, I_p=float(I_p))


def table_to_device(table: KJMATable, device) -> KJMATable:
    """Ship a host-built table's values to ``device`` as float64: the device
    table is the SAME table, bit for bit, not a second build."""
    return table._replace(
        values=torch.as_tensor(table.values, dtype=F64, device=device)
    )


def interp_taps(i1: torch.Tensor, s: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Cubic Lagrange interpolation of uniform-grid ``values`` from integer
    base indices ``i1`` (clipped to [1, n-3] so the taps at offsets
    (−1, 0, 1, 2) stay in bounds) and fractional offsets ``s``, by tensor
    indexing; the reference's association order."""
    i = torch.clamp(i1, 1, values.shape[0] - 3).long()
    return lagrange_stencil(s, values[i - 1], values[i], values[i + 1], values[i + 2])


def lagrange_stencil(s, f_m1, f_0, f_1, f_2):
    """The cubic Lagrange combination of the taps at offsets (−1, 0, 1, 2)
    for fractional offset ``s``, in the reference's association order."""
    sm1 = s + 1.0
    s0 = s
    s1 = s - 1.0
    s2 = s - 2.0
    w_m1 = -(s0 * s1 * s2) / 6.0
    w_0 = (sm1 * s1 * s2) / 2.0
    w_1 = -(sm1 * s0 * s2) / 2.0
    w_2 = (sm1 * s0 * s1) / 6.0
    return w_m1 * f_m1 + w_0 * f_0 + w_1 * f_1 + w_2 * f_2


def cubic_lagrange_uniform(t: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """4-point Lagrange interpolation of uniform-grid ``values`` at
    fractional index ``t``, batched; the base index is clipped in int32
    after the floor."""
    i1 = torch.clamp(torch.floor(t).to(torch.int32), 1, values.shape[0] - 3)
    return interp_taps(i1, t - i1, values)


def eval_f_table(y: torch.Tensor, table: KJMATable) -> torch.Tensor:
    """F(clamp(y)) by cubic interpolation; queries are clamped to the table
    domain (above +50 the caller applies the hard A/V = 0 cut)."""
    t = (torch.clamp(y, -Y_CLAMP, Y_CLAMP) - table.y0) * table.inv_dy
    return cubic_lagrange_uniform(t, table.values)


def area_over_volume_tabulated(y, beta_over_H, T_p, v_w, g_star, table: KJMATable):
    """[A/V](y) via the F-table — the direct kernel's semantics
    (``percolation.area_over_volume``) with F interpolated."""
    beta = beta_over_H * hubble_rate(T_p, g_star)
    expy = torch.exp(torch.clamp(y, -Y_CLAMP, Y_CLAMP))
    pref = (table.I_p / 2.0) * (beta / torch.clamp_min(v_w, 1e-12)) * expy
    F = eval_f_table(y, table)
    return torch.where(y > Y_CLAMP, 0.0, pref * F)
