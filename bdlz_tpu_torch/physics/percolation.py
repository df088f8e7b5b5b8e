"""Percolation-time maps and the KJMA area-to-volume kernel (layer L2).

Counterpart of ``bdlz_tpu/physics/percolation.py``.  Scalar semantics
match the reference (`first_principles_yields.py:126-165`): ``y_of_T``
floors T at 1e-30, ``T_of_y`` returns T_p·1e6 when the inverse-map
denominator is ≤ 1e-12, and A/V is hard-zeroed above y = 50 with e^y
clamped to [−50, 50] and v_w floored at 1e-12.

The z-grid is exactly ``linspace(0, 30, 1200)`` — the scheme is the spec
(``ops/kjma_table.py``) — so it is built with NumPy, as the reference
builds it, and shipped to the device: ``torch.linspace`` rounds its nodes
differently.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bdlz_tpu_torch.backend import F64
from bdlz_tpu_torch.physics.thermo import hubble_rate

#: Default z-grid extent and resolution (reference `AoverVKernel.__init__`).
Z_MAX_DEFAULT: float = 30.0
NZ_DEFAULT: int = 1200


def y_of_T(T, T_p, beta_over_H):
    """Percolation time variable y(T) = ½ (β/H)_p [(T_p/T)² − 1]."""
    return 0.5 * beta_over_H * ((T_p / torch.clamp_min(T, 1e-30)) ** 2 - 1.0)


def T_of_y(y, T_p, beta_over_H):
    """Inverse map T(y) = T_p / √(1 + 2y/B); T_p·1e6 outside the sensible range."""
    denom = 1.0 + 2.0 * y / torch.clamp_min(beta_over_H, 1e-30)
    safe = torch.clamp_min(denom, 1e-12)
    return torch.where(denom <= 1e-12, T_p * 1e6, T_p / torch.sqrt(safe))


class KJMAGrid(NamedTuple):
    """z-quadrature data of the KJMA integral: nodes, z² e^{−z}, and
    γ₄(z) = 6 − e^{−z}(z³ + 3z² + 6z + 6)."""

    z: torch.Tensor
    weight: torch.Tensor
    gamma4: torch.Tensor


def make_kjma_grid_numpy(z_max: float = Z_MAX_DEFAULT, nz: int = NZ_DEFAULT):
    """The fixed z-grid as host NumPy arrays, with the reference's exact
    operations (`first_principles_yields.py:154-156`)."""
    z = np.linspace(0.0, z_max, nz)
    ez = np.exp(-z)
    gamma4 = 6.0 - ez * (z**3 + 3.0 * z**2 + 6.0 * z + 6.0)
    return z, z**2 * ez, gamma4


def make_kjma_grid(device, z_max: float = Z_MAX_DEFAULT, nz: int = NZ_DEFAULT) -> KJMAGrid:
    """The fixed z-grid as float64 tensors on ``device`` (built on the host)."""
    return KJMAGrid(*(
        torch.as_tensor(a, dtype=F64, device=device)
        for a in make_kjma_grid_numpy(z_max, nz)
    ))


def pairwise_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum along the last axis in a fixed pairwise order: halve the axis
    with elementwise adds (zero-padding an odd length) until one term is
    left.  Every row is summed in the same order whatever the batch shape
    or the row's position in memory, which ``Tensor.sum`` does not promise
    on a CUDA device (its split of a row depends on the output count and
    the row's alignment)."""
    n = t.shape[-1]
    while n > 1:
        if n % 2:
            t = torch.cat([t, torch.zeros_like(t[..., :1])], dim=-1)
            n += 1
        n //= 2
        t = t[..., :n] + t[..., n:]
    return t[..., 0]


def trapezoid(f: torch.Tensor, x: torch.Tensor, fixed_order: bool = False) -> torch.Tensor:
    """Trapezoid rule along the last axis, in NumPy's operation order:
    Σ d·(f[1:] + f[:-1]) / 2 with d = diff(x).  ``fixed_order`` sums with
    :func:`pairwise_sum`, so a row's result is the same bits in any batch."""
    d = x[..., 1:] - x[..., :-1]
    terms = d * (f[..., 1:] + f[..., :-1]) / 2.0
    return pairwise_sum(terms) if fixed_order else terms.sum(dim=-1)


def area_over_volume(y, I_p, beta_over_H, T_p, v_w, g_star, grid: KJMAGrid,
                     fixed_order: bool = False):
    """KJMA bubble-wall area per unit volume [A/V](y) [GeV] with the z-integral
    done directly on the fixed grid: (I_p/2)(β/v_w) e^y ∫ z² e^{−z}
    exp(−(I_p/6) e^y γ₄(z)) dz.  Parameters broadcast against ``y``; the
    z-axis is appended for the reduction (summed in a fixed order when
    ``fixed_order``, as the stiff engine needs for lane independence)."""
    H_p = hubble_rate(T_p, g_star)
    beta = beta_over_H * H_p
    v_w_safe = torch.clamp_min(v_w, 1e-12)

    expy = torch.exp(torch.clamp(y, -50.0, 50.0))
    prefactor = (I_p / 2.0) * (beta / v_w_safe) * expy

    # (..., n_z): the per-node scale is formed at the node shape, then
    # broadcast against the z-grid (same products as the reference).
    exponent = (-(I_p / 6.0) * expy)[..., None] * grid.gamma4
    integrand = grid.weight * torch.exp(exponent)
    F = trapezoid(integrand, grid.z, fixed_order)
    return torch.where(y > 50.0, 0.0, prefactor * F)
