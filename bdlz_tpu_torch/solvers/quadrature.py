"""Direct-quadrature yield solver (the fast path, framework layer L4).

Counterpart of ``bdlz_tpu/solvers/quadrature.py``, batched over a leading
point axis: Y_B = ∫ S_B(T) / (s(T) H(T) T) dT on a uniform y-grid over the
kernel's support, with the reference's scalar semantics
(`first_principles_yields.py:231-267`) — y-support clips [−80, +50], the
1e-12 denominator floor, the analytic Jacobian dT/dy, the n_y ≥ 2000
floor, and exactly 0 for an empty window.

``pp`` is a PointParams of (P,) float64 tensors; y-grids are (P, n_y).
"""
from __future__ import annotations

import torch

from bdlz_tpu_torch.backend import F64
from bdlz_tpu_torch.config import PointParams
from bdlz_tpu_torch.physics.percolation import (
    KJMAGrid,
    area_over_volume,
    trapezoid,
    y_of_T,
)
from bdlz_tpu_torch.physics.source import source_window
from bdlz_tpu_torch.physics.thermo import (
    entropy_density,
    hubble_rate,
    mean_speed_chi,
    n_chi_equilibrium,
)

#: Physical support of the KJMA kernel in y (reference :238-241).
Y_NEG_CUT: float = -80.0
Y_POS_CUT: float = +50.0


def quadrature_bounds(pp: PointParams):
    """Clipped y-integration bounds per point (reference :234-241), (P,) each."""
    T_hi = pp.T_max_over_Tp * pp.T_p_GeV
    T_lo = pp.T_min_over_Tp * pp.T_p_GeV
    y_lo = torch.clamp_min(y_of_T(T_hi, pp.T_p_GeV, pp.beta_over_H), Y_NEG_CUT)
    y_hi = torch.clamp_max(y_of_T(T_lo, pp.T_p_GeV, pp.beta_over_H), Y_POS_CUT)
    return y_lo, y_hi


def linspace_rows(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """Per-row uniform grids (P, n): ``lo + i·((hi − lo)/(n − 1))`` with the
    last node set exactly to ``hi`` — NumPy's linspace arithmetic
    (``torch.linspace`` takes no tensor endpoints)."""
    i = torch.arange(n, dtype=F64, device=lo.device)
    ys = i * ((hi - lo) / (n - 1))[:, None] + lo[:, None]
    ys[:, -1] = hi
    return ys


def _columns(pp: PointParams) -> PointParams:
    """Per-point parameters as (P, 1) columns, to broadcast against nodes."""
    return PointParams(*(f[:, None] for f in pp))


def _integrand(ys, pp: PointParams, chi_stats: str, Av) -> torch.Tensor:
    """S_B/(s·H·T)·|dT/dy| at the nodes, given the A/V values (the body the
    direct and tabulated integrands share, in the reference's order)."""
    B_safe = torch.clamp_min(pp.beta_over_H, 1e-30)
    denom = torch.clamp_min(1.0 + 2.0 * ys / B_safe, 1e-12)
    Ts = pp.T_p_GeV / torch.sqrt(denom)
    dTdy = -(pp.T_p_GeV / B_safe) * denom ** (-1.5)

    Hs = hubble_rate(Ts, pp.g_star)
    ss = entropy_density(Ts, pp.g_star_s)
    Js = (
        pp.flux_scale
        * 0.25
        * n_chi_equilibrium(Ts, pp.m_chi_GeV, pp.g_chi, chi_stats)
        * mean_speed_chi(Ts, pp.m_chi_GeV)
    )
    SB = pp.P * Js * Av(ys) * source_window(ys, pp.sigma_y)
    return SB / (ss * Hs * Ts) * torch.abs(dTdy)


def yb_integrand_direct(ys, pp: PointParams, chi_stats: str, grid: KJMAGrid):
    """dY_B/dy at (P, n_y) nodes with the DIRECT (n_z-integrated) kernel."""
    c = _columns(pp)
    return _integrand(ys, c, chi_stats, lambda y: area_over_volume(
        y, c.I_p, c.beta_over_H, c.T_p_GeV, c.v_w, c.g_star, grid
    ))


def yb_integrand_tabulated(ys, pp: PointParams, chi_stats: str, table):
    """dY_B/dy at (P, n_y) nodes with the tabulated KJMA kernel."""
    from bdlz_tpu_torch.ops.kjma_table import area_over_volume_tabulated

    c = _columns(pp)
    return _integrand(ys, c, chi_stats, lambda y: area_over_volume_tabulated(
        y, c.beta_over_H, c.T_p_GeV, c.v_w, c.g_star, table
    ))


def _integrate(pp: PointParams, n_y: int, integrand) -> torch.Tensor:
    n_y = max(int(n_y), 2000)
    y_lo, y_hi = quadrature_bounds(pp)
    ys = linspace_rows(y_lo, y_hi, n_y)
    YB = trapezoid(integrand(ys), ys)
    return torch.where(y_hi > y_lo, YB, 0.0)


def integrate_YB_quadrature(
    pp: PointParams, chi_stats: str, grid: KJMAGrid, n_y: int = 8000
) -> torch.Tensor:
    """Comoving baryon yield Y_B per point, direct kernel; (P,)."""
    return _integrate(
        pp, n_y, lambda ys: yb_integrand_direct(ys, pp, chi_stats, grid)
    )


def integrate_YB_quadrature_tabulated(
    pp: PointParams, chi_stats: str, table, n_y: int = 8000
) -> torch.Tensor:
    """Fast-path Y_B per point with the KJMA z-integral looked up from the
    F-table; (P,)."""
    return _integrate(
        pp, n_y, lambda ys: yb_integrand_tabulated(ys, pp, chi_stats, table)
    )
