"""End-to-end yields pipeline: PointParams -> present-day observables.

Counterpart of ``bdlz_tpu/models/yields_pipeline.py``, batched over a
leading point axis: every function takes a PointParams of (P,) float64
tensors and returns (P,) tensors.  Regime semantics follow the reference
(:376-384): the thermal regime evaluates n_eq(T_hi)/s(T_hi), the
nonthermal regime passes the resolved initial yield through; the
present-day conversion (:413-417) uses s₀ = 2891 cm⁻³.

Only the trapezoid y-quadrature is ported so far; the snapped-panel
Gauss–Legendre rule (``static.quad_panel_gl is True``) raises until
``solvers/panels.py`` is ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from bdlz_tpu_torch.config import PointParams, StaticChoices
from bdlz_tpu_torch.constants import GEV_TO_KG, S0_M3
from bdlz_tpu_torch.physics.percolation import KJMAGrid
from bdlz_tpu_torch.physics.thermo import entropy_density, n_chi_equilibrium
from bdlz_tpu_torch.solvers.quadrature import (
    integrate_YB_quadrature,
    integrate_YB_quadrature_tabulated,
)


class YieldsResult(NamedTuple):
    """The five archived outputs (`yields_out.json` schema, reference :423-427)."""

    Y_B: torch.Tensor
    Y_chi: torch.Tensor
    rho_B_kg_m3: torch.Tensor
    rho_DM_kg_m3: torch.Tensor
    DM_over_B: torch.Tensor


def present_day(Y_B, Y_chi, m_chi_GeV, m_B_kg) -> YieldsResult:
    """Comoving yields to today's mass densities and their ratio, with the
    reference's 1e-300 floor on the ratio denominator."""
    rho_B = Y_B * S0_M3 * m_B_kg
    rho_DM = Y_chi * S0_M3 * (m_chi_GeV * GEV_TO_KG)
    ratio = rho_DM / torch.clamp_min(rho_B, 1e-300)
    return YieldsResult(Y_B, Y_chi, rho_B, rho_DM, ratio)


def final_Y_chi_quadrature(pp: PointParams, static: StaticChoices) -> torch.Tensor:
    """Y_χ on the quadrature path, regime-dispatched (reference :376-384)."""
    if static.regime.lower().startswith("therm"):
        T_hi = pp.T_max_over_Tp * pp.T_p_GeV
        n_eq = n_chi_equilibrium(T_hi, pp.m_chi_GeV, pp.g_chi, static.chi_stats)
        return n_eq / entropy_density(T_hi, pp.g_star_s)
    return pp.Y_chi_init * torch.ones_like(pp.m_chi_GeV)


def _require_trapezoid(static: StaticChoices) -> None:
    if static.quad_panel_gl is True:
        raise NotImplementedError(
            "quad_panel_gl=True needs the snapped-panel Gauss-Legendre rule, "
            "which is not ported yet; use the trapezoid (quad_panel_gl null/false)"
        )


def point_yields(pp: PointParams, static: StaticChoices, grid: KJMAGrid) -> YieldsResult:
    """Full pipeline on the direct quadrature path (the bit-pinned reference
    integrand, one (P, n_y, 1200) tensor)."""
    _require_trapezoid(static)
    Y_B = integrate_YB_quadrature(pp, static.chi_stats, grid, n_y=static.n_y)
    Y_chi = final_Y_chi_quadrature(pp, static)
    return present_day(Y_B, Y_chi, pp.m_chi_GeV, pp.m_B_kg)


def point_yields_fast(
    pp: PointParams, static: StaticChoices, table, n_y: int = 8000
) -> YieldsResult:
    """Pipeline with the tabulated KJMA kernel in plain PyTorch — the
    sweep's ``impl="tabulated"`` engine."""
    _require_trapezoid(static)
    Y_B = integrate_YB_quadrature_tabulated(pp, static.chi_stats, table, n_y=n_y)
    Y_chi = final_Y_chi_quadrature(pp, static)
    return present_day(Y_B, Y_chi, pp.m_chi_GeV, pp.m_B_kg)
