"""Bounce-epoch Boltzmann system (the general ODE path, layer L4).

Counterpart of ``make_rhs`` in ``bdlz_tpu/solvers/boltzmann.py``, batched
over lanes.  State Y = [Y_χ, Y_B], (P, 2), evolved in x = m_χ/T:

    dY_χ/dx = (−⟨σv⟩ s (Y_χ² − Y_χ,eq²) − [deplete]·S_B/s) / (H x)
    dY_B/dx = (S_B/s − Γ_wash H Y_B) / (H x)

with the reference's floors (H, s at 1e-300; x at 1e-30; σv and Γ_wash
at 0).  Everything but Y_χ and Y_B enters through x alone — T, H, s, y,
A/V, J, S_B and Y_χ,eq — so :meth:`BoltzmannRHS.at` evaluates that part
once per abscissa and returns an :class:`RHSStage` whose ``f`` and
``jac`` cost a few (P,) operations each: the stiff stepper's Newton
iterations re-evaluate only those.  The Jacobian is diagonal and given in
closed form.

The JAX package's SciPy Radau path (``solve_scipy_radau``,
``SplineAovTable``) belongs to its NumPy backend, which the port does not
have; it is not ported, and the tests use it as the truth.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from bdlz_tpu_torch.config import PointParams
from bdlz_tpu_torch.physics.percolation import KJMAGrid, area_over_volume, y_of_T
from bdlz_tpu_torch.physics.source import source_window
from bdlz_tpu_torch.physics.thermo import (
    entropy_density,
    hubble_rate,
    n_chi_equilibrium,
    wall_flux,
)


class RHSStage(NamedTuple):
    """The right-hand side at one abscissa per lane, as functions of Y:
    ``f(Y)`` → (P, 2) and ``jac(Y)`` → ((J00, J01), (J10, J11)) of (P,)
    tensors, where None marks an entry that is identically zero."""

    f: Callable[[torch.Tensor], torch.Tensor]
    jac: Callable[[torch.Tensor], tuple]


class BoltzmannRHS:
    """f(x, Y) → dY/dx for a batch of lanes (``pp`` holds (P,) tensors,
    ``x`` is (P,)).  ``A_over_V_T`` optionally replaces the exact KJMA
    z-integral with a lookup of A/V(T)."""

    def __init__(self, pp: PointParams, chi_stats: str, deplete: bool,
                 grid: Optional[KJMAGrid],
                 A_over_V_T: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.pp = pp
        self.chi_stats = chi_stats
        self.deplete = bool(deplete)
        self.grid = grid
        self.A_over_V_T = A_over_V_T

    def at(self, x: torch.Tensor) -> RHSStage:
        pp = self.pp
        T = pp.m_chi_GeV / torch.clamp_min(x, 1e-30)
        H = torch.clamp_min(hubble_rate(T, pp.g_star), 1e-300)
        s = torch.clamp_min(entropy_density(T, pp.g_star_s), 1e-300)
        y = y_of_T(T, pp.T_p_GeV, pp.beta_over_H)
        if self.A_over_V_T is None:
            # summed in a fixed order: a lane's bits must not depend on
            # which other lanes share its batch
            av = area_over_volume(y, pp.I_p, pp.beta_over_H, pp.T_p_GeV, pp.v_w,
                                  pp.g_star, self.grid, fixed_order=True)
        else:
            av = self.A_over_V_T(T)
        J = pp.flux_scale * wall_flux(T, pp.m_chi_GeV, pp.g_chi, self.chi_stats)
        SB = pp.P * J * av * source_window(y, pp.sigma_y)

        sigmav = torch.clamp_min(pp.sigma_v, 0.0)
        Ychi_eq = n_chi_equilibrium(T, pp.m_chi_GeV, pp.g_chi, self.chi_stats) / s
        gamma_w = torch.clamp_min(pp.Gamma_wash_over_H, 0.0)
        # the reference's association order: (−σv·s)·(Y_χ² − Y_eq²),
        # S_B/s − (Γ·H)·Y_B, each over (H·x)
        ann = -sigmav * s
        eq2 = Ychi_eq ** 2
        src = SB / s
        wash = gamma_w * H
        Hx = H * x
        deplete = self.deplete
        j11 = -wash / Hx

        def f(Y):
            Ychi, YB = Y[:, 0], Y[:, 1]
            num = ann * (Ychi ** 2 - eq2)
            if deplete:
                num = num - src
            return torch.stack([num / Hx, (src - wash * YB) / Hx], dim=-1)

        def jac(Y):
            return ((ann * (2.0 * Y[:, 0]) / Hx, None), (None, j11))

        return RHSStage(f, jac)

    def __call__(self, x: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return self.at(x).f(Y)


def make_rhs(
    pp: PointParams,
    chi_stats: str,
    deplete: bool,
    grid: Optional[KJMAGrid],
    A_over_V_T: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> BoltzmannRHS:
    """The batched RHS f(x, Y) → dY/dx (see :class:`BoltzmannRHS`)."""
    return BoltzmannRHS(pp, chi_stats, deplete, grid, A_over_V_T)
