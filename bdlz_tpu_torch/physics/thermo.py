"""Thermodynamics / cosmology library (framework layer L1) in PyTorch.

Counterpart of ``bdlz_tpu/physics/thermo.py`` with the same operation
order and guard rails (reference `first_principles_yields.py:84-123`):

* the hard relativistic/non-relativistic branch at ``T > m/3`` in both the
  equilibrium density and the mean speed;
* the ``max(T, 1e-30)`` floor inside the Boltzmann exponent;
* the ``max(m, 1e-20)`` floor in the mean speed.

Arguments are float64 tensors that broadcast against each other (a batch
passes per-point parameters as (P, 1) against (P, n_y) node tensors).
``entropy_density`` and ``hubble_rate`` are plain arithmetic and also
take Python floats.
"""
from __future__ import annotations

import math

import torch

from bdlz_tpu_torch.constants import HUBBLE_COEFF, MPL_GEV, PI, ZETA3


def is_fermion(stats: str) -> bool:
    """Reference statistics-string convention (`first_principles_yields.py:96`)."""
    return str(stats).lower().startswith("ferm")


def relativistic_density_coeff(g, stats: str):
    """Coefficient c in n_rel = c * T^3 (fermion: 3ζ3/4π² per dof; boson: ζ3/π²)."""
    if is_fermion(stats):
        return g * (3.0 * ZETA3 / (4.0 * PI**2))
    return g * (ZETA3 / (PI**2))


def hubble_rate(T, g_star):
    """Radiation-domination Hubble rate H = 1.66 √g* T²/M_Pl  [GeV]."""
    sq = torch.sqrt(g_star) if torch.is_tensor(g_star) else math.sqrt(g_star)
    return HUBBLE_COEFF * sq * T * T / MPL_GEV


def entropy_density(T, g_star_s):
    """Entropy density s = (2π²/45) g*_s T³  [GeV³]."""
    return (2.0 * PI**2 / 45.0) * g_star_s * T**3


def n_chi_equilibrium(T: torch.Tensor, m, g, stats: str) -> torch.Tensor:
    """Equilibrium χ number density n_eq(T) [GeV³], piecewise at T = m/3:
    c_rel·T³ when relativistic, else g (m/2π)^{3/2} T^{3/2} e^{−m/max(T,1e-30)}."""
    c_rel = relativistic_density_coeff(g, stats)
    relativistic = c_rel * T**3
    mb_coeff = g * (m / (2.0 * PI)) ** 1.5
    boltzmann = mb_coeff * T**1.5 * torch.exp(-m / torch.clamp_min(T, 1e-30))
    return torch.where(T > m / 3.0, relativistic, boltzmann)


def mean_speed_chi(T: torch.Tensor, m) -> torch.Tensor:
    """Mean χ speed: 1 when relativistic (T > m/3), else √(8T/(π m))."""
    thermal_sq = 8.0 * T / (PI * torch.clamp_min(m, 1e-20))
    thermal = torch.sqrt(torch.clamp_min(thermal_sq, 0.0))
    return torch.where(T > m / 3.0, 1.0, thermal)


def wall_flux(T: torch.Tensor, m, g, stats: str) -> torch.Tensor:
    """Kinetic-theory flux onto the wall J_χ = ¼ n_eq v̄  [GeV³]."""
    return 0.25 * n_chi_equilibrium(T, m, g, stats) * mean_speed_chi(T, m)
