"""Physical constants and unit conversions (framework layer L0).

Values are bit-identical to the JAX package's ``bdlz_tpu/constants.py``,
which in turn matches the reference pipeline
(`first_principles_yields.py:33-39`).
"""
from __future__ import annotations

import math

#: Riemann zeta(3), used in relativistic equilibrium number densities.
ZETA3: float = 1.202056903159594

PI: float = math.pi

#: Planck mass in GeV entering H = 1.66 sqrt(g*) T^2 / M_Pl.
MPL_GEV: float = 1.220890e19

#: Radiation-domination Hubble prefactor: H = HUBBLE_COEFF sqrt(g*) T^2 / M_Pl
#: (the sqrt(8 pi^3/90) ~ 1.66 convention of the reference, :84).
HUBBLE_COEFF: float = 1.66

#: Present-day entropy density, cm^-3 and m^-3.
S0_CM3: float = 2891.0
S0_M3: float = S0_CM3 * 1e6

#: GeV -> kg mass conversion.
GEV_TO_KG: float = 1.78266192e-27

#: Proton mass in kg (CODATA).
M_PROTON_KG: float = 1.67262192369e-27

#: Planck 2018 target for Omega_DM / Omega_b (reference PDF section 7, Eq. 22).
PLANCK_DM_OVER_B: float = 5.357

#: Critical density / h^2, kg m^-3 (Planck-normalisation for Omega h^2).
RHO_CRIT_OVER_H2_KG_M3: float = 1.87834e-26

#: Planck 2018 baryon / cold-DM density measurements (TT,TE,EE+lowE+lensing).
PLANCK_OMEGA_B_H2: float = 0.02237
PLANCK_OMEGA_B_H2_SIGMA: float = 0.00015
PLANCK_OMEGA_DM_H2: float = 0.1200
PLANCK_OMEGA_DM_H2_SIGMA: float = 0.0012
