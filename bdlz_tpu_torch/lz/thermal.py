"""Finite-temperature oscillator-bath dephasing (arXiv:1410.0516).

Counterpart of ``bdlz_tpu/lz/thermal.py``.  The thermal scenario replaces
the dephased kernel's free Γ_φ by the rate of an Ohmic bath with an
exponential cutoff at the sweep point's own temperature,

    Γ_φ(T, η, ω_c) = 2 η T (1 − e^{−ω_c/T}),

which is 2ηT for T ≪ ω_c and saturates at 2ηω_c for T ≫ ω_c.  Γ = 0 IS
the coherent kernel, and the cold limit reproduces it bit for bit: the
Γ = 0 case goes through the quaternion path itself, not the Bloch path at
zero rate.  Units: T and ω_c in GeV, η dimensionless.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np

from bdlz_tpu_torch.lz.profile import BounceProfile, load_profile_csv


def validate_bath(eta: float, omega_c: float) -> Tuple[float, float]:
    """Host-boundary bath contract shared by every thermal seam."""
    eta = float(eta)
    omega_c = float(omega_c)
    if eta < 0.0 or omega_c < 0.0:
        raise ValueError(
            f"bath coupling eta and cutoff omega_c must be >= 0, got "
            f"eta={eta}, omega_c={omega_c}"
        )
    return eta, omega_c


def thermal_gamma_phi(T_GeV, eta: float, omega_c_GeV: float):
    """``Γ_φ = 2 η T (1 − e^{−ω_c/T})``, vectorized over ``T_GeV``.  T ≤ 0
    maps to exactly 0.0 (the coherent limit); a NaN T stays NaN."""
    eta, omega_c = validate_bath(eta, omega_c_GeV)
    T = np.asarray(T_GeV, dtype=np.float64)
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        x = np.where(T > 0.0, omega_c / np.where(T > 0.0, T, 1.0), np.inf)
        gam = 2.0 * eta * np.where(T > 0.0, T, 0.0) * (-np.expm1(-x))
    out = np.where(T > 0.0, gam, 0.0)
    # T > 0 is False for NaN, which would map a poisoned point onto the
    # coherent limit; the sweep's failure mask absorbs the NaN instead
    out = np.where(np.isnan(T), np.nan, out)
    return float(out) if np.ndim(T_GeV) == 0 else out


def thermal_method_for(gamma_phi: float) -> Tuple[str, float]:
    """``(method, gamma)`` the thermal scenario evaluates P with: Γ = 0
    goes through the coherent (quaternion) path."""
    g = float(gamma_phi)
    if g < 0.0:
        raise ValueError(f"gamma_phi must be >= 0, got {g}")
    return ("coherent", 0.0) if g == 0.0 else ("dephased", g)


def thermal_probability(
    profile: Union[str, BounceProfile],
    v_w: float,
    T_GeV: float,
    eta: float,
    omega_c_GeV: float,
    device=None,
) -> float:
    """P_{χ→B} under bath dephasing at one (v_w, T) point (host seam)."""
    from bdlz_tpu_torch.lz.kernel import (
        dephased_probability,
        transfer_matrix_propagation,
    )

    if isinstance(profile, str):
        profile = load_profile_csv(profile)
    method, gam = thermal_method_for(
        thermal_gamma_phi(float(T_GeV), eta, omega_c_GeV)
    )
    if method == "coherent":
        _, P = transfer_matrix_propagation(profile, v_w, device=device)
        return float(min(max(P, 0.0), 1.0))
    return dephased_probability(profile, v_w, gam, device=device)


def thermal_probabilities_for_points(
    profile: Union[str, BounceProfile],
    v_w,
    T_p_GeV,
    eta: float,
    omega_c_GeV: float,
    device=None,
) -> np.ndarray:
    """P per sweep point with Γ_φ derived from each point's own T_p.
    Points are grouped by their rate, and each group's speeds go through
    the two-channel batch path (the Γ = 0 group through the coherent
    kernel); non-finite (T, v) rows stay NaN."""
    from bdlz_tpu_torch.lz.sweep_bridge import probabilities_for_points

    if isinstance(profile, str):
        profile = load_profile_csv(profile)
    v_w = np.asarray(v_w, dtype=np.float64)
    if v_w.size == 0:
        validate_bath(eta, omega_c_GeV)
        return np.zeros(0)
    T = np.broadcast_to(np.asarray(T_p_GeV, dtype=np.float64), v_w.shape)
    gam = np.atleast_1d(np.asarray(thermal_gamma_phi(T, eta, omega_c_GeV)))
    out = np.full(v_w.shape, np.nan)
    finite = np.isfinite(gam) & np.isfinite(v_w)
    for g in np.unique(gam[finite]):
        sel = finite & (gam == g)
        method, g_used = thermal_method_for(float(g))
        out[sel] = probabilities_for_points(
            profile, v_w[sel], method=method, gamma_phi=g_used, device=device
        )
    return out
