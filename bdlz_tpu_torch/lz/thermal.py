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
import torch

from bdlz_tpu_torch.backend import F64, resolve_device
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

    The points go to ``device`` once and are grouped there: the distinct
    (T_p, v_w) pairs are the lanes, with an inverse index from the points
    to them, and both come back to the host once.  The rates are NumPy's
    :func:`thermal_gamma_phi` on the distinct temperatures.  The Γ = 0
    lanes go through one coherent pass, every lane with Γ_φ > 0 through
    one dephased pass at its own rate; the lanes' P is scattered to the
    points by the inverse, and rows whose rate or speed is not finite
    stay NaN.  A lane's P is the bits of one pass per rate, as the kernel
    and the plain tree compute each lane alone."""
    from bdlz_tpu_torch.lz.sweep_bridge import _propagated

    eta, omega_c = validate_bath(eta, omega_c_GeV)
    if isinstance(profile, str):
        profile = load_profile_csv(profile)
    v_w = np.asarray(v_w, dtype=np.float64)
    if v_w.size == 0:
        return np.zeros(0)
    dev = resolve_device(device)
    v = torch.as_tensor(v_w.reshape(-1), dtype=F64, device=dev)
    T = torch.as_tensor(np.asarray(T_p_GeV, dtype=np.float64), dtype=F64, device=dev)
    T = torch.broadcast_to(T, v_w.shape).reshape(-1)
    inf = torch.tensor(np.inf, dtype=F64, device=dev)
    # one key for every NaN T (its rate, as +inf's, is NaN) and for every
    # non-finite speed (the point is NaN whatever its rate)
    T_u, T_of = torch.unique(torch.where(torch.isnan(T), inf, T), return_inverse=True)
    v_u, v_of = torch.unique(torch.where(torch.isfinite(v), v, inf), return_inverse=True)
    n_v = v_u.numel()
    keys, lane_of = torch.unique(T_of * n_v + v_of, return_inverse=True)
    # layer boundary: the lanes and the points' lane index go to the host once
    T_u, v_u, keys, lane_of = (t.cpu().numpy() for t in (T_u, v_u, keys, lane_of))  # bdlz-lint: disable=R3
    rate = thermal_gamma_phi(T_u, eta, omega_c)[keys // n_v]
    lane_v = v_u[keys % n_v]
    speed = np.clip(lane_v, 1e-6, 1.0 - 1e-12)
    ok = np.isfinite(rate) & np.isfinite(lane_v)
    P = np.full(keys.shape, np.nan)
    for method, sel in (("coherent", ok & (rate == 0.0)), ("dephased", ok & (rate > 0.0))):
        if np.any(sel):
            P[sel] = _propagated(profile, speed[sel], method, rate[sel], dev)
    return P[lane_of].reshape(v_w.shape)
