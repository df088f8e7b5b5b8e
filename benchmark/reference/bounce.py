"""Plain reference of the O(4) bounce, its wall profile and the local LZ probability.

The potential V(phi) = (lam4/8)(phi^2 - v^2)^2 - (eps/2)(phi/v + 1) has its
false vacuum near -v and its true vacuum near +v.  The bounce solves

    phi'' + (3/rho) phi' = V'(phi),   phi'(0) = 0,   phi(inf) = phi_false,

found here by bisecting the release point phi0 between the barrier top and
the true vacuum: a trajectory integrated by SciPy's DOP853 at rtol 1e-12
either overshoots (phi dips below phi_false) or turns back (phi' > 0).  The
configuration's profile scheme follows: a fixed-grid RK4 pass of
``n_dense`` steps over [rho0, rho_max] from the series start
phi(rho0) = phi0 + V'(phi0) rho0^2/8, with the state frozen onto phi_false
once within 1e-4 of the vacuum gap; the wall radius where phi first
reaches phi_mid = (phi_true + phi_false)/2, by linear interpolation,
moved up to the first double at which phi < phi_mid; ``n_xi`` samples of
Delta = g_Delta (phi - phi_mid) over +-``halfwidth``/mu around it
(mu = v sqrt(lam4)/2).  The local Landau-Zener composition then gives

    lambda = m_mix0^2 / (v_w |Delta'(xi*)|),   P = 1 - exp(-2 pi lambda),

with Delta' the slope of the sampled profile across its sign change.

NumPy and SciPy only, in float64 or (for the control) float32: the
release point's halvings, the dense pass, the profile and P are then
computed in that type.  Nothing of the program under test is imported.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import numpy as np

OVERSHOOT_FRAC = 1e-6     # overshoot: phi below phi_false by this share of the gap
SETTLE_FRAC = 1e-4        # the dense pass freezes onto phi_false within this share
HI_OFFSET_FRAC = 1e-13    # the bracket's upper end: phi_true - gap * this


class Bounce(NamedTuple):
    phi0: float
    r_wall: float
    slope: float          # |Delta'| at the crossing of the sampled profile
    n_crossings: int


def _dV(phi, lam4, v, eps):
    return 0.5 * lam4 * phi * (phi * phi - v * v) - 0.5 * eps / v


def vacua(lam4: float, v: float, eps: float):
    """(phi_false, phi_top, phi_true): the real roots of V', ascending."""
    roots = np.roots([0.5 * lam4, 0.0, -0.5 * lam4 * v * v, -0.5 * eps / v])
    if np.any(np.abs(roots.imag) > 1e-12):
        raise ValueError(f"V' has complex roots for lam4={lam4}, eps={eps}: no barrier")
    out = []
    for r in np.sort(roots.real):
        for _ in range(4):  # polish the roots by Newton
            r = r - _dV(r, lam4, v, eps) / (0.5 * lam4 * (3.0 * r * r - v * v))
        out.append(float(r))
    return tuple(out)


def _overshoots(phi0: float, lam4, v, eps, phi_false, gap, rho0, rho_max) -> bool:
    from scipy.integrate import solve_ivp

    dv0 = _dV(phi0, lam4, v, eps)
    y0 = [phi0 + 0.125 * dv0 * rho0 * rho0, 0.25 * dv0 * rho0]
    floor = phi_false - OVERSHOOT_FRAC * gap

    def rhs(rho, y):
        return [y[1], _dV(y[0], lam4, v, eps) - 3.0 * y[1] / rho]

    def over(rho, y):
        return y[0] - floor

    def back(rho, y):
        return y[1]

    over.terminal, over.direction = True, -1.0
    back.terminal, back.direction = True, 1.0
    sol = solve_ivp(rhs, (rho0, rho_max), y0, method="DOP853", rtol=1e-12, atol=1e-14,
                    events=(over, back))
    return len(sol.t_events[0]) > 0


def release_point(lam4, v, eps, *, rho0, rho_max, n_bisect, dtype=np.float64) -> float:
    phi_false, phi_top, phi_true = vacua(lam4, v, eps)
    gap = phi_true - phi_false
    lo, hi = dtype(phi_top), dtype(phi_true - HI_OFFSET_FRAC * gap)
    for _ in range(int(n_bisect)):
        mid = dtype(dtype(0.5) * (lo + hi))
        if _overshoots(float(mid), lam4, v, eps, phi_false, gap, rho0, rho_max):
            hi = mid
        else:
            lo = mid
    return float(lo)


def dense_profile(phi0, lam4, v, eps, *, rho0, rho_max, n_dense, dtype=np.float64):
    """The fixed-grid RK4 pass: (rho, phi) on n_dense + 1 nodes."""
    phi_false, _top, phi_true = vacua(lam4, v, eps)
    gap = phi_true - phi_false
    t = dtype
    lam4_, v_, eps_ = t(lam4), t(v), t(eps)
    h = t((rho_max - rho0) / n_dense)
    settle = t(phi_false + SETTLE_FRAC * gap)

    def f(rho, p, q):
        return q, t(0.5) * lam4_ * p * (p * p - v_ * v_) - t(0.5) * eps_ / v_ - t(3.0) * q / rho

    dv0 = _dV(t(phi0), lam4_, v_, eps_)
    p = t(phi0) + t(0.125) * dv0 * t(rho0) * t(rho0)
    q = t(0.25) * dv0 * t(rho0)
    phis = np.empty(n_dense + 1, dtype=t)
    phis[0] = p
    for k in range(n_dense):
        rho = t(rho0) + h * t(k)
        k1p, k1q = f(rho, p, q)
        k2p, k2q = f(rho + t(0.5) * h, p + t(0.5) * h * k1p, q + t(0.5) * h * k1q)
        k3p, k3q = f(rho + t(0.5) * h, p + t(0.5) * h * k2p, q + t(0.5) * h * k2q)
        k4p, k4q = f(rho + h, p + h * k3p, q + h * k3q)
        p2 = p + (h / t(6.0)) * (k1p + t(2.0) * k2p + t(2.0) * k3p + k4p)
        q2 = q + (h / t(6.0)) * (k1q + t(2.0) * k2q + t(2.0) * k3q + k4q)
        if p2 < settle:
            p2, q2 = t(phi_false), t(0.0)
        p, q = p2, q2
        phis[k + 1] = p
    rho = t(rho0) + h * np.arange(n_dense + 1, dtype=t)
    return rho, phis


def shoot(potential: Mapping, solver: Mapping, dtype=np.float64) -> Bounce:
    """The bounce of ``potential`` (lam4, vev, eps, g_delta) under the
    configuration's ``solver`` knobs, and its profile's crossing slope."""
    lam4, v, eps = float(potential["lam4"]), float(potential["vev"]), float(potential["eps"])
    g = float(potential["g_delta"])
    t = dtype
    phi0 = release_point(lam4, v, eps, rho0=solver["rho0"], rho_max=solver["rho_max"],
                         n_bisect=solver["n_bisect"], dtype=t)
    rho, phi = dense_profile(phi0, lam4, v, eps, rho0=solver["rho0"], rho_max=solver["rho_max"],
                             n_dense=solver["n_dense"], dtype=t)
    phi_false, _top, phi_true = vacua(lam4, v, eps)
    phi_mid = t(0.5 * (phi_true + phi_false))
    below = np.flatnonzero(phi <= phi_mid)
    if below.size == 0 or below[0] == 0:
        raise RuntimeError(f"the shot profile never crosses phi_mid ({potential})")
    i = below[0]
    denom = phi[i] - phi[i - 1]
    r_wall = rho[i - 1] + (phi_mid - phi[i - 1]) / (denom if denom != 0 else t(1.0)) * (rho[i] - rho[i - 1])
    while not np.interp(r_wall, rho, phi) < phi_mid:
        r_wall = np.nextafter(r_wall, t(np.inf))
    mu = 0.5 * v * math.sqrt(lam4)
    half = t(float(solver["xi_halfwidth_walls"]) / mu)
    xi = np.linspace(-half, half, int(solver["n_xi"])).astype(t)
    delta = t(g) * (np.interp(xi + r_wall, rho, phi).astype(t) - phi_mid)
    cross = np.flatnonzero(delta[:-1] * delta[1:] < 0)
    if cross.size != 1:
        raise RuntimeError(f"the sampled profile crosses {cross.size} times, not once ({potential})")
    j = cross[0]
    slope = abs((delta[j + 1] - delta[j]) / (xi[j + 1] - xi[j]))
    return Bounce(float(phi0), float(r_wall), float(slope), int(cross.size))


def local_probability(bounce: Bounce, m_mix0: float, v_w, dtype=np.float64) -> np.ndarray:
    """P(v_w) = 1 - exp(-2 pi m0^2 / (v |Delta'|)) with v clipped to
    [1e-6, 1 - 1e-12]."""
    t = dtype
    lam1 = t(m_mix0) ** 2 / t(bounce.slope)
    v = np.clip(np.asarray(v_w, dtype=t), t(1e-6), t(1.0 - 1e-12))
    return (t(1.0) - np.exp(t(-2.0 * math.pi) * lam1 / v)).astype(np.float64)
