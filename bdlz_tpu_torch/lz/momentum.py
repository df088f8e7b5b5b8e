"""Momentum-averaged LZ conversion probability — the paper's F(k) layer.

Counterpart of ``bdlz_tpu/lz/momentum.py``.  Incident χ momenta follow the
equilibrium distribution at the percolation temperature, f(k) ∝ k² e^{−E/T};
each (k, μ = cosθ) node is boosted to the wall frame, v_n = (vμ + v_w)/
(1 + vμ v_w), and weighted by the plasma-frame crossing rate
max(vμ + v_w, 0), so

    ⟨P⟩ = Σ w f k² flux P(v_n) / Σ w f k² flux,   F_k = ⟨P⟩ / P(v_w).

The quadrature grids are built on the host with NumPy (copied from the
JAX package); the (n_k, n_μ) node grid — and, for many wall speeds, the
(speeds, n_k, n_μ) grid — is one broadcast tensor program on the device,
where the JAX package nests ``vmap``s.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from bdlz_tpu_torch.backend import F64, resolve_device
from bdlz_tpu_torch.lz.profile import BounceProfile, load_profile_csv


def _wall_frame_normal_speed(v, mu, v_w):
    """Relativistic addition of the plasma-frame normal velocity and v_w."""
    vz = v * mu
    return (vz + v_w) / (1.0 + vz * v_w)


def _k_quadrature(v_w: float, T: float, m: float, n_k: int):
    """Segmented k-quadrature ``(k, w_k, res)`` on the host.

    Breakpoints at k* (v(k*) = v_w, where the μ*-clip puts a C¹ kink in
    the integrand) and at the end of the thermal bulk (E = m + 6T); the
    first segment is Gauss–Legendre in k, tail segments substitute
    t = e^{−(E − E_lo)/T}.  ``res`` is E/T shifted by its minimum, so the
    cold limit does not underflow before the ratio cancels it.
    """
    n_k = int(n_k)
    E_max = m + 45.0 * T
    k_max = float(np.sqrt(E_max * E_max - m * m))
    k_bulk = float(np.sqrt((m + 6.0 * T) ** 2 - m * m))
    kstar = m * v_w / np.sqrt(1.0 - v_w * v_w) if m > 0.0 else 0.0
    breaks = sorted({b for b in (k_bulk, kstar) if 0.0 < b < k_max})
    edges = [0.0] + breaks + [k_max]
    n_seg = max(n_k // (len(edges) - 1), 4)
    x_leg, w_leg = np.polynomial.legendre.leggauss(n_seg)
    s = 0.5 * (x_leg + 1.0)       # Legendre nodes on [0, 1]
    ws = 0.5 * w_leg
    k_parts, w_parts, res_parts = [], [], []
    for i, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
        E_lo = np.sqrt(lo * lo + m * m)
        E_hi = np.sqrt(hi * hi + m * m)
        if i == 0:
            kk = lo + (hi - lo) * s
            ww = ws * (hi - lo)
            res_parts.append(np.sqrt(kk * kk + m * m) / T)
        else:
            t_hi = np.exp(-(E_hi - E_lo) / T)
            tt = t_hi + (1.0 - t_hi) * s
            EE = E_lo - T * np.log(tt)
            kk = np.sqrt(np.maximum(EE * EE - m * m, 0.0))
            ww = ws * (1.0 - t_hi) * (T * EE / np.maximum(kk, 1e-300))
            res_parts.append(np.full(n_seg, E_lo / T))
        k_parts.append(kk)
        w_parts.append(ww)
    k_np = np.concatenate(k_parts)
    wk_np = np.concatenate(w_parts)
    res_np = np.concatenate(res_parts)
    return k_np, wk_np, res_np - res_np.min()


def momentum_averaged_probability(
    profile: Union[str, BounceProfile],
    v_w: float,
    T_GeV: float,
    m_GeV: float,
    n_k: int = 128,
    n_mu: int = 24,
    method: str = "coherent",
    gamma_phi: float = 0.0,
    device=None,
) -> Tuple[float, float]:
    """Flux-weighted thermal average ⟨P_{χ→B}⟩ and F_k = ⟨P⟩/P(v_w).

    ``method`` is ``"coherent"``, ``"dephased"`` (Γ = 0 goes through the
    quaternion path, so it equals the coherent average bit for bit) or
    ``"local"`` (the smooth analytic composition).
    """
    from bdlz_tpu_torch.lz.kernel import validate_gamma_phi

    validate_gamma_phi(gamma_phi, method)
    if method == "dephased":
        from bdlz_tpu_torch.lz.thermal import thermal_method_for

        method, gamma_phi = thermal_method_for(gamma_phi)
    dev = resolve_device(device)

    if isinstance(profile, str):
        profile = load_profile_csv(profile)
    v_w = float(np.clip(v_w, 1e-6, 1.0 - 1e-12))
    T = max(float(T_GeV), 1e-30)
    m = max(float(m_GeV), 0.0)

    k_np, wk_np, res_np = _k_quadrature(v_w, T, m, n_k)
    xmu, wmu = np.polynomial.legendre.leggauss(int(n_mu))

    def t(a):
        return torch.as_tensor(a, dtype=F64, device=dev)

    k = t(k_np)                                     # (n_k,)
    E = torch.sqrt(k * k + m * m)
    v = k / torch.clamp_min(E, 1e-300)              # plasma-frame speed
    fk = (k * k) * torch.exp(-t(res_np))

    # μ over the incident cone [μ*(k), 1], quadratic map clustering nodes
    # where v_n → 0
    mu_star = torch.clamp(-v_w / torch.clamp_min(v, 1e-300), -1.0, 1.0)
    u = 0.5 * (t(xmu) + 1.0)
    wu = t(wmu) * 0.5
    span = (1.0 - mu_star)[:, None]
    mu = mu_star[:, None] + span * u[None, :] ** 2
    mu_jac = span * 2.0 * u[None, :] * wu[None, :]
    v_n = _wall_frame_normal_speed(v[:, None], mu, v_w)   # (n_k, n_mu)
    flux = torch.clamp_min(v[:, None] * mu + v_w, 0.0)

    if method in ("coherent", "dephased"):
        from bdlz_tpu_torch.lz.kernel import (
            _segment_hamiltonians,
            make_P_of_speed,
            over_speed_chunks,
            padded_segments,
        )

        a, b, dxi = _segment_hamiltonians(profile, dev)
        P_batch = make_P_of_speed(method, a, b, dxi, gamma_phi)
        per_speed = padded_segments(a.shape[0]) * 8 * (9 if method == "dephased" else 4)

        def P_of_speed(speed):
            flat = over_speed_chunks(P_batch, speed.reshape(-1), per_speed)
            return flat.reshape(speed.shape)
    elif method == "local":
        from bdlz_tpu_torch.lz.kernel import local_lambdas
        from bdlz_tpu_torch.lz.profile import find_crossings

        lam1 = float(np.sum(local_lambdas(find_crossings(profile), v_w=1.0)))

        def P_of_speed(speed):
            return 1.0 - torch.exp(-2.0 * torch.pi * lam1 / speed)
    else:
        raise ValueError(
            f"method must be 'coherent', 'dephased', or 'local', got {method!r}"
        )

    P_nodes = P_of_speed(torch.clamp_min(v_n, 1e-6))

    w2d = t(wk_np)[:, None] * mu_jac * fk[:, None] * flux
    norm = torch.sum(w2d)
    # layer boundary: the averaged P is returned as a host float
    P_avg = float(torch.sum(w2d * P_nodes) / torch.clamp_min(norm, 1e-300))  # bdlz-lint: disable=R3

    P_wall = float(P_of_speed(t([v_w]))[0])
    F_k = P_avg / P_wall if P_wall > 0.0 else float("nan")
    return float(np.clip(P_avg, 0.0, 1.0)), F_k


def local_momentum_average_batch(
    profile: Union[str, BounceProfile],
    v_ws,
    T_GeV: float,
    m_GeV: float,
    n_k: int = 128,
    n_mu: int = 24,
    device=None,
) -> np.ndarray:
    """⟨P⟩(v_w) for many wall speeds at one thermal state, method "local",
    as one (speeds, n_k, n_μ) tensor program.  Per-speed k-grids may
    differ by a few nodes; they are padded with zero-weight nodes."""
    from bdlz_tpu_torch.lz.kernel import lambda_eff_from_profile

    if isinstance(profile, str):
        profile = load_profile_csv(profile)
    v_ws = np.clip(np.asarray(v_ws, dtype=np.float64), 1e-6, 1.0 - 1e-12)
    if v_ws.size == 0:
        return np.zeros(0)
    dev = resolve_device(device)
    T = max(float(T_GeV), 1e-30)
    m = max(float(m_GeV), 0.0)
    lam1 = lambda_eff_from_profile(profile, v_w=1.0)

    grids = [_k_quadrature(float(vw), T, m, n_k) for vw in v_ws]
    width = max(g[0].shape[0] for g in grids)

    def pad(a, fill):
        return np.pad(a, (0, width - a.shape[0]), constant_values=fill)

    def t(a):
        return torch.as_tensor(a, dtype=F64, device=dev)

    k = t(np.stack([pad(g[0], 1.0) for g in grids]))
    wk = t(np.stack([pad(g[1], 0.0) for g in grids]))
    res = t(np.stack([pad(g[2], 0.0) for g in grids]))
    xmu, wmu = np.polynomial.legendre.leggauss(int(n_mu))
    u = t(0.5 * (xmu + 1.0))
    wu = t(0.5 * wmu)
    v_w_b = t(v_ws)

    E = torch.sqrt(k * k + m * m)
    v = k / torch.clamp_min(E, 1e-300)
    fk = (k * k) * torch.exp(-res)
    mu_star = torch.clamp(-v_w_b[:, None] / torch.clamp_min(v, 1e-300), -1.0, 1.0)
    span = (1.0 - mu_star)[..., None]
    mu = mu_star[..., None] + span * u ** 2
    mu_jac = span * 2.0 * u * wu
    v_n = _wall_frame_normal_speed(v[..., None], mu, v_w_b[:, None, None])
    flux = torch.clamp_min(v[..., None] * mu + v_w_b[:, None, None], 0.0)
    P = 1.0 - torch.exp(-2.0 * torch.pi * lam1 / torch.clamp_min(v_n, 1e-6))
    w3d = wk[..., None] * mu_jac * fk[..., None] * flux
    norm = torch.sum(w3d, dim=(1, 2))
    out = torch.sum(w3d * P, dim=(1, 2)) / torch.clamp_min(norm, 1e-300)
    return np.clip(out.cpu().numpy(), 0.0, 1.0)  # bdlz-lint: disable=R3 — layer boundary
