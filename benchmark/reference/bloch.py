"""Plain reference of the dephased Landau-Zener transport and of its bath rate.

A chi/B two-level system crosses a sampled wall profile (xi_k, Delta_k, m_k),
k = 0..S.  Segment k carries the midpoint Hamiltonian

    H_k = a_k sigma_z + b_k sigma_x,   a_k = (Delta_k + Delta_k+1) / 4,
                                       b_k = (m_k + m_k+1) / 2,

and is crossed in tau_k = (xi_k+1 - xi_k) / v (the exponential-midpoint
rule), so its propagator is the 2x2 complex

    U_k = exp(-i H_k tau_k) = cos(w tau) I - i sin(w tau) / w H_k,   w = sqrt(a^2 + b^2).

The density matrix rho = (I + r . sigma) / 2 is carried as its Bloch
vector r.  A segment maps r to D_k R_k r: R_k is the SO(3) adjoint of U_k,
(R_k)_ij = 1/2 tr(sigma_i U_k sigma_j U_k^dagger), and
D_k = diag(e^-Gamma tau, e^-Gamma tau, 1) decays the coherences in the
diabatic basis.  From r_0 = z (all in chi) the maps are applied one
segment after the other, and P_chi->B = (1 - r_z) / 2.

The thermal bath is an Ohmic oscillator bath with an exponential cutoff
(arXiv:1410.0516): at temperature T its pure-dephasing rate is

    Gamma_phi(T) = 2 eta T (1 - e^(-omega_c / T)).

Plain PyTorch (complex arithmetic, batched over lanes, one segment at a
time) on any device and in float64 or float32 (complex128 or complex64).
Nothing of the program under test is imported.
"""
from __future__ import annotations

import numpy as np
import torch

#: The Pauli matrices sigma_x, sigma_y, sigma_z.
PAULI = ((0.0, 1.0, 1.0, 0.0), (0.0, -1j, 1j, 0.0), (1.0, 0.0, 0.0, -1.0))
#: Wall speeds are clipped into [V_MIN, V_MAX] before the transport.
V_MIN, V_MAX = 1e-6, 1.0 - 1e-12

_COMPLEX = {torch.float64: torch.complex128, torch.float32: torch.complex64}


def bath_rate(T, eta: float, omega_c: float, dtype=np.float64) -> np.ndarray:
    """Gamma_phi = 2 eta T (1 - e^(-omega_c/T)) for T > 0 (in ``dtype``)."""
    t = dtype
    T = np.asarray(T, dtype=t)
    if np.any(~(T > 0)):
        raise ValueError("the bath rate is defined here for T > 0 only")
    return (t(2.0) * t(eta) * T * -np.expm1(-t(omega_c) / T)).astype(t)


def segments(xi, delta, mix, dtype=torch.float64, device="cpu"):
    """(a, b, dxi): each segment's midpoint half-splitting, mixing and width."""
    xi, delta, mix = (torch.as_tensor(np.asarray(x, dtype=np.float64), device=device).to(dtype)
                      for x in (xi, delta, mix))
    return 0.25 * (delta[1:] + delta[:-1]), 0.5 * (mix[1:] + mix[:-1]), xi[1:] - xi[:-1]


def pauli(dtype=torch.complex128, device="cpu") -> torch.Tensor:
    return torch.tensor(PAULI, dtype=dtype, device=device).reshape(3, 2, 2)


def unitary(a, b, tau) -> torch.Tensor:
    """U = exp(-i (a sigma_z + b sigma_x) tau) for lanes: (L,) -> (L, 2, 2)
    complex; a, b and tau broadcast."""
    a, b, tau = torch.broadcast_tensors(a, b, tau)
    w = torch.sqrt(a * a + b * b)
    c = torch.cos(w * tau)
    s = torch.where(w > 0, torch.sin(w * tau) / torch.where(w > 0, w, torch.ones_like(w)), tau)
    sig = pauli(_COMPLEX[a.dtype], a.device)
    eye = torch.eye(2, dtype=sig.dtype, device=a.device)
    H = a[:, None, None] * sig[2] + b[:, None, None] * sig[0]
    return c[:, None, None] * eye - 1j * s[:, None, None] * H


def adjoint(U: torch.Tensor) -> torch.Tensor:
    """R_ij = 1/2 tr(sigma_i U sigma_j U^dagger), real: (L, 2, 2) -> (L, 3, 3)."""
    sig = pauli(U.dtype, U.device)
    R = 0.5 * torch.einsum("iab,lbc,jcd,lda->lij", sig, U, sig, U.conj().transpose(-1, -2))
    return R.real


def transport(a, b, dxi, v, gamma) -> torch.Tensor:
    """The final Bloch vector of each lane (v, gamma), (L,) each, from
    r_0 = z through the segments (a, b, dxi), (S,) each, one at a time:
    (L, 3)."""
    r = torch.zeros((v.shape[0], 3), dtype=v.dtype, device=v.device)
    r[:, 2] = 1.0
    for k in range(a.shape[0]):
        tau = dxi[k] / v
        R = adjoint(unitary(a[k], b[k], tau))
        r = torch.einsum("lij,lj->li", R, r)
        decay = torch.exp(-gamma * tau)
        r = torch.stack([decay * r[:, 0], decay * r[:, 1], r[:, 2]], dim=-1)
    return r


def probability(xi, delta, mix, v_w, gamma, *, dtype=torch.float64,
                device="cpu") -> np.ndarray:
    """P_chi->B of each (v_w, gamma) lane through the profile, in [0, 1]
    (host float64); each distinct lane is transported once."""
    lanes = np.stack([np.asarray(v_w, dtype=np.float64).reshape(-1),
                      np.asarray(gamma, dtype=np.float64).reshape(-1)], axis=1)
    uniq, inverse = np.unique(lanes, axis=0, return_inverse=True)
    a, b, dxi = segments(xi, delta, mix, dtype, device)
    v = torch.as_tensor(np.clip(uniq[:, 0], V_MIN, V_MAX), device=device).to(dtype)
    g = torch.as_tensor(uniq[:, 1], device=device).to(dtype)
    r_z = transport(a, b, dxi, v, g)[:, 2]
    P = torch.clamp(0.5 * (1.0 - r_z), 0.0, 1.0).to(torch.float64).cpu().numpy()
    return P[np.asarray(inverse).reshape(-1)]

