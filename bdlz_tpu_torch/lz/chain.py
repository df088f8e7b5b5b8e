"""N-level banded Landau–Zener chain kernel (arXiv:1212.2907).

Counterpart of ``bdlz_tpu/lz/chain.py``.  A band of N diabatic levels
spans the two-channel splitting: diagonal ``c_k·Δ(ξ)/2`` with
``c_k = 1 − 2k/(N−1)`` (level 0 the incident χ, level N−1 the B channel)
and nearest-neighbour coupling ``m_mix(ξ)``; at N = 2 it is exactly the
two-channel Hamiltonian.

Propagation is all-real float64: each segment's real symmetric midpoint
H is diagonalized ONCE (one batched ``torch.linalg.eigh``, independent of
the speed), ``U = exp(−iHτ) = C − iS`` with ``C = V cos(wτ) Vᵀ`` and
``S = V sin(wτ) Vᵀ``, carried as the real embedding ``[[C, S], [−S, C]]``
and composed by the shared pairwise tree, for all speeds of a chunk at
once.  Populations ``P_k = |⟨k|U|0⟩|²``; the pipeline's conversion
probability is the band-traversing channel P_{N−1}.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from bdlz_tpu_torch.backend import F64, resolve_device
from bdlz_tpu_torch.lz.kernel import (
    _ordered_tree_product,
    _traversal_times,
    over_speed_chunks,
    padded_segments,
)
from bdlz_tpu_torch.lz.profile import BounceProfile, load_profile_csv


def validate_n_levels(n_levels: int) -> int:
    """Host-boundary contract shared by every chain seam."""
    n = int(n_levels)
    if n < 2:
        raise ValueError(f"lz_n_levels must be >= 2, got {n_levels!r}")
    return n


def chain_level_weights(n_levels: int) -> np.ndarray:
    """``c_k = 1 − 2k/(N−1)``: the banded diagonal weights (host-side)."""
    n = validate_n_levels(n_levels)
    return 1.0 - 2.0 * np.arange(n, dtype=np.float64) / (n - 1)


def _chain_hamiltonians(
    profile: BounceProfile, n_levels: int, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Midpoint N×N Hamiltonians ``(S, N, N)`` and segment widths ``(S,)``
    on ``device``, with the two-channel kernel's segmentation."""
    n = validate_n_levels(n_levels)

    def t(a):
        return torch.as_tensor(a, dtype=F64, device=device)

    xi, delta, mix = t(profile.xi), t(profile.delta), t(profile.mix)
    dxi = xi[1:] - xi[:-1]
    half_delta_mid = 0.25 * (delta[1:] + delta[:-1])    # Δ_mid / 2
    mix_mid = 0.5 * (mix[1:] + mix[:-1])
    c = t(chain_level_weights(n))                       # (N,)
    diag = half_delta_mid[:, None] * c[None, :]         # (S, N)
    off = t(np.eye(n, k=1) + np.eye(n, k=-1))           # (N, N) adjacency
    H = diag[:, :, None] * t(np.eye(n))[None] + mix_mid[:, None, None] * off[None]
    return H, dxi


def propagate_chain(H, dxi, v, eig=None):
    """Final populations from ψ₀ = |0⟩ per speed: (B,) → (B, N).

    ``eig`` is ``torch.linalg.eigh(H)`` when the caller has it already
    (the decomposition does not depend on the speed)."""
    n = H.shape[-1]
    tau = _traversal_times(dxi, v)                      # (B, S)
    w, V = torch.linalg.eigh(H) if eig is None else eig  # (S, N), (S, N, N)
    phase = w[None] * tau[:, :, None]                   # (B, S, N)
    Vt = V.transpose(-1, -2)[None]
    C = torch.matmul(V[None] * torch.cos(phase)[:, :, None, :], Vt)
    S = torch.matmul(V[None] * torch.sin(phase)[:, :, None, :], Vt)
    top = torch.cat([C, S], dim=-1)                     # (B, S, N, 2N)
    bot = torch.cat([-S, C], dim=-1)
    M = torch.cat([top, bot], dim=-2)                   # (B, S, 2N, 2N)
    M_total = _ordered_tree_product(M, torch.matmul, np.eye(2 * n))
    x = M_total[:, :n, 0]                               # Re ψ
    y = M_total[:, n:, 0]                               # Im ψ
    return x * x + y * y


def chain_populations(
    profile: Union[str, BounceProfile], v_w: float, n_levels: int, device=None
) -> np.ndarray:
    """Per-species populations ``(N,)`` at one wall speed."""
    validate_n_levels(n_levels)
    if isinstance(profile, str):
        profile = load_profile_csv(profile)
    dev = resolve_device(device)
    H, dxi = _chain_hamiltonians(profile, n_levels, dev)
    v = torch.tensor([max(float(v_w), 1e-12)], dtype=F64, device=dev)
    P = propagate_chain(H, dxi, v)[0].cpu().numpy()
    return np.clip(P, 0.0, 1.0)


def chain_conversion_probability(
    profile: Union[str, BounceProfile], v_w: float, n_levels: int, device=None
) -> float:
    """``P_{χ→B} = P_{N−1}``: the band-traversing conversion channel."""
    return float(chain_populations(profile, v_w, n_levels, device=device)[-1])


def chain_populations_for_speeds(
    profile: Union[str, BounceProfile],
    v_w,
    n_levels: int,
    speed_chunk_bytes: "int | None" = None,
    device=None,
) -> np.ndarray:
    """Populations ``(n_points, N)`` for many wall speeds: one ``eigh``,
    then unique speeds in chunks sized by the chain's memory model — the
    tree stages ``(padded_segments, 2N, 2N)`` f64 embeddings per speed,
    ``padded·8·(2N)²`` bytes."""
    n = validate_n_levels(n_levels)
    if isinstance(profile, str):
        profile = load_profile_csv(profile)
    v_w = np.asarray(v_w, dtype=np.float64)
    if v_w.size == 0:
        return np.zeros((0, n))
    dev = resolve_device(device)
    H, dxi = _chain_hamiltonians(profile, n, dev)
    eig = torch.linalg.eigh(H)
    uniq, inverse = np.unique(v_w, return_inverse=True)
    speeds = torch.clamp(torch.as_tensor(uniq, dtype=F64, device=dev), 1e-6, 1.0 - 1e-12)
    per_speed = padded_segments(dxi.shape[0]) * 8 * (2 * n) ** 2
    P = over_speed_chunks(lambda sp: propagate_chain(H, dxi, sp, eig), speeds,
                          per_speed, speed_chunk_bytes)
    return np.clip(P.cpu().numpy(), 0.0, 1.0)[inverse]


def chain_probabilities_for_points(
    profile: Union[str, BounceProfile], v_w, n_levels: int, device=None
) -> np.ndarray:
    """``P_{χ→B}`` per sweep point: the last column of
    :func:`chain_populations_for_speeds`."""
    return chain_populations_for_speeds(profile, v_w, n_levels, device=device)[:, -1]


def uniform_chain_populations_analytic(
    n_levels: int, coupling: float, length: float, v: float
) -> np.ndarray:
    """Closed-form populations for the flat band (Δ ≡ 0, constant mix):
    the path-graph spectrum λ_j = 2m·cos(jπ/(N+1)), eigenvectors
    φ_j(k) = √(2/(N+1))·sin(jπ(k+1)/(N+1)), U_{k0} = Σ_j φ_j(k) φ_j(0)
    e^{−iλ_j t} with t = L/v."""
    n = validate_n_levels(n_levels)
    t = float(length) / max(float(v), 1e-12)
    j = np.arange(1, n + 1, dtype=np.float64)
    lam = 2.0 * float(coupling) * np.cos(j * np.pi / (n + 1))
    k = np.arange(n, dtype=np.float64)
    phi = np.sqrt(2.0 / (n + 1)) * np.sin(
        np.pi * np.outer(j, k + 1.0) / (n + 1)
    )                                                   # (j, k)
    amp = (phi * phi[:, :1] * np.exp(-1j * lam * t)[:, None]).sum(axis=0)
    return np.abs(amp) ** 2
