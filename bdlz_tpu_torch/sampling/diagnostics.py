"""Convergence diagnostics for ensemble chains: τ_int and split-R̂.

The reference pipeline has no sampling layer at all (it is a single-point
CLI, `first_principles_yields.py:346-441`); the north-star MCMC layer adds
these as the standard stopping instruments:

* :func:`integrated_autocorr_time` — the Sokal/Goodman–Weare integrated
  autocorrelation time per parameter, estimated emcee-style: FFT
  autocorrelation per walker, ensemble-averaged, then the self-consistent
  window M = min{m : m ≥ c·τ(m)} (c=5 by default).
* :func:`split_rhat` — Gelman–Rubin potential-scale-reduction with each
  walker chain split in half (detects within-chain drift that whole-chain
  R̂ misses).  Values ≲ 1.01 indicate convergence.

Both are host-side numpy (diagnostics, not hot path).  This is the
port's own copy of ``bdlz_tpu/sampling/diagnostics.py`` (the port imports
nothing of the JAX package); on the same arrays its outputs are bitwise
the JAX package's.
"""
from __future__ import annotations

import numpy as np


def _next_pow_two(n: int) -> int:
    i = 1
    while i < n:
        i <<= 1
    return i


def _acf_1d(x: np.ndarray) -> np.ndarray:
    """Normalized autocorrelation of a 1-D series via FFT (O(n log n))."""
    x = np.asarray(x, dtype=np.float64)
    n = _next_pow_two(len(x))
    f = np.fft.fft(x - x.mean(), 2 * n)
    acf = np.fft.ifft(f * np.conjugate(f))[: len(x)].real
    if acf[0] <= 0:  # constant chain — no signal
        return np.ones_like(acf)
    return acf / acf[0]


def integrated_autocorr_time(
    chain: np.ndarray, c: float = 5.0
) -> np.ndarray:
    """τ_int per parameter for a (n_steps, W, D) ensemble chain.

    Ensemble-averaged ACF per dimension, then Sokal's automated window:
    τ(m) = 2·Σ_{t≤m} ρ(t) − 1, M = first m with m ≥ c·τ(m).  Estimates are
    only reliable for n_steps ≳ 50·τ — callers should compare the returned
    τ against n_steps/50 themselves (the CLI reports both).
    """
    chain = np.asarray(chain, dtype=np.float64)
    if chain.ndim != 3:
        raise ValueError(f"expected (n_steps, W, D) chain, got {chain.shape}")
    n, W, D = chain.shape
    taus = np.empty(D)
    for d in range(D):
        f = np.zeros(n)
        for w in range(W):
            f += _acf_1d(chain[:, w, d])
        f /= W
        tau_m = 2.0 * np.cumsum(f) - 1.0
        m = np.arange(n)
        window = m >= c * tau_m
        idx = int(np.argmax(window)) if window.any() else n - 1
        taus[d] = tau_m[idx]
    return taus


def split_rhat(chain: np.ndarray) -> np.ndarray:
    """Split-R̂ per parameter for a (n_steps, W, D) ensemble chain.

    Each walker contributes two half-chains (2W chains of n/2 samples);
    R̂ = √(((n−1)/n·W_var + B/n) / W_var) with B the between-chain and
    W_var the within-chain variance.
    """
    chain = np.asarray(chain, dtype=np.float64)
    if chain.ndim != 3:
        raise ValueError(f"expected (n_steps, W, D) chain, got {chain.shape}")
    n2 = (chain.shape[0] // 2) * 2
    half = n2 // 2
    if half < 2:
        raise ValueError("need at least 4 steps for split-R-hat")
    # (half, 2W, D): first halves then second halves of every walker
    split = np.concatenate([chain[:half], chain[half:n2]], axis=1)
    n, m, D = split.shape
    means = split.mean(axis=0)                      # (m, D)
    variances = split.var(axis=0, ddof=1)           # (m, D)
    W_var = variances.mean(axis=0)                  # (D,)
    B = n * means.var(axis=0, ddof=1)               # (D,)
    var_hat = (n - 1) / n * W_var + B / n
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.sqrt(var_hat / W_var)
    return np.where(W_var > 0, out, 1.0)


def effective_sample_size(chain: np.ndarray, c: float = 5.0) -> np.ndarray:
    """N_eff = n_steps·W / τ_int per parameter."""
    chain = np.asarray(chain)
    n, W, _ = chain.shape
    return n * W / integrated_autocorr_time(chain, c=c)


# ---------------------------------------------------------------------------
# rank-normalized diagnostics (Vehtari, Gelman, Simpson, Carpenter &
# Bürkner 2021) — the instruments the NUTS-vs-stretch ESS-per-eval bench
# claim is computed with, in-repo (no arviz in this environment)
# ---------------------------------------------------------------------------

def _rank_normalize(x: np.ndarray) -> np.ndarray:
    """Fractional-rank normal scores of pooled draws, per Vehtari et al.

    ``x`` is (n, m) — n draws of m chains; ranks are over the POOLED
    draws (average ranks on ties), mapped through Φ⁻¹((r − 3/8)/(S + ¼)).
    Rank normalization makes the ESS/R̂ statistics robust to heavy tails
    and nonlinear scale — the "bulk" variants."""
    from scipy.stats import rankdata
    from scipy.special import ndtri

    flat = x.reshape(-1)
    r = rankdata(flat, method="average").reshape(x.shape)
    return ndtri((r - 0.375) / (flat.size + 0.25))


def _ess_multichain(z: np.ndarray) -> float:
    """Combined multi-chain ESS of (n, m) draws (BDA3/Stan estimator).

    Chain-wise FFT autocovariances averaged across chains, combined with
    the between-chain variance into ρ_t = 1 − (W − mean_acov_t)/var⁺,
    truncated by Geyer's initial monotone positive-pair sequence."""
    n, m = z.shape
    if n < 4:
        return float("nan")
    acov = np.empty((n, m))
    for j in range(m):
        a = _acf_1d(z[:, j])
        # _acf_1d normalizes by acov[0]; undo to get autocovariances
        acov[:, j] = a * z[:, j].var()
    mean_acov = acov.mean(axis=1)
    W = mean_acov[0] * n / (n - 1.0)       # within-chain variance (ddof=1)
    B = n * z.mean(axis=0).var(ddof=1) if m > 1 else 0.0
    var_plus = W * (n - 1.0) / n + B / n
    if var_plus <= 0:
        return float(n * m)
    rho = 1.0 - (W - mean_acov) / var_plus
    # Geyer: sum consecutive pairs while positive and monotone
    tau = -1.0
    prev_pair = np.inf
    t = 0
    while t + 1 < n:
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        pair = min(pair, prev_pair)        # initial monotone sequence
        prev_pair = pair
        tau += 2.0 * pair
        t += 2
    tau = max(tau, 1.0 / np.log10(n * m + 10.0))
    return float(n * m / tau)


def bulk_ess(chain: np.ndarray) -> np.ndarray:
    """Bulk effective sample size per parameter, (n_steps, W, D) chains.

    Rank-normalized, split-chain ESS (Vehtari et al. 2021): each chain
    is split in half (drift registers as between-chain variance), the
    pooled draws are rank-normal-scored, and the multi-chain estimator
    combines within/between variances.  This is the numerator of the
    ``nuts_ess_per_eval`` bench line for BOTH samplers — one instrument,
    no sampler-specific flattery."""
    chain = np.asarray(chain, dtype=np.float64)
    if chain.ndim != 3:
        raise ValueError(f"expected (n_steps, W, D) chain, got {chain.shape}")
    n2 = (chain.shape[0] // 2) * 2
    half = n2 // 2
    if half < 4:
        raise ValueError("need at least 8 steps for bulk ESS")
    split = np.concatenate([chain[:half], chain[half:n2]], axis=1)
    D = split.shape[2]
    out = np.empty(D)
    for d in range(D):
        out[d] = _ess_multichain(_rank_normalize(split[:, :, d]))
    return out


def rank_normalized_split_rhat(chain: np.ndarray) -> np.ndarray:
    """Bulk R̂: split-R̂ on rank-normal scores (Vehtari et al. 2021).

    Shares :func:`split_rhat`'s variance arithmetic; the rank-normal
    transform makes it sensitive to scale AND location mismatches in
    heavy-tailed posteriors.  ≲ 1.01 indicates convergence."""
    chain = np.asarray(chain, dtype=np.float64)
    if chain.ndim != 3:
        raise ValueError(f"expected (n_steps, W, D) chain, got {chain.shape}")
    n, W, D = chain.shape
    z = np.empty_like(chain)
    for d in range(D):
        z[:, :, d] = _rank_normalize(chain[:, :, d])
    return split_rhat(z)
