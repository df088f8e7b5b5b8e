"""Per-sweep-point LZ probabilities: the profile → P seam of a sweep.

Counterpart of ``bdlz_tpu/lz/sweep_bridge.py``.  Given a bounce profile,
every grid point's P is derived from that point's own wall speed (and,
for the momentum average, its T_p and m_χ), so wall-speed scans exercise
the distributed-LZ physics end to end.

Methods:

* ``"local"`` — P(v) = 1 − e^(−2πλ₁/v), λ₁ = Σᵢ λᵢ(v = 1); analytic in v
  (host NumPy);
* ``"coherent"`` — the transfer-matrix propagation per unique speed;
* ``"local-momentum"`` — the flux-weighted thermal average of the local
  composition per unique (v_w, T_p, m_χ);
* ``"dephased"`` — the density-matrix transport at rate ``gamma_phi``.

The propagating methods run on ``device`` over unique speeds, in chunks
whose staged bytes fit ``BDLZ_LZ_SPEED_CHUNK_BYTES`` (default 1 GiB; the
tree's leaves, or on the card the dephased kernel's output alone); the
last chunk is padded with the last speed, as in the JAX package.  A
sweep's dephased pass (one rate's speeds to host P) is the span
``lz.dephase``.  The JAX package's ``TRACE_COUNTS`` pins its one-compile
contract; eager PyTorch compiles nothing, so it has no counterpart.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Union

import numpy as np
import torch

from bdlz_tpu_torch.backend import F64, resolve_device
from bdlz_tpu_torch.lz.kernel import local_lambdas
from bdlz_tpu_torch.lz.profile import BounceProfile, find_crossings, load_profile_csv
from bdlz_tpu_torch.utils.profiling import span

VALID_METHODS = ("local", "coherent", "local-momentum", "dephased")


def profile_fingerprint(profile: Union[str, BounceProfile]) -> str:
    """Stable identity of a profile: sha256 over the float64 bytes of
    (xi, delta, mix), 16 hex characters (the JAX package's string)."""
    import hashlib

    if isinstance(profile, str):
        profile = load_profile_csv(profile)
    h = hashlib.sha256()
    for arr in (profile.xi, profile.delta, profile.mix):
        h.update(np.ascontiguousarray(np.asarray(arr, dtype=np.float64)).tobytes())
    return h.hexdigest()[:16]


def _propagated(profile: BounceProfile, speeds_np: np.ndarray, method: str,
                gamma_phi: float, dev) -> np.ndarray:
    """P at each of ``speeds_np`` (already unique and clipped) through the
    coherent or dephased kernel on ``dev``, chunked; host (n,) array.  A
    dephased call is one pass, the span ``lz.dephase``: it ends with the
    host copy, so the pass's device work lies inside it."""
    from bdlz_tpu_torch.lz.kernel import (
        _segment_hamiltonians,
        make_P_of_speed,
        over_speed_chunks,
        staged_bytes_per_speed,
    )

    with span("lz.dephase") if method == "dephased" else contextlib.nullcontext():
        a, b, dxi = _segment_hamiltonians(profile, dev)
        P_of_speed = make_P_of_speed(method, a, b, dxi, gamma_phi)
        per_speed = staged_bytes_per_speed(method, a.shape[0], dev)
        speeds = torch.as_tensor(speeds_np, dtype=F64, device=dev)
        # layer boundary: the P table goes to the sweep's host grid
        return over_speed_chunks(P_of_speed, speeds, per_speed).cpu().numpy()  # bdlz-lint: disable=R3


def probabilities_for_points(
    profile: Union[str, BounceProfile],
    v_w,
    method: str = "local",
    T_p_GeV=None,
    m_chi_GeV=None,
    gamma_phi: float = 0.0,
    device=None,
) -> np.ndarray:
    """P_{χ→B} for each sweep point's wall speed (host (n_points,) array).

    Work is done per unique parameter combination and scattered back, so
    a v_w scan over a large product grid costs O(unique speeds).  For
    ``"local-momentum"`` the per-point ``T_p_GeV``/``m_chi_GeV`` are
    required; combinations are grouped by thermal state (T_p, m_χ), and
    each group's speeds are one batched average.
    """
    if method not in VALID_METHODS:
        raise ValueError(f"method must be one of {VALID_METHODS}, got {method!r}")
    from bdlz_tpu_torch.lz.kernel import validate_gamma_phi

    validate_gamma_phi(gamma_phi, method)
    if isinstance(profile, str):
        profile = load_profile_csv(profile)

    v_w = np.asarray(v_w, dtype=np.float64)

    if method == "local":
        lam1 = float(np.sum(local_lambdas(find_crossings(profile), v_w=1.0)))
        v = np.clip(v_w, 1e-6, 1.0 - 1e-12)
        return 1.0 - np.exp(-2.0 * np.pi * lam1 / v)

    dev = resolve_device(device)
    if method in ("coherent", "dephased"):
        uniq, inverse = np.unique(v_w, return_inverse=True)
        P_uniq = _propagated(profile, np.clip(uniq, 1e-6, 1.0 - 1e-12), method,
                             gamma_phi, dev)
        return np.clip(P_uniq, 0.0, 1.0)[inverse]

    if T_p_GeV is None or m_chi_GeV is None:
        raise ValueError("method='local-momentum' needs per-point T_p_GeV and m_chi_GeV")
    from bdlz_tpu_torch.lz.momentum import local_momentum_average_batch

    T_p = np.broadcast_to(np.asarray(T_p_GeV, dtype=np.float64), v_w.shape)
    m = np.broadcast_to(np.asarray(m_chi_GeV, dtype=np.float64), v_w.shape)
    combos = np.stack([v_w, T_p, m], axis=1)
    uniq, inverse = np.unique(combos, axis=0, return_inverse=True)
    inverse = np.asarray(inverse).reshape(-1)
    P_uniq = np.full(len(uniq), np.nan)
    # non-finite parameter rows stay NaN: the sweep's failure mask
    # absorbs them per point
    finite = np.all(np.isfinite(uniq), axis=1)
    thermal = np.unique(uniq[finite][:, 1:], axis=0)
    for T_i, m_i in thermal:
        sel = finite & (uniq[:, 1] == T_i) & (uniq[:, 2] == m_i)
        P_uniq[sel] = local_momentum_average_batch(
            profile, uniq[sel, 0], float(T_i), float(m_i), device=dev
        )
    return P_uniq[inverse]


class PTable(NamedTuple):
    """Dense P(v_w) table, nodes uniform in u = 1/v_w (λ ∝ 1/v and the
    Stückelberg phases ∝ 1/v are smooth in u)."""

    u0: float        # first node in u = 1/v (= 1/v_hi)
    inv_du: float    # 1 / node spacing in u
    values: Any      # P at the nodes, shape (n,)
    v_lo: float      # domain of validity (queries are clamped into it)
    v_hi: float
    method: str


#: Default table sizes per method: the coherent estimator oscillates in u
#: and needs dense nodes; the momentum average is smooth.
_TABLE_N_DEFAULT = {"coherent": 16384, "local-momentum": 1024, "dephased": 16384}
_TABLE_NG_DEFAULT = 33


def resolve_table2d_shape(n_v: int = 0, n_g: int = 0) -> "tuple[int, int]":
    """The (n_v, n_g) a 2-D P(v_w, Γ_φ) table build uses."""
    return (
        int(n_v) or _TABLE_N_DEFAULT["dephased"],
        int(n_g) or _TABLE_NG_DEFAULT,
    )


def make_P_of_vw_table(
    profile: Union[str, BounceProfile],
    method: str,
    v_lo: float,
    v_hi: float,
    n: int = 0,
    T_p_GeV: "float | None" = None,
    m_chi_GeV: "float | None" = None,
    gamma_phi: float = 0.0,
    device=None,
) -> PTable:
    """P(v_w) over [v_lo, v_hi] on the uniform 1/v grid; ``values`` is a
    float64 tensor on ``device``.  ``T_p_GeV``/``m_chi_GeV`` pin the
    thermal state of ``"local-momentum"``."""
    if method == "local":
        raise ValueError(
            "method='local' is analytic in v_w — use lz_lambda1, not a table"
        )
    if method not in VALID_METHODS:
        raise ValueError(f"method must be one of {VALID_METHODS}, got {method!r}")
    if not (0.0 < v_lo < v_hi <= 1.0):
        raise ValueError(f"need 0 < v_lo < v_hi <= 1, got [{v_lo}, {v_hi}]")
    n = int(n) or _TABLE_N_DEFAULT[method]
    if n < 8:
        raise ValueError(f"table needs >= 8 nodes, got {n}")
    dev = resolve_device(device)
    us = np.linspace(1.0 / v_hi, 1.0 / v_lo, n)
    vs = 1.0 / us
    if method == "local-momentum":
        if T_p_GeV is None or m_chi_GeV is None:
            raise ValueError("local-momentum table needs pinned T_p_GeV and m_chi_GeV")
        from bdlz_tpu_torch.lz.momentum import local_momentum_average_batch

        P = local_momentum_average_batch(
            profile, vs, float(T_p_GeV), float(m_chi_GeV), device=dev
        )
    else:
        P = probabilities_for_points(
            profile, vs, method=method, gamma_phi=gamma_phi, device=dev
        )
    inv_du = (n - 1) / (1.0 / v_lo - 1.0 / v_hi)
    return PTable(
        u0=1.0 / v_hi,
        inv_du=inv_du,
        values=torch.as_tensor(P, dtype=F64, device=dev),
        v_lo=float(v_lo),
        v_hi=float(v_hi),
        method=method,
    )


class PTable2D(NamedTuple):
    """Dense P(v_w, Γ_φ) table of the dephased estimator: uniform 1/v on
    the speed axis, uniform Γ."""

    u0: float
    inv_du: float
    g0: float        # first Γ node (= gamma_lo)
    inv_dg: float    # 1 / Γ node spacing
    values: Any      # P at the nodes, shape (n_v, n_g)
    v_lo: float
    v_hi: float
    g_lo: float
    g_hi: float


def make_P_of_vw_gamma_table(
    profile: Union[str, BounceProfile],
    v_lo: float,
    v_hi: float,
    gamma_lo: float,
    gamma_hi: float,
    n_v: int = 0,
    n_g: int = 0,
    speed_chunk: int = 512,
    device=None,
) -> PTable2D:
    """P(v_w, Γ_φ) over [v_lo, v_hi] × [gamma_lo, gamma_hi]: one dephased
    pass per Γ node over the speeds, chunked by ``speed_chunk`` and by the
    budget (:func:`~bdlz_tpu_torch.lz.kernel.staged_bytes_per_speed`); the
    last chunk is padded with the last speed."""
    from bdlz_tpu_torch.lz.kernel import (
        _segment_hamiltonians,
        make_P_of_speed,
        over_speed_chunks,
        speed_chunk_budget,
        staged_bytes_per_speed,
    )

    if isinstance(profile, str):
        profile = load_profile_csv(profile)
    if not (0.0 < v_lo < v_hi <= 1.0):
        raise ValueError(f"need 0 < v_lo < v_hi <= 1, got [{v_lo}, {v_hi}]")
    if not (0.0 <= gamma_lo < gamma_hi):
        raise ValueError(
            f"need 0 <= gamma_lo < gamma_hi, got [{gamma_lo}, {gamma_hi}]"
        )
    n_v, n_g = resolve_table2d_shape(n_v, n_g)
    if n_v < 8 or n_g < 8:
        raise ValueError(f"table needs >= 8 nodes per axis, got {n_v}x{n_g}")
    dev = resolve_device(device)
    us = np.linspace(1.0 / v_hi, 1.0 / v_lo, n_v)
    vs = torch.as_tensor(np.clip(1.0 / us, 1e-6, 1.0 - 1e-12), dtype=F64, device=dev)
    gs = np.linspace(gamma_lo, gamma_hi, n_g)

    a, b, dxi = _segment_hamiltonians(profile, dev)
    per_speed = staged_bytes_per_speed("dephased", a.shape[0], dev)
    chunk = max(1, min(int(speed_chunk), speed_chunk_budget() // max(per_speed, 1), n_v))
    cols = [
        over_speed_chunks(make_P_of_speed("dephased", a, b, dxi, float(g)), vs,
                          per_speed, budget=chunk * per_speed)
        for g in gs
    ]
    vals = torch.clamp(torch.stack(cols, dim=1), 0.0, 1.0)
    return PTable2D(
        u0=1.0 / v_hi,
        inv_du=(n_v - 1) / (1.0 / v_lo - 1.0 / v_hi),
        g0=float(gamma_lo),
        inv_dg=(n_g - 1) / (gamma_hi - gamma_lo),
        values=vals,
        v_lo=float(v_lo),
        v_hi=float(v_hi),
        g_lo=float(gamma_lo),
        g_hi=float(gamma_hi),
    )


def _clip(x, lo, hi, device):
    return torch.clamp(torch.as_tensor(x, dtype=F64, device=device), lo, hi)


def eval_P_table_2d(v_w, gamma_phi, table: PTable2D) -> torch.Tensor:
    """P(v_w, Γ_φ) for (Q,) queries by separable cubic Lagrange
    interpolation: four u-interpolated Γ columns around each query, then
    the same stencil across them at t = s + 1 (with four rows the base
    index clips to 1).  Clamped into the domain and into [0, 1]."""
    from bdlz_tpu_torch.ops.kjma_table import lagrange_stencil

    vals = table.values
    dev = vals.device
    u = 1.0 / _clip(v_w, table.v_lo, table.v_hi, dev)
    tu = (u - table.u0) * table.inv_du
    g = _clip(gamma_phi, table.g_lo, table.g_hi, dev)
    tg = (g - table.g0) * table.inv_dg
    n_v, n_g = vals.shape
    j1 = torch.clamp(torch.floor(tg).to(torch.int32), 1, n_g - 3)
    s = tg - j1
    i1 = torch.clamp(torch.floor(tu).to(torch.int32), 1, n_v - 3)
    su = tu - i1
    i, j = i1.long(), j1.long()
    cols = [
        lagrange_stencil(su, vals[i - 1, j + k], vals[i, j + k], vals[i + 1, j + k],
                         vals[i + 2, j + k])
        for k in (-1, 0, 1, 2)
    ]
    t = s + 1.0
    P = lagrange_stencil(t - torch.ones_like(t), *cols)
    return torch.clamp(P, 0.0, 1.0)


# ---------------------------------------------------------------------------
# LZ scenario plane: the chain and thermal modes.  One dispatch home shared
# by every consumer, so that they cannot drift in what a mode means.
# ---------------------------------------------------------------------------

def scenario_identity(static) -> "dict | None":
    """The resolved scenario as an identity payload (None = two-channel),
    the JAX package's dict."""
    mode = getattr(static, "lz_mode", "two_channel")
    if mode == "two_channel":
        return None
    if mode == "chain":
        return {"mode": "chain", "n_levels": int(static.lz_n_levels)}
    if mode == "thermal":
        return {
            "mode": "thermal",
            "eta": float(static.lz_bath_eta),
            "omega_c": float(static.lz_bath_omega_c),
        }
    raise ValueError(f"unknown lz_mode {mode!r}")


def scenario_probabilities_for_points(
    profile: Union[str, BounceProfile],
    static,
    v_w,
    T_p_GeV=None,
    device=None,
) -> np.ndarray:
    """Per-point P under the static's scenario mode: ``"chain"`` takes the
    band-traversing channel of the N-level chain, ``"thermal"`` derives
    Γ_φ from each point's own T_p.  Raises on ``"two_channel"``, which
    goes through :func:`probabilities_for_points`."""
    mode = getattr(static, "lz_mode", "two_channel")
    if mode == "chain":
        from bdlz_tpu_torch.lz.chain import chain_probabilities_for_points

        return chain_probabilities_for_points(
            profile, v_w, int(static.lz_n_levels), device=device
        )
    if mode == "thermal":
        from bdlz_tpu_torch.lz.thermal import thermal_probabilities_for_points

        if T_p_GeV is None:
            raise ValueError(
                "lz_mode='thermal' derives Gamma_phi from each point's "
                "T_p_GeV; pass the per-point temperatures"
            )
        return thermal_probabilities_for_points(
            profile, v_w, T_p_GeV,
            float(static.lz_bath_eta), float(static.lz_bath_omega_c),
            device=device,
        )
    raise ValueError(
        f"scenario dispatch is for lz_mode 'chain'/'thermal', got {mode!r} "
        "(two-channel sweeps use probabilities_for_points)"
    )


class PTableN(NamedTuple):
    """Dense per-species P(v_w) table of the N-level chain: ``values`` is
    (n, N), one column per species, on the uniform 1/v grid; column N−1
    is the pipeline's P_chi_to_B."""

    u0: float
    inv_du: float
    values: Any      # populations at the nodes, shape (n, N)
    v_lo: float
    v_hi: float
    n_levels: int


def make_P_table_n(
    profile: Union[str, BounceProfile],
    n_levels: int,
    v_lo: float,
    v_hi: float,
    n: int = 0,
    device=None,
) -> PTableN:
    """Per-species chain populations over [v_lo, v_hi] (the chain's
    memory model chunks the speeds); the coherent default density."""
    from bdlz_tpu_torch.lz.chain import chain_populations_for_speeds, validate_n_levels

    n_levels = validate_n_levels(n_levels)
    if not (0.0 < v_lo < v_hi <= 1.0):
        raise ValueError(f"need 0 < v_lo < v_hi <= 1, got [{v_lo}, {v_hi}]")
    n = int(n) or _TABLE_N_DEFAULT["coherent"]
    if n < 8:
        raise ValueError(f"table needs >= 8 nodes, got {n}")
    dev = resolve_device(device)
    us = np.linspace(1.0 / v_hi, 1.0 / v_lo, n)
    P = chain_populations_for_speeds(profile, 1.0 / us, n_levels, device=dev)
    return PTableN(
        u0=1.0 / v_hi,
        inv_du=(n - 1) / (1.0 / v_lo - 1.0 / v_hi),
        values=torch.as_tensor(P, dtype=F64, device=dev),
        v_lo=float(v_lo),
        v_hi=float(v_hi),
        n_levels=n_levels,
    )


def eval_P_table_n(v_w, table: PTableN) -> torch.Tensor:
    """Per-species populations (Q, N) by cubic interpolation on the 1/v
    grid, clamped into the domain and into [0, 1]."""
    from bdlz_tpu_torch.ops.kjma_table import cubic_lagrange_uniform

    vals = table.values
    u = 1.0 / _clip(v_w, table.v_lo, table.v_hi, vals.device)
    t = (u - table.u0) * table.inv_du
    cols = [cubic_lagrange_uniform(t, vals[:, k]) for k in range(int(table.n_levels))]
    return torch.clamp(torch.stack(cols, dim=-1), 0.0, 1.0)


def eval_P_table(v_w, table: PTable) -> torch.Tensor:
    """P(v_w) by cubic Lagrange interpolation on the 1/v grid, clamped
    into the table's domain and into [0, 1]."""
    from bdlz_tpu_torch.ops.kjma_table import cubic_lagrange_uniform

    vals = table.values
    u = 1.0 / _clip(v_w, table.v_lo, table.v_hi, vals.device)
    t = (u - table.u0) * table.inv_du
    return torch.clamp(cubic_lagrange_uniform(t, vals), 0.0, 1.0)
