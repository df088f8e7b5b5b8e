"""Two-channel distributed Landau–Zener transition kernel, batched over speeds.

Counterpart of ``bdlz_tpu/lz/kernel.py``: a χ/B two-level system crossing
at the bubble wall, with local adiabaticity λ = m_mix(ξ*)²/(v_w |Δ'(ξ*)|)
and single-crossing probability P = 1 − e^(−2πλ) (paper Eqs. 5-9).

Evaluation modes:

* **local** — per-crossing λ, composed as λ_eff = Σᵢ λᵢ and mapped through
  P = 1 − e^(−2πλ_eff) (host NumPy: it is analytic);
* **coherent** — the two-channel Schrödinger equation i v ∂_ξ ψ = H(ξ) ψ
  across the sampled profile as an ordered product of per-segment
  exponentials (exponential-midpoint rule), each the closed-form SU(2)
  exponential stored as a real unit quaternion, composed by a log-depth
  pairwise tree;
* **dephased** — the density-matrix transport with diabatic-basis
  dephasing: each segment's SO(3) rotation times a coherence decay; on
  the card one hand kernel (``ops/bloch_kernel``), elsewhere the tree.

Where the JAX package ``vmap``s a per-speed program, every function here
takes a leading speed axis: ``v`` is a (B,) tensor and one tensor program
propagates all B speeds at once (leaves (B, segments, 4) or
(B, segments, 3, 3)).  Everything stays real float64 on the device the
segment arrays live on.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from bdlz_tpu_torch.backend import F64, resolve_device
from bdlz_tpu_torch.lz.profile import BounceProfile, Crossings, find_crossings, load_profile_csv


def local_lambdas(crossings: Crossings, v_w: float) -> np.ndarray:
    """λᵢ = m_mix(ξᵢ*)² / (v_w |Δ'(ξᵢ*)|) per crossing (paper Eq. 8); a
    crossing with a vanishing slope is fully adiabatic: λ → ∞."""
    v = max(float(v_w), 1e-12)
    slope = np.abs(crossings.slope)
    with np.errstate(divide="ignore"):
        return np.where(
            slope > 0.0, crossings.mix**2 / (v * np.where(slope > 0, slope, 1.0)), np.inf
        )


def probability_from_lambda(lam) -> float:
    """P = 1 − e^(−2πλ), clamped to [0, 1] (paper Eq. 9)."""
    lam = max(float(lam), 0.0)
    return float(min(max(1.0 - np.exp(-2.0 * np.pi * lam), 0.0), 1.0))


def lambda_eff_from_profile(
    profile: Union[str, BounceProfile], v_w: float = 1.0
) -> float:
    """Σᵢ λᵢ over all located crossings (the local composition)."""
    if isinstance(profile, str):
        profile = load_profile_csv(profile)
    lams = local_lambdas(find_crossings(profile), v_w)
    return float(np.sum(lams)) if lams.size else 0.0


def _segment_hamiltonians(profile: BounceProfile, device):
    """Midpoint H = a σ_z + b σ_x per segment and the segment widths, as
    (S,) float64 tensors on ``device`` (exponential-midpoint rule)."""
    xi = torch.as_tensor(profile.xi, dtype=F64, device=device)
    delta = torch.as_tensor(profile.delta, dtype=F64, device=device)
    mix = torch.as_tensor(profile.mix, dtype=F64, device=device)
    dxi = xi[1:] - xi[:-1]
    half_delta_mid = 0.25 * (delta[1:] + delta[:-1])  # Δ_mid / 2
    mix_mid = 0.5 * (mix[1:] + mix[:-1])
    return half_delta_mid, mix_mid, dxi


def _traversal_times(dxi: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """τ = dξ / v per (speed, segment): (B, S)."""
    return dxi[None, :] / torch.clamp_min(v, 1e-12)[:, None]


def _su2_quaternions(a, b, tau):
    """U = exp(−i (a σ_z + b σ_x) τ) as unit quaternions (w, x, y, z),
    U = w·I − i(x σ_x + y σ_y + z σ_z); (…, S) → (…, S, 4).  sin(ωτ)/ω is
    τ·sinc(ωτ/π), smooth at ω → 0."""
    omega = torch.sqrt(a * a + b * b)
    phase = omega * tau
    sinc = torch.sinc(phase / torch.pi) * tau
    w = torch.cos(phase)
    x = b * sinc
    z = a * sinc
    y = torch.zeros_like(w)
    return torch.stack([w, x, y, z], dim=-1)


def _quat_compose(q1, q2):
    """Hamilton product on (…, 4) stacks: U(q1)·U(q2) = U(q1 ∘ q2)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def _quat_to_matrix(q) -> np.ndarray:
    """The complex 2×2 U of one quaternion (host-side, for reporting)."""
    w, x, y, z = (float(q[i]) for i in range(4))
    return np.array(
        [[w - 1j * z, -y - 1j * x], [y - 1j * x, w + 1j * z]], dtype=np.complex128
    )


def _ordered_tree_product(xs, compose, identity):
    """Ordered product x_N ∘ ··· ∘ x_1 along axis 1 of ``xs`` (B, N, …),
    by pairwise halving: pad to a power of two with ``identity``, then
    compose adjacent pairs with the LATER element on the left.  Shared by
    the quaternion, Bloch and chain propagators."""
    n = xs.shape[1]
    size = 1 << max(n - 1, 1).bit_length()
    if size != n:
        ident = torch.as_tensor(identity, dtype=xs.dtype, device=xs.device)
        pad = ident.expand((xs.shape[0], size - n) + tuple(xs.shape[2:]))
        xs = torch.cat([xs, pad], dim=1)
    while xs.shape[1] > 1:
        pairs = xs.reshape((xs.shape[0], -1, 2) + tuple(xs.shape[2:]))
        xs = compose(pairs[:, :, 1], pairs[:, :, 0])
    return xs[:, 0]


def propagate_quaternion(a, b, dxi, v):
    """Total SU(2) propagator U_N···U_1 as a quaternion per speed: (B,) →
    (B, 4); P_{χ→B} = q_x² + q_y²."""
    qs = _su2_quaternions(a, b, _traversal_times(dxi, v))
    return _ordered_tree_product(
        qs, _quat_compose, np.array([1.0, 0.0, 0.0, 0.0])
    )


def _quat_to_rotations(q):
    """SO(3) adjoint of SU(2) quaternions, U (r·σ) U† = (R r)·σ:
    (…, 4) → (…, 3, 3)."""
    w, x, y, z = q.unbind(-1)
    one = torch.ones_like(w)
    rows = [
        torch.stack([one - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), one - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     one - 2 * (x * x + y * y)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def propagate_bloch(a, b, dxi, v, gamma_phi):
    """Dephased transport: the final Bloch vector from r₀ = ẑ per speed,
    (B,) → (B, 3).  Each segment applies its SU(2) propagator's SO(3)
    rotation, then the coherence decay diag(e^(−Γτ), e^(−Γτ), 1), at one
    rate ``gamma_phi`` for every speed (a float) or at a rate per speed (a
    (B,) tensor).  P_{χ→B} = (1 − r_z)/2.  On CUDA tensors one hand kernel
    (``ops/bloch_kernel``); on CPU tensors :func:`propagate_bloch_plain`."""
    from bdlz_tpu_torch.ops.bloch_kernel import bloch_transport

    rates = gamma_phi if torch.is_tensor(gamma_phi) else torch.full_like(v, gamma_phi)
    return bloch_transport(a, b, dxi, v, rates)


def propagate_bloch_plain(a, b, dxi, v, gamma_phi):
    """:func:`propagate_bloch`'s plain version: the segments' 3×3 maps
    staged as (B, 2^k, 3, 3) leaves and composed by the pairwise tree,
    each speed's coherences decaying at its own rate ``gamma_phi`` (B,)."""
    if gamma_phi.shape != v.shape:
        raise ValueError("propagate_bloch_plain: gamma_phi must hold one rate per speed, "
                         f"got {tuple(gamma_phi.shape)} for {tuple(v.shape)} speeds")
    tau = _traversal_times(dxi, v)
    Rs = _quat_to_rotations(_su2_quaternions(a, b, tau))
    # Γ < 0 is rejected at every host boundary; the clamp only keeps a
    # negative rate from growing coherences
    decay = torch.exp(-torch.clamp_min(gamma_phi, 0.0)[:, None] * tau)
    scale = torch.stack([decay, decay, torch.ones_like(decay)], dim=-1)
    Ms = Rs * scale[..., None]
    M_total = _ordered_tree_product(Ms, torch.matmul, np.eye(3))
    return M_total[:, :, 2]  # M_total @ ẑ


def gamma_phi_cli_error(method: str, gamma_phi: float) -> "str | None":
    """The CLIs' --lz-gamma-phi pairing rule as a message (None = valid)."""
    if gamma_phi < 0.0:
        return "--lz-gamma-phi must be >= 0"
    if gamma_phi and method != "dephased":
        return "--lz-gamma-phi requires --lz-method dephased"
    return None


def validate_gamma_phi(gamma_phi: float, method: str) -> None:
    """Host-boundary Γ_φ contract: negative rates are invalid, and a rate
    the method would ignore is a caller error."""
    if gamma_phi < 0.0:
        raise ValueError(f"gamma_phi must be >= 0, got {gamma_phi}")
    if gamma_phi and method != "dephased":
        raise ValueError(f"gamma_phi has no effect with method={method!r}")


def make_P_of_speed(method: str, a, b, dxi, gamma_phi):
    """``P_of_speed(v)``, (B,) → (B,), for the propagating estimators: the
    single home of P = q_x² + q_y² (coherent) and P = (1 − r_z)/2
    (dephased), the latter at ``gamma_phi``, one rate or a rate per speed
    (:func:`propagate_bloch`)."""
    if method == "dephased":
        def P_of_speed(speed):
            r = propagate_bloch(a, b, dxi, speed, gamma_phi)
            return 0.5 * (1.0 - r[:, 2])
    elif method == "coherent":
        def P_of_speed(speed):
            q = propagate_quaternion(a, b, dxi, speed)
            return q[:, 1] ** 2 + q[:, 2] ** 2
    else:
        raise ValueError(
            f"no propagation closure for method={method!r} "
            "(expected 'coherent' or 'dephased')"
        )
    return P_of_speed


def speed_chunk_budget() -> int:
    """Bytes one chunk of speeds may stage
    (``BDLZ_LZ_SPEED_CHUNK_BYTES``, default 1 GiB)."""
    import os

    return int(os.environ.get("BDLZ_LZ_SPEED_CHUNK_BYTES", 1 << 30))


def padded_segments(n_seg: int) -> int:
    """The tree's leaf count for ``n_seg`` segments (a power of two)."""
    return 1 << max(n_seg - 1, 1).bit_length()


def staged_bytes_per_speed(method: str, n_seg: int, device) -> int:
    """Bytes one speed stages for the chunk budget: the tree's leaves,
    ``padded_segments`` f64 maps of 9 (dephased) or 4 (coherent) values;
    the dephased kernel on the card stages none and writes r (3 f64)."""
    if method == "dephased" and torch.device(device).type == "cuda":
        return 3 * 8
    return padded_segments(n_seg) * 8 * (9 if method == "dephased" else 4)


def over_speed_chunks(fn, speeds: torch.Tensor, per_speed_bytes: int,
                      budget: "int | None" = None, lanes: tuple = ()) -> torch.Tensor:
    """``fn`` over ``speeds`` (B,) in chunks whose staged bytes fit the
    budget; each (B,) tensor of ``lanes`` (a rate per speed) is cut with
    the speeds and passed after them.  A short last chunk is padded with
    the last lane, so every call has one shape (the JAX package's
    one-compile rule, kept so that a row's bits never depend on where the
    chunks fall)."""
    n = speeds.shape[0]
    budget = speed_chunk_budget() if budget is None else int(budget)
    chunk = max(1, min(n, budget // max(per_speed_bytes, 1)))
    parts = []
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        args = [t[lo:hi] for t in (speeds,) + lanes]
        if hi - lo < chunk:
            args = [torch.cat([x, t[-1:].expand(chunk - (hi - lo))])
                    for x, t in zip(args, (speeds,) + lanes)]
        parts.append(fn(*args)[: hi - lo])
    return torch.cat(parts) if parts else speeds.new_zeros((0,))


def _speed(v_w: float, device) -> torch.Tensor:
    return torch.tensor([max(float(v_w), 1e-12)], dtype=F64, device=device)


def dephased_probability(
    profile: BounceProfile, v_w: float, gamma_phi: float, device=None
) -> float:
    """P_{χ→B} with diabatic-basis dephasing at rate Γ_φ (host seam)."""
    validate_gamma_phi(gamma_phi, "dephased")
    dev = resolve_device(device)
    a, b, dxi = _segment_hamiltonians(profile, dev)
    P = float(make_P_of_speed("dephased", a, b, dxi, gamma_phi)(_speed(v_w, dev))[0])
    return float(min(max(P, 0.0), 1.0))


def transfer_matrix_propagation(
    profile: BounceProfile,
    v_w: float,
    use_generic_expm: bool = False,
    device=None,
):
    """Total transfer matrix U across the profile and P_{χ→B} = |U₁₀|²:
    ``(U_total, P)`` with ``U_total`` a host complex 2×2 array.

    ``use_generic_expm`` replaces the closed-form SU(2) segments by
    ``torch.linalg.matrix_exp`` of the complex generators and an ordered
    complex matrix product — an independent cross-check of the quaternion
    path, used by the tests only.
    """
    dev = resolve_device(device)
    v = max(float(v_w), 1e-12)
    a, b, dxi = _segment_hamiltonians(profile, dev)
    if use_generic_expm:
        tau = dxi / v
        H = torch.stack(
            [torch.stack([a, b], dim=-1), torch.stack([b, -a], dim=-1)], dim=-2
        ).to(torch.complex128)
        Us = torch.linalg.matrix_exp(-1j * H * tau[:, None, None])
        # layer boundary: U goes to the host
        U_total = _ordered_tree_product(  # bdlz-lint: disable=R3
            Us[None], torch.matmul, np.eye(2, dtype=np.complex128)
        )[0].cpu().numpy()
        return U_total, float(np.abs(U_total[1, 0]) ** 2)
    # layer boundary: one speed's quaternion goes to the host
    q = propagate_quaternion(a, b, dxi, _speed(v, dev))[0].cpu().numpy()  # bdlz-lint: disable=R3
    return _quat_to_matrix(q), float(q[1] ** 2 + q[2] ** 2)


def probability_from_profile(
    profile_csv_path: str,
    v_w: float,
    method: str = "coherent",
    gamma_phi: float = 0.0,
    device=None,
) -> float:
    """The reference seam ``maybe_P``: (csv, v_w) → P ∈ [0, 1] by the
    coherent, local or dephased estimator."""
    validate_gamma_phi(gamma_phi, method)
    profile = load_profile_csv(profile_csv_path)
    if method == "local":
        return probability_from_lambda(lambda_eff_from_profile(profile, v_w))
    if method == "dephased":
        return dephased_probability(profile, v_w, gamma_phi, device=device)
    if method != "coherent":
        raise ValueError(
            f"method must be 'coherent', 'local', or 'dephased', got {method!r}"
        )
    _, P = transfer_matrix_propagation(profile, v_w, device=device)
    return float(min(max(P, 0.0), 1.0))
