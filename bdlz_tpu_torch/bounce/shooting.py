"""O(4) bounce shooting: release-point bisection over adaptive SDIRK4 segments.

Counterpart of ``bdlz_tpu/bounce/shooting.py``.  The radial bubble ODE

    φ''(ρ) + (3/ρ)·φ'(ρ) = V′(φ),   φ'(0) = 0,  φ(∞) = φ_false

is solved by the overshoot/undershoot construction: a release point φ₀
near the true vacuum either overshoots past φ_false or turns back, and
``n_bisect`` float64 halvings converge on the bounce.  Each
classification integrates up to ``n_segments`` fixed segments, each an
adaptive SDIRK4(3) solve, and stops at the first verdict; the converged
φ₀ is then densified by a fixed-grid RK4 pass that accumulates the
Euclidean action S₄ = 2π²∫ρ³[½φ'² + V − V(φ_false)]dρ in order.

On the card the whole shoot — about 45,000 sequential attempted steps for
the reference potential — is one hand-written CUDA kernel
(``csrc/bounce_shoot.cu`` through ``ops/bounce_kernel.py``), one thread per
lane.  The plain version below is the same algorithm in eager PyTorch,
batched over lanes: each segment is one ``solvers/sdirk.esdirk_solve`` of
the lanes still undecided, with an RHS whose ``at(ρ)`` gives the
closed-form Jacobian [[0, 1], [V″(φ), −3/ρ]].  The kernel wrapper runs it
only for CPU tensors.  At the full knobs it takes minutes (a few
milliseconds of host dispatch per attempted step); the tests run it at
reduced knobs.

Lanes are independent, so a batch equals the loop of single shoots bit
for bit; ``lane_width`` (≥ 1) sets how many lanes one launch carries.
Host-side work (vacuum Newton, profile interpolation onto the wall
window) stays in NumPy.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Union

import numpy as np
import torch

from bdlz_tpu_torch.backend import F64, resolve_device
from bdlz_tpu_torch.bounce.potential import (
    PotentialSpec,
    _d2V,
    as_potential_spec,
    potential_dV,
    potential_V,
    vacua,
    wall_width_mu,
)
from bdlz_tpu_torch.lz.profile import BounceProfile

# -- solver knobs --------------------------------------------------------
DEFAULT_RHO0 = 1e-2          # series-IC start (regularizes the 3/ρ term)
DEFAULT_RHO_MAX = 80.0       # far edge of the integration domain
DEFAULT_N_SEGMENTS = 80      # classification ladder segments
DEFAULT_N_BISECT = 60        # float64 release-point halvings
DEFAULT_N_DENSE = 4096       # RK4 densification steps
DEFAULT_N_XI = 801           # profile samples across the wall window
DEFAULT_XI_HALFWIDTH_WALLS = 8.0  # window half-width in wall widths (1/μ)
DEFAULT_LANE_WIDTH = 8       # lanes per launch

# -- classification tolerances --------------------------------------------
#: overshoot: φ dips below φ_false by this fraction of Δφ = φ_true−φ_false
_OVERSHOOT_FRAC = 1e-6
#: undershoot: φ' turns positive past this absolute floor
_UNDERSHOOT_V_TOL = 1e-14
#: the dense pass freezes the state onto φ_false once within this fraction
#: of Δφ, so that the exponential deviation past the wall does not
#: pollute the action tail
_SETTLE_FRAC = 1e-4
#: bisection upper bracket: φ_true − Δφ·this
_HI_OFFSET_FRAC = 1e-13

#: 2π², the action's prefactor, as the JAX package forms it
TWO_PI_SQ = 2.0 * math.pi ** 2


class BounceSolution(NamedTuple):
    """One solved bounce (host NumPy arrays)."""

    phi0: np.ndarray       # converged release point
    r_wall: np.ndarray     # wall radius: φ(r_wall) = φ_mid
    action: np.ndarray     # Euclidean action S₄ of the shot trajectory
    converged: np.ndarray  # every segment succeeded + wall located
    rho: np.ndarray        # dense radial grid (n_dense+1,)
    phi: np.ndarray        # φ(ρ) on the dense grid
    dphi: np.ndarray       # φ'(ρ) on the dense grid


class BounceSolveError(RuntimeError):
    """Raised when a shoot cannot produce a usable profile."""


class Knobs(NamedTuple):
    """The solver knobs, validated, and the grid steps derived from them
    exactly as the JAX package derives them."""

    rho0: float
    rho_max: float
    n_segments: int
    n_bisect: int
    n_dense: int
    lane_width: int

    @property
    def h_seg(self) -> float:
        return (self.rho_max - self.rho0) / self.n_segments

    @property
    def h_dense(self) -> float:
        return (self.rho_max - self.rho0) / self.n_dense


def make_knobs(rho0=DEFAULT_RHO0, rho_max=DEFAULT_RHO_MAX,
               n_segments=DEFAULT_N_SEGMENTS, n_bisect=DEFAULT_N_BISECT,
               n_dense=DEFAULT_N_DENSE, lane_width=DEFAULT_LANE_WIDTH) -> Knobs:
    if int(lane_width) < 1:
        raise BounceSolveError(f"lane_width must be >= 1, got {lane_width}")
    return Knobs(float(rho0), float(rho_max), int(n_segments), int(n_bisect),
                 int(n_dense), int(lane_width))


# ---- the plain version -------------------------------------------------

class ShootRHS:
    """f(ρ, Y) = (φ', V′(φ) − 3φ'/ρ) for a batch of lanes, as an RHS
    object of ``solvers/sdirk``: ``at(ρ)`` gives f and the closed-form
    Jacobian [[0, 1], [V″(φ), −3/ρ]]."""

    def __init__(self, lam4, vev, eps):
        self.lam4, self.vev, self.eps = lam4, vev, eps

    def at(self, rho):
        from bdlz_tpu_torch.solvers.boltzmann import RHSStage

        lam4, vev, eps = self.lam4, self.vev, self.eps

        def f(Y):
            return torch.stack(
                [Y[:, 1], potential_dV(Y[:, 0], lam4, vev, eps) - 3.0 * Y[:, 1] / rho],
                dim=-1,
            )

        def jac(Y):
            return ((torch.zeros_like(rho), torch.ones_like(rho)),
                    (_d2V(Y[:, 0], lam4, vev), -3.0 / rho))

        return RHSStage(f, jac)


def _series_ic(phi0, lam4, vev, eps, rho0: float):
    """φ(ρ₀) = φ₀ + V′(φ₀)ρ₀²/8, φ'(ρ₀) = V′(φ₀)ρ₀/4, as (W, 2)."""
    dv0 = potential_dV(phi0, lam4, vev, eps)
    return torch.stack([phi0 + 0.125 * dv0 * rho0 * rho0, 0.25 * dv0 * rho0], dim=-1)


class ClassifyOut(NamedTuple):
    verdict: torch.Tensor    # +1 overshoot / −1 undershoot, int64 (W,)
    y_first: torch.Tensor    # state after the first segment, (W, 2)
    y_end: torch.Tensor      # state after the last segment run, (W, 2)
    segments: torch.Tensor   # segments run, int64 (W,)
    steps: torch.Tensor      # attempted SDIRK steps, int64 (W,)
    ok: torch.Tensor         # every segment succeeded, bool (W,)


def classify_plain(params: torch.Tensor, phi0: torch.Tensor, knobs: Knobs) -> ClassifyOut:
    """Classify each lane's release point ``phi0`` (W,) for the potentials
    ``params`` (W, 6) = (λ₄, v, ε, φ_false, φ_top, φ_true).  Each segment
    solves only the lanes still undecided."""
    from bdlz_tpu_torch.solvers.sdirk import esdirk_solve

    lam4, vev, eps, phi_false, _phi_top, phi_true = params.unbind(-1)
    delta_phi = phi_true - phi_false
    floor_phi = phi_false - _OVERSHOOT_FRAC * delta_phi
    W = params.shape[0]
    z64 = torch.zeros(W, dtype=torch.int64, device=params.device)
    y = _series_ic(phi0, lam4, vev, eps, knobs.rho0)
    verdict, segments, steps = z64.clone(), z64.clone(), z64.clone()
    ok = torch.ones(W, dtype=torch.bool, device=params.device)
    y_first = y
    for k in range(knobs.n_segments):
        live = torch.nonzero(verdict == 0).flatten()
        if live.numel() == 0:
            break
        a = knobs.rho0 + knobs.h_seg * float(k)
        sol = esdirk_solve(ShootRHS(lam4[live], vev[live], eps[live]), a, a + knobs.h_seg,
                           y[live], auto_h0=True)
        y2 = sol.y
        v = torch.where(y2[:, 0] < floor_phi[live], 1,
                        torch.where(y2[:, 1] > _UNDERSHOOT_V_TOL, -1, 0))
        y = y.index_copy(0, live, y2)
        verdict = verdict.index_copy(0, live, v)
        ok = ok.index_copy(0, live, ok[live] & sol.success)
        segments = segments.index_add(0, live, torch.ones_like(live))
        steps = steps.index_add(0, live, sol.n_steps)
        if k == 0:
            y_first = y
    verdict = torch.where(verdict == 0, -1, verdict)  # friction won: undershoot
    return ClassifyOut(verdict, y_first, y, segments, steps, ok)


class ShootOut(NamedTuple):
    phi0: torch.Tensor       # (W,)
    r_wall: torch.Tensor     # (W,), NaN where the wall was not crossed
    action: torch.Tensor     # (W,)
    converged: torch.Tensor  # bool (W,)
    phi: torch.Tensor        # (W, n_dense+1)
    dphi: torch.Tensor       # (W, n_dense+1)
    steps: torch.Tensor      # attempted SDIRK steps of the bisection, int64 (W,)
    segments: torch.Tensor   # segment solves of the bisection, int64 (W,)


def dense_plain(params: torch.Tensor, phi0: torch.Tensor, knobs: Knobs):
    """The dense pass from ``phi0``: fixed-grid RK4 with the settle
    freeze, the trapezoid action accumulated step by step, and the wall
    radius by linear interpolation at φ_mid.  ``(r_wall, action, crossed,
    phi, dphi)``."""
    lam4, vev, eps, phi_false, _phi_top, phi_true = params.unbind(-1)
    delta_phi = phi_true - phi_false
    phi_mid = 0.5 * (phi_true + phi_false)
    v_false = potential_V(phi_false, lam4, vev, eps)
    settle = phi_false + _SETTLE_FRAC * delta_phi
    rho0, h, n_dense = knobs.rho0, knobs.h_dense, knobs.n_dense

    def rhs(rho, y):
        return torch.stack(
            [y[:, 1], potential_dV(y[:, 0], lam4, vev, eps) - 3.0 * y[:, 1] / rho], dim=-1)

    def integrand(rho, y):
        return rho * (rho * rho) * (
            0.5 * y[:, 1] * y[:, 1] + potential_V(y[:, 0], lam4, vev, eps) - v_false)

    frozen = torch.stack([phi_false, 0.0 * phi_false], dim=-1)
    y = _series_ic(phi0, lam4, vev, eps, rho0)
    f_prev = integrand(rho0, y)
    s_acc = torch.zeros_like(phi0)
    ys = [y]
    for k in range(n_dense):
        rho = rho0 + h * float(k)
        k1 = rhs(rho, y)
        k2 = rhs(rho + 0.5 * h, y + 0.5 * h * k1)
        k3 = rhs(rho + 0.5 * h, y + 0.5 * h * k2)
        k4 = rhs(rho + h, y + h * k3)
        y2 = y + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        y2 = torch.where((y2[:, 0] < settle)[:, None], frozen, y2)
        f_new = integrand(rho + h, y2)
        s_acc = s_acc + 0.5 * (f_prev + f_new) * h
        f_prev, y = f_new, y2
        ys.append(y)
    traj = torch.stack(ys, dim=1)                       # (W, n_dense+1, 2)
    phis, dphis = traj[..., 0], traj[..., 1]
    action = TWO_PI_SQ * s_acc
    below = phis <= phi_mid[:, None]
    idx = below.to(torch.int8).argmax(dim=1)
    crossed = below.gather(1, idx[:, None])[:, 0] & (idx > 0)
    i0 = torch.clamp_min(idx - 1, 0)
    p0 = phis.gather(1, i0[:, None])[:, 0]
    p1 = phis.gather(1, (i0 + 1)[:, None])[:, 0]
    denom = torch.where(p1 == p0, 1.0, p1 - p0)
    frac = (phi_mid - p0) / denom
    rho_i0 = rho0 + h * i0.to(F64)
    r_wall = torch.where(crossed, rho_i0 + frac * h, torch.nan)
    return r_wall, action, crossed, phis, dphis


def shoot_plain(params: torch.Tensor, knobs: Knobs) -> ShootOut:
    """The whole shoot in eager PyTorch: ``n_bisect`` halvings, then the
    dense pass at the lower bracket (the undershoot side)."""
    _lam4, _vev, _eps, phi_false, phi_top, phi_true = params.unbind(-1)
    delta_phi = phi_true - phi_false
    lo = phi_top
    hi = phi_true - _HI_OFFSET_FRAC * delta_phi
    ok = torch.ones_like(lo, dtype=torch.bool)
    steps = torch.zeros_like(lo, dtype=torch.int64)
    segments = torch.zeros_like(steps)
    for _ in range(knobs.n_bisect):
        mid = 0.5 * (lo + hi)
        c = classify_plain(params, mid, knobs)
        under = c.verdict < 0
        lo = torch.where(under, mid, lo)
        hi = torch.where(under, hi, mid)
        ok = ok & c.ok
        steps = steps + c.steps
        segments = segments + c.segments
    r_wall, action, crossed, phis, dphis = dense_plain(params, lo, knobs)
    converged = (ok & crossed & torch.isfinite(action)
                 & torch.isfinite(phis).all(dim=1))
    return ShootOut(lo, r_wall, action, converged, phis, dphis, steps, segments)


# ---- the solver API ----------------------------------------------------

def _params_row(spec: PotentialSpec) -> np.ndarray:
    spec = as_potential_spec(spec)
    phi_false, phi_top, phi_true = vacua(spec)
    return np.asarray(
        [spec.lam4, spec.vev, spec.eps, phi_false, phi_top, phi_true],
        dtype=np.float64,
    )


def _run_rows(rows: np.ndarray, knobs: Knobs, device) -> BounceSolution:
    """Shoot rows (n, 6) in launches of ``lane_width`` lanes."""
    from bdlz_tpu_torch.ops.bounce_kernel import bounce_shoot

    dev = resolve_device(device)
    outs = []
    for start in range(0, rows.shape[0], knobs.lane_width):
        chunk = torch.as_tensor(rows[start:start + knobs.lane_width], dtype=F64, device=dev)
        outs.append(bounce_shoot(chunk, knobs))
    fields = [torch.cat(parts).cpu().numpy() for parts in zip(*outs)]
    phi0, r_wall, action, converged, phi, dphi = fields[:6]
    rho = knobs.rho0 + knobs.h_dense * np.arange(knobs.n_dense + 1, dtype=np.float64)
    return BounceSolution(phi0, r_wall, action, converged.astype(bool),
                          np.broadcast_to(rho, phi.shape).copy(), phi, dphi)


def solve_bounce(
    spec: Union[PotentialSpec, str, dict],
    rho0: float = DEFAULT_RHO0,
    rho_max: float = DEFAULT_RHO_MAX,
    n_segments: int = DEFAULT_N_SEGMENTS,
    n_bisect: int = DEFAULT_N_BISECT,
    n_dense: int = DEFAULT_N_DENSE,
    lane_width: int = DEFAULT_LANE_WIDTH,
    device=None,
) -> BounceSolution:
    """Shoot one potential (one launch on the card)."""
    knobs = make_knobs(rho0, rho_max, n_segments, n_bisect, n_dense, lane_width)
    out = _run_rows(_params_row(spec)[None, :], knobs, device)
    return BounceSolution(*(np.asarray(a)[0] for a in out))


def solve_bounce_batch(
    specs: Sequence[Union[PotentialSpec, str, dict]],
    rho0: float = DEFAULT_RHO0,
    rho_max: float = DEFAULT_RHO_MAX,
    n_segments: int = DEFAULT_N_SEGMENTS,
    n_bisect: int = DEFAULT_N_BISECT,
    n_dense: int = DEFAULT_N_DENSE,
    lane_width: int = DEFAULT_LANE_WIDTH,
    device=None,
) -> BounceSolution:
    """Shoot a batch of potentials; fields carry a leading batch axis,
    equal per lane to :func:`solve_bounce_scalar_loop` bit for bit."""
    if len(specs) == 0:
        raise BounceSolveError("solve_bounce_batch needs at least one spec")
    knobs = make_knobs(rho0, rho_max, n_segments, n_bisect, n_dense, lane_width)
    rows = np.stack([_params_row(s) for s in specs])
    return _run_rows(rows, knobs, device)


def solve_bounce_scalar_loop(
    specs: Sequence[Union[PotentialSpec, str, dict]],
    rho0: float = DEFAULT_RHO0,
    rho_max: float = DEFAULT_RHO_MAX,
    n_segments: int = DEFAULT_N_SEGMENTS,
    n_bisect: int = DEFAULT_N_BISECT,
    n_dense: int = DEFAULT_N_DENSE,
    lane_width: int = DEFAULT_LANE_WIDTH,
    device=None,
) -> BounceSolution:
    """One :func:`solve_bounce` per spec — the baseline of the batch."""
    sols = [
        solve_bounce(s, rho0=rho0, rho_max=rho_max, n_segments=n_segments,
                     n_bisect=n_bisect, n_dense=n_dense, lane_width=lane_width,
                     device=device)
        for s in specs
    ]
    return BounceSolution(*(np.stack(f) for f in zip(*sols)))


def bounce_profile(
    spec: Union[PotentialSpec, str, dict],
    n_xi: int = DEFAULT_N_XI,
    xi_halfwidth_walls: float = DEFAULT_XI_HALFWIDTH_WALLS,
    solution: "BounceSolution | None" = None,
    **solver_knobs,
) -> BounceProfile:
    """The two-channel LZ profile of a potential: ξ ∈ ±(halfwidth/μ)
    around the solved wall radius at ``n_xi`` points, Δ(ξ) =
    g_Δ·(φ(ξ) − φ_mid) (one crossing at the wall), m_mix(ξ) = m₀.
    ``solver_knobs`` (``device`` included) go to :func:`solve_bounce`."""
    spec = as_potential_spec(spec)
    sol = solution if solution is not None else solve_bounce(spec, **solver_knobs)
    if np.ndim(sol.phi0) != 0:
        raise BounceSolveError(
            "bounce_profile expects a single solved spec (got a batched solution)"
        )
    if not bool(sol.converged):
        raise BounceSolveError(
            f"bounce shoot did not converge for {spec} "
            f"(phi0={float(sol.phi0)!r}, action={float(sol.action)!r}); "
            f"widen rho_max or revisit the spec"
        )
    if n_xi < 2:
        raise BounceSolveError(f"n_xi must be >= 2, got {n_xi}")
    mu = wall_width_mu(spec)
    half = float(xi_halfwidth_walls) / mu
    phi_false, _phi_top, phi_true = vacua(spec)
    phi_mid = 0.5 * (phi_true + phi_false)
    r_wall = float(sol.r_wall)
    # An odd window puts a sample exactly at r_wall, where Δ is the rounding
    # residue of φ(r_wall) − φ_mid (~1e-16), and find_crossings takes the
    # wall's slope from the segment on that residue's side: on the
    # reference potential the two sides differ by 1.6e-5 in P.  So r_wall is
    # rounded up to the first double at which φ < φ_mid (the side of the
    # shoot's "first dense sample at or below φ_mid"), and the slope no
    # longer depends on the shoot's last bits.  The JAX package's reference
    # solution already lies on that side and is left as it is.
    for _ in range(64):
        if not np.interp(r_wall, sol.rho, sol.phi) >= phi_mid:
            break
        r_wall = float(np.nextafter(r_wall, np.inf))
    if r_wall - half < float(sol.rho[0]) or r_wall + half > float(sol.rho[-1]):
        raise BounceSolveError(
            f"wall window ±{half:.3g} around r_wall={r_wall:.3g} escapes the "
            f"solved domain [{float(sol.rho[0]):.3g}, {float(sol.rho[-1]):.3g}]; "
            f"increase rho_max or reduce xi_halfwidth_walls"
        )
    xi = np.linspace(-half, half, int(n_xi))
    phi = np.interp(xi + r_wall, sol.rho, sol.phi)
    delta = spec.g_delta * (phi - phi_mid)
    mix = np.full_like(xi, spec.m_mix0)
    return BounceProfile(xi=xi, delta=delta, mix=mix)


def bounce_probabilities(
    spec: Union[PotentialSpec, str, dict],
    v_w,
    method: str = "local",
    device=None,
    **profile_knobs,
) -> np.ndarray:
    """Potential → profile → P(v_w), in one call."""
    from bdlz_tpu_torch.lz.sweep_bridge import probabilities_for_points

    profile = bounce_profile(spec, device=device, **profile_knobs)
    return probabilities_for_points(profile, v_w, method=method, device=device)
