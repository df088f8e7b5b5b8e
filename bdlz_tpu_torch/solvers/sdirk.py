"""Stiff ESDIRK integrator, batched over lanes in PyTorch.

Counterpart of ``bdlz_tpu/solvers/sdirk.py``: the same two embedded
L-stable, stiffly accurate tableaus (the Hairer–Wanner 5-stage SDIRK4(3),
the default, and Kvaernø(4,2,3)), the same per-lane step attempt, step
controller (I, or PI), starting step (fixed, or Hairer–Wanner) and
resumable :class:`ESDIRKState`.

The JAX engine is one ``lax.while_loop`` per lane under ``vmap``.  Here
it is one host loop over attempted steps for all lanes of a batch at
once: each lane carries its own step size, error history and counters;
masks do what ``jnp.where`` does there, and a lane that is done (or out
of budget) is left exactly as it was.  A lane's arithmetic never mixes
with another lane's, so its result does not depend on the batch it runs
in.  The host tests "any lane still running" once per
``CHECK_EVERY`` attempted steps, not once per step; a budgeted advance
(the rounds of ``solvers/batching.py``) runs exactly its budget without
a host sync.

Each implicit stage is solved by ``newton_iters`` Newton iterations with
the Jacobian re-evaluated in every iteration and a closed-form 2×2 solve
(1e-300 determinant floor).  The right-hand side is an object with an
``at(x)`` method returning a :class:`~bdlz_tpu_torch.solvers.boltzmann.RHSStage`:
what depends on x only is evaluated once per stage abscissa, not once
per Newton iteration (the values are the same).  A plain batched
function ``f(x, Y)`` (x (P,), Y (P, 2), each row depending on its own
lane only) is also accepted; its Jacobian comes from forward-mode AD.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.autograd.forward_ad as fwAD

from bdlz_tpu_torch.backend import F64
from bdlz_tpu_torch.config import PointParams, StaticChoices
from bdlz_tpu_torch.physics.percolation import KJMAGrid
from bdlz_tpu_torch.solvers.boltzmann import RHSStage, make_rhs

#: Kvaernø(4,2,3) diagonal coefficient.
_GAMMA = 0.4358665215084589994160194511935568425

#: Attempted steps between two host tests of "any lane still running"
#: in an unbudgeted advance (the steps after the last lane finished are
#: masked no-ops).
CHECK_EVERY = 16


def _tableau_kvaerno3():
    """Kvaernø(4,2,3): ESDIRK (explicit first stage), L-stable, stiffly
    accurate, order 3 with embedded order 2."""
    g = _GAMMA
    a31 = (-4.0 * g * g + 6.0 * g - 1.0) / (4.0 * g)
    a32 = (-2.0 * g + 1.0) / (4.0 * g)
    b1 = (6.0 * g - 1.0) / (12.0 * g)
    b2 = -1.0 / ((24.0 * g - 12.0) * g)
    b3 = (-6.0 * g * g + 6.0 * g - 1.0) / (6.0 * g - 3.0)
    c = (0.0, 2.0 * g, 1.0, 1.0)
    A = (
        (0.0, 0.0, 0.0, 0.0),
        (g, g, 0.0, 0.0),
        (a31, a32, g, 0.0),
        (b1, b2, b3, g),
    )
    # b = row 4 (stiffly accurate, 3rd order); embedded = row 3 (2nd order).
    return c, A, A[3], A[2], 3.0, g, True


def _tableau_sdirk4():
    """Hairer–Wanner SDIRK, 5 stages, γ = 1/4: L-stable, stiffly accurate,
    order 4 with an embedded order-3 estimate (H&W II, Table 6.5)."""
    g = 0.25
    c = (0.25, 0.75, 11.0 / 20.0, 0.5, 1.0)
    A = (
        (g, 0.0, 0.0, 0.0, 0.0),
        (0.5, g, 0.0, 0.0, 0.0),
        (17.0 / 50.0, -1.0 / 25.0, g, 0.0, 0.0),
        (371.0 / 1360.0, -137.0 / 2720.0, 15.0 / 544.0, g, 0.0),
        (25.0 / 24.0, -49.0 / 48.0, 125.0 / 16.0, -85.0 / 12.0, g),
    )
    b_emb = (59.0 / 48.0, -17.0 / 96.0, 225.0 / 32.0, -85.0 / 12.0, 0.0)
    return c, A, A[4], b_emb, 4.0, g, False


_TABLEAUS = {"kvaerno3": _tableau_kvaerno3, "sdirk4": _tableau_sdirk4}


class ESDIRKSolution(NamedTuple):
    y: torch.Tensor           # (P, 2) final state
    success: torch.Tensor     # (P,) bool: reached x1 with a finite state
    n_steps: torch.Tensor     # (P,) attempted steps
    n_accepted: torch.Tensor
    n_rejected: torch.Tensor


class ESDIRKState(NamedTuple):
    """The full resumable per-lane integration state, (P,) or (P, 2) each.

    Pausing after a bounded number of steps and resuming replays exactly
    the step sequence of an uninterrupted run.  ``err_prev`` is the PI
    controller's history (1.0 = neutral), carried under either controller.
    """

    x: torch.Tensor
    y: torch.Tensor
    h: torch.Tensor           # next trial step size
    f: torch.Tensor           # slope at (x, y): the reusable last stage
    err_prev: torch.Tensor
    n: torch.Tensor           # attempted steps so far (int64)
    n_accepted: torch.Tensor
    n_rejected: torch.Tensor
    done: torch.Tensor        # bool: reached x1


class _BatchedFunction:
    """A plain batched ``f(x, Y)`` (x (P,), Y (P, 2), rows independent) as
    an RHS object; its per-lane Jacobian columns come from two
    forward-mode derivatives with the same unit tangent in every lane
    (``torch.autograd.forward_ad``, ~30× cheaper per call here than
    ``torch.func.jvp``)."""

    def __init__(self, fn: Callable):
        self._fn = fn

    def at(self, x: torch.Tensor) -> RHSStage:
        def f(Y):
            return self._fn(x, Y)

        def column(Y, k):
            e = torch.zeros_like(Y)
            e[:, k] = 1.0
            with fwAD.dual_level():
                return fwAD.unpack_dual(f(fwAD.make_dual(Y, e))).tangent

        def jac(Y):
            c0, c1 = column(Y, 0), column(Y, 1)
            return ((c0[:, 0], c1[:, 0]), (c0[:, 1], c1[:, 1]))

        return RHSStage(f, jac)


def _as_rhs(rhs):
    return rhs if hasattr(rhs, "at") else _BatchedFunction(rhs)


def _solve_2x2(J, r: torch.Tensor) -> torch.Tensor:
    """Closed-form solve J @ d = r per lane; J = ((a, b), (c, d)) of (P,)
    tensors with None for an identically zero entry, r (P, 2)."""
    (a, b), (c, d) = J
    r0, r1 = r[:, 0], r[:, 1]
    det = a * d if b is None or c is None else a * d - b * c
    det = torch.where(torch.abs(det) > 1e-300, det, 1e-300)
    d0 = (r0 * d if b is None else r0 * d - r1 * b) / det
    d1 = (r1 * a if c is None else r1 * a - r0 * c) / det
    return torch.stack([d0, d1], dim=-1)


def _lanes(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a (P,) float64 tensor on ``like``'s device."""
    t = torch.as_tensor(v, dtype=F64, device=like.device)
    return t.expand(like.shape[0]) if t.dim() == 0 else t


def _atol(atol, like: torch.Tensor):
    """A scalar atol stays a float; a tensor — (2,) per component, (P, 1)
    per lane — broadcasts against (P, 2)."""
    if isinstance(atol, (int, float)):
        return float(atol)
    return torch.as_tensor(atol, dtype=F64, device=like.device)


class _Stepper:
    """THE single definition of the step attempt and controller, shared by
    the run-to-completion solve and the budgeted rounds: one body is what
    makes the repacked engine equal the lockstep one lane by lane."""

    def __init__(self, rhs, x0, x1, rtol, atol, newton_iters, h_max, h_max_fn,
                 method, pi_controller):
        (self.c, self.A, self.b, self.b_emb, self.order, self.g,
         self.explicit_first) = _TABLEAUS[method]()
        self.rhs = _as_rhs(rhs)
        self.x1 = x1
        self.abs_span = torch.abs(x1 - x0)
        self.h_cap = self.abs_span if h_max is None else _lanes(h_max, x0)
        self.rtol = rtol
        self.atol = atol
        self.newton_iters = int(newton_iters)
        self.h_max_fn = h_max_fn
        self.pi_controller = bool(pi_controller)

    def _newton(self, stage: RHSStage, rhs_const, Y, hg):
        """Solve Y = rhs_const + h·γ·f(x_s, Y) by fixed-iteration Newton."""
        hg_col = hg[:, None]
        for _ in range(self.newton_iters):
            F = Y - hg_col * stage.f(Y) - rhs_const
            (j00, j01), (j10, j11) = stage.jac(Y)
            J = ((1.0 - hg * j00, None if j01 is None else 0.0 - hg * j01),
                 (None if j10 is None else 0.0 - hg * j10, 1.0 - hg * j11))
            Y = Y - _solve_2x2(J, F)
        return Y

    def attempt_step(self, x, y, h, f0):
        """One step attempt for every lane: ``(y_new, err, last slope)``."""
        c, A, g = self.c, self.A, self.g
        ks = []
        for i in range(len(c)):
            if i == 0 and self.explicit_first:
                ks.append(f0)
                continue
            x_s = x + c[i] * h
            acc = y
            for j in range(i):
                acc = acc + (h * A[i][j])[:, None] * ks[j]
            k_pred = ks[i - 1] if ks else f0
            hg = h * g
            stage = self.rhs.at(x_s)
            Y_i = self._newton(stage, acc, acc + hg[:, None] * k_pred, hg)
            ks.append(stage.f(Y_i))

        y_new, y_emb = y, y
        for j in range(len(c)):
            y_new = y_new + (h * self.b[j])[:, None] * ks[j]
            y_emb = y_emb + (h * self.b_emb[j])[:, None] * ks[j]
        # atol may be per component: the two yields live on scales many
        # decades apart once annihilation re-thermalizes Y_chi
        scale = self.atol + self.rtol * torch.maximum(torch.abs(y), torch.abs(y_new))
        err = torch.sqrt(torch.mean(((y_new - y_emb) / scale) ** 2, dim=-1))
        # both tableaus are stiffly accurate with c_last = 1: the last
        # stage slope IS rhs(x + h, y_new), reusable as the next f0
        return y_new, err, ks[-1]

    def body(self, s: ESDIRKState, active: torch.Tensor) -> ESDIRKState:
        """One attempted step for the ``active`` lanes; the rest unchanged."""
        h_allowed = (self.h_cap if self.h_max_fn is None
                     else torch.minimum(self.h_cap, self.h_max_fn(s.x)))
        h_eff = torch.minimum(torch.minimum(s.h, h_allowed), self.x1 - s.x)
        y_new, err, f_last = self.attempt_step(s.x, s.y, h_eff, s.f)

        err = torch.where(torch.isfinite(err), err, math.inf)
        accept = err <= 1.0
        e = torch.where(err > 0.0, err, 1e-10)
        order = self.order
        if self.pi_controller:
            # Gustafsson PI on accepted steps, the plain I response on
            # rejections
            kI, kP = 0.3 / order, 0.4 / order
            ep = torch.clamp_min(s.err_prev, 1e-10)
            factor = torch.where(
                accept,
                0.9 * e ** (-(kI + kP)) * ep ** kP,
                0.9 * e ** (-1.0 / order),
            )
        else:
            factor = 0.9 * e ** (-1.0 / order)
        factor = torch.clamp(factor, 0.2, 5.0)
        h_next = torch.clamp(h_eff * factor, self.abs_span * 1e-12, self.h_cap)

        took = accept & active
        x = torch.where(took, s.x + h_eff, s.x)
        return ESDIRKState(
            x=x,
            y=torch.where(took[:, None], y_new, s.y),
            h=torch.where(active, h_next, s.h),
            f=torch.where(took[:, None], f_last, s.f),
            err_prev=torch.where(took, e, s.err_prev),
            n=s.n + active,
            n_accepted=s.n_accepted + took,
            n_rejected=s.n_rejected + (active & ~accept),
            done=torch.where(active, x >= self.x1 - self.abs_span * 1e-14, s.done),
        )


def esdirk_init(
    rhs,
    x0,
    x1,
    y0: torch.Tensor,
    rtol: float = 1e-8,
    atol=1e-16,
    h_max=None,
    h_max_fn: Optional[Callable] = None,
    method: str = "sdirk4",
    auto_h0: bool = False,
) -> ESDIRKState:
    """Initial :class:`ESDIRKState` at ``x0`` for every lane of ``y0``
    (P, 2): one slope evaluation and a step-size guess.

    ``auto_h0=False`` is the conservative ``h = span·1e−4``;
    ``auto_h0=True`` the Hairer–Wanner starting step (one extra slope
    evaluation estimates y''), still bound by ``h_max_fn``.
    """
    order = _TABLEAUS[method]()[4]
    rhs = _as_rhs(rhs)
    x0, x1 = _lanes(x0, y0), _lanes(x1, y0)
    atol = _atol(atol, y0)
    span = x1 - x0
    h_cap = torch.abs(span) if h_max is None else _lanes(h_max, y0)
    f0 = rhs.at(x0).f(y0)
    if auto_h0:
        scale0 = atol + rtol * torch.abs(y0)
        d0 = torch.sqrt(torch.mean((y0 / scale0) ** 2, dim=-1))
        d1 = torch.sqrt(torch.mean((f0 / scale0) ** 2, dim=-1))
        h_a = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6 * torch.abs(span),
                          0.01 * d0 / torch.clamp_min(d1, 1e-300))
        h_a = torch.minimum(h_a, h_cap)
        if h_max_fn is not None:
            h_a = torch.minimum(h_a, h_max_fn(x0))
        # explicit Euler probe -> second-derivative estimate d2
        f1 = rhs.at(x0 + h_a).f(y0 + h_a[:, None] * f0)
        d2 = (torch.sqrt(torch.mean(((f1 - f0) / scale0) ** 2, dim=-1))
              / torch.clamp_min(h_a, 1e-300))
        dm = torch.maximum(d1, d2)
        h_b = torch.where(
            dm <= 1e-15,
            torch.maximum(1e-6 * torch.abs(span), h_a * 1e-3),
            (0.01 / dm) ** (1.0 / (order + 1.0)),
        )
        h_init = torch.minimum(100.0 * h_a, h_b)
        h_init = torch.clamp(h_init, torch.abs(span) * 1e-12, h_cap)
        if h_max_fn is not None:
            h_init = torch.minimum(h_init, h_max_fn(x0))
    else:
        h_init = torch.minimum(span * 1e-4, h_cap)
    P = y0.shape[0]
    zeros = torch.zeros(P, dtype=torch.int64, device=y0.device)
    return ESDIRKState(
        x=x0, y=y0, h=h_init, f=f0,
        err_prev=torch.ones(P, dtype=F64, device=y0.device),
        n=zeros, n_accepted=zeros, n_rejected=zeros,
        done=torch.zeros(P, dtype=torch.bool, device=y0.device),
    )


def esdirk_advance(
    rhs,
    state: ESDIRKState,
    x0,
    x1,
    rtol: float = 1e-8,
    atol=1e-16,
    max_steps: int = 10_000,
    newton_iters: int = 6,
    h_max=None,
    h_max_fn: Optional[Callable] = None,
    method: str = "sdirk4",
    pi_controller: bool = False,
    budget: Optional[int] = None,
) -> ESDIRKState:
    """Advance every lane adaptively toward ``x1``.

    ``budget=None`` runs until every lane is done or has made
    ``max_steps`` attempts.  A finite ``budget`` runs exactly ``budget``
    masked step attempts (no host sync), after which each lane has made
    at most ``budget`` more attempts: the round of the lane-repacking
    engine.  The bound rides on each lane's own counter ``n``.
    """
    y = state.y
    x0, x1 = _lanes(x0, y), _lanes(x1, y)
    stepper = _Stepper(rhs, x0, x1, rtol, _atol(atol, y), newton_iters, h_max,
                       h_max_fn, method, pi_controller)
    if budget is None:
        n_stop = max_steps
    else:
        n_stop = torch.clamp_max(state.n + int(budget), int(max_steps))

    def active(s):
        return ~s.done & (s.n < n_stop)

    if budget is not None:
        for _ in range(int(budget)):
            state = stepper.body(state, active(state))
        return state
    # a host loop by design: the lanes' done flags are read every CHECK_EVERY steps
    while bool(active(state).any()):  # bdlz-lint: disable=R2
        for _ in range(CHECK_EVERY):
            state = stepper.body(state, active(state))
    return state


def solution_from_state(state: ESDIRKState) -> ESDIRKSolution:
    """Collapse a final state into the caller-facing solution record."""
    success = state.done & torch.all(torch.isfinite(state.y), dim=-1)
    return ESDIRKSolution(
        y=state.y, success=success, n_steps=state.n,
        n_accepted=state.n_accepted, n_rejected=state.n_rejected,
    )


def esdirk_solve(
    rhs,
    x0,
    x1,
    y0,
    rtol: float = 1e-8,
    atol=1e-16,
    max_steps: int = 10_000,
    newton_iters: int = 6,
    h_max=None,
    h_max_fn: Optional[Callable] = None,
    method: str = "sdirk4",
    auto_h0: bool = False,
    pi_controller: bool = False,
) -> ESDIRKSolution:
    """Integrate dy/dx = rhs(x, y) over [x0, x1] adaptively for every lane.

    ``y0`` is (P, 2), or (2,) for one lane (the solution then has no lane
    axis).  ``x0``/``x1``/``h_max`` are floats or (P,) tensors; ``atol`` a
    float or a tensor that broadcasts against (P, 2).  ``h_max_fn(x)``
    caps the step by position.  ``auto_h0``/``pi_controller`` default off.
    """
    y0 = torch.as_tensor(y0, dtype=F64)
    single = y0.dim() == 1
    if single:
        y0 = y0[None, :]
    state = esdirk_init(rhs, x0, x1, y0, rtol=rtol, atol=atol, h_max=h_max,
                        h_max_fn=h_max_fn, method=method, auto_h0=auto_h0)
    state = esdirk_advance(rhs, state, x0, x1, rtol=rtol, atol=atol,
                           max_steps=max_steps, newton_iters=newton_iters,
                           h_max=h_max, h_max_fn=h_max_fn, method=method,
                           pi_controller=pi_controller)
    sol = solution_from_state(state)
    return ESDIRKSolution(*(t[0] for t in sol)) if single else sol


class LogX:
    """A right-hand side in u = ln x: ``at(u)`` is ``x · rhs.at(x)`` with
    x = e^u, Jacobian included."""

    def __init__(self, rhs):
        self.rhs = rhs

    def at(self, u: torch.Tensor) -> RHSStage:
        x = torch.exp(u)
        st = self.rhs.at(x)
        xc = x[:, None]

        def jac(Y):
            (j00, j01), (j10, j11) = st.jac(Y)
            return tuple(tuple(None if j is None else x * j for j in row)
                         for row in ((j00, j01), (j10, j11)))

        return RHSStage(lambda Y: xc * st.f(Y), jac)

    def __call__(self, u, Y):
        return self.at(u).f(Y)


def boltzmann_ode_problem(
    pp: PointParams,
    chi_stats: str,
    deplete: bool,
    grid: Optional[KJMAGrid],
    T_lo=None,
    T_hi=None,
    av_table=None,
):
    """The log-x Boltzmann problem for a batch of lanes:
    ``(rhs_u, u0, u1, h_max_fn)``.

    THE single definition shared by the per-point path and the repacked
    engine.  ``T_lo``/``T_hi`` default to the window ratios in ``pp``;
    explicit values are used verbatim.  ``av_table`` (a device
    ``KJMATable``) replaces the exact z-integral with the F(y) lookup; it
    is valid only when every lane shares its I_p.

    The step cap: a third of the source pulse's width in u where the
    source can be non-negligible ([u_lo, u_hi], from the percolation map
    y(u)), one step to the window edge before it, 0.25 after it, and a
    step boundary landed exactly on each C0 kink of the RHS — the A/V
    hard cut at u_hi and the T = m/3 seam at u = ln 3.
    """
    A_over_V_T = None
    if av_table is not None:
        from bdlz_tpu_torch.ops.kjma_table import area_over_volume_tabulated
        from bdlz_tpu_torch.physics.percolation import y_of_T

        def A_over_V_T(T):
            y = y_of_T(T, pp.T_p_GeV, pp.beta_over_H)
            return area_over_volume_tabulated(
                y, pp.beta_over_H, pp.T_p_GeV, pp.v_w, pp.g_star, av_table
            )

    rhs = make_rhs(pp, chi_stats, deplete, grid, A_over_V_T=A_over_V_T)
    if T_lo is None:
        T_lo = pp.T_min_over_Tp * pp.T_p_GeV
    if T_hi is None:
        T_hi = pp.T_max_over_Tp * pp.T_p_GeV
    x0 = pp.m_chi_GeV / T_hi
    x1 = pp.m_chi_GeV / torch.clamp_min(_lanes(T_lo, pp.m_chi_GeV), 1e-30)
    u0, u1 = torch.log(x0), torch.log(x1)

    B = torch.clamp_min(pp.beta_over_H, 1e-30)
    w_cap = torch.clamp_max((pp.sigma_y / B) / 3.0, 0.05)
    u_p = torch.log(pp.m_chi_GeV / torch.clamp_min(pp.T_p_GeV, 1e-30))
    y_minus = -torch.minimum(8.0 * pp.sigma_y, 0.49 * B)
    y_plus = torch.clamp_max(8.0 * pp.sigma_y, 50.0)
    u_lo = u_p + 0.5 * torch.log1p(2.0 * y_minus / B)
    u_hi = u_p + 0.5 * torch.log1p(2.0 * y_plus / B)
    h_out = 0.25
    u_seam = math.log(3.0)

    def h_max_fn(u):
        cap = torch.where(
            u < u_lo,
            torch.maximum(u_lo - u, w_cap),
            torch.where(u <= u_hi, w_cap, h_out),
        )
        for uk in (u_hi, u_seam):
            d = uk - u
            cap = torch.where(d > 1e-12, torch.minimum(cap, d), cap)
        return cap

    return LogX(rhs), u0, u1, h_max_fn


def boltzmann_final_yields(sol: ESDIRKSolution):
    """(Y_chi, Y_B) per lane from a Boltzmann ESDIRK solution, (P,) each."""
    return sol.y[:, 0], sol.y[:, 1]


def solve_boltzmann_esdirk(
    pp: PointParams,
    static: StaticChoices,
    grid: Optional[KJMAGrid],
    Y0,
    T_lo,
    T_hi,
    rtol: Optional[float] = None,
    atol=None,
    max_steps: int = 10_000,
    method: Optional[str] = None,
    av_table=None,
) -> ESDIRKSolution:
    """Boltzmann evolution in x = m/T over [m/T_hi, m/T_lo] for a batch of
    lanes (``pp`` of (P,) tensors): the per-point path, run to completion
    in lockstep.

    ``Y0`` is (P, 2), or a pair of per-lane values (Y_χ0, Y_B0).
    ``method``/``rtol``/``atol`` default to ``static``'s ``ode_*`` keys.
    The tri-state engine knobs resolve None → off here (this is the
    bit-pinned path); ``av_table`` swaps in the F(y) lookup.
    """
    method = static.ode_method if method is None else method
    rtol = static.ode_rtol if rtol is None else rtol
    atol = static.ode_atol if atol is None else atol
    ref = pp.m_chi_GeV
    if isinstance(Y0, torch.Tensor) and Y0.dim() == 2:
        y0 = Y0.to(dtype=F64, device=ref.device)
    else:
        y0 = torch.stack([_lanes(v, ref) for v in Y0], dim=-1)
    rhs_u, u0, u1, h_max_fn = boltzmann_ode_problem(
        pp, static.chi_stats, static.deplete_DM_from_source, grid,
        T_lo=_lanes(T_lo, ref), T_hi=_lanes(T_hi, ref), av_table=av_table,
    )
    return esdirk_solve(
        rhs_u, u0, u1, y0, rtol=rtol, atol=atol, max_steps=max_steps,
        h_max_fn=h_max_fn, method=method,
        auto_h0=bool(static.ode_auto_h0),
        pi_controller=bool(static.ode_pi_controller),
    )
