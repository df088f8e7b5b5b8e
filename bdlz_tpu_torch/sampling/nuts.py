"""No-U-Turn sampler (NUTS) over batched chains — gradient-based MCMC.

Counterpart of ``bdlz_tpu/sampling/nuts.py``: multinomial NUTS
(Betancourt 2017 flavour of Hoffman & Gelman 2014) with biased-progressive
sampling across doublings, multinomial sampling within a subtree, the
popcount checkpoint scheme for the sub-U-turn checks, the ``DELTA_MAX``
divergence test, dual-averaging step-size adaptation, a three-window
warmup with a pooled diag or dense mass matrix, and honest counters
(``n_leapfrog``, ``n_logp_evals``, ``n_divergent``).

**Design for the card.**  JAX ``vmap``s a ``while_loop`` per chain, so
every lane runs the same iteration count and a lane that is done is
frozen by ``where``.  Here the doubling ``d < max_tree_depth`` and the
leaf ``i < 2**d`` are Python ints shared by all chains, so popcount and
the checkpoint slots are host arithmetic; an ``active`` mask freezes the
chains that turned or diverged (they are still evaluated, but neither
their state nor their counters advance), and the loops end when no chain
is active — one host sync per leaf and per doubling.  All of a step's
randomness is drawn up front as tensors (:class:`NutsDraws`): the
momentum normals, the doubling directions and acceptance uniforms, and
one selection uniform per leaf.  They mirror JAX's key tree (the chain
key splits into ``k_mom``/``k_tree``; ``k_tree`` into ``key, k_dir,
k_sub, k_acc`` per doubling; ``k_sub`` into ``key, k_sel`` per leaf), so
a caller can inject JAX's draws; the port's runs take them from a seeded
CPU ``torch.Generator`` (a draw source, :class:`TorchNutsDraws`).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from bdlz_tpu_torch.backend import F64

#: Energy-error threshold marking a leapfrog leaf divergent (Stan's default).
DELTA_MAX = 1000.0

VALID_MASS_MATRIX = ("diag", "dense")


class NUTSRun(NamedTuple):
    """One multi-chain NUTS run's kept draws and adaptation."""

    chain: np.ndarray         # (n_keep, C, D)
    logp_chain: np.ndarray    # (n_keep, C)
    acceptance: float         # mean accept-prob statistic over kept draws
    step_size: float          # the ε the kept draws ran at
    inv_mass: np.ndarray      # (D,) diag or (D, D) dense inverse mass
    mass_matrix: str          # "diag" | "dense"
    n_leapfrog: int           # leapfrog steps = logp+grad evals, warmup incl.
    n_logp_evals: int         # n_leapfrog + per-phase initializations
    n_divergent: int          # divergent draws in the kept phase
    mean_tree_depth: float
    final: Tuple[Any, Any]    # (positions (C, D), logp (C,)) at the end
    n_batched_leaves: int = 0  # leaves the transitions ran, warmup incl.: one
                               # (C, D) value-and-grad each, one host sync


class NutsDraws(NamedTuple):
    """All the randomness of one transition of C chains, max depth md."""

    normal: torch.Tensor    # (C, D) standard normals of the momentum
    go_right: torch.Tensor  # (C, md) bool: the direction of each doubling
    u_acc: torch.Tensor     # (C, md) uniform: biased-progressive acceptance
    u_sel: torch.Tensor     # (C, md, 2**(md-1)) uniform: leaf selection


class TorchNutsDraws:
    """The port's draw source: everything from one CPU ``torch.Generator``
    in call order, each transition's draws shipped to the device in one
    copy.  ``phase`` names are ignored (a replay of another package's key
    tree uses them)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def momentum(self, phase: str, D: int) -> np.ndarray:
        """Standard normals (D,) of a step-size search's momentum."""
        return torch.randn(D, generator=self.generator, dtype=F64).numpy()

    def transition(self, phase: str, index: int, C: int, D: int, md: int,
                   device) -> NutsDraws:
        g = self.generator
        L = 1 << max(md - 1, 0)
        parts = [torch.randn(C * D, generator=g, dtype=F64),
                 torch.rand(C * md, generator=g, dtype=F64),
                 torch.rand(C * md, generator=g, dtype=F64),
                 torch.rand(C * md * L, generator=g, dtype=F64)]
        packed = torch.cat(parts).to(device)
        a, b, c = C * D, C * D + C * md, C * D + 2 * C * md
        return NutsDraws(
            normal=packed[:a].view(C, D),
            go_right=packed[a:b].view(C, md) < 0.5,
            u_acc=packed[b:c].view(C, md),
            u_sel=packed[c:].view(C, md, L),
        )


def _mass_ops(mass_matrix: str, inv_mass: torch.Tensor, chol_mass: torch.Tensor):
    """(velocity, kinetic, momentum-from-normals) over (C, D) rows."""
    if mass_matrix == "diag":
        def vel(r):
            return inv_mass * r

        def kinetic(r):
            return 0.5 * (r * r * inv_mass).sum(dim=-1)

        def momentum(normal):
            return normal * chol_mass
    else:
        def vel(r):
            return r @ inv_mass.T

        def kinetic(r):
            return 0.5 * (r * (r @ inv_mass.T)).sum(dim=-1)

        def momentum(normal):
            return normal @ chol_mass.T
    return vel, kinetic, momentum


def _popcount(n: int) -> int:
    return bin(n).count("1")


def _where(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Row-wise select of (C,) or (C, D) tensors by a (C,) mask."""
    if new.ndim > 1:
        mask = mask.view(-1, *([1] * (new.ndim - 1)))
    return torch.where(mask, new, old)


def make_nuts_draw(logp_fn: Callable, mass_matrix: str, max_tree_depth: int = 8) -> Callable:
    """The multi-chain NUTS transition.

    Returns ``step(z (C,D), logp (C,), grad (C,D), eps, inv_mass,
    chol_mass, draws) -> (z', logp', grad', stats)`` with ``stats =
    (accept_prob, depth, n_leapfrog, divergent)``, each (C,).  ε and the
    mass tensors are arguments, so the warmup windows and the sampling
    phase share one transition; ``logp``/``grad``
    carry the previous draw's evaluation, so a step costs exactly its
    leapfrog count of evaluations.  ``step.n_leaves`` counts the batched
    leaves (one (C, D) value-and-grad each) over every call.
    """
    from bdlz_tpu_torch.sampling.grad import make_logp_value_and_grad

    if mass_matrix not in VALID_MASS_MATRIX:
        raise ValueError(f"mass_matrix={mass_matrix!r} is not one of {VALID_MASS_MATRIX}")
    value_and_grad = make_logp_value_and_grad(logp_fn)
    md = int(max_tree_depth)

    def step(z, logp, grad, eps: float, inv_mass, chol_mass, draws: NutsDraws):
        C, D = z.shape
        dev = z.device
        im = torch.as_tensor(inv_mass, dtype=F64, device=dev)
        cm = torch.as_tensor(chol_mass, dtype=F64, device=dev)
        vel, kinetic, momentum = _mass_ops(mass_matrix, im, cm)

        def dot(a, b):
            return (a * b).sum(dim=-1)

        r0 = momentum(draws.normal)
        joint0 = logp - kinetic(r0)
        # the trajectory: edges, proposal, weights and counters per chain
        zl, rl, gl = z, r0, grad
        zr, rr, gr = z, r0, grad
        z_prop, lp_prop, g_prop = z, logp, grad
        log_sum_w = torch.zeros(C, dtype=F64, device=dev)
        sum_accept = torch.zeros(C, dtype=F64, device=dev)
        n_leap = torch.zeros(C, dtype=torch.int64, device=dev)
        depth = torch.zeros(C, dtype=torch.int64, device=dev)
        turning = torch.zeros(C, dtype=torch.bool, device=dev)
        diverging = torch.zeros(C, dtype=torch.bool, device=dev)
        neg_inf = torch.full((C,), -torch.inf, dtype=F64, device=dev)

        for d in range(md):
            active = ~(turning | diverging)
            if not bool(active.any()):
                break
            go_right = draws.go_right[:, d]
            direction = torch.where(go_right, torch.ones(C, dtype=F64, device=dev),
                                    torch.full((C,), -1.0, dtype=F64, device=dev))
            step_eps = direction * eps
            # ---- the subtree: 2**d leaves from the chosen edge ----------
            sz = torch.where(go_right[:, None], zr, zl)
            sr = torch.where(go_right[:, None], rr, rl)
            sg = torch.where(go_right[:, None], gr, gl)
            s_zp, s_lpp, s_gp = sz, neg_inf, sg
            s_lsw = neg_inf
            s_acc = torch.zeros(C, dtype=F64, device=dev)
            s_n = torch.zeros(C, dtype=torch.int64, device=dev)
            s_turn = torch.zeros(C, dtype=torch.bool, device=dev)
            s_div = torch.zeros(C, dtype=torch.bool, device=dev)
            ckpt_z: dict = {}
            ckpt_r: dict = {}
            for i in range(1 << d):
                live = active & ~(s_turn | s_div)
                if not bool(live.any()):
                    break
                step.n_leaves += 1
                # leapfrog
                r_half = sr + (0.5 * step_eps)[:, None] * sg
                z_new = sz + step_eps[:, None] * vel(r_half)
                lp_new, g_new = value_and_grad(z_new)
                r_new = r_half + (0.5 * step_eps)[:, None] * g_new
                joint = lp_new - kinetic(r_new)
                joint = torch.where(torch.isfinite(joint), joint, -torch.inf)
                w = joint - joint0
                div_new = w < -DELTA_MAX
                lsw_new = torch.logaddexp(s_lsw, w)
                take = torch.log(draws.u_sel[:, d, i]) < w - lsw_new
                take_l = live & take
                s_zp = _where(take_l, z_new, s_zp)
                s_lpp = _where(take_l, lp_new, s_lpp)
                s_gp = _where(take_l, g_new, s_gp)
                s_acc = _where(live, s_acc + torch.clamp_max(torch.exp(w), 1.0), s_acc)
                # the checkpoint scheme: even leaf i stores at slot
                # popcount(i); odd leaf i checks the slots of the subtrees
                # it closes, in trajectory order (dz flipped backwards)
                pc = _popcount(i)
                turn_new = torch.zeros(C, dtype=torch.bool, device=dev)
                if i % 2 == 0:
                    ckpt_z[min(pc, md)] = z_new
                    ckpt_r[min(pc, md)] = r_new
                else:
                    t_ones = _popcount(i & ~(i + 1))
                    v_new = vel(r_new)
                    for s in range(max(pc - t_ones, 0), min(pc - 1, md) + 1):
                        dz = direction[:, None] * (z_new - ckpt_z[s])
                        turn_new = turn_new | (dot(dz, vel(ckpt_r[s])) < 0.0) | (
                            dot(dz, v_new) < 0.0)
                sz = _where(live, z_new, sz)
                sr = _where(live, r_new, sr)
                sg = _where(live, g_new, sg)
                s_lsw = _where(live, lsw_new, s_lsw)
                s_n = s_n + live.to(torch.int64)
                s_div = s_div | (live & div_new)
                s_turn = s_turn | (live & turn_new)
            # ---- merge the subtree into the trajectory ----------------
            ok = ~(s_turn | s_div)
            take = active & ok & (torch.log(draws.u_acc[:, d]) < s_lsw - log_sum_w)
            z_prop = _where(take, s_zp, z_prop)
            lp_prop = _where(take, s_lpp, lp_prop)
            g_prop = _where(take, s_gp, g_prop)
            grow = active & ok
            log_sum_w = _where(grow, torch.logaddexp(log_sum_w, s_lsw), log_sum_w)
            left = grow & ~go_right
            right = grow & go_right
            zl, rl, gl = _where(left, sz, zl), _where(left, sr, rl), _where(left, sg, gl)
            zr, rr, gr = _where(right, sz, zr), _where(right, sr, rr), _where(right, sg, gr)
            dz = zr - zl
            uturn = (dot(dz, vel(rl)) < 0.0) | (dot(dz, vel(rr)) < 0.0)
            sum_accept = _where(active, sum_accept + s_acc, sum_accept)
            n_leap = n_leap + torch.where(active, s_n, 0)
            depth = depth + active.to(torch.int64)
            turning = turning | (active & (s_turn | uturn))
            diverging = diverging | (active & s_div)

        accept_prob = sum_accept / torch.clamp_min(n_leap, 1).to(F64)
        return z_prop, lp_prop, g_prop, (accept_prob, depth, n_leap, diverging)

    step.value_and_grad = value_and_grad
    step.n_leaves = 0
    return step


# ---------------------------------------------------------------------------
# dual-averaging step-size adaptation (Hoffman & Gelman 2014, §3.2.1),
# host NumPy as in the JAX package
# ---------------------------------------------------------------------------

class _DAState(NamedTuple):
    log_eps: float
    log_eps_avg: float
    h_avg: float
    mu: float
    t: float


def _da_init(eps0: float) -> _DAState:
    return _DAState(log_eps=float(np.log(eps0)), log_eps_avg=float(np.log(eps0)),
                    h_avg=0.0, mu=float(np.log(10.0 * eps0)), t=0.0)


def _da_update(da: _DAState, accept: float, target: float,
               gamma: float = 0.05, t0: float = 10.0, kappa: float = 0.75) -> _DAState:
    t = da.t + 1.0
    eta_h = 1.0 / (t + t0)
    h_avg = (1.0 - eta_h) * da.h_avg + eta_h * (target - accept)
    log_eps = da.mu - np.sqrt(t) / gamma * h_avg
    eta = t ** (-kappa)
    log_eps_avg = eta * log_eps + (1.0 - eta) * da.log_eps_avg
    return _DAState(log_eps=float(log_eps), log_eps_avg=float(log_eps_avg),
                    h_avg=float(h_avg), mu=da.mu, t=t)


def _find_reasonable_eps(value_and_grad, mass_matrix, inv_mass, chol_mass, normal,
                         z, logp, grad) -> Tuple[float, int]:
    """Hoffman–Gelman Algorithm 4 on one chain: double or halve ε until
    the one-step acceptance crosses 1/2.  ``normal`` (D,) are the
    momentum's standard normals.  Host loop; returns (ε, evaluations)."""
    dev = z.device
    im = torch.as_tensor(inv_mass, dtype=F64, device=dev)
    cm = torch.as_tensor(chol_mass, dtype=F64, device=dev)
    vel, kinetic, momentum = _mass_ops(mass_matrix, im, cm)
    z, grad = z[None, :], grad[None, :]
    r0 = momentum(torch.as_tensor(normal, dtype=F64, device=dev)[None, :])

    def one_step(eps):
        r_half = r0 + 0.5 * eps * grad
        z_new = z + eps * vel(r_half)
        logp_new, grad_new = value_and_grad(z_new)
        r_new = r_half + 0.5 * eps * grad_new
        return float((logp_new - kinetic(r_new))[0])

    joint0 = float((logp - kinetic(r0))[0])
    eps = 1.0
    evals = 1
    dlogp = one_step(eps) - joint0
    if not np.isfinite(dlogp):
        dlogp = -np.inf
    a = 1.0 if dlogp > np.log(0.5) else -1.0
    while a * dlogp > -a * np.log(2.0):
        eps = eps * (2.0 ** a)
        if eps > 1e6 or eps < 1e-12:
            break
        dlogp = one_step(eps) - joint0
        if not np.isfinite(dlogp):
            dlogp = -np.inf
        evals += 1
    return float(np.clip(eps, 1e-12, 1e6)), evals


def _estimate_inv_mass(samples: np.ndarray, mass_matrix: str) -> Tuple[np.ndarray, np.ndarray]:
    """(inv_mass, chol_mass) from pooled warmup samples (n, D), with
    Stan's shrinkage toward 1e-3·I by weight 5/(n+5)."""
    n = samples.shape[0]
    w = n / (n + 5.0)
    if mass_matrix == "diag":
        var = np.var(samples, axis=0, ddof=1 if n > 1 else 0)
        inv_mass = w * var + (1.0 - w) * 1e-3
        chol_mass = 1.0 / np.sqrt(inv_mass)
        return inv_mass, chol_mass
    cov = np.cov(samples, rowvar=False, ddof=1 if n > 1 else 0)
    cov = np.atleast_2d(cov)
    inv_mass = w * cov + (1.0 - w) * 1e-3 * np.eye(cov.shape[0])
    chol_mass = np.linalg.cholesky(np.linalg.inv(inv_mass))
    return inv_mass, chol_mass


# ---------------------------------------------------------------------------
# the multi-chain driver
# ---------------------------------------------------------------------------

class _PhaseStats(NamedTuple):
    accept_mean: float
    n_leapfrog: int
    depth_mean: float
    n_divergent: int


def _run_phase(step, draws, phase: str, md: int, z, logp, grad, n_steps: int, eps_or_da,
               target_accept, adapt: bool, inv_mass, chol_mass, thin: int = 1,
               collect: bool = True):
    """Advance all chains ``n_steps`` through the one transition.  With
    ``adapt`` dual averaging advances on the pooled (cross-chain mean)
    accept statistic.  Returns the kept (every ``thin``-th) positions and
    logp, host-stacked, and the summed stats."""
    C, D = z.shape
    chain, logp_chain = [], []
    acc_sum = depth_sum = 0.0
    n_leap = n_div = 0
    for t in range(int(n_steps)):
        eps = float(np.exp(eps_or_da.log_eps)) if adapt else float(eps_or_da)
        d = draws.transition(phase, t, C, D, md, z.device)
        z, logp, grad, (acc, depth, leap, div) = step(z, logp, grad, eps, inv_mass,
                                                     chol_mass, d)
        stats = torch.stack([acc.mean(), depth.to(F64).mean(), leap.sum().to(F64),
                             div.sum().to(F64)]).cpu().numpy()
        acc_step = float(stats[0])
        if adapt:
            eps_or_da = _da_update(eps_or_da, acc_step, target_accept)
        acc_sum += acc_step
        depth_sum += float(stats[1])
        n_leap += int(stats[2])
        n_div += int(stats[3])
        if collect and (t + 1) % thin == 0:
            chain.append(z.cpu().numpy())
            logp_chain.append(logp.cpu().numpy())
    stats = _PhaseStats(accept_mean=acc_sum / max(n_steps, 1), n_leapfrog=n_leap,
                        depth_mean=depth_sum / max(n_steps, 1), n_divergent=n_div)
    return (z, logp, grad, eps_or_da,
            np.stack(chain) if chain else None,
            np.stack(logp_chain) if logp_chain else None,
            stats)


def run_nuts(
    logp_fn: Callable,
    init,
    n_steps: int,
    *,
    generator: Optional[torch.Generator] = None,
    draws=None,
    n_warmup: Optional[int] = None,
    target_accept: float = 0.8,
    mass_matrix: str = "diag",
    max_tree_depth: int = 8,
    step_size: Optional[float] = None,
    inv_mass=None,
    thin: int = 1,
    device=None,
) -> NUTSRun:
    """Run multinomial NUTS from ``init`` (C, D) for ``n_steps`` draws.

    ``logp_fn`` is batched, (C, D) → (C,), and differentiable in torch;
    the chains run on ``device``, else on the logp's ``.device``, else on
    the card (no card raises; pass ``device="cpu"`` for the CPU).
    Randomness comes from ``generator`` (a seeded CPU
    ``torch.Generator``) or a ``draws`` source (:class:`TorchNutsDraws`'s
    interface).  With ``step_size=None`` the run warms up first
    (``n_warmup`` draws, default 300): ε search → dual averaging → pooled
    mass estimation → ε re-search and a final averaging window; fewer
    than 40 warmup draws adapt ε only, on the unit metric.  Warmup draws
    are not returned; their evaluations are counted.  With explicit
    ``step_size`` and ``inv_mass`` the run is a pure continuation (the
    checkpoint layer resumes segments so).
    """
    if mass_matrix not in VALID_MASS_MATRIX:
        raise ValueError(f"mass_matrix={mass_matrix!r} is not one of {VALID_MASS_MATRIX}")
    if not 0.0 < float(target_accept) < 1.0:
        raise ValueError(f"target_accept must be in (0, 1), got {target_accept!r}")
    if n_steps % thin:
        raise ValueError("n_steps must be divisible by thin")
    if (generator is None) == (draws is None):
        raise ValueError("pass exactly one of generator= and draws=")
    if draws is None:
        draws = TorchNutsDraws(generator)
    from bdlz_tpu_torch.sampling.ensemble import _sampler_device

    init = torch.as_tensor(init, dtype=F64, device=_sampler_device(logp_fn, device))
    if init.ndim != 2:
        raise ValueError(f"init must be (n_chains, D), got {tuple(init.shape)}")
    C, D = init.shape
    if (step_size is None) != (inv_mass is None):
        raise ValueError(
            "pass both step_size and inv_mass (a resumed run) or neither "
            "(a fresh, adapted run)"
        )
    resume = step_size is not None
    if resume and n_warmup:
        raise ValueError(
            "n_warmup must be 0 when resuming with an explicit "
            "step_size/inv_mass (adaptation already happened)"
        )
    n_warmup = 300 if (n_warmup is None and not resume) else int(n_warmup or 0)
    md = int(max_tree_depth)
    step = make_nuts_draw(logp_fn, mass_matrix, md)
    value_and_grad = step.value_and_grad
    # the initial evaluation happens here even on a resumed segment, so a
    # segmented run recomputes exactly as the uninterrupted one
    logp, grad = value_and_grad(init)
    n_evals = C
    if not bool(torch.isfinite(logp).all()):
        raise ValueError(
            "logp is not finite at the initial chain positions; start "
            "chains strictly inside the prior bounds"
        )
    z = init
    unit = (np.ones(D), np.ones(D)) if mass_matrix == "diag" else (np.eye(D), np.eye(D))

    total_leapfrog = 0
    if resume:
        inv_mass = np.asarray(inv_mass, dtype=np.float64)
        if mass_matrix == "diag":
            chol_mass = 1.0 / np.sqrt(inv_mass)
        else:
            chol_mass = np.linalg.cholesky(np.linalg.inv(inv_mass))
        eps = float(step_size)
    elif n_warmup < 40:
        # tiny warmup: step size only, on the unit metric
        inv_mass, chol_mass = unit
        eps0, ev = _find_reasonable_eps(value_and_grad, mass_matrix, inv_mass, chol_mass,
                                        draws.momentum("eps", D), z[0], logp[:1], grad[0])
        n_evals += ev
        z, logp, grad, da, _c, _l, st = _run_phase(
            step, draws, "p1", md, z, logp, grad, n_warmup, _da_init(eps0), target_accept,
            adapt=True, inv_mass=inv_mass, chol_mass=chol_mass, collect=False)
        total_leapfrog += st.n_leapfrog
        eps = float(np.exp(da.log_eps_avg))
    else:
        # three windows (Stan-lite)
        inv_mass, chol_mass = unit
        n1 = max(10, int(0.15 * n_warmup))
        n3 = max(10, int(0.10 * n_warmup))
        n2 = max(n_warmup - n1 - n3, 10)
        eps0, ev = _find_reasonable_eps(value_and_grad, mass_matrix, inv_mass, chol_mass,
                                        draws.momentum("eps", D), z[0], logp[:1], grad[0])
        n_evals += ev
        # window 1: step size only, unit metric
        z, logp, grad, da, _c, _l, st = _run_phase(
            step, draws, "p1", md, z, logp, grad, n1, _da_init(eps0), target_accept,
            adapt=True, inv_mass=inv_mass, chol_mass=chol_mass, collect=False)
        total_leapfrog += st.n_leapfrog
        # window 2: keep adapting ε, collect samples for the mass
        z, logp, grad, da, warm_chain, _l, st = _run_phase(
            step, draws, "p2", md, z, logp, grad, n2, da, target_accept,
            adapt=True, inv_mass=inv_mass, chol_mass=chol_mass)
        total_leapfrog += st.n_leapfrog
        inv_mass, chol_mass = _estimate_inv_mass(np.asarray(warm_chain).reshape(-1, D),
                                                 mass_matrix)
        # window 3: re-search ε under the new metric, final averaging
        eps0, ev = _find_reasonable_eps(value_and_grad, mass_matrix, inv_mass, chol_mass,
                                        draws.momentum("eps2", D), z[0], logp[:1], grad[0])
        n_evals += ev
        z, logp, grad, da, _c, _l, st = _run_phase(
            step, draws, "p3", md, z, logp, grad, n3, _da_init(eps0), target_accept,
            adapt=True, inv_mass=inv_mass, chol_mass=chol_mass, collect=False)
        total_leapfrog += st.n_leapfrog
        eps = float(np.exp(da.log_eps_avg))

    z, logp, grad, _eps, chain, logp_chain, stats = _run_phase(
        step, draws, "sample", md, z, logp, grad, int(n_steps), float(eps), target_accept,
        adapt=False, inv_mass=inv_mass, chol_mass=chol_mass, thin=thin)
    total_leapfrog += stats.n_leapfrog
    return NUTSRun(
        chain=chain if chain is not None else np.zeros((0, C, D)),
        logp_chain=logp_chain if logp_chain is not None else np.zeros((0, C)),
        acceptance=float(stats.accept_mean),
        step_size=float(eps),
        inv_mass=np.asarray(inv_mass),
        mass_matrix=mass_matrix,
        n_leapfrog=int(total_leapfrog),
        n_logp_evals=int(total_leapfrog + n_evals),
        n_divergent=int(stats.n_divergent),
        mean_tree_depth=float(stats.depth_mean),
        final=(z, logp),
        n_batched_leaves=int(step.n_leaves),
    )
