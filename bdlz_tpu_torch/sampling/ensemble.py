"""Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch move).

Counterpart of ``bdlz_tpu/sampling/ensemble.py``.  The ensemble is one
(W, D) tensor; each red-black half-update proposes and accepts for W/2
walkers at once through the batched logp.

Stretch move: to update walker X_k against the complementary half {X_j},
draw z ~ g(z) ∝ 1/√z on [1/a, a] via z = ((a−1)u + 1)²/a, propose
Y = X_j + z (X_k − X_j), accept with log-probability
(D−1)·ln z + logp(Y) − logp(X_k).

The update is split from its randomness: :func:`stretch_step` is pure in
its draws (per half ``u_z``, ``j``, ``u_acc``), and :func:`run_ensemble`
takes them from a seeded CPU ``torch.Generator`` and ships each step's
draws to the device in one copy.  A chain is therefore a function of the
seed alone, the same on the CPU and on the card.  JAX's threefry draws
cannot be reproduced in torch: a port chain is not JAX's chain for the
same seed, but the optional ``draws`` source lets a caller inject JAX's
draws and compare the two steppers.

With a ``mesh`` the walker axis is split over its members for every
logp evaluation (each member's rows on its device and CUDA stream, the
rows gathered across processes); every process draws the same seeded
numbers and holds the whole ensemble, so the chain is bitwise the chain
without a mesh.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from bdlz_tpu_torch.backend import F64, resolve_device


class EnsembleState(NamedTuple):
    walkers: torch.Tensor   # (W, D)
    logp: torch.Tensor      # (W,)
    n_accept: torch.Tensor  # int64 scalar, cumulative over half-updates


class HalfDraws(NamedTuple):
    """The randomness of one half-update."""

    u_z: torch.Tensor    # (W/2,) uniform [0, 1): the stretch factor
    j: torch.Tensor      # (W/2,) int64: the anchor in the other half
    u_acc: torch.Tensor  # (W/2,) uniform [0, 1): the acceptance test


class EnsembleRun(NamedTuple):
    chain: torch.Tensor        # (n_keep, W, D)
    logp_chain: torch.Tensor   # (n_keep, W)
    final: EnsembleState
    acceptance: float          # overall acceptance fraction


def make_generator(seed: int, *streams: int) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded from ``(seed, *streams)`` through
    NumPy's ``SeedSequence``, so that two streams of one seed are
    independent."""
    state = np.random.SeedSequence([int(seed), *(int(s) for s in streams)])
    return torch.Generator(device="cpu").manual_seed(int(state.generate_state(1, np.uint64)[0]))


def draw_stretch(generator: torch.Generator, W: int, device) -> "tuple[HalfDraws, HalfDraws]":
    """One step's draws for both halves, from ``generator`` on the host,
    moved to ``device`` in one copy: per half ``u_z``, ``j``, ``u_acc``."""
    half = W // 2
    rows = []
    for _ in range(2):
        rows.append(torch.rand(half, generator=generator, dtype=F64))
        rows.append(torch.randint(0, half, (half,), generator=generator).to(F64))
        rows.append(torch.rand(half, generator=generator, dtype=F64))
    packed = torch.stack(rows).to(device)   # (6, W/2): j is exact in f64
    return tuple(HalfDraws(packed[3 * h], packed[3 * h + 1].long(), packed[3 * h + 2])
                 for h in range(2))


def _sampler_device(logp_fn, device=None) -> torch.device:
    """Where a sampler runs: ``device`` when given, else the logp's
    ``.device``, else the card (raising without one).  The CPU only when
    the caller or the logp asks for it."""
    own = getattr(logp_fn, "device", None)
    if device is None:
        return resolve_device(own)
    if own is not None and torch.device(own).type != torch.device(device).type:
        raise ValueError(f"device={str(device)!r} but the logp runs on {str(own)!r}")
    return resolve_device(device)


def _half_update(active, active_logp, other, logp_fn, a: float, d: HalfDraws):
    """Stretch-move update of ``active`` (W/2, D) against ``other``."""
    D = active.shape[1]
    z = ((a - 1.0) * d.u_z + 1.0) ** 2 / a
    anchors = other[d.j]
    proposal = anchors + z[:, None] * (active - anchors)
    logp_new = logp_fn(proposal)
    log_accept = (D - 1.0) * torch.log(z) + logp_new - active_logp
    accept = torch.log(d.u_acc) < log_accept
    new_active = torch.where(accept[:, None], proposal, active)
    new_logp = torch.where(accept, logp_new, active_logp)
    return new_active, new_logp, accept.sum()


def stretch_step(state: EnsembleState, logp_fn: Callable,
                 draws: "Sequence[HalfDraws]", a: float = 2.0) -> EnsembleState:
    """One full ensemble step (both red-black half-updates) with the given
    draws; ``logp_fn`` maps (n, D) walkers to (n,)."""
    half = state.walkers.shape[0] // 2
    first, second = state.walkers[:half], state.walkers[half:]
    lp1, lp2 = state.logp[:half], state.logp[half:]
    first, lp1, acc1 = _half_update(first, lp1, second, logp_fn, a, draws[0])
    second, lp2, acc2 = _half_update(second, lp2, first, logp_fn, a, draws[1])
    return EnsembleState(
        walkers=torch.cat([first, second]),
        logp=torch.cat([lp1, lp2]),
        n_accept=state.n_accept + acc1 + acc2,
    )


def sharded_logp(logp_fn: Callable, mesh, home) -> Callable:
    """``logp_fn`` with its batch split over ``mesh``: member ``k``'s rows
    (``batch_sharding``) evaluated on its device and stream, every
    process's rows gathered in order, the result on ``home``.  A member
    on another device than the logp's raises."""
    from bdlz_tpu_torch.parallel.mesh import batch_sharding, on_stream
    from bdlz_tpu_torch.parallel.multihost import allgather_ragged, process_count

    own = getattr(logp_fn, "device", None)
    flat = mesh.devices.reshape(-1)
    for dev in mesh.local_devices:
        if own is not None and torch.device(own) != dev:
            raise ValueError(f"the logp runs on {str(own)!r}, but a mesh member is {str(dev)!r}")

    def fn(x: torch.Tensor) -> torch.Tensor:
        bounds = batch_sharding(mesh).bounds(int(x.shape[0]))
        launched = []
        for k in mesh.local_members:
            lo, hi = bounds[k]
            s = mesh.stream(k)
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(flat[k]))
            with on_stream(s):
                launched.append((s, logp_fn(x[lo:hi].to(flat[k]))))
        parts = []
        for s, out in launched:
            if s is not None:
                torch.cuda.current_stream(home).wait_stream(s)
            parts.append(out.to(home))
        local = torch.cat(parts)
        if process_count() == 1:
            return local
        per = mesh.n_local
        counts = [bounds[(p + 1) * per - 1][1] - bounds[p * per][0]
                  for p in range(process_count())]
        return torch.as_tensor(allgather_ragged(local, counts), dtype=F64, device=home)

    fn.device = home
    return fn


def run_ensemble(
    logp_fn: Callable,
    init_walkers,
    n_steps: int,
    *,
    generator: Optional[torch.Generator] = None,
    a: float = 2.0,
    thin: int = 1,
    init_logp=None,
    draws: Optional[Callable[[int], "Sequence[HalfDraws]"]] = None,
    device=None,
    mesh=None,
) -> EnsembleRun:
    """Run the ensemble for ``n_steps``, keeping every ``thin``-th state.

    ``logp_fn`` is batched, (n, D) → (n,).  ``W`` must be even and
    ≥ 2D+2.  The walkers live on ``device``, else on the logp's
    ``.device``, else on the card (no card raises; pass ``device="cpu"``
    for the CPU).  Draws come from ``generator``
    (a seeded CPU ``torch.Generator``), or from ``draws(step) ->
    (half_1, half_2)`` when given.  ``init_logp`` carries a resumed
    chain's (W,) log-probabilities instead of re-evaluating them.  No
    host sync happens inside the step loop.  ``mesh`` splits the walkers
    of every logp evaluation over its members (:func:`sharded_logp`);
    the chain is the one without a mesh, bit for bit.
    """
    if (generator is None) == (draws is None):
        raise ValueError("pass exactly one of generator= and draws=")
    if mesh is not None:
        device = _sampler_device(logp_fn, device if device is not None
                                 else mesh.local_devices[0])
        logp_fn = sharded_logp(logp_fn, mesh, device)
    device = _sampler_device(logp_fn, device)
    walkers = torch.as_tensor(init_walkers, dtype=F64, device=device)
    W, D = walkers.shape
    if W % 2:
        raise ValueError("number of walkers must be even")
    if W < 2 * D + 2:
        raise ValueError(f"need >= {2 * D + 2} walkers for D={D}")
    if n_steps % thin:
        raise ValueError("n_steps must be divisible by thin")
    state = EnsembleState(
        walkers=walkers,
        logp=(logp_fn(walkers) if init_logp is None
              else torch.as_tensor(init_logp, dtype=F64, device=device)),
        n_accept=torch.zeros((), dtype=torch.int64, device=device),
    )
    chain, logp_chain = [], []
    for t in range(int(n_steps)):
        d = draws(t) if draws is not None else draw_stretch(generator, W, device)
        state = stretch_step(state, logp_fn, d, a)
        if (t + 1) % thin == 0:
            chain.append(state.walkers)
            logp_chain.append(state.logp)
    n_keep = int(n_steps) // thin
    return EnsembleRun(
        chain=torch.stack(chain) if chain else walkers.new_zeros((0, W, D)),
        logp_chain=torch.stack(logp_chain) if logp_chain else walkers.new_zeros((0, W)),
        final=state,
        acceptance=float(state.n_accept) / (W * n_steps) if n_keep else 0.0,
    )
