"""Lane-repacking batched ESDIRK engine — the stiff sweep's default.

Counterpart of ``bdlz_tpu/solvers/batching.py``.  The lockstep strategy
(``solve_boltzmann_esdirk`` over the whole batch, the sweep's
``impl="esdirk_lockstep"``) drags every lane through the masked step loop
until the slowest lane converges.  This engine instead:

* runs rounds of ``round_steps`` attempted steps (a budgeted
  ``esdirk_advance``, one shared stepper body), then gathers the lanes
  still running into a dense batch on the device before the next round;
* sorts lanes first by a stiffness proxy — |Γ_wash|, then the source
  ramp width σ_y/(β/H), both descending — so that lanes retire together;
* evaluates the RHS with the tabulated F(y) lookup when the batch shares
  one I_p, and turns on the Hairer–Wanner starting step and the PI
  controller: the tri-state knobs resolve None → on here, and off on the
  per-point path.

With the knobs off, each lane's result equals the lockstep engine's bit
for bit.  The JAX engine pads each round to a power-of-two bucket so that
XLA compiles a handful of programs; eager PyTorch compiles nothing, so
rounds run at their exact size and the ladder is dropped.

With a ``mesh`` each round's packed lanes are split over the members
(the batch plan of ``parallel/mesh.batch_sharding``), each piece advanced
on its member's device and CUDA stream; the compaction stays on the
host, in one process, as in the JAX engine.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from bdlz_tpu_torch.config import PointParams, StaticChoices
from bdlz_tpu_torch.physics.percolation import KJMAGrid
from bdlz_tpu_torch.utils.profiling import CompactionStats

#: Attempted-step budget per round (the JAX engine's default).
ROUND_STEPS_DEFAULT = 64

#: Host-built F(y) tables by (I_p, n): the build is a (n × 1200) host
#: tensor, paid once per I_p and process, not per chunk.
_AV_TABLE_CACHE: Dict[Tuple[float, int], object] = {}
_AV_TABLE_NODES = 16384


def _cached_av_table(I_p: float, device):
    from bdlz_tpu_torch.ops.kjma_table import make_f_table, table_to_device

    key = (float(I_p), _AV_TABLE_NODES)
    if key not in _AV_TABLE_CACHE:
        while len(_AV_TABLE_CACHE) >= 16:  # bound: each table is ~128 KB
            _AV_TABLE_CACHE.pop(next(iter(_AV_TABLE_CACHE)))
        _AV_TABLE_CACHE[key] = make_f_table(float(I_p), n=_AV_TABLE_NODES)
    return table_to_device(_AV_TABLE_CACHE[key], device)


def resolve_engine_knobs(static: StaticChoices, I_p_col) -> Dict[str, bool]:
    """Resolve the tri-state knobs for THIS engine: None → on.  The
    tabulated RHS also needs one I_p across the batch (the table is
    per-I_p); a mixed-I_p batch falls back to the exact kernel."""
    def tri(v, default):
        return default if v is None else bool(v)

    uniform_ip = np.unique(np.asarray(I_p_col, dtype=np.float64)).size == 1
    return {
        "auto_h0": tri(static.ode_auto_h0, True),
        "pi_controller": tri(static.ode_pi_controller, True),
        "tabulated_av": tri(static.ode_tabulated_av, True) and uniform_ip,
    }


def _take(nt, idx: torch.Tensor):
    """Lanes ``idx`` of every field of a NamedTuple of tensors."""
    return type(nt)(*(f[idx] for f in nt))


def _to(nt, device):
    return type(nt)(*(f.to(device) for f in nt))


def initial_yields(pp: PointParams, static: StaticChoices) -> torch.Tensor:
    """(P, 2) initial state: thermal lanes start at n_eq(T_hi)/s(T_hi),
    nonthermal ones at Y_chi_init; Y_B starts at 0.  Unknown regimes
    fall to thermal, as the reference ODE path's else-branch does."""
    from bdlz_tpu_torch.physics.thermo import entropy_density, n_chi_equilibrium

    if static.regime.lower().startswith("non"):
        Ychi0 = pp.Y_chi_init
    else:
        T_hi = pp.T_max_over_Tp * pp.T_p_GeV
        Ychi0 = n_chi_equilibrium(
            T_hi, pp.m_chi_GeV, pp.g_chi, static.chi_stats
        ) / entropy_density(T_hi, pp.g_star_s)
    return torch.stack([Ychi0, torch.zeros_like(Ychi0)], dim=-1)


def solve_boltzmann_esdirk_batch(
    pp: PointParams,
    static: StaticChoices,
    grid: KJMAGrid,
    round_steps: int = ROUND_STEPS_DEFAULT,
    max_steps: int = 10_000,
    stats: Optional[CompactionStats] = None,
    knobs: Optional[Dict[str, bool]] = None,
    mesh=None,
):
    """Solve the Boltzmann system for a batch of lanes (``pp`` of (P,)
    tensors on the device), lane-repacked.  Returns an ``ESDIRKSolution``
    in the INPUT lane order.

    ``knobs`` is a :func:`resolve_engine_knobs` result; None resolves
    from this batch.  A sweep resolves once over its full grid and passes
    the result, so that chunk boundaries never change which RHS runs.
    ``stats`` receives one record per round and the per-lane step counts.
    ``mesh`` splits each round's lanes over its members (one process).
    """
    from bdlz_tpu_torch.solvers.sdirk import (
        ESDIRKState,
        boltzmann_ode_problem,
        esdirk_advance,
        esdirk_init,
        solution_from_state,
    )

    dev = pp.m_chi_GeV.device
    n = int(pp.m_chi_GeV.shape[0])
    if n == 0:
        raise ValueError("empty batch")
    # the repacking plan is made on the host from the chunk's parameters
    host = PointParams(*(f.detach().cpu().numpy() for f in pp))  # bdlz-lint: disable=R3
    if knobs is None:
        knobs = resolve_engine_knobs(static, host.I_p)
    elif knobs["tabulated_av"] and np.unique(host.I_p).size != 1:
        raise ValueError(
            "tabulated_av=True passed for a batch with mixed I_p values"
        )
    av_table = (_cached_av_table(float(host.I_p[0]), dev)
                if knobs["tabulated_av"] else None)

    # cost bucketing: lexsort's LAST key is primary; stable, descending
    ramp_w = host.sigma_y / np.maximum(host.beta_over_H, 1e-30)
    order = np.lexsort((-ramp_w, -np.abs(host.Gamma_wash_over_H)))
    order_t = torch.as_tensor(order, dtype=torch.int64, device=dev)
    pp_sorted = _take(pp, order_t)

    rtol, atol, method = static.ode_rtol, static.ode_atol, static.ode_method
    aux_on: Dict[torch.device, tuple] = {dev: (grid, av_table)}

    def problem(pp_lanes):
        d = pp_lanes.m_chi_GeV.device
        if d not in aux_on:
            aux_on[d] = (_to(grid, d),
                         None if av_table is None else av_table._replace(
                             values=av_table.values.to(d)))
        g, av = aux_on[d]
        return boltzmann_ode_problem(
            pp_lanes, static.chi_stats, static.deplete_DM_from_source, g, av_table=av,
        )

    def advance(sub, pp_lanes):
        rhs_u, u0, u1, h_max_fn = problem(pp_lanes)
        return esdirk_advance(
            rhs_u, sub, u0, u1, rtol=rtol, atol=atol, max_steps=max_steps,
            h_max_fn=h_max_fn, method=method,
            pi_controller=knobs["pi_controller"], budget=round_steps,
        )

    def advance_on_mesh(sub, pp_lanes):
        """One round's lanes split over the members, each piece advanced
        on its device and stream, joined back in member order."""
        from bdlz_tpu_torch.parallel.mesh import batch_sharding, on_stream

        flat = mesh.devices.reshape(-1)
        launched = []
        for k, (a, b) in zip(mesh.local_members,
                             batch_sharding(mesh).local_bounds(int(sub.x.shape[0]))):
            if b == a:
                continue
            s = mesh.stream(k)
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(dev))
            with on_stream(s):
                part = (_to(type(sub)(*(f[a:b] for f in sub)), flat[k]),
                        _to(type(pp_lanes)(*(f[a:b] for f in pp_lanes)), flat[k]))
                launched.append((s, advance(*part)))
        parts = []
        for s, new in launched:
            if s is not None:
                torch.cuda.current_stream(dev).wait_stream(s)
            parts.append(_to(new, dev))
        return type(sub)(*(torch.cat([p[i] for p in parts]) for i in range(len(sub))))

    rhs_u, u0, u1, h_max_fn = problem(pp_sorted)
    state = esdirk_init(
        rhs_u, u0, u1, initial_yields(pp_sorted, static), rtol=rtol, atol=atol,
        h_max_fn=h_max_fn, method=method, auto_h0=knobs["auto_h0"],
    )

    def running(s: ESDIRKState) -> torch.Tensor:
        return ~s.done & (s.n < max_steps)

    round_index = 0
    while True:
        idx = torch.nonzero(running(state)).flatten()  # the round's host sync
        if idx.numel() == 0:
            break
        t0 = time.perf_counter()
        sub = _take(state, idx)
        new = (advance if mesh is None else advance_on_mesh)(sub, _take(pp_sorted, idx))
        state = ESDIRKState(*(f.index_copy(0, idx, g) for f, g in zip(state, new)))
        if stats is not None:
            retired = int(idx.numel() - running(new).sum())
            stats.record_round(
                round_index=round_index,
                batch_lanes=int(idx.numel()),
                active_lanes=int(idx.numel()),
                lanes_retired=retired,
                steps_accepted=int((new.n_accepted - sub.n_accepted).sum()),
                steps_rejected=int((new.n_rejected - sub.n_rejected).sum()),
                seconds=time.perf_counter() - t0,
            )
        round_index += 1

    unsort = torch.empty_like(order_t)
    unsort[order_t] = torch.arange(n, dtype=torch.int64, device=dev)
    sol = solution_from_state(_take(state, unsort))
    if stats is not None:
        stats.lane_steps = sol.n_steps.cpu().numpy()  # bdlz-lint: disable=R3 — stats sink, host
    return sol


def make_batched_esdirk_step(
    static: StaticChoices,
    round_steps: int = ROUND_STEPS_DEFAULT,
    max_steps: int = 10_000,
    stats_sink=None,
    knobs: Optional[Dict[str, bool]] = None,
    mesh=None,
):
    """``step(pp_chunk, grid) -> YieldsResult`` on the repacked engine;
    failed lanes become NaN rows.  ``stats_sink`` is called with each
    chunk's :class:`CompactionStats`; ``knobs`` pins one resolution
    across every chunk; ``mesh`` splits each round over its members."""
    def step(pp_chunk, grid):
        from bdlz_tpu_torch.models.yields_pipeline import YieldsResult, present_day

        stats = CompactionStats()
        sol = solve_boltzmann_esdirk_batch(
            pp_chunk, static, grid, round_steps=round_steps,
            max_steps=max_steps, stats=stats, knobs=knobs, mesh=mesh,
        )
        if stats_sink is not None:
            stats_sink(stats)
        res = present_day(sol.y[:, 1], sol.y[:, 0], pp_chunk.m_chi_GeV,
                          pp_chunk.m_B_kg)
        return YieldsResult(*(torch.where(sol.success, f, torch.nan) for f in res))

    return step
