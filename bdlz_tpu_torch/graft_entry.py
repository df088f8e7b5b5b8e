"""Entry points of the compile check: the single-card forward step and the mesh dry run.

Counterpart of ``__graft_entry__.py``.  :func:`entry` exposes the flagship
forward step — the batched tabulated yields pipeline (a PointParams batch
→ Ω_DM/Ω_b) — with small example arguments on the card.

:func:`dryrun_multichip` builds a (dp × sp) mesh of n members and runs
one step of each engine on it:

1. the tabulated sweep step over ``2n`` points, batch-split over the
   mesh, with the χ² against Planck reduced across it;
2. the sp-split quadrature of the archived point (sp = 2 when n is even);
3. the kernel engine (P1, where JAX runs its Pallas engine) on the mesh,
   within 1e-6 of step 1;
4. the stiff ESDIRK engine on the batch-split washout config;
5. the stretch sampler with its walkers split over the mesh, gathered
   to the host.

Checks raise :class:`RuntimeError`.  On the card every member sits on
card ``k % count``; two members of one card run on their own CUDA
streams.  ``devices="cpu"`` puts every member on the host.  There is no
counterpart of JAX's ``_force_cpu_devices``: the port never pins the CPU
by itself.

    python -m bdlz_tpu_torch.graft_entry [n]    # dryrun_multichip(n or 8) on the card
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from bdlz_tpu_torch.backend import F64, resolve_device
from bdlz_tpu_torch.config import (
    config_from_dict,
    point_params_from_config,
    static_choices_from_config,
)
from bdlz_tpu_torch.constants import PLANCK_DM_OVER_B
from bdlz_tpu_torch.interop import point_params_from_numpy
from bdlz_tpu_torch.models.yields_pipeline import point_yields_fast
from bdlz_tpu_torch.ops.kjma_table import make_f_table, table_to_device
from bdlz_tpu_torch.parallel.gridshard import make_sp_quadrature
from bdlz_tpu_torch.parallel.mesh import make_mesh
from bdlz_tpu_torch.parallel.multihost import allreduce_sum, gather_to_host
from bdlz_tpu_torch.parallel.sweep import build_grid, make_sweep_step
from bdlz_tpu_torch.physics.percolation import make_kjma_grid
from bdlz_tpu_torch.sampling.ensemble import make_generator, run_ensemble

#: The archived nonthermal benchmark point (``__graft_entry__.py:51-59``).
ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
ENTRY_AXES = {"m_chi_GeV": np.geomspace(0.2, 2.0, 4), "T_p_GeV": [80.0, 120.0]}
ENTRY_TABLE_N, DRYRUN_TABLE_N = 4096, 2048
ENTRY_N_Y, DRYRUN_N_Y, SP_N_Y = 2000, 2048, 2048
KERNEL_RTOL = 1e-6  # P1 at n_y 2048 against the tabulated step at n_y 2000


def entry(device=None):
    """``(fn, (pp_batch, table))`` for the single-card check: ``fn(pp, tab)``
    maps the batch to its (8,) float64 Ω_DM/Ω_b through
    ``point_yields_fast`` at n_y 2000, in one batched call.  The batch and
    the 4096-entry F table (built on the host) live on ``device``: the
    card by default (no card raises), the CPU only when asked for."""
    dev = resolve_device(device)
    base = config_from_dict(ARCHIVED)
    static = static_choices_from_config(base)
    pp_batch = point_params_from_numpy(build_grid(base, ENTRY_AXES), dev)
    table = table_to_device(make_f_table(base.I_p, n=ENTRY_TABLE_N), dev)

    def fn(pp, tab):
        return point_yields_fast(pp, static, tab, n_y=ENTRY_N_Y).DM_over_B

    return fn, (pp_batch, table)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _members(n_devices: int, devices) -> list:
    if devices == "cpu":
        return ["cpu"] * n_devices
    if devices is not None:
        raise ValueError(f"devices must be None (the cards) or 'cpu', got {devices!r}")
    resolve_device(None)  # no card raises here
    count = torch.cuda.device_count()
    return [torch.device("cuda", k % count) for k in range(n_devices)]


def _toy_logp(theta: torch.Tensor) -> torch.Tensor:
    return -0.5 * (theta[:, 0] ** 2 + 2.0 * (theta[:, 1] - theta[:, 0]) ** 2)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """One step of every engine on an ``n_devices``-member mesh; prints
    JAX's summary line and returns ``mesh``, ``batch``, ``chi2``,
    ``ratios``, ``ratios_kernel``, ``YB_sp`` (None when sp = 1),
    ``Y_B_esdirk`` and ``engines``."""
    base = config_from_dict(ARCHIVED)
    static = static_choices_from_config(base)
    sp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh((n_devices // sp, sp), devices=_members(n_devices, devices))
    table = make_f_table(base.I_p, n=DRYRUN_TABLE_N)
    tables = {dev: table_to_device(table, dev) for dev in mesh.local_devices}
    engines: dict = {}

    # ---- dp: the sweep step over a tiny grid, the batch split over the mesh
    batch = 2 * n_devices
    pp = build_grid(base, {"m_chi_GeV": np.geomspace(0.2, 2.0, batch)})
    local = make_sweep_step(static, n_y=ENTRY_N_Y, impl="tabulated", mesh=mesh)(pp, tables)
    # each process's partial sum of squares, added across processes
    sq = torch.as_tensor(np.sum((local.DM_over_B / PLANCK_DM_OVER_B - 1.0) ** 2), dtype=F64)
    chi2 = float(allreduce_sum(sq)) / batch
    ratios = gather_to_host(local.DM_over_B)
    _check(ratios.shape == (batch,) and bool(np.all(np.isfinite(ratios))),
           f"tabulated ratios {ratios}")
    _check(np.isfinite(chi2), f"chi2 {chi2}")
    engines["tabulated(dp)"] = "ok"

    # ---- sp: one point's quadrature grid split over the sp axis --------
    YB_sp = None
    if sp > 1:
        pp0 = point_params_from_config(base, base.P_chi_to_B)
        YB_sp = float(make_sp_quadrature(static, mesh, n_y=SP_N_Y)(pp0, table))
        _check(np.isfinite(YB_sp) and YB_sp > 0.0, f"sp Y_B {YB_sp}")
        engines["gridshard(sp)"] = "ok"

    # ---- the kernel engine (P1) on the mesh; the key is JAX's name of the
    # step, whose engine there is the Pallas kernel under shard_map
    step_k = make_sweep_step(static, n_y=DRYRUN_N_Y, impl="kernel", mesh=mesh)
    ratios_kernel = gather_to_host(step_k(pp, tables).DM_over_B)
    _check(ratios_kernel.shape == (batch,) and bool(np.all(np.isfinite(ratios_kernel))),
           f"kernel ratios {ratios_kernel}")
    rel = float(np.max(np.abs(ratios_kernel - ratios) / np.abs(ratios)))
    _check(rel <= KERNEL_RTOL, f"kernel ratios {rel:.3e} rel from the tabulated ones")
    engines["pallas(shard_map)"] = "ok"

    # ---- esdirk: the stiff Boltzmann engine on the batch-split washout config
    cfg_ode = dataclasses.replace(base, Gamma_wash_over_H=0.01, T_min_over_Tp=0.2)
    pp_ode = build_grid(cfg_ode, {"m_chi_GeV": np.geomspace(0.5, 2.0, batch)})
    step_ode = make_sweep_step(static_choices_from_config(cfg_ode), mesh=mesh, impl="esdirk")
    grids = {dev: make_kjma_grid(dev) for dev in mesh.local_devices}
    Y_B_esdirk = gather_to_host(step_ode(pp_ode, grids).Y_B)
    _check(bool(np.all(np.isfinite(Y_B_esdirk))), f"esdirk Y_B {Y_B_esdirk}")
    engines["esdirk(dp)"] = "ok"

    # ---- the stretch sampler, its walkers split over the mesh -----------
    # walkers per member rounded up to even: W divides over the members
    # and halves for the red-black split at any mesh size, odd ones too
    per = max(2, -(-8 // n_devices))
    per += per % 2
    W = n_devices * per
    init = 2.0 * torch.rand((W, 2), generator=make_generator(3), dtype=F64) - 1.0
    run = run_ensemble(_toy_logp, init, n_steps=4, generator=make_generator(4), mesh=mesh)
    chain, logp_chain = gather_to_host((run.chain, run.logp_chain))
    _check(chain.shape == (4, W, 2) and bool(np.all(np.isfinite(chain))),
           f"chain of shape {chain.shape}")
    _check(logp_chain.shape == (4, W), f"logp chain of shape {logp_chain.shape}")
    engines["ensemble(dp)"] = "ok"

    print(
        f"dryrun_multichip OK: mesh={dict(mesh.shape)}, batch={batch}, chi2={chi2:.3e}, "
        "engines: " + " ".join(f"{k}={v}" for k, v in engines.items()),
        flush=True,
    )
    return {"mesh": dict(mesh.shape), "batch": batch, "chi2": chi2, "ratios": ratios,
            "ratios_kernel": ratios_kernel, "YB_sp": YB_sp, "Y_B_esdirk": Y_B_esdirk,
            "engines": engines}


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
