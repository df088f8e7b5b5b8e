"""Physics likelihoods of the sampling layer.

Counterpart of ``bdlz_tpu/sampling/likelihoods.py``: the yields pipeline's
present-day densities (``models.yields_pipeline.point_yields_fast``) are
normalised by ρ_crit/h² and scored against the Gaussian Planck 2018
constraints on (Ω_b h², Ω_DM h²).

Where JAX builds a one-point ``θ (D,) → scalar`` that the samplers
``vmap``, the port builds the batched function: ``logp(θ (W, D)) -> (W,)``
on the builder's ``device`` (the card unless the caller asks for the
CPU).  Every operation is per row — nothing reduces across walkers — so a
walker's value and gradient do not depend on the others.  The returned
functions carry their device as ``fn.device``.
"""
from __future__ import annotations

from typing import Callable, Mapping, Sequence, Tuple

import torch

from bdlz_tpu_torch.backend import F64, resolve_device
from bdlz_tpu_torch.config import Config, PointParams, StaticChoices, point_params_from_config
from bdlz_tpu_torch.constants import (
    GEV_TO_KG,
    PLANCK_OMEGA_B_H2,
    PLANCK_OMEGA_B_H2_SIGMA,
    PLANCK_OMEGA_DM_H2,
    PLANCK_OMEGA_DM_H2_SIGMA,
    RHO_CRIT_OVER_H2_KG_M3,
)
from bdlz_tpu_torch.models.yields_pipeline import YieldsResult, point_yields_fast
from bdlz_tpu_torch.parallel.sweep import AXIS_MAP


def omegas_from_result(result: YieldsResult):
    """(Ω_b h², Ω_DM h²) from present-day densities."""
    return (
        result.rho_B_kg_m3 / RHO_CRIT_OVER_H2_KG_M3,
        result.rho_DM_kg_m3 / RHO_CRIT_OVER_H2_KG_M3,
    )


def planck_gaussian_logp(omega_b_h2, omega_dm_h2):
    """Gaussian Planck 2018 log-likelihood on both density parameters
    (tensors or NumPy arrays)."""
    rb = (omega_b_h2 - PLANCK_OMEGA_B_H2) / PLANCK_OMEGA_B_H2_SIGMA
    rd = (omega_dm_h2 - PLANCK_OMEGA_DM_H2) / PLANCK_OMEGA_DM_H2_SIGMA
    return -0.5 * (rb * rb + rd * rd)


def as_theta(theta, device) -> torch.Tensor:
    """θ as a (W, D) float64 tensor on ``device``."""
    t = torch.as_tensor(theta, dtype=F64, device=device)
    if t.ndim != 2:
        raise ValueError(f"theta must be a (W, D) batch, got shape {tuple(t.shape)}")
    return t


def make_pipeline_logprob(
    base: Config,
    static: StaticChoices,
    table,
    param_keys: Sequence[str] = ("m_chi_GeV", "P_chi_to_B"),
    bounds: "Mapping[str, Tuple[float, float]] | None" = None,
    log_params: Sequence[str] = (),
    n_y: int = 2000,
    lz_lambda1: "float | None" = None,
    lz_P_table=None,
    lz_P_table2d=None,
    emulator=None,
    device=None,
) -> Callable:
    """``logp(θ (W, D)) -> (W,)``: the Planck likelihood of the pipeline
    at each walker, with JAX's parameter semantics.

    ``param_keys`` name the sampled dimensions (config-schema names, see
    ``AXIS_MAP``; ``"lz_gamma_phi"`` feeds ``lz_P_table2d``); everything
    else is pinned at ``base``.  ``bounds`` is a flat prior (−inf outside
    the box); ``log_params`` are sampled in log10.  ``lz_lambda1`` ties P
    to the wall speed by P = 1 − e^(−2πλ₁/v_w); ``lz_P_table`` /
    ``lz_P_table2d`` interpolate P(v_w) / P(v_w, Γ_φ) tables
    (``lz.sweep_bridge``).  ``table`` is the F-table (host or device),
    shipped to ``device`` once.  ``emulator`` (an artifact, a bundle or a
    directory) switches to the emulator-backed fast mode, checked against
    ``base``/``static`` at construction; walkers outside every domain
    score −inf.  A non-finite value is −inf.
    """
    n_lz = _check_param_spec(param_keys, lz_lambda1, lz_P_table, lz_P_table2d)
    bounds = dict(bounds or {})
    dev = resolve_device(device)
    if emulator is not None:
        return _make_emulator_logprob(base, static, emulator, param_keys, bounds, log_params,
                                      n_lz=n_lz, device=dev)

    from bdlz_tpu_torch.ops.kjma_table import table_to_device

    pp0 = point_params_from_config(base, base.P_chi_to_B or 0.0)
    bounds_lo, bounds_hi = bounds_arrays(param_keys, bounds, dev)
    bind = _make_theta_binder(pp0, param_keys, log_params, lz_lambda1=lz_lambda1,
                              lz_P_table=lz_P_table, lz_P_table2d=lz_P_table2d, device=dev)
    table_dev = table_to_device(table, dev)

    def logp(theta):
        theta = as_theta(theta, dev)
        # the flat prior, one membership test per walker
        lp = flat_prior(theta, bounds_lo, bounds_hi)
        res = point_yields_fast(bind(theta), static, table_dev, n_y=n_y)
        lp = lp + planck_gaussian_logp(*omegas_from_result(res))
        return torch.where(torch.isfinite(lp), lp, -torch.inf)

    logp.device = dev
    return logp


def _check_param_spec(param_keys: Sequence[str], lz_lambda1, lz_P_table, lz_P_table2d) -> int:
    """The constructor-time refusals shared by :func:`make_pipeline_logprob`
    and :func:`make_pipeline_observables` (JAX's strings); returns the
    number of armed lz_* P derivations."""
    n_lz = sum(x is not None for x in (lz_lambda1, lz_P_table, lz_P_table2d))
    if n_lz > 1:
        raise ValueError(
            "pass at most one of lz_lambda1 / lz_P_table / lz_P_table2d"
        )
    for k in param_keys:
        if k == "lz_gamma_phi":
            if lz_P_table2d is None:
                raise ValueError(
                    "sampling 'lz_gamma_phi' requires lz_P_table2d "
                    "(a P(v_w, gamma) table from make_P_of_vw_gamma_table)"
                )
            continue
        if k not in AXIS_MAP:
            raise ValueError(f"unknown parameter {k!r}; valid: {sorted(AXIS_MAP)}")
    if lz_P_table2d is not None and "lz_gamma_phi" not in param_keys:
        raise ValueError(
            "lz_P_table2d is only for sampling 'lz_gamma_phi'; use the 1-D "
            "lz_P_table when the rate is pinned"
        )
    if n_lz and "P_chi_to_B" in param_keys:
        raise ValueError(
            "P_chi_to_B cannot be sampled when the profile ties P to the "
            "wall speed; sample v_w instead"
        )
    if "I_p" in param_keys:
        raise ValueError(
            "I_p cannot be a sampled parameter on the tabulated fast path: "
            "the KJMA F-table is built for one I_p (see run_sweep's "
            "use_table guard), and its values are CONSTANTS wrt I_p under "
            "autodiff (the gradient would be silently wrong — "
            "docs/perf_notes.md); pin I_p or sample with the direct kernel"
        )
    return n_lz


def bounds_arrays(param_keys: Sequence[str], bounds: Mapping[str, Tuple[float, float]],
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) prior-bound vectors over ``param_keys`` (±inf = unbounded),
    on ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    lo = torch.tensor([bounds[k][0] if k in bounds else -torch.inf for k in param_keys],
                      dtype=F64, device=device)
    hi = torch.tensor([bounds[k][1] if k in bounds else torch.inf for k in param_keys],
                      dtype=F64, device=device)
    return lo, hi


def flat_prior(theta: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """0 for a walker inside the box, −inf outside: one membership test
    per row of ``theta`` (W, D)."""
    inside = ((theta >= lo) & (theta <= hi)).all(dim=1)
    zero = torch.zeros(theta.shape[0], dtype=F64, device=theta.device)
    return zero.masked_fill(~inside, -torch.inf)


def _device_values(table, device):
    """An lz table with its ``values`` as a float64 tensor on ``device``."""
    return table._replace(values=torch.as_tensor(table.values, dtype=F64, device=device))


def _make_theta_binder(pp0: PointParams, param_keys: Sequence[str], log_params: Sequence[str],
                       lz_lambda1=None, lz_P_table=None, lz_P_table2d=None,
                       device=None) -> Callable:
    """``θ (W, D) -> PointParams`` of (W,) tensors, shared by the exact
    logp and the gradient layer: log10 entries through ``10**v``, the
    baryon mass GeV → kg, and P rebound by the λ₁ law or the cubic P
    tables, all differentiable in θ."""
    device = resolve_device(device)
    if lz_P_table is not None:
        lz_P_table = _device_values(lz_P_table, device)
    if lz_P_table2d is not None:
        lz_P_table2d = _device_values(lz_P_table2d, device)

    def bind(theta: torch.Tensor) -> PointParams:
        W = theta.shape[0]
        values = {}
        gamma_phi = None
        for i, k in enumerate(param_keys):
            v = theta[:, i]
            if k in log_params:
                v = torch.pow(10.0, v)
            if k == "lz_gamma_phi":
                gamma_phi = v  # feeds the P table, not PointParams
                continue
            if k == "m_B_GeV":
                v = v * GEV_TO_KG  # PointParams stores the baryon mass in kg
            values[AXIS_MAP[k]] = v
        pp = PointParams(*(
            values[f] if f in values
            else torch.full((W,), float(getattr(pp0, f)), dtype=F64, device=theta.device)
            for f in PointParams._fields
        ))
        if lz_lambda1 is not None:
            v_w = torch.clamp(pp.v_w, 1e-6, 1.0 - 1e-12)
            pp = pp._replace(P=1.0 - torch.exp(-2.0 * torch.pi * lz_lambda1 / v_w))
        elif lz_P_table is not None:
            from bdlz_tpu_torch.lz.sweep_bridge import eval_P_table

            pp = pp._replace(P=eval_P_table(pp.v_w, lz_P_table))
        elif lz_P_table2d is not None:
            from bdlz_tpu_torch.lz.sweep_bridge import eval_P_table_2d

            pp = pp._replace(P=eval_P_table_2d(pp.v_w, gamma_phi, lz_P_table2d))
        return pp

    return bind


def make_pipeline_observables(
    base: Config,
    static: StaticChoices,
    table,
    param_keys: Sequence[str] = ("m_chi_GeV", "P_chi_to_B"),
    log_params: Sequence[str] = (),
    n_y: int = 2000,
    lz_lambda1: "float | None" = None,
    lz_P_table=None,
    lz_P_table2d=None,
    device=None,
) -> Callable:
    """``θ (W, D) -> (Ω_b h² (W,), Ω_DM h² (W,))`` through the exact
    pipeline: the logp without its prior and likelihood, with the same
    parameter semantics and refusals — the differentiation surface of
    :mod:`bdlz_tpu_torch.sampling.grad`."""
    from bdlz_tpu_torch.ops.kjma_table import table_to_device

    _check_param_spec(param_keys, lz_lambda1, lz_P_table, lz_P_table2d)
    dev = resolve_device(device)
    pp0 = point_params_from_config(base, base.P_chi_to_B or 0.0)
    bind = _make_theta_binder(pp0, param_keys, log_params, lz_lambda1=lz_lambda1,
                              lz_P_table=lz_P_table, lz_P_table2d=lz_P_table2d, device=dev)
    table_dev = table_to_device(table, dev)

    def observables(theta):
        res = point_yields_fast(bind(as_theta(theta, dev)), static, table_dev, n_y=n_y)
        return omegas_from_result(res)

    observables.device = dev
    return observables


def _make_emulator_logprob(base, static, emulator, param_keys, bounds, log_params, n_lz: int,
                           device) -> Callable:
    """The emulator-backed fast mode: validate the artifact against the
    caller's physics, then interpolate log10(ρ_B), log10(ρ_DM) from its
    tables (every domain of a bundle, each walker routed to the domain
    that holds it)."""
    from bdlz_tpu_torch.emulator import (
        EmulatorArtifact,
        MultiDomainArtifact,
        build_identity,
        check_identity,
        domain_artifacts,
        load_any_artifact,
    )
    from bdlz_tpu_torch.emulator.grid import (
        device_tables,
        in_domain,
        interp_log_fields,
        select_domains,
    )

    if n_lz:
        raise ValueError(
            "the emulator fast mode is mutually exclusive with the lz_* P "
            "derivations: bake the LZ seam into the emulator's axes (e.g. "
            "sweep v_w with lz_profile at BUILD time) instead"
        )
    if not isinstance(emulator, (EmulatorArtifact, MultiDomainArtifact)):
        emulator = load_any_artifact(str(emulator))
    missing = [k for k in param_keys if k not in emulator.axis_names]
    if missing:
        raise ValueError(
            f"sampled parameter(s) {missing} are not axes of the emulator "
            f"artifact (axes: {list(emulator.axis_names)}); rebuild the "
            "artifact with those axes or sample on the exact path"
        )
    # stale-artifact gate; a tri-state caller adopts the artifact's scheme
    q_art = emulator.identity.get("quad_panel_gl")
    if static.quad_panel_gl is None and q_art is not None:
        static = static._replace(quad_panel_gl=bool(q_art))
    check_identity(
        emulator,
        build_identity(base, static, int(emulator.identity.get("n_y", 0)),
                       str(emulator.identity.get("impl", "tabulated"))),
    )
    doms = domain_artifacts(emulator)
    pinned: dict = {}
    for k_ax, name in enumerate(emulator.axis_names):
        if name in param_keys:
            continue
        v = getattr(base, name)
        if v is None:
            raise ValueError(
                f"emulator axis {name!r} is not sampled and the base config "
                "pins it to None; set a concrete value"
            )
        v = float(v)
        spans = [(float(d.axis_nodes[k_ax][0]), float(d.axis_nodes[k_ax][-1])) for d in doms]
        if not any(lo <= v <= hi for lo, hi in spans):
            raise ValueError(
                f"base config {name}={v} lies outside every emulator "
                f"domain for that axis (domains span {spans}; a gap is "
                "the seam band — every walker would score -inf)"
            )
        pinned[name] = v

    tables = [device_tables(dom, ("rho_B_kg_m3", "rho_DM_kg_m3"), device) for dom in doms]
    axis_order = emulator.axis_names
    key_pos = {k: i for i, k in enumerate(param_keys)}
    bounds_lo, bounds_hi = bounds_arrays(param_keys, bounds, device)

    def eval_fn(table, tvec):
        logs = interp_log_fields(tvec, table)
        return (logs["rho_B_kg_m3"], logs["rho_DM_kg_m3"]), in_domain(tvec, table.nodes)

    def logp(theta):
        theta = as_theta(theta, device)
        W = theta.shape[0]
        lp = flat_prior(theta, bounds_lo, bounds_hi)
        cols = []
        for name in axis_order:
            if name in key_pos:
                v = theta[:, key_pos[name]]
                cols.append(torch.pow(10.0, v) if name in log_params else v)
            else:
                cols.append(torch.full((W,), pinned[name], dtype=F64, device=device))
        (log_b, log_d), inside = select_domains(torch.stack(cols, dim=1), tables, eval_fn)
        ob = torch.pow(10.0, log_b) / RHO_CRIT_OVER_H2_KG_M3
        od = torch.pow(10.0, log_d) / RHO_CRIT_OVER_H2_KG_M3
        lp = lp + planck_gaussian_logp(ob, od)
        lp = torch.where(inside, lp, -torch.inf)
        return torch.where(torch.isfinite(lp), lp, -torch.inf)

    logp.device = device
    return logp
