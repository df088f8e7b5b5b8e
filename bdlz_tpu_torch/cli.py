"""Single-point command line (framework layer L6):

    python -m bdlz_tpu_torch --config yields_config.json [--diagnostics]
        [--planck] [--quad on|off] [--sanitize] [--device cuda|cpu]
        [--maybe-compute-P-from-profile profile.csv [--lz-method M]
         [--lz-gamma-phi G] [--lz-momentum-average]]
    python -m bdlz_tpu_torch --write-template [--template-extensions]
        [--config path]

Counterpart of ``bdlz_tpu/cli.py``.  The printed result block, the
``Wrote yields_out.json`` line, the ``--planck`` block, the 21-row
``--diagnostics`` table and ``yields_out.json`` have the JAX CLI's form,
so the archived config prints the same bytes.  ``--device`` takes the
place of ``--backend``: the point runs on the card unless ``--device cpu``
is given, and the config's ``backend`` key is ignored.  Validation is
strict, as on a device backend of the JAX package.

``--maybe-compute-P-from-profile`` resolves P_chi_to_B from a bounce
profile as the JAX CLI does: the reference's external-module hook first
in a reference-shaped invocation, then the port's LZ kernel on the
device, falling back to the config value with the same ``[info]`` and
``[warn]`` lines.

The quadrature path is ``point_yields`` on the direct integrand, with an
unset ``quad_panel_gl`` pinned to the trapezoid (the archived outputs are
tied to it); the stiff path is the per-point ESDIRK solve, which warns and
carries on when a lane does not converge, as the reference's ODE path does.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from typing import Optional

import numpy as np
import torch

from bdlz_tpu_torch.backend import F64, resolve_device
from bdlz_tpu_torch.config import (
    Config,
    load_config,
    needs_ode_path,
    point_params_from_config,
    static_choices_from_config,
    validate,
    write_template,
)
from bdlz_tpu_torch.utils.deferred import add_deferred_flags, refuse_deferred_flags

#: Flags of the JAX CLI that the port replaces.
DEFERRED_FLAGS = {
    "--backend": (True, "the port has one backend: use --device cuda|cpu"),
}

#: Module names the reference's dynamic-import hook probes, in order.
_EXTERNAL_LZ_MODULES = (
    "lambda_local_LZ_from_profile",
    "extended_LZ_lambda",
    "transport_from_profile",
)


def try_external_P_from_profile(
    profile_csv_path: str, v_w: float
) -> "tuple[Optional[float], Optional[str]]":
    """The reference's external-module hook: the first of the three module
    names that imports provides ``compute_prob_from_profile(csv, v_w)``,
    or ``compute_lambda_eff_from_profile(csv)`` mapped through
    P = 1 − e^(−2πλ) with λ floored at 0; P clamps to [0, 1].  Every
    failure is swallowed (the reference's contract): ``(None, None)``.
    Returns ``(P, module_name)``."""
    import importlib

    try:
        for modname in _EXTERNAL_LZ_MODULES:
            try:
                mod = importlib.import_module(modname)
            except Exception:
                continue
            if hasattr(mod, "compute_prob_from_profile"):
                P = float(mod.compute_prob_from_profile(profile_csv_path, v_w))
            elif hasattr(mod, "compute_lambda_eff_from_profile"):
                lam = float(mod.compute_lambda_eff_from_profile(profile_csv_path))
                P = 1.0 - math.exp(-2.0 * math.pi * max(lam, 0.0))
            else:
                continue
            return max(min(P, 1.0), 0.0), modname
    except Exception:
        pass
    return None, None


def resolve_P(
    cfg: Config,
    profile_csv: Optional[str] = None,
    momentum_average: bool = False,
    lz_method: Optional[str] = None,
    lz_gamma_phi: float = 0.0,
    device=None,
) -> float:
    """LZ-probability resolution order (reference ``maybe_P``): a profile
    CSV takes precedence over the config value; both absent is an error.
    The prints are part of the CLI contract.

    A reference-shaped invocation (no estimator flags) honours the
    external-module hook first.  ``lz_method`` None is that sentinel; the
    kernel's default estimator is coherent.  With ``momentum_average`` the
    estimator is flux-averaged over incident momenta.
    """
    from bdlz_tpu_torch.lz.kernel import validate_gamma_phi

    explicit_method = lz_method is not None
    lz_method = lz_method or "coherent"
    if lz_method not in ("coherent", "local", "dephased"):
        raise ValueError(
            f"lz_method must be 'coherent', 'local', or 'dephased', "
            f"got {lz_method!r}"
        )
    validate_gamma_phi(lz_gamma_phi, lz_method)
    P_used = cfg.P_chi_to_B
    if profile_csv:
        # a missing card is the caller's error, not a failed computation
        # to fall back from
        device = resolve_device(device)
        reference_shaped = (
            not momentum_average and not explicit_method and not lz_gamma_phi
        )
        if reference_shaped:
            P_ext, ext_mod = try_external_P_from_profile(profile_csv, cfg.v_w)
            if P_ext is not None:
                # attribution goes to stderr: stdout keeps the reference's
                # one line
                print(
                    f"[info] external LZ module {ext_mod!r} provided P "
                    "(reference dynamic-import hook)",
                    file=sys.stderr,
                )
                print(f"[info] Using P_chi_to_B from profile: {P_ext:.6g}")
                return float(P_ext)
        P_try, reason = None, None
        try:
            if momentum_average:
                from bdlz_tpu_torch.lz import momentum_averaged_probability

                P_try, F_k = momentum_averaged_probability(
                    profile_csv, cfg.v_w, cfg.T_p_GeV, cfg.m_chi_GeV,
                    method=lz_method, gamma_phi=lz_gamma_phi, device=device,
                )
                print(f"[info] momentum-averaged LZ kernel: F_k = {F_k:.6g}")
            else:
                from bdlz_tpu_torch.lz import probability_from_profile

                P_try = float(probability_from_profile(
                    profile_csv, cfg.v_w, method=lz_method,
                    gamma_phi=lz_gamma_phi, device=device,
                ))
            P_try = max(min(P_try, 1.0), 0.0)
        except Exception as exc:  # fall back to config, like the reference
            P_try, reason = None, f"{type(exc).__name__}: {exc}"
        if P_try is not None:
            print(f"[info] Using P_chi_to_B from profile: {P_try:.6g}")
            P_used = P_try
        else:
            print("[warn] Could not compute P from profile automatically; falling back to config.")
            if reason:
                print(f"[info] profile P computation failed with: {reason}")
    if P_used is None:
        raise RuntimeError("P_chi_to_B is not set and could not be computed from profile.")
    return float(P_used)


def can_use_quadrature(cfg: Config) -> bool:
    """Fast-path guard (reference :372), the shared predicate of config.py."""
    return not needs_ode_path(cfg)


def _point(cfg: Config, P_used: float, dev: torch.device):
    from bdlz_tpu_torch.interop import point_params_from_numpy

    return point_params_from_numpy(point_params_from_config(cfg, P_used), dev)


def run_point(cfg: Config, P_used: float, device=None):
    """Evaluate one point on ``device`` (the card by default); returns a
    ``YieldsResult`` of one-element tensors."""
    from bdlz_tpu_torch.models.yields_pipeline import point_yields, present_day
    from bdlz_tpu_torch.physics.percolation import make_kjma_grid

    dev = resolve_device(device)
    pp = _point(cfg, P_used, dev)
    static = static_choices_from_config(cfg)
    if static.quad_panel_gl is None:
        static = static._replace(quad_panel_gl=False)  # bit-pinned default
    grid = make_kjma_grid(dev)
    if can_use_quadrature(cfg):
        return point_yields(pp, static, grid)

    from bdlz_tpu_torch.solvers.batching import initial_yields
    from bdlz_tpu_torch.solvers.sdirk import boltzmann_final_yields, solve_boltzmann_esdirk

    T_hi = cfg.T_max_over_Tp * cfg.T_p_GeV
    T_lo = cfg.T_min_over_Tp * cfg.T_p_GeV
    sol = solve_boltzmann_esdirk(pp, static, grid, initial_yields(pp, static), T_lo, T_hi)
    if not bool(sol.success.all()):
        # warn-but-continue, like the reference ODE path
        print(
            "[warn] ODE solver reported failure: ESDIRK did not converge "
            f"in {int(sol.n_steps[0])} steps"
        )
    Y_chi, Y_B = boltzmann_final_yields(sol)
    return present_day(Y_B, Y_chi, pp.m_chi_GeV, pp.m_B_kg)


def print_results(result) -> None:
    """The printed result block (the reference's byte contract)."""
    print("\n=== Results (today) ===")
    print(f"rho_B^0   = {float(result.rho_B_kg_m3):.3e} kg/m^3")
    print(f"rho_DM^0  = {float(result.rho_DM_kg_m3):.3e} kg/m^3")
    print(f"DM/B ratio= {float(result.DM_over_B):.6g}")


def print_diagnostics(cfg: Config, P_used: float, device=None) -> None:
    """The 21-row table of y(T), A/V, J_χ and S_B on a geomspace around
    T_p, evaluated on ``device`` in one batch."""
    from bdlz_tpu_torch.physics.percolation import area_over_volume, make_kjma_grid, y_of_T
    from bdlz_tpu_torch.physics.source import source_window
    from bdlz_tpu_torch.physics.thermo import wall_flux

    dev = resolve_device(device)
    pp = _point(cfg, P_used, dev)
    grid = make_kjma_grid(dev)
    print("\n# Diagnostics around percolation")
    Ts_np = np.geomspace(cfg.T_p_GeV * 0.5, cfg.T_p_GeV * 2.0, 21)
    Ts = torch.as_tensor(Ts_np, dtype=F64, device=dev)
    ys = y_of_T(Ts, pp.T_p_GeV, pp.beta_over_H)
    aov = area_over_volume(ys, pp.I_p, pp.beta_over_H, pp.T_p_GeV, pp.v_w,
                           pp.g_star, grid)
    J = pp.flux_scale * wall_flux(Ts, pp.m_chi_GeV, pp.g_chi, cfg.chi_stats)
    SB = pp.P * J * aov * source_window(ys, pp.sigma_y)
    print(" T/Tp      y(T)        A/V [GeV]         J_chi [GeV^3]      S_B [GeV^3]")
    for T, y, a, j, sb in zip(Ts_np, *(t.cpu().tolist() for t in (ys, aov, J, SB))):
        print(f"{T/cfg.T_p_GeV:7.3f}  {y:9.3f}  {a:14.6e}  {j:16.6e}  {sb:14.6e}")


def main(argv: Optional[list] = None) -> None:
    from bdlz_tpu_torch.utils.io import write_yields_out

    ap = argparse.ArgumentParser(
        description="First-principles DM/Baryon yields from bounce-sourced transport"
    )
    ap.add_argument("--config", required=False, help="Path to yields_config.json")
    ap.add_argument("--write-template", action="store_true",
                    help="Write a template config and exit (the reference's "
                         "20-key artifact, byte-identical)")
    ap.add_argument("--template-extensions", action="store_true",
                    dest="template_extensions",
                    help="With --write-template: include the framework "
                         "extension keys in the template.")
    ap.add_argument("--maybe-compute-P-from-profile", dest="profile_csv", default=None,
                    help="Try to compute P_chi_to_B from the LZ kernel using this profile CSV.")
    ap.add_argument("--diagnostics", action="store_true",
                    help="Print a small table of y(T), A/V(T), J_chi(T), S_B(T) around T_p.")
    ap.add_argument("--lz-momentum-average", action="store_true",
                    dest="lz_momentum_average",
                    help="With --maybe-compute-P-from-profile: flux-weighted "
                         "thermal average of the LZ probability over incident "
                         "chi momenta at T_p (the paper's F(k) layer; "
                         "framework addition).")
    from bdlz_tpu_torch.lz.options import POINT_METHODS, add_lz_method_flags, lz_flags_error

    add_lz_method_flags(
        ap, default=None, choices=POINT_METHODS, include_profile=False,
        method_help="With --maybe-compute-P-from-profile: the LZ "
                    "estimator (framework addition; same family as the "
                    "sweep/MCMC CLIs). Default: coherent transfer "
                    "matrix. Passing the flag (any value) opts into "
                    "the in-repo kernel, skipping the reference's "
                    "external-module hook.",
    )
    ap.add_argument("--quad", default=None, choices=("on", "off"),
                    help="Override the config's quad_panel_gl knob for this "
                         "point: on = snapped-panel Gauss-Legendre "
                         "y-quadrature, off = the reference trapezoid.  "
                         "Default: the config key; an absent key keeps the "
                         "bit-pinned trapezoid.")
    ap.add_argument("--planck", action="store_true",
                    help="Print the Planck comparison block: settling factor "
                         "f_settle and effective probability P_eff (paper "
                         "Eqs. 22-24).")
    ap.add_argument("--sanitize", action="store_true",
                    help="Runtime sanitizer (framework addition): the "
                         "op-level NaN check, finiteness asserts at every "
                         "pipeline layer boundary, and a float64 dtype-drift "
                         "check (ARCHITECTURE.md).")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    add_deferred_flags(ap, DEFERRED_FLAGS)
    args = ap.parse_args(argv)
    refuse_deferred_flags(ap, args, DEFERRED_FLAGS)

    if args.lz_momentum_average and not args.profile_csv:
        ap.error("--lz-momentum-average requires --maybe-compute-P-from-profile")
    if (args.lz_method is not None or args.lz_gamma_phi) and not args.profile_csv:
        ap.error("--lz-method/--lz-gamma-phi require "
                 "--maybe-compute-P-from-profile")
    err = lz_flags_error(args, default_method="coherent")
    if err:
        ap.error(err)
    if args.write_template:
        write_template(
            args.config or "yields_config.json",
            include_extensions=args.template_extensions,
        )
        return
    if not args.config:
        print("ERROR: --config is required (or use --write-template).")
        return

    cfg = load_config(args.config)
    if args.quad is not None:
        cfg = dataclasses.replace(cfg, quad_panel_gl=args.quad == "on")
    cfg = validate(cfg, backend="gpu")  # strict, as on a device backend
    if cfg.lz_mode != "two_channel":
        ap.error(
            f"lz_mode={cfg.lz_mode!r} in the config: the single-point "
            "CLI evaluates the two-channel kernel only — use "
            "sweep_cli for the chain/thermal scenarios, or drop the "
            "scenario keys"
        )
    if args.sanitize:
        from bdlz_tpu_torch import sanitize

        sanitize.enable()
    P_used = resolve_P(
        cfg, args.profile_csv, momentum_average=args.lz_momentum_average,
        lz_method=args.lz_method, lz_gamma_phi=args.lz_gamma_phi,
        device=args.device,
    )

    result = run_point(cfg, P_used, args.device)
    if args.sanitize:
        # the output boundary: the quadrature and ESDIRK paths land here
        sanitize.check_tree(sanitize.BOUNDARY_SOLVER, result)
    print_results(result)
    write_yields_out("yields_out.json", cfg, P_used, result)
    print("Wrote yields_out.json")

    if args.planck:
        from bdlz_tpu_torch.analysis import planck_comparison

        cmp_ = planck_comparison(float(result.DM_over_B), P_used)
        print("\n=== Planck comparison (paper Eqs. 22-24) ===")
        print(f"(rho_DM/rho_b)_raw    = {float(cmp_['ratio_raw']):.10g}")
        print(f"(rho_DM/rho_b)_Planck = {float(cmp_['ratio_planck']):.4g}")
        print(f"f_settle              = {float(cmp_['f_settle']):.5f}")
        print(f"P_eff                 = {float(cmp_['P_eff']):.5f}")

    if args.diagnostics:
        print_diagnostics(cfg, P_used, args.device)


if __name__ == "__main__":
    main()
