"""MCMC command line: the Planck likelihood over pipeline parameters.

    python -m bdlz_tpu_torch.mcmc_cli --config yields_config_equal_mass.json \\
        --param "m_chi_GeV=0.05:20" --param "P_chi_to_B=1e-4:1" \\
        --walkers 64 --steps 500 --out chain.npz [--device cpu]

Counterpart of ``bdlz_tpu/mcmc_cli.py``, with its flags, defaults,
validation, refusal strings, summary JSON and ``--out`` npz schema.  Each
sampled parameter gets a flat prior over its bounds; the likelihood is
the full yields pipeline (the tabulated fast path) mapped to
(Ω_b h², Ω_DM h²) against the Planck 2018 Gaussians.  The walkers (or
NUTS chains) run batched on ``--device`` (``cuda``, the default, fails
without a card; ``cpu`` runs the plain PyTorch path).  The initial walkers
are drawn from ``--seed`` and the chain from ``--seed`` + 1, as in the JAX
CLI, through CPU ``torch.Generator`` streams: a chain is reproducible per
seed on the CPU and on the card, but it is not the JAX CLI's chain.
``--sanitize`` arms the op-level NaN check over the whole run (the
stand-in for ``jax_debug_nans`` under the JAX likelihood) and checks the
chain at the output boundary.  ``--multihost`` joins the process group
from JAX's env vars (one identical invocation per process, each on its
``--device``): the stretch walkers are rounded to a multiple of twice
the processes and split over them for every logp evaluation, NUTS
chains stay unsharded, and only the coordinator writes and prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch


def parse_param(spec: str):
    name, _, rhs = spec.partition("=")
    lo, _, hi = rhs.partition(":")
    if not hi:
        raise ValueError(f"--param must look like name=lo:hi, got {spec!r}")
    return name.strip(), (float(lo), float(hi))


def initial_walkers(params, W: int, seed: int) -> np.ndarray:
    """(W, D) walkers uniform in each parameter's bounds, drawn from
    ``seed``'s stream, one parameter after the other."""
    from bdlz_tpu_torch.sampling.ensemble import make_generator

    g = make_generator(seed)
    cols = [lo + (hi - lo) * torch.rand(W, generator=g, dtype=torch.float64)
            for lo, hi in params.values()]
    return torch.stack(cols, dim=1).numpy()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="bdlz_tpu_torch ensemble-MCMC driver")
    ap.add_argument("--config", required=True)
    ap.add_argument("--param", action="append", required=True,
                    help="Sampled parameter with flat-prior bounds, e.g. m_chi_GeV=0.05:20")
    ap.add_argument("--walkers", type=int, default=64)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--burn", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="Write the chain to this .npz")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="Flush chain segments here incrementally; an "
                         "interrupted run resumes from the last completed "
                         "segment (bitwise-identical to uninterrupted)")
    ap.add_argument("--checkpoint-every", type=int, default=100,
                    help="Steps per checkpoint segment (with --checkpoint-dir)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    from bdlz_tpu_torch.lz.options import (
        SWEEP_METHODS,
        add_lz_method_flags,
        add_lz_scenario_flags,
        lz_flags_error,
    )

    add_lz_method_flags(
        ap, default="local", choices=SWEEP_METHODS,
        profile_help="Bounce-profile CSV: tie P_chi_to_B to the sampled "
                     "wall speed through the two-channel LZ kernel, so "
                     "sampling v_w samples the distributed-LZ physics",
        method_help="LZ estimator with --lz-profile: local (analytic in "
                    "v_w, evaluated exactly per walker), coherent (full "
                    "transfer matrix), local-momentum (thermal "
                    "flux-weighted average), and dephased (density-"
                    "matrix transport at --lz-gamma-phi) via a dense "
                    "P(v_w) interpolation table built once at startup",
    )
    add_lz_scenario_flags(ap)
    ap.add_argument("--lz-table-n", type=int, default=0, dest="lz_table_n",
                    help="Nodes of the P(v_w) table for coherent/"
                         "local-momentum/dephased/chain/thermal "
                         "(0 = per-method default)")
    ap.add_argument("--sampler", choices=("stretch", "nuts"), default=None,
                    help="Transition kernel: the affine-invariant stretch "
                         "move (default; gradient-free) or gradient-based "
                         "multinomial NUTS (batched chains, far higher ESS "
                         "per pipeline evaluation). Default: the config's "
                         "'sampler'")
    ap.add_argument("--mass-matrix", choices=("diag", "dense"), default=None,
                    dest="mass_matrix",
                    help="NUTS warmup metric (default: config "
                         "'mass_matrix'); 'dense' aligns correlated "
                         "posterior ridges")
    ap.add_argument("--target-accept", type=float, default=None,
                    dest="target_accept",
                    help="NUTS dual-averaging acceptance target "
                         "(default: config 'target_accept')")
    ap.add_argument("--nuts-warmup", type=int, default=None, dest="nuts_warmup",
                    help="NUTS adaptation draws (step-size search, dual "
                         "averaging, mass estimation) before sampling "
                         "(default 300)")
    ap.add_argument("--max-tree-depth", type=int, default=None, dest="max_tree_depth",
                    help="NUTS trajectory doubling cap (2^depth leapfrog "
                         "steps max per draw; default 8)")
    ap.add_argument("--sanitize", action="store_true",
                    help="Runtime sanitizer: the op-level NaN check under the "
                         "likelihood and a finite-f64 check of the chain")
    ap.add_argument("--multihost", action="store_true",
                    help="Join the process group from JAX_COORDINATOR_ADDRESS/"
                         "JAX_NUM_PROCESSES/JAX_PROCESS_ID; walkers shard across "
                         "the processes (one identical invocation per process)")
    args = ap.parse_args(argv)
    _gerr = lz_flags_error(args, default_method="local")
    if _gerr:
        raise SystemExit(_gerr)
    if not 0 <= args.burn < args.steps:
        raise SystemExit(
            f"--burn {args.burn} must satisfy 0 <= burn < --steps {args.steps}"
        )

    if args.multihost:
        from bdlz_tpu_torch.parallel import init_multihost

        init_multihost()

    from bdlz_tpu_torch.backend import resolve_device
    from bdlz_tpu_torch.config import load_config, static_choices_from_config, validate
    from bdlz_tpu_torch.lz.options import apply_scenario_flags
    from bdlz_tpu_torch.ops.kjma_table import make_f_table
    from bdlz_tpu_torch.sampling import make_pipeline_logprob, run_ensemble
    from bdlz_tpu_torch.sampling.ensemble import make_generator

    # the likelihood runs on a device backend: strict validation
    cfg = validate(load_config(args.config), backend="gpu")
    cfg = apply_scenario_flags(cfg, args)
    static = static_choices_from_config(cfg)
    params = dict(parse_param(s) for s in args.param)

    # sampler resolution: flags > config keys > defaults; a NUTS-only knob
    # stated with the stretch sampler is an error, not a no-op
    sampler = args.sampler or cfg.sampler
    if sampler == "stretch" and any(
        v is not None for v in (args.mass_matrix, args.target_accept,
                                args.nuts_warmup, args.max_tree_depth)
    ):
        raise SystemExit(
            "--mass-matrix/--target-accept/--nuts-warmup/--max-tree-depth "
            "have no effect with the stretch sampler; pass --sampler nuts"
        )
    mass_matrix = args.mass_matrix or cfg.mass_matrix
    target_accept = cfg.target_accept if args.target_accept is None else args.target_accept
    nuts_warmup = 300 if args.nuts_warmup is None else args.nuts_warmup
    max_tree_depth = 8 if args.max_tree_depth is None else args.max_tree_depth
    if not 0.0 < target_accept < 1.0:
        raise SystemExit(
            f"--target-accept must be in (0, 1), got {target_accept}"
        )

    if not args.lz_profile and (args.lz_method != "local" or args.lz_table_n
                                or "lz_gamma_phi" in params):
        raise SystemExit(
            "--lz-method/--lz-table-n/lz_gamma_phi sampling have no effect "
            "without --lz-profile"
        )
    if cfg.lz_mode != "two_channel":
        if not args.lz_profile:
            raise SystemExit(
                f"lz_mode={cfg.lz_mode!r} derives P from a bounce profile; "
                "pass --lz-profile"
            )
        if args.lz_method != "local" or args.lz_gamma_phi:
            raise SystemExit(
                f"--lz-method/--lz-gamma-phi have no effect with "
                f"lz_mode={cfg.lz_mode!r} (the scenario owns the kernel)"
            )
        if "lz_gamma_phi" in params:
            raise SystemExit(
                f"sampling lz_gamma_phi has no effect with lz_mode="
                f"{cfg.lz_mode!r} (the scenario derives its own dephasing)"
            )
        if cfg.lz_mode == "thermal" and "T_p_GeV" in params:
            raise SystemExit(
                "lz_mode='thermal' derives Gamma_phi at the pinned "
                "T_p_GeV; T_p_GeV cannot be sampled with it"
            )
    dev = resolve_device(args.device)
    lz_kwargs = {}
    _profile_fp = None
    _table_n = None
    _scenario = None
    gamma_sampled = False
    if args.lz_profile:
        if "P_chi_to_B" in params:
            raise SystemExit(
                "--lz-profile ties P_chi_to_B to the wall speed; sample v_w "
                "instead of P_chi_to_B"
            )
        from bdlz_tpu_torch.lz import sweep_bridge as sb
        from bdlz_tpu_torch.lz.profile import load_profile_csv

        profile = load_profile_csv(args.lz_profile)
        _profile_fp = sb.profile_fingerprint(profile)
        gamma_sampled = "lz_gamma_phi" in params
        if gamma_sampled:
            if args.lz_method != "dephased":
                raise SystemExit(
                    "sampling lz_gamma_phi requires --lz-method dephased"
                )
            if args.lz_gamma_phi:
                raise SystemExit(
                    "--lz-gamma-phi pins the rate; drop the flag to sample "
                    "lz_gamma_phi"
                )
            if "v_w" not in params:
                raise SystemExit(
                    "sampling lz_gamma_phi requires sampling v_w too (the "
                    "P table is 2-D in (v_w, gamma))"
                )
        if args.lz_method == "local-momentum":
            for k in ("T_p_GeV", "m_chi_GeV"):
                if k in params:
                    raise SystemExit(
                        f"--lz-method local-momentum evaluates P at the "
                        f"pinned thermal state; {k} cannot be sampled "
                        "with it"
                    )
        if cfg.lz_mode != "two_channel":
            _scenario = sb.scenario_identity(static)
            if "v_w" not in params:
                if args.lz_table_n:
                    raise SystemExit(
                        "--lz-table-n has no effect when v_w is not "
                        "sampled (P is resolved once host-side — no "
                        "table is built)"
                    )
                P_pin = float(sb.scenario_probabilities_for_points(
                    profile, static, [cfg.v_w], T_p_GeV=[cfg.T_p_GeV], device=dev)[0])
                cfg = dataclasses.replace(cfg, P_chi_to_B=P_pin)
            elif cfg.lz_mode == "chain":
                # the chain's band-traversing column through the 1/v table
                v_lo, v_hi = params["v_w"]
                tn = sb.make_P_table_n(profile, cfg.lz_n_levels, v_lo, v_hi,
                                       n=args.lz_table_n, device=dev)
                lz_kwargs["lz_P_table"] = sb.PTable(
                    u0=tn.u0, inv_du=tn.inv_du, values=tn.values[:, -1],
                    v_lo=tn.v_lo, v_hi=tn.v_hi, method="chain",
                )
                _table_n = int(tn.values.shape[0])
            else:
                # thermal: Γ_φ from the bath at the pinned T_p, then the
                # dephased table (or the coherent one at Γ = 0)
                from bdlz_tpu_torch.lz.thermal import thermal_gamma_phi, thermal_method_for

                method, gam = thermal_method_for(thermal_gamma_phi(
                    cfg.T_p_GeV, cfg.lz_bath_eta, cfg.lz_bath_omega_c))
                v_lo, v_hi = params["v_w"]
                ptab = sb.make_P_of_vw_table(profile, method, v_lo, v_hi, n=args.lz_table_n,
                                             gamma_phi=gam, device=dev)
                lz_kwargs["lz_P_table"] = ptab
                _table_n = int(ptab.values.shape[0])
        elif args.lz_method == "local":
            if args.lz_table_n:
                raise SystemExit(
                    "--lz-table-n has no effect with --lz-method local "
                    "(P(v_w) is analytic — no table is built)"
                )
            from bdlz_tpu_torch.lz.kernel import lambda_eff_from_profile

            lz_kwargs["lz_lambda1"] = lambda_eff_from_profile(profile, v_w=1.0)
        elif "v_w" not in params:
            if args.lz_table_n:
                raise SystemExit(
                    "--lz-table-n has no effect when v_w is not sampled "
                    "(P is resolved once host-side — no table is built)"
                )
            if args.lz_method == "local-momentum":
                from bdlz_tpu_torch.lz.momentum import local_momentum_average_batch

                P_pin = float(local_momentum_average_batch(
                    profile, [cfg.v_w], cfg.T_p_GeV, cfg.m_chi_GeV, device=dev)[0])
            else:
                P_pin = float(sb.probabilities_for_points(
                    profile, [cfg.v_w], method=args.lz_method,
                    gamma_phi=args.lz_gamma_phi, device=dev)[0])
            cfg = dataclasses.replace(cfg, P_chi_to_B=P_pin)
        elif gamma_sampled:
            v_lo, v_hi = params["v_w"]
            g_lo, g_hi = params["lz_gamma_phi"]
            _n_v, _n_g = sb.resolve_table2d_shape(args.lz_table_n)
            print(
                f"[mcmc] building P(v_w, Gamma_phi) table: {_n_v} speeds "
                f"x {_n_g} gammas = {_n_v * _n_g} profile transports; "
                "shrink with --lz-table-n (the speed axis) if startup "
                "cost matters",
                file=sys.stderr,
            )
            ptab2 = sb.make_P_of_vw_gamma_table(profile, v_lo, v_hi, g_lo, g_hi,
                                                n_v=args.lz_table_n, device=dev)
            lz_kwargs["lz_P_table2d"] = ptab2
            _table_n = list(ptab2.values.shape)
        else:
            v_lo, v_hi = params["v_w"]
            ptab = sb.make_P_of_vw_table(
                profile, args.lz_method, v_lo, v_hi, n=args.lz_table_n,
                T_p_GeV=cfg.T_p_GeV, m_chi_GeV=cfg.m_chi_GeV,
                gamma_phi=args.lz_gamma_phi, device=dev,
            )
            lz_kwargs["lz_P_table"] = ptab
            _table_n = int(ptab.values.shape[0])

    table = make_f_table(cfg.I_p)
    logp = make_pipeline_logprob(cfg, static, table, param_keys=tuple(params),
                                 bounds=params, device=dev, **lz_kwargs)

    if args.sanitize:
        from bdlz_tpu_torch.utils.profiling import enable_nan_debugging

        # the likelihood is the JAX CLI's jitted program: its layer
        # checkpoints see tracers there, so only the op-level check runs
        # until the output boundary below
        enable_nan_debugging(True)

    from bdlz_tpu_torch.parallel import make_mesh
    from bdlz_tpu_torch.parallel.multihost import is_coordinator, process_count

    # one mesh member per process, on its --device
    n_dev = process_count()
    if sampler == "nuts":
        # NUTS chains are batched, not sharded: a few gradient chains
        # leave no walker axis worth scattering
        W = max(int(args.walkers), 1)
        mesh = None
    else:
        W = ((args.walkers + 2 * n_dev - 1) // (2 * n_dev)) * 2 * n_dev
        mesh = make_mesh(shape=(n_dev, 1), devices=[dev]) if n_dev > 1 else None
    init = initial_walkers(params, W, args.seed)

    resumed_segments = 0
    if args.checkpoint_dir:
        from bdlz_tpu_torch.config import config_identity_dict
        from bdlz_tpu_torch.sampling.checkpoint import run_ensemble_checkpointed

        # the resolved static joins the run identity (tri-state engine
        # knobs resolved to what the likelihood runs)
        static_resolved = static._replace(
            quad_panel_gl=bool(static.quad_panel_gl),
            ode_auto_h0=bool(static.ode_auto_h0),
            ode_pi_controller=bool(static.ode_pi_controller),
            ode_tabulated_av=bool(static.ode_tabulated_av),
        )
        run = run_ensemble_checkpointed(
            args.seed + 1, logp, init, n_steps=args.steps,
            out_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
            static=static_resolved, sampler=sampler, device=dev, mesh=mesh,
            sampler_opts=(
                {"mass_matrix": mass_matrix, "target_accept": float(target_accept),
                 "max_tree_depth": int(max_tree_depth), "n_warmup": int(nuts_warmup)}
                if sampler == "nuts" else None
            ),
            identity={
                "config": config_identity_dict(cfg),
                "params": {k: list(v) for k, v in params.items()},
                **(
                    {"lz": {
                        "profile": _profile_fp,
                        **({"scenario": _scenario} if _scenario is not None else {}),
                        "method": args.lz_method,
                        "table_n": _table_n,
                        **({"gamma_phi": ("sampled" if gamma_sampled else args.lz_gamma_phi)}
                           if args.lz_method == "dephased" else {}),
                    }}
                    if args.lz_profile else {}
                ),
            },
        )
        full_chain, full_logp = run.chain, run.logp_chain
        acceptance = run.acceptance
        resumed_segments = run.resumed_segments
        nuts_info = (
            {"step_size": float(run.step_size), "n_logp_evals": int(run.n_logp_evals),
             "n_divergent": int(run.n_divergent)}
            if sampler == "nuts" else None
        )
    elif sampler == "nuts":
        from bdlz_tpu_torch.sampling import run_nuts

        run = run_nuts(
            logp, init, args.steps, generator=make_generator(args.seed + 1),
            n_warmup=int(nuts_warmup), target_accept=float(target_accept),
            mass_matrix=mass_matrix, max_tree_depth=int(max_tree_depth), device=dev,
        )
        full_chain, full_logp = run.chain, run.logp_chain
        acceptance = float(run.acceptance)
        nuts_info = {
            "step_size": float(run.step_size),
            "n_logp_evals": int(run.n_logp_evals),
            "n_divergent": int(run.n_divergent),
            "mean_tree_depth": round(float(run.mean_tree_depth), 3),
        }
    else:
        run = run_ensemble(logp, init, args.steps, generator=make_generator(args.seed + 1),
                           device=dev, mesh=mesh)
        full_chain = run.chain.cpu().numpy()
        full_logp = run.logp_chain.cpu().numpy()
        acceptance = float(run.acceptance)
        nuts_info = None

    if args.sanitize:
        from bdlz_tpu_torch import sanitize

        sanitize.enable(nans=False)
        # sampler -> output boundary: walker positions must stay finite
        # f64 (logp may legitimately be -inf outside the prior box)
        sanitize.checkpoint("L4:sampler -> output (mcmc)", chain=full_chain)
        sanitize.check_tree("L4:sampler -> output (mcmc)", {"logp": full_logp},
                            allow_nan=True)

    from bdlz_tpu_torch.sampling.diagnostics import integrated_autocorr_time, split_rhat

    post = full_chain[args.burn:]                       # (n, W, D)
    tau = integrated_autocorr_time(post)
    # split-R-hat needs >= 4 post-burn steps; shorter runs report null
    rhat = split_rhat(post) if post.shape[0] >= 4 else np.full(len(params), np.nan)
    n_eff = post.shape[0] * post.shape[1] / tau

    chain = post.reshape(-1, len(params))
    logps = full_logp[args.burn:].reshape(-1)
    best = int(np.argmax(logps))
    summary = {
        "walkers": W,
        "steps": args.steps,
        "burn": args.burn,
        "sampler": sampler,
        "acceptance": round(acceptance, 4),
        "map_logp": float(logps[best]),
        "map_params": {k: float(chain[best, i]) for i, k in enumerate(params)},
        "posterior_mean": {k: float(chain[:, i].mean()) for i, k in enumerate(params)},
        "posterior_std": {k: float(chain[:, i].std()) for i, k in enumerate(params)},
        "tau_int": {k: round(float(tau[i]), 3) for i, k in enumerate(params)},
        "split_rhat": {
            k: (round(float(rhat[i]), 5) if np.isfinite(rhat[i]) else None)
            for i, k in enumerate(params)
        },
        "n_eff": {k: round(float(n_eff[i]), 1) for i, k in enumerate(params)},
        # τ estimates need n ≳ 50·τ to be trustworthy (Sokal's criterion)
        "tau_reliable": bool(post.shape[0] >= 50 * float(tau.max())),
    }
    if nuts_info is not None:
        summary["nuts"] = {"mass_matrix": mass_matrix, **nuts_info}
    if args.checkpoint_dir:
        summary["checkpoint_dir"] = args.checkpoint_dir
        summary["resumed_segments"] = resumed_segments
    if args.lz_profile:
        summary["lz"] = {"profile": args.lz_profile, "method": args.lz_method}
        if _scenario is not None:
            summary["lz"]["mode"] = cfg.lz_mode
            summary["lz"]["scenario"] = _scenario
            del summary["lz"]["method"]
        if args.lz_method == "dephased":
            summary["lz"]["gamma_phi"] = "sampled" if gamma_sampled else args.lz_gamma_phi
    if args.out:
        if is_coordinator():
            from bdlz_tpu_torch.utils.io import atomic_savez

            atomic_savez(args.out, chain=full_chain, logp=full_logp,
                         param_names=list(params))
        summary["out"] = args.out
    if is_coordinator():
        print(json.dumps(summary))


if __name__ == "__main__":
    main()
