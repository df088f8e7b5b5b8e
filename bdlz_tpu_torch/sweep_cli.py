"""Sweep command line on one CUDA device:

    python -m bdlz_tpu_torch.sweep_cli \\
        --config yields_config_equal_mass.json \\
        --axis "m_chi_GeV=geom:0.1:10:64" --axis "v_w=lin:0.05:0.95:16"

Axis syntax: ``name=geom:start:stop:n`` (geomspace), ``lin:start:stop:n``
(linspace), or an explicit comma list ``name=0.1,0.5,1.0``.  A JSON
summary with the JAX sweep CLI's keys goes to stdout.  ``--device cpu``
runs the plain PyTorch path on the host; the default is the card.

``--lz-profile``/``--bounce`` derive each point's P from its wall speed
through the LZ layer (``--lz-method``, ``--lz-gamma-phi``, and the
scenario flags ``--lz-mode``/``--lz-n-levels``/``--lz-bath-*``), with the
JAX sweep CLI's pairing errors.  Its flags that the port does not have
yet (resume directories, event logs, the sanitizer, meshes and elastic
fleets) are refused with the ROADMAP item that brings them.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np

from bdlz_tpu_torch.utils.deferred import add_deferred_flags, refuse_deferred_flags

_D2 = "ROADMAP D2, sweep resume, retry and caches"
_D6 = "ROADMAP D6, host planes"
_D7 = "ROADMAP D7, serving and elastic sweeps"
_D9 = "ROADMAP D9, multi-GPU"
#: Flags of the JAX sweep CLI that the port does not have yet.
DEFERRED_FLAGS = {
    "--out": (True, _D2), "--events": (True, _D2),
    "--sanitize": (False, _D6), "--debug-nans": (False, _D6),
    "--profile-dir": (True, _D6),
    "--elastic": (True, _D7), "--elastic-store": (True, _D7),
    "--elastic-workers": (True, _D7), "--worker-id": (True, _D7),
    "--lease-ttl": (True, _D7), "--quarantine-after": (True, _D7),
    "--churn-plan": (True, _D7), "--poll": (True, _D7),
    "--mesh-sp": (True, _D9), "--multihost": (False, _D9),
}


def parse_axis(spec: str):
    name, _, rhs = spec.partition("=")
    if not rhs:
        raise ValueError(f"--axis must look like name=geom:a:b:n, got {spec!r}")
    if rhs.startswith(("geom:", "lin:")):
        kind, a, b, n = rhs.split(":")
        a, b, n = float(a), float(b), int(n)
        vals = np.geomspace(a, b, n) if kind == "geom" else np.linspace(a, b, n)
    else:
        vals = np.asarray([float(v) for v in rhs.split(",")])
    return name.strip(), vals


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="bdlz_tpu_torch parameter sweep")
    ap.add_argument("--config", required=True, help="Base yields_config JSON")
    ap.add_argument("--axis", action="append", default=[],
                    help="Sweep axis, e.g. m_chi_GeV=geom:0.1:10:64 (repeatable)")
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--n-y", type=int, default=8000, dest="n_y")
    ap.add_argument("--impl", default="kernel",
                    choices=("kernel", "tabulated", "direct", "esdirk",
                             "esdirk_lockstep"),
                    help="Per-point engine: kernel (hand-written CUDA "
                         "interpolate-and-reduce kernels), tabulated (the "
                         "same quadrature in plain PyTorch), direct (the "
                         "exact (n_y x n_z) integrand; forced when I_p is "
                         "swept), esdirk (the lane-repacking stiff Boltzmann "
                         "engine; forced when sigma_v, washout or depletion "
                         "are active), esdirk_lockstep (the same stepper run "
                         "to completion over the whole chunk, kept for A/B)")
    ap.add_argument("--fuse-exp", action="store_true", dest="fuse_exp",
                    help="With --impl kernel: evaluate the merged exponential "
                         "inside the kernel (native f64 exp)")
    ap.add_argument("--quad", default="auto", choices=("auto", "on", "off"),
                    help="y-quadrature on the tabulated engine: auto (default: "
                         "snapped-panel Gauss-Legendre once the population "
                         "audit passes, else the reference trapezoid, "
                         "loudly), on (the panel rule, no audit), off (the "
                         "reference trapezoid).  Overrides the config's "
                         "quad_panel_gl")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    from bdlz_tpu_torch.lz.options import (
        SWEEP_METHODS,
        add_bounce_flag,
        add_lz_method_flags,
        add_lz_scenario_flags,
        apply_scenario_flags,
        bounce_flag_error,
        lz_flags_error,
    )

    add_lz_method_flags(
        ap, default="local", choices=SWEEP_METHODS,
        profile_help="Bounce-profile CSV: derive each point's P_chi_to_B "
                     "from its own wall speed through the two-channel LZ "
                     "kernel (v_w scans then exercise the distributed-LZ "
                     "physics end to end)",
        method_help="Per-point LZ estimator with --lz-profile: local "
                    "(analytic composition, spectrally exact — the "
                    "1e-6-contract default), coherent (full transfer "
                    "matrix, carries Stueckelberg oscillations), "
                    "local-momentum (thermal flux-weighted average), "
                    "dephased (density-matrix transport with "
                    "--lz-gamma-phi dephasing)",
    )
    add_lz_scenario_flags(ap)
    add_bounce_flag(ap)
    add_deferred_flags(ap, DEFERRED_FLAGS)
    args = ap.parse_args(argv)
    refuse_deferred_flags(ap, args, DEFERRED_FLAGS)
    if args.fuse_exp and args.impl != "kernel":
        ap.error("--fuse-exp requires --impl kernel")
    err = bounce_flag_error(args) or lz_flags_error(args, default_method="local")
    if err:
        ap.error(err)
    if args.lz_mode in ("chain", "thermal") and not (args.lz_profile or args.bounce):
        ap.error(f"--lz-mode {args.lz_mode} derives P per point from a "
                 "bounce profile; pass --lz-profile or --bounce")

    from bdlz_tpu_torch.config import load_config, static_choices_from_config, validate
    from bdlz_tpu_torch.constants import PLANCK_DM_OVER_B
    from bdlz_tpu_torch.parallel.sweep import run_sweep

    # the sweep runs on a device backend: strict validation
    cfg = validate(load_config(args.config), backend="gpu")
    for key in ("retry_enabled", "cache_enabled", "fault_injection"):
        if getattr(cfg, key):
            raise SystemExit(f"{key}: true is not ported to bdlz_tpu_torch yet ({_D2})")
    # explicit scenario flags override the config's lz_* keys
    cfg = apply_scenario_flags(cfg, args)
    if cfg.lz_mode != "two_channel":
        if not (args.lz_profile or args.bounce):
            raise SystemExit(
                f"lz_mode={cfg.lz_mode!r} derives P per point from a bounce "
                "profile; pass --lz-profile or --bounce"
            )
        if args.lz_method != "local" or args.lz_gamma_phi:
            raise SystemExit(
                f"--lz-method/--lz-gamma-phi have no effect with "
                f"lz_mode={cfg.lz_mode!r} (the scenario owns the kernel)"
            )
    axes: Dict[str, np.ndarray] = dict(parse_axis(s) for s in args.axis)
    if not axes:
        raise SystemExit("at least one --axis is required")

    static = static_choices_from_config(cfg)
    if args.quad != "auto":
        static = static._replace(quad_panel_gl=args.quad == "on")
    res = run_sweep(
        cfg, axes, static, chunk_size=args.chunk,
        n_y=args.n_y, impl=args.impl, fuse_exp=args.fuse_exp,
        device=args.device, lz_profile=args.lz_profile, lz_method=args.lz_method,
        lz_gamma_phi=args.lz_gamma_phi, bounce=args.bounce,
    )

    ratios = res.outputs["DM_over_B"]
    finite = np.isfinite(ratios)
    if finite.any():
        best = int(np.argmin(np.abs(np.where(finite, ratios, np.inf) - PLANCK_DM_OVER_B)))
        shape = tuple(len(v) for v in axes.values())
        best_idx = np.unravel_index(best, shape)
        closest = {
            "index": best,
            "DM_over_B": float(ratios[best]),
            "target": PLANCK_DM_OVER_B,
            "params": {
                name: float(vals[i]) for (name, vals), i in zip(axes.items(), best_idx)
            },
        }
    else:
        closest = None  # every point failed; keep the summary strict JSON
    print(json.dumps({
        # omit-at-default, as in the JAX CLI
        **({"lz_mode": cfg.lz_mode} if cfg.lz_mode != "two_channel" else {}),
        "n_points": res.n_points,
        "n_failed": res.n_failed,
        # the port has no self-healing, resume or output directory yet:
        # the JAX CLI's keys are kept at their idle values
        "n_quarantined": 0,
        "n_retries": 0,
        "seconds": round(res.seconds, 3),
        "points_per_sec": round(res.points_per_sec, 1),
        "resumed_chunks": 0,
        "quad_impl": res.quad_impl,
        "n_quad_nodes": res.n_quad_nodes,
        "out_dir": None,
        "closest_to_planck": closest,
    }))


if __name__ == "__main__":
    main()
