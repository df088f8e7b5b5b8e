"""Sweep command line on one CUDA device:

    python -m bdlz_tpu_torch.sweep_cli \\
        --config yields_config_equal_mass.json \\
        --axis "m_chi_GeV=geom:0.1:10:64" --axis "v_w=lin:0.05:0.95:16"

Axis syntax: ``name=geom:start:stop:n`` (geomspace), ``lin:start:stop:n``
(linspace), or an explicit comma list ``name=0.1,0.5,1.0``.  A JSON
summary with the JAX sweep CLI's keys goes to stdout.  ``--device cpu``
runs the plain PyTorch path on the host; the default is the card.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np


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
    ap.add_argument("--impl", default="kernel", choices=("kernel", "tabulated"),
                    help="Per-point engine: kernel (hand-written CUDA "
                         "interpolate-and-reduce kernels) or tabulated (the "
                         "same quadrature in plain PyTorch)")
    ap.add_argument("--fuse-exp", action="store_true", dest="fuse_exp",
                    help="With --impl kernel: evaluate the merged exponential "
                         "inside the kernel (native f64 exp)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    if args.fuse_exp and args.impl != "kernel":
        ap.error("--fuse-exp requires --impl kernel")

    from bdlz_tpu_torch.config import load_config, static_choices_from_config, validate
    from bdlz_tpu_torch.constants import PLANCK_DM_OVER_B
    from bdlz_tpu_torch.parallel.sweep import run_sweep

    # the sweep runs on a device backend: strict validation
    cfg = validate(load_config(args.config), backend="gpu")
    axes: Dict[str, np.ndarray] = dict(parse_axis(s) for s in args.axis)
    if not axes:
        raise SystemExit("at least one --axis is required")

    res = run_sweep(
        cfg, axes, static_choices_from_config(cfg), chunk_size=args.chunk,
        n_y=args.n_y, impl=args.impl, fuse_exp=args.fuse_exp,
        device=args.device,
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
