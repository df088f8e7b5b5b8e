#!/usr/bin/env python3
"""Grid-wide 1e-6 accuracy proof of the PyTorch/CUDA port, with a
per-stage attribution of its worst point: the port's counterpart of
``scripts/accuracy_audit.py``.

    python scripts/torch_accuracy_audit.py [--points 1024] [--n-y 8000]
        [--seed 0] [--out ACCURACY_AUDIT_TORCH.json] [--device cpu]

1. **Proof.**  ``--points`` configs of the adversarial audit population
   (``validation.build_audit_population``: broad draws, deep
   Maxwell–Boltzmann, windows against the y-support clips, the T = m/3
   seam inside the window) go through the tabulated engine
   (``models/yields_pipeline.point_yields_fast``, one batched call) and
   through the kernel engine at its default tier, P1
   (``ops/kjma_kernel.point_yields_kernel``, the ``kernel`` section), on
   the device, against the per-point CPU f64 reference
   (``validation.reference_ratios_cached``) at the same n_y.  On the host
   the ``kernel`` section runs the kernel's plain version and says so
   (``"impl": "plain"``).
2. **Attribution.**  For the tabulated engine's worst point each stage is
   computed on the device and on the CPU in f64 and compared: the F-table
   values (host-built, so 0), their interpolation
   (``ops/kjma_table.eval_f_table``) and the stages of
   ``solvers/quadrature.integrand_stream_probe``.

Writes the artifact (JAX's keys, plus ``device``, the card's name and
power limit as ``nvidia-smi`` gives them, and the ``kernel`` section) and
prints it without its worst points as one JSON line.  Runs on the card
unless ``--device cpu``; without a card it exits 2.  Exits 1 when a
section misses the 1e-6 contract.  The default ``--out`` is
``ACCURACY_AUDIT_TORCH.json``; JAX's ``ACCURACY_AUDIT.json`` is refused.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BENCH_POINT = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
CONTRACT_RTOL = 1e-6


def rel_to_scale(a, b) -> float:
    """max |a − b| relative to b, guarding exact-zero tails (F(y)
    underflows to 0 identically on both sides near y = +50)."""
    import numpy as np

    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    denom = np.maximum(np.abs(b), np.max(np.abs(b)) * 1e-12 + 1e-300)
    return float(np.max(np.abs(a - b) / denom))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--out", default="ACCURACY_AUDIT_TORCH.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-y", type=int, default=8000, dest="n_y")
    ap.add_argument("--device", default=None, help="cuda (default: the first card) or cpu")
    args = ap.parse_args(argv)
    if os.path.basename(args.out) == "ACCURACY_AUDIT.json":
        ap.error("ACCURACY_AUDIT.json is the JAX package's artifact; write the port's elsewhere")

    from bdlz_tpu_torch.backend import device_label, resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"torch_accuracy_audit: {exc} (--device cpu)", file=sys.stderr)
        return 2

    import numpy as np
    import torch

    from bdlz_tpu_torch.backend import F64
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.interop import point_params_from_numpy
    from bdlz_tpu_torch.models.yields_pipeline import point_yields_fast
    from bdlz_tpu_torch.ops import kjma_kernel as kk
    from bdlz_tpu_torch.ops.kjma_table import eval_f_table, make_f_table, table_to_device
    from bdlz_tpu_torch.solvers.quadrature import integrand_stream_probe
    from bdlz_tpu_torch.validation import build_audit_population, reference_ratios_cached

    base = config_from_dict(BENCH_POINT)
    static = static_choices_from_config(base)
    pop = build_audit_population(base, int(args.points), seed=args.seed)
    grid = pop.grid
    m, T_p = pop.axes["m_chi_GeV"], pop.axes["T_p_GeV"]
    sigma_y, beta = pop.axes["source_shape_sigma_y"], pop.axes["beta_over_H"]
    T_min, T_max = pop.axes["T_min_over_Tp"], pop.axes["T_max_over_Tp"]

    # the reference at the engines' n_y: backend error at equal
    # discretization, not y-grid truncation
    t0 = time.time()
    ref_stats: dict = {}
    ref = reference_ratios_cached(grid, static, n_y=args.n_y, stats=ref_stats)
    t_ref = time.time() - t0

    table_np = make_f_table(base.I_p)
    table = table_to_device(table_np, dev)
    pp = point_params_from_numpy(grid, dev)
    got = point_yields_fast(pp, static, table, n_y=args.n_y).DM_over_B.cpu().numpy()
    rel = np.abs(got / ref - 1.0)
    order = np.argsort(rel)[::-1]

    report = {
        "platform": dev.type,
        "device": device_label(dev),
        "n_points": int(args.points),
        "n_y": args.n_y,
        "engine": "tabulated",
        "max_rel_err": float(rel.max()),
        "p99_rel_err": float(np.percentile(rel, 99)),
        "p90_rel_err": float(np.percentile(rel, 90)),
        "median_rel_err": float(np.percentile(rel, 50)),
        "contract_1e-6_ok": bool(rel.max() <= CONTRACT_RTOL),
        "population": dict(pop.counts),
        "worst_points": [
            {
                "rel_err": float(rel[i]),
                "m_chi_GeV": float(m[i]),
                "T_p_GeV": float(T_p[i]),
                "sigma_y": float(sigma_y[i]),
                "beta_over_H": float(beta[i]),
                "window": [float(T_min[i]), float(T_max[i])],
            }
            for i in order[:5]
        ],
        "reference_seconds": t_ref,
        # a warm cache makes reference_seconds a disk read
        "reference_cached": bool(ref_stats.get("cache_hit")),
    }

    # the kernel engine at its default tier (JAX's pallas section)
    before = kk.LAUNCHES["point_reduce"]
    got_k = kk.point_yields_kernel(pp, static, table, args.n_y).DM_over_B.cpu().numpy()
    rel_k = np.abs(got_k / ref - 1.0)
    report["kernel"] = {
        "entry": "bdlz_tpu_torch.ops.kjma_kernel.point_yields_kernel",
        "kernel": "point_reduce",
        "impl": "cuda" if dev.type == "cuda" else "plain",
        "launches": kk.LAUNCHES["point_reduce"] - before,
        "kernel_digest": kk.kernel_digest(),
        "max_rel_err": float(rel_k.max()),
        "p99_rel_err": float(np.percentile(rel_k, 99)),
        "median_rel_err": float(np.percentile(rel_k, 50)),
        "contract_1e-6_ok": bool(rel_k.max() <= CONTRACT_RTOL),
    }

    # attribution: each stage on the device against the CPU in f64
    cpu = torch.device("cpu")
    table_cpu = table_to_device(table_np, cpu)
    stage = {"f_table_values": rel_to_scale(table.values.cpu().numpy(), table_np.values)}
    ys = np.linspace(-49.0, 49.0, 4001)
    stage["f_table_interp"] = rel_to_scale(
        eval_f_table(torch.as_tensor(ys, dtype=F64, device=dev), table).cpu().numpy(),
        eval_f_table(torch.as_tensor(ys, dtype=F64), table_cpu).numpy())
    iw = int(order[0])
    pp_w = type(grid)(*(float(np.asarray(f)[iw]) for f in grid))
    probe = integrand_stream_probe(pp_w, static, table, n_y=args.n_y, device=dev)
    probe_cpu = integrand_stream_probe(pp_w, static, table_cpu, n_y=args.n_y, device=cpu)
    for k in probe:
        stage[k] = rel_to_scale(probe[k].cpu().numpy(), probe_cpu[k].numpy())
    report["stage_attribution_worst_point"] = stage

    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if k != "worst_points"}), flush=True)
    print(f"[audit] artifact written to {args.out}", file=sys.stderr)
    return 0 if report["contract_1e-6_ok"] and report["kernel"]["contract_1e-6_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
