#!/usr/bin/env python3
"""Timed engine comparison of the PyTorch/CUDA port: the tabulated
engine against each tier of the kernel engine, the port's counterpart
of ``scripts/impl_shootout.py``.

    python scripts/torch_impl_shootout.py [--points 65536] [--chunk 8192]
        [--n-y 8000] [--gate-points 64] [--device cpu]

Engines (``ENGINES``): ``tabulated`` and ``kernel`` with the modifiers
``+fuse`` (the fused tier's exponent) and ``+stream`` (the (P, n_y)
integrand written and summed per row on the host instead of reduced in
the kernel): ``kernel`` runs P1, ``kernel+stream`` P2, ``kernel+fuse``
P3 and ``kernel+fuse+stream`` P4 (``csrc/kjma_point.cu``).  Each engine runs
the same grid (``parallel/sweep.build_grid``: ``--points`` ** (1/4) per
axis over m_chi, T_p, P and v_w) in the same chunks through
``parallel/sweep.make_chunk_runner``: an 8-point sample against the
per-point CPU reference, two warm-up chunks (on the card the kernel
engine captures its chunk graph on the second), then the whole grid timed on
the host clock (every chunk ends in a copy to the host, which waits for
the device), counting the padded work.  The gate scores each engine over
``--gate-points`` audit points (seed 1) against the reference through
``validation.engine_population_max_rel``.  One JSON line per engine,
each naming the card (its name and power limit as ``nvidia-smi`` gives
them, ``cpu`` on the host) and, for the kernel engines, the entry point,
the kernel and ``kernel_digest()``; then a markdown table.

Runs on the card unless ``--device cpu``; without a card it exits 2.
Unlike the JAX tool, which records a failed engine and exits 0, this one
prints the failed row and exits 1 when any engine or gate failed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BENCH_POINT = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
#: engine -> (impl, fuse_exp, reduce, point kernel)
ENGINES = {
    "tabulated": ("tabulated", False, True, None),
    "kernel": ("kernel", False, True, "point_reduce"),
    "kernel+stream": ("kernel", False, False, "point_stream"),
    "kernel+fuse": ("kernel", True, True, "point_fused_reduce"),
    "kernel+fuse+stream": ("kernel", True, False, "point_fused_stream"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=65536)
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--n-y", type=int, default=8000, dest="n_y")
    ap.add_argument("--gate-points", type=int, default=64, dest="gate_points",
                    help="audit points per engine for the gate column; 0 drops it")
    ap.add_argument("--device", default=None, help="cuda (default: the first card) or cpu")
    args = ap.parse_args(argv)

    from bdlz_tpu_torch.backend import device_label, resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"torch_impl_shootout: {exc} (--device cpu)", file=sys.stderr)
        return 2

    import numpy as np
    import torch

    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.ops import kjma_kernel as kk
    from bdlz_tpu_torch.ops.kjma_table import make_f_table
    from bdlz_tpu_torch.parallel.sweep import build_grid, make_chunk_runner
    from bdlz_tpu_torch.validation import (
        build_audit_population,
        engine_population_max_rel,
        reference_ratios,
        reference_ratios_cached,
    )

    label = device_label(dev)
    base = config_from_dict(BENCH_POINT)
    static = static_choices_from_config(base)
    side = max(2, int(round(args.points ** 0.25)))
    axes = {
        "m_chi_GeV": np.geomspace(0.1, 10.0, side),
        "T_p_GeV": np.geomspace(30.0, 300.0, side),
        "P_chi_to_B": np.linspace(0.02, 0.9, side),
        "v_w": np.linspace(0.05, 0.9, side),
    }
    pp_all = build_grid(base, axes)
    n_total = int(pp_all.m_chi_GeV.shape[0])
    chunk = int(args.chunk)
    table = make_f_table(base.I_p)

    # the accuracy sample, shared by the engines
    rng = np.random.default_rng(0)
    sample = np.unique(rng.choice(min(chunk, n_total), size=8, replace=False))
    ref = dict(zip(sample.tolist(), reference_ratios(
        type(pp_all)(*(f[sample] for f in pp_all)), static)))

    n_gate = max(0, int(args.gate_points))
    if n_gate:
        gate_pop = build_audit_population(base, n_gate, seed=1)
        gate_ref = reference_ratios_cached(gate_pop.grid, static, n_y=args.n_y)

    rows = []
    for engine, (impl, fuse, reduce, kernel) in ENGINES.items():
        row = {"engine": engine, "platform": dev.type, "device": label}
        try:
            run_chunk, eff_chunk = make_chunk_runner(
                pp_all, chunk, static, table, impl=impl, n_y=args.n_y, fuse_exp=fuse,
                reduce=reduce, device=dev)
            first = run_chunk(0, min(eff_chunk, n_total))  # warm-up
            run_chunk(0, min(eff_chunk, n_total))  # the kernel engine's graph capture
            errs = [abs(float(first[i]) / r - 1.0) for i, r in ref.items() if i < eff_chunk]
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            done = n_evaluated = 0
            while done < n_total:
                hi = min(done + eff_chunk, n_total)
                run_chunk(done, hi)  # a host array: the device has finished
                done = hi
                n_evaluated += eff_chunk  # the last chunk is padded and run in full
            dt = time.perf_counter() - t0
            row.update({
                "points_per_sec_per_chip": n_evaluated / dt,
                "seconds": dt,
                "n_points": n_total,
                "n_evaluated": n_evaluated,
                "chunk": eff_chunk,
                "n_y": args.n_y,
                "max_rel_err_vs_reference": max(errs) if errs else None,
            })
            if kernel is not None:
                row.update({"entry": "bdlz_tpu_torch.ops.kjma_kernel.point_yields_kernel",
                            "kernel": kernel,
                            "impl": "cuda" if dev.type == "cuda" else "plain",
                            "kernel_digest": kk.kernel_digest()})
            if n_gate:
                row["gate_points"] = n_gate
                try:
                    row["gate_max_rel_err"] = engine_population_max_rel(
                        gate_pop.grid, gate_ref, static, table, impl=impl, n_y=args.n_y,
                        fuse_exp=fuse, reduce=reduce, device=dev)
                except Exception as gexc:  # noqa: BLE001 — recorded; the run exits 1
                    traceback.print_exc()
                    row["gate_error"] = f"{type(gexc).__name__}: {gexc}"
        except Exception as exc:  # noqa: BLE001 — recorded; the run exits 1
            traceback.print_exc()
            row["error"] = f"{type(exc).__name__}: {exc}"
        rows.append(row)
        print(json.dumps(row), flush=True)

    print(f"\n{label}\n")
    print("| engine | pts/s/chip | rel err | gate rel err | seconds |")
    print("|---|---|---|---|---|")
    for r in rows:
        if "error" in r:
            print(f"| {r['engine']} | FAILED: {r['error'][:60]} | — | — | — |")
            continue
        err = r["max_rel_err_vs_reference"]
        gate = (f"FAILED: {r['gate_error'][:40]}" if "gate_error" in r
                else format(r["gate_max_rel_err"], ".2e") if "gate_max_rel_err" in r
                else "n/a")
        print(f"| {r['engine']} | {r['points_per_sec_per_chip']:.1f} "
              f"| {'n/a' if err is None else format(err, '.2e')} "
              f"| {gate} | {r['seconds']:.3f} |")
    return 1 if any("error" in r or "gate_error" in r for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
