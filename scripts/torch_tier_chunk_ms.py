#!/usr/bin/env python3
"""Device time and peak memory per chunk of each kernel tier of the
PyTorch/CUDA port's KJMA engine, on one CUDA card:

    python scripts/torch_tier_chunk_ms.py [--root DIR] [--label NAME]

For each tier (reduce, fused_reduce, stream, fused_stream) it times
``ops.kjma_kernel.integrate_YB_kernel`` on the first 8192-point chunk of
``chip_smoke.py``'s main grid (n_y 8000, a 16384-entry table) with CUDA
events (a warm-up, then 5 windows of 10 calls; the median per call), the
peak memory one call allocates above what was allocated before it, and
the main grid (32768 points, 4 chunks) through ``run_sweep`` 5 times
(median points/s).  ``--root`` names the directory that holds the
``bdlz_tpu_torch`` package to measure (default: this checkout), so that
two versions of the port can be measured in turns in one session on one
card: e.g. a parent commit unpacked with ``git archive`` and this one,
in the order parent, change, change, parent.  The kernels are built from
that directory's sources at first use.  Prints one JSON line, with the
card's name and power limit; exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

N_POINTS, N_Y, TABLE_N, CALLS, WINDOWS = 8192, 8000, 16384, 10, 5
ARCHIVED = {  # the archived equal-mass benchmark point (chip_smoke.py)
    "regime": "nonthermal", "m_chi_GeV": 0.95, "g_chi": 2, "chi_stats": "fermion",
    "sigma_v_chi_GeV_m2": 0.0, "T_p_GeV": 100.0, "beta_over_H": 100.0,
    "v_w": 0.30, "I_p": 0.34, "g_star": 106.75, "g_star_s": 106.75,
    "P_chi_to_B": 0.14925839040304145, "source_shape_sigma_y": 9.0,
    "Gamma_wash_over_H": 0.0, "incident_flux_scale": 1.07e-9,
    "deplete_DM_from_source": False, "T_max_over_Tp": 5.0,
    "T_min_over_Tp": 0.001, "Y_chi_init": 4.90e-10, "n_chi_at_Tp_GeV3": None,
}
TIERS = {"reduce": (False, True), "fused_reduce": (True, True),
         "stream": (False, False), "fused_stream": (True, False)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="directory holding the bdlz_tpu_torch package to measure")
    ap.add_argument("--label", default=None, help="a name for this run in the JSON line")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_tier_chunk_ms: no CUDA device is available", file=sys.stderr)
        return 2
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.interop import point_params_from_numpy
    from bdlz_tpu_torch.ops import kjma_kernel as kk
    from bdlz_tpu_torch.ops.kjma_table import make_f_table, table_to_device
    from bdlz_tpu_torch.parallel.sweep import build_grid, run_sweep

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    base = config_from_dict(ARCHIVED)
    static = static_choices_from_config(base)
    axes = {"m_chi_GeV": np.geomspace(0.1, 10.0, 64), "T_p_GeV": np.geomspace(30.0, 300.0, 32),
            "v_w": np.linspace(0.05, 0.95, 16)}
    grid = build_grid(base, axes)
    chunk = point_params_from_numpy(type(grid)(*(f[:N_POINTS] for f in grid)), dev)
    table = table_to_device(make_f_table(base.I_p, n=TABLE_N), dev)
    tiers = {}
    for name, (fuse_exp, reduce) in TIERS.items():
        def call():
            return kk.integrate_YB_kernel(chunk, base.chi_stats, table, N_Y,
                                          fuse_exp=fuse_exp, reduce=reduce)
        call()  # warm-up: builds and loads the kernels on first use
        torch.cuda.synchronize()
        start_mem = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - start_mem
        windows = []
        for _ in range(WINDOWS):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALLS):
                call()
            stop.record()
            torch.cuda.synchronize()
            windows.append(start.elapsed_time(stop) / CALLS)
        kw = dict(impl="kernel", fuse_exp=fuse_exp, reduce=reduce, chunk_size=N_POINTS,
                  n_y=N_Y, table_nodes=TABLE_N, device=dev)
        pps = [run_sweep(base, axes, static, **kw).points_per_sec for _ in range(WINDOWS)]
        tiers[name] = {"ms_per_chunk": float(np.median(windows)), "ms_samples": windows,
                       "peak_mem_above_start_bytes": peak,
                       "sweep_points_per_sec_median": float(np.median(pps)),
                       "sweep_points_per_sec_samples": pps}
    print(json.dumps({"label": args.label, "root": os.path.abspath(args.root),
                      "package": os.path.dirname(os.path.dirname(os.path.abspath(kk.__file__))),
                      "device": torch.cuda.get_device_name(0), "nvidia_smi": smi.strip(),
                      "points": N_POINTS, "n_y": N_Y, "table_n": TABLE_N, "tiers": tiers}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
