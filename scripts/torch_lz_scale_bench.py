#!/usr/bin/env python3
"""Design-scale LZ ingestion and transport run of the PyTorch/CUDA port,
the port's counterpart of ``scripts/lz_scale_bench.py``.

    python scripts/torch_lz_scale_bench.py [--rows 1000001] [--speeds 64]
        [--table-n 256] [--numpy-compare] [--device cpu]

Phases, one JSON line each:

1. ``parse``: write a ``--rows``-row wall-profile CSV (ξ, δ, m_mix) to a
   temporary file and load it (``lz/profile.load_profile_csv``: the
   g++-built native parser when it builds, NumPy otherwise);
   ``--numpy-compare`` also times the NumPy parser on the same file.
2. ``coherent``: the coherent transfer-matrix P over all segments for
   ``--speeds`` wall speeds (``lz/sweep_bridge.probabilities_for_points``);
   the row lists each P.
3. ``ptable``: the coherent P(v_w) table at ``--table-n`` nodes
   (``lz/sweep_bridge.make_P_of_vw_table``).

Each row gives the process's peak RSS, the device's peak allocation in
the phase (``torch.cuda.max_memory_allocated``; null on the host) and the
card's name and power limit as ``nvidia-smi`` gives them (``cpu`` on the
host).  Runs on the card unless ``--device cpu`` (the JAX tool forces the
CPU unless told ``--tpu``); without a card it exits 2.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rss_mb() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_001)
    ap.add_argument("--speeds", type=int, default=64)
    ap.add_argument("--table-n", type=int, default=256, dest="table_n")
    ap.add_argument("--numpy-compare", action="store_true",
                    help="also time the NumPy CSV parser (slow)")
    ap.add_argument("--device", default=None, help="cuda (default: the first card) or cpu")
    args = ap.parse_args(argv)

    from bdlz_tpu_torch.backend import device_label, resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"torch_lz_scale_bench: {exc} (--device cpu)", file=sys.stderr)
        return 2

    import numpy as np
    import torch

    from bdlz_tpu_torch.lz import profile as profile_mod
    from bdlz_tpu_torch.lz.sweep_bridge import make_P_of_vw_table, probabilities_for_points
    from bdlz_tpu_torch.native import native_available

    label = device_label(dev)
    cuda = dev.type == "cuda"

    def start() -> float:
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        return time.perf_counter()

    def memory() -> dict:
        return {"rss_mb": rss_mb(),
                "device_peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
                "device": label}

    n = int(args.rows)
    xi = np.linspace(-300.0, 300.0, n)
    delta = -0.08 * np.tanh(xi / 4.0)
    mix = np.full(n, 0.02)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "profile.csv")
        with open(path, "w") as f:
            f.write("xi,delta,m_mix\n")
            np.savetxt(f, np.column_stack([xi, delta, mix]), delimiter=",")

        t0 = start()
        prof = profile_mod.load_profile_csv(path)
        row = {"phase": "parse", "rows": n, "parser": "native" if native_available() else "numpy",
               "native_seconds": time.perf_counter() - t0}
        if args.numpy_compare:
            real_read = profile_mod._read_csv
            profile_mod._read_csv = profile_mod.read_csv_numpy
            try:
                t0 = time.perf_counter()
                prof_np = profile_mod.load_profile_csv(path)
                t_numpy = time.perf_counter() - t0
            finally:
                profile_mod._read_csv = real_read
            np.testing.assert_allclose(prof_np.xi, prof.xi, rtol=1e-15)
            row["numpy_seconds"] = t_numpy
            row["native_speedup"] = t_numpy / row["native_seconds"]
    print(json.dumps({**row, **memory()}), flush=True)

    v = np.linspace(0.05, 0.9, int(args.speeds))
    t0 = start()
    P = probabilities_for_points(prof, v, method="coherent", device=dev)
    t_coh = time.perf_counter() - t0
    print(json.dumps({
        "phase": "coherent", "segments": n - 1, "speeds": len(v),
        "seconds": t_coh, "speeds_per_sec": len(v) / t_coh,
        "finite": bool(np.isfinite(P).all()),
        "P_range": [float(P.min()), float(P.max())], "P": P.tolist(), **memory(),
    }), flush=True)

    t0 = start()
    table = make_P_of_vw_table(prof, "coherent", 0.05, 0.9, n=args.table_n, device=dev)
    vals = table.values.cpu().numpy()
    t_tab = time.perf_counter() - t0
    print(json.dumps({
        "phase": "ptable", "segments": n - 1, "nodes": int(args.table_n),
        "seconds": t_tab, "finite": bool(np.isfinite(vals).all()),
        "P_range": [float(vals.min()), float(vals.max())], **memory(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
