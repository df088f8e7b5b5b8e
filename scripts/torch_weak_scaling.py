#!/usr/bin/env python3
"""Weak-scaling probe of the PyTorch/CUDA port's sweep path, the port's
counterpart of ``scripts/weak_scaling.py``.

    python scripts/torch_weak_scaling.py [--counts 1,2,4,8]
        [--points-per-member 2048] [--device cpu]

For each member count n of ``--counts`` one child process runs
``run_sweep`` with an ``out_dir`` (chunk files, manifest, resume
bookkeeping) on ``make_mesh(shape=(n, 1))`` with n × the per-member
points in chunks of n × ``CHUNK_PER_MEMBER`` at n_y ``N_Y``: a warm-up
sweep into a throwaway directory, then the timed one.  Member k sits on card
``k % count`` (on one card every member shares it, each on its own CUDA
stream; on the host they are CPU members).  Ideal weak scaling keeps the
total points/s constant as n grows on one card, since the members share
it: what falls is the host's cost per member (the per-member ship,
gather, chunk files).  One JSON line per count with the ratio to one
member (``n_devices`` counts the members, under JAX's key), each with
the card's name and power limit as ``nvidia-smi`` gives them (``cpu`` on
the host), then a markdown table.  ``--members n`` runs one count (the
child).  Runs on the card unless ``--device cpu``;
without a card it exits 2; a child that fails or a sweep with a failed
point exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BENCH_POINT = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
CHUNK_PER_MEMBER = 512
N_Y = 2000
CHILD_TIMEOUT_S = 1800


def run_one(n: int, dev, points_per_member: int) -> int:
    import numpy as np
    import torch

    from bdlz_tpu_torch.backend import device_label
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.parallel import make_mesh, run_sweep

    base = config_from_dict(BENCH_POINT)
    n_total = points_per_member * n
    side = int(round(n_total ** 0.5))
    axes = {"m_chi_GeV": np.geomspace(0.2, 5.0, side),
            "v_w": np.linspace(0.05, 0.9, n_total // side)}
    static = static_choices_from_config(base)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        members = [torch.device("cuda", k % count) for k in range(n)]
    else:
        members = ["cpu"] * n
    mesh = make_mesh(shape=(n, 1), devices=members)
    kw = dict(mesh=mesh, chunk_size=CHUNK_PER_MEMBER * n, n_y=N_Y)
    with tempfile.TemporaryDirectory() as out:
        run_sweep(base, axes, static, out_dir=os.path.join(out, "warm"), **kw)
        t0 = time.perf_counter()
        res = run_sweep(base, axes, static, out_dir=os.path.join(out, "timed"), **kw)
        dt = time.perf_counter() - t0
    print(json.dumps({
        "n_devices": n, "members": [str(m) for m in mesh.local_devices],
        "n_points": int(res.n_points), "chunk": CHUNK_PER_MEMBER * n, "n_y": N_Y,
        "seconds": dt, "points_per_sec_total": res.n_points / dt,
        "n_failed": int(res.n_failed), "device": device_label(dev),
    }), flush=True)
    return 0 if res.n_failed == 0 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--counts", default="1,2,4,8", help="comma list of member counts")
    ap.add_argument("--points-per-member", type=int, default=2048, dest="points_per_member")
    ap.add_argument("--members", type=int, default=0,
                    help="child mode: run one member count and print its JSON line")
    ap.add_argument("--device", default=None, help="cuda (default: the cards) or cpu")
    args = ap.parse_args(argv)

    from bdlz_tpu_torch.backend import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"torch_weak_scaling: {exc} (--device cpu)", file=sys.stderr)
        return 2
    if args.members:
        return run_one(args.members, dev, args.points_per_member)

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    rows = []
    for n in (int(c) for c in args.counts.split(",")):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--members", str(n),
             "--device", dev.type, "--points-per-member", str(args.points_per_member)],
            capture_output=True, text=True, env=env, timeout=CHILD_TIMEOUT_S,
        )
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            print(f"torch_weak_scaling: the child of {n} members exited {proc.returncode}: "
                  f"{proc.stdout.strip()}", file=sys.stderr)
            return 1
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        row["vs_one_member"] = row["points_per_sec_total"] / (
            rows[0]["points_per_sec_total"] if rows else row["points_per_sec_total"])
        rows.append(row)
        print(json.dumps(row), flush=True)

    print(f"\n{rows[0]['device']}\n")
    print("| members | points | seconds | total pts/s | vs 1 member |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['n_devices']} | {r['n_points']} | {r['seconds']:.3f} "
              f"| {r['points_per_sec_total']:.1f} | {r['vs_one_member']:.3f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
