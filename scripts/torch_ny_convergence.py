#!/usr/bin/env python3
"""y-grid convergence study of the PyTorch/CUDA port: the truncation
error behind the n_y defaults, the port's counterpart of
``scripts/ny_convergence.py``.

    python scripts/torch_ny_convergence.py [--levels 2000,4000,...,128000]
        [--sp 2] [--device cpu]

Y_B of the benchmark point through the tabulated engine
(``models/yields_pipeline.point_yields_fast``) at each n_y of
``--levels``, each level's relative distance to the finest, and the
finest level once more through the sp-sharded quadrature
(``parallel/gridshard.make_sp_quadrature``) on a ``(1, sp)`` mesh whose
members sit on card ``k % count`` (on one card they repeat it; on the
host they are CPU members).  Prints one JSON line per row, each with the
card's name and power limit as ``nvidia-smi`` gives them (``cpu`` on the
host), then a markdown table.  Runs on the card unless ``--device cpu``;
without a card it exits 2.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BENCH_POINT = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--levels", default="2000,4000,8000,16000,32000,64000,128000",
                    help="comma list of n_y trapezoid-node counts; the finest is "
                         "the self-convergence reference")
    ap.add_argument("--sp", type=int, default=2,
                    help="sp members of the finest level's sharded row; 1 drops it")
    ap.add_argument("--device", default=None, help="cuda (default: the first card) or cpu")
    args = ap.parse_args(argv)

    from bdlz_tpu_torch.backend import device_label, resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"torch_ny_convergence: {exc} (--device cpu)", file=sys.stderr)
        return 2

    import torch

    from bdlz_tpu_torch.config import (
        config_from_dict,
        point_params_from_config,
        static_choices_from_config,
    )
    from bdlz_tpu_torch.interop import point_params_from_numpy
    from bdlz_tpu_torch.models.yields_pipeline import point_yields_fast
    from bdlz_tpu_torch.ops.kjma_table import make_f_table, table_to_device

    label = device_label(dev)
    levels = sorted(int(x) for x in args.levels.split(","))
    base = config_from_dict(BENCH_POINT)
    static = static_choices_from_config(base)
    table_np = make_f_table(base.I_p)
    table = table_to_device(table_np, dev)
    pp = point_params_from_config(base, base.P_chi_to_B)
    pp_dev = point_params_from_numpy(pp, dev)

    Y = {n_y: float(point_yields_fast(pp_dev, static, table, n_y=n_y).Y_B[0]) for n_y in levels}
    finest = levels[-1]
    rows = []
    for n_y in levels:
        rows.append({"n_y": n_y, "Y_B": Y[n_y],
                     "rel_vs_finest": abs(Y[n_y] / Y[finest] - 1.0) if n_y != finest else 0.0,
                     "device": label})
        print(json.dumps(rows[-1]), flush=True)

    # the finest level's integral once more, its y-grid split over sp
    # members with one sum across them
    if args.sp > 1:
        from bdlz_tpu_torch.parallel.gridshard import make_sp_quadrature
        from bdlz_tpu_torch.parallel.mesh import make_mesh

        if dev.type == "cuda":
            count = torch.cuda.device_count()
            members = [torch.device("cuda", k % count) for k in range(args.sp)]
        else:
            members = ["cpu"] * args.sp
        mesh = make_mesh(shape=(1, args.sp), devices=members)
        Y_sp = float(make_sp_quadrature(static, mesh, n_y=finest)(pp, table_np))
        rows.append({"n_y": finest, "engine": f"gridshard(sp={args.sp})", "Y_B": Y_sp,
                     "rel_vs_single_device": abs(Y_sp / Y[finest] - 1.0), "device": label})
        print(json.dumps(rows[-1]), flush=True)

    print(f"\n{label}\n")
    print("| n_y | Y_B | rel vs finest |")
    print("|---|---|---|")
    for r in rows:
        tag = f"{r['n_y']}" + (f" ({r['engine']})" if "engine" in r else "")
        rel = r.get("rel_vs_finest", r.get("rel_vs_single_device"))
        print(f"| {tag} | {r['Y_B']:.12e} | {rel:.2e} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
