"""The readings that the limits of ``correct`` are set from, in one process.

For each seed, one run of the cell as ``benchmark/run.py`` makes it (set-up,
the window at the cell's own size, the check); the program's readings are
its compared numbers.  On the first ``--controls`` seeds each control
takes the program's place at the same sampled points and goes through the
same check: the reference computed in float32 (the precision below the
configuration's float64), whole, and with its F table's z-integral kept
in float64; where the configuration shoots a bounce, the float32 yields
with the shoot in float64 as well.  A control that raises gives no number
and is reported as such.  The benchmark's own runs do not run the controls.

    python3 -m benchmark.harness.calibrate --workload <cell> --seeds 1,2,3 \
        --seconds 10 --controls 3
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def controls(config):
    """(name, reference precision) of each control for ``config``."""
    import torch

    out = [("float32", {"dtype": torch.float32, "shoot_dtype": np.float32}),
           ("float32_table64", {"dtype": torch.float32, "table_dtype": torch.float64,
                                "shoot_dtype": np.float64})]
    if config["reference"] != "bounce_lz":
        out = [(n, {k: v for k, v in p.items() if k != "shoot_dtype"}) for n, p in out]
    return out


def control_reading(cell, records, seed: int, device, precision):
    """``{"correct": ..., <number>: value, ...}`` of the check with the
    reference in ``precision`` in the program's place at the samples of the
    sweeps the check draws, or the error the control raised."""
    from benchmark.harness import correct

    sweeps = correct.checked(records, cell.traffic, seed)
    if not sweeps:
        return "no sweep completed"
    cache: dict = {}
    try:
        stand_in = [r._replace(outputs=correct.reference_outputs(
            cell.config, r, r.quad_impl, device, cache, **precision), n_failed=0) for r in sweeps]
    except (RuntimeError, ValueError, FloatingPointError) as exc:
        return f"raised {type(exc).__name__}: {exc}"
    ok, numbers = correct.check(cell.config, cell.traffic, stand_in, seed, device)
    return {"correct": ok, **{name: v for name, v, _ in numbers}}


def calibrate(cell, seeds, seconds: float, n_controls: int, device):
    """One JSON-able line per seed: the run's correctness, rate and
    compared numbers, and on the first ``n_controls`` seeds the controls'."""
    from benchmark.harness import main

    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        run, peak = main.measure(cell, seed, seconds, False, device, t0)
        res = main.result(cell, run, False, seed, device, peak, {})
        line = {"cell": cell.name, "seed": seed, "correct": res["correct"],
                "sweeps": res["attempted"],
                "quad": sorted({str(r.quad_impl) for r in run.records}),
                "points_per_s": res["metrics"].get("points_per_s", {}).get("value"),
                **{name: c["value"] for name, c in res["checks"].items()}}
        if i < n_controls:
            for name, precision in controls(cell.config):
                line[f"control.{name}"] = control_reading(cell, run.records, seed, device,
                                                          precision)
        line["seconds"] = time.perf_counter() - t0
        yield line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", type=int, default=3)
    args = ap.parse_args(argv)

    from benchmark.harness import spec

    seeds = [int(s) for s in args.seeds.split(",")]
    for line in calibrate(spec.load_cell(args.workload), seeds, args.seconds, args.controls,
                          "cuda"):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
