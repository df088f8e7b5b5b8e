"""One run of one cell: set-up, the measured window, the check, one result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the traced window's busy and
window seconds and a breakdown.  The compared numbers and their limits
are the last lines on standard error and the last key of the result.
Without a CUDA card, or with fewer than the cell asks for, the run fails
before it prints anything.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, List, NamedTuple, Optional

from benchmark.harness import guard, spec
from benchmark.harness import window as win


class Run(NamedTuple):
    """What a metric reader reads."""

    config: dict
    traffic: dict
    records: List[Any]       # the window's requests in order (window.Record)
    setup_s: float
    trace: Optional[Any]


def parse(argv=None):
    ap = argparse.ArgumentParser(description="the benchmark of bdlz_tpu_torch")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    """Set-up and the window; returns (run, memory peak bytes).  ``device``
    is the program's device: the card, or the CPU in the benchmark's tests."""
    import torch

    from benchmark.harness.program import Program

    # the deployment's host threads for the program's CPU tensor work
    # (the audit, the small host ops), as its configuration states them
    torch.set_num_threads(int(cell.config["host_threads"]))
    program = Program(cell.config, cell.traffic, device)
    win.warm(program, cell.traffic, cell.config, seed)
    setup_s = time.perf_counter() - t_start
    w = win.run(program, cell.traffic, cell.config, seed, seconds, trace)
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    return Run(cell.config, cell.traffic, w.records, setup_s, w.trace), peak


def result(cell: spec.Cell, run: Run, trace: bool, seed: int, device, peak: int,
           device_info: dict) -> dict:
    """The result line's object; frees the program's memory, then checks."""
    import gc

    import torch

    from benchmark.harness import correct, trace as trc

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = dict(device_info, memory_peak_bytes=int(peak))
    out = {"metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        lo, hi = run.trace.window
        dev["busy_s"] = trc.busy_ns(run.trace.device, lo, hi) * 1e-9
        dev["window_s"] = (hi - lo) * 1e-9
        out["breakdown"] = trc.breakdown(run.trace)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    done = [r for r in run.records if not r.cut]
    ok, numbers = correct.check(cell.config, cell.traffic, run.records, seed, device)
    failed = sum(1 for r in done if r.error is not None or r.n_failed)
    ok = ok and bool(done) and failed == 0
    for r in done:
        if r.error is not None:
            print(f"request {r.request.index} raised {r.error}", file=sys.stderr)
    return {"correct": ok, "attempted": len(done), "failed": failed, **out,
            "checks": {name: {"value": v, "limit": lim} for name, v, lim in numbers}}


def emit(res: dict) -> None:
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)


def card_info(chips: int) -> dict:
    """The card's identity, or exit before any result without enough cards."""
    import subprocess

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise SystemExit(f"this cell needs {chips} CUDA card(s); {n} visible")
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
        power = float(smi.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        power = None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "power_limit_w": power}


def main(argv=None, t_start: Optional[float] = None) -> None:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    info = card_info(int(cell.workload["chips"]))
    run, peak = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    res = result(cell, run, bool(args.trace), args.seed, "cuda", peak, info)
    found = guard.forbidden_loaded()
    if found:
        raise SystemExit(f"the run loaded {found}: the benchmark may not load JAX or the "
                         "JAX package")
    print(f"card power limit {info['power_limit_w']} W", file=sys.stderr)
    emit(res)
