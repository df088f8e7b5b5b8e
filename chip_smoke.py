#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``bdlz_tpu_torch/csrc`` with
``nvcc`` (sm_90a), holds each kernel against its plain PyTorch version at
the production shapes, drives the port's sweep — the system's main path —
at full width through each kernel tier, checks the results against the
plain tabulated engine and the archived point, and times the kernels.

Every phase prints one JSON line; the card's name and power limit as
``nvidia-smi`` reports them and a ``kernels`` line come before the last
line, which is ``{"ok": true, "device": {...}}``.  Any failed check ends
the script with a non-zero exit and no ``ok`` line; so does a machine
without a CUDA device, or a directory without the port.  Imports nothing
of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Production shapes: the sweep CLI's defaults.
N_POINTS, N_Y, TABLE_N = 8192, 8000, 16384
ARCHIVED = {  # the archived equal-mass benchmark point
    "regime": "nonthermal", "m_chi_GeV": 0.95, "g_chi": 2, "chi_stats": "fermion",
    "sigma_v_chi_GeV_m2": 0.0, "T_p_GeV": 100.0, "beta_over_H": 100.0,
    "v_w": 0.30, "I_p": 0.34, "g_star": 106.75, "g_star_s": 106.75,
    "P_chi_to_B": 0.14925839040304145, "source_shape_sigma_y": 9.0,
    "Gamma_wash_over_H": 0.0, "incident_flux_scale": 1.07e-9,
    "deplete_DM_from_source": False, "T_max_over_Tp": 5.0,
    "T_min_over_Tp": 0.001, "Y_chi_init": 4.90e-10, "n_chi_at_Tp_GeV3": None,
}
ARCHIVED_RATIO = 5.688926334903014
MAIN_AXES = {  # 64 x 32 x 16 = 32768 points, 4 chunks of 8192
    "m_chi_GeV": np.geomspace(0.1, 10.0, 64),
    "T_p_GeV": np.geomspace(30.0, 300.0, 32),
    "v_w": np.linspace(0.05, 0.95, 16),
}
# (fuse_exp, reduce) of each kernel tier of the sweep
TIERS = {"reduce": (False, True), "fused_reduce": (True, True),
         "stream": (False, False), "fused_stream": (True, False)}
REDUCE_RTOL, STREAM_RTOL, SWEEP_RTOL, ARCHIVED_RTOL = 1e-12, 1e-13, 1e-10, 1e-9

# H100 SXM peaks from NVIDIA's data sheet: HBM3 at 3.35 TB/s, and
# 34 TFLOP/s FP64 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 34e12
# f64 operations per node, counted from csrc/kjma_interp.cu: 3 offsets,
# 4 weights of 3 ops, a 4-tap combine of 7, one product with g (+1 with
# e^a), +1 accumulate in the reduce kernels; an f64 exp counted as 20.
EXP_FLOPS = 20
FLOPS_PER_NODE = {"reduce": 24, "stream": 23,
                  "fused_reduce": 25 + EXP_FLOPS, "fused_stream": 24 + EXP_FLOPS}
# bytes per node: g 8 + i1 4 + sfrac 8 (+ a 8), + 8 written by the stream kernels
BYTES_PER_NODE = {"reduce": 20, "stream": 28, "fused_reduce": 28, "fused_stream": 36}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
           "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda}
    emit({"phase": "device", **dev})
    return dev


def phase_build() -> None:
    from bdlz_tpu_torch.ops import _build, kjma_kernel

    built = _build.build(kjma_kernel.SOURCE)
    kernels, name = [], None
    for line in built.ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            tmpl = re.search(r"kjma_interp_kernelILb([01])ELb([01])E", m.group(1))
            name = {("0", "1"): "reduce", ("0", "0"): "stream", ("1", "1"): "fused_reduce",
                    ("1", "0"): "fused_stream"}[tmpl.groups()] if tmpl else m.group(1)
            kernels.append({"kernel": name})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and kernels:
            kernels[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernels:
            kernels[-1]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            kernels[-1]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    kjma_kernel.load_library()
    check(len(kernels) == 4, f"ptxas reported 4 kernels, got {kernels}")
    emit({"phase": "build", "source": "bdlz_tpu_torch/csrc/" + kjma_kernel.SOURCE,
          "seconds": built.seconds, "cached": built.cached,
          "dynamic_smem_bytes": TABLE_N * 8 + 32 * 8, "kernels": kernels})


def _args(name, streams, values):
    st = streams["fused" in name]
    if "fused" in name:
        return (st.g, st.a, st.i1, st.sfrac, values)
    return (st.g, st.i1, st.sfrac, values)


def phase_parity(dev) -> tuple:
    """Each kernel against its plain version at P=8192, n_y=8000, n=16384."""
    from bdlz_tpu_torch.config import config_from_dict
    from bdlz_tpu_torch.interop import point_params_from_numpy
    from bdlz_tpu_torch.ops import kjma_kernel as kk
    from bdlz_tpu_torch.ops.kjma_table import make_f_table, table_to_device
    from bdlz_tpu_torch.parallel.sweep import build_grid
    from bdlz_tpu_torch.physics.percolation import T_of_y
    from bdlz_tpu_torch.solvers.quadrature import quadrature_bounds

    base = config_from_dict(ARCHIVED)
    rng = np.random.default_rng(2026)
    # masses up to 1000 GeV put part of most windows below T = m/3
    grid = build_grid(base, {
        "m_chi_GeV": np.exp(rng.uniform(np.log(0.1), np.log(1000.0), N_POINTS)),
        "T_p_GeV": rng.uniform(30.0, 300.0, N_POINTS),
        "v_w": rng.uniform(0.05, 0.95, N_POINTS),
        "source_shape_sigma_y": rng.uniform(2.0, 20.0, N_POINTS),
        "P_chi_to_B": rng.uniform(0.01, 0.9, N_POINTS),
    }, product=False)
    pp = point_params_from_numpy(grid, dev)
    table = table_to_device(make_f_table(base.I_p, n=TABLE_N), dev)
    streams = {f: kk.prepare_streams(pp, base.chi_stats, table, N_Y, fuse_exp=f)
               for f in (False, True)}
    st = streams[False]
    # windows that hold both branches: T(y_hi) < m/3 < T(y_lo)
    y_lo, y_hi = quadrature_bounds(pp)
    m3 = pp.m_chi_GeV / 3.0
    both = int(((T_of_y(y_hi, pp.T_p_GeV, pp.beta_over_H) < m3)
                & (m3 < T_of_y(y_lo, pp.T_p_GeV, pp.beta_over_H))).sum())
    check(both > 0, "the parity grid crosses T = m/3 inside some windows")
    errs = {}
    for name in TIERS:
        fn, plain = getattr(kk, "interp_" + name), getattr(kk, "interp_" + name + "_plain")
        got = fn(*_args(name, streams, table.values))
        torch.cuda.synchronize()
        ref = plain(*_args(name, streams, table.values))
        check(bool(torch.isfinite(got).all()), f"{name}: finite output")
        diff = (got - ref).abs()
        if name.endswith("reduce"):
            rel = (diff / ref.abs().clamp_min(1e-300)).max().item()
            tol = REDUCE_RTOL
        else:
            scale = ref.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
            rel = (diff / scale).max().item()
            tol = STREAM_RTOL
        check(rel <= tol, f"{name}: kernel vs plain {rel:.3e} <= {tol:g}")
        errs[name] = {"max_abs_err": diff.max().item(), "max_rel_err": rel, "rtol": tol}
        del got, ref, diff
    a = kk.interp_reduce(st.g, st.i1, st.sfrac, table.values)
    b = kk.interp_reduce(st.g, st.i1, st.sfrac, table.values)
    torch.cuda.synchronize()
    check(torch.equal(a, b), "reduce kernel bitwise reproducible run to run")
    emit({"phase": "parity", "points": N_POINTS, "n_y": N_Y, "table_n": TABLE_N,
          "points_with_seam_in_window": both, "reduce_bitwise_reproducible": True,
          "kernels": errs})
    return streams, table, errs


def phase_main_path(dev) -> dict:
    """The sweep at full width through each kernel tier, against the plain
    tabulated engine; launches counted from 0 around each run."""
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.ops import kjma_kernel as kk
    from bdlz_tpu_torch.parallel.sweep import run_sweep

    base = config_from_dict(ARCHIVED)
    static = static_choices_from_config(base)
    kw = dict(chunk_size=N_POINTS, n_y=N_Y, table_nodes=TABLE_N, device=dev)
    ref = run_sweep(base, MAIN_AXES, static, impl="tabulated", **kw)
    check(ref.n_failed == 0, "tabulated sweep all finite")
    ref_ratio = ref.outputs["DM_over_B"]
    launches, runs = {}, {}
    for name, (fuse_exp, reduce) in TIERS.items():
        torch.cuda.reset_peak_memory_stats(dev)
        kk.reset_launches()
        res = run_sweep(base, MAIN_AXES, static, impl="kernel", fuse_exp=fuse_exp,
                        reduce=reduce, **kw)
        counts = dict(kk.LAUNCHES)
        launches[name] = counts[name]
        ratio = res.outputs["DM_over_B"]
        check(res.n_points == 32768 and res.chunks == 4, f"{name}: 32768 points in 4 chunks")
        check(bool(np.isfinite(ratio).all()) and res.n_failed == 0, f"{name}: all finite")
        check(counts == {k: (4 if k == name else 0) for k in counts},
              f"{name}: 4 launches of its kernel and none of the others, got {counts}")
        rel = float(np.max(np.abs(ratio - ref_ratio) / np.abs(ref_ratio)))
        check(rel <= SWEEP_RTOL, f"{name}: sweep vs tabulated {rel:.3e} <= {SWEEP_RTOL:g}")
        runs[name] = {"launches": counts[name], "seconds": res.seconds,
                      "points_per_sec": res.points_per_sec, "max_rel_vs_tabulated": rel,
                      "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    one = run_sweep(base, {"m_chi_GeV": [0.95]}, static, impl="kernel",
                    chunk_size=1, n_y=N_Y, table_nodes=TABLE_N, device=dev)
    archived = float(one.outputs["DM_over_B"][0])
    arel = abs(archived / ARCHIVED_RATIO - 1.0)
    check(arel <= ARCHIVED_RTOL, f"archived point {archived!r}: {arel:.3e} <= {ARCHIVED_RTOL:g}")
    emit({"phase": "main_path", "points": ref.n_points, "chunk": N_POINTS, "n_y": N_Y,
          "table_n": TABLE_N, "tabulated_points_per_sec": ref.points_per_sec,
          "tiers": runs, "archived_DM_over_B": archived, "archived_rel_err": arel})
    return launches


def _cuda_ms(fn, reps: int, repeats: int = 5) -> list:
    """Per-launch ms of ``fn`` from CUDA events around ``reps`` launches,
    after a warm-up, for each of ``repeats`` windows."""
    fn()  # warm-up
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    return out


def phase_timing(dev, streams, table) -> dict:
    """Kernel and plain times at the production shapes (CUDA events), each
    kernel's bound, and the host prep's time for one chunk."""
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.interop import point_params_from_numpy
    from bdlz_tpu_torch.ops import kjma_kernel as kk
    from bdlz_tpu_torch.parallel.sweep import build_grid, run_sweep

    nodes = N_POINTS * N_Y
    out = {}
    for name in TIERS:
        args = _args(name, streams, table.values)
        fn, plain = getattr(kk, "interp_" + name), getattr(kk, "interp_" + name + "_plain")
        samples = _cuda_ms(lambda: fn(*args), 20)
        ms = float(np.median(samples))
        plain_ms = float(np.median(_cuda_ms(lambda: plain(*args), 3)))
        n_bytes = nodes * BYTES_PER_NODE[name] + TABLE_N * 8 + (
            N_POINTS * 8 if name.endswith("reduce") else 0)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        flops_ms = nodes * FLOPS_PER_NODE[name] / FP64_FLOP_PER_S * 1e3
        out[name] = {"ms": ms, "ms_samples": samples, "plain_ms": plain_ms, "bytes": n_bytes,
                     "flops": nodes * FLOPS_PER_NODE[name],
                     "bound_ms": max(bytes_ms, flops_ms),
                     "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
                     "achieved_bytes_per_s": n_bytes / (ms * 1e-3)}
    base = config_from_dict(ARCHIVED)
    grid = build_grid(base, MAIN_AXES)
    chunk = point_params_from_numpy(type(grid)(*(f[:N_POINTS] for f in grid)), dev)
    prep_ms = {f"fuse_exp={f}": float(np.median(_cuda_ms(
        lambda f=f: kk.prepare_streams(chunk, base.chi_stats, table, N_Y, fuse_exp=f), 3)))
        for f in (False, True)}
    static = static_choices_from_config(base)
    kw = dict(impl="kernel", chunk_size=N_POINTS, n_y=N_Y, table_nodes=TABLE_N, device=dev)
    sweep_pps = [run_sweep(base, MAIN_AXES, static, **kw).points_per_sec for _ in range(5)]
    emit({"phase": "timing", "points": N_POINTS, "n_y": N_Y, "kernels": out,
          "prep_ms_per_chunk": prep_ms,
          "sweep_points_per_sec_median": float(np.median(sweep_pps)),
          "sweep_points_per_sec_samples": sweep_pps,
          "peak_hbm_bytes_per_s": HBM_BYTES_PER_S, "peak_fp64_flop_per_s": FP64_FLOP_PER_S})
    return out


def phase_profile(dev) -> None:
    """One default-tier sweep under ``torch.profiler``: device busy time
    against the host clock, and device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.parallel.sweep import run_sweep

    base = config_from_dict(ARCHIVED)
    static = static_choices_from_config(base)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = run_sweep(base, MAIN_AXES, static, impl="kernel", chunk_size=N_POINTS,
                        n_y=N_Y, table_nodes=TABLE_N, device=dev)
    device_ms: dict = {}
    for e in prof.key_averages():  # device-side events only: kernels and copies
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            key = e.key[:96]
            device_ms[key] = device_ms.get(key, 0.0) + e.self_device_time_total / 1e3
    busy_ms = sum(device_ms.values())
    kjma_ms = sum(v for k, v in device_ms.items() if "kjma_interp_kernel" in k)
    copy_ms = sum(v for k, v in device_ms.items() if "Memcpy" in k or "Memset" in k)
    wall_ms = res.seconds * 1e3
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "profile", "sweep_wall_ms_profiled": wall_ms,
          "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
          "kjma_kernel_ms": kjma_ms, "copy_ms": copy_ms,
          "other_device_ms": busy_ms - kjma_ms - copy_ms,
          "top_device_ms": dict(top)})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # the port itself: a directory holding only this script fails here
    from bdlz_tpu_torch.ops import kjma_kernel as kk

    t0 = time.perf_counter()
    dev_info = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    streams, table, errs = phase_parity(dev)
    launches = phase_main_path(dev)
    timing = phase_timing(dev, streams, table)
    del streams
    phase_profile(dev)
    emit({"kernels": [{
        "name": kk.KERNELS[name][0],
        "route": "cuda",
        "source": "bdlz_tpu_torch/csrc/" + kk.SOURCE,
        "replaces": kk.KERNELS[name][1],
        "launches": launches[name],
        "max_abs_err": errs[name]["max_abs_err"],
        "ms": timing[name]["ms"],
        "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes interpolate-and-reduce
    } for name in TIERS]})
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "device": dev_info["nvidia_smi"]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev_info["name"],
                                 "count": dev_info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
