#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``bdlz_tpu_torch/csrc`` with
``nvcc`` (sm_90a), holds each kernel against its plain PyTorch version at
the production shapes, drives the port's sweep — the system's main path —
at full width through each kernel tier, checks the results against the
plain tabulated engine and the archived point, and times the kernels.
Then it drives the paths that hold no hand kernel: the stiff Boltzmann
sweep (the lane-repacking ESDIRK engine on a 1024-point washout grid),
the audited panel Gauss–Legendre quadrature of the tabulated sweep, and
the single-point CLI (``python -m bdlz_tpu_torch``) in a subprocess.
Last come the bounce solver, whose shoot is one hand-written kernel
(``bounce_path``: the kernel against its plain version and against the
JAX package's reference shoot, the audit, batch against loop, times), and
the LZ layer at full width (``lz_path``: P-tables at their default sizes,
one of them over a 1,000,001-sample profile, and the sweep with a shot
bounce through each estimator and scenario).

Every phase prints one JSON line; the card's name and power limit as
``nvidia-smi`` reports them and a ``kernels`` line come before the last
line, which is ``{"ok": true, "device": {...}}``.  Any failed check ends
the script with a non-zero exit and no ``ok`` line; so does a machine
without a CUDA device, or a directory without the port.  Imports nothing
of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
# The stiff grid: the archived point with washout on and the window cut at
# T_p/20, over m_chi x Gamma_wash/H = 32 x 32 = 1024 points, nothing cut.
STIFF = dict(ARCHIVED, Gamma_wash_over_H=0.01, T_min_over_Tp=0.05)
STIFF_AXES = {
    "m_chi_GeV": np.geomspace(0.3, 3.0, 32),
    "Gamma_wash_over_H": np.linspace(0.005, 0.1, 32),
}
# repacked (knobs on) vs lockstep (knobs off), card vs CPU, panel vs trapezoid
STIFF_RTOL, CARD_CPU_RTOL, PANEL_RTOL = 1e-6, 1e-6, 1e-9

# The reference potential's shoot by the JAX package (bdlz_tpu.bounce,
# full knobs; tests/test_torch_bounce.py holds these equal to it) and the
# archived P it reproduces at v_w = 0.3.
BOUNCE_REFERENCE = {"phi0": 1.04668034824163, "r_wall": 27.807233670376903,
                    "action": 49450.36521418286, "P_at_v_w_0.3": 0.14925839040304145}
BOUNCE_PHI0_RTOL, BOUNCE_RTOL = 1e-10, 1e-6       # kernel vs the JAX constants
CLASSIFY_RTOL, DENSE_ATOL = 1e-9, 1e-10          # kernel vs plain on the card
LZ_SWEEP_RTOL, LZ_CARD_CPU_RTOL = 1e-10, 1e-10
# The bounce kernel is latency bound: one thread runs a lane's whole chain
# of dependent steps.  f64 operations on the critical path of one
# attempted SDIRK4 step, counted from csrc/bounce_shoot.cu (PERF.md): per
# Newton iteration 12 dependent operations and one division (~9), 6
# iterations per stage, ~10 more per stage, 5 stages, and ~80 for the
# embedded error, its square root and the controller's pow.
BOUNCE_DEP_OPS_PER_STEP = 760
# Dependent-issue latency of one f64 add, multiply or FMA, in cycles (the
# figure published for Volta and Ampere microbenchmarks; not measured here)
F64_LATENCY_CYCLES = 8

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


def _ptxas_kernels(log: str) -> list:
    """Registers, spills and static shared memory per kernel, from
    ``-Xptxas -v``."""
    kernels, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            tmpl = re.search(r"kjma_interp_kernelILb([01])ELb([01])E", m.group(1))
            plain = re.search(r"(bounce_[a-z]+_kernel)", m.group(1))
            name = {("0", "1"): "reduce", ("0", "0"): "stream", ("1", "1"): "fused_reduce",
                    ("1", "0"): "fused_stream"}[tmpl.groups()] if tmpl else (
                        plain.group(1) if plain else m.group(1))
            kernels.append({"kernel": name})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and kernels:
            kernels[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernels:
            kernels[-1]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            kernels[-1]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return kernels


def phase_build() -> None:
    """Both sources at once, one nvcc each."""
    from concurrent.futures import ThreadPoolExecutor

    from bdlz_tpu_torch.ops import _build, bounce_kernel, kjma_kernel

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        kjma, bounce = pool.map(_build.build, (kjma_kernel.SOURCE, bounce_kernel.SOURCE))
    wall = time.perf_counter() - t0
    kjma_kernel.load_library()
    bounce_kernel.load_library()
    kk_kernels, bk_kernels = _ptxas_kernels(kjma.ptxas_log), _ptxas_kernels(bounce.ptxas_log)
    check(len(kk_kernels) == 4, f"ptxas reported 4 KJMA kernels, got {kk_kernels}")
    check(sorted(k["kernel"] for k in bk_kernels)
          == ["bounce_classify_kernel", "bounce_shoot_kernel"],
          f"ptxas reported the bounce shoot and classify kernels, got {bk_kernels}")
    emit({"phase": "build", "wall_seconds": wall, "sources": [
        {"source": "bdlz_tpu_torch/csrc/" + kjma_kernel.SOURCE, "seconds": kjma.seconds,
         "cached": kjma.cached, "dynamic_smem_bytes": TABLE_N * 8 + 32 * 8,
         "kernels": kk_kernels},
        {"source": "bdlz_tpu_torch/csrc/" + bounce_kernel.SOURCE, "seconds": bounce.seconds,
         "cached": bounce.cached, "kernels": bk_kernels}]})


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
    # pinned: an unresolved tri-state would let the audit pick the panel rule
    ref = run_sweep(base, MAIN_AXES, static._replace(quad_panel_gl=False),
                    impl="tabulated", **kw)
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
    return out, float(np.median(sweep_pps))


def _device_ms(prof) -> dict:
    """Device time (ms) by kernel or copy name from a ``torch.profiler``
    run: device-side events only."""
    from torch.autograd import DeviceType

    device_ms: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            key = e.key[:96]
            device_ms[key] = device_ms.get(key, 0.0) + e.self_device_time_total / 1e3
    return device_ms


def phase_profile(dev) -> None:
    """One default-tier sweep under ``torch.profiler``: device busy time
    against the host clock, and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.parallel.sweep import run_sweep

    base = config_from_dict(ARCHIVED)
    static = static_choices_from_config(base)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = run_sweep(base, MAIN_AXES, static, impl="kernel", chunk_size=N_POINTS,
                        n_y=N_Y, table_nodes=TABLE_N, device=dev)
    device_ms = _device_ms(prof)
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


def _launches_around(fn):
    """``fn()`` with every kernel's launch count set to 0 just before and
    read just after: (result, counts)."""
    from bdlz_tpu_torch.ops import bounce_kernel as bk
    from bdlz_tpu_torch.ops import kjma_kernel as kk

    kk.reset_launches()
    bk.reset_launches()
    out = fn()
    return out, {**kk.LAUNCHES, **{"bounce_" + k: v for k, v in bk.LAUNCHES.items()}}


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def phase_stiff_path(dev) -> None:
    """The stiff sweep at full size through ``run_sweep`` (routed to the
    repacked ESDIRK engine, knobs resolved on), then: repacked against
    lockstep with the knobs off (bitwise) and with them on (1e-6) on the
    first 64 lanes, and 8 corner lanes on the card against the CPU."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.interop import point_params_from_numpy
    from bdlz_tpu_torch.parallel.sweep import build_grid, run_sweep
    from bdlz_tpu_torch.physics.percolation import make_kjma_grid
    from bdlz_tpu_torch.solvers.batching import (
        initial_yields,
        make_batched_esdirk_step,
        solve_boltzmann_esdirk_batch,
    )
    from bdlz_tpu_torch.solvers.sdirk import solve_boltzmann_esdirk

    t0 = time.perf_counter()
    part_s = {}
    base = config_from_dict(STIFF)
    static = static_choices_from_config(base)
    n_points = int(np.prod([len(v) for v in STIFF_AXES.values()]))
    res, counts = _launches_around(lambda: run_sweep(
        base, STIFF_AXES, static, chunk_size=n_points, device=dev))
    n_m, n_g = (len(v) for v in STIFF_AXES.values())
    check(res.impl == "esdirk" and res.n_points == n_points,
          f"{n_points} points routed to esdirk, got {res.n_points} to {res.impl}")
    check(res.n_failed == 0, f"stiff sweep all finite ({res.n_failed} failed)")
    check(not any(counts.values()), f"no hand kernel on the stiff path, got {counts}")
    (stats,) = res.esdirk_stats
    steps = stats.lane_steps
    part_s["sweep"] = time.perf_counter() - t0

    grid_np = build_grid(base, STIFF_AXES)
    first = point_params_from_numpy(type(grid_np)(*(f[:64] for f in grid_np)), dev)
    off = static._replace(ode_auto_h0=False, ode_pi_controller=False, ode_tabulated_av=False)
    zgrid = make_kjma_grid(dev)
    t1 = time.perf_counter()
    rep = solve_boltzmann_esdirk_batch(first, off, zgrid)
    torch.cuda.synchronize()
    part_s["repacked_64_knobs_off"] = time.perf_counter() - t1
    T_lo = first.T_min_over_Tp * first.T_p_GeV
    T_hi = first.T_max_over_Tp * first.T_p_GeV
    t1 = time.perf_counter()
    lock = solve_boltzmann_esdirk(first, off, zgrid, initial_yields(first, off), T_lo, T_hi)
    torch.cuda.synchronize()
    part_s["lockstep_64_knobs_off"] = time.perf_counter() - t1
    check(bool(lock.success.all()), "lockstep, knobs off: all 64 lanes converged")
    bitwise = all(torch.equal(getattr(rep, f), getattr(lock, f))
                  for f in ("y", "n_steps", "n_accepted", "n_rejected", "success"))
    check(bitwise, "repacked == lockstep bit for bit with the knobs off (64 lanes)")
    on_vs_off = max(_max_rel(res.outputs["Y_B"][:64], lock.y[:, 1].cpu()),
                    _max_rel(res.outputs["Y_chi"][:64], lock.y[:, 0].cpu()))
    check(on_vs_off <= STIFF_RTOL, f"knobs on vs lockstep off {on_vs_off:.3e} <= {STIFF_RTOL:g}")

    # 8 lanes at the grid's corners and edges: 4 masses x the two washout ends
    corners = np.array([i * n_g + j for i in np.linspace(0, n_m - 1, 4).astype(int)
                        for j in (0, n_g - 1)])
    sub = type(grid_np)(*(f[corners] for f in grid_np))
    t1 = time.perf_counter()
    cpu = make_batched_esdirk_step(static)(point_params_from_numpy(sub, "cpu"),
                                           make_kjma_grid("cpu"))
    part_s["cpu_8_lanes"] = time.perf_counter() - t1
    card_cpu = max(_max_rel(res.outputs[f][corners], getattr(cpu, f).numpy())
                   for f in ("Y_B", "Y_chi", "DM_over_B"))
    check(card_cpu <= CARD_CPU_RTOL, f"card vs CPU on 8 lanes {card_cpu:.3e} <= {CARD_CPU_RTOL:g}")

    # device activity only: recording ~700k host ops as well would slow the
    # host loop that is being measured and take minutes to aggregate
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res_p = run_sweep(base, STIFF_AXES, static, chunk_size=n_points, device=dev)
    device_ms = _device_ms(prof)
    part_s["profiled_sweep"] = time.perf_counter() - t1
    busy_ms = sum(device_ms.values())
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:6]
    emit({"phase": "stiff_path", "points": res.n_points, "impl": res.impl,
          "seconds": time.perf_counter() - t0, "part_seconds": part_s,
          "sweep_seconds": res.seconds,
          "points_per_sec": res.points_per_sec, "kernel_launches": counts,
          "rounds": stats.n_rounds,
          "lanes_live_per_round": [r.active_lanes for r in stats.rounds],
          "round_seconds": [r.seconds for r in stats.rounds],
          "steps_per_lane_median": float(np.median(steps)),
          "steps_per_lane_max": int(steps.max()),
          "steps_accepted": stats.summary()["steps_accepted"],
          "steps_rejected": stats.summary()["steps_rejected"],
          "repacked_vs_lockstep_knobs_off_bitwise": bitwise,
          "knobs_on_vs_lockstep_off_max_rel": on_vs_off,
          "card_vs_cpu_8_lanes_max_rel": card_cpu,
          "profiled_sweep_wall_ms": res_p.seconds * 1e3, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / (res_p.seconds * 1e3),
          "device_kernel_launches": sum(
              e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
          "top_device_ms": dict(top)})


def phase_panel_path(dev, kernel_pps: float) -> None:
    """The tabulated sweep with quad_panel_gl null over the main grid: the
    audit's verdict, the scheme that ran, and — when the panel rule runs —
    agreement with the trapezoid kernel sweep."""
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.ops.kjma_table import make_f_table
    from bdlz_tpu_torch.parallel.sweep import build_grid, run_sweep
    from bdlz_tpu_torch.validation import panel_gl_population_audit

    t0 = time.perf_counter()
    base = config_from_dict(ARCHIVED)
    static = static_choices_from_config(base)
    check(static.quad_panel_gl is None, "the config leaves the tri-state unset")
    audit = panel_gl_population_audit(build_grid(base, MAIN_AXES), base.chi_stats,
                                      n_y=N_Y, table=make_f_table(base.I_p, n=TABLE_N))
    kw = dict(chunk_size=N_POINTS, n_y=N_Y, table_nodes=TABLE_N, device=dev)
    res, counts = _launches_around(
        lambda: run_sweep(base, MAIN_AXES, static, impl="tabulated", **kw))
    check(res.n_failed == 0, "panel-path sweep all finite")
    check(res.quad_impl == ("panel_gl" if audit.ok else "trap"),
          f"the sweep ran the audited scheme, got {res.quad_impl}")
    check(not any(counts.values()), f"no hand kernel on the tabulated path, got {counts}")
    pps = [res.points_per_sec] + [run_sweep(base, MAIN_AXES, static, impl="tabulated",
                                            **kw).points_per_sec for _ in range(2)]
    rel = None
    if audit.ok:
        trap = run_sweep(base, MAIN_AXES, static, impl="kernel", **kw)
        rel = _max_rel(res.outputs["DM_over_B"], trap.outputs["DM_over_B"])
        check(rel <= PANEL_RTOL, f"panel vs trapezoid kernel sweep {rel:.3e} <= {PANEL_RTOL:g}")
    emit({"phase": "panel_path", "points": res.n_points,
          "seconds": time.perf_counter() - t0,
          "audit": {"ok": audit.ok, "reason": audit.reason, "n_sampled": audit.n_sampled,
                    "n_seam_inside": audit.n_seam_inside,
                    "max_rel_vs_trap": audit.max_rel_vs_trap,
                    "max_err_half": audit.max_err_half,
                    "max_err_quarter": audit.max_err_quarter},
          "quad_impl": res.quad_impl, "n_quad_nodes": res.n_quad_nodes,
          "kernel_launches": counts, "points_per_sec_median": float(np.median(pps)),
          "points_per_sec_samples": pps, "kernel_tier_points_per_sec_median": kernel_pps,
          "max_rel_vs_trapezoid_kernel": rel})


def phase_cli(dev) -> None:
    """``python -m bdlz_tpu_torch`` in a subprocess, in a fresh directory:
    the archived config with --diagnostics --planck, and the stiff config.
    The same two points in-process first, with the launch counts read
    around them."""
    from bdlz_tpu_torch.cli import run_point
    from bdlz_tpu_torch.config import config_from_dict

    t0 = time.perf_counter()
    inproc, counts = _launches_around(lambda: [
        float(run_point(config_from_dict(c), c["P_chi_to_B"], dev).DM_over_B)
        for c in (ARCHIVED, STIFF)])
    check(not any(counts.values()), f"no hand kernel on the CLI paths, got {counts}")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    work = tempfile.mkdtemp(prefix="bdlz_cli_")
    runs = {}
    try:
        for name, cfg, flags in (("archived", ARCHIVED, ["--diagnostics", "--planck"]),
                                 ("stiff", STIFF, [])):
            d = os.path.join(work, name)
            os.mkdir(d)
            with open(os.path.join(d, "cfg.json"), "w") as f:
                json.dump(cfg, f)
            t1 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "bdlz_tpu_torch", "--config", "cfg.json", *flags],
                cwd=d, env=env, capture_output=True, text=True, timeout=300)
            wall = time.perf_counter() - t1
            check(proc.returncode == 0, f"cli {name}: exit {proc.returncode}: {proc.stderr[-2000:]}")
            with open(os.path.join(d, "yields_out.json")) as f:
                ratio = json.load(f)["final"]["DM_over_B"]
            check(np.isfinite(ratio) and "[warn]" not in proc.stdout, f"cli {name}: finite, converged")
            runs[name] = {"wall_seconds": wall, "DM_over_B": ratio,
                          "stdout_lines": len(proc.stdout.splitlines())}
            if name == "archived":
                check("DM/B ratio= 5.68893\n" in proc.stdout, "cli archived: DM/B ratio= 5.68893")
                check("# Diagnostics around percolation" in proc.stdout
                      and "=== Planck comparison" in proc.stdout, "cli archived: both blocks")
                arel = abs(ratio / ARCHIVED_RATIO - 1.0)
                check(arel <= ARCHIVED_RTOL, f"cli archived {ratio!r}: {arel:.3e} <= {ARCHIVED_RTOL:g}")
                runs[name]["rel_err_vs_archived"] = arel
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "cli", "seconds": time.perf_counter() - t0, "kernel_launches": counts,
          "in_process_DM_over_B": inproc, "runs": runs})


def _rel(a, b) -> float:
    return abs(float(a) / float(b) - 1.0)


def _sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def phase_bounce_path(dev) -> dict:
    """The O(4) bounce shoot: the classify and dense kernels against the
    plain version on the card, the full-knob shoot (one launch) against the
    JAX package's reference shoot, the audit, a 64-spec batch against the
    loop of single shoots, and the times."""
    from bdlz_tpu_torch.bounce import (
        PotentialSpec,
        reference_potential,
        solve_bounce,
        solve_bounce_batch,
        solve_bounce_scalar_loop,
    )
    from bdlz_tpu_torch.bounce.shooting import (
        _params_row,
        classify_plain,
        dense_plain,
        make_knobs,
    )
    from bdlz_tpu_torch.ops import bounce_kernel as bk
    from bdlz_tpu_torch.validation import bounce_audit

    t0 = time.perf_counter()
    knobs = make_knobs()
    spec = reference_potential()
    row = _params_row(spec)
    phi_false, phi_top, phi_true = row[3], row[4], row[5]
    dphi = phi_true - phi_false
    hi = phi_true - 1e-13 * dphi

    # 1. classify: 6 release points across the bracket and 2 beside the
    # converged φ₀ (1e-7 and 1e-8 of Δφ away), kernel and plain on the card
    phi0_ref = BOUNCE_REFERENCE["phi0"]
    points = np.concatenate([np.linspace(phi_top, hi, 8)[1:-1],
                             [phi0_ref - 1e-7 * dphi, phi0_ref + 1e-8 * dphi]])
    check(bool(np.all(np.abs(points - phi0_ref) > 1e-9 * dphi)),
          "no release point within 1e-9 of Δφ of the converged φ₀")
    params = torch.as_tensor(np.repeat(row[None], len(points), axis=0), dtype=torch.float64,
                             device=dev)
    phis = torch.as_tensor(points, dtype=torch.float64, device=dev)
    kc = bk.bounce_classify(params, phis, knobs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pc = classify_plain(params, phis, knobs)
    torch.cuda.synchronize()
    plain_classify_8_s = time.perf_counter() - t1
    check(torch.equal(kc.verdict, pc.verdict) and torch.equal(kc.segments, pc.segments),
          f"classify verdicts {kc.verdict.tolist()} / {pc.verdict.tolist()} and segments "
          f"{kc.segments.tolist()} / {pc.segments.tolist()} equal")
    first_rel = ((kc.y_first - pc.y_first).abs() / pc.y_first.abs()).max().item()
    check(first_rel <= CLASSIFY_RTOL, f"first segment's end state {first_rel:.3e} "
                                      f"<= {CLASSIFY_RTOL:g}")
    classify_abs = max((kc.y_first - pc.y_first).abs().max().item(),
                       (kc.y_end - pc.y_end).abs().max().item())

    # 2. the main path: one shoot, one launch
    sol, counts = _launches_around(lambda: solve_bounce(spec, device=dev))
    check(counts["bounce_shoot"] == 1 and counts["bounce_classify"] == 0,
          f"one bounce_shoot launch per solve_bounce, got {counts}")
    check(bool(sol.converged), "the reference shoot converged")
    errs = {k: _rel(getattr(sol, k), BOUNCE_REFERENCE[k]) for k in ("phi0", "r_wall", "action")}
    check(errs["phi0"] <= BOUNCE_PHI0_RTOL, f"phi0 vs JAX {errs['phi0']:.3e}")
    check(errs["r_wall"] <= BOUNCE_RTOL and errs["action"] <= BOUNCE_RTOL,
          f"r_wall/action vs JAX {errs}")

    # 3. the dense pass of the plain version at the kernel's φ₀
    p1 = torch.as_tensor(row[None], dtype=torch.float64, device=dev)
    phi0_t = torch.as_tensor([float(sol.phi0)], dtype=torch.float64, device=dev)
    t1 = time.perf_counter()
    r_wall_p, action_p, _crossed, phi_p, _dphi_p = dense_plain(p1, phi0_t, knobs)
    torch.cuda.synchronize()
    plain_dense_s = time.perf_counter() - t1
    dense_abs = float(np.max(np.abs(phi_p[0].cpu().numpy() - sol.phi)))
    check(dense_abs <= DENSE_ATOL, f"dense phi kernel vs plain {dense_abs:.3e} <= {DENSE_ATOL:g}")

    # 4. the audit on the card
    audit = bounce_audit(device=dev)
    check(audit.ok and audit.P_vs_archived <= 1e-6 and audit.action_vs_thin_wall <= 0.12
          and audit.n_crossings == 1, f"bounce audit passed: {audit}")

    # 5. 64 specs around the reference: the batch (one launch) equals the
    # loop of single shoots bit for bit
    lam4s, epss = np.linspace(0.45, 0.55, 8), np.linspace(0.045, 0.055, 8)
    specs = [PotentialSpec(l4, spec.vev, e, spec.g_delta, spec.m_mix0)
             for l4 in lam4s for e in epss]
    t1 = time.perf_counter()
    batch = solve_bounce_batch(specs, lane_width=len(specs), device=dev)
    batch_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    loop = solve_bounce_scalar_loop(specs, device=dev)
    loop_s = time.perf_counter() - t1
    bitwise = all(np.array_equal(getattr(batch, f), getattr(loop, f), equal_nan=True)
                  for f in batch._fields)
    check(bitwise, "solve_bounce_batch equals solve_bounce_scalar_loop bit for bit")
    check(bool(batch.converged.all()), "all 64 shoots converged")

    # 6. times: one shoot and one plain classify (CUDA events), the bound
    one = _cuda_ms(lambda: bk.bounce_shoot(p1, knobs), 1, repeats=3)
    shoot = bk.bounce_shoot(p1, knobs)
    steps = int(shoot.steps.item())
    # the plain version is eager: one timed classify, no warm-up
    mid = torch.as_tensor([points[-2]], dtype=torch.float64, device=dev)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    classify_plain(p1, mid, knobs)
    stop.record()
    torch.cuda.synchronize()
    plain_classify = [start.elapsed_time(stop)]
    clock = _sm_clock_hz()
    bound_ms = steps * BOUNCE_DEP_OPS_PER_STEP * F64_LATENCY_CYCLES / clock * 1e3
    ms = float(np.median(one))
    timing = {"ms": ms, "ms_samples": one, "plain_ms": plain_classify[0],
              "plain_is": "one classify of one release point 1e-7 of the bracket from phi0",
              "bound_ms": bound_ms, "bound_by": "operations", "attempted_steps": steps,
              "segment_solves": int(shoot.segments.item()),
              "dep_ops_per_step": BOUNCE_DEP_OPS_PER_STEP,
              "f64_latency_cycles": F64_LATENCY_CYCLES, "sm_clock_hz": clock,
              "fraction_of_bound": bound_ms / ms}
    emit({"phase": "bounce_path", "seconds": time.perf_counter() - t0,
          "classify": {"points": points.tolist(), "verdicts": kc.verdict.tolist(),
                       "segments": kc.segments.tolist(), "steps": kc.steps.tolist(),
                       "first_segment_max_rel": first_rel, "max_abs_err": classify_abs,
                       "plain_8_lanes_seconds": plain_classify_8_s},
          "shoot": {"launches": counts["bounce_shoot"], "phi0": float(sol.phi0),
                    "r_wall": float(sol.r_wall), "action": float(sol.action),
                    "rel_vs_jax": errs},
          "dense_max_abs_kernel_vs_plain": dense_abs, "plain_dense_seconds": plain_dense_s,
          "plain_dense_r_wall": r_wall_p.item(), "plain_dense_action": action_p.item(),
          "audit": {"ok": audit.ok, "P_vs_archived": audit.P_vs_archived,
                    "action_vs_thin_wall": audit.action_vs_thin_wall,
                    "n_crossings": audit.n_crossings},
          "batch_64": {"seconds": batch_s, "loop_seconds": loop_s, "bitwise_equal": bitwise,
                       "launches": 1, "action_range": [float(batch.action.min()),
                                                       float(batch.action.max())]},
          "timing": timing})
    return {"launches": counts["bounce_shoot"], "max_abs_err": max(classify_abs, dense_abs),
            **timing, "solution": sol}


LZ_METHODS = {  # sweep estimators and scenarios of the lz_path sweeps
    "local": ({}, {"lz_method": "local"}),
    "coherent": ({}, {"lz_method": "coherent"}),
    "local-momentum": ({}, {"lz_method": "local-momentum"}),
    "dephased": ({}, {"lz_method": "dephased", "lz_gamma_phi": 0.01}),
    "chain": ({"lz_mode": "chain", "lz_n_levels": 3}, {}),
    "thermal": ({"lz_mode": "thermal", "lz_bath_eta": 0.001, "lz_bath_omega_c": 50.0}, {}),
}


def phase_lz_path(dev, sol, kernel_pps: float) -> None:
    """The LZ layer at full width: the P-tables at their default sizes over
    the kernel-shot reference profile (801 samples) and over a
    1,000,001-sample profile of the same wall (profiled), the sweep with
    the shot bounce through each estimator and scenario against the
    tabulated engine, and the table on the card against the CPU."""
    from torch.profiler import ProfilerActivity, profile

    from bdlz_tpu_torch.bounce import bounce_profile, reference_potential
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.lz.sweep_bridge import (
        make_P_of_vw_gamma_table,
        make_P_of_vw_table,
        make_P_table_n,
    )
    from bdlz_tpu_torch.parallel.sweep import run_sweep

    t0 = time.perf_counter()
    spec = reference_potential()
    prof = bounce_profile(spec, solution=sol)
    big = bounce_profile(spec, solution=sol, n_xi=1_000_001)
    check(len(prof.xi) == 801 and len(big.xi) == 1_000_001, "profiles of 801 and 1,000,001")
    tables = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        vals = out.values
        check(bool(torch.isfinite(vals).all()) and vals.device.type == "cuda",
              f"{name}: finite, on the card")
        tables[name] = {"seconds": time.perf_counter() - t1, "shape": list(vals.shape)}
        return out

    timed("coherent_16384_over_801", lambda: make_P_of_vw_table(
        prof, "coherent", 0.05, 0.95, device=dev))
    timed("coherent_16384_over_1000001", lambda: make_P_of_vw_table(
        big, "coherent", 0.05, 0.95, device=dev))
    timed("dephased_2d_16384x33_over_801", lambda: make_P_of_vw_gamma_table(
        prof, 0.05, 0.95, 0.0, 0.05, device=dev))
    timed("chain3_16384_over_801", lambda: make_P_table_n(prof, 3, 0.05, 0.95, device=dev))

    # device activity of the 1,000,001-sample table
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof_run:
        make_P_of_vw_table(big, "coherent", 0.05, 0.95, device=dev)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t1) * 1e3
    device_ms = _device_ms(prof_run)
    busy_ms = sum(device_ms.values())
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:6]

    # the table's P on the card against the CPU, 64 nodes
    card = make_P_of_vw_table(prof, "coherent", 0.05, 0.95, n=64, device=dev).values.cpu()
    cpu = make_P_of_vw_table(prof, "coherent", 0.05, 0.95, n=64, device="cpu").values
    card_cpu = float(((card - cpu).abs() / cpu.abs()).max())
    check(card_cpu <= LZ_CARD_CPU_RTOL, f"table card vs CPU {card_cpu:.3e}")

    # the sweep CLI's path with a shot bounce, per estimator and scenario
    sweeps = {}
    bounce = dict(spec._asdict())
    for name, (cfg_over, kw) in LZ_METHODS.items():
        base = config_from_dict(dict(ARCHIVED, **cfg_over))
        static = static_choices_from_config(base)
        common = dict(chunk_size=N_POINTS, n_y=N_Y, table_nodes=TABLE_N, device=dev,
                      bounce=bounce, **kw)
        res, counts = _launches_around(lambda: run_sweep(base, MAIN_AXES, static,
                                                         impl="kernel", **common))
        check(res.n_points == 32768 and res.n_failed == 0, f"{name}: 32768 finite points")
        check(counts["reduce"] == 4 and counts["bounce_shoot"] == 1,
              f"{name}: K1 launched 4 times and the shoot once, got {counts}")
        ref = run_sweep(base, MAIN_AXES, static._replace(quad_panel_gl=False),
                        impl="tabulated", **common)
        rel = _max_rel(res.outputs["DM_over_B"], ref.outputs["DM_over_B"])
        check(rel <= LZ_SWEEP_RTOL, f"{name}: kernel vs tabulated {rel:.3e}")
        check("bounce" in res.lz_identity, f"{name}: the potential keys the sweep")
        sweeps[name] = {"points_per_sec": res.points_per_sec, "sweep_seconds": res.seconds,
                        "lz_prepass_seconds": res.lz_seconds, "launches": counts,
                        "max_rel_vs_tabulated": rel, "lz_identity": res.lz_identity}
    emit({"phase": "lz_path", "seconds": time.perf_counter() - t0, "tables": tables,
          "profile_1000001": {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                              "device_busy_share": busy_ms / wall_ms,
                              "top_device_ms": dict(top)},
          "table_card_vs_cpu_64_nodes_max_rel": card_cpu,
          "sweeps": sweeps, "plain_P_kernel_tier_points_per_sec": kernel_pps})


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
    timing, sweep_pps = phase_timing(dev, streams, table)
    del streams
    phase_profile(dev)
    phase_stiff_path(dev)
    phase_panel_path(dev, sweep_pps)
    phase_cli(dev)
    bounce = phase_bounce_path(dev)
    phase_lz_path(dev, bounce.pop("solution"), sweep_pps)
    from bdlz_tpu_torch.ops import bounce_kernel as bk

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
    } for name in TIERS] + [{
        "name": bk.KERNELS["shoot"][0],
        "route": "cuda",
        "source": "bdlz_tpu_torch/csrc/" + bk.SOURCE,
        "replaces": bk.KERNELS["shoot"][1],
        "launches": bounce["launches"],
        "max_abs_err": bounce["max_abs_err"],
        "ms": bounce["ms"],
        "plain_ms": bounce["plain_ms"],  # one plain classify, not a whole shoot
        "bound_ms": bounce["bound_ms"],
        "bound_by": bounce["bound_by"],
        "library_ms": None,  # no PyTorch call shoots a bounce
    }]})
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "device": dev_info["nvidia_smi"]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev_info["name"],
                                 "count": dev_info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
