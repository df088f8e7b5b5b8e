#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``bdlz_tpu_torch/csrc`` with
``nvcc`` (sm_90a), holds each kernel against its plain PyTorch version at
the production shapes (``parity``: the stream tiers' point kernels P2 and
P4 node by node on a seam-crossing grid; ``point_parity``: the point
kernels P1-P4, which compute each tier's whole function from per-point
scalars, over the main grid's first chunk, the audit population and edge
cases), drives the
port's sweep — the system's main path —
at full width through each kernel tier, checks the results against the
plain tabulated engine and the archived point, and times the kernels.
Then it drives the paths that hold no hand kernel: the stiff Boltzmann
sweep (the lane-repacking ESDIRK engine on a 1024-point washout grid),
the audited panel Gauss–Legendre quadrature of the tabulated sweep, and
the single-point CLI (``python -m bdlz_tpu_torch``) in a subprocess.
Before those, ``overlap_path`` runs the main grid through P1 with the
sweep's double-buffered chunk loop and with the serial loop, in turns
(bitwise equal outputs, points/s, and under the profiler each side's
device busy share, idle gaps between chunks and peak memory), and the
tiered population gate through ``make_chunk_runner`` for P1-P4.
Then come the bounce solver, whose shoot is one hand-written kernel
(``bounce_path``: a depth-k bisection tree per lane, against its plain
version, against the JAX package's reference shoot and bit for bit
against the one-thread-per-lane kernel; the audit, batch against loop,
the measured f64 latencies, times and bounds), and
the LZ layer at full width (``lz_path``: P-tables at their default sizes,
one of them over a 1,000,001-sample profile, and the sweep with a shot
bounce through each estimator and scenario).  Then the sweep's
robustness on the main grid through P1 (``robust_path``: resume, a torn
chunk file, a transient fault, a poison point bisected into quarantine,
a NaN point, the chunk store cold and warm) and the emulator
(``emulator_path``: the bench's 4-D box built through P1 and checked
against the plain engine, saved and reloaded, 65,536 queries timed on
the card against the CPU, a spot check against exact P1 points, a warm
rebuild through one store, and the seam-split bundle).  Last the sampling
layer (``sampling_path``, no hand kernel on it): the stretch sampler at the
MCMC CLI's defaults over (m_chi, P) of the archived config, NUTS from its
walkers, a stretch run backed by the emulator_path artifact against its
exact twin, the card's logp, gradient and chain against the CPU's,
finite-difference parity, a checkpointed NUTS chain cut and resumed, and
``python -m bdlz_tpu_torch.mcmc_cli`` in a subprocess.  Then the host
planes (``host_planes``: the g++-built CSV parser against NumPy on a
1,000,001-sample profile, the per-point CPU reference on 64 audit points
against the card's P1 engine, ``sweep_cli --sanitize --profile-dir`` and
``--debug-nans``) and the serving plane (``serving_path``: the emulator_path
artifact served by the single service under 65,536 queries, mixed
requests whose exact fallback runs P1, the 2-replica fleet with its fault
drills, a rollout cutover under load, and ``python -m bdlz_tpu_torch.serve``
in subprocesses).  Then the mesh (``mesh_path``): the main grid on two
members of the one card through P1 and the tabulated engine, bitwise the
runs without a mesh; one point's sp quadrature at n_y 1,048,576;
``sweep_cli --multihost`` and ``mcmc_cli --multihost`` in two processes on
the card (gloo carries their agreements), resumed; a fleet with mixed
kernel builds refused on both processes; and a NCCL world of one.  Last
the compile-check entry points (``graft_path``): ``entry()``'s forward step on
the card against the CPU, timed, and ``dryrun_multichip`` on meshes of 2
and 4 members of the one card against the same dry runs on the host, P1
launched on every member.  Then the evidence tools (``evidence_path``:
``scripts/torch_*.py``, each through its ``main`` at reduced sizes): the
accuracy audit through the tabulated engine and P1 against the CPU
reference, the n_y convergence study with its sp row, the engine
shoot-out through P1-P4, the LZ scale run and weak scaling over 1 and 2
members of the card.

Every phase prints one JSON line; the card's name and power limit as
``nvidia-smi`` reports them and a ``kernels`` line come before the last
line, which is ``{"ok": true, "device": {...}}``.  Any failed check ends
the script with a non-zero exit and no ``ok`` line; so does a machine
without a CUDA device, or a directory without the port.  Imports nothing
of JAX or of the JAX package.  ``--only host_planes,serving_path`` (or any
of overlap_path, robust_path, emulator_path, sampling_path, mesh_path,
graft_path, elastic_path, fabric_path, evidence_path) runs just those phases
(after the build) and prints no ``ok`` line.
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
# (fuse_exp, reduce) of each kernel tier of the sweep, and the kernel each
# tier launches: the point kernels of csrc/kjma_point.cu, P1 and P3 for the
# reduce tiers, P2 and P4 for the stream tiers.
TIERS = {"reduce": (False, True), "fused_reduce": (True, True),
         "stream": (False, False), "fused_stream": (True, False)}
TIER_KERNEL = {"reduce": "point_reduce", "fused_reduce": "point_fused_reduce",
               "stream": "point_stream", "fused_stream": "point_fused_stream"}
#: P1, P3, P2, P4: kjma_point_kernel<FUSED, REDUCE>'s instantiations.
POINT_KERNELS = ("point_reduce", "point_fused_reduce", "point_stream", "point_fused_stream")
STREAM_KERNELS = ("point_stream", "point_fused_stream")
MAIN_KERNEL = TIER_KERNEL["reduce"]  # P1, the default tier's kernel
SWEEP_RTOL, ARCHIVED_RTOL = 1e-10, 1e-9
# a reduce kernel against its plain version per point (the summation order
# differs); a stream kernel against its plain version per node, relative
# to the row's largest node (the same operations in the same order); the
# reduce tier's Y_B against the stream tier's (the summation order only)
POINT_RTOL, STREAM_RTOL, ROUTE_RTOL = 1e-13, 1e-14, 1e-13
Y_CUT = 50.0  # the hard A/V = 0 cut: nodes above it are 0
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
# The bounce shoot is latency bound: a classification is one chain of
# dependent attempted steps.  Dependent f64 operations on the critical path
# of one attempted SDIRK4 step, counted from csrc/bounce_shoot.cu (PERF.md):
# per Newton iteration 12 adds or multiplies and one division; per stage 6
# iterations, ~10 more adds or multiplies and the slope's division (3φ'/ρ);
# 5 stages; then the embedded error (~12 adds or multiplies, one division,
# one square root) and the I controller's pow.
STEP_CHAIN = {"add": 5 * (6 * 12 + 10) + 12, "div": 5 * (6 + 1) + 1, "sqrt": 1, "pow": 1}
# One RK4 step of the dense pass: per stage the predictor (2), 3φ'/ρ (1 and
# a division) and V' − 3φ'/ρ (1); the combination (6) and the settle test (1).
DENSE_CHAIN = {"add": 4 * 4 + 7, "div": 4}
# The serial shoot's first bound: 760 dependent operations per step at an
# assumed 8 cycles each (the latency published for Volta and Ampere).
ASSUMED_OPS_PER_STEP, ASSUMED_LATENCY_CYCLES = 760, 8
# Dependent f64 operations the latency probe runs per kind.
PROBE_REPS = 4096

# H100 SXM peaks from NVIDIA's data sheet: HBM3 at 3.35 TB/s, and
# 34 TFLOP/s FP64 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 34e12
# f64 instructions of one exp, counted as 20.
EXP_FLOPS = 20
# The point kernels are bound by operations: f64 instructions per node of
# a non-empty window, counted from csrc/kjma_point.cu (every kernel does
# the same node operations, the fused ones in another order; the stream
# kernels store the node where the reduce kernels add it).  49 adds, multiplies, compares and
# conversions (the node's y 4, d 3, the clamp 2, aw 2, the seam 2, A 2,
# bf 1, w 1, the exponent's argument and two products 3, t, floor and i1
# 6, the cubic's offsets, weights and taps 20, the product, the cut and
# the sum 3), 4 IEEE divisions (2y/B, y^2/(2 sigma^2) and the cubic's two
# /6) at ~9 instructions each (a reciprocal estimate and its Newton
# steps), a square root at ~8 and an exp at ~20 (EXP_FLOPS).  The H100's
# 34 TFLOP/s FP64 peak counts an FMA as two operations: it issues one f64
# instruction per FP64 lane and clock, 17e12 a second.
POINT_F64_INSTR_PER_NODE = 49 + 4 * 9 + 8 + EXP_FLOPS
FP64_INSTR_PER_S = FP64_FLOP_PER_S / 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase_device() -> dict:
    from bdlz_tpu_torch.backend import device_label

    smi = device_label(torch.device("cuda", 0))
    print(smi, flush=True)
    dev = {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
           "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda}
    emit({"phase": "device", **dev})
    return dev


def _point_kernel_name(fused: str, reduce: str) -> str:
    """The wrapper of ``kjma_point_kernel<FUSED, REDUCE>``, from the
    template arguments' digits in its mangled name."""
    return {("0", "1"): "point_reduce", ("1", "1"): "point_fused_reduce",
            ("0", "0"): "point_stream", ("1", "0"): "point_fused_stream"}[(fused, reduce)]


def _ptxas_kernels(log: str) -> list:
    """Registers, spills and static shared memory per kernel, from
    ``-Xptxas -v``."""
    kernels, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            point = re.search(r"kjma_point_kernelILb([01])ELb([01])E", m.group(1))
            plain = re.search(r"((bounce|bloch)_[a-z_]+?_kernel)", m.group(1))
            if point:
                name = _point_kernel_name(*point.groups())
            else:
                name = plain.group(1) if plain else m.group(1)
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


#: f64 instructions in SASS (the FP64 pipe's arithmetic, compares,
#: conversions and the reciprocal and root estimates).
SASS_F64 = re.compile(r"\b(DADD|DMUL|DFMA|DSETP|DMNMX|FRND\.F64\S*|F2I\S*\.F64\S*|"
                      r"I2F\.F64\S*|F2F\.F64\S*|MUFU\.(RCP|RSQ)64H)\b")


def _sass_f64_counts(lib_path) -> dict:
    """Per kernel, the f64 instructions in its SASS (``cuobjdump -sass``):
    a static count of the whole function, its division and exp slow paths
    included, beside the per-node count from the source; None where the
    toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and SASS_F64.search(line):
            counts[name] += 1
    return counts


def phase_build() -> None:
    """The three sources at once, one nvcc each."""
    from concurrent.futures import ThreadPoolExecutor

    from bdlz_tpu_torch.ops import _build, bloch_kernel, bounce_kernel, kjma_kernel

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        point, bounce, bloch = pool.map(_build.build, (
            kjma_kernel.POINT_SOURCE, bounce_kernel.SOURCE, bloch_kernel.SOURCE))
    wall = time.perf_counter() - t0
    kjma_kernel.load_point_library()
    bounce_kernel.load_library()
    bloch_kernel.load_library()
    pk_kernels, bk_kernels = _ptxas_kernels(point.ptxas_log), _ptxas_kernels(bounce.ptxas_log)
    bl_kernels = _ptxas_kernels(bloch.ptxas_log)
    check([k["kernel"] for k in bl_kernels] == ["bloch_transport_kernel"],
          f"ptxas reported the transport kernel, got {bl_kernels}")
    check(all(k.get("spill_stores") == 0 and k.get("spill_loads") == 0 for k in bl_kernels),
          f"the transport kernels spill no registers, got {bl_kernels}")
    check(sorted(k["kernel"] for k in pk_kernels) == sorted(POINT_KERNELS),
          f"ptxas reported the four point kernels, got {pk_kernels}")
    check(all(k.get("spill_stores") == 0 and k.get("spill_loads") == 0 for k in pk_kernels),
          f"the point kernels spill no registers, got {pk_kernels}")
    sass = _sass_f64_counts(point.path)
    for k in pk_kernels:
        k["sass_f64_instructions"] = None if sass is None else next(
            (n for f, n in sass.items()
             if (m := re.search(r"kjma_point_kernelILb([01])ELb([01])E", f))
             and _point_kernel_name(*m.groups()) == k["kernel"]), None)
    check(sorted(k["kernel"] for k in bk_kernels)
          == ["bounce_classify_kernel", "bounce_latency_probe_kernel",
              "bounce_shoot_serial_kernel", "bounce_tree_kernel"],
          f"ptxas reported the tree, serial, classify and probe kernels, got {bk_kernels}")
    emit({"phase": "build", "wall_seconds": wall, "sources": [
        {"source": "bdlz_tpu_torch/csrc/" + kjma_kernel.POINT_SOURCE, "seconds": point.seconds,
         "cached": point.cached, "dynamic_smem_bytes": TABLE_N * 8 + 32 * 8,
         "f64_instructions_per_node_counted": POINT_F64_INSTR_PER_NODE,
         "kernels": pk_kernels},
        {"source": "bdlz_tpu_torch/csrc/" + bounce_kernel.SOURCE, "seconds": bounce.seconds,
         "cached": bounce.cached, "kernels": bk_kernels},
        {"source": "bdlz_tpu_torch/csrc/" + bloch_kernel.SOURCE, "seconds": bloch.seconds,
         "cached": bloch.cached, "kernels": bl_kernels,
         "ptxas_log": bloch.ptxas_log}]})


def _stream_rel(got, ref) -> float:
    """Largest per-node error of a stream kernel relative to its row's
    largest node; the plain version's zeros (empty windows, nodes past the
    cut) must be exactly 0 in the kernel too."""
    zero = ref == 0
    check(torch.equal(got[zero], ref[zero]), "the kernel's zeros are the plain version's")
    scale = ref.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
    return ((got - ref).abs() / scale).max().item()


def phase_parity(dev) -> tuple:
    """The stream tiers' kernels P2 and P4 against their plain versions,
    node by node, on a grid of P=8192 points whose windows cross T = m/3
    (n_y=8000, n=16384), and bitwise run to run."""
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
    scalars = kk.point_scalars(pp, base.chi_stats, table, N_Y)
    # windows that hold both branches: T(y_hi) < m/3 < T(y_lo)
    y_lo, y_hi = quadrature_bounds(pp)
    m3 = pp.m_chi_GeV / 3.0
    both = int(((T_of_y(y_hi, pp.T_p_GeV, pp.beta_over_H) < m3)
                & (m3 < T_of_y(y_lo, pp.T_p_GeV, pp.beta_over_H))).sum())
    check(both > 0, "the parity grid crosses T = m/3 inside some windows")
    errs = {}
    for name in STREAM_KERNELS:
        fn, plain = getattr(kk, name), getattr(kk, name + "_plain")
        got = fn(scalars, table, N_Y)
        torch.cuda.synchronize()
        ref = plain(scalars, table, N_Y)
        check(got.shape == ref.shape == (N_POINTS, N_Y) and bool(torch.isfinite(got).all()),
              f"{name}: finite, shape {tuple(got.shape)}")
        rel = _stream_rel(got, ref)
        check(rel <= STREAM_RTOL, f"{name}: kernel vs plain per node {rel:.3e} <= {STREAM_RTOL:g}")
        nodes_bitwise = float((got == ref).double().mean().item())
        check(torch.equal(got, fn(scalars, table, N_Y)), f"{name}: bitwise reproducible")
        errs[name] = {"max_abs_err": (got - ref).abs().max().item(), "max_rel_err": rel,
                      "rtol": STREAM_RTOL, "share_of_nodes_bitwise": nodes_bitwise}
        del got, ref
    emit({"phase": "parity", "points": N_POINTS, "n_y": N_Y, "table_n": TABLE_N,
          "points_with_seam_in_window": both, "bitwise_reproducible": True,
          "kernels": errs})
    return table, errs, pp


def _main_chunk(dev):
    """The main grid's first chunk (8192 points) as device PointParams."""
    from bdlz_tpu_torch.config import config_from_dict
    from bdlz_tpu_torch.interop import point_params_from_numpy
    from bdlz_tpu_torch.parallel.sweep import build_grid

    grid = build_grid(config_from_dict(ARCHIVED), MAIN_AXES)
    return point_params_from_numpy(type(grid)(*(f[:N_POINTS] for f in grid)), dev)


def _set_window(s, lo, hi):
    """The scalar rows ``s`` with every window set to [lo, hi] by hand."""
    from bdlz_tpu_torch.ops import kjma_kernel as kk

    s = s.clone()
    s[:, kk._COL["y_lo"]], s[:, kk._COL["y_hi"]] = lo, hi
    return s


def _point_rel(got, ref) -> float:
    """Largest relative error per point; rows whose plain sum is 0 (empty
    windows, nodes past the cut) must be exactly 0 in the kernel too."""
    zero = ref == 0
    check(torch.equal(got[zero], ref[zero]), "the kernel's zeros are the plain version's")
    if bool(zero.all()):
        return 0.0
    return ((got - ref).abs() / ref.abs())[~zero].max().item()


def phase_point_parity(dev, parity_pp, table) -> dict:
    """The point kernels P1-P4 against their plain versions on the card
    (the sums per point, the stream kernels' rows per node): over the main
    grid's first chunk (8192 x 8000), the parity grid (seam-crossing
    windows), the 1024-point audit population, and edge cases (empty,
    reversed and clipped windows; windows across and above y = 50 on the
    F table and on a table of ones, where the stream kernels' nodes above
    50 must be exactly 0; n_y at its floor of 2000; P = 1, P = 0 and
    P = 133); bitwise reproducible run to run; and each reduce tier's Y_B
    against its stream tier's.  Returns each kernel's errors on the main
    chunk."""
    import dataclasses

    from bdlz_tpu_torch.config import config_from_dict
    from bdlz_tpu_torch.interop import point_params_from_numpy
    from bdlz_tpu_torch.ops import kjma_kernel as kk
    from bdlz_tpu_torch.parallel.sweep import build_grid
    from bdlz_tpu_torch.validation import build_audit_population

    t0 = time.perf_counter()
    base = config_from_dict(ARCHIVED)
    main = kk.point_scalars(_main_chunk(dev), base.chi_stats, table, N_Y)
    parity = kk.point_scalars(parity_pp, base.chi_stats, table, N_Y)
    audit = kk.point_scalars(point_params_from_numpy(
        build_audit_population(base, N_GATE).grid, dev), base.chi_stats, table, N_Y)
    empty = []
    for lo, hi, B in ((5.0, 4.0, 100.0), (4.0, 5.0, 400.0), (1.0, 1.0, 100.0),
                      (0.01, 0.05, 100.0)):
        cfg = dataclasses.replace(base, T_min_over_Tp=lo, T_max_over_Tp=hi, beta_over_H=B)
        empty.append(kk.point_scalars(point_params_from_numpy(
            build_grid(cfg, {"m_chi_GeV": [0.95, 3.0, 500.0]}), dev), cfg.chi_stats, table, N_Y))
    empty = torch.cat(empty)
    check(not bool((empty[:, kk._COL["y_hi"]] > empty[:, kk._COL["y_lo"]]).any()),
          "the empty-window rows are empty")
    ones = table._replace(values=torch.ones_like(table.values))
    edges = torch.cat([empty, _set_window(parity[:64], 40.0, 60.0),
                       _set_window(parity[:64], 51.0, 60.0)]).contiguous()
    floor = kk.point_scalars(parity_pp, base.chi_stats, table, 2000)
    cases = {  # name: (scalars, table, n_y)
        "main_chunk": (main, table, N_Y), "parity_grid": (parity, table, N_Y),
        "audit_population": (audit, table, N_Y), "edges": (edges, table, N_Y),
        "edges_table_of_ones": (edges, ones, N_Y), "n_y_floor": (floor, table, 2000),
        "one_point": (main[:1], table, N_Y), "no_point": (main[:0], table, N_Y),
        "133_points": (parity[:133], table, N_Y)}
    above_cut = kk._nodes(edges, ones, N_Y).y > Y_CUT
    out, errs = {}, {}
    for name in POINT_KERNELS:
        fn, plain = getattr(kk, name), getattr(kk, name + "_plain")
        stream = name in STREAM_KERNELS
        tol = STREAM_RTOL if stream else POINT_RTOL
        rows = {}
        for case, (sc, tab, n_y) in cases.items():
            kk.reset_launches()
            got = fn(sc, tab, n_y)
            torch.cuda.synchronize()
            check(kk.LAUNCHES[name] == (1 if sc.shape[0] else 0),
                  f"{name} {case}: one launch, got {kk.LAUNCHES}")
            ref = plain(sc, tab, n_y)
            shape = (sc.shape[0], max(n_y, 2000)) if stream else (sc.shape[0],)
            check(got.shape == ref.shape == shape and bool(torch.isfinite(got).all()),
                  f"{name} {case}: finite, shape {tuple(got.shape)}")
            rel = 0.0 if not sc.shape[0] else (_stream_rel(got, ref) if stream
                                               else _point_rel(got, ref))
            check(rel <= tol, f"{name} {case}: kernel vs plain {rel:.3e} <= {tol:g}")
            # the rows that sum to 0 (stream: whose every node is 0)
            zero_rows = (ref == 0).all(dim=-1) if stream else ref == 0
            rows[case] = {"points": int(sc.shape[0]), "n_y": n_y, "max_rel_err": rel,
                          "zeros": int(zero_rows.sum()),
                          "max_abs_err": (got - ref).abs().max().item() if sc.shape[0] else 0.0}
            if stream and case == "edges_table_of_ones":
                check(bool((got[above_cut] == 0).all()) and bool((got[~above_cut] != 0).any()),
                      f"{name}: every node above y = 50 is exactly 0")
            if case == "main_chunk":
                errs[name] = rows[case]
            del got, ref
        check(torch.equal(fn(main, table, N_Y), fn(main, table, N_Y)),
              f"{name} bitwise reproducible run to run")
        check(rows["edges_table_of_ones"]["zeros"] == empty.shape[0] + 64,
              f"{name}: the empty windows and the windows above y = 50 sum to 0 "
              f"on the table of ones, got {rows['edges_table_of_ones']['zeros']} zeros")
        out[name] = rows
    # each reduce tier against its stream tier, Y_B on the main chunk
    pp = _main_chunk(dev)
    route = {}
    for fuse_exp in (False, True):
        got = kk.integrate_YB_kernel(pp, base.chi_stats, table, N_Y, fuse_exp=fuse_exp)
        ref = kk.integrate_YB_kernel(pp, base.chi_stats, table, N_Y, fuse_exp=fuse_exp,
                                     reduce=False)
        rel = ((got - ref).abs() / ref.abs()).max().item()
        check(rel <= ROUTE_RTOL, f"reduce tier vs stream tier (fuse_exp={fuse_exp}) "
              f"{rel:.3e} <= {ROUTE_RTOL:g}")
        route[f"fuse_exp={fuse_exp}"] = rel
    emit({"phase": "point_parity", "rtol": POINT_RTOL, "stream_rtol": STREAM_RTOL,
          "kernels": out, "reduce_tier_vs_stream_tier_max_rel": route,
          "bitwise_reproducible": True, "seconds": time.perf_counter() - t0})
    return errs


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
    launches, runs = dict.fromkeys(kk.LAUNCHES, 0), {}
    for name, (fuse_exp, reduce) in TIERS.items():
        kernel = TIER_KERNEL[name]
        torch.cuda.reset_peak_memory_stats(dev)
        kk.reset_launches()
        res = run_sweep(base, MAIN_AXES, static, impl="kernel", fuse_exp=fuse_exp,
                        reduce=reduce, **kw)
        counts = dict(kk.LAUNCHES)
        launches[kernel] = counts[kernel]
        ratio = res.outputs["DM_over_B"]
        check(res.n_points == 32768 and res.chunks == 4, f"{name}: 32768 points in 4 chunks")
        check(bool(np.isfinite(ratio).all()) and res.n_failed == 0, f"{name}: all finite")
        check(counts == {k: (4 if k == kernel else 0) for k in counts},
              f"{name}: 4 launches of {kernel} and none of the others, got {counts}")
        rel = float(np.max(np.abs(ratio - ref_ratio) / np.abs(ref_ratio)))
        check(rel <= SWEEP_RTOL, f"{name}: sweep vs tabulated {rel:.3e} <= {SWEEP_RTOL:g}")
        runs[name] = {"kernel": kernel, "launches": counts[kernel], "seconds": res.seconds,
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


def _point_bound(scalars, n_y, stream: bool) -> dict:
    """The least time of a point kernel on these rows: the operations of
    the nodes of non-empty windows (empty ones compute nothing) over the
    FP64 instruction rate, against the bytes (scalars and table read once;
    one sum per point written, or 8 B per node by a stream kernel) over
    HBM's rate."""
    from bdlz_tpu_torch.ops import kjma_kernel as kk

    P = int(scalars.shape[0])
    nonempty = int((scalars[:, kk._COL["y_hi"]] > scalars[:, kk._COL["y_lo"]]).sum())
    n_bytes = P * len(kk.POINT_COLUMNS) * 8 + TABLE_N * 8 + (P * n_y * 8 if stream else P * 8)
    instr = nonempty * n_y * POINT_F64_INSTR_PER_NODE
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = instr / FP64_INSTR_PER_S * 1e3
    return {"bytes": n_bytes, "f64_instructions": instr, "nonempty_points": nonempty,
            "bytes_ms": bytes_ms, "operations_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_timing(dev, table) -> dict:
    """Kernel and plain times on the main grid's first chunk (8192 points,
    n_y 8000; CUDA events), each kernel's bound, ``point_scalars``' time,
    and each tier's device ms per chunk: ``point_scalars`` + the kernel
    (+ the host's row sum for the stream tiers), and the whole
    ``integrate_YB_kernel`` call timed alone with its peak memory; then
    the main grid's rate through the default tier."""
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.ops import kjma_kernel as kk
    from bdlz_tpu_torch.parallel.sweep import run_sweep

    base = config_from_dict(ARCHIVED)
    chunk = _main_chunk(dev)
    scalars = kk.point_scalars(chunk, base.chi_stats, table, N_Y)
    scalars_ms = float(np.median(_cuda_ms(
        lambda: kk.point_scalars(chunk, base.chi_stats, table, N_Y), 20)))
    out = {}
    for name in POINT_KERNELS:
        stream = name in STREAM_KERNELS
        fn, plain = getattr(kk, name), getattr(kk, name + "_plain")
        bound = _point_bound(scalars, N_Y, stream)
        samples = _cuda_ms(lambda: fn(scalars, table, N_Y), 20)
        ms = float(np.median(samples))
        row = {"ms": ms, "ms_samples": samples,
               "plain_ms": float(np.median(_cuda_ms(lambda: plain(scalars, table, N_Y), 3))),
               **bound, "bound_share": bound["bound_ms"] / ms,
               "achieved_f64_instr_per_s": bound["f64_instructions"] / (ms * 1e-3)}
        if stream:
            rows = fn(scalars, table, N_Y)
            row["achieved_write_bytes_per_s"] = rows.numel() * 8 / (ms * 1e-3)
            row["host_sum_ms"] = float(np.median(_cuda_ms(lambda: rows.sum(dim=-1), 20)))
            del rows
        row["device_ms_per_chunk"] = scalars_ms + ms + row.get("host_sum_ms", 0.0)
        out[name] = row
    tiers = {}
    for tier, (fuse_exp, reduce) in TIERS.items():
        torch.cuda.synchronize()
        start_mem = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        call_ms = _cuda_ms(lambda: kk.integrate_YB_kernel(
            chunk, base.chi_stats, table, N_Y, fuse_exp=fuse_exp, reduce=reduce), 10)
        tiers[tier] = {"kernel": TIER_KERNEL[tier],
                       "device_ms_per_chunk": out[TIER_KERNEL[tier]]["device_ms_per_chunk"],
                       "integrate_ms_per_chunk": float(np.median(call_ms)),
                       "integrate_ms_samples": call_ms,
                       "integrate_peak_mem_above_start_bytes":
                           torch.cuda.max_memory_allocated(dev) - start_mem}
    static = static_choices_from_config(base)
    kw = dict(impl="kernel", chunk_size=N_POINTS, n_y=N_Y, table_nodes=TABLE_N, device=dev)
    sweep_pps = [run_sweep(base, MAIN_AXES, static, **kw).points_per_sec for _ in range(5)]
    emit({"phase": "timing", "points": N_POINTS, "n_y": N_Y, "kernels": out, "tiers": tiers,
          "point_scalars_ms_per_chunk": scalars_ms,
          "sweep_points_per_sec_median": float(np.median(sweep_pps)),
          "sweep_points_per_sec_samples": sweep_pps,
          "peak_hbm_bytes_per_s": HBM_BYTES_PER_S, "peak_fp64_flop_per_s": FP64_FLOP_PER_S,
          "fp64_instr_per_s": FP64_INSTR_PER_S})
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


def _launches_around(fn):
    """``fn()`` with every kernel's launch count set to 0 just before and
    read just after: (result, counts)."""
    from bdlz_tpu_torch.ops import bloch_kernel as lk
    from bdlz_tpu_torch.ops import bounce_kernel as bk
    from bdlz_tpu_torch.ops import kjma_kernel as kk

    kk.reset_launches()
    bk.reset_launches()
    lk.reset_launches()
    out = fn()
    return out, {**kk.LAUNCHES, **{"bounce_" + k: v for k, v in bk.LAUNCHES.items()},
                 **lk.LAUNCHES}


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
        base, STIFF_AXES, static, chunk_size=n_points, impl="kernel", device=dev))
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
        res_p = run_sweep(base, STIFF_AXES, static, chunk_size=n_points, impl="kernel",
                          device=dev)
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


def _shoot_bitwise(a, b) -> bool:
    """Every ``ShootOut`` field of two shoots bit for bit (NaN where NaN)."""
    return all(torch.equal(x.view(torch.int64), y.view(torch.int64))
               if x.is_floating_point() else torch.equal(x, y) for x, y in zip(a, b))


def phase_bounce_path(dev) -> dict:
    """The O(4) bounce shoot: the classify and dense kernels against the
    plain version on the card, the full-knob shoot (one tree-kernel launch)
    against the JAX package's reference shoot, the audit, a 64-spec batch
    against the loop of single shoots, the tree kernel against the
    one-thread-per-lane kernel bit for bit, the f64 latencies, and the
    times with the tree's and the serial shoot's bounds."""
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
    check(counts["bounce_shoot"] == 1 and counts["bounce_shoot_serial"] == 0
          and counts["bounce_classify"] == 0,
          f"one tree-kernel launch per solve_bounce and no other, got {counts}")
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

    # 6. the tree kernel against the one-thread-per-lane kernel, every
    # field bit for bit: the reference shoot (at the derived depth and at
    # depth 4) and the 64-spec batch in one launch each
    pb = torch.as_tensor(np.stack([_params_row(s) for s in specs]), dtype=torch.float64,
                         device=dev)
    tree, tree_stats = bk.bounce_shoot(p1, knobs, stats=True)
    tree4 = bk.bounce_shoot(p1, knobs, depth=4)
    serial = bk.bounce_shoot_serial(p1, knobs)
    tree_b, stats_b = bk.bounce_shoot(pb, knobs, stats=True)
    serial_b = bk.bounce_shoot_serial(pb, knobs)
    torch.cuda.synchronize()
    for name, a, b in (("reference", tree, serial), ("reference at depth 4", tree4, serial),
                       ("64-spec batch", tree_b, serial_b)):
        check(_shoot_bitwise(a, b), f"tree == serial kernel bit for bit, {name}")
    plan = {w: bk.tree_plan(w, knobs.n_bisect, dev) for w in (1, len(specs))}
    crit, total, depth, rounds = (int(v) for v in tree_stats[0].tolist())
    steps = int(serial.steps.item())
    check(depth == plan[1]["depth"] and rounds == -(-knobs.n_bisect // depth),
          f"depth {depth} and rounds {rounds} as planned ({plan[1]})")
    check(crit <= steps <= total, f"critical {crit} <= serial {steps} <= total {total} steps")
    check(bool((stats_b[:, 0] <= serial_b.steps).all()
               and (serial_b.steps <= stats_b[:, 1]).all()),
          "64-spec batch: critical <= serial <= total steps per lane")

    # 7. times: the tree and the serial shoot, and one plain classify (CUDA
    # events); the f64 latencies and the bounds they give
    one = _cuda_ms(lambda: bk.bounce_shoot(p1, knobs), 1, repeats=3)
    one_serial = _cuda_ms(lambda: bk.bounce_shoot_serial(p1, knobs), 1, repeats=3)
    batch_tree = _cuda_ms(lambda: bk.bounce_shoot(pb, knobs), 1, repeats=3)
    batch_serial = _cuda_ms(lambda: bk.bounce_shoot_serial(pb, knobs), 1, repeats=3)
    # the depth's trade: fewer rounds against more warps per SM
    depth_ms = {d: _cuda_ms(lambda d=d: bk.bounce_shoot(p1, knobs, depth=d), 1, repeats=1)[0]
                for d in (3, 6)}
    # the plain version is eager: one timed classify, no warm-up
    mid = torch.as_tensor([points[-2]], dtype=torch.float64, device=dev)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    classify_plain(p1, mid, knobs)
    stop.record()
    torch.cuda.synchronize()
    plain_classify = [start.elapsed_time(stop)]
    clock = _sm_clock_hz()
    lat = bk.f64_latency_probe(dev, PROBE_REPS)
    # adds and multiplies share one count: the larger of the two latencies
    per_op = dict(lat, add=max(lat["add"], lat["mul"]))
    step_cycles = sum(n * per_op[op] for op, n in STEP_CHAIN.items())
    dense_ms = knobs.n_dense * sum(n * per_op[op] for op, n in DENSE_CHAIN.items()) / clock * 1e3
    bound_ms = crit * step_cycles / clock * 1e3 + dense_ms
    serial_bound_ms = steps * step_cycles / clock * 1e3 + dense_ms
    assumed_bound_ms = steps * ASSUMED_OPS_PER_STEP * ASSUMED_LATENCY_CYCLES / clock * 1e3
    ms, serial_ms = float(np.median(one)), float(np.median(one_serial))
    timing = {"ms": ms, "ms_samples": one, "plain_ms": plain_classify[0],
              "plain_is": "one classify of one release point 1e-7 of the bracket from phi0",
              "bound_ms": bound_ms, "bound_by": "operations",
              "serial_ms": serial_ms, "serial_ms_samples": one_serial,
              "serial_bound_ms": serial_bound_ms,
              "serial_bound_ms_at_assumed_latency": assumed_bound_ms,
              "fraction_of_bound": bound_ms / ms,
              "serial_fraction_of_serial_bound": serial_bound_ms / serial_ms,
              "tree_fraction_of_serial_bound": serial_bound_ms / ms,
              "depth": depth, "rounds": rounds, "critical_path_steps": crit,
              "total_steps": total, "attempted_steps": steps,
              "segment_solves": int(serial.segments.item()), "plan": plan,
              "f64_latency_cycles": lat, "step_chain": STEP_CHAIN,
              "step_chain_cycles": step_cycles, "dense_chain": DENSE_CHAIN,
              "dense_bound_ms": dense_ms, "sm_clock_hz": clock,
              "ms_at_depth": depth_ms,
              "batch_64_tree_ms": float(np.median(batch_tree)),
              "batch_64_serial_ms": float(np.median(batch_serial)),
              "batch_64_critical_steps_max": int(stats_b[:, 0].max()),
              "batch_64_total_steps": int(stats_b[:, 1].sum())}
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
          "tree_vs_serial_bitwise": {"reference": True, "reference_depth_4": True,
                                     "batch_64_all_fields": True},
          "timing": timing})
    return {"launches": counts["bounce_shoot"], "max_abs_err": max(classify_abs, dense_abs),
            **timing, "solution": sol}


# The local-momentum pre-pass is a host loop over every (v_w, T_p, m_chi)
# point (~44 s per 32768-point sweep, paid by the P1 run and by its
# tabulated reference); its sweeps run every fourth m_chi, one 8192-point
# chunk, to keep the whole script near ten minutes.
LM_AXES = dict(MAIN_AXES, m_chi_GeV=MAIN_AXES["m_chi_GeV"][::4])
LZ_BATH = (0.001, 50.0)  # the thermal scenario's η and ω_c (GeV)
LZ_METHODS = {  # sweep estimators and scenarios of the lz_path sweeps
    "local": ({}, {"lz_method": "local"}),
    "coherent": ({}, {"lz_method": "coherent"}),
    "local-momentum": ({}, {"lz_method": "local-momentum"}),
    "dephased": ({}, {"lz_method": "dephased", "lz_gamma_phi": 0.01}),
    "chain": ({"lz_mode": "chain", "lz_n_levels": 3}, {}),
    "thermal": ({"lz_mode": "thermal", "lz_bath_eta": LZ_BATH[0],
                 "lz_bath_omega_c": LZ_BATH[1]}, {}),
}


def _dephased_passes(name: str, axes: dict) -> int:
    """The dephased transport passes an lz_path sweep makes, each one
    launch of the kernel: one for the dephased estimator; for the thermal
    scenario one for every lane with Γ_φ > 0 of the grid's T_p together,
    whatever its rates (its Γ_φ = 0 lanes, if any, make one coherent pass
    of their own, which launches no transport kernel); none for the
    others."""
    if name == "dephased":
        return 1
    if name != "thermal":
        return 0
    from bdlz_tpu_torch.lz.thermal import thermal_gamma_phi

    gam = np.asarray(thermal_gamma_phi(axes["T_p_GeV"], *LZ_BATH))
    return int(bool(np.any(gam > 0.0)))


def phase_lz_path(dev, sol, kernel_pps: float) -> int:
    """The LZ layer at full width: the P-tables at their default sizes over
    the kernel-shot reference profile (801 samples) and over a
    1,000,001-sample profile of the same wall (profiled), the sweep with
    the shot bounce through each estimator and scenario against the
    tabulated engine, and the table on the card against the CPU.  Returns
    the dephased transport kernel's launches in those sweeps."""
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
    sweeps, bloch_launches = {}, 0
    bounce = dict(spec._asdict())
    for name, (cfg_over, kw) in LZ_METHODS.items():
        base = config_from_dict(dict(ARCHIVED, **cfg_over))
        static = static_choices_from_config(base)
        common = dict(chunk_size=N_POINTS, n_y=N_Y, table_nodes=TABLE_N, device=dev,
                      bounce=bounce, **kw)
        axes = LM_AXES if name == "local-momentum" else MAIN_AXES
        n_points = int(np.prod([len(v) for v in axes.values()]))
        res, counts = _launches_around(lambda: run_sweep(base, axes, static,
                                                         impl="kernel", **common))
        check(res.n_points == n_points and res.n_failed == 0,
              f"{name}: {n_points} finite points")
        check(counts[MAIN_KERNEL] == n_points // N_POINTS and counts["bounce_shoot"] == 1,
              f"{name}: P1 launched once per chunk and the shoot once, got {counts}")
        passes = _dephased_passes(name, axes)
        check(counts["bloch"] == passes,
              f"{name}: the transport kernel once per dephased pass ({passes}), got {counts}")
        bloch_launches += counts["bloch"]
        ref = run_sweep(base, axes, static._replace(quad_panel_gl=False),
                        impl="tabulated", **common)
        rel = _max_rel(res.outputs["DM_over_B"], ref.outputs["DM_over_B"])
        check(rel <= LZ_SWEEP_RTOL, f"{name}: kernel vs tabulated {rel:.3e}")
        check("bounce" in res.lz_identity, f"{name}: the potential keys the sweep")
        sweeps[name] = {"points": n_points, "points_per_sec": res.points_per_sec,
                        "sweep_seconds": res.seconds,
                        "lz_prepass_seconds": res.lz_seconds, "launches": counts,
                        "max_rel_vs_tabulated": rel, "lz_identity": res.lz_identity}
    emit({"phase": "lz_path", "seconds": time.perf_counter() - t0, "tables": tables,
          "profile_1000001": {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                              "device_busy_share": busy_ms / wall_ms,
                              "top_device_ms": dict(top)},
          "table_card_vs_cpu_64_nodes_max_rel": card_cpu,
          "sweeps": sweeps, "plain_P_kernel_tier_points_per_sec": kernel_pps})
    return bloch_launches


# The dephased transport's least work (benchmark/harness/dephase_work.py,
# frozen there): f64 instructions per lane-segment.
BLOCH_F64_INSTR_PER_LANE_SEGMENT = 79
# The cell bounce_lz_dephased.scan's pass: its 128 bath rates (T_p
# geom(30, 300, 128)) × 1024 speeds in one launch, and a scalar-rate
# launch of its 1024 speeds at one rate.
BLOCH_RATES, BLOCH_SPEEDS, BLOCH_RATE = 128, 1024, 0.07


def _kernel_device_ms(fn, name: str, reps: int = 20, repeats: int = 5) -> list:
    """Per-launch device ms of the kernels whose name holds ``name``, from
    the profiler's device events over ``reps`` calls of ``fn``, for each of
    ``repeats`` windows: the card's time alone, where CUDA events around
    back-to-back calls would time the host's calls once a kernel is
    shorter than its wrapper (~36 µs a call on an H100).  Each window's
    time is over the launches it recorded (late in a long process a
    window may drop some); a window that recorded none is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and name in e.key]
        if sum(e.count for e in evs):
            out.append(sum(e.self_device_time_total for e in evs) / 1e3
                       / sum(e.count for e in evs))
    return out


def _bloch_bound_ms(lanes: int, n_seg: int) -> float:
    """The transport's least ms for ``lanes`` lanes over ``n_seg``
    segments: the frozen count's operations, or the segments read once
    and each lane's v, Γ and r (4 f64) moved once."""
    ops = lanes * n_seg * BLOCH_F64_INSTR_PER_LANE_SEGMENT
    return 1e3 * max(ops / FP64_INSTR_PER_S, (n_seg * 3 + lanes * 4) * 8 / HBM_BYTES_PER_S)


def phase_bloch_path(dev, main_launches=None) -> dict:
    """The dephased transport's kernel at the benchmark cell's shape (the
    shot reference profile's 800 segments): the cell's one pass a sweep,
    its 128 bath rates × 1024 speeds = 131,072 lanes in one launch at a
    rate per lane, checked against the plain tree on the card at the same
    lanes (chunked as a pass chunks it) and bit for bit against one launch
    per rate; and one rate's 1024 speeds against the tree.  Each shape's
    device time (median of 5×20 launches, the profiler's device events)
    and bound from the frozen count; the plain tree's time at each shape
    (not a yardstick of speed).  The row is the cell's pass; its
    ``launches`` are ``main_launches``, the main path's (the timed
    launches are the phase's own)."""
    from bdlz_tpu_torch.bounce import bounce_profile, reference_potential
    from bdlz_tpu_torch.lz import kernel as lk
    from bdlz_tpu_torch.lz.thermal import thermal_gamma_phi
    from bdlz_tpu_torch.ops import bloch_kernel as bk

    t0 = time.perf_counter()
    prof = bounce_profile(reference_potential(), device=dev)
    a, b, dxi = lk._segment_hamiltonians(prof, dev)
    n_seg = int(a.shape[0])
    v = torch.linspace(0.05, 0.95, BLOCH_SPEEDS, dtype=torch.float64, device=dev)
    v_g = torch.full_like(v, BLOCH_RATE)
    bk.reset_launches()
    err_1024 = float((bk.bloch_transport(a, b, dxi, v, v_g)
                      - lk.propagate_bloch_plain(a, b, dxi, v, v_g)).abs().max())
    check(err_1024 <= 1e-12, f"bloch kernel vs the tree at one rate: {err_1024:.3e}")
    rates = thermal_gamma_phi(np.geomspace(30.0, 300.0, BLOCH_RATES), *LZ_BATH)
    lane_v = v.repeat(BLOCH_RATES)
    lane_g = torch.as_tensor(np.repeat(rates, BLOCH_SPEEDS), dtype=torch.float64, device=dev)
    per_speed = lk.staged_bytes_per_speed("dephased", n_seg, "cpu")  # the tree's leaves

    def plain_pass():  # (lanes, 3): the chunks' rows in order
        return lk.over_speed_chunks(lambda sp, g: lk.propagate_bloch_plain(a, b, dxi, sp, g),
                                    lane_v, per_speed, lanes=(lane_g,))

    one = bk.bloch_transport(a, b, dxi, lane_v, lane_g)
    err = float((one - plain_pass()).abs().max())
    check(err <= 1e-12, f"bloch kernel vs the tree at the cell's lanes: {err:.3e}")
    per_rate = torch.cat([lk.propagate_bloch(a, b, dxi, v, float(g)) for g in rates])
    check(torch.equal(one, per_rate), "one launch at a rate per lane is the per-rate launches")

    samples = _kernel_device_ms(lambda: bk.bloch_transport(a, b, dxi, lane_v, lane_g),
                                "bloch_transport_kernel")
    samples_1024 = _kernel_device_ms(lambda: bk.bloch_transport(a, b, dxi, v, v_g),
                                     "bloch_transport_kernel")
    check(bool(samples) and bool(samples_1024), "the profiler recorded the transport kernel")
    timed_launches = bk.LAUNCHES["bloch"]
    check(timed_launches == 1 + 1 + BLOCH_RATES + 2 * (1 + 5 * 20),
          f"bloch launches counted, got {timed_launches}")
    plain_samples = _cuda_ms(plain_pass, 1, repeats=3)
    plain_1024 = _cuda_ms(lambda: lk.propagate_bloch_plain(a, b, dxi, v, v_g), 20)
    lanes = BLOCH_RATES * BLOCH_SPEEDS
    bound_ms, bound_1024 = _bloch_bound_ms(lanes, n_seg), _bloch_bound_ms(BLOCH_SPEEDS, n_seg)
    ms, ms_1024 = float(np.median(samples)), float(np.median(samples_1024))
    row = {"name": bk.KERNELS["bloch"][0], "route": "cuda",
           "source": "bdlz_tpu_torch/csrc/" + bk.SOURCE, "replaces": bk.KERNELS["bloch"][1],
           "launches": main_launches, "max_abs_err": err, "ms": ms,
           "plain_ms": float(np.median(plain_samples)), "bound_ms": bound_ms,
           "bound_by": "operations", "library_ms": None}
    emit({"phase": "bloch_path", "seconds": time.perf_counter() - t0,
          "lanes": lanes, "rates": BLOCH_RATES, "speeds": BLOCH_SPEEDS, "segments": n_seg,
          "timed_launches": timed_launches, "ms_samples": samples,
          "plain_ms_samples": plain_samples,
          "f64_instructions": lanes * n_seg * BLOCH_F64_INSTR_PER_LANE_SEGMENT,
          "bound_share": bound_ms / ms,
          "one_rate": {"gamma_phi": BLOCH_RATE, "max_abs_err": err_1024,
                       "ms_samples": samples_1024, "bound_ms": bound_1024,
                       "bound_share": bound_1024 / ms_1024, "plain_ms_samples": plain_1024},
          "kernel": row})
    return row


def _bitwise(a: dict, b: dict, keep=None) -> bool:
    """Every output field bit for bit (optionally on the points ``keep``)."""
    return all(np.array_equal(a[f] if keep is None else a[f][keep],
                              b[f] if keep is None else b[f][keep], equal_nan=True)
               for f in b)


def _events(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


POISON_POINT, NAN_POINT = 12345, 777  # global grid indices of the injected faults


def phase_robust_path(dev) -> None:
    """The main grid at full width through P1 into a sweep directory with
    an event log: a clean run and its resume; a torn chunk file and its
    resume; a transient step fault; a poison point bisected into
    quarantine; a NaN point; a chunk store run cold, then warm."""
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.faults import FaultPlan
    from bdlz_tpu_torch.parallel.sweep import heal_budget, run_sweep
    from bdlz_tpu_torch.provenance import Store
    from bdlz_tpu_torch.utils.logging import EventLog
    from bdlz_tpu_torch.utils.retry import resolve_engine_retry

    t0 = time.perf_counter()
    base = config_from_dict(ARCHIVED)
    static = static_choices_from_config(base)
    kw = dict(impl="kernel", chunk_size=N_POINTS, n_y=N_Y, table_nodes=TABLE_N, device=dev)
    n_total = int(np.prod([len(v) for v in MAIN_AXES.values()]))
    n_chunks = -(-n_total // N_POINTS)
    work = tempfile.mkdtemp(prefix="bdlz_robust_")
    wall, out = {}, {}

    def run(name, **extra):
        t1 = time.perf_counter()
        res, counts = _launches_around(lambda: run_sweep(base, MAIN_AXES, static, **kw, **extra))
        wall[name] = time.perf_counter() - t1
        return res, counts[MAIN_KERNEL]

    try:
        d = os.path.join(work, "sweep")
        clean, p1 = run("clean", out_dir=d,
                        event_log=EventLog(path=os.path.join(work, "clean.jsonl")))
        check(clean.n_points == n_total and clean.chunks == n_chunks == 4 and p1 == 4,
              f"clean: {n_total} points in 4 chunks, 4 P1 launches, got {p1}")
        check(clean.n_failed == 0 and clean.n_quarantined == 0 and clean.n_retries == 0,
              "clean: no failure, quarantine or retry")
        ev = [e["event"] for e in _events(os.path.join(work, "clean.jsonl"))]
        check(ev == ["sweep_start"] + ["chunk_done"] * 4, f"clean events {ev}")
        resumed, p1 = run("resume", out_dir=d)
        check(resumed.resumed_chunks == 4 and p1 == 0, f"resume: 4 chunks, 0 P1, got {p1}")
        check(_bitwise(resumed.outputs, clean.outputs), "resume: bitwise the clean run")
        out["resume"] = {"resumed_chunks": resumed.resumed_chunks, "p1_launches": p1}

        # a torn chunk file, then a resume under the same (spent) plan
        torn = FaultPlan.from_obj([{"site": "chunk_write", "kind": "torn", "key": 2}])
        d2 = os.path.join(work, "torn")
        run("torn_write", out_dir=d2, fault_plan=torn)
        try:
            np.load(os.path.join(d2, "chunk_00002.npz"))["DM_over_B"]
            was_torn = False
        except Exception:  # noqa: BLE001 — a torn zip fails to load
            was_torn = True
        check(was_torn, "chunk 2's file is torn")
        healed, p1 = run("torn_resume", out_dir=d2, fault_plan=torn)
        check(healed.resumed_chunks == 3 and p1 == 1,
              f"torn resume: 3 chunks resumed, chunk 2 recomputed (1 P1), got {p1}")
        check(_bitwise(healed.outputs, clean.outputs), "torn resume: bitwise the clean run")
        out["torn"] = {"resumed_chunks": healed.resumed_chunks, "p1_launches": p1}

        # a transient step fault on chunk 1, twice
        ev_path = os.path.join(work, "transient.jsonl")
        tr, p1 = run("transient", event_log=EventLog(path=ev_path), fault_plan=FaultPlan.from_obj(
            [{"site": "step", "kind": "transient", "key": 1, "times": 2}]))
        retries = [e for e in _events(ev_path) if e["event"] == "chunk_retry"]
        check(tr.n_retries == 2 and len(retries) == 2 and all(e["chunk"] == 1 for e in retries),
              f"transient: 2 retries of chunk 1, got {tr.n_retries} / {len(retries)} events")
        check(tr.n_quarantined == 0 and _bitwise(tr.outputs, clean.outputs),
              "transient: bitwise the clean run")
        out["transient"] = {"n_retries": tr.n_retries, "p1_launches": p1}

        # a poison point, bisected down to itself
        ev_path = os.path.join(work, "poison.jsonl")
        po, p1 = run("poison", event_log=EventLog(path=ev_path), fault_plan=FaultPlan.from_obj(
            [{"site": "step", "kind": "poison", "point": POISON_POINT}]))
        attempts = resolve_engine_retry(None, base, static).max_attempts
        want = np.zeros(n_total, dtype=bool)
        want[POISON_POINT] = True
        q_ev = [e for e in _events(ev_path) if e["event"] == "chunk_quarantine"]
        check(po.n_quarantined == 1 and np.array_equal(po.quarantined_mask, want)
              and np.array_equal(po.failed_mask, want),
              f"poison: only point {POISON_POINT} quarantined")
        check(_bitwise(po.outputs, clean.outputs, keep=~want), "poison: the rest bitwise clean")
        check(po.n_retries <= heal_budget(N_POINTS, attempts),
              f"poison: {po.n_retries} retries <= heal budget {heal_budget(N_POINTS, attempts)}")
        check(len(q_ev) == 1 and (q_ev[0]["lo"], q_ev[0]["hi"]) == (POISON_POINT, POISON_POINT + 1),
              f"poison: one chunk_quarantine event at {POISON_POINT}, got {q_ev}")
        out["poison"] = {"n_retries": po.n_retries, "heal_budget": heal_budget(N_POINTS, attempts),
                         "p1_launches": p1}

        # a NaN point: an ordinary failure, not a quarantine
        nan, p1 = run("nan", fault_plan=FaultPlan.from_obj(
            [{"site": "step", "kind": "nan", "point": NAN_POINT}]))
        want = np.zeros(n_total, dtype=bool)
        want[NAN_POINT] = True
        check(np.array_equal(nan.failed_mask, want) and nan.n_quarantined == 0,
              f"nan: point {NAN_POINT} failed, nothing quarantined")
        check(_bitwise(nan.outputs, clean.outputs, keep=~want), "nan: the rest bitwise clean")

        # the chunk store, cold then warm
        root = os.path.join(work, "store")
        cold, p1_cold = run("cache_cold", cache=Store(root))
        warm, p1 = run("cache_warm", cache=Store(root))
        check(cold.cache_misses == 4 and cold.cache_hits == 0 and p1_cold == 4,
              f"cold: 4 misses, got {cold.cache_hits}/{cold.cache_misses}")
        check(warm.cache_hits == 4 and warm.cache_misses == 0 and p1 == 0,
              f"warm: 4 hits, 0 P1, got {warm.cache_hits}/{warm.cache_misses}, {p1}")
        check(_bitwise(warm.outputs, cold.outputs) and _bitwise(cold.outputs, clean.outputs),
              "warm == cold == clean bitwise")
        out["cache"] = {"cold": [cold.cache_hits, cold.cache_misses],
                        "warm": [warm.cache_hits, warm.cache_misses], "p1_warm": p1}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "robust_path", "seconds": time.perf_counter() - t0, "points": n_total,
          "wall_seconds": wall, "clean_sweep_seconds": clean.seconds,
          "clean_points_per_sec": clean.points_per_sec, "checks": out})


EMU_SPEC = {  # the bench's emulator box (bench.py:1149-1160)
    "m_chi_GeV": (0.1, 10.0, 3, "log"),
    "T_p_GeV": (30.0, 300.0, 5, "log"),
    "source_shape_sigma_y": (3.0, 18.0, 5, "lin"),
    "beta_over_H": (50.0, 500.0, 5, "log"),
}
CACHE_SPEC = {"m_chi_GeV": (0.3, 3.0, 4, "log"), "T_p_GeV": (60.0, 200.0, 4, "log")}
SEAM_SPEC = {"m_chi_GeV": (20.0, 600.0, 3, "log"), "T_p_GeV": (95.0, 105.0, 2, "log")}
N_QUERIES, N_SPOT = 65536, 2048
EMU_TABLE_RTOL, QUERY_RTOL, BAND_ATOL = 1e-10, 1e-14, 1e-12


def _build_emu_box(dev):
    """The bench's 4-D box built through P1: ((artifact, report), the
    build's launch counts, seconds)."""
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.emulator import AxisSpec, build_emulator

    base = config_from_dict(ARCHIVED)
    spec = {k: AxisSpec(*v) for k, v in EMU_SPEC.items()}
    t1 = time.perf_counter()
    out, counts = _launches_around(lambda: build_emulator(
        base, spec, static_choices_from_config(base), rtol=1e-4, n_probe=48, max_rounds=25,
        n_y=N_Y, chunk_size=N_POINTS, seed=0, impl="kernel", device=dev))
    return out, counts, time.perf_counter() - t1


def phase_emulator_path(dev):
    """The emulator: the bench's 4-D box built through P1, 512 of its
    nodes against the plain tabulated engine on the CPU, save and reload,
    65,536 queries on the card (timed, against the CPU query), a spot
    check against an exact P1 sweep, the warm rebuild of the sweep-cache
    box through one store, and the seam-split bundle.  Returns the 4-D
    artifact."""
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.emulator import (
        FIELDS,
        AxisSpec,
        build_emulator,
        load_any_artifact,
        load_artifact,
        make_domain_fn,
        make_exact_evaluator,
        make_query_fn,
        save_artifact,
        seam_band_for_box,
    )
    from bdlz_tpu_torch.provenance import Store
    from bdlz_tpu_torch.validation import relative_errors

    t0 = time.perf_counter()
    base = config_from_dict(ARCHIVED)
    static = static_choices_from_config(base)
    (art, rep), counts, build_s = _build_emu_box(dev)
    build_p1 = counts[MAIN_KERNEL]
    check(build_p1 > 0, f"the build launched P1, got {counts}")
    shape = tuple(len(n) for n in art.axis_nodes)
    check(all(bool(np.all(np.isfinite(art.values[f]))) for f in FIELDS), "finite table")

    # 512 table nodes against the plain tabulated engine on the CPU
    rng = np.random.default_rng(11)
    sel = rng.choice(art.n_points, size=min(512, art.n_points), replace=False)
    idx = np.unravel_index(sel, shape)
    cols = {name: np.asarray(art.axis_nodes[k])[idx[k]] for k, name in enumerate(art.axis_names)}
    ref = make_exact_evaluator(base, static._replace(quad_panel_gl=False), n_y=N_Y,
                               impl="tabulated", chunk_size=len(sel), device="cpu")(cols)
    table_rel = max(_max_rel(art.values[f][idx], ref[f]) for f in FIELDS)
    check(table_rel <= EMU_TABLE_RTOL, f"table vs CPU tabulated {table_rel:.3e}")

    # save, reload (hash verified), reload onto the CPU
    work = tempfile.mkdtemp(prefix="bdlz_emu_")
    try:
        save_artifact(os.path.join(work, "art"), art)
        loaded = load_artifact(os.path.join(work, "art"))
        check(loaded.content_hash == art.content_hash, "reload: content hash verified")
        rng = np.random.default_rng(7)
        thetas = np.stack([
            10 ** rng.uniform(-1.0, 1.0, N_QUERIES),
            10 ** rng.uniform(np.log10(30.0), np.log10(300.0), N_QUERIES),
            rng.uniform(3.0, 18.0, N_QUERIES),
            10 ** rng.uniform(np.log10(50.0), np.log10(500.0), N_QUERIES),
        ], axis=1)
        query = make_query_fn(loaded, device=dev)
        th_dev = torch.as_tensor(thetas, dtype=torch.float64, device=dev)
        samples = _cuda_ms(lambda: query(th_dev), 1)
        q_ms = float(np.median(samples))
        card = query(th_dev).cpu().numpy()
        cpu = make_query_fn(load_artifact(os.path.join(work, "art")), device="cpu")(thetas).numpy()
        q_rel = _max_rel(card, cpu)
        check(q_rel <= QUERY_RTOL, f"card queries vs CPU {q_rel:.3e} <= {QUERY_RTOL:g}")
        check(bool(make_domain_fn(loaded, device=dev)(th_dev).all()), "every query in the box")

        # the exact path the queries replace, through P1
        spot = {name: thetas[:N_SPOT, k] for k, name in enumerate(art.axis_names)}
        evaluate = make_exact_evaluator(base, static, n_y=N_Y, impl="kernel",
                                        chunk_size=N_SPOT, device=dev)
        _, counts = _launches_around(lambda: evaluate(spot))  # builds the engine
        check(counts[MAIN_KERNEL] == 1, f"one P1 launch for the spot check, got {counts}")
        exact_samples = []
        for _ in range(3):
            t1 = time.perf_counter()
            exact = evaluate(spot)["DM_over_B"]
            exact_samples.append(time.perf_counter() - t1)
        exact_s = float(np.median(exact_samples))
        spot_rel = float(np.max(relative_errors(card[:N_SPOT], exact)))

        # the sweep-cache box, cold then warm through one store root
        cspec = {k: AxisSpec(*v) for k, v in CACHE_SPEC.items()}
        ckw = dict(rtol=1e-3, n_probe=16, max_rounds=2, n_y=N_Y, impl="kernel",
                   chunk_size=64, seed=5, device=dev)
        root = os.path.join(work, "store")
        cold_store, warm_store = Store(root), Store(root)
        t1 = time.perf_counter()
        cold, _ = build_emulator(base, cspec, static, cache=cold_store, **ckw)
        cold_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        (warm, _), counts = _launches_around(lambda: build_emulator(
            base, cspec, static, cache=warm_store, **ckw))
        warm_s = time.perf_counter() - t1
        probed = warm_store.stats.hits + warm_store.stats.misses
        hit_rate = warm_store.stats.hits / max(probed, 1)
        check(all(np.array_equal(cold.values[f], warm.values[f]) for f in FIELDS)
              and all(np.array_equal(a, b) for a, b in zip(cold.axis_nodes, warm.axis_nodes)),
              "warm rebuild bitwise the cold one")
        check(hit_rate == 1.0 and counts[MAIN_KERNEL] == 0,
              f"warm: hit rate {hit_rate}, P1 launches {counts[MAIN_KERNEL]}")

        # the seam-split bundle, default engine, on the card
        sbase = config_from_dict(dict(ARCHIVED, source_shape_sigma_y=1.5))
        sspec = {k: AxisSpec(*v) for k, v in SEAM_SPEC.items()}
        t1 = time.perf_counter()
        bundle, srep = build_emulator(
            sbase, sspec, rtol=1e-3, n_probe=6, n_holdout=24, max_rounds=6,
            max_nodes_per_axis=96, n_y=200, chunk_size=64, seed=0, device=dev,
            out_dir=os.path.join(work, "seam"))
        seam_s = time.perf_counter() - t1
        band_cpu = seam_band_for_box(sbase, sspec, rtol=1e-3, safety=2.0, device="cpu")
        check(len(getattr(bundle, "domains", ())) == 2, "the seam box splits in two domains")
        band_err = max(abs(bundle.seam_band[k] - band_cpu[k]) for k in ("lo", "hi"))
        check(band_err <= BAND_ATOL and bundle.seam_band["axis"] == band_cpu["axis"],
              f"band {bundle.seam_band} vs CPU {band_cpu}")
        reloaded = load_any_artifact(os.path.join(work, "seam"))
        check(reloaded.content_hash == bundle.content_hash, "bundle reload verified")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "emulator_path", "seconds": time.perf_counter() - t0,
          "build": {"seconds": build_s, "rounds": len(rep.rounds),
                    "n_exact_evals": rep.n_exact_evals, "grid_shape": list(shape),
                    "grid_points": art.n_points, "converged": bool(rep.converged),
                    "max_rel_err": rep.max_rel_err, "p1_launches": build_p1},
          "table_vs_cpu_tabulated_512_max_rel": table_rel,
          "query": {"n": N_QUERIES, "ms_per_batch": q_ms, "ms_samples": samples,
                    "queries_per_sec": N_QUERIES / (q_ms * 1e-3),
                    "card_vs_cpu_max_rel": q_rel},
          "spot": {"n": N_SPOT, "max_rel_err": spot_rel, "exact_seconds": exact_s,
                   "exact_seconds_samples": exact_samples,
                   "exact_points_per_sec": N_SPOT / exact_s},
          "warm_rebuild": {"cold_seconds": cold_s, "warm_seconds": warm_s,
                           "hits": warm_store.stats.hits, "misses": warm_store.stats.misses,
                           "hit_rate": hit_rate, "grid_points": cold.n_points},
          "seam": {"seconds": seam_s, "domains": len(bundle.domains), "band": bundle.seam_band,
                   "band_vs_cpu_abs": band_err, "converged": bool(srep.converged),
                   "max_rel_err": srep.max_rel_err, "n_exact_evals": srep.n_exact_evals}})
    return art


# The sampling cell: the archived config with (m_chi, P) sampled over the
# MCMC CLI docstring's box, at the CLI's defaults (64 walkers, 500 steps,
# burn 100, n_y 2000, a 16384-entry table); NUTS with 16 chains at depth 8,
# started from the stretch run's walkers.  NUTS is host-bound on the card
# (~28 ms per batched leaf, PERF.md): to keep the phase near two minutes its
# draws are cut from 300 warmup + 200 to 150 + 100; no width is cut.
SAMPLE_BOUNDS = {"m_chi_GeV": (0.05, 20.0), "P_chi_to_B": (1e-4, 1.0)}
EMU_SAMPLE_BOUNDS = {"m_chi_GeV": (0.1, 10.0), "source_shape_sigma_y": (3.0, 18.0)}
WALKERS, STEPS, BURN = 64, 500, 100
NUTS_CHAINS, NUTS_WARMUP, NUTS_DRAWS, NUTS_DEPTH = 16, 150, 100, 8
SAMPLE_CARD_CPU_RTOL, SAMPLE_CHAIN_ATOL, FD_PARITY_TOL = 1e-12, 1e-10, 1e-5


def _kernel_count(prof) -> tuple:
    """(kernels, copies) launched on the device under a profiler run."""
    from torch.autograd import DeviceType

    kernels = copies = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.key.startswith(("Memcpy", "Memset")):
            copies += e.count
        else:
            kernels += e.count
    return kernels, copies


def phase_sampling_path(dev, artifact=None) -> None:
    """The sampling layer on the card (see ``SAMPLE_BOUNDS``); ``artifact``
    is emulator_path's 4-D surface (built here when run alone).  No hand
    kernel is on this path: the launch counts read around each run are 0."""
    from torch.profiler import ProfilerActivity, profile

    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.mcmc_cli import initial_walkers
    from bdlz_tpu_torch.ops.kjma_table import make_f_table
    from bdlz_tpu_torch.sampling import (
        bulk_ess,
        gradient_parity,
        integrated_autocorr_time,
        make_logp_value_and_grad,
        make_pipeline_logprob,
        run_ensemble,
        run_ensemble_checkpointed,
        run_nuts,
        split_rhat,
    )
    from bdlz_tpu_torch.sampling.ensemble import make_generator
    from bdlz_tpu_torch.sampling.nuts import TorchNutsDraws, make_nuts_draw

    t0 = time.perf_counter()
    base = config_from_dict(ARCHIVED)
    static = static_choices_from_config(base)
    table = make_f_table(base.I_p, n=TABLE_N)

    def logp_on(device, bounds=SAMPLE_BOUNDS, **kw):
        return make_pipeline_logprob(base, static, table, param_keys=tuple(bounds),
                                     bounds=bounds, n_y=2000, device=device, **kw)

    def timed(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, counts = _launches_around(fn)
        torch.cuda.synchronize()
        check(not any(counts.values()), f"no hand kernel on the sampling path, got {counts}")
        return out, time.perf_counter() - t1

    # ---- the stretch sampler at the CLI's defaults -----------------------
    logp = logp_on(dev)
    init = initial_walkers(SAMPLE_BOUNDS, WALKERS, 0)
    run, stretch_s = timed(lambda: run_ensemble(logp, init, STEPS, generator=make_generator(1)))
    chain = run.chain.cpu().numpy()
    lpc = run.logp_chain.cpu().numpy()
    check(bool(np.isfinite(chain).all()), "stretch chain finite")
    post = chain[BURN:]
    map_logp = float(lpc[BURN:].max())
    check(0.05 < run.acceptance < 0.95 and map_logp > -5.0,
          f"stretch acceptance {run.acceptance:.3f}, MAP logp {map_logp:.3f}")
    stretch = {"walkers": WALKERS, "steps": STEPS, "seconds": stretch_s,
               "steps_per_sec": STEPS / stretch_s,
               "pipeline_evals_per_sec": WALKERS * (STEPS + 1) / stretch_s,
               "acceptance": run.acceptance, "map_logp": map_logp,
               "posterior_mean": post.reshape(-1, 2).mean(axis=0).tolist(),
               "posterior_std": post.reshape(-1, 2).std(axis=0).tolist(),
               "tau_int": integrated_autocorr_time(post).tolist(),
               "split_rhat": split_rhat(post).tolist(),
               "bulk_ess": bulk_ess(post).tolist()}
    stretch["bulk_ess_per_eval"] = min(stretch["bulk_ess"]) / (WALKERS * (STEPS + 1))

    # ---- NUTS from the stretch walkers -----------------------------------
    start = run.final.walkers[:NUTS_CHAINS]
    nuts, nuts_s = timed(lambda: run_nuts(logp, start, NUTS_DRAWS, generator=make_generator(2),
                                          n_warmup=NUTS_WARMUP, max_tree_depth=NUTS_DEPTH))
    check(bool(np.isfinite(nuts.chain).all()), "NUTS chain finite")
    nuts_ess = bulk_ess(nuts.chain)
    # device kernels and busy time per leaf: one adapted transition under
    # the profiler (its host time is the profiler's, so not reported)
    step = make_nuts_draw(logp, "diag", NUTS_DEPTH)
    z = torch.as_tensor(nuts.chain[-1], dtype=torch.float64, device=dev)
    lp0, g0 = step.value_and_grad(z)
    im = np.asarray(nuts.inv_mass)
    draws = TorchNutsDraws(make_generator(3)).transition("sample", 0, NUTS_CHAINS, 2,
                                                         NUTS_DEPTH, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(z, lp0, g0, nuts.step_size, im, 1.0 / np.sqrt(im), draws)
        torch.cuda.synchronize()
    kernels, copies = _kernel_count(prof)
    busy_ms = sum(_device_ms(prof).values())
    nuts_out = {"chains": NUTS_CHAINS, "n_warmup": NUTS_WARMUP, "draws": NUTS_DRAWS,
                "max_tree_depth": NUTS_DEPTH, "seconds": nuts_s,
                "n_leapfrog": nuts.n_leapfrog, "n_logp_evals": nuts.n_logp_evals,
                "leapfrogs_per_sec": nuts.n_leapfrog / nuts_s,
                "batched_leaves": nuts.n_batched_leaves,
                "host_ms_per_leaf": 1e3 * nuts_s / nuts.n_batched_leaves,
                "mean_tree_depth": nuts.mean_tree_depth, "step_size": nuts.step_size,
                "inv_mass": im.tolist(), "acceptance": nuts.acceptance,
                "n_divergent": nuts.n_divergent, "bulk_ess": nuts_ess.tolist(),
                "bulk_ess_per_eval": float(nuts_ess.min()) / nuts.n_logp_evals,
                "posterior_mean": nuts.chain.reshape(-1, 2).mean(axis=0).tolist(),
                "posterior_std": nuts.chain.reshape(-1, 2).std(axis=0).tolist(),
                "profiled": {"transitions": 1, "batched_leaves": step.n_leaves,
                             "device_kernels": kernels, "copies": copies,
                             "kernels_per_leaf": kernels / step.n_leaves,
                             "device_busy_ms": busy_ms,
                             "device_ms_per_leaf": busy_ms / step.n_leaves}}

    # ---- the emulator-backed stretch run against its exact twin -------------
    if artifact is None:
        from bdlz_tpu_torch.emulator import AxisSpec, build_emulator

        artifact, _ = build_emulator(base, {k: AxisSpec(*v) for k, v in EMU_SPEC.items()},
                                     static, rtol=1e-4, n_probe=48, max_rounds=25, n_y=N_Y,
                                     chunk_size=N_POINTS, seed=0, impl="kernel", device=dev)
    emu_init = initial_walkers(EMU_SAMPLE_BOUNDS, WALKERS, 0)
    emu_logp = logp_on(dev, EMU_SAMPLE_BOUNDS, emulator=artifact)
    twin_logp = logp_on(dev, EMU_SAMPLE_BOUNDS)
    emu_run, emu_s = timed(lambda: run_ensemble(emu_logp, emu_init, STEPS,
                                                generator=make_generator(1)))
    check(bool(torch.isfinite(emu_run.chain).all()), "emulator-backed chain finite")
    twin_run, twin_s = timed(lambda: run_ensemble(twin_logp, emu_init, STEPS,
                                                  generator=make_generator(1)))
    fin = emu_run.final.walkers
    emulator = {"params": list(EMU_SAMPLE_BOUNDS), "seconds": emu_s,
                "steps_per_sec": STEPS / emu_s, "exact_twin_seconds": twin_s,
                "exact_twin_steps_per_sec": STEPS / twin_s, "speedup": twin_s / emu_s,
                "acceptance": emu_run.acceptance, "twin_acceptance": twin_run.acceptance,
                "final_walkers_logp_gap_max_abs":
                    float((emu_logp(fin) - twin_logp(fin)).abs().max()),
                "artifact_grid": [len(n) for n in artifact.axis_nodes]}

    # ---- the card against the CPU, and finite differences on the card -------
    cpu_logp = logp_on("cpu")
    lp_c, g_c = make_logp_value_and_grad(logp)(init)
    lp_h, g_h = make_logp_value_and_grad(cpu_logp)(init)
    lp_rel, g_rel = _max_rel(lp_c.cpu(), lp_h), _max_rel(g_c.cpu(), g_h)
    check(lp_rel <= SAMPLE_CARD_CPU_RTOL and g_rel <= SAMPLE_CARD_CPU_RTOL,
          f"card vs CPU logp {lp_rel:.3e}, gradient {g_rel:.3e} <= {SAMPLE_CARD_CPU_RTOL:g}")
    n_cmp = 50
    cpu_run = run_ensemble(cpu_logp, init, n_cmp, generator=make_generator(1))
    card_run = run_ensemble(logp, init, n_cmp, generator=make_generator(1))
    chain_abs = float(np.max(np.abs(card_run.chain.cpu().numpy() - cpu_run.chain.numpy())))
    same_accepts = int(card_run.final.n_accept) == int(cpu_run.final.n_accept)
    check(chain_abs <= SAMPLE_CHAIN_ATOL and same_accepts,
          f"card vs CPU stretch chain {chain_abs:.3e} <= {SAMPLE_CHAIN_ATOL:g}, same accepts")
    fd = gradient_parity(logp, np.array([0.97, 0.15]))
    check(fd["max_rel_err"] <= FD_PARITY_TOL, f"FD parity on the card {fd['max_rel_err']:.3e}")

    # ---- a checkpointed NUTS chain cut after segment 1, then resumed --------
    work = tempfile.mkdtemp(prefix="bdlz_mcmc_")
    try:
        ckw = dict(n_steps=16, checkpoint_every=8, identity={"cell": "sampling_path"},
                   sampler="nuts", sampler_opts={"n_warmup": 20})
        start_np = start.cpu().numpy()
        t1 = time.perf_counter()
        full = run_ensemble_checkpointed(7, logp, start_np, out_dir=os.path.join(work, "a"),
                                         **ckw)
        ck_s = time.perf_counter() - t1
        shutil.copytree(os.path.join(work, "a"), os.path.join(work, "b"))
        os.remove(os.path.join(work, "b", "seg_00001.npz"))
        with open(os.path.join(work, "b", "manifest.json")) as f:
            manifest = json.load(f)
        manifest["done"] = [0]
        with open(os.path.join(work, "b", "manifest.json"), "w") as f:
            json.dump(manifest, f)
        resumed = run_ensemble_checkpointed(7, logp, start_np, out_dir=os.path.join(work, "b"),
                                            **ckw)
        bitwise = (resumed.resumed_segments == 1 and np.array_equal(resumed.chain, full.chain)
                   and resumed.step_size == full.step_size
                   and resumed.n_logp_evals == full.n_logp_evals)
        check(bitwise, "resumed NUTS chain bitwise the uninterrupted one")

        # ---- the CLI in a subprocess: the in-process chain, bit for bit ----
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        with open(os.path.join(work, "cfg.json"), "w") as f:
            json.dump(ARCHIVED, f)
        argv = [sys.executable, "-m", "bdlz_tpu_torch.mcmc_cli", "--config", "cfg.json",
                "--param", "m_chi_GeV=0.05:20", "--param", "P_chi_to_B=1e-4:1",
                "--out", "chain.npz"]
        t1 = time.perf_counter()
        proc = subprocess.run(argv, cwd=work, env=env, capture_output=True, text=True,
                              timeout=300)
        cli_s = time.perf_counter() - t1
        check(proc.returncode == 0, f"mcmc_cli exit {proc.returncode}: {proc.stderr[-2000:]}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        with np.load(os.path.join(work, "chain.npz")) as data:
            cli_same = bool(np.array_equal(data["chain"], chain))
        check(cli_same and summary["walkers"] == WALKERS,
              "mcmc_cli chain bit for bit the in-process run's")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "sampling_path", "seconds": time.perf_counter() - t0,
          "kernel_launches": 0, "bounds": SAMPLE_BOUNDS, "n_y": 2000, "table_n": TABLE_N,
          "stretch": stretch, "nuts": nuts_out, "emulator": emulator,
          "card_vs_cpu": {"walkers": WALKERS, "logp_max_rel": lp_rel, "grad_max_rel": g_rel,
                          "stretch_steps": n_cmp, "chain_max_abs": chain_abs,
                          "same_accepts": same_accepts},
          "fd_parity": {"point": [0.97, 0.15], "max_rel_err": fd["max_rel_err"]},
          "checkpoint": {"segments": full.segments, "resumed_segments": resumed.resumed_segments,
                         "bitwise": bitwise, "seconds": ck_s},
          "cli": {"wall_seconds": cli_s, "acceptance": summary["acceptance"],
                  "map_logp": summary["map_logp"], "chain_equals_in_process": cli_same}})


# The host planes: the native CSV parser on the lz_path profile size, the
# engine gate's reference on 64 audit points against the card's P1 sweep,
# and the sweep CLI's debugging flags in subprocesses.
N_PROFILE, N_AUDIT, REF_RTOL = 1_000_001, 64, 1e-9


def _subprocess_env() -> dict:
    root = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def phase_host_planes(dev) -> None:
    """The native parser against NumPy on a 1,000,001-sample profile
    (bitwise, both timed; the card's machine must build and use it), the
    per-point CPU reference on 64 audit points against the card's P1
    sweep engine, ``sweep_cli --sanitize --profile-dir`` (one trace of the
    sweep with its spans and P1, the summary unchanged) and ``--debug-nans`` on a NaN grid
    (a non-zero exit naming the op)."""
    from bdlz_tpu_torch import native
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.lz import profile as lzp
    from bdlz_tpu_torch.ops.kjma_table import make_f_table, table_to_device
    from bdlz_tpu_torch.parallel.sweep import run_sweep
    from bdlz_tpu_torch.validation import (
        build_audit_population,
        engine_population_max_rel,
        reference_ratios,
    )

    t0 = time.perf_counter()
    check(native.native_available(), "the native CSV parser built with g++ on this machine")
    work = tempfile.mkdtemp(prefix="bdlz_host_")
    try:
        rng = np.random.default_rng(3)
        xi = np.linspace(-50.0, 50.0, N_PROFILE)
        prof = np.stack([xi, 1e-3 * np.tanh(xi) + rng.normal(0, 1e-9, N_PROFILE),
                         np.full(N_PROFILE, 0.3)], axis=1)
        csv = os.path.join(work, "profile.csv")
        np.savetxt(csv, prof, delimiter=",", header="xi,delta,m_mix", comments="",
                   fmt="%.17g")
        t1 = time.perf_counter()
        n_names, n_data = lzp._read_csv(csv)
        native_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        p_names, p_data = lzp.read_csv_numpy(csv)
        numpy_s = time.perf_counter() - t1
        check(n_names == p_names and n_data.tobytes() == p_data.tobytes()
              and n_data.tobytes() == prof.tobytes(), "native parse bitwise NumPy's")

        # the engine gate: per-point CPU reference against P1 on the card
        base = config_from_dict(ARCHIVED)
        static = static_choices_from_config(base)._replace(quad_panel_gl=False, n_y=N_Y)
        pop = build_audit_population(base, N_AUDIT)
        t1 = time.perf_counter()
        ref = reference_ratios(pop.grid, static)
        ref_s = time.perf_counter() - t1
        table = table_to_device(make_f_table(base.I_p, n=TABLE_N), dev)
        ref_rel = engine_population_max_rel(pop.grid, ref, static, table, impl="kernel",
                                            n_y=N_Y, device=dev)
        check(ref_rel <= REF_RTOL, f"reference vs card P1 {ref_rel:.3e} <= {REF_RTOL:g}")

        # the sweep CLI's debugging flags
        cfg = os.path.join(work, "cfg.json")
        with open(cfg, "w") as f:
            json.dump(ARCHIVED, f)
        env = _subprocess_env()
        grid = ["--config", cfg, "--axis", "m_chi_GeV=geom:0.3:30:64", "--axis",
                "T_p_GeV=geom:60:200:64", "--chunk", "2048", "--n-y", str(N_Y),
                "--impl", "kernel"]

        def sweep(*flags):
            t1 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "bdlz_tpu_torch.sweep_cli", *grid,
                                   *flags], env=env, capture_output=True, text=True,
                                  timeout=300)
            return proc, time.perf_counter() - t1

        traces = os.path.join(work, "traces")
        checked, checked_s = sweep("--sanitize", "--profile-dir", traces)
        check(checked.returncode == 0, f"sweep_cli: {checked.stderr[-800:]}")
        names = sorted(f for f in os.listdir(traces) if f.endswith(".json"))
        check(names == ["trace_00000.json"], f"one trace of the sweep: {names}")
        with open(os.path.join(traces, names[0])) as f:
            events = json.load(f)["traceEvents"]
        # the host's spans; the trace mirrors each on the card's timeline
        # (category gpu_user_annotation) around the kernels it launched
        spans = [e["name"] for e in events if e.get("cat") == "user_annotation"]
        n_steps = spans.count("chunk.step")
        n_p1 = sum("kjma_point_kernel" in e.get("name", "") for e in events
                   if e.get("cat") == "kernel")
        check(n_steps == 2 and spans.count("sweep") == 1 and n_p1 >= 2,
              f"the trace holds the sweep's spans and P1: {n_steps} chunk.step for 2 "
              f"chunks, {n_p1} kjma_point_kernel events")
        # the same sweep in-process, without the flags
        res = run_sweep(base, {"m_chi_GeV": np.geomspace(0.3, 30.0, 64),
                               "T_p_GeV": np.geomspace(60.0, 200.0, 64)},
                        static_choices_from_config(base), chunk_size=2048, n_y=N_Y,
                        impl="kernel", device=dev)
        got = json.loads(checked.stdout.splitlines()[-1])
        best = got["closest_to_planck"]
        same = ((got["n_points"], got["n_failed"], got["quad_impl"], got["n_quad_nodes"])
                == (res.n_points, res.n_failed, res.quad_impl, res.n_quad_nodes)
                and best["DM_over_B"] == float(res.outputs["DM_over_B"][best["index"]]))
        check(same, f"--sanitize --profile-dir leave the summary unchanged: {got} vs "
                    f"{(res.n_points, res.n_failed, res.quad_impl, res.n_quad_nodes)}")
        grid[grid.index("T_p_GeV=geom:60:200:64")] = "P_chi_to_B=0.1,nan"
        nan_run, nan_s = sweep("--debug-nans", "--quad", "off")
        check(nan_run.returncode != 0 and "NaN produced by" in nan_run.stderr,
              f"--debug-nans on a NaN grid: exit {nan_run.returncode}")
        nan_op = nan_run.stderr.strip().splitlines()[-1]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "host_planes", "seconds": time.perf_counter() - t0,
          "native": {"rows": N_PROFILE, "native_seconds": native_s, "numpy_seconds": numpy_s,
                     "bitwise": True},
          "reference": {"n": N_AUDIT, "n_y": N_Y, "cpu_seconds": ref_s,
                        "p1_vs_reference_max_rel": ref_rel},
          "sweep_cli": {"sanitize_profile_seconds": checked_s, "traces": len(names),
                        "trace_chunk_steps": n_steps, "summary_equals_in_process": same},
          "debug_nans": {"exit": nan_run.returncode, "seconds": nan_s, "error": nan_op}})


# The serving cells: the emulator_path artifact served at the serve CLI's
# defaults (max-batch 256, max-wait 5 ms); 65,536 in-domain queries; 1,024
# requests with 10% outside the box; 2 replicas on the one card.
N_SERVE, N_MIXED, SERVE_BATCH, SERVE_WAIT_S = 65536, 1024, 256, 0.005
FALLBACK_RTOL = 1e-10


def _serve_stream(submit, thetas):
    """Submit every query, stamp each future's resolution: (answers,
    latencies in s, wall s)."""
    done = [0.0] * len(thetas)

    def stamp(i, t_sub):
        def cb(_f):
            done[i] = time.monotonic() - t_sub
        return cb

    t0 = time.monotonic()
    futs = []
    for i, th in enumerate(thetas):
        fut = submit(th)
        fut.add_done_callback(stamp(i, time.monotonic()))
        futs.append(fut)
    answers = [f.result() for f in futs]
    return answers, np.asarray(done), time.monotonic() - t0


def _mixed_queries(lo, hi, n, seed, log_axes=()):
    """``n`` queries in the box, 10% of them pushed 5% past one edge.  Below
    a ``log_axes`` axis the push is a factor 1.05 (the linear push takes
    m_chi of the emulator box negative, where no log box can reach)."""
    rng = np.random.default_rng(seed)
    th = lo + (hi - lo) * rng.uniform(size=(n, len(lo)))
    out = rng.choice(n, n // 10, replace=False)
    for i in out:
        k = rng.integers(len(lo))
        below = lo[k] / 1.05 if k in log_axes else lo[k] - 0.05 * (hi[k] - lo[k])
        th[i, k] = hi[k] * 1.05 if rng.integers(2) else below
    return th


def _pump_fleet(fleet, thetas):
    futs = []
    for th in thetas:
        futs.append(fleet.submit(th))
        fleet.run_once()
        fleet.poll()
    fleet.drain()
    return [f.result(timeout=0) for f in futs]


def phase_serving_path(dev, artifact=None):
    """The serving plane on the emulator_path artifact (built here when
    run alone): the single service under 65,536 in-domain queries (q/s,
    p50/p99), the mixed requests whose exact fallback runs P1 (against
    the plain tabulated engine on the CPU), the 2-replica fleet (bitwise
    the 1-replica one, a replica fault re-answered, every breaker open
    answered through P1), a rollout cutover under load, and the serve
    CLI (``--bench``, ``--requests``) in subprocesses.  Returns the P1
    launches of the serving run."""
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.emulator import load_artifact, make_exact_evaluator, save_artifact
    from bdlz_tpu_torch.faults import FaultPlan
    from bdlz_tpu_torch.serve import ArtifactRollout, FleetService, YieldService

    t0 = time.perf_counter()
    base = config_from_dict(ARCHIVED)
    if artifact is None:
        (artifact, _), _, _ = _build_emu_box(dev)
    work = tempfile.mkdtemp(prefix="bdlz_serve_")
    try:
        art_dir = os.path.join(work, "art")
        save_artifact(art_dir, artifact)
        art = load_artifact(art_dir)
        lo, hi = art.hull

        def serving_run():
            svc = YieldService(art, base, max_batch_size=SERVE_BATCH, device=dev)
            check(svc.exact_engine == "kernel", f"exact fallback engine {svc.exact_engine}")
            rng = np.random.default_rng(21)
            inside = lo + (hi - lo) * rng.uniform(size=(N_SERVE, len(lo)))
            mb = svc.make_batcher(max_wait_s=SERVE_WAIT_S)
            mb.start()
            try:
                values, lat, wall = _serve_stream(mb.submit, inside)
            finally:
                mb.stop()
            mixed = _mixed_queries(lo, hi, N_MIXED, 22)
            res = [svc.process_batch(mixed[i:i + SERVE_BATCH])
                   for i in range(0, N_MIXED, SERVE_BATCH)]
            return svc, inside, np.asarray(values), lat, wall, mixed, res

        (svc, inside, values, lat, wall, mixed, res), counts = _launches_around(serving_run)
        p1 = counts[MAIN_KERNEL]
        summary = svc.stats.summary()
        check(bool(np.all(np.isfinite(values))) and summary["requests"] == N_SERVE,
              "every in-domain query answered, finite")
        mixed_vals = np.concatenate([np.asarray(r.values) for r in res])
        reasons = sum((list(r.reasons) for r in res), [])
        fb = np.array([r is not None for r in reasons])
        n_ood = sum(r == "ood" for r in reasons)
        check(n_ood == N_MIXED // 10 and p1 >= 1,
              f"{n_ood} out-of-domain requests, {p1} P1 launches by the fallback")
        static = static_choices_from_config(base)._replace(quad_panel_gl=False)
        cols = {n: mixed[fb, k] for k, n in enumerate(art.axis_names)}
        plain = make_exact_evaluator(base, static, n_y=N_Y, impl="tabulated",
                                     chunk_size=int(fb.sum()), device="cpu")(cols)["DM_over_B"]
        fb_rel = _max_rel(mixed_vals[fb], plain)
        check(fb_rel <= FALLBACK_RTOL, f"fallback vs CPU tabulated {fb_rel:.3e}")

        # the host cost of one in-domain batch: the single service's
        # process_batch and one fleet replica's dispatch + gather
        batch = inside[:SERVE_BATCH]
        one_svc = FleetService(art, base, n_replicas=1)
        rset = one_svc.replica_set
        per_batch = {"service": lambda: svc.process_batch(batch),
                     "fleet_dispatch": lambda: rset.dispatch(batch).gather()}
        hot = {}
        for name, fn in per_batch.items():
            fn()
            samples = []
            for _ in range(50):
                t1 = time.perf_counter()
                fn()
                samples.append((time.perf_counter() - t1) * 1e3)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn()
            kernels, copies = _kernel_count(prof)
            hot[name] = {"host_ms_median": float(np.median(samples)),
                         "host_ms_min": float(np.min(samples)),
                         "kernels_per_batch": kernels / 10, "copies_per_batch": copies / 10,
                         "device_ms_per_batch": sum(_device_ms(prof).values()) / 10}

        # the fleet: 2 replicas on the one card against 1
        fleet_th = mixed[:512]
        one = _pump_fleet(one_svc, fleet_th)
        t1 = time.perf_counter()
        two_svc = FleetService(art, base, n_replicas=2, routing="round_robin")
        two = _pump_fleet(two_svc, fleet_th)
        fleet_s = time.perf_counter() - t1
        bitwise = (np.array([r.value for r in two]).tobytes()
                   == np.array([r.value for r in one]).tobytes())
        check(bitwise and {r.replica for r in two} == {0, 1},
              "2-replica answers bitwise the 1-replica ones, both replicas used")
        faulty = FleetService(art, base, n_replicas=2, fault_plan=FaultPlan.from_obj(
            [{"site": "replica_dispatch", "kind": "nan", "key": 0}]))
        healed = _pump_fleet(faulty, fleet_th)
        healed_ok = (np.array([r.value for r in healed]).tobytes()
                     == np.array([r.value for r in one]).tobytes())
        check(healed_ok and faulty.health.healed_batches >= 1,
              f"replica fault re-answered bitwise ({faulty.health.summary()})")
        dead = FleetService(art, base, n_replicas=2, fault_plan=FaultPlan.from_obj(
            [{"site": "replica_dispatch", "kind": "raise"}]))
        degraded, dcounts = _launches_around(lambda: _pump_fleet(dead, fleet_th[:256]))
        deg_rel = _max_rel([r.value for r in degraded],
                           make_exact_evaluator(base, static, n_y=N_Y, impl="tabulated",
                                                chunk_size=256, device="cpu")(
                               {n: fleet_th[:256, k] for k, n in enumerate(art.axis_names)}
                           )["DM_over_B"])
        check(all(r.degraded for r in degraded) and dcounts[MAIN_KERNEL] >= 1
              and deg_rel <= FALLBACK_RTOL,
              f"every breaker open: degraded through P1 ({dcounts[MAIN_KERNEL]}), {deg_rel:.3e}")

        # a rollout cutover under load
        art2_dir = os.path.join(work, "art2")
        manifest = {k: v for k, v in art.manifest.items() if k != "hash"}
        save_artifact(art2_dir, art._replace(
            values={k: np.asarray(v) * 1.001 for k, v in art.values.items()},
            manifest=manifest))
        ro = ArtifactRollout(two_svc)
        futs, old_hash, n_roll = [], two_svc.artifact_hash, min(4096, len(inside))
        for i, th in enumerate(inside[:n_roll]):
            futs.append(two_svc.submit(th))
            two_svc.run_once()
            two_svc.poll()
            if i == n_roll // 2:
                new_hash = ro.stage(art2_dir)
                ro.cutover()
        two_svc.drain()
        rolled = [f.result(timeout=0) for f in futs]
        order = [r.artifact_hash for r in rolled]
        n_old = order.count(old_hash)
        check(len(rolled) == n_roll and 0 < n_old < n_roll
              and order == [old_hash] * n_old + [new_hash] * (n_roll - n_old),
              "cutover: every request answered, old artifact then new, never mixed")

        # the serve CLI in subprocesses
        cfg = os.path.join(work, "cfg.json")
        with open(cfg, "w") as f:
            json.dump(ARCHIVED, f)
        req = os.path.join(work, "req.jsonl")
        with open(req, "w") as f:
            for i, th in enumerate(mixed):
                f.write(json.dumps({"id": i, **dict(zip(art.axis_names, map(float, th)))})
                        + "\n")
        env = _subprocess_env()
        cli = [sys.executable, "-m", "bdlz_tpu_torch.serve", "--config", cfg,
               "--artifact", art_dir]
        t1 = time.perf_counter()
        bench = subprocess.run(cli + ["--bench", str(N_SERVE)], env=env,
                               capture_output=True, text=True, timeout=300)
        bench_s = time.perf_counter() - t1
        check(bench.returncode == 0, f"serve --bench: {bench.stderr[-1500:]}")
        brec = json.loads(bench.stdout.strip().splitlines()[-1])
        check(brec["finite"] == brec["requests"] == N_SERVE,
              f"serve --bench answers {brec['finite']} of {N_SERVE}")
        reqs = subprocess.run(cli + ["--requests", req], env=env, capture_output=True,
                              text=True, timeout=300)
        check(reqs.returncode == 0, f"serve --requests: {reqs.stderr[-1500:]}")
        recs = [json.loads(ln) for ln in reqs.stdout.strip().splitlines()]
        cli_same = ([r["value"] for r in recs] == [float(v) for v in mixed_vals]
                    and [r["fallback_reason"] for r in recs] == reasons)
        check(cli_same, "serve --requests answers equal the in-process ones")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "serving_path", "seconds": time.perf_counter() - t0,
          "exact_fallback_engine": svc.exact_engine,
          "service": {"n": N_SERVE, "max_batch": SERVE_BATCH, "max_wait_ms": SERVE_WAIT_S * 1e3,
                      "queries_per_sec": N_SERVE / wall, "wall_seconds": wall,
                      "p50_latency_ms": float(np.percentile(lat, 50)) * 1e3,
                      "p99_latency_ms": float(np.percentile(lat, 99)) * 1e3,
                      "batches": summary["batches"], "mean_batch": summary["mean_batch"],
                      "fallbacks": summary["fallbacks"], "gated": summary["gated_fallbacks"],
                      "warmup_seconds": summary["warmup_seconds"]},
          "mixed": {"n": N_MIXED, "ood": n_ood, "fallbacks": int(fb.sum()),
                    "gated": int(sum(r.n_gated for r in res)), "p1_launches": p1,
                    "fallback_vs_cpu_tabulated_max_rel": fb_rel},
          "per_batch": hot,
          "fleet": {"replicas": 2, "n": len(fleet_th), "seconds": fleet_s,
                    "bitwise_vs_one_replica": bitwise, "fault_reanswered_bitwise": healed_ok,
                    "health": faulty.health.summary(), "degraded_p1_launches": dcounts[MAIN_KERNEL],
                    "degraded_vs_cpu_tabulated_max_rel": deg_rel},
          "rollout": {"requests": len(rolled), "dropped": 0, "answered_by_old": n_old,
                      "hashes": [old_hash, new_hash]},
          "cli": {"bench_queries_per_sec": brec["value"], "bench_wall_seconds": bench_s,
                  "bench_fallbacks": brec["fallbacks"],
                  "requests_equal_in_process": cli_same}})
    return p1


ELASTIC_WORKERS = 3
#: The main grid as sweep_cli flags (np.geomspace / np.linspace, as MAIN_AXES).
MAIN_AXIS_FLAGS = ["--axis", "m_chi_GeV=geom:0.1:10.0:64", "--axis",
                   "T_p_GeV=geom:30.0:300.0:32", "--axis", "v_w=lin:0.05:0.95:16"]


def _sweep_summary(ratios: np.ndarray) -> dict:
    """sweep_cli's closest-to-Planck record of a main-grid result."""
    from bdlz_tpu_torch.constants import PLANCK_DM_OVER_B

    best = int(np.argmin(np.abs(ratios - PLANCK_DM_OVER_B)))
    return {"index": best, "DM_over_B": float(ratios[best])}


def phase_elastic_path(dev) -> dict:
    """The elastic work-stealing sweep on the main grid: each kernel tier
    through ``run_sweep_elastic`` (3 in-process workers on a manual
    clock) bitwise against ``run_sweep`` of the same tier, 4 launches
    each; a run under churn (a worker crash on chunk 1, a flaky lease
    claim on chunk 2) still bitwise; two ``sweep_cli --elastic auto``
    processes over one store (one coordinator, one worker) whose folded
    result is the in-process one; and a ``--device cpu`` worker refused
    by the card's job record.  Returns the launches per tier."""
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.faults import FaultPlan
    from bdlz_tpu_torch.parallel import (
        ManualClock,
        plan_elastic_sweep,
        run_sweep,
        run_sweep_elastic,
    )
    from bdlz_tpu_torch.provenance import Store, read_lease

    t0 = time.perf_counter()
    base = config_from_dict(ARCHIVED)
    static = static_choices_from_config(base)
    kw = dict(impl="kernel", chunk_size=N_POINTS, n_y=N_Y, table_nodes=TABLE_N, device=dev)
    work = tempfile.mkdtemp(prefix="bdlz_elastic_")
    launches, tiers = {}, {}
    try:
        for name, (fuse_exp, reduce) in TIERS.items():
            tier = dict(kw, fuse_exp=fuse_exp, reduce=reduce)
            ref = run_sweep(base, MAIN_AXES, static, **tier)
            res, counts = _launches_around(lambda: run_sweep_elastic(
                base, MAIN_AXES, static, store=os.path.join(work, name),
                n_workers=ELASTIC_WORKERS, clock=ManualClock(), **tier))
            check(res.n_points == 32768 and res.n_failed == 0, f"elastic {name}: all finite")
            check(_bitwise(res.outputs, ref.outputs), f"elastic {name}: bitwise run_sweep")
            kernel = TIER_KERNEL[name]
            check(counts[kernel] == 4 and sum(counts.values()) == 4,
                  f"elastic {name}: 4 launches of {kernel} only, got {counts}")
            launches[kernel] = counts[kernel]
            tiers[name] = {"kernel": kernel, "launches": counts[kernel], "seconds": res.seconds,
                           "serial_seconds": ref.seconds, "points_per_sec": res.points_per_sec}
            if name == "reduce":
                p1_ref = ref

        churn = FaultPlan.from_obj([
            {"site": "worker_crash", "kind": "transient", "chunk": 1, "times": 1},
            {"site": "lease", "kind": "transient", "chunk": 2, "times": 1}])
        churn_store = os.path.join(work, "churn")
        res, counts = _launches_around(lambda: run_sweep_elastic(
            base, MAIN_AXES, static, store=churn_store, n_workers=ELASTIC_WORKERS,
            lease_ttl_s=5.0, churn_plan=churn, clock=ManualClock(), **kw))
        plan = plan_elastic_sweep(base, MAIN_AXES, static, **kw)
        recs = [read_lease(Store(churn_store), plan.job, ci) for ci in range(plan.n_chunks)]
        check(_bitwise(res.outputs, p1_ref.outputs) and res.n_quarantined == 0,
              "elastic under churn: bitwise run_sweep")
        check(recs[1]["failures"] and all(r["state"] == "done" for r in recs),
              f"the crashed worker's chunk was stolen: {recs[1]}")
        launches[MAIN_KERNEL] += counts[MAIN_KERNEL]
        churn_row = {"p1_launches": counts[MAIN_KERNEL], "seconds": res.seconds,
                     "stolen_generation": recs[1]["generation"],
                     "failure_credit": recs[1]["failures"],
                     "generations": [r["generation"] for r in recs]}

        # two processes over one store: one is elected coordinator
        cfg = os.path.join(work, "cfg.json")
        with open(cfg, "w") as f:
            json.dump(ARCHIVED, f)
        cli_store = os.path.join(work, "cli")
        cli = [sys.executable, "-m", "bdlz_tpu_torch.sweep_cli", "--config", cfg,
               *MAIN_AXIS_FLAGS, "--impl", "kernel", "--elastic-store", cli_store,
               "--poll", "0.2"]
        t1 = time.perf_counter()
        procs = [subprocess.Popen(cli + ["--elastic", "auto", "--worker-id", f"p{i}"],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                  env=_subprocess_env()) for i in range(2)]
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=300)
                outs.append((p.returncode, out, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        cli_s = time.perf_counter() - t1
        check(all(rc == 0 for rc, _, _ in outs),
              f"elastic CLI roles: {[err[-1500:] for rc, _, err in outs if rc]}")
        roles = ["coordinator" if "elected coordinator" in err else "worker"
                 for _, _, err in outs]
        check(sorted(roles) == ["coordinator", "worker"], f"elected roles {roles}")
        coord = json.loads(outs[roles.index("coordinator")][1].strip().splitlines()[-1])
        worker = json.loads(outs[roles.index("worker")][1].strip().splitlines()[-1])
        want = _sweep_summary(p1_ref.outputs["DM_over_B"])
        got = {k: coord["closest_to_planck"][k] for k in want}
        check(coord["n_points"] == 32768 and coord["n_failed"] == 0 and got == want,
              f"coordinator summary {got} against in-process {want}")
        folded = run_sweep_elastic(base, MAIN_AXES, static, store=cli_store, **kw)
        check(folded.cache_hits == 4 and _bitwise(folded.outputs, p1_ref.outputs),
              "the CLI fleet's committed chunks are the in-process bits")

        # a CPU role against the card's job is refused by the job record
        cpu = subprocess.run(cli + ["--elastic", "worker", "--worker-id", "cpu0",
                                    "--device", "cpu"], capture_output=True, text=True,
                             env=_subprocess_env(), timeout=300)
        check(cpu.returncode != 0 and "ElasticError" in cpu.stderr,
              f"a --device cpu worker must be refused: rc {cpu.returncode}, "
              f"{cpu.stderr[-800:]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "elastic_path", "seconds": time.perf_counter() - t0, "points": 32768,
          "chunks": 4, "workers": ELASTIC_WORKERS, "tiers": tiers, "churn": churn_row,
          "cli": {"roles": roles, "seconds": cli_s, "worker_chunks": worker["chunks_done"],
                  "closest_to_planck": got},
          "cpu_worker_refused": True})
    return launches


#: The chain tenant: N = 3 over a (m_chi, v_w) box, P from an analytic
#: profile (the tests' tanh wall), at the main path's n_y through P1.
CHAIN_SPEC = {"m_chi_GeV": (0.5, 2.0, 5, "log"), "v_w": (0.2, 0.4, 5, "lin")}
AUTOSCALE_S, FAR_M_CHI = 1.0, 40.0


def _chain_profile():
    from bdlz_tpu_torch.lz.profile import BounceProfile

    xi = np.linspace(-30.0, 30.0, 1001)
    return BounceProfile(xi=xi, delta=-0.08 * np.tanh(xi / 4.0), mix=np.full_like(xi, 0.02))


def _values(futs) -> np.ndarray:
    return np.array([f.result(timeout=0).value for f in futs])


def _drift_queries(artifact, n, seed):
    """``n`` queries of a traffic drift: uniform over a sub-box that hangs a
    third past the box's top edge in m_chi and sits in the middle tenth of
    every other axis (in each axis's own scale)."""
    from bdlz_tpu_torch.emulator.grid import axis_coord

    rng = np.random.default_rng(seed)
    cols = []
    for k, name in enumerate(artifact.axis_names):
        nodes, scale = np.asarray(artifact.axis_nodes[k]), artifact.axis_scales[k]
        u_lo, u_hi = (float(v) for v in axis_coord(nodes[[0, -1]], scale))
        d = u_hi - u_lo
        a, b = ((u_lo + 0.8 * d, u_hi + 0.1 * d) if name == "m_chi_GeV"
                else (u_lo + 0.45 * d, u_lo + 0.55 * d))
        u = rng.uniform(a, b, n)
        cols.append(10.0 ** u if scale == "log" else u)
    return np.stack(cols, axis=1)


def _refine_cycle(artifact, base, stream, dev, root):
    """The refinement daemon on a 1-replica fleet of ``artifact``: serve
    ``stream`` in 256-query batches until the daemon sees drift and runs
    its cycle (snapshot, traffic-weighted rebuild through P1, delivery),
    then serve the stream again on whatever surface serves.  Returns
    (record, P1 launches of the cycle)."""
    from bdlz_tpu_torch.emulator import artifact_hull
    from bdlz_tpu_torch.parallel import ManualClock
    from bdlz_tpu_torch.provenance import Store
    from bdlz_tpu_torch.provenance.registry import ARTIFACT_KIND
    from bdlz_tpu_torch.refine import RefinementDaemon
    from bdlz_tpu_torch.serve import FleetService

    clock = ManualClock()
    fleet = FleetService(artifact, base, max_batch_size=SERVE_BATCH, n_replicas=1,
                         clock=clock, devices=[dev])
    store = Store(root)
    daemon = RefinementDaemon(
        fleet, base, store=store, clock=clock, window=N_MIXED, min_queries=32,
        drift_gated_rate=0.05, rebuild_budget=1, observe_s=0.5,
        build_kw=dict(n_probe=48, max_rounds=25, chunk_size=N_POINTS))
    lo, hi = artifact_hull(artifact)
    far = lo + 0.5 * (hi - lo)
    far[artifact.axis_names.index("m_chi_GeV")] = FAR_M_CHI

    def serve(thetas):
        futs = [fleet.submit(t) for t in thetas]
        clock.advance(0.01)
        while fleet.pending():
            fleet.run_once(force=True)
            while fleet.in_flight():
                fleet.poll(block=True)
        return [f.result(timeout=0) for f in futs]

    def fallback_rate(rows):
        return sum(r.n_fallback for r in rows) / sum(r.size for r in rows)

    far_before = serve([far])[0]
    rebuild_s, p1, steps, rows = None, 0, 0, []
    for i in range(0, len(stream), SERVE_BATCH):  # until the daemon sees drift
        serve(stream[i:i + SERVE_BATCH])
        rows = list(fleet.stats.rows[1:])  # served by the seed surface
        t1 = time.perf_counter()
        status, counts = _launches_around(daemon.step)
        steps += 1
        if status.get("drifted"):
            rebuild_s, p1 = time.perf_counter() - t1, counts[MAIN_KERNEL]
            break
    check(rebuild_s is not None and daemon.cycles == 1 and p1 >= 1,
          f"the daemon saw the drift and rebuilt through P1 ({p1} launches)")
    far_after = serve([far])[0]
    n2 = len(fleet.stats.rows)
    for i in range(0, len(stream), SERVE_BATCH):
        serve(stream[i:i + SERVE_BATCH])
    far_bitwise = np.float64(far_before.value).tobytes() == np.float64(far_after.value).tobytes()
    check(far_before.fallback_reason == far_after.fallback_reason == "ood" and far_bitwise,
          "a far out-of-domain answer is bitwise equal across the cycle")
    decision = daemon.history[0]["decision"]
    published = os.path.isdir(os.path.join(store.root, ARTIFACT_KIND))
    check((decision["outcome"] == "promoted") == published
          and (fleet.artifact_hash != artifact.content_hash) == published,
          f"promoted iff published and serving: {decision}")
    row = {"drift_at_step": steps, "rebuild_seconds": rebuild_s, "rebuild_p1_launches": p1,
           "snapshot_ood_rate": daemon.history[0]["snapshot_ood_rate"],
           "snapshot_gated_rate": daemon.history[0]["snapshot_gated_rate"],
           "fallback_rate_before": fallback_rate(rows),
           "fallback_rate_after": fallback_rate(fleet.stats.rows[n2:]),
           "far_ood_bitwise": far_bitwise, "decision": decision, "published": published,
           "rollbacks": fleet.stats.extras.get("rollbacks", [])}
    fleet.close()
    return row, p1


def phase_fabric_path(dev, artifact=None) -> int:
    """Tenancy, refinement and the fabric on the card.  Two tenants (the
    emulator_path box and an N=3 chain surface built here through P1)
    behind one ``MultiTenantService`` at the serve CLI's defaults under a
    steady load on its clock (the autoscaler grows and shrinks the pools),
    answers bitwise a single-tenant fleet's, an eviction answered through
    P1 and a readmission bitwise the pre-eviction answers; the refinement
    daemon on a 1-replica fleet fed the 1,024-request mix until it
    rebuilds through P1 and cuts over; two fabric hosts over one store: a
    host crash failed over bitwise, a store partition answered through P1,
    and an idle host stealing the main grid's chunks through P1, bitwise
    ``run_sweep``.  Returns the P1 launches of the phase."""
    import dataclasses

    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.emulator import AxisSpec, artifact_hull, build_emulator
    from bdlz_tpu_torch.emulator import make_exact_evaluator
    from bdlz_tpu_torch.faults import FaultPlan
    from bdlz_tpu_torch.parallel import (
        LeasePlane,
        ManualClock,
        ensure_job_record,
        plan_elastic_sweep,
        run_sweep,
        run_sweep_elastic,
    )
    from bdlz_tpu_torch.provenance import Store, publish_artifact
    from bdlz_tpu_torch.serve import (
        FabricHost,
        FleetService,
        GlobalRouter,
        MultiTenantService,
        ServiceUnavailable,
        ServingFabric,
    )
    from bdlz_tpu_torch.serve.tenancy import pool_bytes_per_replica

    t0 = time.perf_counter()
    base = config_from_dict(ARCHIVED)
    static = static_choices_from_config(base)
    if artifact is None:
        (artifact, _), _, _ = _build_emu_box(dev)
    base_chain = dataclasses.replace(base, lz_mode="chain", lz_n_levels=3)
    prof = _chain_profile()
    (chain_art, chain_rep), chain_counts = _launches_around(lambda: build_emulator(
        base_chain, {k: AxisSpec(*v) for k, v in CHAIN_SPEC.items()},
        static_choices_from_config(base_chain), rtol=1e-3, n_probe=16, max_rounds=6,
        n_y=N_Y, chunk_size=N_POINTS, impl="kernel", lz_profile=prof, device=dev))
    p1 = chain_counts[MAIN_KERNEL]
    check(p1 >= 1, "the chain tenant was built through P1")
    work = tempfile.mkdtemp(prefix="bdlz_fabric_")
    try:
        store = Store(os.path.join(work, "store"))
        tenants = {"box": publish_artifact(store, artifact),
                   "chain": publish_artifact(store, chain_art)}
        lo, hi = artifact_hull(artifact)
        clo, chi = artifact_hull(chain_art)
        rng = np.random.default_rng(31)

        # ---- tenancy: a steady offered load on the service's clock
        clock = ManualClock()
        svc = MultiTenantService(base, tenant_map=tenants, store=store,
                                 max_batch_size=SERVE_BATCH, max_wait_s=SERVE_WAIT_S,
                                 clock=clock, lz_profile=prof, autoscale_interval_s=AUTOSCALE_S,
                                 n_replicas=1, devices=[dev])
        mem, bytes_est = {}, {}
        for scn, (a, b) in (("box", (lo, hi)), ("chain", (clo, chi))):
            m0 = torch.cuda.memory_allocated(dev)
            svc.submit(a + 0.5 * (b - a), scenario=scn)
            mem[scn] = torch.cuda.memory_allocated(dev) - m0
            bytes_est[scn] = svc.pool(scn).bytes_per_replica
        svc.drain()
        blocks = {"box": lo + (hi - lo) * rng.uniform(size=(SERVE_BATCH, len(lo))),
                  "chain": clo + (chi - clo) * rng.uniform(size=(SERVE_BATCH, len(clo)))}
        replicas, host_ms, answers = [], {s: [] for s in blocks}, {}
        for tick in range(6):
            if tick < 3:  # one full batch per pool per interval, timed per pool
                futs = {}
                for scn in blocks:
                    futs[scn] = [svc.submit(t, scenario=scn) for t in blocks[scn]]
                    t1 = time.perf_counter()
                    svc.run_once()
                    svc.poll(block=True)
                    torch.cuda.synchronize(dev)
                    host_ms[scn].append((time.perf_counter() - t1) * 1e3)
                answers.setdefault("first", {s: _values(f) for s, f in futs.items()})
            clock.advance(AUTOSCALE_S)
            svc.run_once()
            replicas.append({s: svc.pool(s).n_replicas for s in blocks})
        for _ in range(2):
            clock.advance(AUTOSCALE_S)
            svc.run_once()
            replicas.append({s: svc.pool(s).n_replicas for s in blocks})
        check(any(r["box"] == 2 for r in replicas) and replicas[-1]["box"] == 1,
              f"the autoscaler grew and shrank the box pool: {replicas}")
        single = {"box": FleetService(artifact, base, max_batch_size=SERVE_BATCH,
                                      devices=[dev]),
                  "chain": FleetService(chain_art, base_chain, max_batch_size=SERVE_BATCH,
                                        lz_profile=prof, devices=[dev])}
        bitwise_single = {}
        for scn, fleet in single.items():
            fs = [fleet.submit(t) for t in blocks[scn]]
            fleet.drain()
            bitwise_single[scn] = _values(fs).tobytes() == answers["first"][scn].tobytes()
            fleet.close()
        check(all(bitwise_single.values()), f"tenancy vs single-tenant fleets {bitwise_single}")

        # ---- eviction below the two pools' bytes, then readmission
        svc.submit(blocks["chain"][0], scenario="chain")
        svc.drain()
        svc.memory_budget_bytes = svc.pool("chain").resident_bytes
        svc.run_once()
        check(svc.pool("box").evicted and not svc.pool("chain").evicted,
              "the memory budget evicted the idle box pool")
        probe = blocks["box"][:64]
        deg, deg_counts = _launches_around(lambda: (
            [svc.submit(t, scenario="box") for t in probe], svc.drain())[0])
        deg_resp = [f.result(timeout=0) for f in deg]
        plain = make_exact_evaluator(
            base, static._replace(quad_panel_gl=False), n_y=N_Y, impl="tabulated",
            chunk_size=len(probe), device="cpu")(
                {n: probe[:, k] for k, n in enumerate(artifact.axis_names)})["DM_over_B"]
        deg_rel = _max_rel([r.value for r in deg_resp], plain)
        check(all(r.degraded and r.fallback_reason == "pool_evicted" and r.replica == -1
                  for r in deg_resp) and deg_counts[MAIN_KERNEL] >= 1
              and deg_rel <= FALLBACK_RTOL,
              f"evicted pool answered through P1 ({deg_counts[MAIN_KERNEL]}), {deg_rel:.3e}")
        p1 += deg_counts[MAIN_KERNEL]
        svc.memory_budget_bytes = None
        svc.readmit("box")
        post = [svc.submit(t, scenario="box") for t in blocks["box"]]
        svc.drain()
        readmit_bitwise = _values(post).tobytes() == answers["first"]["box"].tobytes()
        check(readmit_bitwise, "readmitted answers bitwise the pre-eviction ones")
        tenancy = {"replicas_per_pass": replicas, "wall_ms_per_batch": host_ms,
                   "memory_allocated_bytes": mem, "pool_bytes_per_replica": bytes_est,
                   "bitwise_single_tenant": bitwise_single,
                   "evicted_p1_launches": deg_counts[MAIN_KERNEL],
                   "evicted_vs_cpu_tabulated_max_rel": deg_rel,
                   "readmit_bitwise": readmit_bitwise, "summary": {
                       k: v for k, v in svc.summary().items() if k != "pools"}}
        svc.close()

        # ---- refinement: drift, a traffic-weighted rebuild through P1, delivery
        log_axes = [k for k, sc in enumerate(artifact.axis_scales) if sc == "log"]
        streams = {"mix": _mixed_queries(lo, hi, N_MIXED, 22, log_axes=log_axes),
                   "drift": _drift_queries(artifact, N_MIXED, 23)}
        refine = {}
        for name, stream in streams.items():
            row, counts = _refine_cycle(artifact, base, stream, dev,
                                        os.path.join(work, f"refine_{name}"))
            p1 += counts
            refine[name] = row
        mix, drift = refine["mix"], refine["drift"]
        check(drift["decision"]["outcome"] == "promoted"
              and drift["fallback_rate_after"] <= drift["fallback_rate_before"] / 2,
              f"the drifted stream's candidate was promoted and the fallback rate fell "
              f"at least 2x: {drift}")
        check(mix["decision"]["outcome"] == "promoted"
              and mix["fallback_rate_after"] <= mix["fallback_rate_before"] / 2
              or mix["decision"]["outcome"] == "rejected" and not mix["published"],
              f"the mix's candidate was promoted with the fallback rate 2x lower, or "
              f"rejected unpublished: {mix}")

        # ---- the fabric: two hosts over one store
        fclock = ManualClock()
        # host 1's store calls: register 0, two ticks' heartbeats 1 and 2,
        # then the partitioned heartbeat's two attempts 3 and 4
        crash = FaultPlan.from_obj([{"site": "host_crash", "kind": "raise", "chunk": 1}])
        part = FaultPlan.from_obj([{"site": "store_partition", "kind": "raise", "chunk": k}
                                   for k in (3, 4)])
        hosts = [FabricHost(base, fabric="chip", host_id=f"h{i}", host_index=i, store=store,
                            tenant_map=tenants, clock=fclock, ttl_s=30.0,
                            max_batch_size=SERVE_BATCH, fault_plan=faults,
                            partition_retries=2, steal_chunks_per_tick=4, cache_root=cache,
                            devices=[dev])
                 for i, (faults, cache) in enumerate(
                     ((crash, None), (part, os.path.join(work, "h1cache"))))]
        fab = ServingFabric(hosts, GlobalRouter(store, "chip", 2, clock=fclock))
        fab.register_all()
        trace = blocks["box"][:64]
        v0 = [fab.submit(t, scenario="box") for t in trace]
        fab.drain()
        check({f.result(timeout=0).host_id for f in v0} == {"h0"}, "host 0 served first")
        fab.tick()  # host 0 advertises its pool; then dies at its next tick
        doomed = [fab.submit(t, scenario="box") for t in trace[:8]]
        fab.tick()
        n_typed = sum(isinstance(f.exception(timeout=0), ServiceUnavailable) for f in doomed)
        check(not hosts[0].alive and n_typed == len(doomed), "host 0 crashed, queued work typed")
        v1 = [fab.submit(t, scenario="box") for t in trace]
        fab.drain()
        failover_bitwise = _values(v1).tobytes() == _values(v0).tobytes()
        check(failover_bitwise and {f.result(timeout=0).host_id for f in v1} == {"h1"},
              "failover to host 1, bitwise the clean run")
        check(not hosts[1].heartbeat() and hosts[1].partitioned, "host 1 partitioned")
        pres, pcounts = _launches_around(
            lambda: hosts[1].submit(trace[0], scenario="box").result(timeout=0))
        check(pres.degraded and pres.fallback_reason == "store_partition"
              and pcounts[MAIN_KERNEL] >= 1, f"partition answered through P1 ({pcounts})")
        p1 += pcounts[MAIN_KERNEL]
        check(hosts[1].heartbeat() and not hosts[1].partitioned, "the partition healed")

        kw = dict(impl="kernel", chunk_size=N_POINTS, n_y=N_Y, table_nodes=TABLE_N, device=dev)
        ref = run_sweep(base, MAIN_AXES, static, **kw)
        plan = plan_elastic_sweep(base, MAIN_AXES, static, **kw)
        ensure_job_record(store, plan)
        leases = LeasePlane(store, plan.job, plan.n_chunks, ttl_s=60.0, clock=fclock)
        hosts[1].attach_sweep(plan, leases)
        _, scounts = _launches_around(lambda: [fab.tick() for _ in range(2)])
        folded = run_sweep_elastic(base, MAIN_AXES, static, store=store, **kw)
        check(hosts[1].chunks_stolen == 4 and scounts[MAIN_KERNEL] == 4
              and folded.cache_hits == 4 and _bitwise(folded.outputs, ref.outputs),
              f"host 1 stole 4 chunks through P1, bitwise run_sweep ({scounts})")
        p1 += scounts[MAIN_KERNEL]
        fabric = {"failover_bitwise": failover_bitwise, "typed_failures": n_typed,
                  "failovers": fab.failovers, "partition_p1_launches": pcounts[MAIN_KERNEL],
                  "stolen_chunks": hosts[1].chunks_stolen,
                  "stolen_p1_launches": scounts[MAIN_KERNEL],
                  "artifact_cache": hosts[1].artifact_cache.counters()}
        fab.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "fabric_path", "seconds": time.perf_counter() - t0,
          "chain_build": {"p1_launches": chain_counts[MAIN_KERNEL],
                          "converged": chain_rep.converged,
                          "seconds": chain_rep.build_seconds},
          "tenancy": tenancy, "refine": refine, "fabric": fabric, "p1_launches": p1})
    return p1


# The mesh: the main grid split over two members of the one card, the sp
# quadrature of one point at a giant n_y, two processes on the card through
# the CLIs (gloo carries their agreements), and a NCCL world of one.
SP_N_Y, SP_RTOL = 1_048_576, 1e-12
MESH_CLI_TIMEOUT = 300
#: Runs ``sweep_cli.main`` as ``python -m bdlz_tpu_torch.sweep_cli`` would,
#: recording what the CLI does not print: each P1 launch's rows, the files
#: the process wrote and its gathered outputs.  ``argv[2]`` other than "-"
#: makes this process report another kernel library digest.
SWEEP_PROBE = r'''
import json, sys
import numpy as np
from bdlz_tpu_torch import sweep_cli
from bdlz_tpu_torch.ops import kjma_kernel as kk
from bdlz_tpu_torch.parallel import sweep as sw
from bdlz_tpu_torch.utils import io
out_npz, digest = sys.argv[1], sys.argv[2]
if digest != "-":
    kk.kernel_digest = lambda: digest
rows, writes, box = [], [0], {}
launch, run_sweep = kk._launch_point, sw.run_sweep
def counted_launch(name, scalars, *rest):
    rows.append(int(scalars.shape[0]))
    return launch(name, scalars, *rest)
def counted(fn):
    def inner(*a, **k):
        writes[0] += 1
        return fn(*a, **k)
    return inner
def kept(*a, **k):
    box["res"] = res = run_sweep(*a, **k)
    return res
kk._launch_point, sw.run_sweep = counted_launch, kept
io.atomic_savez, io.atomic_write_json = counted(io.atomic_savez), counted(io.atomic_write_json)
sweep_cli.main(sys.argv[3:])
res = box["res"]
np.savez(out_npz, **res.outputs)
print(json.dumps({"probe": {"launches": dict(kk.LAUNCHES), "rows": rows, "writes": writes[0],
                            "resumed": res.resumed_chunks, "chunks": res.chunks}}), flush=True)
'''
#: A NCCL world of size one: the control plane over gloo, then the
#: collectives on cuda:0 tensors through the NCCL group, and the sp
#: quadrature's all-reduce.
NCCL_PROBE = r'''
import json, sys
import numpy as np, torch
from bdlz_tpu_torch.config import config_from_dict, point_params_from_config, static_choices_from_config
from bdlz_tpu_torch.ops.kjma_table import make_f_table
from bdlz_tpu_torch.parallel import make_mesh, multihost as mh
from bdlz_tpu_torch.parallel.gridshard import make_sp_quadrature
cfg = config_from_dict(json.loads(sys.argv[2]))
static, dev = static_choices_from_config(cfg), torch.device("cuda", 0)
pp, table = point_params_from_config(cfg, cfg.P_chi_to_B), make_f_table(cfg.I_p)
sp = make_sp_quadrature(static, make_mesh((1, 2), devices=[dev, dev]), n_y=65536)
alone = float(sp(pp, table))
assert mh.init_multihost(f"localhost:{sys.argv[1]}", 1, 0) and mh.process_count() == 1
host = mh.allreduce_min(np.array([3, -3], dtype=np.int64)).tolist()
knobs = mh.allreduce_min(torch.tensor([7, -7], dtype=torch.int64, device=dev))
plan = mh.broadcast_from_coordinator(torch.arange(4, dtype=torch.float64, device=dev))
world = float(sp(pp, table))
torch.cuda.synchronize()
print(json.dumps({"nccl": {"backends": mh.backend_names(), "host_min": host,
    "device_min": knobs.tolist(), "device_min_on": str(knobs.device),
    "broadcast": plan.tolist(), "sp_alone": alone, "sp_in_world": world}}), flush=True)
import torch.distributed as dist
dist.destroy_process_group()
'''


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _two_processes(argv_of, env=None):
    """Start ``argv_of(pid)`` for pids 0 and 1 with JAX's env vars of one
    two-process run; ``[(rc, stdout, stderr)]``, every process stopped."""
    port = str(_free_port())
    procs = []
    for pid in (0, 1):
        penv = dict(env or _subprocess_env(), JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                    JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(argv_of(pid), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True, env=penv))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=MESH_CLI_TIMEOUT)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _probe(out: str) -> dict:
    return next(json.loads(line)["probe"] for line in out.splitlines()
                if line.startswith('{"probe"'))


def phase_mesh_path(dev) -> int:
    """Meshes and processes at full width on the card: (a) the main grid
    on a ``(2, 1)`` mesh of ``[cuda:0, cuda:0]`` through P1 (8 launches of
    4096 points) and through the tabulated engine, bitwise the runs
    without a mesh; (b) the archived point's Y_B at n_y 1,048,576 on a
    ``(1, 2)`` mesh against the one-device trapezoid and the CPU; (c)
    ``sweep_cli --multihost`` in two processes on the card (4 P1 launches
    of 4096 points each, the one-process result gathered on both, only
    the coordinator writing, a second invocation resuming every chunk),
    a two-process ``mcmc_cli --multihost`` run with checkpoints resumed
    bitwise, and a run whose kernel digest differs on one process,
    refused by both; (d) a NCCL world of one.  Returns P1's launches."""
    from bdlz_tpu_torch.config import (
        config_from_dict,
        point_params_from_config,
        static_choices_from_config,
    )
    from bdlz_tpu_torch.interop import point_params_from_numpy
    from bdlz_tpu_torch.ops import kjma_kernel as kk
    from bdlz_tpu_torch.ops.kjma_table import make_f_table, table_to_device
    from bdlz_tpu_torch.parallel import make_mesh, run_sweep
    from bdlz_tpu_torch.parallel.gridshard import make_sp_quadrature
    from bdlz_tpu_torch.solvers.quadrature import integrate_YB_quadrature_tabulated

    t0 = time.perf_counter()
    base = config_from_dict(ARCHIVED)
    static = static_choices_from_config(base)
    mesh = make_mesh((2, 1), devices=[dev, dev])
    kw = dict(chunk_size=N_POINTS, n_y=N_Y, table_nodes=TABLE_N)

    # ---- (a) the main grid on an in-process mesh, timed in turns --------
    # (plain, mesh, mesh, plain) so that first-use costs fall on neither
    plain = run_sweep(base, MAIN_AXES, static, impl="kernel", device=dev, **kw)
    rows = []
    launch = kk._launch_point

    def counted_launch(name, scalars, *rest):
        rows.append(int(scalars.shape[0]))
        return launch(name, scalars, *rest)

    kk._launch_point = counted_launch
    try:
        meshed, counts = _launches_around(
            lambda: run_sweep(base, MAIN_AXES, static, impl="kernel", mesh=mesh, **kw))
    finally:
        kk._launch_point = launch
    check(counts[MAIN_KERNEL] == 8 and sum(counts.values()) == 8 and rows == [4096] * 8,
          f"meshed P1: 8 launches of 4096 points, got {counts} rows {rows}")
    check(_bitwise(meshed.outputs, plain.outputs), "meshed P1 sweep bitwise the plain one")
    meshed2 = run_sweep(base, MAIN_AXES, static, impl="kernel", mesh=mesh, **kw)
    plain2 = run_sweep(base, MAIN_AXES, static, impl="kernel", device=dev, **kw)
    pinned = static._replace(quad_panel_gl=False)
    tab = [run_sweep(base, MAIN_AXES, pinned, impl="tabulated", **where)
           for where in ({"device": dev}, {"mesh": mesh}, {"mesh": mesh}, {"device": dev})]
    check(all(_bitwise(t.outputs, tab[0].outputs) for t in tab[1:]),
          "meshed tabulated sweep bitwise the plain one")
    grid = {"p1": {"launches": counts[MAIN_KERNEL], "rows_per_launch": rows[0],
                   "seconds": [meshed.seconds, meshed2.seconds],
                   "plain_seconds": [plain.seconds, plain2.seconds],
                   "points_per_sec": [meshed.points_per_sec, meshed2.points_per_sec],
                   "bitwise": True},
            "tabulated": {"seconds": [tab[1].seconds, tab[2].seconds],
                          "plain_seconds": [tab[0].seconds, tab[3].seconds], "bitwise": True}}

    # ---- (b) the sp quadrature at a giant n_y --------------------------
    pp, table = point_params_from_config(base, base.P_chi_to_B), make_f_table(base.I_p)
    sp = make_sp_quadrature(static, make_mesh((1, 2), devices=[dev, dev]), n_y=SP_N_Y)
    yb = float(sp(pp, table))
    one = float(integrate_YB_quadrature_tabulated(
        point_params_from_numpy(pp, dev), static.chi_stats, table_to_device(table, dev),
        n_y=SP_N_Y)[0])
    cpu = float(make_sp_quadrature(static, make_mesh((1, 2), devices=["cpu", "cpu"]),
                                   n_y=SP_N_Y)(pp, table))
    r_one, r_cpu = abs(yb / one - 1.0), abs(yb / cpu - 1.0)
    check(r_one <= SP_RTOL and r_cpu <= SP_RTOL,
          f"sp Y_B {yb!r}: one device {r_one:.3e}, CPU {r_cpu:.3e} <= {SP_RTOL:g}")
    sp_ms = _cuda_ms(lambda: sp(pp, table), reps=1, repeats=5)
    one_ms = _cuda_ms(lambda: integrate_YB_quadrature_tabulated(
        point_params_from_numpy(pp, dev), static.chi_stats, table_to_device(table, dev),
        n_y=SP_N_Y), reps=1, repeats=5)
    sp_row = {"n_y": SP_N_Y, "mesh": [1, 2], "Y_B": yb, "rel_vs_one_device": r_one,
              "rel_vs_cpu": r_cpu, "ms_median": float(np.median(sp_ms)), "ms": sp_ms,
              "one_device_ms_median": float(np.median(one_ms))}

    # ---- (c) two processes on the card ---------------------------------
    work = tempfile.mkdtemp(prefix="bdlz_mesh_")
    try:
        cfg = os.path.join(work, "cfg.json")
        with open(cfg, "w") as f:
            json.dump(ARCHIVED, f)
        out_dir = os.path.join(work, "sweep")

        def sweep_argv(tag, digest="-"):
            return lambda pid: [
                sys.executable, "-c", SWEEP_PROBE, os.path.join(work, f"{tag}_p{pid}.npz"),
                digest if pid == 1 else "-", "--config", cfg, *MAIN_AXIS_FLAGS,
                "--impl", "kernel", "--device", "cuda", "--out", out_dir, "--multihost"]

        t1 = time.perf_counter()
        cold = _two_processes(sweep_argv("cold"))
        cold_s = time.perf_counter() - t1
        check(all(rc == 0 for rc, _, _ in cold),
              f"sweep_cli --multihost: {[err[-1500:] for rc, _, err in cold if rc]}")
        probes = [_probe(out) for _, out, _ in cold]
        for pid, pr in enumerate(probes):
            check(pr["launches"][MAIN_KERNEL] == 4 and pr["rows"] == [4096] * 4,
                  f"process {pid}: 4 P1 launches of 4096 points, got {pr}")
            with np.load(os.path.join(work, f"cold_p{pid}.npz")) as data:
                check(_bitwise(dict(data), plain.outputs),
                      f"process {pid} gathered the one-process result bitwise")
        check(probes[0]["writes"] == 8 and probes[1]["writes"] == 0,
              f"only the coordinator writes: {[p['writes'] for p in probes]}")
        check(sorted(os.listdir(out_dir)) == [f"chunk_{i:05d}.npz" for i in range(4)]
              + ["manifest.json"], f"the directory: {sorted(os.listdir(out_dir))}")
        summaries = [next(json.loads(line) for line in out.splitlines()
                          if line.startswith('{"n_points"')) for _, out, _ in cold]
        check(summaries[0]["closest_to_planck"] == summaries[1]["closest_to_planck"],
              "both processes print the same closest point")
        t1 = time.perf_counter()
        warm = _two_processes(sweep_argv("warm"))
        warm_s = time.perf_counter() - t1
        check(all(rc == 0 for rc, _, _ in warm),
              f"resumed sweep_cli --multihost: {[err[-1500:] for rc, _, err in warm if rc]}")
        for pid, (_, out, _) in enumerate(warm):
            pr = _probe(out)
            check(pr["resumed"] == 4 and pr["launches"][MAIN_KERNEL] == 0,
                  f"process {pid} resumed every chunk: {pr}")
        multihost_launches = sum(p["launches"][MAIN_KERNEL] for p in probes)

        mcmc_dir = os.path.join(work, "chain")

        def mcmc_argv(tag):
            return lambda pid: [
                sys.executable, "-m", "bdlz_tpu_torch.mcmc_cli", "--config", cfg,
                "--param", "m_chi_GeV=0.05:20", "--param", "P_chi_to_B=1e-4:1",
                "--checkpoint-dir", mcmc_dir, "--out", os.path.join(work, f"{tag}.npz"),
                "--multihost"]

        t1 = time.perf_counter()
        first = _two_processes(mcmc_argv("chain1"))
        mcmc_s = time.perf_counter() - t1
        check(all(rc == 0 for rc, _, _ in first),
              f"mcmc_cli --multihost: {[err[-1500:] for rc, _, err in first if rc]}")
        again = _two_processes(mcmc_argv("chain2"))
        check(all(rc == 0 for rc, _, _ in again),
              f"resumed mcmc_cli --multihost: {[err[-1500:] for rc, _, err in again if rc]}")
        s1, s2 = (json.loads(o[0][1].strip().splitlines()[-1]) for o in (first, again))
        check(first[1][1].strip() == "" and again[1][1].strip() == "",
              "only the coordinator prints the summary")
        with np.load(os.path.join(work, "chain1.npz")) as a, \
                np.load(os.path.join(work, "chain2.npz")) as b:
            chain_same = bool(np.array_equal(a["chain"], b["chain"])
                              and np.array_equal(a["logp"], b["logp"]))
        check(s2["resumed_segments"] == 5 and chain_same and s1["walkers"] == 64,
              f"mcmc resumed bitwise: {s2['resumed_segments']} segments, {chain_same}")

        mixed = _two_processes(sweep_argv("mixed", digest="f" * 16))
        refused = [rc != 0 and "kernel library digest differs across hosts" in err
                   for rc, _, err in mixed]
        check(all(refused), f"mixed digests refused on both: {[e[-800:] for _, _, e in mixed]}")

        # ---- (d) a NCCL world of one --------------------------------------
        nccl = subprocess.run([sys.executable, "-c", NCCL_PROBE, str(_free_port()),
                               json.dumps(ARCHIVED)], capture_output=True, text=True,
                              env=_subprocess_env(), timeout=MESH_CLI_TIMEOUT)
        check(nccl.returncode == 0, f"NCCL world of one: {nccl.stderr[-1500:]}")
        world = json.loads(nccl.stdout.strip().splitlines()[-1])["nccl"]
        check(world["backends"] == {"host": "gloo", "device": "nccl"}
              and world["host_min"] == [3, -3] and world["device_min"] == [7, -7]
              and world["device_min_on"] == "cuda:0" and world["broadcast"] == [0.0, 1.0, 2.0, 3.0]
              and world["sp_in_world"] == world["sp_alone"], f"NCCL world of one: {world}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "mesh_path", "seconds": time.perf_counter() - t0,
          "mesh": {"shape": [2, 1], "members": [str(dev)] * 2}, "grid": grid, "sp": sp_row,
          "multihost": {"processes": 2, "p1_launches": [p["launches"][MAIN_KERNEL] for p in probes],
                        "rows_per_launch": probes[0]["rows"][0], "bitwise": True,
                        "coordinator_writes": probes[0]["writes"],
                        "other_writes": probes[1]["writes"], "seconds": cold_s,
                        "resume_seconds": warm_s, "resumed_chunks": 4},
          "mcmc": {"processes": 2, "walkers": s1["walkers"], "steps": s1["steps"],
                   "seconds": mcmc_s, "resumed_segments": s2["resumed_segments"],
                   "bitwise": chain_same, "acceptance": s1["acceptance"]},
          "mixed_digest_refused": [bool(r) for r in refused], "nccl_world_of_one": world})
    return counts[MAIN_KERNEL] + multihost_launches


# ---- graft_path: the compile-check entry points on the card ----------------
GRAFT_RTOL = 1e-12       # the card against the host on the same call
GRAFT_MESHES = (2, 4)    # members, all on the one card: meshes (1, 2) and (2, 2)


def phase_graft_path(dev) -> int:
    """The compile-check entry points (``bdlz_tpu_torch/graft_entry.py``) on the
    card: ``entry()``'s forward step on cuda:0 against the same step on
    the CPU and its time per call (CUDA events, median of 5); then
    ``dryrun_multichip(n)`` for n = 2 and 4 with every member on the one
    card, each step against the same call on host members (χ², ratios,
    P1 ratios and the sp Y_B ≤1e-12 rel; the ESDIRK Y_B at the stiff
    engine's card-vs-CPU tolerance) and P1 launched once per member.
    Returns P1's launches."""
    from bdlz_tpu_torch import graft_entry as ge

    t0 = time.perf_counter()
    fn, (pp, table) = ge.entry()
    check(pp.m_chi_GeV.device == dev and table.values.device == dev,
          f"entry() on the card, got {pp.m_chi_GeV.device}")
    got = fn(pp, table)
    cpu_fn, cpu_args = ge.entry(device="cpu")
    r_entry = _max_rel(got.cpu().numpy(), cpu_fn(*cpu_args).numpy())
    check(got.shape == (8,) and got.dtype == torch.float64 and r_entry <= GRAFT_RTOL,
          f"entry() fn on the card vs the CPU {r_entry:.3e} <= {GRAFT_RTOL:g}")
    entry_ms = _cuda_ms(lambda: fn(pp, table), reps=1, repeats=5)

    runs, p1 = {}, 0
    for n in GRAFT_MESHES:
        t1 = time.perf_counter()
        card, counts = _launches_around(lambda: ge.dryrun_multichip(n))
        card_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        host = ge.dryrun_multichip(n, devices="cpu")
        host_s = time.perf_counter() - t1
        check(counts[MAIN_KERNEL] == n and sum(counts.values()) == n,
              f"dryrun({n}): one P1 launch per member and no other kernel, got {counts}")
        check(card["mesh"] == host["mesh"] == {"dp": n // 2, "sp": 2}
              and card["engines"] == host["engines"], f"dryrun({n}): {card['engines']}")
        rel = {key: _max_rel(card[key], host[key])
               for key in ("chi2", "ratios", "ratios_kernel", "YB_sp", "Y_B_esdirk")}
        tabulated = _max_rel(card["ratios_kernel"], card["ratios"])
        check(max(v for k, v in rel.items() if k != "Y_B_esdirk") <= GRAFT_RTOL
              and rel["Y_B_esdirk"] <= CARD_CPU_RTOL and tabulated <= ge.KERNEL_RTOL,
              f"dryrun({n}) card vs host {rel}, P1 vs tabulated {tabulated:.3e}")
        p1 += counts[MAIN_KERNEL]
        runs[n] = {"mesh": card["mesh"], "members": [str(dev)] * n, "batch": card["batch"],
                   "chi2": card["chi2"], "p1_launches": counts[MAIN_KERNEL],
                   "card_vs_host_max_rel": rel, "p1_vs_tabulated_max_rel": tabulated,
                   "seconds": card_s, "host_seconds": host_s}
    emit({"phase": "graft_path", "seconds": time.perf_counter() - t0,
          "entry": {"points": int(got.shape[0]), "n_y": ge.ENTRY_N_Y,
                    "table_n": ge.ENTRY_TABLE_N, "card_vs_cpu_max_rel": r_entry,
                    "ms_median": float(np.median(entry_ms)), "ms": entry_ms},
          "dryrun": runs, "p1_launches": p1})
    return p1


OVERLAP_RUNS = 5           # main-grid runs per side, taken in turns
N_GATE = 1024              # the tiered gate's audit population
GATE_RTOL = 1e-10          # each kernel tier against the tabulated engine


def _device_timeline(prof) -> dict:
    """Device activity of a ``torch.profiler`` run: busy time, the idle
    gaps between merged device intervals (the three largest, with where
    they fall and the device work on either side), and at each
    device-to-host copy but the last (the chunk boundaries) the gap to
    the next device work and how many kernels the host had already
    launched that had not yet started on the device."""
    from torch.autograd import DeviceType

    events = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events() if e.device_type == DeviceType.CUDA)
    launches = sorted(e.time_range.start for e in prof.events()
                      if e.device_type == DeviceType.CPU and e.name.startswith("cudaLaunchKernel"))
    kernel_starts = sorted(start for start, _, name in events
                           if "Memcpy" not in name and "Memset" not in name)
    merged = []
    for start, end, name in events:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
            merged[-1][3] = name
        else:
            merged.append([start, end, name, name])
    gaps = sorted(((b[0] - a[1], a[1], a[3], b[2]) for a, b in zip(merged, merged[1:])),
                  reverse=True)
    t_first = merged[0][0] if merged else 0.0
    boundary, ahead = [], []
    d2h = [end for _, end, name in events if "DtoH" in name]
    for end in d2h[:-1]:
        later = [m[0] for m in merged if m[0] >= end]
        if later:
            boundary.append((later[0] - end) / 1e3)
        ahead.append(sum(1 for t in launches if t < end)
                     - sum(1 for t in kernel_starts if t < end))
    return {"busy_ms": sum(m[1] - m[0] for m in merged) / 1e3,
            "span_ms": (merged[-1][1] - t_first) / 1e3 if merged else 0.0,
            "largest_idle_gap_ms": gaps[0][0] / 1e3 if gaps else 0.0,
            "idle_ms": sum(g[0] for g in gaps) / 1e3, "d2h_copies": len(d2h),
            "largest_gaps": [{"ms": g / 1e3, "at_ms": (t - t_first) / 1e3,
                              "after": a[:64], "before": b[:64]} for g, t, a, b in gaps[:3]],
            "chunk_boundary_gaps_ms": boundary,
            "kernels_enqueued_ahead_at_d2h_end": ahead}


def phase_overlap_path(dev) -> dict:
    """The sweep's double-buffered chunk loop on the main grid (32768
    points in 4 chunks of 8192, n_y 8000, P1) against the serial loop,
    in turns, 5 runs each: outputs bitwise equal, points/s per side, and
    under ``torch.profiler`` each side's device busy share, largest idle
    gap, chunk-boundary gaps and peak memory.  Then the tiered population
    gate (``validation.engine_population_max_rel`` through
    ``parallel.sweep.make_chunk_runner``) for P1-P4 on 1024 audit points
    against the tabulated engine.  Returns each kernel's launches."""
    from torch.profiler import ProfilerActivity, profile

    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.ops import kjma_kernel as kk
    from bdlz_tpu_torch.ops.kjma_table import make_f_table, table_to_device
    from bdlz_tpu_torch.parallel.sweep import make_chunk_runner, run_sweep
    from bdlz_tpu_torch.validation import build_audit_population, engine_population_max_rel

    t0 = time.perf_counter()
    base = config_from_dict(ARCHIVED)
    static = static_choices_from_config(base)
    kw = dict(impl="kernel", chunk_size=N_POINTS, n_y=N_Y, table_nodes=TABLE_N, device=dev)
    launches = dict.fromkeys(kk.LAUNCHES, 0)

    def run(overlap):
        torch.cuda.reset_peak_memory_stats(dev)
        res, counts = _launches_around(lambda: run_sweep(base, MAIN_AXES, static,
                                                         overlap_chunks=overlap, **kw))
        check(counts[MAIN_KERNEL] == 4 and sum(counts.values()) == 4,
              f"overlap={overlap}: 4 P1 launches and no other kernel, got {counts}")
        for k in launches:
            launches[k] += counts.get(k, 0)
        return res, counts[MAIN_KERNEL], torch.cuda.max_memory_allocated(dev)

    first, _, _ = run(False)
    ref = first.outputs
    sides = {True: {"pps": [], "p1": [], "peak": []}, False: {"pps": [], "p1": [], "peak": []}}
    for _ in range(OVERLAP_RUNS):
        for overlap in (True, False):
            res, p1, peak = run(overlap)
            check(res.n_failed == 0 and res.chunks == 4, f"overlap={overlap}: 4 chunks, finite")
            check(all(res.outputs[f].tobytes() == ref[f].tobytes() for f in ref),
                  f"overlap={overlap}: outputs bitwise the first serial run's")
            sides[overlap]["pps"].append(res.points_per_sec)
            sides[overlap]["p1"].append(p1)
            sides[overlap]["peak"].append(peak)
    out = {}
    for overlap in (True, False):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res, _, peak = run(overlap)
        tl = _device_timeline(prof)
        side = sides[overlap]
        out["overlap" if overlap else "serial"] = {
            "points_per_sec_median": float(np.median(side["pps"])),
            "points_per_sec_samples": side["pps"], "p1_launches_per_run": side["p1"],
            "peak_mem_bytes": max(side["peak"]),
            "profiled": {"wall_ms": res.seconds * 1e3,
                         "device_busy_share": tl["busy_ms"] / (res.seconds * 1e3),
                         "peak_mem_bytes": peak, **tl}}
    gain = (out["overlap"]["points_per_sec_median"] / out["serial"]["points_per_sec_median"])

    # the tiered gate through the chunk runner, against the tabulated engine
    pop = build_audit_population(base, N_GATE)
    gstatic = static._replace(quad_panel_gl=False)
    table = table_to_device(make_f_table(base.I_p, n=TABLE_N), dev)
    ref_run, ref_chunk = make_chunk_runner(pop.grid, N_GATE, gstatic, table,
                                           impl="tabulated", n_y=N_Y, device=dev)
    check(ref_chunk == N_GATE, f"tabulated runner chunk {ref_chunk}")
    ref_pop = ref_run(0, N_GATE)
    gates = {}
    for name, (fuse_exp, reduce) in TIERS.items():
        t1 = time.perf_counter()
        rel, counts = _launches_around(lambda: engine_population_max_rel(
            pop.grid, ref_pop, gstatic, table, impl="kernel", n_y=N_Y, fuse_exp=fuse_exp,
            reduce=reduce, device=dev))
        kernel = TIER_KERNEL[name]
        check(counts[kernel] == 1 and sum(counts.values()) == 1,
              f"gate {name}: one launch of {kernel}, got {counts}")
        check(rel <= GATE_RTOL, f"gate {name}: {rel:.3e} <= {GATE_RTOL:g}")
        launches[kernel] += counts[kernel]
        gates[name] = {"kernel": kernel, "max_rel_vs_tabulated": rel, "launches": counts[kernel],
                       "seconds": time.perf_counter() - t1}
    emit({"phase": "overlap_path", "points": first.n_points, "chunk": N_POINTS, "n_y": N_Y,
          "table_n": TABLE_N, "runs_per_side": OVERLAP_RUNS, "outputs_bitwise": True,
          "sides": out, "rate_ratio_overlap_over_serial": gain,
          "gate": {"population": N_GATE, "tiers": gates},
          "seconds": time.perf_counter() - t0})
    return launches


#: The evidence tools' arguments in evidence_path: cut from their defaults
#: (1024 audit points, n_y up to 128000, a 65536-point grid, 64 speeds and a
#: 256-node table, 1 to 8 members) to keep the phase near two minutes.
EVIDENCE_ARGS = {
    "accuracy_audit": ["--points", "128", "--n-y", str(N_Y)],
    "ny_convergence": ["--levels", "2000,8000,32000", "--sp", "2"],
    "impl_shootout": ["--points", str(N_POINTS), "--gate-points", "64"],
    "lz_scale_bench": ["--rows", "1000001", "--speeds", "8", "--table-n", "32"],
    "weak_scaling": ["--counts", "1,2"],
}
EVIDENCE_GATE_RTOL, SP_RTOL = 1e-9, 1e-12


def _run_tool(name: str, argv: list) -> tuple:
    """``scripts/torch_<name>.py``'s ``main(argv)`` in this process, its
    standard output captured: (exit code, JSON lines, seconds)."""
    import contextlib
    import importlib.util
    import io

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    rows = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
    return rc, rows, time.perf_counter() - t0


def phase_evidence_path(dev) -> dict:
    """The port's evidence tools (``scripts/torch_*.py``) on the card,
    each through its ``main`` at the sizes of ``EVIDENCE_ARGS``: the
    grid-wide accuracy audit (both sections inside the 1e-6 contract, P1
    ≤1e-9 from the reference, launched once), the n_y convergence study
    (the sp row ≤1e-12 from one device), the engine shoot-out (five
    engines, each gate ≤1e-9, P1-P4 each launched once a chunk, once for
    the warm-up and once for the gate), the LZ scale run (P finite in [0,
    1]) and weak scaling (no failed point; its children run the sweep in
    processes of their own).  The reference cache lives in a temporary
    directory, so no run reads an earlier one.  Returns each kernel's
    launches."""
    from bdlz_tpu_torch.backend import device_label

    t0 = time.perf_counter()
    smi = device_label(dev)
    launches = dict.fromkeys(POINT_KERNELS, 0)
    tmp = tempfile.mkdtemp(prefix="bdlz_evidence_")
    old_cache = os.environ.get("BDLZ_REF_CACHE_DIR")
    os.environ["BDLZ_REF_CACHE_DIR"] = os.path.join(tmp, "refcache")
    try:
        runs, seconds = {}, {}
        for name, argv in EVIDENCE_ARGS.items():
            if name == "accuracy_audit":
                argv = argv + ["--out", os.path.join(tmp, "audit.json")]
            (rc, rows, seconds[name]), counts = _launches_around(lambda: _run_tool(name, argv))
            check(rc == 0, f"{name} {argv}: exit code {rc}")
            check(rows and all(r["device"] == smi for r in rows),
                  f"{name}: every row names the card, got {[r['device'] for r in rows]}")
            runs[name] = (rows, counts)
            for k in launches:
                launches[k] += counts[k]

        rows, counts = runs["accuracy_audit"]
        with open(os.path.join(tmp, "audit.json")) as f:
            audit = json.load(f)
        kern = audit["kernel"]
        check(audit["contract_1e-6_ok"] and kern["contract_1e-6_ok"],
              f"audit: tabulated {audit['max_rel_err']:.3e}, P1 {kern['max_rel_err']:.3e} <= 1e-6")
        check(kern["max_rel_err"] <= REF_RTOL and kern["impl"] == "cuda",
              f"audit: P1 {kern['max_rel_err']:.3e} <= {REF_RTOL:g} on the card")
        check(counts[MAIN_KERNEL] == kern["launches"] == 1 and sum(counts.values()) == 1,
              f"audit: one P1 launch and no other kernel, got {counts}")

        rows, counts = runs["ny_convergence"]
        check(len(rows) == 4 and rows[-1]["rel_vs_single_device"] <= SP_RTOL
              and sum(counts.values()) == 0,
              f"convergence: sp row {rows[-1]} <= {SP_RTOL:g}, no kernel, got {counts}")

        rows, counts = runs["impl_shootout"]
        check(len(rows) == 5 and not any("error" in r or "gate_error" in r for r in rows),
              f"shoot-out: five engines without an error, got {rows}")
        for r in rows:
            check(r["gate_max_rel_err"] <= EVIDENCE_GATE_RTOL
                  and r["max_rel_err_vs_reference"] <= EVIDENCE_GATE_RTOL,
                  f"shoot-out {r['engine']}: sample {r['max_rel_err_vs_reference']:.3e}, gate "
                  f"{r['gate_max_rel_err']:.3e} <= {EVIDENCE_GATE_RTOL:g}")
            if "kernel" in r:
                want = r["n_evaluated"] // r["chunk"] + 3  # two warm-ups and the gate
                check(counts[r["kernel"]] == want and r["impl"] == "cuda",
                      f"shoot-out {r['engine']}: {want} launches of {r['kernel']}, got {counts}")
        check(sum(counts.values()) == sum(counts[r["kernel"]] for r in rows if "kernel" in r),
              f"shoot-out: no other kernel, got {counts}")

        rows, counts = runs["lz_scale_bench"]
        ranges = [r["P_range"] for r in rows[1:]]
        check([r["phase"] for r in rows] == ["parse", "coherent", "ptable"]
              and all(r["finite"] for r in rows[1:])
              and all(0.0 <= lo <= hi <= 1.0 for lo, hi in ranges) and sum(counts.values()) == 0,
              f"lz scale: P finite in [0, 1], no kernel, got {ranges}, {counts}")

        rows, _ = runs["weak_scaling"]
        check([r["n_devices"] for r in rows] == [1, 2] and all(r["n_failed"] == 0 for r in rows),
              f"weak scaling: 1 and 2 members without a failed point, got {rows}")
    finally:
        if old_cache is None:
            os.environ.pop("BDLZ_REF_CACHE_DIR", None)
        else:
            os.environ["BDLZ_REF_CACHE_DIR"] = old_cache
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "evidence_path", "seconds": time.perf_counter() - t0,
          "tool_seconds": seconds, "launches": launches,
          "audit": {k: v for k, v in audit.items() if k != "worst_points"},
          **{name: runs[name][0] for name in EVIDENCE_ARGS if name != "accuracy_audit"}})
    return launches


#: Phases that can run on their own (``--only``); such a run prints no
#: kernels line and no ok line.
STANDALONE = {"overlap_path": phase_overlap_path,
              "robust_path": phase_robust_path, "emulator_path": phase_emulator_path,
              "sampling_path": phase_sampling_path, "host_planes": phase_host_planes,
              "serving_path": phase_serving_path, "elastic_path": phase_elastic_path,
              "fabric_path": phase_fabric_path, "mesh_path": phase_mesh_path,
              "graft_path": phase_graft_path, "evidence_path": phase_evidence_path,
              "bloch_path": phase_bloch_path}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke test of the port on one NVIDIA GPU")
    ap.add_argument("--only", default=None,
                    help=f"comma list of phases to run alone, of {sorted(STANDALONE)}")
    only = ap.parse_args(argv).only
    only = only.split(",") if only else None
    if only and not set(only) <= set(STANDALONE):
        ap.error(f"--only takes {sorted(STANDALONE)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # the port itself: a directory holding only this script fails here
    from bdlz_tpu_torch.ops import kjma_kernel as kk

    t0 = time.perf_counter()
    dev_info = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    if only:
        for name in only:
            STANDALONE[name](dev)
        emit({"phase": "done", "seconds": time.perf_counter() - t0, "only": only})
        return 0
    table, errs, parity_pp = phase_parity(dev)
    errs.update(phase_point_parity(dev, parity_pp, table))
    del parity_pp
    launches = phase_main_path(dev)
    timing, sweep_pps = phase_timing(dev, table)
    # P1 through the double-buffered and the serial loop, P1-P4 through
    # the chunk runner's tiered gate
    for name, n in phase_overlap_path(dev).items():
        launches[name] += n
    phase_stiff_path(dev)
    phase_panel_path(dev, sweep_pps)
    phase_cli(dev)
    bounce = phase_bounce_path(dev)
    bloch_launches = phase_lz_path(dev, bounce.pop("solution"), sweep_pps)
    # the row's time, bound and parity at the cell's shape; its launches
    # are the main path's, those of the dephased and thermal sweeps
    bloch = phase_bloch_path(dev, bloch_launches)
    phase_robust_path(dev)
    artifact = phase_emulator_path(dev)
    phase_sampling_path(dev, artifact)
    phase_host_planes(dev)
    # P1's row counts the main path's launches and the serving run's
    launches[MAIN_KERNEL] += phase_serving_path(dev, artifact)
    # P1-P4 on the elastic sweep, and P1 through tenancy, refinement and
    # the fabric
    for name, n in phase_elastic_path(dev).items():
        launches[name] += n
    launches[MAIN_KERNEL] += phase_fabric_path(dev, artifact)
    # P1 on every mesh member and every process
    launches[MAIN_KERNEL] += phase_mesh_path(dev)
    # P1 on every member of the mesh dry runs
    launches[MAIN_KERNEL] += phase_graft_path(dev)
    # P1 through the accuracy audit, P1-P4 through the shoot-out
    for name, n in phase_evidence_path(dev).items():
        launches[name] += n
    check(all(launches[k] > 0 for k in TIER_KERNEL.values()),
          f"every tier's kernel launched on the main path, got {launches}")
    from bdlz_tpu_torch.ops import bounce_kernel as bk

    emit({"kernels": [{
        "name": kk.KERNELS[name][0],
        "route": "cuda",
        "source": "bdlz_tpu_torch/csrc/" + kk.POINT_SOURCE,
        "replaces": kk.KERNELS[name][1],
        "launches": launches[name],
        "max_abs_err": errs[name]["max_abs_err"],
        "ms": timing[name]["ms"],
        "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the KJMA integrand
    } for name in POINT_KERNELS] + [{
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
    }, bloch]})  # no PyTorch call propagates a dephased Bloch vector
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "device": dev_info["nvidia_smi"]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev_info["name"],
                                 "count": dev_info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
