"""The frozen yardstick of the point kernel's work, and the chip's peaks.

The y-quadrature of a point runs over the window [y_lo, y_hi] with
y(T) = (beta/H)/2 ((T_p/T)^2 - 1), y_lo = max(y(T_max), -80) and
y_hi = min(y(T_min), +50); a point whose window is empty does no node
work.  A point with a window evaluates max(n_y, 2000) nodes, and each node
costs ``F64_INSTR_PER_NODE`` f64 instructions: 49 adds, multiplies,
compares and conversions (the node's y 4, d 3, the clamp 2, the window
exponent 2, the seam 2, the exponent 2, the statistics factor 1, the
weight 1, the exponent's argument and two products 3, the table index 6,
the cubic's offsets, weights and taps 20, the product, the cut and the
sum 3), 4 IEEE divisions at ~9 instructions each, a square root at ~8 and
an exp at ~20 -- the count of the point kernel's source when this
benchmark was written, frozen here so that it reads the same work
whatever implements the kernel later.  Bytes: each point's 10 f64 inputs
and the table read once, one f64 per point written.
"""
from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

from benchmark.reference.yields import window_bounds

F64_INSTR_PER_NODE = 49 + 4 * 9 + 8 + 20
INPUTS_PER_POINT = 10
N_Y_FLOOR = 2000

#: NVIDIA H100 SXM (data sheet, 700 W): 34 TFLOP/s FP64 outside the tensor
#: cores, which counts an FMA as two, so 17e12 f64 instructions a second
#: (one per FP64 lane and clock); HBM3 at 3.35 TB/s.
PEAK_F64_INSTR_PER_S = 34e12 / 2
PEAK_HBM_BYTES_PER_S = 3.35e12


def nonempty(inputs: Mapping[str, np.ndarray]) -> np.ndarray:
    y_lo, y_hi = window_bounds(inputs["T_p_GeV"], inputs["beta_over_H"],
                               inputs["T_max_over_Tp"], inputs["T_min_over_Tp"])
    return y_hi > y_lo


def least_seconds(inputs: Mapping[str, np.ndarray], n_y: int, table_nodes: int,
                  chunk: int) -> float:
    """The least time the chip needs for one sweep's point-kernel work:
    per chunk of ``chunk`` points the larger of its operations over the
    FP64 instruction rate and its bytes over HBM's rate, summed."""
    ok = nonempty(inputs)
    nodes = max(int(n_y), N_Y_FLOOR)
    total = 0.0
    for lo in range(0, ok.shape[0], chunk):
        part = ok[lo:lo + chunk]
        ops = float(part.sum()) * nodes * F64_INSTR_PER_NODE
        nbytes = part.shape[0] * (INPUTS_PER_POINT + 1) * 8 + table_nodes * 8
        total += max(ops / PEAK_F64_INSTR_PER_S, nbytes / PEAK_HBM_BYTES_PER_S)
    return total


def least_seconds_of(sweeps: Iterable, config: Mapping) -> float:
    """Summed over the traced sweeps, from their requests' inputs."""
    from benchmark.reference.yields import point_inputs

    return sum(least_seconds(point_inputs(config["yields_config"], s.request.axes),
                             s.request.kwargs["n_y"], s.request.kwargs["table_nodes"],
                             s.request.kwargs["chunk_size"]) for s in sweeps)
