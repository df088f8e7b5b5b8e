"""The frozen yardstick of the dephased Landau-Zener transport's work.

A sweep of the thermal scenario propagates every distinct (v_w, Gamma_phi)
pair of its grid, a lane, through the profile's S real segments (n_xi - 1;
a tree's padding to a power of two is not work).  The count is the least
work a lane-segment needs, so that no implementation reads above its
bound: values a segment's lanes share (w = sqrt(a^2 + b^2), w dxi, a/w,
b/w) and values a lane's segments share (1/v, Gamma/v) are hoisted and
not counted, and each segment's map is applied to the lane's Bloch
vector, never composed into a 3x3 product.  Per lane and segment, in f64
instructions (an FMA counts as one):

* the phase theta = (w dxi)(1/v): 1;
* the decay's exponent (Gamma/v) dxi: 1;
* cos theta, sin theta and the decay exp(-Gamma tau): 20 each, the exp
  rate of ``work.py``: 60;
* the rotation's unit quaternion (cos theta, x, 0, z), x = (b/w) sin theta
  and z = (a/w) sin theta, and the doubled 2x, 2z: 4;
* the rotation of the Bloch vector r in the Rodrigues form: t = 2 q x r
  (its y-component of q is 0: 4), then r + cos theta t + q x t (7): 11;
* the decay of the two coherence components: 2.

That is 1 + 1 + 60 + 4 + 11 + 2 = 79, frozen here so that it reads the
same work whatever implements the transport later.  (The port's scheme
builds each segment's 3x3 adjoint and composes the maps by a tree, 27
FMA a product: more work than this least.)  Bytes: the segments'
(a, b, dxi) read once, each lane's v and Gamma read once and its P
written once, all f64.  The chip's peaks are ``work.py``'s.
"""
from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

from benchmark.harness.work import PEAK_F64_INSTR_PER_S, PEAK_HBM_BYTES_PER_S
from benchmark.reference.bloch import V_MAX, V_MIN, bath_rate

F64_INSTR_PER_LANE_SEGMENT = 1 + 1 + 60 + 4 + 11 + 2
BYTES_PER_SEGMENT = 3 * 8
BYTES_PER_LANE = 3 * 8


def lanes(axes: Mapping[str, np.ndarray], config: Mapping) -> int:
    """The distinct (v_w, Gamma_phi) pairs of a product grid over ``axes``
    at the configuration's other values."""
    yc = config["yields_config"]
    T = np.asarray(axes.get("T_p_GeV", [yc["T_p_GeV"]]), dtype=np.float64)
    v = np.asarray(axes.get("v_w", [yc["v_w"]]), dtype=np.float64)
    rates = np.unique(bath_rate(T, yc["lz_bath_eta"], yc["lz_bath_omega_c"]))
    return int(rates.size * np.unique(np.clip(v, V_MIN, V_MAX)).size)


def least_seconds(n_lanes: int, n_segments: int) -> float:
    """The least time the chip needs for ``n_lanes`` lanes over
    ``n_segments`` segments: the larger of the operations over the FP64
    instruction rate and the bytes over HBM's rate."""
    ops = float(n_lanes) * n_segments * F64_INSTR_PER_LANE_SEGMENT
    nbytes = n_segments * BYTES_PER_SEGMENT + n_lanes * BYTES_PER_LANE
    return max(ops / PEAK_F64_INSTR_PER_S, nbytes / PEAK_HBM_BYTES_PER_S)


def least_seconds_of(sweeps: Iterable, config: Mapping) -> float:
    """Summed over the sweeps, from their requests' axes."""
    n_seg = int(config["solver"]["n_xi"]) - 1
    return sum(least_seconds(lanes(s.request.axes, config), n_seg) for s in sweeps)
