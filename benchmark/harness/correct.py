"""The check that decides ``correct``: what the timed sweeps produced against
the plain reference, at the points each sweep's sample drew.

Compared numbers, each with the limit the configuration file gives it (a
number whose limit the file does not give is not compared):

* ``max_rel_err``: the largest relative gap |program / reference - 1| over
  Y_B, Y_chi and DM_over_B at every sampled point of the checked sweeps,
  the reference on the y-quadrature the program reports it ran (a zero
  reference value is judged against the median magnitude; a value that
  is not finite counts as infinitely far);
* ``trap_rel_err``: the same gap against the reference on the n_y-node
  trapezoid, the scheme of the 1e-6 contract, whatever scheme the program
  chose: it judges the population audit's choice of the panel rule;
* ``failed_points``: points of the window's sweeps that the program
  marked failed, and every point of a sweep that raised.
"""
from __future__ import annotations

from typing import List, Mapping, Sequence, Tuple

import numpy as np

from benchmark.harness import spec
from benchmark.harness import traffic as tr
from benchmark.harness.program import OUTPUTS

#: The gaps to the reference, each with the y-quadrature the reference runs.
GAPS = (("max_rel_err", lambda r: r.quad_impl), ("trap_rel_err", lambda r: "trap"))


def relative_errors(got, ref) -> np.ndarray:
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    nz = ref != 0.0
    scale = np.median(np.abs(ref[nz])) if nz.any() else 1.0
    with np.errstate(divide="ignore", invalid="ignore"):
        err = np.where(nz, np.abs(got / np.where(nz, ref, 1.0) - 1.0), np.abs(got) / scale)
    return np.where(np.isfinite(got) & np.isfinite(err), err, np.inf)


def checked(records: Sequence, traffic: Mapping, seed: int) -> list:
    """The window's completed sweeps whose samples the reference works
    out: all of them, or a draw of the mix's ``check.sweeps`` from the seed."""
    done = [r for r in records if not r.cut and r.error is None]
    k = traffic["check"]["sweeps"]
    if k == "all" or len(done) <= int(k):
        return done
    pick = tr.rng(seed, tr.SAMPLE, 1 << 30).choice(len(done), size=int(k), replace=False)
    return [done[i] for i in sorted(pick)]


def reference_outputs(config: Mapping, record, scheme: str, device, cache: dict,
                      **precision):
    """The reference's outputs at ``record``'s sampled points on ``scheme``,
    kept in ``cache`` (one cache per precision)."""
    import torch

    key = ("outputs", record.request.index, scheme)
    if key not in cache:
        cache[key] = spec.reference(config)(
            config, record.request, record.sample, scheme=scheme, device=device, cache=cache,
            **{"dtype": torch.float64, **precision})
    return cache[key]


def worst_gap(config: Mapping, sweeps: Sequence, scheme_of, device, cache: dict) -> float:
    """max |program / reference - 1| over the sweeps' samples and the
    compared outputs, the reference on ``scheme_of(record)``."""
    worst = 0.0
    for r in sweeps:
        ref = reference_outputs(config, r, scheme_of(r), device, cache)
        for f in OUTPUTS:
            worst = max(worst, float(np.max(relative_errors(r.outputs[f], ref[f]))))
    return worst


def check(config: Mapping, traffic: Mapping, records: Sequence, seed: int,
          device) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """``(correct, [(name, value, limit), ...])`` for the window's records."""
    limits = config["limits"]
    done = [r for r in records if not r.cut]
    sweeps = checked(records, traffic, seed)
    cache: dict = {}
    numbers = [(name, worst_gap(config, sweeps, scheme_of, device, cache) if sweeps
                else float("inf"), float(limits[name]))
               for name, scheme_of in GAPS if name in limits]
    numbers.append(("failed_points", float(sum(r.n_failed for r in done)),
                    float(limits["failed_points"])))
    return all(v <= lim for _, v, lim in numbers), numbers
