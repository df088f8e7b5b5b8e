"""Shared pieces of the benchmark's own tests (``python -m pytest benchmark/tests``).

They run on the CPU at tiny sizes: the cells' own files, cut to a few
points per axis, n_y 2000 and 64-point chunks.  The port's plain bounce
shoot takes minutes on the CPU, so a cell that shoots gets the
reference's solution of the same potential in its place (``tiny_cell``
patches ``bdlz_tpu_torch.bounce.shooting.solve_bounce``); the card runs
the port's own shoot.
"""
from __future__ import annotations

import time

import numpy as np
import pytest

from benchmark.harness import spec
from benchmark.reference import bounce as rb

CELLS = ("equal_mass.scan_kernel", "bounce_lz.potential_scan", "equal_mass.scan_default")
SEED = 2 ** 31 + 12345


def _reference_solution(config):
    """A stand-in for the port's ``solve_bounce``: the reference's release
    point and dense pass in the port's ``BounceSolution``."""
    from bdlz_tpu_torch.bounce import shooting as sh

    slv = config["solver"]

    def solve(spec_, **_knobs):
        s = sh.as_potential_spec(spec_)
        phi0 = rb.release_point(s.lam4, s.vev, s.eps, rho0=slv["rho0"], rho_max=slv["rho_max"],
                                n_bisect=slv["n_bisect"])
        rho, phi = rb.dense_profile(phi0, s.lam4, s.vev, s.eps, rho0=slv["rho0"],
                                    rho_max=slv["rho_max"], n_dense=slv["n_dense"])
        pf, _, pt = rb.vacua(s.lam4, s.vev, s.eps)
        i = int(np.flatnonzero(phi <= 0.5 * (pf + pt))[0])
        r_wall = rho[i - 1] + (0.5 * (pf + pt) - phi[i - 1]) / (phi[i] - phi[i - 1]) * (
            rho[i] - rho[i - 1])
        return sh.BounceSolution(np.float64(phi0), np.float64(r_wall), np.float64(0.0),
                                 np.bool_(True), rho, phi, np.gradient(phi, rho))

    return solve


def shrink(cell: spec.Cell, points_per_axis: int = 4) -> spec.Cell:
    cfg = dict(cell.config, sweep=dict(cell.config["sweep"], n_y=2000, chunk_size=64))
    traffic = dict(cell.traffic)
    traffic["axes"] = {k: ":".join(v.split(":")[:3] + [str(points_per_axis)])
                       for k, v in cell.traffic["axes"].items()}
    traffic["check"] = {"points_per_sweep": 16,
                        "sweeps": "all" if cell.traffic["check"]["sweeps"] == "all" else 1}
    return cell._replace(config=cfg, traffic=traffic)


@pytest.fixture
def tiny_cell(monkeypatch):
    """``tiny_cell(name)``: the cell's files cut to CPU size (the port's
    shoot replaced as the module docstring says)."""
    def make(name: str) -> spec.Cell:
        cell = shrink(spec.load_cell(name))
        if "solver" in cell.config:
            import bdlz_tpu_torch.bounce.shooting as sh

            monkeypatch.setattr(sh, "solve_bounce", _reference_solution(cell.config))
        return cell

    return make


def run_cell(cell: spec.Cell, seconds: float = 1.0, trace: bool = False, seed: int = SEED):
    """Set-up, window, check and the result object of a run on the CPU (a
    cell that shoots gets 8 s or more: its stand-in shoot takes ~2 s)."""
    from benchmark.harness import main as hm

    if "solver" in cell.config:
        seconds = max(seconds, 8.0)

    t0 = time.perf_counter()
    run, peak = hm.measure(cell, seed, seconds, trace, "cpu", t0)
    info = {"platform": "cpu", "kind": "cpu", "count": 1}
    return run, hm.result(cell, run, trace, seed, "cpu", peak, info)

