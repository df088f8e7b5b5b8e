"""Port physics (L1-L3), F table and y-grids against the JAX package's
NumPy path, on both sides of the T = m/3 seam.

Tolerances: ≤1e-14 rel for elementwise physics (PyTorch's CPU pow/exp
may differ from NumPy's libm by an ulp or two); the F table bitwise
(both are built by the same host NumPy code).
"""
import numpy as np
import pytest
import torch

import bdlz_tpu.ops.kjma_table as jt
import bdlz_tpu.physics.percolation as jp
import bdlz_tpu.physics.source as js
import bdlz_tpu.physics.thermo as jth

import bdlz_tpu_torch.ops.kjma_table as tt
import bdlz_tpu_torch.physics.percolation as tp
import bdlz_tpu_torch.physics.source as ts
import bdlz_tpu_torch.physics.thermo as tth
from bdlz_tpu_torch.backend import F64
from bdlz_tpu_torch.solvers.quadrature import linspace_rows

RTOL = 1e-14
RNG = np.random.default_rng(11)
# T spans both sides of m/3 for every m (T/m from 1e-3 to 1e2)
M = np.exp(RNG.uniform(np.log(0.1), np.log(1000.0), 256))
T = M * np.exp(RNG.uniform(np.log(1e-3), np.log(1e2), 256))


def t64(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=F64)


def close(got, ref, rtol=RTOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    err = np.abs(got[fin] - ref[fin]) / np.maximum(np.abs(ref[fin]), 1e-300)
    assert err.max(initial=0.0) <= rtol


def test_seam_population_spans_both_branches():
    rel = T > M / 3.0
    assert rel.any() and (~rel).any()


@pytest.mark.parametrize("stats", ["fermion", "boson"])
def test_thermo_matches_numpy(stats):
    g = np.full_like(M, 2.0)
    close(tth.n_chi_equilibrium(t64(T), t64(M), t64(g), stats),
          jth.n_chi_equilibrium(T, M, g, stats, np))
    close(tth.mean_speed_chi(t64(T), t64(M)), jth.mean_speed_chi(T, M, np))
    close(tth.wall_flux(t64(T), t64(M), t64(g), stats),
          jth.wall_flux(T, M, g, stats, np))
    close(tth.hubble_rate(t64(T), t64(np.full_like(T, 106.75))),
          jth.hubble_rate(T, np.full_like(T, 106.75), np))
    close(tth.entropy_density(t64(T), 106.75), jth.entropy_density(T, 106.75, np))


def test_percolation_and_source_match_numpy():
    y = RNG.uniform(-90.0, 60.0, 512)
    B, Tp = 100.0, 100.0
    close(tp.y_of_T(t64(T), t64(Tp), t64(B)), jp.y_of_T(T, Tp, B, np))
    close(tp.T_of_y(t64(y), t64(Tp), t64(B)), jp.T_of_y(y, Tp, B, np))
    close(ts.source_window(t64(y), t64(9.0)), js.source_window(y, 9.0, np))
    grid_t, grid_j = tp.make_kjma_grid("cpu"), jp.make_kjma_grid(np)
    for a, b in zip(grid_t, grid_j):
        assert np.array_equal(a.numpy(), b)  # the z-grid is the spec: bitwise
    close(tp.area_over_volume(t64(y), t64(0.34), t64(B), t64(Tp), t64(0.3),
                              t64(106.75), grid_t),
          jp.area_over_volume(y, 0.34, B, Tp, 0.3, 106.75, grid_j, np))


@pytest.mark.parametrize("I_p,n", [(0.34, 16384), (0.9, 4096)])
def test_f_table_bitwise_equal(I_p, n):
    a, b = tt.make_f_table(I_p, n=n), jt.make_f_table(I_p, np, n=n)
    assert np.array_equal(a.values, b.values)
    assert (a.y0, a.inv_dy, a.I_p) == (b.y0, b.inv_dy, b.I_p)
    dev = tt.table_to_device(a, "cpu")
    assert dev.values.dtype == torch.float64
    assert np.array_equal(dev.values.numpy(), b.values)


def test_eval_f_table_and_tabulated_av_match_numpy():
    tab_j = jt.make_f_table(0.34, np)
    tab_t = tt.table_to_device(tt.make_f_table(0.34), "cpu")
    y = np.concatenate([RNG.uniform(-60.0, 60.0, 4096), [-50.0, 50.0, 0.0]])
    close(tt.eval_f_table(t64(y), tab_t), jt.eval_f_table(y, tab_j, np))
    close(tt.area_over_volume_tabulated(t64(y), t64(100.0), t64(100.0), t64(0.3),
                                        t64(106.75), tab_t),
          jt.area_over_volume_tabulated(y, 100.0, 100.0, 0.3, 106.75, tab_j, np))


def test_linspace_rows_vs_numpy_and_jax():
    """The port's per-row grid is NumPy's linspace arithmetic exactly; the
    JAX kernel path's ``jnp.linspace`` rounds differently, and the
    measured gap stays within a few ulps of the node magnitude."""
    import jax.numpy as jnp

    lo = RNG.uniform(-80.0, -1.0, 16)
    hi = RNG.uniform(1.0, 50.0, 16)
    n = 2048
    got = linspace_rows(t64(lo), t64(hi), n).numpy()
    ref_np = np.stack([np.linspace(a, b, n) for a, b in zip(lo, hi)])
    assert np.array_equal(got, ref_np)
    ref_jax = np.asarray(jnp.linspace(jnp.asarray(lo), jnp.asarray(hi), n, axis=-1))
    ulp = np.spacing(np.maximum(np.abs(lo), np.abs(hi)))[:, None]
    gap_ulps = np.max(np.abs(got - ref_jax) / ulp)
    assert gap_ulps <= 4.0
