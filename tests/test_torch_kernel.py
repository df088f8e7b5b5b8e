"""The port's kernel module (``bdlz_tpu_torch/ops/kjma_kernel.py``) on the CPU,
where every wrapper runs its kernel's plain PyTorch version, against the
JAX package.

Tolerances, with their reasons:
* ≤1e-6 against the Pallas kernels (run in interpret mode): the TPU
  kernels carry f32 streams, the port f64;
* ≤1e-10 against the tabulated f64 path (``point_yields_fast``): only the
  closed-form collapse of the prefactors and the summation order differ;
* ≤1e-12 between the port's own tiers (fused/unfused, reduce/stream).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdlz_tpu.config import config_from_dict, static_choices_from_config
from bdlz_tpu.models.yields_pipeline import point_yields_fast
from bdlz_tpu.ops import kjma_pallas as jk
from bdlz_tpu.ops.kjma_table import make_f_table
from bdlz_tpu.parallel.sweep import build_grid

from bdlz_tpu_torch.interop import point_params_from_numpy, table_from_numpy
from bdlz_tpu_torch.ops import kjma_kernel as kk

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
N_Y = 2048
TIERS = [(False, True), (False, False), (True, True), (True, False)]  # (fuse_exp, reduce)


@pytest.fixture(scope="module")
def setup():
    base = config_from_dict(ARCHIVED)
    table_np = make_f_table(base.I_p, np, n=16384)
    table_j = make_f_table(base.I_p, jnp, n=16384)
    t4 = jk.build_shifted_table(table_j)
    table_t = table_from_numpy(table_np.values, table_np.y0, table_np.inv_dy,
                               table_np.I_p, "cpu")
    rng = np.random.default_rng(42)
    n = 8
    grid = build_grid(base, {
        # heavy masses / low T_p exercise the Maxwell-Boltzmann branch
        "m_chi_GeV": np.concatenate([rng.uniform(0.1, 5.0, n - 3), [120.0, 400.0, 1000.0]]),
        "T_p_GeV": np.concatenate([rng.uniform(50.0, 200.0, n - 3), [30.0, 35.0, 30.0]]),
        "P_chi_to_B": rng.uniform(0.01, 0.9, n),
        "v_w": rng.uniform(0.05, 0.95, n),
        "source_shape_sigma_y": rng.uniform(2.0, 20.0, n),
    }, product=False)
    return base, table_j, t4, table_t, grid


def _tabulated_ref(grid, static, table_j, jit_warmup):
    fn = jax.jit(jax.vmap(lambda p: point_yields_fast(p, static, table_j, jnp, n_y=N_Y)))
    g = jax.tree.map(jnp.asarray, grid)
    jit_warmup(fn, g)
    return fn(g)


def _streams_np(n_points, n_y, n_table, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.uniform(0.0, 1.0, (n_points, n_y)),                  # g
        rng.uniform(-30.0, 0.0, (n_points, n_y)),                # a = A - A_max
        rng.integers(1, n_table - 3, (n_points, n_y)).astype(np.int32),
        rng.uniform(0.0, 1.0, (n_points, n_y)),                  # sfrac
    )


@pytest.mark.parametrize("fuse_exp,reduce", TIERS)
def test_plain_kernels_match_pallas_kernels(setup, fuse_exp, reduce):
    """K1-K4 plain versions vs ``interp_multiply[_fused](interpret=True)`` on
    identical streams; ≤1e-6 relative to each point's sum (reduce) or
    largest node (stream)."""
    _, _, t4, table_t, _ = setup
    P, n_y = 3, 1024 * 2
    ncol = -(-n_y // (jk.ROWS * jk.COL_BLOCK)) * jk.COL_BLOCK
    g, a, i1, s = _streams_np(P, n_y, table_t.values.shape[0], seed=5)

    def tiles(x, fill):
        return jk._to_tiles(jnp.asarray(x), n_y, ncol, fill)

    if fuse_exp:
        a_hi, a_lo = jk.split_f64(jnp.asarray(a))
        out = jk.interp_multiply_fused(
            tiles(g.astype(np.float32), 0.0), tiles(a_hi, 0.0), tiles(a_lo, 0.0),
            tiles(i1, 1), tiles(s.astype(np.float32), 0.0), t4,
            interpret=True, reduce=reduce)
    else:
        out = jk.interp_multiply(
            tiles(g.astype(np.float32), 0.0), tiles(i1, 1),
            tiles(s.astype(np.float32), 0.0), t4, interpret=True, reduce=reduce)
    tg, ta, ti, ts = (torch.as_tensor(x) for x in (g, a, i1, s))
    if reduce:
        ref = np.sum(np.asarray(out[0], np.float64) - np.asarray(out[1], np.float64),
                     axis=(1, 2))
        got = (kk.interp_fused_reduce(tg, ta, ti, ts, table_t.values) if fuse_exp
               else kk.interp_reduce(tg, ti, ts, table_t.values)).numpy()
        assert np.max(np.abs(got - ref) / np.abs(ref)) <= 1e-6
    else:
        ref = np.asarray(out, np.float64).reshape(P, -1)[:, :n_y]
        got = (kk.interp_fused_stream(tg, ta, ti, ts, table_t.values) if fuse_exp
               else kk.interp_stream(tg, ti, ts, table_t.values)).numpy()
        scale = np.max(np.abs(ref), axis=1, keepdims=True)
        assert np.max(np.abs(got - ref) / scale) <= 1e-6
    assert kk.LAUNCHES == dict.fromkeys(kk.LAUNCHES, 0)  # CPU: no kernel launched


@pytest.mark.parametrize("fuse_exp,reduce", TIERS)
def test_integrate_YB_kernel_matches_pallas_and_tabulated(setup, fuse_exp, reduce, jit_warmup):
    base, table_j, t4, table_t, grid = setup
    static = static_choices_from_config(base)
    got = kk.integrate_YB_kernel(
        point_params_from_numpy(grid, "cpu"), static.chi_stats, table_t, N_Y,
        fuse_exp=fuse_exp, reduce=reduce).numpy()
    pallas = np.asarray(jk.integrate_YB_pallas(
        jax.tree.map(jnp.asarray, grid), static.chi_stats, table_j, t4, n_y=N_Y,
        interpret=True, fuse_exp=fuse_exp, reduce=reduce))
    assert np.max(np.abs(got - pallas) / np.abs(pallas)) <= 1e-6
    ref = np.asarray(_tabulated_ref(grid, static, table_j, jit_warmup).Y_B)
    assert np.max(np.abs(got - ref) / np.abs(ref)) <= 1e-10


@pytest.mark.parametrize("regime", ["thermal", "nonthermal"])
def test_point_yields_kernel_all_fields_match_tabulated(setup, regime, jit_warmup):
    base, table_j, _, table_t, _ = setup
    cfg = dataclasses.replace(base, regime=regime)
    static = static_choices_from_config(cfg)
    grid = build_grid(cfg, {"m_chi_GeV": [0.5, 0.95, 2.0, 300.0]})
    got = kk.point_yields_kernel(point_params_from_numpy(grid, "cpu"), static,
                                 table_t, N_Y)
    ref = _tabulated_ref(grid, static, table_j, jit_warmup)
    for f in got._fields:
        r = np.asarray(getattr(ref, f))
        assert np.max(np.abs(getattr(got, f).numpy() - r) / np.abs(r)) <= 1e-10, f


@pytest.mark.parametrize("fuse_exp,reduce", TIERS)
def test_empty_window_is_exactly_zero(setup, fuse_exp, reduce):
    base, _, _, table_t, _ = setup
    # reversed window, a window clipped away below y = -80, and y_hi == y_lo
    for lo, hi, B in ((5.0, 4.0, 100.0), (4.0, 5.0, 400.0), (1.0, 1.0, 100.0)):
        cfg = dataclasses.replace(base, T_min_over_Tp=lo, T_max_over_Tp=hi,
                                  beta_over_H=B)
        pp = point_params_from_numpy(build_grid(cfg, {"m_chi_GeV": [0.95, 3.0]}), "cpu")
        got = kk.integrate_YB_kernel(pp, "fermion", table_t, N_Y,
                                     fuse_exp=fuse_exp, reduce=reduce)
        assert torch.equal(got, torch.zeros(2, dtype=torch.float64))


def test_population_matches_numpy_reference(setup):
    """64 randomized points spanning both n_eq branches, the y-support clips
    and the T = m/3 seam, through the kernel path against the
    bit-reproducible NumPy reference (direct z-integral per node) on the
    same trapezoid.  The contract is 1e-6; what remains is the F table's
    interpolation error (1.7e-11 measured at n_y = 8000), so 1e-9 is asserted."""
    from bdlz_tpu.models.yields_pipeline import point_yields
    from bdlz_tpu.physics.percolation import make_kjma_grid

    base, _, _, table_t, _ = setup
    static = static_choices_from_config(base)._replace(n_y=N_Y)
    rng = np.random.default_rng(11)
    n = 64
    m = 10 ** rng.uniform(-1.0, 1.0, n)
    T_p = 10 ** rng.uniform(1.5, 2.5, n)
    m[-8:] = 3.0 * T_p[-8:] * rng.uniform(0.8, 1.2, 8)   # seam inside window
    m[-16:-8] = 10 ** rng.uniform(1.5, 3.0, 8)           # deep Maxwell-Boltzmann
    grid = build_grid(base, {
        "m_chi_GeV": m,
        "T_p_GeV": T_p,
        "source_shape_sigma_y": rng.uniform(2.0, 20.0, n),
        "beta_over_H": rng.uniform(50.0, 500.0, n),
        "v_w": rng.uniform(0.05, 0.95, n),
        "P_chi_to_B": rng.uniform(0.01, 0.9, n),
    }, product=False)
    got = kk.integrate_YB_kernel(point_params_from_numpy(grid, "cpu"),
                                 static.chi_stats, table_t, N_Y).numpy()
    grid_np = make_kjma_grid(np)
    ref = np.array([
        point_yields(type(grid)(*(float(f[i]) for f in grid)), static, grid_np, np).Y_B
        for i in range(n)
    ])
    assert np.max(np.abs(got / ref - 1.0)) <= 1e-9


def test_linear_in_P_and_flux(setup):
    """Y_B is linear in P_chi_to_B and the flux scale: both enter one
    per-point prefactor, so the scaling holds to a few ulps."""
    base, _, _, table_t, _ = setup
    grid1 = build_grid(base, {"m_chi_GeV": [0.5, 0.95, 2.0]})
    grid2 = grid1._replace(P=grid1.P * 2.0, flux_scale=grid1.flux_scale * 3.0)
    y1, y2 = (kk.integrate_YB_kernel(point_params_from_numpy(g, "cpu"), "fermion",
                                     table_t, N_Y).numpy() for g in (grid1, grid2))
    np.testing.assert_allclose(y2, 6.0 * y1, rtol=1e-12)


def test_tiers_agree(setup):
    """Fused vs unfused and reduce vs stream: the same function in f64,
    ≤1e-12 (exp placement and summation order differ)."""
    _, _, _, table_t, grid = setup
    pp = point_params_from_numpy(grid, "cpu")
    out = {t: kk.integrate_YB_kernel(pp, "fermion", table_t, N_Y, fuse_exp=t[0],
                                     reduce=t[1]).numpy() for t in TIERS}
    ref = out[(False, True)]
    for t, v in out.items():
        assert np.max(np.abs(v - ref) / np.abs(ref)) <= 1e-12, t


def test_streams_and_plain_versions_are_f64_and_consistent(setup):
    """The host prep ships float64 streams and int32 indices clipped to
    [1, n-3]; each reduce plain version is its stream summed."""
    _, _, _, table_t, grid = setup
    pp = point_params_from_numpy(grid, "cpu")
    for fuse in (False, True):
        st = kk.prepare_streams(pp, "fermion", table_t, N_Y, fuse_exp=fuse)
        assert st.g.dtype == st.sfrac.dtype == torch.float64
        assert st.i1.dtype == torch.int32
        assert int(st.i1.min()) >= 1 and int(st.i1.max()) <= table_t.values.shape[0] - 3
        assert float(st.g.abs().max()) == 1.0  # peak-normalised per point
        v = table_t.values
        if fuse:
            assert st.a.dtype == torch.float64 and float(st.a.max()) <= 1e-12
            assert torch.equal(kk.interp_fused_reduce_plain(st.g, st.a, st.i1, st.sfrac, v),
                               kk.interp_fused_stream_plain(st.g, st.a, st.i1, st.sfrac, v).sum(-1))
        else:
            assert st.a is None
            assert torch.equal(kk.interp_reduce_plain(st.g, st.i1, st.sfrac, v),
                               kk.interp_stream_plain(st.g, st.i1, st.sfrac, v).sum(-1))
