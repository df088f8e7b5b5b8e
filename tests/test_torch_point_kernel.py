"""The point kernels' plain versions (``bdlz_tpu_torch/ops/kjma_kernel.py``:
``point_scalars`` → ``point_[fused_]reduce`` or ``point_[fused_]stream`` →
``point_finish``, the route of ``integrate_YB_kernel`` in every tier) on the
CPU, against each other and the JAX package.

Tolerances, with their reasons:
* ≤1e-13 between the reduce tiers and the stream tiers: the same node
  values, summed in another order;
* ≤1e-6 against JAX's ``integrate_YB_pallas(interpret=True)``: the TPU
  kernels carry f32 streams;
* ≤1e-10 against JAX's tabulated ``point_yields_fast`` and ≤1e-12 of each
  row's largest node against JAX's integrand at the same nodes: only the
  closed-form collapse of the prefactors (and the summation order) differ.
Empty windows, nodes past the y = 50 cut, slices of the plain version and
single points are held bit for bit.
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
from bdlz_tpu.parallel.sweep import run_sweep as j_run_sweep
from bdlz_tpu.solvers.quadrature import yb_integrand_tabulated as j_integrand

from bdlz_tpu_torch.config import config_from_dict as t_config_from_dict
from bdlz_tpu_torch.config import static_choices_from_config as t_static
from bdlz_tpu_torch.interop import point_params_from_numpy, table_from_numpy
from bdlz_tpu_torch.ops import kjma_kernel as kk
from bdlz_tpu_torch.parallel.sweep import run_sweep

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
N_Y = 2048
TIER_RTOL, PALLAS_RTOL, TABULATED_RTOL, NODE_RTOL = 1e-13, 1e-6, 1e-10, 1e-12
FUSE = [False, True]


@pytest.fixture(scope="module")
def env():
    base = config_from_dict(ARCHIVED)
    table_np = make_f_table(base.I_p, np, n=16384)
    table_j = make_f_table(base.I_p, jnp, n=16384)
    table_t = table_from_numpy(table_np.values, table_np.y0, table_np.inv_dy,
                               table_np.I_p, "cpu")
    # tests/test_torch_kernel.py's randomized population (both n_eq
    # branches, the y-support clips, the T = m/3 seam) and the archived point
    rng = np.random.default_rng(11)
    n = 64
    m = 10 ** rng.uniform(-1.0, 1.0, n)
    T_p = 10 ** rng.uniform(1.5, 2.5, n)
    m[-8:] = 3.0 * T_p[-8:] * rng.uniform(0.8, 1.2, 8)   # seam inside window
    m[-16:-8] = 10 ** rng.uniform(1.5, 3.0, 8)           # deep Maxwell-Boltzmann
    axes = {
        "m_chi_GeV": m,
        "T_p_GeV": T_p,
        "source_shape_sigma_y": rng.uniform(2.0, 20.0, n),
        "beta_over_H": rng.uniform(50.0, 500.0, n),
        "v_w": rng.uniform(0.05, 0.95, n),
        "P_chi_to_B": rng.uniform(0.01, 0.9, n),
    }
    archived = {"m_chi_GeV": 0.95, "T_p_GeV": 100.0, "source_shape_sigma_y": 9.0,
                "beta_over_H": 100.0, "v_w": 0.3, "P_chi_to_B": ARCHIVED["P_chi_to_B"]}
    for k, v in archived.items():
        axes[k] = np.append(axes[k], v)
    grid = build_grid(base, axes, product=False)
    return {"base": base, "table_j": table_j, "table_t": table_t, "grid": grid,
            "pp": point_params_from_numpy(grid, "cpu")}


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize("n_y", [2000, 8000])
@pytest.mark.parametrize("fuse_exp", FUSE)
def test_point_path_matches_the_stream_path(env, fuse_exp, n_y):
    """The reduce tier (P1/P3) against the stream tier (P2/P4 and the
    host's row sum) on the same scalars."""
    kk.reset_launches()
    got = kk.integrate_YB_kernel(env["pp"], "fermion", env["table_t"], n_y,
                                 fuse_exp=fuse_exp, reduce=True)
    ref = kk.integrate_YB_kernel(env["pp"], "fermion", env["table_t"], n_y,
                                 fuse_exp=fuse_exp, reduce=False)
    assert got.dtype == torch.float64 and got.shape == ref.shape == (65,)
    assert bool(torch.isfinite(got).all()) and bool((got > 0).all())
    rel = _rel(got.numpy(), ref.numpy())
    print(f"RESIDUAL reduce tier vs stream tier (fuse_exp={fuse_exp}, n_y={n_y}): {rel:.3e}")
    assert rel <= TIER_RTOL
    assert kk.LAUNCHES == dict.fromkeys(kk.LAUNCHES, 0)  # CPU: no kernel launched


@pytest.mark.parametrize("fuse_exp", FUSE)
def test_point_path_matches_jax_pallas_and_tabulated(env, fuse_exp, jit_warmup):
    base, grid = env["base"], env["grid"]
    static = static_choices_from_config(base)
    got = kk.integrate_YB_kernel(env["pp"], static.chi_stats, env["table_t"], N_Y,
                                 fuse_exp=fuse_exp, reduce=True).numpy()
    jgrid = jax.tree.map(jnp.asarray, grid)
    pallas = np.asarray(jk.integrate_YB_pallas(
        jgrid, static.chi_stats, env["table_j"], jk.build_shifted_table(env["table_j"]),
        n_y=N_Y, interpret=True, fuse_exp=fuse_exp, reduce=True))
    fn = jax.jit(jax.vmap(lambda p: point_yields_fast(p, static, env["table_j"], jnp,
                                                      n_y=N_Y)))
    jit_warmup(fn, jgrid)
    tab = np.asarray(fn(jgrid).Y_B)
    r_pallas, r_tab = _rel(got, pallas), _rel(got, tab)
    print(f"RESIDUAL point path (fuse_exp={fuse_exp}) vs JAX pallas {r_pallas:.3e}, "
          f"vs JAX tabulated {r_tab:.3e}")
    assert r_pallas <= PALLAS_RTOL
    assert r_tab <= TABULATED_RTOL


@pytest.mark.parametrize("fuse_exp", FUSE)
def test_empty_reversed_and_clipped_windows_are_exactly_zero(env, fuse_exp):
    base = env["base"]
    # reversed, clipped away below y = -80, y_hi == y_lo, and a window wholly
    # above T_p (y_lo > 50 >= y_hi)
    for lo, hi, B in ((5.0, 4.0, 100.0), (4.0, 5.0, 400.0), (1.0, 1.0, 100.0),
                      (0.01, 0.05, 100.0)):
        cfg = dataclasses.replace(base, T_min_over_Tp=lo, T_max_over_Tp=hi, beta_over_H=B)
        pp = point_params_from_numpy(build_grid(cfg, {"m_chi_GeV": [0.95, 3.0, 500.0]}), "cpu")
        s = kk.point_scalars(pp, "fermion", env["table_t"], N_Y)
        assert not bool((s[:, 1] > s[:, 0]).any())
        reduce_plain = kk.point_fused_reduce_plain if fuse_exp else kk.point_reduce_plain
        assert torch.equal(reduce_plain(s, env["table_t"], N_Y), torch.zeros(3, dtype=torch.float64))
        got = kk.integrate_YB_kernel(pp, "fermion", env["table_t"], N_Y,
                                     fuse_exp=fuse_exp, reduce=True)
        assert torch.equal(got, torch.zeros(3, dtype=torch.float64)), (lo, hi, B)


def _with_window(s, lo, hi):
    """``s`` with every row's window set to [lo, hi] (and its A_max)."""
    s = s.clone()
    c = kk._COL
    sig = torch.sqrt(s[:, c["two_sig2"]] / 2.0)
    y_star = torch.clamp(torch.clamp_max(sig ** 2, 50.0), lo, hi)
    s[:, c["y_lo"]], s[:, c["y_hi"]] = lo, hi
    s[:, c["A_max"]] = torch.clamp(y_star, -50.0, 50.0) - y_star * y_star / (2.0 * sig ** 2)
    return s


@pytest.mark.parametrize("fuse_exp", FUSE)
def test_nodes_above_y_50_are_cut(env, fuse_exp):
    """A window across y = 50, which quadrature_bounds never makes (so the
    scalars are set by hand), on a table of ones (the KJMA F itself
    underflows to 0 long before y = 50): the nodes above 50 add exactly
    nothing, as in JAX's tabulated integrand on the same nodes and table;
    a window wholly above 50 sums to exactly 0."""
    pp, table = env["pp"], env["table_t"]
    ones = table._replace(values=torch.ones_like(table.values))
    ones_j = env["table_j"]._replace(values=jnp.ones_like(env["table_j"].values))
    s = kk.point_scalars(pp, "fermion", ones, N_Y)[:8]
    reduce_plain = kk.point_fused_reduce_plain if fuse_exp else kk.point_reduce_plain
    across = _with_window(s, 40.0, 60.0)
    got = kk.point_finish(across, reduce_plain(across, ones, N_Y)).numpy()
    grid = type(env["grid"])(*(f[:8] for f in env["grid"]))
    ys = np.linspace(40.0, 60.0, N_Y)
    ref = np.array([
        np.trapezoid(np.asarray(j_integrand(
            jnp.asarray(ys), jax.tree.map(lambda f: jnp.asarray(f[i]), grid), "fermion",
            ones_j, jnp)), ys)
        for i in range(8)])
    assert np.all(ref > 0) and np.all(np.isfinite(got))
    rel = _rel(got, ref)
    print(f"RESIDUAL window across y = 50 (fuse_exp={fuse_exp}) vs JAX integrand: {rel:.3e}")
    assert rel <= TABULATED_RTOL
    above = _with_window(s, 51.0, 60.0)
    assert torch.equal(reduce_plain(above, ones, N_Y), torch.zeros(8, dtype=torch.float64))


def test_n_y_below_the_floor_is_the_floor(env):
    pp, table = env["pp"], env["table_t"]
    assert torch.equal(kk.point_scalars(pp, "fermion", table, 1000),
                       kk.point_scalars(pp, "fermion", table, 2000))
    for fuse_exp in FUSE:
        a = kk.integrate_YB_kernel(pp, "fermion", table, 100, fuse_exp=fuse_exp)
        b = kk.integrate_YB_kernel(pp, "fermion", table, 2000, fuse_exp=fuse_exp)
        assert torch.equal(a, b)


def test_one_point_and_no_point(env):
    pp, table = env["pp"], env["table_t"]
    batch = kk.integrate_YB_kernel(pp, "fermion", table, N_Y)
    for i in (0, 57, 64):
        one = type(pp)(*(f[i:i + 1] for f in pp))
        assert torch.equal(kk.integrate_YB_kernel(one, "fermion", table, N_Y), batch[i:i + 1])
    none = type(pp)(*(f[:0] for f in pp))
    s = kk.point_scalars(none, "fermion", table, N_Y)
    assert s.shape == (0, len(kk.POINT_COLUMNS))
    for fuse_exp in FUSE:
        out = kk.integrate_YB_kernel(none, "fermion", table, N_Y, fuse_exp=fuse_exp)
        assert out.shape == (0,) and out.dtype == torch.float64


def test_point_scalars_are_one_contiguous_f64_block(env):
    from bdlz_tpu_torch.solvers.quadrature import quadrature_bounds

    pp, table = env["pp"], env["table_t"]
    s = kk.point_scalars(pp, "fermion", table, N_Y)
    assert s.dtype == torch.float64 and s.is_contiguous()
    assert s.shape == (65, len(kk.POINT_COLUMNS)) == (65, 10)
    c = kk._COL
    y_lo, y_hi = quadrature_bounds(pp)
    assert torch.equal(s[:, c["y_lo"]], y_lo) and torch.equal(s[:, c["y_hi"]], y_hi)
    # the nodes span [y_lo, y_hi] at the spacing (y_hi - y_lo)/(n_y - 1)
    nd = kk._nodes(s, table, N_Y)
    assert torch.equal(nd.y[:, 0], y_lo) and torch.equal(nd.y[:, -1], y_hi)
    assert torch.equal(nd.w[:, 1], (y_hi - y_lo) / (N_Y - 1))
    assert torch.equal(s[:, c["m"]], pp.m_chi_GeV)
    assert torch.equal(s[:, c["three_Tp"]], 3.0 * pp.T_p_GeV)
    assert torch.equal(s[:, c["B_safe"]], pp.beta_over_H)
    # the stream tier's rows: every node finite, every row's peak > 0
    peak = kk.point_stream(s, table, N_Y).abs().amax(dim=-1)
    assert bool(torch.isfinite(peak).all()) and bool((peak > 0).all())


def test_the_plain_version_in_slices_is_the_plain_version_whole(env, monkeypatch):
    pp, table = env["pp"], env["table_t"]
    s = kk.point_scalars(pp, "fermion", table, N_Y)
    whole = {f: kk._point_plain(s, table, N_Y, f, reduce=True) for f in FUSE}
    monkeypatch.setattr(kk, "_PLAIN_NODES_PER_SLICE", 3 * N_Y)
    for f in FUSE:
        assert torch.equal(kk._point_plain(s, table, N_Y, f, reduce=True), whole[f])


def test_kernel_sweep_through_the_point_path_matches_jax(env, jit_warmup):
    """``run_sweep(impl="kernel")`` — the only caller of the point kernels —
    against JAX's tabulated sweep on a small grid, no launch on the CPU."""
    axes = {"m_chi_GeV": np.geomspace(0.1, 600.0, 5), "T_p_GeV": np.geomspace(30.0, 300.0, 3)}
    jstatic = static_choices_from_config(env["base"])._replace(quad_panel_gl=False)
    kw = dict(chunk_size=8, n_y=2000)
    jit_warmup(j_run_sweep, env["base"], axes, jstatic, impl="tabulated", **kw)
    ref = j_run_sweep(env["base"], axes, jstatic, impl="tabulated", **kw)
    base = t_config_from_dict(ARCHIVED)
    for fuse_exp in FUSE:
        kk.reset_launches()
        got = run_sweep(base, axes, t_static(base), impl="kernel", fuse_exp=fuse_exp,
                        device="cpu", **kw)
        assert kk.LAUNCHES == dict.fromkeys(kk.LAUNCHES, 0)
        assert got.chunks == 2 and got.n_failed == 0
        rel = _rel(got.outputs["DM_over_B"], ref.outputs["DM_over_B"])
        print(f"RESIDUAL point-path sweep (fuse_exp={fuse_exp}) vs JAX tabulated: {rel:.3e}")
        assert rel <= TABULATED_RTOL


# ---- the stream tiers (P2, P4) -----------------------------------------------

def _stream(fuse_exp):
    return kk.point_fused_stream if fuse_exp else kk.point_stream


@pytest.mark.parametrize("fuse_exp", FUSE)
def test_stream_rows_match_jax_integrand_at_the_same_nodes(env, fuse_exp, jit_warmup):
    """Each node of a P2 (P4) row, times KK·e^{A_max} and over its
    trapezoid weight, is JAX's ``yb_integrand_tabulated`` at that node:
    ≤1e-12 of the row's largest node."""
    pp, table = env["pp"], env["table_t"]
    s = kk.point_scalars(pp, "fermion", table, N_Y)
    rows = _stream(fuse_exp)(s, table, N_Y)
    nd = kk._nodes(s, table, N_Y)
    c = kk._COL
    got = (rows * (s[:, c["KK"]] * torch.exp(s[:, c["A_max"]]))[:, None] / nd.w).numpy()
    fn = jax.jit(jax.vmap(lambda y, p: j_integrand(y, p, "fermion", env["table_j"], jnp)))
    args = (jnp.asarray(nd.y.numpy()), jax.tree.map(jnp.asarray, env["grid"]))
    jit_warmup(fn, *args)
    ref = np.asarray(fn(*args))
    assert got.shape == ref.shape == (65, N_Y) and np.all(np.isfinite(got))
    rel = float(np.max(np.abs(got - ref) / np.max(np.abs(ref), axis=1, keepdims=True)))
    print(f"RESIDUAL stream rows (fuse_exp={fuse_exp}) vs JAX integrand per node: {rel:.3e}")
    assert rel <= NODE_RTOL


@pytest.mark.parametrize("fuse_exp", FUSE)
def test_stream_rows_of_empty_reversed_and_clipped_windows_are_exactly_zero(env, fuse_exp):
    base = env["base"]
    for lo, hi, B in ((5.0, 4.0, 100.0), (4.0, 5.0, 400.0), (1.0, 1.0, 100.0),
                      (0.01, 0.05, 100.0)):
        cfg = dataclasses.replace(base, T_min_over_Tp=lo, T_max_over_Tp=hi, beta_over_H=B)
        pp = point_params_from_numpy(build_grid(cfg, {"m_chi_GeV": [0.95, 3.0, 500.0]}), "cpu")
        s = kk.point_scalars(pp, "fermion", env["table_t"], N_Y)
        assert torch.equal(_stream(fuse_exp)(s, env["table_t"], N_Y),
                           torch.zeros(3, N_Y, dtype=torch.float64))
        got = kk.integrate_YB_kernel(pp, "fermion", env["table_t"], N_Y,
                                     fuse_exp=fuse_exp, reduce=False)
        assert torch.equal(got, torch.zeros(3, dtype=torch.float64)), (lo, hi, B)


@pytest.mark.parametrize("fuse_exp", FUSE)
def test_stream_nodes_above_y_50_are_exactly_zero(env, fuse_exp):
    """On a table of ones, a window across y = 50 keeps every node at or
    below 50 (> 0) and writes exactly 0 above it; its Y_B is JAX's
    trapezoid of the integrand on the same nodes; a window wholly above
    50 is a row of zeros."""
    pp, table = env["pp"], env["table_t"]
    ones = table._replace(values=torch.ones_like(table.values))
    ones_j = env["table_j"]._replace(values=jnp.ones_like(env["table_j"].values))
    s = kk.point_scalars(pp, "fermion", ones, N_Y)[:8]
    across = _with_window(s, 40.0, 60.0)
    rows = _stream(fuse_exp)(across, ones, N_Y)
    y = kk._nodes(across, ones, N_Y).y
    assert bool((y > 50.0).any()) and bool((y <= 50.0).any())
    assert bool((rows[y > 50.0] == 0.0).all()) and bool((rows[y <= 50.0] > 0.0).all())
    got = kk.point_finish(across, rows.sum(dim=-1)).numpy()
    grid = type(env["grid"])(*(f[:8] for f in env["grid"]))
    ys = np.linspace(40.0, 60.0, N_Y)
    ref = np.array([
        np.trapezoid(np.asarray(j_integrand(
            jnp.asarray(ys), jax.tree.map(lambda f: jnp.asarray(f[i]), grid), "fermion",
            ones_j, jnp)), ys)
        for i in range(8)])
    rel = _rel(got, ref)
    print(f"RESIDUAL stream window across y = 50 (fuse_exp={fuse_exp}) vs JAX: {rel:.3e}")
    assert rel <= TABULATED_RTOL
    above = _with_window(s, 51.0, 60.0)
    assert torch.equal(_stream(fuse_exp)(above, ones, N_Y),
                       torch.zeros(8, N_Y, dtype=torch.float64))


def test_stream_n_y_below_the_floor_is_the_floor(env):
    pp, table = env["pp"], env["table_t"]
    s = kk.point_scalars(pp, "fermion", table, 2000)
    for fuse_exp in FUSE:
        rows = _stream(fuse_exp)(s, table, 100)
        assert rows.shape == (65, 2000)
        assert torch.equal(rows, _stream(fuse_exp)(s, table, 2000))
        a = kk.integrate_YB_kernel(pp, "fermion", table, 100, fuse_exp=fuse_exp, reduce=False)
        b = kk.integrate_YB_kernel(pp, "fermion", table, 2000, fuse_exp=fuse_exp, reduce=False)
        assert torch.equal(a, b)


def test_stream_one_point_and_no_point(env):
    pp, table = env["pp"], env["table_t"]
    s = kk.point_scalars(pp, "fermion", table, N_Y)
    none = type(pp)(*(f[:0] for f in pp))
    for fuse_exp in FUSE:
        rows = _stream(fuse_exp)(s, table, N_Y)
        for i in (0, 57, 64):
            assert torch.equal(_stream(fuse_exp)(s[i:i + 1], table, N_Y), rows[i:i + 1])
        empty = _stream(fuse_exp)(s[:0], table, N_Y)
        assert empty.shape == (0, N_Y) and empty.dtype == torch.float64
        out = kk.integrate_YB_kernel(none, "fermion", table, N_Y, fuse_exp=fuse_exp,
                                     reduce=False)
        assert out.shape == (0,) and out.dtype == torch.float64


def test_the_stream_plain_version_in_slices_is_the_plain_version_whole(env, monkeypatch):
    pp, table = env["pp"], env["table_t"]
    s = kk.point_scalars(pp, "fermion", table, N_Y)
    whole = {f: kk._point_plain(s, table, N_Y, f, reduce=False) for f in FUSE}
    monkeypatch.setattr(kk, "_PLAIN_NODES_PER_SLICE", 3 * N_Y)
    for f in FUSE:
        assert torch.equal(kk._point_plain(s, table, N_Y, f, reduce=False), whole[f])
        # each row summed is the reduce plain version, bit for bit
        assert torch.equal(whole[f].sum(dim=-1), kk._point_plain(s, table, N_Y, f, reduce=True))


def test_stream_tier_sweep_matches_jax(env, jit_warmup):
    """``run_sweep(impl="kernel", reduce=False)`` through P2/P4 against
    JAX's tabulated sweep on a small grid, no launch on the CPU."""
    axes = {"m_chi_GeV": np.geomspace(0.1, 600.0, 5), "T_p_GeV": np.geomspace(30.0, 300.0, 3)}
    jstatic = static_choices_from_config(env["base"])._replace(quad_panel_gl=False)
    kw = dict(chunk_size=8, n_y=2000)
    jit_warmup(j_run_sweep, env["base"], axes, jstatic, impl="tabulated", **kw)
    ref = j_run_sweep(env["base"], axes, jstatic, impl="tabulated", **kw)
    base = t_config_from_dict(ARCHIVED)
    for fuse_exp in FUSE:
        kk.reset_launches()
        got = run_sweep(base, axes, t_static(base), impl="kernel", fuse_exp=fuse_exp,
                        reduce=False, device="cpu", **kw)
        assert kk.LAUNCHES == dict.fromkeys(kk.LAUNCHES, 0)
        assert got.chunks == 2 and got.n_failed == 0
        rel = _rel(got.outputs["DM_over_B"], ref.outputs["DM_over_B"])
        print(f"RESIDUAL stream-tier sweep (fuse_exp={fuse_exp}) vs JAX tabulated: {rel:.3e}")
        assert rel <= TABULATED_RTOL
