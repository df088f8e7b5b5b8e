"""The port's snapped-panel Gauss–Legendre quadrature, its population audit
and the quad_panel_gl tri-state, held against the JAX package on the CPU.

Inputs come from the JAX package's own seeded audit population and grids.
Tolerances: scheme nodes, weights and panel edges bitwise; the panel
integral ≤1e-13 rel per point (summation order only: the port sums a
point's 560 products with ``Tensor.sum``, NumPy pairwise); the audit's
verdict and seam count equal; sweep outputs ≤1e-12 rel.
"""
import dataclasses

import numpy as np
import pytest
import torch

from bdlz_tpu.config import config_from_dict as j_config_from_dict
from bdlz_tpu.config import static_choices_from_config as j_static
from bdlz_tpu.ops.kjma_table import make_f_table as j_make_f_table
from bdlz_tpu.parallel.sweep import build_grid as j_build_grid
from bdlz_tpu.parallel.sweep import run_sweep as j_run_sweep
from bdlz_tpu.physics.percolation import make_kjma_grid as j_make_kjma_grid
from bdlz_tpu.solvers import panels as jp
from bdlz_tpu.solvers.quadrature import quadrature_bounds as j_bounds
from bdlz_tpu.validation import build_audit_population as j_population
from bdlz_tpu.validation import panel_gl_population_audit as j_audit
from bdlz_tpu.validation import resolve_quad_panel_gl as j_resolve

from bdlz_tpu_torch import validation as tv
from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
from bdlz_tpu_torch.interop import point_params_from_numpy
from bdlz_tpu_torch.ops.kjma_table import make_f_table, table_to_device
from bdlz_tpu_torch.parallel.sweep import build_grid, run_sweep
from bdlz_tpu_torch.physics.percolation import make_kjma_grid
from bdlz_tpu_torch.solvers import panels as tp
from bdlz_tpu_torch.solvers.quadrature import quadrature_bounds

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
SMOOTH_AXES = {"m_chi_GeV": np.geomspace(0.1, 10.0, 6),
               "T_p_GeV": np.geomspace(30.0, 300.0, 6)}
SEAM_AXES = {"m_chi_GeV": [250.0, 300.0]}  # m ~ 3·T_p: the seam in-window


@pytest.fixture(scope="module")
def j_base():
    return j_config_from_dict(ARCHIVED)


@pytest.fixture(scope="module")
def base():
    return config_from_dict(ARCHIVED)


@pytest.fixture(scope="module")
def table_np(j_base):
    return j_make_f_table(j_base.I_p, np)


@pytest.fixture(scope="module")
def population(j_base):
    """64 points of the JAX audit population (seed 1): broad, deep
    Maxwell–Boltzmann, clip-edge and seam-straddling classes."""
    return j_population(j_base, 64, seed=1).grid


def _point(grid, i):
    return type(grid)(*(np.float64(np.asarray(f)[i]) for f in grid))


@pytest.mark.parametrize("n_panels,n_nodes", [(28, 20), (28, 10), (28, 5), (4, 8), (1, 2)])
def test_scheme_nodes_and_weights_bitwise(n_panels, n_nodes):
    j = jp.make_panel_scheme(np, n_panels=n_panels, n_nodes=n_nodes)
    t = tp.make_panel_scheme("cpu", n_panels=n_panels, n_nodes=n_nodes)
    assert t.n_quad_nodes == j.n_quad_nodes == n_panels * n_nodes
    assert t.nodes.dtype == torch.float64
    assert np.array_equal(t.nodes.numpy(), np.asarray(j.nodes))
    assert np.array_equal(t.weights.numpy(), np.asarray(j.weights))


def test_scheme_shape_validation():
    with pytest.raises(ValueError, match="n_panels"):
        tp.make_panel_scheme("cpu", n_panels=0)
    s = tp.make_panel_scheme("cpu", n_panels=4, n_nodes=8)
    # Gauss-Legendre exactness: a degree-14 monomial with 8 nodes
    assert float((s.weights * s.nodes ** 14).sum()) == pytest.approx(2.0 / 15.0, rel=1e-12)


@pytest.mark.parametrize("n_panels", [28, 16, 1])
def test_panel_edges_bitwise_on_the_audit_population(population, n_panels):
    pp = point_params_from_numpy(population, "cpu")
    y_lo, y_hi = quadrature_bounds(pp)
    got = tp.panel_edges(pp, y_lo, y_hi, n_panels).numpy()
    for i in range(got.shape[0]):
        p = _point(population, i)
        lo, hi = j_bounds(p, np)
        assert np.array_equal(got[i], np.asarray(jp.panel_edges(p, lo, hi, n_panels, np))), i


def test_seam_and_washout_land_on_edges(base):
    pp = point_params_from_numpy(build_grid(base, {"m_chi_GeV": [3.0 * 100.0 * 1.05]}), "cpu")
    y_lo, y_hi = quadrature_bounds(pp)
    edges = tp.panel_edges(pp, y_lo, y_hi, tp.N_PANELS_DEFAULT)[0]
    seam, wash = tp.y_branch_seam(pp)[0], tp.y_washout_turn_on(pp.I_p)[0]
    assert y_lo[0] < seam < y_hi[0]
    assert bool((edges == seam).any()) and bool((edges == wash).any())
    assert bool((edges[1:] >= edges[:-1]).all())
    assert edges[0] == y_lo[0] and edges[-1] == y_hi[0]


@pytest.mark.parametrize("tabulated", [True, False], ids=["tabulated", "direct"])
def test_integral_matches_jax(population, table_np, tabulated):
    """Every third point of the population (seam, clip and deep-MB points
    among them): ≤1e-13 rel, and exactly 0 where JAX gives 0."""
    idx = np.arange(0, 64, 3 if tabulated else 8)
    sub = type(population)(*(np.asarray(f)[idx] for f in population))
    pp = point_params_from_numpy(sub, "cpu")
    if tabulated:
        aux = table_to_device(make_f_table(0.34), "cpu")
        j_aux = table_np
    else:
        aux, j_aux = make_kjma_grid("cpu"), j_make_kjma_grid(np)
    got = tp.integrate_YB_panel_gl(pp, "fermion", aux, tabulated=tabulated).numpy()
    ref = np.array([float(jp.integrate_YB_panel_gl(_point(sub, i), "fermion", j_aux, np,
                                                   tabulated=tabulated))
                    for i in range(len(idx))])
    zero = ref == 0.0
    assert np.array_equal(got[zero], ref[zero])
    assert np.max(np.abs(got[~zero] / ref[~zero] - 1.0)) <= 1e-13


def test_empty_window_gives_exact_zero(base):
    grid = build_grid(base, {"beta_over_H": [400.0], "T_min_over_Tp": [10.0],
                             "T_max_over_Tp": [12.0]}, product=False)
    pp = point_params_from_numpy(grid, "cpu")
    y_lo, y_hi = quadrature_bounds(pp)
    assert bool((y_hi < y_lo).all())  # empty after the support clip
    table = table_to_device(make_f_table(0.34), "cpu")
    assert tp.integrate_YB_panel_gl(pp, "fermion", table).item() == 0.0
    assert tp.integrate_YB_panel_gl(pp, "fermion", make_kjma_grid("cpu"),
                                    tabulated=False).item() == 0.0


@pytest.mark.parametrize("which", ["smooth", "seam", "swept_I_p"])
def test_audit_gives_jax_verdict(j_base, base, table_np, which):
    """The JAX panel tests' three populations: the same verdict, seam
    count, sample size and node count; the measured errors agree to
    1e-3 of their own size (they are differences of near-equal sums)."""
    if which == "smooth":
        j_grid, grid = j_build_grid(j_base, SMOOTH_AXES), build_grid(base, SMOOTH_AXES)
    elif which == "seam":
        j_grid = j_population(j_base, 64, seed=1).grid
        grid = tv.build_audit_population(base, 64, seed=1).grid
        for a, b in zip(grid, j_grid):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    else:
        j_grid = j_build_grid(j_base, {"I_p": [0.3, 0.4]})
        grid = build_grid(base, {"I_p": [0.3, 0.4]})
    ref = j_audit(j_grid, "fermion", n_y=8000, table=table_np)
    got = tv.panel_gl_population_audit(grid, "fermion", n_y=8000, table=make_f_table(0.34))
    assert (got.ok, got.n_seam_inside, got.n_sampled, got.n_quad_nodes) == (
        ref.ok, ref.n_seam_inside, ref.n_sampled, ref.n_quad_nodes)
    assert got.reason.split(":")[0] == ref.reason.split(":")[0]
    for f in ("max_rel_vs_trap", "max_err_half", "max_err_quarter"):
        a, b = getattr(got, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if b is not None:
            assert a == pytest.approx(b, rel=1e-3, abs=1e-15), f
    if which == "smooth":
        assert got.ok and got.max_rel_vs_trap <= 1e-9
        assert got.max_err_half <= 0.25 * got.max_err_quarter


@pytest.mark.parametrize("impl,q,axes", [
    ("tabulated", None, "smooth"), ("tabulated", None, "seam"),
    ("tabulated", True, "seam"), ("tabulated", False, "smooth"),
    ("direct", True, "smooth"), ("kernel", None, "smooth"),
    ("esdirk", True, "smooth"),
])
def test_resolver_semantics_match_jax(j_base, base, impl, q, axes, capsys):
    """None audits (tabulated only) and announces; True/False pass
    through; other engines resolve False and warn when True was asked."""
    ax = SMOOTH_AXES if axes == "smooth" else SEAM_AXES
    j_impl = "pallas" if impl == "kernel" else impl
    ref, ref_audit = j_resolve(j_build_grid(j_base, ax), j_static(j_base)._replace(
        quad_panel_gl=q), j_impl, 8000)
    j_err = capsys.readouterr().err
    got, audit = tv.resolve_quad_panel_gl(build_grid(base, ax), static_choices_from_config(
        base)._replace(quad_panel_gl=q), impl, 8000)
    err = capsys.readouterr().err
    assert got is ref
    assert (audit is None) == (ref_audit is None)
    assert ("quad_panel_gl on" in err) == ("quad_panel_gl on" in j_err)
    assert ("audit fallback" in err) == ("audit fallback" in j_err)
    assert ("requires the tabulated engine" in err) == ("requires the tabulated engine" in j_err)


@pytest.mark.parametrize("q", [None, True, False])
def test_sweep_resolves_the_scheme_like_jax(j_base, base, jit_warmup, q):
    """The tabulated sweep with each tri-state value on a smooth grid: the
    same scheme and node count as JAX's run_sweep, outputs ≤1e-12."""
    axes = {"m_chi_GeV": np.geomspace(0.1, 2.0, 4)}
    kw = dict(chunk_size=4, n_y=8000, impl="tabulated")
    j_st = j_static(j_base)._replace(quad_panel_gl=q)
    jit_warmup(j_run_sweep, j_base, axes, j_st, **kw)
    ref = j_run_sweep(j_base, axes, j_st, **kw)
    got = run_sweep(base, axes, static_choices_from_config(base)._replace(quad_panel_gl=q),
                    device="cpu", **kw)
    assert (got.quad_impl, got.n_quad_nodes) == (ref.quad_impl, ref.n_quad_nodes)
    assert got.quad_impl == ("trap" if q is False else "panel_gl")
    for f, r in ref.outputs.items():
        assert np.max(np.abs(got.outputs[f] / r - 1.0)) <= 1e-12, f


def test_seam_grid_stays_on_the_trapezoid_loudly(base, capsys):
    res = run_sweep(base, SEAM_AXES, static_choices_from_config(base), chunk_size=2,
                    n_y=2000, impl="tabulated", device="cpu")
    assert (res.quad_impl, res.n_quad_nodes) == ("trap", 2000)
    assert "audit fallback" in capsys.readouterr().err


def test_relative_errors_zero_reference_rule():
    got = np.array([1.0, 2.0, 1e-3])
    ref = np.array([1.0, 1.0, 0.0])
    assert tv.relative_errors(got, ref).tolist() == [0.0, 1.0, 1e-3]
    with pytest.raises(tv.GateFailure):
        tv.relative_errors(np.array([np.nan]), np.array([1.0]))
    with pytest.raises(tv.GateFailure):
        tv.relative_errors(np.array([1.0]), np.array([0.0]))
    ok = tv.population_max_rel(lambda lo, hi: got[lo:hi] * 0 + ref[lo:hi] * (1 + 1e-9),
                               2, ref)
    assert ok == pytest.approx(1e-9, rel=1e-6)


def test_quad_on_config_key_runs_the_panel_rule_per_point(base):
    """point_yields with quad_panel_gl True: the panel rule on the direct
    integrand, within 1e-9 of the golden trapezoid value."""
    from bdlz_tpu_torch.config import point_params_from_config
    from bdlz_tpu_torch.models.yields_pipeline import point_yields

    pp = point_params_from_numpy(point_params_from_config(base, base.P_chi_to_B), "cpu")
    static = static_choices_from_config(dataclasses.replace(base, quad_panel_gl=True))
    r = point_yields(pp, static, make_kjma_grid("cpu")).DM_over_B.item()
    assert r == pytest.approx(5.688926334903014, rel=1e-9) and r != 5.688926334903014
