"""The port's stiff Boltzmann engine on the CPU: the RHS, the ESDIRK
stepper and its two tableaus, the per-point solve, and the lane-repacking
batch engine, held against the JAX package on the same inputs.

Tolerances (each measured and stated at its test):
* ``make_rhs`` and the log-x problem ≤1e-14 rel (the exact z-integral is
  summed in another order; everything else is the same operations);
* per-point and repacked solves ≤1e-8 rel on Y_B and Y_χ against JAX.
  Step sequences are adaptive, so one ulp in an error estimate could flip
  an accept; the measured residuals are far below the bound and the
  step counters agree exactly (asserted);
* against JAX's SciPy Radau truth ≤1e-6 rel (the stiff path's contract);
* the repacked engine equals the lockstep engine bit for bit per lane
  with its knobs off.
"""
import dataclasses

import numpy as np
import pytest
import torch

from bdlz_tpu.config import config_from_dict as j_config_from_dict
from bdlz_tpu.config import point_params_from_config as j_pp_from_config
from bdlz_tpu.config import static_choices_from_config as j_static
from bdlz_tpu.parallel.sweep import build_grid as j_build_grid
from bdlz_tpu.physics.percolation import make_kjma_grid as j_make_kjma_grid

from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
from bdlz_tpu_torch.interop import point_params_from_numpy
from bdlz_tpu_torch.parallel.sweep import build_grid, run_sweep
from bdlz_tpu_torch.physics.percolation import make_kjma_grid
from bdlz_tpu_torch.solvers import sdirk as ts
from bdlz_tpu_torch.solvers.batching import (
    initial_yields,
    make_batched_esdirk_step,
    resolve_engine_knobs,
    solve_boltzmann_esdirk_batch,
)
from bdlz_tpu_torch.solvers.boltzmann import make_rhs
from bdlz_tpu_torch.utils.profiling import CompactionStats

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
KNOBS_OFF = dict(ode_auto_h0=False, ode_pi_controller=False, ode_tabulated_av=False)
OFF = {"auto_h0": False, "pi_controller": False, "tabulated_av": False}


def cfg_pair(**over):
    d = dict(ARCHIVED, **over)
    return config_from_dict(d), j_config_from_dict(d)


def mixed_grid(n_side=2):
    """The JAX batching tests' mixed-stiffness grid: washout strength and
    pulse width spread so per-lane step counts diverge."""
    cfg, j_cfg = cfg_pair(Gamma_wash_over_H=0.01, T_min_over_Tp=0.1)
    axes = {"m_chi_GeV": np.geomspace(0.3, 3.0, n_side),
            "Gamma_wash_over_H": np.geomspace(1e-3, 0.5, n_side),
            "source_shape_sigma_y": [3.0, 15.0]}
    return cfg, j_cfg, axes


def _lanes(pp_np):
    return point_params_from_numpy(pp_np, "cpu")


def _window(pp):
    return pp.T_min_over_Tp * pp.T_p_GeV, pp.T_max_over_Tp * pp.T_p_GeV


# --- tableaus and the stepper on analytic problems ------------------------

class Relax:
    """dY/dx = −λ (Y − target) with its closed-form Jacobian, as an RHS
    object (``at(x)`` → RHSStage)."""

    def __init__(self, lam, target=(0.0, 0.0)):
        self.lam = lam
        self.target = torch.tensor(target, dtype=torch.float64)

    def at(self, x):
        from bdlz_tpu_torch.solvers.boltzmann import RHSStage

        j = torch.full_like(x, -self.lam)
        return RHSStage(lambda Y: -self.lam * (Y - self.target), lambda Y: ((j, None), (None, j)))


@pytest.mark.parametrize("method", ["sdirk4", "kvaerno3"])
def test_tableau_equals_jax_and_meets_order_conditions(method):
    from bdlz_tpu.solvers import sdirk as js

    tab = ts._TABLEAUS[method]()
    assert tab == js._TABLEAUS[method]()
    c, A, b, b_emb, order, g, explicit_first = tab
    c, A, b, be = np.array(c), np.array(A), np.array(b), np.array(b_emb)
    tol = 1e-14
    assert np.abs(A.sum(1) - c).max() < tol
    assert abs(b.sum() - 1) < tol and abs(b @ c - 0.5) < tol
    assert abs(b @ (c * c) - 1 / 3) < tol and abs(b @ (A @ c) - 1 / 6) < tol
    assert abs(be.sum() - 1) < tol and abs(be @ c - 0.5) < tol
    if method == "sdirk4":
        assert order == 4.0 and not explicit_first
        assert abs(b @ c ** 3 - 1 / 4) < tol and abs((b * c) @ (A @ c) - 1 / 8) < tol
        assert abs(b @ (A @ (c * c)) - 1 / 12) < tol
        assert abs(b @ (A @ (A @ c)) - 1 / 24) < tol
        assert abs(be @ (c * c) - 1 / 3) < tol and abs(be @ (A @ c) - 1 / 6) < tol
        assert abs(1 - b @ np.linalg.solve(A, np.ones(5))) < 1e-12  # R(∞) = 0
    else:
        assert order == 3.0 and explicit_first
        assert abs(np.linalg.solve(A[1:, 1:], A[1:, 0])[-1]) < 1e-12  # R(∞) = 0


@pytest.mark.parametrize("method,rtol", [("sdirk4", 1e-10), ("kvaerno3", 1e-9)])
def test_linear_decay_exact(method, rtol):
    sol = ts.esdirk_solve(Relax(3.0), 0.0, 2.0,
                          torch.tensor([1.0, 0.5], dtype=torch.float64),
                          rtol=rtol, atol=1e-14, method=method)
    assert bool(sol.success)
    np.testing.assert_allclose(sol.y.numpy(), np.array([1.0, 0.5]) * np.exp(-6.0), rtol=1e-8)


def test_stiff_decay_is_stable():
    """λ = 1e6: an explicit method needs ~1e6 steps; the L-stable pair
    only resolves the transient."""
    sol = ts.esdirk_solve(Relax(1e6, (2.0, 3.0)), 0.0, 1.0,
                          torch.zeros(2, dtype=torch.float64), rtol=1e-8, atol=1e-12)
    assert bool(sol.success) and int(sol.n_steps) < 2000
    np.testing.assert_allclose(sol.y.numpy(), [2.0, 3.0], atol=1e-7)


def test_max_steps_reports_failure():
    sol = ts.esdirk_solve(Relax(1e6), 0.0, 1.0,
                          torch.ones(2, dtype=torch.float64), rtol=1e-12, atol=1e-18,
                          max_steps=3)
    assert not bool(sol.success) and int(sol.n_steps) == 3


def test_lane_function_stepper_matches_jax_bitwise():
    """A plain batched f(x, Y) (its Jacobian from torch.func.jvp) on a
    nonlinear system: the port's stepper takes JAX's steps exactly."""
    import jax.numpy as jnp

    from bdlz_tpu.solvers.sdirk import esdirk_solve as j_solve

    ref = j_solve(lambda t, y: jnp.array([-2.0 * y[0] + y[1] ** 2, -y[1]]), 0.0, 2.0,
                  jnp.array([1.0, 1.0]), rtol=1e-7, atol=1e-14)
    got = ts.esdirk_solve(lambda t, y: torch.stack([-2.0 * y[:, 0] + y[:, 1] ** 2, -y[:, 1]], -1),
                          0.0, 2.0, torch.tensor([1.0, 1.0], dtype=torch.float64),
                          rtol=1e-7, atol=1e-14)
    assert (int(got.n_accepted), int(got.n_rejected)) == (int(ref.n_accepted),
                                                           int(ref.n_rejected))
    np.testing.assert_allclose(got.y.numpy(), np.asarray(ref.y), rtol=1e-14)
    exact = np.array([3.0 * np.exp(-4.0), np.exp(-2.0)])
    assert np.abs(got.y.numpy() - exact).max() < 1e-8


def test_solve_2x2_matches_jax_and_keeps_the_determinant_floor():
    import jax.numpy as jnp

    from bdlz_tpu.solvers.sdirk import _solve_2x2 as j_solve_2x2

    rng = np.random.default_rng(3)
    M = rng.normal(size=(6, 2, 2))
    M[0] = [[0.0, 0.0], [0.0, 2.0]]  # singular: the 1e-300 floor
    r = rng.normal(size=(6, 2))
    r[0] = [3.0, 4.0]
    t = torch.as_tensor(M, dtype=torch.float64)
    got = ts._solve_2x2(((t[:, 0, 0], t[:, 0, 1]), (t[:, 1, 0], t[:, 1, 1])),
                        torch.as_tensor(r, dtype=torch.float64)).numpy()
    ref = np.stack([np.asarray(j_solve_2x2(jnp.asarray(M[i]), jnp.asarray(r[i])))
                    for i in range(6)])
    assert np.array_equal(got, ref)
    assert got[0, 0] == (3.0 * 2.0) / 1e-300
    diag = ts._solve_2x2(((t[:, 0, 0], None), (None, t[:, 1, 1])),
                         torch.as_tensor(r, dtype=torch.float64))
    assert diag[0, 0].item() == got[0, 0]


# --- the Boltzmann problem -------------------------------------------------

def test_make_rhs_matches_jax():
    """Random lanes, x across each window, Y on both sides of equilibrium,
    σv, washout and depletion on: ≤1e-14 rel per component."""
    from bdlz_tpu.solvers.boltzmann import make_rhs as j_make_rhs

    cfg, j_cfg = cfg_pair(sigma_v_chi_GeV_m2=1e-12, Gamma_wash_over_H=0.1,
                          deplete_DM_from_source=True, regime="thermal")
    rng = np.random.default_rng(5)
    n = 16
    axes = {"m_chi_GeV": 10 ** rng.uniform(-1, 1.5, n), "T_p_GeV": rng.uniform(30, 300, n),
            "v_w": rng.uniform(0.05, 0.95, n), "source_shape_sigma_y": rng.uniform(2, 20, n)}
    g = j_build_grid(j_cfg, axes, product=False)
    x = g.m_chi_GeV / (g.T_p_GeV * rng.uniform(0.05, 5.0, n))
    Y = np.stack([10 ** rng.uniform(-12, -3, n), 10 ** rng.uniform(-12, -9, n)], -1)
    ref = np.stack([
        np.asarray(j_make_rhs(type(g)(*(np.asarray(f)[i] for f in g)), "fermion", True,
                              j_make_kjma_grid(np), np)(x[i], Y[i]))
        for i in range(n)])
    rhs = make_rhs(_lanes(g), "fermion", True, make_kjma_grid("cpu"))
    got = rhs(torch.as_tensor(x, dtype=torch.float64),
              torch.as_tensor(Y, dtype=torch.float64)).numpy()
    assert np.max(np.abs(got / ref - 1.0)) <= 1e-14


def test_rhs_jacobian_is_jacfwd_of_the_rhs():
    cfg, _ = cfg_pair(sigma_v_chi_GeV_m2=1e-12, Gamma_wash_over_H=0.1)
    pp = _lanes(build_grid(cfg, {"m_chi_GeV": [0.5, 3.0]}))
    rhs = make_rhs(pp, "fermion", False, make_kjma_grid("cpu"))
    x = torch.tensor([0.3, 2.0], dtype=torch.float64)
    Y = torch.tensor([[1e-3, 1e-10], [2e-9, 3e-11]], dtype=torch.float64)
    (j00, j01), (j10, j11) = rhs.at(x).jac(Y)
    assert j01 is None and j10 is None
    # rows are independent: d(Σ_lanes f)/dY holds each lane's Jacobian
    auto = torch.func.jacfwd(lambda y: rhs(x, y).sum(0))(Y)  # [i, lane, j]
    np.testing.assert_allclose(j00.numpy(), auto[0, :, 0].numpy(), rtol=1e-15)
    np.testing.assert_allclose(j11.numpy(), auto[1, :, 1].numpy(), rtol=1e-15)
    assert (auto[0, :, 1] == 0).all() and (auto[1, :, 0] == 0).all()


def test_log_x_problem_matches_jax():
    """u0, u1, the u-RHS and the step cap (pulse window, u_hi and ln 3
    kinks) at points across each span: ≤1e-14 rel."""
    from bdlz_tpu.solvers.sdirk import boltzmann_ode_problem as j_problem

    cfg, j_cfg = cfg_pair(Gamma_wash_over_H=0.05, T_min_over_Tp=0.05)
    axes = {"m_chi_GeV": [0.3, 0.95, 40.0, 400.0], "source_shape_sigma_y": [3.0, 15.0]}
    g = j_build_grid(j_cfg, axes)
    pp = _lanes(g)
    T_lo, T_hi = _window(pp)
    rhs_u, u0, u1, cap = ts.boltzmann_ode_problem(pp, "fermion", False,
                                                  make_kjma_grid("cpu"), T_lo, T_hi)
    frac = np.linspace(0.0, 1.0, 13)
    Y = torch.tensor([[4.9e-10, 3e-11]] * 8, dtype=torch.float64)
    for i in range(8):
        p = type(g)(*(np.asarray(f)[i] for f in g))
        jr, ju0, ju1, jcap = j_problem(p, "fermion", False, j_make_kjma_grid(np),
                                       T_lo=p.T_min_over_Tp * p.T_p_GeV,
                                       T_hi=p.T_max_over_Tp * p.T_p_GeV)
        assert u0[i].item() == pytest.approx(float(ju0), rel=1e-15)
        assert u1[i].item() == pytest.approx(float(ju1), rel=1e-15)
        for f in frac:
            u = float(ju0) + f * (float(ju1) - float(ju0))
            uu = torch.full((8,), u, dtype=torch.float64)
            assert cap(uu)[i].item() == pytest.approx(float(jcap(u)), rel=1e-14, abs=1e-300)
            ref = np.asarray(jr(u, np.asarray(Y[i].numpy())))
            got = rhs_u(uu, Y)[i].numpy()
            np.testing.assert_allclose(got, ref, rtol=1e-14, atol=0)


# --- per-point solves against JAX and against Radau --------------------------

SOLVE_CASES = {
    "washout": dict(Gamma_wash_over_H=0.2, T_min_over_Tp=0.05),
    "annihilate-nonthermal": dict(sigma_v_chi_GeV_m2=1e-12, T_min_over_Tp=0.05),
    "annihilate-thermal": dict(sigma_v_chi_GeV_m2=1e-12, T_min_over_Tp=0.05,
                               regime="thermal"),
}


@pytest.mark.parametrize("name", sorted(SOLVE_CASES))
def test_solve_boltzmann_esdirk_matches_jax(name, jit_warmup):
    """Per-point path, the config's own tolerances (rtol 1e-8, atol 1e-17,
    sdirk4, knobs off).  Measured: washout 5.2e-14, annihilate-thermal
    1.2e-12, annihilate-nonthermal 1.2e-11 rel (the largest), with
    n_accepted and n_rejected equal to JAX's in all three."""
    from bdlz_tpu.solvers.sdirk import solve_boltzmann_esdirk as j_solve

    cfg, j_cfg = cfg_pair(**SOLVE_CASES[name])
    j_p = j_pp_from_config(j_cfg, j_cfg.P_chi_to_B)
    pp = _lanes(j_p)
    static = static_choices_from_config(cfg)
    Y0 = initial_yields(pp, static)
    T_lo, T_hi = j_cfg.T_min_over_Tp * j_cfg.T_p_GeV, j_cfg.T_max_over_Tp * j_cfg.T_p_GeV
    j_args = (j_p, j_static(j_cfg), j_make_kjma_grid(np), tuple(Y0[0].tolist()), T_lo, T_hi)
    jit_warmup(j_solve, *j_args)
    ref = j_solve(*j_args)
    got = ts.solve_boltzmann_esdirk(pp, static, make_kjma_grid("cpu"), Y0, T_lo, T_hi)
    assert bool(got.success[0]) and bool(ref.success)
    assert (int(got.n_accepted[0]), int(got.n_rejected[0])) == (int(ref.n_accepted),
                                                                int(ref.n_rejected))
    rel = np.abs(got.y[0].numpy() / np.asarray(ref.y) - 1.0)
    assert rel.max() <= 1e-8, rel


def test_default_engine_meets_the_radau_contract():
    """JAX's own Radau truth (rtol 1e-12, exact kernel, pulse cap) on the
    corner the JAX test pins: the port's default engine within 1e-6 (JAX
    measures 1.5e-8 at its worst corner)."""
    from bdlz_tpu.solvers.boltzmann import solve_scipy_radau

    cfg, j_cfg = cfg_pair(Gamma_wash_over_H=0.0937, T_min_over_Tp=0.05, m_chi_GeV=0.8786)
    j_p = j_pp_from_config(j_cfg, j_cfg.P_chi_to_B)
    T_p = j_cfg.T_p_GeV
    ref = solve_scipy_radau(j_p, "fermion", False, j_make_kjma_grid(np), (4.9e-10, 0.0),
                            0.05 * T_p, 5.0 * T_p, rtol=1e-12, atol=1e-22,
                            reference_step_cap=False, table_n=None, pulse_step_cap=True)
    assert ref.success
    got = ts.solve_boltzmann_esdirk(_lanes(j_p), static_choices_from_config(cfg),
                                    make_kjma_grid("cpu"), (4.9e-10, 0.0),
                                    0.05 * T_p, 5.0 * T_p)
    assert bool(got.success[0])
    assert got.y[0, 1].item() == pytest.approx(ref.Y_B, rel=1e-6)
    assert got.y[0, 0].item() == pytest.approx(ref.Y_chi, rel=1e-6)


def test_per_component_atol():
    cfg, _ = cfg_pair(**SOLVE_CASES["annihilate-thermal"])
    pp = _lanes(build_grid(cfg, {"m_chi_GeV": [0.95]}))
    static = static_choices_from_config(cfg)
    T_lo, T_hi = _window(pp)
    a = ts.solve_boltzmann_esdirk(pp, static, make_kjma_grid("cpu"), initial_yields(pp, static),
                                  T_lo, T_hi, atol=torch.tensor([1e-13, 1e-20],
                                                                dtype=torch.float64))
    b = ts.solve_boltzmann_esdirk(pp, static, make_kjma_grid("cpu"), initial_yields(pp, static),
                                  T_lo, T_hi)
    assert bool(a.success.all()) and bool(b.success.all())
    assert a.y[0, 1].item() == pytest.approx(b.y[0, 1].item(), rel=1e-6)


# --- the lane-repacking engine --------------------------------------------------

def _grid(cfg, axes):
    return _lanes(build_grid(cfg, axes))


def test_repacked_equals_lockstep_bitwise_with_knobs_off():
    """8 mixed-stiffness lanes, rounds of 48 steps (several pauses): every
    lane's state and counters equal the lockstep engine's."""
    cfg, _, axes = mixed_grid()
    pp = _grid(cfg, axes)
    static = static_choices_from_config(cfg)._replace(**KNOBS_OFF)
    stats = CompactionStats()
    rep = solve_boltzmann_esdirk_batch(pp, static, make_kjma_grid("cpu"), round_steps=48,
                                       stats=stats)
    T_lo, T_hi = _window(pp)
    lock = ts.solve_boltzmann_esdirk(pp, static, make_kjma_grid("cpu"),
                                     initial_yields(pp, static), T_lo, T_hi)
    assert stats.n_rounds > 1
    for f in ("y", "n_steps", "n_accepted", "n_rejected", "success"):
        assert torch.equal(getattr(rep, f), getattr(lock, f)), f


def test_lane_order_does_not_matter():
    cfg, _, axes = mixed_grid()
    pp = _grid(cfg, axes)
    static = static_choices_from_config(cfg)
    sol = solve_boltzmann_esdirk_batch(pp, static, make_kjma_grid("cpu"))
    perm = torch.as_tensor(np.random.default_rng(11).permutation(8), dtype=torch.int64)
    shuf = solve_boltzmann_esdirk_batch(type(pp)(*(f[perm] for f in pp)), static,
                                        make_kjma_grid("cpu"))
    assert torch.equal(shuf.y, sol.y[perm]) and torch.equal(shuf.n_steps, sol.n_steps[perm])


def test_repacked_engine_matches_jax(jit_warmup):
    """The engine's defaults (Hairer–Wanner start, PI controller,
    tabulated A/V) against JAX's repacked engine on the same 8 lanes:
    ≤1e-8 rel (measured 1.4e-11), equal step counters."""
    from bdlz_tpu.solvers.batching import solve_boltzmann_esdirk_batch as j_batch

    cfg, j_cfg, axes = mixed_grid()
    j_g = j_build_grid(j_cfg, axes)
    jit_warmup(j_batch, j_g, j_static(j_cfg), j_make_kjma_grid(np))
    ref = j_batch(j_g, j_static(j_cfg), j_make_kjma_grid(np))
    got = solve_boltzmann_esdirk_batch(_lanes(j_g), static_choices_from_config(cfg),
                                       make_kjma_grid("cpu"))
    assert np.array_equal(got.n_accepted.numpy(), np.asarray(ref.n_accepted))
    assert np.array_equal(got.n_rejected.numpy(), np.asarray(ref.n_rejected))
    rel = np.abs(got.y.numpy() / np.asarray(ref.y) - 1.0)
    assert rel.max() <= 1e-8, rel.max()


def test_accelerated_defaults_stay_in_contract():
    """Knobs on against the bit-pinned lockstep engine: ≤1e-6."""
    cfg, _, axes = mixed_grid()
    pp = _grid(cfg, axes)
    static = static_choices_from_config(cfg)
    sol = solve_boltzmann_esdirk_batch(pp, static, make_kjma_grid("cpu"))
    T_lo, T_hi = _window(pp)
    ref = ts.solve_boltzmann_esdirk(pp, static, make_kjma_grid("cpu"),
                                    initial_yields(pp, static), T_lo, T_hi)
    assert bool(sol.success.all()) and bool(ref.success.all())
    assert ((sol.y / ref.y - 1.0).abs().max()).item() < 1e-6


def test_failed_lane_is_a_nan_row_and_the_others_are_untouched():
    cfg, _ = cfg_pair(Gamma_wash_over_H=0.05, T_min_over_Tp=0.2)
    static = static_choices_from_config(cfg)
    step = make_batched_esdirk_step(static, max_steps=400)
    grid = make_kjma_grid("cpu")
    with_bad = step(_grid(cfg, {"m_chi_GeV": [0.95, -1.0, 1.2]}), grid)
    alone = step(_grid(cfg, {"m_chi_GeV": [0.95, 1.2]}), grid)
    for f, t in zip(with_bad._fields, with_bad):
        assert torch.isnan(t[1]), f
        assert torch.equal(t[[0, 2]], getattr(alone, f)), f


def test_mixed_I_p_batch_uses_the_exact_kernel():
    cfg, _, axes = mixed_grid()
    pp = _grid(cfg, axes)
    static = static_choices_from_config(cfg)
    assert resolve_engine_knobs(static, pp.I_p.numpy()) == {
        "auto_h0": True, "pi_controller": True, "tabulated_av": True}
    I_p = pp.I_p.clone()
    I_p[0] = 0.5
    mixed = pp._replace(I_p=I_p)
    assert resolve_engine_knobs(static, I_p.numpy())["tabulated_av"] is False
    assert resolve_engine_knobs(static._replace(ode_tabulated_av=False),
                                pp.I_p.numpy())["tabulated_av"] is False
    got = solve_boltzmann_esdirk_batch(mixed, static, make_kjma_grid("cpu"))
    exact = solve_boltzmann_esdirk_batch(mixed, static, make_kjma_grid("cpu"),
                                         knobs=dict(OFF, auto_h0=True, pi_controller=True))
    assert torch.equal(got.y, exact.y) and bool(got.success.all())
    with pytest.raises(ValueError, match="mixed I_p"):
        solve_boltzmann_esdirk_batch(mixed, static, make_kjma_grid("cpu"),
                                     knobs={"auto_h0": True, "pi_controller": True,
                                            "tabulated_av": True})


def test_rounds_retire_monotonically_and_reconcile():
    cfg, _, axes = mixed_grid()
    pp = _grid(cfg, axes)
    stats = CompactionStats()
    sol = solve_boltzmann_esdirk_batch(pp, static_choices_from_config(cfg),
                                       make_kjma_grid("cpu"), round_steps=32, stats=stats)
    active = [r.active_lanes for r in stats.rounds]
    assert all(a >= b for a, b in zip(active, active[1:]))
    assert sum(r.lanes_retired for r in stats.rounds) == 8
    assert sum(r.steps_accepted for r in stats.rounds) == int(sol.n_accepted.sum())
    assert sum(r.steps_rejected for r in stats.rounds) == int(sol.n_rejected.sum())
    assert np.array_equal(stats.lane_steps, sol.n_steps.numpy())
    assert stats.summary()["pad_waste"] == 0.0


def test_no_lane_converges_within_max_steps():
    cfg, _, axes = mixed_grid()
    stats = CompactionStats()
    sol = solve_boltzmann_esdirk_batch(_grid(cfg, axes), static_choices_from_config(cfg),
                                       make_kjma_grid("cpu"), round_steps=10, max_steps=25,
                                       stats=stats)
    assert not bool(sol.success.any()) and bool((sol.n_steps == 25).all())
    assert stats.n_rounds == 3 and sum(r.lanes_retired for r in stats.rounds) == 8


def test_sweep_lockstep_engine_stays_selectable():
    cfg, _ = cfg_pair(Gamma_wash_over_H=0.05, T_min_over_Tp=0.2)
    static = static_choices_from_config(cfg)
    axes = {"m_chi_GeV": [0.5, 0.95]}
    new = run_sweep(cfg, axes, static, chunk_size=2, impl="esdirk", device="cpu")
    old = run_sweep(cfg, axes, static, chunk_size=2, impl="esdirk_lockstep", device="cpu")
    assert (new.impl, old.impl) == ("esdirk", "esdirk_lockstep")
    assert (new.quad_impl, new.n_quad_nodes) == (None, None)
    assert new.esdirk_stats and old.esdirk_stats is None
    np.testing.assert_allclose(new.outputs["Y_B"], old.outputs["Y_B"], rtol=1e-6)


def test_sweep_routes_like_jax(capsys):
    """Stiff configurations go to esdirk (lockstep only on request); a
    swept I_p sends the table engines to direct; fuse_exp on a forced
    engine raises."""
    from bdlz_tpu_torch.parallel.sweep import route_impl

    cfg, _ = cfg_pair(Gamma_wash_over_H=0.05)
    assert route_impl(cfg, {"m_chi_GeV": [1.0]}, "kernel") == "esdirk"
    assert "stiff regime" in capsys.readouterr().err
    assert route_impl(cfg, {"m_chi_GeV": [1.0]}, "esdirk_lockstep") == "esdirk_lockstep"
    base, _ = cfg_pair()
    assert route_impl(base, {"Gamma_wash_over_H": [0.0, 0.1]}, "tabulated") == "esdirk"
    assert route_impl(base, {"Gamma_wash_over_H": [0.0]}, "tabulated") == "tabulated"
    assert route_impl(base, {"I_p": [0.3]}, "kernel") == "direct"
    assert route_impl(base, {"m_chi_GeV": [1.0]}, "kernel") == "kernel"
    with pytest.raises(ValueError, match="fuse_exp"):
        route_impl(base, {"I_p": [0.3]}, "kernel", fuse_exp=True)
    with pytest.raises(ValueError, match="unknown"):
        route_impl(base, {"m_chi_GeV": [1.0]}, "pallas")
    dep = dataclasses.replace(base, deplete_DM_from_source=True)
    assert route_impl(dep, {"m_chi_GeV": [1.0]}, "direct") == "esdirk"


def test_boltzmann_final_yields_matches_jax_per_lane():
    """The port's batched solution gives each lane's (Y_chi, Y_B) as
    JAX's per-point solution does."""
    from bdlz_tpu.solvers.sdirk import ESDIRKSolution as JSolution
    from bdlz_tpu.solvers.sdirk import boltzmann_final_yields as j_final

    y = np.random.default_rng(3).uniform(1e-12, 1e-9, (4, 2))
    ok = torch.ones(4, dtype=torch.bool)
    steps = torch.zeros(4, dtype=torch.int64)
    Y_chi, Y_B = ts.boltzmann_final_yields(ts.ESDIRKSolution(
        torch.as_tensor(y, dtype=torch.float64), ok, steps, steps, steps))
    for i in range(4):
        j_chi, j_B = j_final(JSolution(y[i], True, 0, 0, 0))
        assert (float(Y_chi[i]), float(Y_B[i])) == (float(j_chi), float(j_B))
