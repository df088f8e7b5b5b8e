"""The frozen reference against the archive and against the port on the CPU.

The reference imports nothing of the port; these tests may."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import spec
from benchmark.reference import bounce as rb
from benchmark.reference import yields as ry

ARCHIVED_DM_OVER_B = 5.688926334903014
ARCHIVED_P = 0.14925839040304145


def _config(name):
    return spec.load_cell({"equal_mass": "equal_mass.scan_kernel",
                           "bounce_lz": "bounce_lz.potential_scan"}[name]).config


def test_reference_gives_the_archived_ratio():
    # The archive integrated F(y) by the z-trapezoid at every node; the
    # configuration reads it from the 16384-node table by cubic
    # interpolation, which moves the ratio by 5.6e-12: 1e-10 holds that
    # and nothing of the size of a lost term.
    cfg = _config("equal_mass")
    inputs = ry.point_inputs(cfg["yields_config"], {"v_w": np.array([0.3])})
    out = ry.yields_at(inputs, np.array([0]), cfg["yields_config"], cfg["sweep"], scheme="trap",
                       dtype=torch.float64, device="cpu", cache={})
    assert abs(out["DM_over_B"][0] / ARCHIVED_DM_OVER_B - 1.0) < 1e-10


def test_reference_shoot_gives_the_archived_probability():
    # The configuration's m_mix0 is the repo's calibration: the value at
    # which its potential gives the archived P at v_w 0.3.  The reference's
    # own shoot reproduces it: it bisects with another integrator (DOP853 at
    # rtol 1e-12), and its release point, and so the crossing's slope,
    # agrees to the last digits (1.8e-10 in P measured).
    cfg = _config("bounce_lz")
    pot = cfg["sweep"]["bounce"]
    b = rb.shoot(pot, cfg["solver"])
    assert b.n_crossings == 1
    P = rb.local_probability(b, pot["m_mix0"], [0.3])[0]
    assert abs(P / ARCHIVED_P - 1.0) < 1e-8


@pytest.mark.parametrize("impl", ["kernel", "tabulated"])
def test_reference_agrees_with_the_port_equal_mass(impl):
    # Same scheme, other association order and another exp: a few ulps
    # per node, 1.3e-15 measured; 1e-13 leaves room and fails any float32.
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.parallel.sweep import run_sweep

    cfg = _config("equal_mass")
    sizes = dict(cfg["sweep"], n_y=2000, chunk_size=32)
    axes = {"m_chi_GeV": np.geomspace(0.1, 10, 5), "T_p_GeV": np.geomspace(30, 300, 4),
            "v_w": np.linspace(0.05, 0.95, 3)}
    base = config_from_dict(dict(cfg["yields_config"]))
    res = run_sweep(base, axes, static_choices_from_config(base), impl=impl, device="cpu",
                    **sizes)
    inputs = ry.point_inputs(cfg["yields_config"], axes)
    ref = ry.yields_at(inputs, np.arange(res.n_points), cfg["yields_config"], sizes,
                       scheme=res.quad_impl, dtype=torch.float64, device="cpu", cache={})
    for f in ("Y_B", "Y_chi", "DM_over_B"):
        np.testing.assert_allclose(res.outputs[f], ref[f], rtol=1e-13, atol=0)


def test_reference_profile_agrees_with_the_port_bounce_lz():
    # The port's plain shoot takes minutes on the CPU, so the stages are
    # held apart: the port's dense RK4 pass from the reference's release
    # point (the same fixed grid: bitwise up to the exp-free arithmetic's
    # order, 1e-13 absolute in phi), and the port's profile and local LZ
    # probability from the reference's solution (1e-13 in P).
    from bdlz_tpu_torch.bounce.potential import PotentialSpec
    from bdlz_tpu_torch.bounce.shooting import _params_row, bounce_profile, dense_plain, make_knobs
    from bdlz_tpu_torch.lz.sweep_bridge import probabilities_for_points
    from benchmark.tests.conftest import _reference_solution

    cfg = _config("bounce_lz")
    pot = dict(cfg["sweep"]["bounce"], lam4=0.53, eps=0.047)
    slv = cfg["solver"]
    ref = rb.shoot(pot, slv)
    rho, phi = rb.dense_profile(ref.phi0, pot["lam4"], pot["vev"], pot["eps"], rho0=slv["rho0"],
                                rho_max=slv["rho_max"], n_dense=slv["n_dense"])
    spec_ = PotentialSpec(pot["lam4"], pot["vev"], pot["eps"], pot["g_delta"], pot["m_mix0"])
    knobs = make_knobs(slv["rho0"], slv["rho_max"], n_bisect=slv["n_bisect"],
                       n_dense=slv["n_dense"])
    row = torch.as_tensor(_params_row(spec_)[None], dtype=torch.float64)
    _rw, _act, crossed, phis, _dphis = dense_plain(row, torch.tensor([ref.phi0],
                                                                      dtype=torch.float64), knobs)
    assert bool(crossed[0])
    np.testing.assert_allclose(phis[0].numpy(), phi, rtol=0, atol=1e-13)

    sol = _reference_solution(cfg)(spec_)
    profile = bounce_profile(spec_, solution=sol)
    v = np.linspace(0.05, 0.95, 7)
    got = probabilities_for_points(profile, v, method="local", device="cpu")
    want = rb.local_probability(ref, pot["m_mix0"], v)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


def test_reference_takes_the_sweep_cli_axis_names():
    # The README's first sweep (m_chi_GeV x P_chi_to_B) and the other axes
    # whose CLI names differ from the point parameters', against the port
    # on the CPU: the same 1e-13 as above.
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.parallel.sweep import run_sweep

    cfg = _config("equal_mass")
    sizes = dict(cfg["sweep"], n_y=2000, chunk_size=32)
    axes = {"m_chi_GeV": np.geomspace(0.1, 10, 3), "P_chi_to_B": np.linspace(0.02, 0.9, 3),
            "source_shape_sigma_y": np.array([4.0, 9.0]),
            "incident_flux_scale": np.array([1e-9, 2e-9]), "m_B_GeV": np.array([0.9, 1.1])}
    base = config_from_dict(dict(cfg["yields_config"]))
    res = run_sweep(base, axes, static_choices_from_config(base), impl="kernel", device="cpu",
                    **sizes)
    inputs = ry.point_inputs(cfg["yields_config"], axes)
    ref = ry.yields_at(inputs, None, cfg["yields_config"], sizes, scheme=res.quad_impl,
                       dtype=torch.float64, device="cpu", cache={})
    for f in ("Y_B", "Y_chi", "DM_over_B"):
        np.testing.assert_allclose(res.outputs[f], ref[f], rtol=1e-13, atol=0)


@pytest.mark.parametrize("axis", ["sigma_v_chi_GeV_m2", "Gamma_wash_over_H", "P"])
def test_reference_refuses_what_it_does_not_model(axis):
    cfg = _config("equal_mass")
    with pytest.raises(ValueError):
        ry.point_inputs(cfg["yields_config"], {axis: np.array([0.1, 0.2])})
    with pytest.raises(ValueError):
        ry.refuse_unmodelled({"n_y": 8000, "lz_gamma_phi": 0.01})
