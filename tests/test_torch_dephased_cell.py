"""The port's dephased and thermal LZ transport against the benchmark's plain
reference (``benchmark/reference/bloch.py``) on the CPU, and the span and
counters that the ``bounce_lz_dephased.scan`` cell reads.

* P of the dephased transport (a fixed Gamma_phi) and of the thermal
  scenario (Gamma_phi from each point's T_p) on seeded random smooth
  profiles of a few dozen segments, at random speeds, rates and bath
  parameters: the port composes quaternion-built 3x3 maps by a pairwise
  tree, the reference applies complex 2x2 propagators' adjoints one
  segment after the other; they differ by rounding, <= 1e-12 relative.
* A thermal ``run_sweep`` on the kernel engine against the reference's
  yields fed the reference's P.
* The thermal scenario's one pass (every distinct (T_p, v_w) pair a lane
  at its own rate) against the route of one pass per distinct rate,
  reproduced here: the same bits, NaN rows included.
* The span ``lz.dephase`` once per dephased pass (one under the thermal
  bath whatever its rates, none on the coherent path), inside
  ``lz.points``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bdlz_tpu_torch import config as tc
from bdlz_tpu_torch.lz.profile import BounceProfile
from bdlz_tpu_torch.lz.sweep_bridge import probabilities_for_points
from bdlz_tpu_torch.lz.thermal import (
    thermal_gamma_phi,
    thermal_method_for,
    thermal_probabilities_for_points,
)
from bdlz_tpu_torch.parallel import sweep as ts
from benchmark.reference import bloch
from benchmark.reference import yields as ry

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": None,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
SEEDS = [2 ** 31 + 7, 12345, 987654321, 42]


def _profile(seed: int, n_seg: int = None) -> BounceProfile:
    """A smooth wall: Delta a tanh with a ripple through one crossing, the
    mixing positive and varying, over +-halfwidth, on a seeded number of
    segments (a few dozen)."""
    r = np.random.default_rng(seed)
    n_seg = int(r.integers(24, 64)) if n_seg is None else n_seg
    half = r.uniform(8.0, 30.0)
    xi = np.linspace(-half, half, n_seg + 1)
    width = r.uniform(1.0, 4.0)
    delta = r.uniform(0.5, 1.5) * np.tanh((xi - r.uniform(-1, 1)) / width) \
        + 0.05 * np.sin(r.uniform(0.5, 2.0) * xi)
    mix = r.uniform(0.05, 0.3) * (1.0 + 0.2 * np.cos(xi / width))
    return BounceProfile(xi=xi, delta=delta, mix=mix)


def _lz_spans(fn):
    """``fn()`` under the CPU profiler, and its ``lz.points`` and
    ``lz.dephase`` spans as (name, start_ns, end_ns)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof_:
        out = fn()
    return out, [(e.name(), int(e.start_ns()), int(e.end_ns()))
                 for e in prof_.profiler.kineto_results.events()
                 if e.name() in ("lz.points", "lz.dephase")]


def _reference_P(prof: BounceProfile, v, gamma) -> np.ndarray:
    return bloch.probability(prof.xi, prof.delta, prof.mix, v, gamma)


@pytest.mark.parametrize("mode", ["dephased", "thermal"])
@pytest.mark.parametrize("seed", SEEDS)
def test_port_P_matches_the_plain_reference(seed, mode):
    r = np.random.default_rng(seed + 1)
    prof = _profile(seed)
    v = r.uniform(0.05, 0.95, 24)
    if mode == "dephased":
        gamma = r.uniform(0.005, 0.3)
        got = probabilities_for_points(prof, v, method="dephased", gamma_phi=gamma,
                                       device="cpu")
        want = _reference_P(prof, v, np.full_like(v, gamma))
    else:
        T = r.uniform(20.0, 400.0, 24)
        eta, omega_c = r.uniform(1e-4, 5e-3), r.uniform(5.0, 200.0)
        got = thermal_probabilities_for_points(prof, v, T, eta, omega_c, device="cpu")
        gamma = bloch.bath_rate(T, eta, omega_c)
        np.testing.assert_allclose(thermal_gamma_phi(T, eta, omega_c), gamma, rtol=1e-15)
        want = _reference_P(prof, v, gamma)
    assert np.all((want > 1e-3) & (want < 1.0))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_thermal_sweep_matches_the_reference_yields():
    # The kernel engine's yields against the reference's yields fed the
    # reference's P: the outputs are linear in P (Y_B) or in 1/P
    # (DM_over_B), so P's 1e-12 above carries over; the yields alone
    # agree to ~1e-15 (benchmark/tests, 1e-13).
    prof = _profile(SEEDS[0], n_seg=40)
    cfg = dict(ARCHIVED, lz_mode="thermal", lz_bath_eta=0.002, lz_bath_omega_c=40.0)
    base = tc.config_from_dict(cfg)
    axes = {"m_chi_GeV": np.geomspace(0.3, 3.0, 3), "T_p_GeV": np.geomspace(30.0, 300.0, 4),
            "v_w": np.linspace(0.1, 0.9, 5)}
    sizes = dict(chunk_size=16, n_y=400, table_nodes=512)
    res = ts.run_sweep(base, axes, tc.static_choices_from_config(base), impl="kernel",
                       lz_profile=prof, device="cpu", **sizes)
    assert res.n_failed == 0 and res.lz_identity is not None
    yc = dataclasses.asdict(base)
    inputs = ry.point_inputs(yc, axes)
    P = _reference_P(prof, inputs["v_w"], bloch.bath_rate(inputs["T_p_GeV"], 0.002, 40.0))
    inputs["P_chi_to_B"] = P
    ref = ry.yields_at(inputs, None, yc, sizes, scheme=res.quad_impl, dtype=torch.float64,
                       device="cpu", cache={})
    for f in ("Y_B", "Y_chi", "DM_over_B"):
        np.testing.assert_allclose(res.outputs[f], ref[f], rtol=1e-12, atol=0)


@pytest.mark.parametrize("path", ["thermal", "dephased", "coherent"])
def test_each_dephased_pass_is_one_span(path):
    prof = _profile(SEEDS[1], n_seg=33)
    v = np.tile(np.linspace(0.1, 0.9, 7), 10)            # 7 distinct speeds, repeated
    T = np.repeat(np.geomspace(30.0, 300.0, 5), 14)      # 5 distinct temperatures
    if path == "thermal":
        _, spans = _lz_spans(lambda: thermal_probabilities_for_points(prof, v, T, 0.001, 50.0,
                                                                      device="cpu"))
        passes = 1
    else:
        gamma = 0.05 if path == "dephased" else 0.0
        _, spans = _lz_spans(lambda: probabilities_for_points(prof, v, method=path,
                                                              gamma_phi=gamma, device="cpu"))
        passes = 1 if path == "dephased" else 0
    assert [s[0] for s in spans] == ["lz.dephase"] * passes


def test_the_dephased_passes_lie_inside_the_points_span():
    prof = _profile(SEEDS[2], n_seg=30)
    cfg = dict(ARCHIVED, lz_mode="thermal", lz_bath_eta=0.001, lz_bath_omega_c=50.0)
    base = tc.config_from_dict(cfg)
    axes = {"T_p_GeV": np.geomspace(30.0, 300.0, 3), "v_w": np.linspace(0.1, 0.9, 4)}
    res, spans = _lz_spans(lambda: ts.run_sweep(
        base, axes, tc.static_choices_from_config(base), impl="kernel", lz_profile=prof,
        device="cpu", chunk_size=16, n_y=400, table_nodes=512))
    assert res.n_failed == 0
    (points,) = [s for s in spans if s[0] == "lz.points"]
    dephase = [s for s in spans if s[0] == "lz.dephase"]
    assert len(dephase) == 1
    assert all(points[1] <= s[1] and s[2] <= points[2] for s in dephase)


def _per_rate_route(prof, v, T, eta, omega_c):
    """The thermal scenario as one pass per distinct rate: each rate's
    points masked out of all of them, their speeds through
    ``probabilities_for_points`` (the Gamma = 0 group through the coherent
    kernel), the result scattered back; non-finite rows NaN."""
    v = np.asarray(v, dtype=np.float64)
    gam = np.atleast_1d(thermal_gamma_phi(np.broadcast_to(T, v.shape), eta, omega_c))
    out = np.full(v.shape, np.nan)
    finite = np.isfinite(gam) & np.isfinite(v)
    for g in np.unique(gam[finite]):
        sel = finite & (gam == g)
        method, g_used = thermal_method_for(float(g))
        out[sel] = probabilities_for_points(prof, v[sel], method=method, gamma_phi=g_used,
                                            device="cpu")
    return out


def _thermal_case(case, r):
    """(v, T, eta, omega_c) of one mix of points, shuffled."""
    speeds = r.uniform(0.05, 0.95, 9)
    temps = r.uniform(20.0, 400.0, 6)
    eta, omega_c = r.uniform(1e-4, 5e-3), r.uniform(5.0, 200.0)
    if case == "cold":          # a Gamma = 0 group beside the dephased rates
        temps = np.concatenate([temps, [0.0, -3.0, -np.inf]])
    elif case == "no_bath":     # eta = 0: every rate 0, the coherent pass alone
        eta = 0.0
    elif case == "clips":       # speeds at and beyond the clips, repeated
        speeds = np.array([0.0, -0.2, 1e-7, 1e-6, 0.5, 1.0 - 1e-12, 1.0, 1.7, 0.5, 1e-7])
    elif case == "non_finite":  # NaN and inf rows of either axis
        speeds = np.concatenate([speeds, [np.nan, np.inf, -np.inf]])
        temps = np.concatenate([temps, [np.nan, np.inf]])
    T, v = (x.ravel() for x in np.meshgrid(temps, speeds, indexing="ij"))
    T, v = np.tile(T, 3), np.tile(v, 3)  # every pair three times
    order = r.permutation(v.size)
    return v[order], T[order], eta, omega_c


def _same_bits(got, want):
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.array_equal(got[ok].view(np.uint64), want[ok].view(np.uint64))


@pytest.mark.parametrize("case", ["mixed", "cold", "no_bath", "clips", "non_finite"])
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_the_thermal_pass_is_the_per_rate_route_bit_for_bit(seed, case):
    r = np.random.default_rng(seed + 3)
    prof = _profile(seed)
    v, T, eta, omega_c = _thermal_case(case, r)
    got = thermal_probabilities_for_points(prof, v, T, eta, omega_c, device="cpu")
    _same_bits(got, _per_rate_route(prof, v, T, eta, omega_c))
    assert np.isnan(got).any() == (case == "non_finite")


def test_the_thermal_pass_keeps_its_bits_where_the_budget_cuts_its_lanes(monkeypatch):
    # a budget of 5 speeds' tree leaves: the lanes (speeds with their
    # rates) are cut into chunks of 5, the last padded with the last lane
    r = np.random.default_rng(7)
    prof = _profile(SEEDS[3], n_seg=40)
    v, T, eta, omega_c = _thermal_case("mixed", r)
    want = _per_rate_route(prof, v, T, eta, omega_c)
    monkeypatch.setenv("BDLZ_LZ_SPEED_CHUNK_BYTES", str(64 * 8 * 9 * 5))
    _same_bits(thermal_probabilities_for_points(prof, v, T, eta, omega_c, device="cpu"), want)


@pytest.mark.parametrize("shape", ["scalar_T", "2-D"])
def test_the_thermal_pass_takes_the_points_shapes(shape):
    prof = _profile(SEEDS[0], n_seg=30)
    v = np.linspace(0.1, 0.9, 12)
    T = 80.0 if shape == "scalar_T" else np.geomspace(30.0, 300.0, 3)[:, None]
    if shape == "2-D":
        v = np.broadcast_to(v, (3, 12))
    got = thermal_probabilities_for_points(prof, v, T, 0.001, 50.0, device="cpu")
    assert got.shape == v.shape
    _same_bits(got.ravel(), _per_rate_route(prof, v.ravel(),
                                            np.broadcast_to(T, v.shape).ravel(), 0.001, 50.0))
