"""The dephased transport's CUDA kernel (``ops/bloch_kernel``,
``csrc/bloch_transport.cu``) against its plain version, the pairwise tree
of 3×3 maps (``lz/kernel.propagate_bloch_plain``), on the card; and one
launch at a rate per lane against one launch per rate, bit for bit (a
lane's slices depend on the segments alone), with the thermal scenario's
one pass against the route of one pass per rate.

This file imports no JAX (the card's machine has none); run it there
without the repository's conftest, which imports JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_bloch_kernel_gpu.py

Without a CUDA device every test skips; the check is made inside a
fixture, so every worker collects the same tests.

Tolerance: |Δr| <= 1e-12 per component.  The kernel composes the
segments' maps in another order than the tree (slices in registers, then
the slices in order) and forms each phase as (ω dξ)(1/v) where the tree
forms ω (dξ / v), so only rounding may differ: ~1e-15 at the benchmark's
speeds.  At v = 1e-6 with Γ = 0 a phase reaches ~2e4 rad, where one
rounding of it moves r by ~1e-12 a segment for any evaluation; with the
bath's rates the coherences decay within a segment there, so the clipped
speeds are held at those rates.
"""
import numpy as np
import pytest
import torch

from bdlz_tpu_torch.bounce import bounce_profile, reference_potential
from bdlz_tpu_torch.lz import kernel as lk
from bdlz_tpu_torch.lz.profile import BounceProfile
from bdlz_tpu_torch.lz.sweep_bridge import probabilities_for_points
from bdlz_tpu_torch.lz.thermal import (
    thermal_gamma_phi,
    thermal_method_for,
    thermal_probabilities_for_points,
)
from bdlz_tpu_torch.ops import bloch_kernel as bk
from bdlz_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

TOL = 1e-12
#: Γ_φ of the benchmark's bath over its T_p box (0.047-0.092 GeV).
RATES = (0.047, 0.07, 0.092)
F64 = torch.float64


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "`python -m pytest --noconftest -m gpu`")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def shot(cuda):
    """The benchmark cell's profile: the reference potential shot on the
    card, 801 samples over ±8 wall widths (800 segments)."""
    return bounce_profile(reference_potential(), device=cuda)


def _segments(profile, dev):
    return lk._segment_hamiltonians(profile, dev)


def _speeds(values, dev):
    return torch.as_tensor(np.asarray(values, dtype=np.float64), dtype=F64, device=dev)


def _rates(gamma, v):
    """One rate for each of the speeds ``v``."""
    return torch.full_like(v, gamma)


def _gap(a, b, dxi, v, gamma):
    got = bk.bloch_transport(a, b, dxi, v, _rates(gamma, v))
    want = lk.propagate_bloch_plain(a, b, dxi, v, _rates(gamma, v))
    torch.cuda.synchronize()
    assert got.shape == want.shape == (v.shape[0], 3)
    assert bool(torch.isfinite(got).all())
    return float((got - want).abs().max())


@pytest.mark.parametrize("gamma", RATES)
def test_the_cells_shape(cuda, shot, gamma):
    a, b, dxi = _segments(shot, cuda)
    assert a.shape == (800,)
    v = _speeds(np.linspace(0.05, 0.95, 1024), cuda)
    assert _gap(a, b, dxi, v, gamma) <= TOL


def test_no_dephasing(cuda, shot):
    a, b, dxi = _segments(shot, cuda)
    v = _speeds(np.linspace(0.05, 0.95, 1024), cuda)
    assert _gap(a, b, dxi, v, 0.0) <= TOL


@pytest.mark.parametrize("gamma", RATES)
def test_speeds_at_the_clips(cuda, shot, gamma):
    a, b, dxi = _segments(shot, cuda)
    v = _speeds([1e-6, 2e-6, 1e-3, 0.5, 1.0 - 1e-12], cuda)
    assert _gap(a, b, dxi, v, gamma) <= TOL


def test_the_upper_clip_without_dephasing(cuda, shot):
    a, b, dxi = _segments(shot, cuda)
    assert _gap(a, b, dxi, _speeds([1.0 - 1e-12, 0.999], cuda), 0.0) <= TOL


@pytest.mark.parametrize("gamma", [0.0, RATES[1]])
def test_a_segment_with_no_hamiltonian_is_the_identity_rotation(cuda, shot, gamma):
    a, b, dxi = (t.clone() for t in _segments(shot, cuda))
    # ω = 0 on the first segment, on three next to the wall and on the last
    for k in (0, 398, 399, 400, 799):
        a[k] = 0.0
        b[k] = 0.0
    v = _speeds(np.linspace(0.05, 0.95, 256), cuda)
    assert _gap(a, b, dxi, v, gamma) <= TOL
    # a profile of one such segment leaves ẑ decayed by nothing
    one = bk.bloch_transport(a[:1], b[:1], dxi[:1], v[:3], _rates(gamma, v[:3]))
    assert torch.equal(one.cpu(), torch.tensor([[0.0, 0.0, 1.0]] * 3, dtype=F64))


@pytest.mark.parametrize("n_speeds", [1, 7, 1000])
def test_speed_counts_off_the_block(cuda, shot, n_speeds):
    a, b, dxi = _segments(shot, cuda)
    v = _speeds(np.linspace(0.05, 0.95, n_speeds), cuda)
    for gamma in (0.0, RATES[2]):
        assert _gap(a, b, dxi, v, gamma) <= TOL


@pytest.mark.parametrize("n_seg", [1, 31, 65, 2500])
def test_profiles_off_the_slices_and_over_several_tiles(cuda, n_seg):
    # a smooth wall of n_seg segments: fewer than the slices, not a
    # multiple of them, and more than one tile of 1024 staged segments
    xi = np.linspace(-20.0, 20.0, n_seg + 1)
    prof = BounceProfile(xi=xi, delta=np.tanh(xi / 2.5) + 0.05 * np.sin(xi),
                         mix=0.05 * (1.0 + 0.2 * np.cos(xi / 2.5)))
    a, b, dxi = _segments(prof, cuda)
    v = _speeds(np.linspace(0.05, 0.95, 300), cuda)
    for gamma in (0.0, RATES[0]):
        assert _gap(a, b, dxi, v, gamma) <= TOL


def test_one_launch_per_pass(cuda, shot):
    v = np.linspace(0.05, 0.95, 1024)
    bk.reset_launches()
    probabilities_for_points(shot, v, method="dephased", gamma_phi=RATES[0], device=cuda)
    assert bk.LAUNCHES["bloch"] == 1
    # the thermal scenario: one pass for every rate
    bk.reset_launches()
    T = np.repeat([30.0, 100.0, 300.0], v.size)
    P = thermal_probabilities_for_points(shot, np.tile(v, 3), T, 0.001, 50.0, device=cuda)
    assert bk.LAUNCHES["bloch"] == 1 and np.isfinite(P).all()
    bk.reset_launches()


def test_a_pass_is_one_launch_where_the_trees_leaves_would_split_it(cuda, shot, monkeypatch):
    # a budget of 100 speeds' tree leaves (1024 padded segments of 3×3
    # f64): the tree would take 11 chunks, the kernel stages no leaves
    monkeypatch.setenv("BDLZ_LZ_SPEED_CHUNK_BYTES", str(1024 * 8 * 9 * 100))
    v = np.linspace(0.05, 0.95, 1024)
    bk.reset_launches()
    probabilities_for_points(shot, v, method="dephased", gamma_phi=RATES[0], device=cuda)
    assert bk.LAUNCHES["bloch"] == 1
    bk.reset_launches()


def test_each_launch_is_a_span_inside_its_pass(cuda, shot):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        probabilities_for_points(shot, np.linspace(0.05, 0.95, 64), method="dephased",
                                 gamma_phi=RATES[1], device=cuda)
    ev = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
          if e.name() in ("lz.dephase", "lz.dephase.kernel")]
    (outer,) = [e for e in ev if e[0] == "lz.dephase"]
    (inner,) = [e for e in ev if e[0] == "lz.dephase.kernel"]
    assert outer[1] <= inner[1] and inner[2] <= outer[2]


def test_inputs_the_kernel_does_not_take_raise(cuda, shot):
    a, b, dxi = _segments(shot, cuda)
    v = _speeds(np.linspace(0.05, 0.95, 16), cuda)
    rates = torch.full((16,), 0.05, dtype=F64, device=cuda)
    bk.reset_launches()
    with pytest.raises(TypeError, match="float64"):
        bk.bloch_transport(a.float(), b, dxi, v, rates)
    with pytest.raises(TypeError, match="float64"):
        bk.bloch_transport(a, b, dxi, v.float(), rates)
    with pytest.raises(ValueError, match="contiguous"):
        bk.bloch_transport(a, b, dxi, torch.stack([v, v], 1)[:, 0], rates)
    with pytest.raises(ValueError, match="contiguous"):
        bk.bloch_transport(torch.stack([a, a], 1)[:, 0], b, dxi, v, rates)
    with pytest.raises(ValueError, match="1-D"):
        bk.bloch_transport(a, b, dxi, v[None], rates)
    with pytest.raises(ValueError, match="one value per segment"):
        bk.bloch_transport(a, b[:-1], dxi, v, rates)
    with pytest.raises(ValueError, match="is on"):
        bk.bloch_transport(a.cpu(), b, dxi, v, rates)
    with pytest.raises(ValueError, match="is on"):
        bk.bloch_transport(a, b, dxi, v, rates.cpu())
    with pytest.raises(TypeError, match="float64"):
        bk.bloch_transport(a, b, dxi, v, rates.float())
    with pytest.raises(ValueError, match="one rate per speed"):
        bk.bloch_transport(a, b, dxi, v, rates[:-1])
    with pytest.raises(ValueError, match="one rate per speed"):
        bk.bloch_transport(a, b, dxi, v, torch.cat([rates, rates]))
    with pytest.raises(ValueError, match="one rate per speed"):
        bk.bloch_transport(a, b, dxi, v, rates[:1])
    assert bk.LAUNCHES["bloch"] == 0


def test_nan_debugging_sees_what_the_kernel_wrote(cuda, shot):
    a, b, dxi = _segments(shot, cuda)
    v = _speeds([0.3, float("nan")], cuda)
    profiling.enable_nan_debugging(True)
    try:
        with pytest.raises(FloatingPointError, match="bloch_transport"):
            bk.bloch_transport(a, b, dxi, v, _rates(0.05, v))
    finally:
        profiling.enable_nan_debugging(False)
    # a NaN speed stays NaN, as the tree's clamp leaves it
    assert bool(torch.isnan(bk.bloch_transport(a, b, dxi, v, _rates(0.05, v))[1]).all())


def _cell_lanes(n_rates, n_speeds, dev):
    """Every (rate, speed) pair of the cell's grid: the bath's Γ_φ over
    T_p geom(30, 300) (η 0.001, ω_c 50 GeV) and v_w lin(0.05, 0.95)."""
    rates = thermal_gamma_phi(np.geomspace(30.0, 300.0, n_rates), 0.001, 50.0)
    speeds = np.linspace(0.05, 0.95, n_speeds)
    return (_speeds(np.tile(speeds, n_rates), dev), _speeds(np.repeat(rates, n_speeds), dev),
            rates, n_speeds)


def _per_rate_launches(a, b, dxi, v, rates, n_speeds):
    """One launch per rate, as the scalar-rate callers make it."""
    return torch.cat([lk.propagate_bloch(a, b, dxi, v[i * n_speeds:(i + 1) * n_speeds],
                                         float(g)) for i, g in enumerate(rates)])


def test_one_launch_over_the_cells_rates_is_the_per_rate_launches(cuda, shot):
    # 128 rates × 1024 speeds × 800 segments: the cell's one pass a sweep
    a, b, dxi = _segments(shot, cuda)
    v, g, rates, n = _cell_lanes(128, 1024, cuda)
    bk.reset_launches()
    got = bk.bloch_transport(a, b, dxi, v, g)
    assert bk.LAUNCHES["bloch"] == 1
    want = _per_rate_launches(a, b, dxi, v, rates, n)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
    # and a slice of it against the tree
    assert float((got[:512] - lk.propagate_bloch_plain(a, b, dxi, v[:512], g[:512]))
                 .abs().max()) <= TOL
    bk.reset_launches()


@pytest.mark.parametrize("n_rates,n_speeds", [(1, 1), (3, 7), (5, 333), (2, 8 * 1001 + 5)])
def test_lane_counts_off_the_block(cuda, shot, n_rates, n_speeds):
    a, b, dxi = _segments(shot, cuda)
    v, g, rates, n = _cell_lanes(n_rates, n_speeds, cuda)
    got = bk.bloch_transport(a, b, dxi, v, g)
    assert torch.equal(got, _per_rate_launches(a, b, dxi, v, rates, n))
    head = slice(0, min(v.shape[0], 300))
    assert float((got[head] - lk.propagate_bloch_plain(a, b, dxi, v[head], g[head]))
                 .abs().max()) <= TOL


def test_a_float_rate_is_that_rate_in_every_lane(cuda, shot):
    a, b, dxi = _segments(shot, cuda)
    v = _speeds(np.linspace(0.05, 0.95, 1024), cuda)
    for gamma in (0.0, RATES[1], -0.5):
        rates = torch.full((1024,), max(gamma, 0.0), dtype=F64, device=cuda)
        assert torch.equal(lk.propagate_bloch(a, b, dxi, v, gamma),
                           bk.bloch_transport(a, b, dxi, v, rates))
    # a negative rate in a tensor is taken as 0 too
    mixed = torch.tensor([-1.0, 0.0] * 512, dtype=F64, device=cuda)
    assert torch.equal(bk.bloch_transport(a, b, dxi, v, mixed),
                       lk.propagate_bloch(a, b, dxi, v, 0.0))


def test_the_thermal_pass_on_the_card_is_the_per_rate_route(cuda, shot):
    # mixed rates, a Γ = 0 group (T <= 0), NaN and inf rows, speeds
    # repeated and at the clips, shuffled: the one pass against one pass
    # per distinct rate, both on the card
    r = np.random.default_rng(2 ** 31 + 11)
    speeds = np.concatenate([np.linspace(0.05, 0.95, 40),
                             [0.0, 1e-7, 1.0, 1.3, np.nan, np.inf]])
    temps = np.concatenate([np.geomspace(30.0, 300.0, 9), [0.0, -2.0, np.nan, np.inf]])
    T, v = (x.ravel() for x in np.meshgrid(temps, speeds, indexing="ij"))
    order = r.permutation(np.tile(np.arange(v.size), 2))
    T, v = T[order], v[order]
    bk.reset_launches()
    got = thermal_probabilities_for_points(shot, v, T, 0.001, 50.0, device=cuda)
    assert bk.LAUNCHES["bloch"] == 1
    gam = thermal_gamma_phi(T, 0.001, 50.0)
    want = np.full(v.shape, np.nan)
    finite = np.isfinite(gam) & np.isfinite(v)
    for g_ in np.unique(gam[finite]):
        sel = finite & (gam == g_)
        method, g_used = thermal_method_for(float(g_))
        want[sel] = probabilities_for_points(shot, v[sel], method=method, gamma_phi=g_used,
                                             device=cuda)
    assert np.array_equal(np.isnan(got), ~finite)
    assert np.array_equal(got[finite].view(np.uint64), want[finite].view(np.uint64))
    bk.reset_launches()
