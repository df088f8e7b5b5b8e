"""The port's CUDA kernels against their plain PyTorch versions, and the
paths without a hand kernel (the stiff engine, the panel quadrature, the
single-point CLI), on the card.

This file imports no JAX (the card's machine has none); run it there
without the repository's conftest, which imports JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Without a CUDA device every test skips; the check is made inside a
fixture, so every worker collects the same tests.
"""
import numpy as np
import pytest
import torch

from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
from bdlz_tpu_torch.interop import point_params_from_numpy
from bdlz_tpu_torch.ops import kjma_kernel as kk
from bdlz_tpu_torch.ops.kjma_table import make_f_table, table_to_device
from bdlz_tpu_torch.parallel.sweep import build_grid, run_sweep

pytestmark = pytest.mark.gpu

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
N_POINTS, N_Y = 512, 2048


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "`python -m pytest --noconftest -m gpu`")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def setup(cuda):
    base = config_from_dict(ARCHIVED)
    rng = np.random.default_rng(7)
    # heavy masses and low T_p put part of every window below T = m/3
    grid = build_grid(base, {
        "m_chi_GeV": np.exp(rng.uniform(np.log(0.1), np.log(1000.0), N_POINTS)),
        "T_p_GeV": rng.uniform(30.0, 300.0, N_POINTS),
        "v_w": rng.uniform(0.05, 0.95, N_POINTS),
        "source_shape_sigma_y": rng.uniform(2.0, 20.0, N_POINTS),
    }, product=False)
    pp = point_params_from_numpy(grid, cuda)
    table = table_to_device(make_f_table(base.I_p), cuda)
    streams = {
        fused: kk.prepare_streams(pp, "fermion", table, N_Y, fuse_exp=fused)
        for fused in (False, True)
    }
    return base, table, streams


def _run(name, st, values, plain):
    fn = getattr(kk, ("interp_" + name + "_plain") if plain else ("interp_" + name))
    args = (st.g, st.a, st.i1, st.sfrac, values) if "fused" in name else (
        st.g, st.i1, st.sfrac, values)
    return fn(*args)


@pytest.mark.parametrize("name", ["reduce", "stream", "fused_reduce", "fused_stream"])
def test_kernel_matches_plain_version(name, setup):
    """Reduce: <= 1e-12 rel per point (summation order differs); stream:
    <= 1e-13 per node relative to the point's largest node."""
    _, table, streams = setup
    st = streams["fused" in name]
    got = _run(name, st, table.values, plain=False)
    torch.cuda.synchronize()
    ref = _run(name, st, table.values, plain=True)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    if name.endswith("reduce"):
        err = (got - ref).abs() / ref.abs().clamp_min(1e-300)
        assert err.max().item() <= 1e-12
    else:
        scale = ref.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
        assert ((got - ref).abs() / scale).max().item() <= 1e-13


def test_reduce_is_bitwise_reproducible(setup):
    _, table, streams = setup
    st = streams[False]
    a = kk.interp_reduce(st.g, st.i1, st.sfrac, table.values)
    b = kk.interp_reduce(st.g, st.i1, st.sfrac, table.values)
    assert torch.equal(a, b)


def test_launch_counter_counts_kernel_launches_only(setup):
    _, table, streams = setup
    st = streams[False]
    kk.reset_launches()
    kk.interp_reduce(st.g, st.i1, st.sfrac, table.values)
    kk.interp_reduce_plain(st.g, st.i1, st.sfrac, table.values)
    assert kk.LAUNCHES == {"reduce": 1, "stream": 0, "fused_reduce": 0,
                           "fused_stream": 0}


def test_wrapper_rejects_what_the_kernel_does_not_take(setup, cuda):
    _, table, streams = setup
    st = streams[False]
    with pytest.raises(TypeError):
        kk.interp_reduce(st.g, st.i1.long(), st.sfrac, table.values)
    with pytest.raises(ValueError):
        kk.interp_reduce(st.g.t(), st.i1.t(), st.sfrac.t(), table.values)
    big = torch.zeros(32768, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        kk.interp_reduce(st.g, st.i1, st.sfrac, big)


def test_kernel_sweep_matches_tabulated_sweep(setup, cuda):
    base, _, _ = setup
    # pinned: an unresolved tri-state would let the audit pick the panel rule
    static = static_choices_from_config(base)._replace(quad_panel_gl=False)
    axes = {"m_chi_GeV": np.geomspace(0.1, 10.0, 8),
            "T_p_GeV": np.geomspace(30.0, 300.0, 4)}
    kk.reset_launches()
    got = run_sweep(base, axes, static, chunk_size=16, n_y=2000, device=cuda)
    assert kk.LAUNCHES["reduce"] == 2
    ref = run_sweep(base, axes, static, chunk_size=16, n_y=2000,
                    impl="tabulated", device=cuda)
    g, r = got.outputs["DM_over_B"], ref.outputs["DM_over_B"]
    assert np.isfinite(g).all()
    assert np.max(np.abs(g - r) / np.abs(r)) <= 1e-10


STIFF = dict(ARCHIVED, Gamma_wash_over_H=0.01, T_min_over_Tp=0.1)
STIFF_AXES = {"m_chi_GeV": np.geomspace(0.3, 3.0, 2),
              "Gamma_wash_over_H": np.geomspace(1e-3, 0.5, 2),
              "source_shape_sigma_y": [3.0, 15.0]}


def test_stiff_repacked_equals_lockstep_bitwise_on_the_card(cuda):
    from bdlz_tpu_torch.physics.percolation import make_kjma_grid
    from bdlz_tpu_torch.solvers.batching import initial_yields, solve_boltzmann_esdirk_batch
    from bdlz_tpu_torch.solvers.sdirk import solve_boltzmann_esdirk

    base = config_from_dict(STIFF)
    static = static_choices_from_config(base)._replace(
        ode_auto_h0=False, ode_pi_controller=False, ode_tabulated_av=False)
    pp = point_params_from_numpy(build_grid(base, STIFF_AXES), cuda)
    grid = make_kjma_grid(cuda)
    rep = solve_boltzmann_esdirk_batch(pp, static, grid, round_steps=48)
    lock = solve_boltzmann_esdirk(pp, static, grid, initial_yields(pp, static),
                                  pp.T_min_over_Tp * pp.T_p_GeV, pp.T_max_over_Tp * pp.T_p_GeV)
    assert bool(lock.success.all())
    for f in ("y", "n_steps", "n_accepted", "n_rejected"):
        assert torch.equal(getattr(rep, f), getattr(lock, f)), f


def test_stiff_sweep_on_the_card_matches_the_cpu(cuda):
    """The default (repacked, knobs on) stiff sweep on the card and on the
    CPU: ≤1e-6 rel (only libm-level differences feed the adaptive steps)."""
    base = config_from_dict(STIFF)
    static = static_choices_from_config(base)
    a = run_sweep(base, STIFF_AXES, static, chunk_size=8, device=cuda)
    b = run_sweep(base, STIFF_AXES, static, chunk_size=8, device="cpu")
    assert a.impl == "esdirk" and a.n_failed == 0
    for f, r in b.outputs.items():
        assert np.max(np.abs(a.outputs[f] / r - 1.0)) <= 1e-6, f


def test_panel_sweep_on_the_card_matches_the_trapezoid(setup, cuda):
    base, _, _ = setup
    static = static_choices_from_config(base)
    axes = {"m_chi_GeV": np.geomspace(0.1, 10.0, 8), "T_p_GeV": np.geomspace(30.0, 300.0, 4)}
    kw = dict(chunk_size=32, n_y=8000, device=cuda)
    gl = run_sweep(base, axes, static, impl="tabulated", **kw)
    trap = run_sweep(base, axes, static, impl="kernel", **kw)
    assert (gl.quad_impl, gl.n_quad_nodes) == ("panel_gl", 560)
    g, r = gl.outputs["DM_over_B"], trap.outputs["DM_over_B"]
    assert np.max(np.abs(g / r - 1.0)) <= 1e-9


def test_cli_point_on_the_card(cuda):
    from bdlz_tpu_torch.cli import run_point

    cfg = config_from_dict(ARCHIVED)
    r = run_point(cfg, cfg.P_chi_to_B, cuda)
    assert r.DM_over_B.device.type == "cuda"
    assert abs(r.DM_over_B.item() / 5.688926334903014 - 1.0) <= 1e-12
    stiff = config_from_dict(STIFF)
    assert np.isfinite(run_point(stiff, stiff.P_chi_to_B, cuda).DM_over_B.item())


# ---- the bounce shoot kernel and the LZ layer on the card -------------------

def test_bounce_classify_kernel_matches_plain(cuda):
    """Verdicts, segment and step counts equal; states within 1e-9 rel (the
    plain version's torch pow and the kernel's may round apart)."""
    from bdlz_tpu_torch.bounce import reference_potential
    from bdlz_tpu_torch.bounce.shooting import _params_row, classify_plain, make_knobs
    from bdlz_tpu_torch.ops import bounce_kernel as bk

    knobs = make_knobs()
    row = _params_row(reference_potential())
    points = np.linspace(row[4], row[5], 5)[1:-1]
    params = torch.as_tensor(np.repeat(row[None], len(points), axis=0), device=cuda)
    phis = torch.as_tensor(points, device=cuda)
    bk.reset_launches()
    got = bk.bounce_classify(params, phis, knobs)
    ref = classify_plain(params, phis, knobs)
    assert bk.LAUNCHES == {"shoot": 0, "classify": 1}
    for f in ("verdict", "segments", "steps", "ok"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    for f in ("y_first", "y_end"):
        assert ((getattr(got, f) - getattr(ref, f)).abs()
                / getattr(ref, f).abs()).max().item() <= 1e-9, f


def test_bounce_batch_equals_loop_bitwise_on_the_card(cuda):
    from bdlz_tpu_torch.bounce import (
        PotentialSpec,
        reference_potential,
        solve_bounce_batch,
        solve_bounce_scalar_loop,
    )

    ref = reference_potential()
    specs = [ref._replace(eps=e) for e in (0.045, 0.05, 0.055)] + [
        PotentialSpec(0.8, 1.1, 0.09, 1.3, 0.04)]
    batch = solve_bounce_batch(specs, lane_width=3, device=cuda)
    loop = solve_bounce_scalar_loop(specs, device=cuda)
    assert batch.converged.all()
    for f in batch._fields:
        assert np.array_equal(getattr(batch, f), getattr(loop, f), equal_nan=True), f


def test_bounce_audit_on_the_card_launches_the_kernel(cuda):
    from bdlz_tpu_torch.ops import bounce_kernel as bk
    from bdlz_tpu_torch.validation import bounce_audit

    bk.reset_launches()
    audit = bounce_audit(device=cuda)
    assert bk.LAUNCHES["shoot"] == 1
    assert audit.ok and audit.n_crossings == 1 and audit.P_vs_archived <= 1e-6


def test_lz_table_on_the_card_matches_the_cpu(cuda):
    from bdlz_tpu_torch.lz.profile import BounceProfile
    from bdlz_tpu_torch.lz.sweep_bridge import make_P_of_vw_gamma_table, make_P_of_vw_table

    xi = np.linspace(-30.0, 30.0, 1001)
    prof = BounceProfile(xi=xi, delta=-0.08 * np.tanh(xi / 4.0), mix=np.full_like(xi, 0.02))
    for method in ("coherent", "dephased"):
        kw = {"gamma_phi": 0.01} if method == "dephased" else {}
        a = make_P_of_vw_table(prof, method, 0.05, 0.95, n=64, device=cuda, **kw)
        b = make_P_of_vw_table(prof, method, 0.05, 0.95, n=64, device="cpu", **kw)
        assert a.values.device.type == "cuda"
        assert ((a.values.cpu() - b.values).abs() / b.values).max().item() <= 1e-10
    t2 = make_P_of_vw_gamma_table(prof, 0.05, 0.95, 0.0, 0.1, n_v=32, n_g=8, device=cuda)
    assert t2.values.shape == (32, 8) and torch.isfinite(t2.values).all()
