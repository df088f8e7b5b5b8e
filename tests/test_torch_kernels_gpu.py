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
    return base, table, kk.point_scalars(pp, "fermion", table, N_Y)


#: Each tier's wrapper (``reduce=False`` is a stream tier).
TIER_WRAPPER = {"reduce": "point_reduce", "stream": "point_stream",
                "fused_reduce": "point_fused_reduce", "fused_stream": "point_fused_stream"}
#: A stream kernel's nodes against its plain version's, relative to the
#: row's largest node: the same operations in the same order per node.
STREAM_RTOL = 1e-14


def _stream_rel(got, ref):
    """Largest per-node error relative to each row's largest node; the
    plain version's zeros (empty rows, nodes past the cut) are exact."""
    zero = ref == 0
    assert torch.equal(got[zero], ref[zero])
    scale = ref.abs().amax(dim=-1, keepdim=True).clamp_min(1e-300)
    return ((got - ref).abs() / scale).max().item()


@pytest.mark.parametrize("name", ["reduce", "stream", "fused_reduce", "fused_stream"])
def test_kernel_matches_plain_version(name, setup):
    """Reduce: <= 1e-13 rel per point (summation order differs); stream:
    <= 1e-14 per node relative to the point's largest node."""
    _, table, s = setup
    wrapper = TIER_WRAPPER[name]
    got = getattr(kk, wrapper)(s, table, N_Y)
    torch.cuda.synchronize()
    ref = getattr(kk, wrapper + "_plain")(s, table, N_Y)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    if name.endswith("reduce"):
        err = (got - ref).abs() / ref.abs().clamp_min(1e-300)
        assert err.max().item() <= 1e-13
    else:
        assert got.shape == (N_POINTS, N_Y)
        assert _stream_rel(got, ref) <= STREAM_RTOL


def test_reduce_is_bitwise_reproducible(setup):
    _, table, s = setup
    for wrapper in TIER_WRAPPER.values():
        fn = getattr(kk, wrapper)
        assert torch.equal(fn(s, table, N_Y), fn(s, table, N_Y)), wrapper


def test_launch_counter_counts_kernel_launches_only(setup):
    _, table, s = setup
    kk.reset_launches()
    kk.point_stream(s, table, N_Y)
    kk.point_stream_plain(s, table, N_Y)
    assert kk.LAUNCHES == {"point_reduce": 0, "point_fused_reduce": 0,
                           "point_stream": 1, "point_fused_stream": 0}


def test_wrapper_rejects_what_the_kernel_does_not_take(setup, cuda):
    _, table, s = setup
    with pytest.raises(TypeError):
        kk.point_stream(s.float(), table, N_Y)
    with pytest.raises(ValueError):
        kk.point_stream(s.t().contiguous().t(), table, N_Y)
    with pytest.raises(ValueError):
        kk.point_fused_stream(s[:, :-1].contiguous(), table, N_Y)
    big = torch.zeros(32768, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        kk.point_stream(s, table._replace(values=big), N_Y)


def test_kernel_sweep_matches_tabulated_sweep(setup, cuda):
    base, _, _ = setup
    # pinned: an unresolved tri-state would let the audit pick the panel rule
    static = static_choices_from_config(base)._replace(quad_panel_gl=False)
    axes = {"m_chi_GeV": np.geomspace(0.1, 10.0, 8),
            "T_p_GeV": np.geomspace(30.0, 300.0, 4)}
    kk.reset_launches()
    got = run_sweep(base, axes, static, chunk_size=16, n_y=2000, impl="kernel", device=cuda)
    assert kk.LAUNCHES == {k: (2 if k == "point_reduce" else 0) for k in kk.LAUNCHES}
    ref = run_sweep(base, axes, static, chunk_size=16, n_y=2000,
                    impl="tabulated", device=cuda)
    g, r = got.outputs["DM_over_B"], ref.outputs["DM_over_B"]
    assert np.isfinite(g).all()
    assert np.max(np.abs(g - r) / np.abs(r)) <= 1e-10


# ---- the point kernels (csrc/kjma_point.cu) ---------------------------------

POINT_RTOL = 1e-13   # kernel vs plain per point: the summation order differs


def _window(s, lo, hi):
    """``s`` with every row's window set to [lo, hi] by hand."""
    s = s.clone()
    c = kk._COL
    s[:, c["y_lo"]], s[:, c["y_hi"]] = lo, hi
    return s


def _edge_scalars(base, table, n_y, dev):
    """Rows of every kind the point kernels take: the setup's seam-crossing
    points, empty (reversed, clipped away, zero-width) windows, windows
    across and above y = 50, stacked into one block."""
    import dataclasses

    rng = np.random.default_rng(3)
    grid = build_grid(base, {
        "m_chi_GeV": np.exp(rng.uniform(np.log(0.1), np.log(1000.0), 133)),
        "T_p_GeV": rng.uniform(30.0, 300.0, 133),
        "source_shape_sigma_y": rng.uniform(2.0, 20.0, 133)}, product=False)
    parts = [kk.point_scalars(point_params_from_numpy(grid, dev), "fermion", table, n_y)]
    for lo, hi, B in ((5.0, 4.0, 100.0), (4.0, 5.0, 400.0), (1.0, 1.0, 100.0)):
        cfg = dataclasses.replace(base, T_min_over_Tp=lo, T_max_over_Tp=hi, beta_over_H=B)
        pp = point_params_from_numpy(build_grid(cfg, {"m_chi_GeV": [0.95, 500.0]}), dev)
        parts.append(kk.point_scalars(pp, "fermion", table, n_y))
    parts.append(_window(parts[0][:4], 40.0, 60.0))
    parts.append(_window(parts[0][:4], 51.0, 60.0))
    return torch.cat(parts).contiguous()


def _point_rel(got, ref):
    zero = ref == 0
    assert torch.equal(got[zero], ref[zero])  # empty windows: exactly 0 on both
    return ((got - ref).abs() / ref.abs().clamp_min(1e-300))[~zero].max().item()


@pytest.mark.parametrize("n_y", [2000, N_Y, 8000])
@pytest.mark.parametrize("name", ["point_reduce", "point_fused_reduce",
                                  "point_stream", "point_fused_stream"])
def test_point_kernel_matches_plain_version(name, n_y, setup, cuda):
    base, table, _ = setup
    s = _edge_scalars(base, table, n_y, cuda)
    fn, plain = getattr(kk, name), getattr(kk, name + "_plain")
    # a table of ones too: the KJMA F underflows long before y = 50, so only
    # there do the nodes above the cut carry weight until the select drops them
    ones = table._replace(values=torch.ones_like(table.values))
    for tab, rows in ((table, s), (table, s[:1]), (table, s[:0]), (table, s[:133]),
                      (ones, s)):
        kk.reset_launches()
        got = fn(rows, tab, n_y)
        torch.cuda.synchronize()
        assert kk.LAUNCHES[name] == (1 if rows.shape[0] else 0)
        ref = plain(rows, tab, n_y)
        assert torch.isfinite(got).all()
        if name.endswith("reduce"):
            assert got.shape == ref.shape == (rows.shape[0],)
            if rows.shape[0]:
                assert _point_rel(got, ref) <= POINT_RTOL
        else:
            assert got.shape == ref.shape == (rows.shape[0], n_y)
            if rows.shape[0]:
                assert _stream_rel(got, ref) <= STREAM_RTOL


def test_point_kernel_is_bitwise_reproducible(setup, cuda):
    base, table, _ = setup
    s = _edge_scalars(base, table, N_Y, cuda)
    for fn in (kk.point_reduce, kk.point_fused_reduce, kk.point_stream,
               kk.point_fused_stream):
        assert torch.equal(fn(s, table, N_Y), fn(s, table, N_Y))


def test_point_wrapper_rejects_what_the_kernel_does_not_take(setup, cuda):
    base, table, _ = setup
    s = _edge_scalars(base, table, N_Y, cuda)
    with pytest.raises(TypeError):
        kk.point_reduce(s.float(), table, N_Y)
    with pytest.raises(ValueError):
        kk.point_reduce(s, table._replace(values=table.values.cpu()), N_Y)
    with pytest.raises(ValueError):
        kk.point_reduce(s.t().contiguous().t(), table, N_Y)
    with pytest.raises(ValueError):
        kk.point_reduce(s[:, :-1].contiguous(), table, N_Y)
    big = torch.zeros(32768, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        kk.point_fused_reduce(s, table._replace(values=big), N_Y)
    with pytest.raises(ValueError):
        kk.point_fused_stream(s, table._replace(values=table.values.cpu()), N_Y)


def test_kernel_sweep_runs_the_point_kernel_once_per_chunk_and_k1_never(setup, cuda):
    base, _, _ = setup
    static = static_choices_from_config(base)
    axes = {"m_chi_GeV": np.geomspace(0.1, 10.0, 8), "T_p_GeV": np.geomspace(30.0, 300.0, 6)}
    for (fuse_exp, reduce), name in (((False, True), "point_reduce"),
                                     ((True, True), "point_fused_reduce"),
                                     ((False, False), "point_stream"),
                                     ((True, False), "point_fused_stream")):
        kk.reset_launches()
        res = run_sweep(base, axes, static, chunk_size=16, n_y=N_Y, impl="kernel",
                        fuse_exp=fuse_exp, reduce=reduce, device=cuda)
        assert res.chunks == 3 and res.n_failed == 0
        assert kk.LAUNCHES == {k: (3 if k == name else 0) for k in kk.LAUNCHES}


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
    a = run_sweep(base, STIFF_AXES, static, chunk_size=8, impl="kernel", device=cuda)
    b = run_sweep(base, STIFF_AXES, static, chunk_size=8, impl="kernel", device="cpu")
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
    assert bk.LAUNCHES == {"shoot": 0, "shoot_serial": 0, "classify": 1}
    for f in ("verdict", "segments", "steps", "ok"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    for f in ("y_first", "y_end"):
        assert ((getattr(got, f) - getattr(ref, f)).abs()
                / getattr(ref, f).abs()).max().item() <= 1e-9, f


def _shoot_fields_equal(a, b):
    """Every ``ShootOut`` field bit for bit (NaN where NaN)."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.is_floating_point():
            assert torch.equal(x.view(torch.int64), y.view(torch.int64)), f
        else:
            assert torch.equal(x, y), f


@pytest.mark.parametrize("which", ["reference", "batch_3"])
def test_bounce_tree_equals_the_serial_kernel_bitwise(which, cuda):
    """The tree kernel (derived depth, and depth 4) against the
    one-thread-per-lane kernel at full knobs: all eight fields bit for bit;
    critical-path steps <= the serial steps <= every node's steps."""
    from bdlz_tpu_torch.bounce import PotentialSpec, reference_potential
    from bdlz_tpu_torch.bounce.shooting import _params_row, make_knobs
    from bdlz_tpu_torch.ops import bounce_kernel as bk

    ref = reference_potential()
    specs = [ref] if which == "reference" else [
        ref._replace(eps=0.045), PotentialSpec(0.8, 1.1, 0.09, 1.3, 0.04), ref]
    params = torch.as_tensor(np.stack([_params_row(s) for s in specs]), device=cuda)
    knobs = make_knobs()
    serial = bk.bounce_shoot_serial(params, knobs)
    tree, stats = bk.bounce_shoot(params, knobs, stats=True)
    tree4 = bk.bounce_shoot(params, knobs, depth=4)
    torch.cuda.synchronize()
    _shoot_fields_equal(tree, serial)
    _shoot_fields_equal(tree4, serial)
    assert bool(tree.converged.all())
    plan = bk.tree_plan(len(specs), knobs.n_bisect, cuda)
    assert stats[:, 2].tolist() == [plan["depth"]] * len(specs)
    assert stats[:, 3].tolist() == [-(-knobs.n_bisect // plan["depth"])] * len(specs)
    assert bool((stats[:, 0] <= serial.steps).all() and (serial.steps <= stats[:, 1]).all())


def test_solve_bounce_launches_the_tree_kernel_once(cuda):
    from bdlz_tpu_torch.bounce import reference_potential, solve_bounce
    from bdlz_tpu_torch.ops import bounce_kernel as bk

    bk.reset_launches()
    sol = solve_bounce(reference_potential(), device=cuda)
    assert bk.LAUNCHES == {"shoot": 1, "shoot_serial": 0, "classify": 0}
    assert bool(sol.converged)


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


# ---- sweep robustness and the emulator on the card --------------------------

def test_sweep_resume_on_the_card_is_bitwise(cuda, tmp_path):
    """A K1 sweep into a directory, then its resume: every chunk read back,
    no K1 launch, the outputs bit for bit; a warm store run likewise."""
    from bdlz_tpu_torch.provenance import Store

    base = config_from_dict(ARCHIVED)
    static = static_choices_from_config(base)
    axes = {"m_chi_GeV": np.geomspace(0.1, 10.0, 16), "T_p_GeV": np.geomspace(30.0, 300.0, 4)}
    kw = dict(chunk_size=16, n_y=2000, impl="kernel", device=cuda)
    kk.reset_launches()
    first = run_sweep(base, axes, static, out_dir=str(tmp_path / "d"),
                      cache=Store(str(tmp_path / "s")), **kw)
    assert kk.LAUNCHES["point_reduce"] == 4 and first.cache_misses == 4
    kk.reset_launches()
    again = run_sweep(base, axes, static, out_dir=str(tmp_path / "d"), **kw)
    warm = run_sweep(base, axes, static, cache=Store(str(tmp_path / "s")), **kw)
    assert kk.LAUNCHES["point_reduce"] == 0
    assert again.resumed_chunks == 4 and warm.cache_hits == 4
    for f, v in first.outputs.items():
        assert np.array_equal(again.outputs[f], v) and np.array_equal(warm.outputs[f], v), f


def test_emulator_query_on_the_card_matches_the_cpu(cuda):
    """Values ≤1e-14 rel, domain and predicted error equal, on a smooth
    positive 3-D table (a power law with a mild wiggle, as a yield surface
    is) over non-uniform nodes.  The card's log10 of a query may differ
    from the CPU's by an ulp; its effect scales with the table's log-slope
    across a cell, which a random table would make arbitrarily large."""
    from bdlz_tpu_torch.emulator import (
        EmulatorArtifact,
        make_domain_fn,
        make_error_fn,
        make_query_fn,
    )

    rng = np.random.default_rng(5)
    nodes = (np.geomspace(0.1, 10.0, 7), np.sort(rng.uniform(30.0, 300.0, 9)),
             np.linspace(0.05, 0.95, 5))
    shape = tuple(len(n) for n in nodes)
    m, t, v = np.meshgrid(*nodes, indexing="ij")
    log_ratio = (0.75 + 0.3 * np.log10(m) - 1.2 * np.log10(t / 100.0) + 0.5 * v
                 + 0.01 * np.sin(7.0 * v) * np.log10(m))
    art = EmulatorArtifact(
        axis_names=("m_chi_GeV", "T_p_GeV", "v_w"), axis_nodes=nodes,
        axis_scales=("log", "log", "lin"),
        values={"DM_over_B": 10 ** log_ratio}, identity={},
        manifest={"converged": True},
        predicted_error=rng.uniform(0.0, 1e-4, tuple(n - 1 for n in shape)))
    th = np.stack([10 ** rng.uniform(-1.2, 1.2, 4096), rng.uniform(20.0, 320.0, 4096),
                   rng.uniform(0.0, 1.0, 4096)], axis=1)
    got = make_query_fn(art, device=cuda)(th)
    assert got.device.type == "cuda"
    ref = make_query_fn(art, device="cpu")(th).numpy()
    assert np.max(np.abs(got.cpu().numpy() / ref - 1.0)) <= 1e-14
    for fn in (make_domain_fn, make_error_fn):
        assert np.array_equal(fn(art, device=cuda)(th).cpu().numpy(),
                              fn(art, device="cpu")(th).numpy())


# ---- the sampling layer on the card -----------------------------------------

def _sampling_logp(device):
    from bdlz_tpu_torch.sampling import make_pipeline_logprob

    base = config_from_dict(ARCHIVED)
    bounds = {"m_chi_GeV": (0.05, 20.0), "P_chi_to_B": (1e-4, 1.0)}
    return make_pipeline_logprob(base, static_choices_from_config(base), make_f_table(base.I_p),
                                 param_keys=tuple(bounds), bounds=bounds, device=device)


def test_logp_and_gradient_on_the_card_match_the_cpu(cuda):
    """The Planck logp and its autograd gradient of 64 walkers on the card
    and on the CPU: ≤1e-12 rel (the trapezoid's row sums differ in order
    only)."""
    from bdlz_tpu_torch.sampling import make_logp_value_and_grad

    rng = np.random.default_rng(3)
    th = np.column_stack([rng.uniform(0.6, 1.6, 64), rng.uniform(0.1, 0.2, 64)])
    lp_c, g_c = make_logp_value_and_grad(_sampling_logp(cuda))(th)
    lp_h, g_h = make_logp_value_and_grad(_sampling_logp("cpu"))(th)
    assert lp_c.device.type == "cuda" and torch.isfinite(g_c).all()
    assert float(((lp_c.cpu() - lp_h).abs() / lp_h.abs()).max()) <= 1e-12
    assert float(((g_c.cpu() - g_h).abs() / g_h.abs()).max()) <= 1e-12


def test_stretch_chain_on_the_card_is_the_cpu_chain(cuda):
    """The same seed on the card and on the CPU: the draws come from one
    CPU generator, so the chains agree to ≤1e-10 with the same accepts."""
    from bdlz_tpu_torch.sampling import run_ensemble
    from bdlz_tpu_torch.sampling.ensemble import make_generator

    init = np.column_stack([np.linspace(0.8, 1.2, 16), np.linspace(0.12, 0.18, 16)])
    a = run_ensemble(_sampling_logp(cuda), init, 30, generator=make_generator(1))
    b = run_ensemble(_sampling_logp("cpu"), init, 30, generator=make_generator(1))
    assert int(a.final.n_accept) == int(b.final.n_accept)
    assert float((a.chain.cpu() - b.chain).abs().max()) <= 1e-10


# ---- the serving plane on the card ------------------------------------------

def test_yield_service_on_the_card_launches_k1_and_matches_the_cpu(cuda, tmp_path):
    """64 queries, 16 outside the box: the exact fallback of an artifact
    built with impl="kernel" runs K1 on the card; ≤1e-10 from the CPU."""
    from bdlz_tpu_torch.emulator import AxisSpec, build_emulator, load_artifact
    from bdlz_tpu_torch.serve import YieldService

    base = config_from_dict(ARCHIVED)
    spec = {"m_chi_GeV": AxisSpec(0.9, 1.1, 3, "log"), "T_p_GeV": AxisSpec(90.0, 110.0, 3, "log")}
    build_emulator(base, spec, rtol=1e-3, n_probe=4, n_holdout=8, max_rounds=2, n_y=2000,
                   impl="kernel", device=cuda, out_dir=str(tmp_path / "art"))
    art = load_artifact(str(tmp_path / "art"))
    assert art.identity["impl"] == "kernel"
    rng = np.random.default_rng(9)
    th = np.stack([rng.uniform(0.9, 1.1, 64), rng.uniform(90.0, 110.0, 64)], axis=1)
    th[::4, 0] = rng.uniform(1.2, 1.5, 16)
    on_card = YieldService(art, base, max_batch_size=64, device=cuda)
    assert on_card.exact_engine == "kernel"
    kk.reset_launches()
    got, n_fb = on_card.evaluate(th)
    assert n_fb >= 16 and kk.LAUNCHES["point_reduce"] >= 1
    ref, n_ref = YieldService(art, base, max_batch_size=64, device="cpu").evaluate(th)
    assert n_ref == n_fb
    assert np.max(np.abs(got / ref - 1.0)) <= 1e-10


# ---- the elastic sweep, tenancy and the fabric on the card ---------------------------

TIER_ARGS = {"reduce": (False, True), "stream": (False, False),
             "fused_reduce": (True, True), "fused_stream": (True, False)}
#: The kernel each tier launches.
TIER_KERNEL = TIER_WRAPPER


@pytest.mark.parametrize("tier", sorted(TIER_ARGS))
def test_an_elastic_kernel_sweep_is_bitwise_run_sweep(tier, cuda, tmp_path):
    """Three in-process workers over 4 chunks launch the tier's kernel once
    per chunk and fold the serial sweep's bits."""
    from bdlz_tpu_torch.parallel import run_sweep_elastic

    base = config_from_dict(ARCHIVED)
    static = static_choices_from_config(base)
    fuse_exp, reduce = TIER_ARGS[tier]
    axes = {"m_chi_GeV": np.geomspace(0.1, 10.0, 16), "T_p_GeV": np.geomspace(30.0, 300.0, 8)}
    kw = dict(impl="kernel", fuse_exp=fuse_exp, reduce=reduce, chunk_size=32, n_y=N_Y,
              device=cuda)
    ref = run_sweep(base, axes, static, **kw)
    kk.reset_launches()
    res = run_sweep_elastic(base, axes, static, store=str(tmp_path / "s"), n_workers=3, **kw)
    assert kk.LAUNCHES[TIER_KERNEL[tier]] == 4
    for f in ref.outputs:
        assert res.outputs[f].tobytes() == ref.outputs[f].tobytes(), f


def _kernel_artifact(tmp_path, cuda):
    from bdlz_tpu_torch.emulator import AxisSpec, build_emulator
    from bdlz_tpu_torch.provenance import Store, publish_artifact

    base = config_from_dict(ARCHIVED)
    spec = {"m_chi_GeV": AxisSpec(0.9, 1.1, 3, "log"), "T_p_GeV": AxisSpec(90.0, 110.0, 3, "log")}
    art, _ = build_emulator(base, spec, rtol=1e-3, n_probe=4, n_holdout=8, max_rounds=2,
                            n_y=2000, impl="kernel", device=cuda)
    store = Store(str(tmp_path / "store"))
    return base, art, store, publish_artifact(store, art)


def test_an_evicted_pool_answers_through_k1_on_the_card(cuda, tmp_path):
    from bdlz_tpu_torch.emulator import make_exact_evaluator
    from bdlz_tpu_torch.serve import MultiTenantService

    base, art, store, h = _kernel_artifact(tmp_path, cuda)
    clock = [0.0]
    svc = MultiTenantService(base, tenant_map={"a": h}, store=store, max_batch_size=8,
                             clock=lambda: clock[0], fault_plan='{"faults": [{"site": '
                             '"pool_evict", "kind": "raise", "key": 0}]}')
    th = np.stack([np.linspace(0.92, 1.08, 8), np.linspace(92.0, 108.0, 8)], axis=1)
    try:
        for t in th:
            svc.submit(t, scenario="a")
        svc.drain()
        svc.run_once()
        assert svc.pool("a").evicted
        kk.reset_launches()
        futs = [svc.submit(t, scenario="a") for t in th]
        svc.drain()
        got = np.array([f.result(timeout=0).value for f in futs])
        assert kk.LAUNCHES["point_reduce"] >= 1
        assert all(f.result(timeout=0).fallback_reason == "pool_evicted" for f in futs)
    finally:
        svc.close()
    static = static_choices_from_config(base)._replace(quad_panel_gl=False)
    ref = make_exact_evaluator(base, static, n_y=2000, impl="tabulated", chunk_size=8,
                               device="cpu")({"m_chi_GeV": th[:, 0], "T_p_GeV": th[:, 1]})
    assert np.max(np.abs(got / ref["DM_over_B"] - 1.0)) <= 1e-10


def test_a_partitioned_host_answers_through_k1_on_the_card(cuda, tmp_path):
    from bdlz_tpu_torch.serve import FabricHost

    base, art, store, h = _kernel_artifact(tmp_path, cuda)
    clock = [0.0]
    plan = '{"faults": [{"site": "store_partition", "kind": "raise", "chunk": 1}, ' \
           '{"site": "store_partition", "kind": "raise", "chunk": 2}]}'
    host = FabricHost(base, fabric="f", host_id="h0", host_index=0, store=store,
                      tenant_map={"a": h}, clock=lambda: clock[0], fault_plan=plan,
                      partition_retries=2, max_batch_size=8)
    try:
        host.register()
        host.submit([1.0, 100.0], scenario="a")
        host.drain()
        assert not host.heartbeat() and host.partitioned
        kk.reset_launches()
        r = host.submit([1.01, 101.0], scenario="a").result(timeout=0)
        assert r.degraded and r.fallback_reason == "store_partition"
        assert kk.LAUNCHES["point_reduce"] >= 1 and np.isfinite(r.value)
    finally:
        host.close()


def test_a_two_member_mesh_on_one_card_is_k1_bitwise_twice_per_chunk(setup, cuda):
    """``[cuda:0, cuda:0]``: each member launches K1 on its own stream over
    its half of every chunk; the sweep is bitwise the run without a mesh."""
    from bdlz_tpu_torch.parallel import make_mesh

    base, _, _ = setup
    static = static_choices_from_config(base)._replace(quad_panel_gl=False)
    axes = {"m_chi_GeV": np.geomspace(0.1, 10.0, 8),
            "T_p_GeV": np.geomspace(30.0, 300.0, 4)}
    plain = run_sweep(base, axes, static, chunk_size=16, n_y=2000, impl="kernel", device=cuda)
    kk.reset_launches()
    meshed = run_sweep(base, axes, static, chunk_size=16, n_y=2000, impl="kernel",
                       mesh=make_mesh((2, 1), devices=[cuda, cuda]))
    assert kk.LAUNCHES["point_reduce"] == 2 * meshed.chunks == 4
    np.testing.assert_array_equal(meshed.outputs["DM_over_B"], plain.outputs["DM_over_B"])


def test_sp_quadrature_on_the_card_matches_the_cpu(cuda):
    """One point's 65536-node y-grid over two members of one card: within
    1e-12 rel of the same quadrature on two host members."""
    from bdlz_tpu_torch.config import point_params_from_config
    from bdlz_tpu_torch.parallel import make_mesh
    from bdlz_tpu_torch.parallel.gridshard import make_sp_quadrature

    base = config_from_dict(ARCHIVED)
    static = static_choices_from_config(base)
    pp, table = point_params_from_config(base, base.P_chi_to_B), make_f_table(base.I_p)
    got = make_sp_quadrature(static, make_mesh((1, 2), devices=[cuda, cuda]), n_y=65536)(
        pp, table)
    ref = make_sp_quadrature(static, make_mesh((1, 2), devices=["cpu", "cpu"]), n_y=65536)(
        pp, table)
    assert got.device.type == "cuda"
    assert abs(float(got) / float(ref) - 1.0) <= 1e-12


def test_the_overlapped_k1_sweep_is_bitwise_the_serial_one_on_the_card(cuda):
    """The double-buffered loop (pinned staging, one chunk in flight, one
    event per chunk) against the serial loop on the main grid's axes at a
    reduced size: 4096 points in 4 chunks, K1 once per chunk on each."""
    base = config_from_dict(ARCHIVED)
    static = static_choices_from_config(base)
    axes = {"m_chi_GeV": np.geomspace(0.1, 10.0, 64), "T_p_GeV": np.geomspace(30.0, 300.0, 32),
            "v_w": np.linspace(0.05, 0.95, 2)}
    kw = dict(chunk_size=1024, n_y=N_Y, impl="kernel", device=cuda)
    runs = []
    for overlap in (True, False, True):
        kk.reset_launches()
        runs.append(run_sweep(base, axes, static, overlap_chunks=overlap, **kw))
        assert kk.LAUNCHES == {k: (4 if k == "point_reduce" else 0) for k in kk.LAUNCHES}
    assert runs[0].n_failed == 0 and runs[0].chunks == 4
    for f, v in runs[1].outputs.items():
        assert runs[0].outputs[f].tobytes() == v.tobytes() == runs[2].outputs[f].tobytes(), f


@pytest.mark.parametrize("tier", sorted(TIER_ARGS))
def test_make_chunk_runner_launches_exactly_its_tier_s_kernel(tier, setup, cuda):
    """One launch of the tier's kernel per chunk and none of the others;
    the tiered gate through the runner does the same over its population."""
    from bdlz_tpu_torch.parallel.sweep import make_chunk_runner
    from bdlz_tpu_torch.validation import engine_population_max_rel

    base, table, _ = setup
    static = static_choices_from_config(base)
    fuse_exp, reduce = TIER_ARGS[tier]
    grid = build_grid(base, {"m_chi_GeV": np.geomspace(0.1, 10.0, 48)})
    kk.reset_launches()
    run, chunk = make_chunk_runner(grid, 16, static, table, impl="kernel", n_y=N_Y,
                                   fuse_exp=fuse_exp, reduce=reduce, device=cuda)
    got = np.concatenate([run(lo, lo + chunk) for lo in range(0, 48, chunk)])
    assert chunk == 16 and got.shape == (48,) and np.isfinite(got).all()
    assert kk.LAUNCHES == {k: (3 if k == TIER_KERNEL[tier] else 0) for k in kk.LAUNCHES}
    ref_run, _ = make_chunk_runner(grid, 48, static, table, impl="tabulated", n_y=N_Y,
                                   device=cuda)
    ref = ref_run(0, 48)
    kk.reset_launches()
    gate = engine_population_max_rel(grid, ref, static, table, impl="kernel", n_y=N_Y,
                                     fuse_exp=fuse_exp, reduce=reduce, device=cuda)
    assert kk.LAUNCHES == {k: (1 if k == TIER_KERNEL[tier] else 0) for k in kk.LAUNCHES}
    assert gate <= 1e-10


# ---- the kernel engine's chunk step as one CUDA graph -----------------------

#: 50 points: 4 chunks of 16, the last padded from 2 valid points.
GRAPH_AXES = {"m_chi_GeV": np.geomspace(0.1, 10.0, 10), "T_p_GeV": np.geomspace(30.0, 300.0, 5)}


def _graph_sweep(base, tier, cuda, axes=GRAPH_AXES, chunk_size=16, **kw):
    fuse_exp, reduce = TIER_ARGS[tier]
    return run_sweep(base, axes, static_choices_from_config(base), chunk_size=chunk_size,
                     n_y=N_Y, impl="kernel", fuse_exp=fuse_exp, reduce=reduce,
                     device=cuda, **kw)


def _eager_only(monkeypatch):
    """The kernel step without its graph: the eager chain of launches."""
    monkeypatch.setattr(kk, "graph_route", lambda *a, **k: False)


def _fresh():
    kk.clear_graphs()
    kk.reset_graph_stats()
    kk.reset_launches()


@pytest.mark.parametrize("tier", sorted(TIER_ARGS))
def test_the_graphed_sweep_is_bitwise_the_eager_one(tier, cuda, monkeypatch):
    """The key's first chunk eager, then one capture and one replay a
    chunk, the padded last chunk included; one launch of the tier's
    kernel a chunk on either route, and the outputs bit for bit."""
    base = config_from_dict(ARCHIVED)
    want_launches = {k: (4 if k == TIER_KERNEL[tier] else 0) for k in kk.LAUNCHES}
    _fresh()
    graphed = _graph_sweep(base, tier, cuda)
    assert graphed.chunks == 4 and graphed.n_failed == 0
    assert kk.GRAPH_STATS == {"captures": 1, "replays": 3, "eager": 1}
    assert kk.LAUNCHES == want_launches
    _eager_only(monkeypatch)
    _fresh()
    eager = _graph_sweep(base, tier, cuda)
    assert kk.GRAPH_STATS == {"captures": 0, "replays": 0, "eager": 4}
    assert kk.LAUNCHES == want_launches
    for f, v in eager.outputs.items():
        assert graphed.outputs[f].tobytes() == v.tobytes(), f


def test_a_graph_reloads_a_new_table_and_another_I_p_captures_anew(cuda, monkeypatch):
    """Sweeps with fresh table tensors of one I_p replay one graph; a table
    of the same scalars but other values, or one written in place, is
    copied in before the replay; another I_p captures a second graph.
    Each run equals the eager step on the same table, bit for bit."""
    import dataclasses

    from bdlz_tpu_torch.parallel.sweep import make_chunk_runner

    base = config_from_dict(ARCHIVED)
    static = static_choices_from_config(base)
    _fresh()
    a, b = _graph_sweep(base, "reduce", cuda), _graph_sweep(base, "reduce", cuda)
    assert kk.GRAPH_STATS == {"captures": 1, "replays": 7, "eager": 1}
    for f, v in a.outputs.items():
        assert b.outputs[f].tobytes() == v.tobytes(), f
    other = dataclasses.replace(base, I_p=0.5)
    c = _graph_sweep(other, "reduce", cuda)
    assert kk.GRAPH_STATS == {"captures": 2, "replays": 10, "eager": 2}

    grid = build_grid(base, GRAPH_AXES)
    table = table_to_device(make_f_table(base.I_p), cuda)
    doubled = table._replace(values=table.values * 2.0)

    def chunks(tab):
        run, chunk = make_chunk_runner(grid, 16, static, tab, impl="kernel", n_y=N_Y,
                                       device=cuda)
        return np.concatenate([run(lo, lo + chunk) for lo in range(0, 48, chunk)])

    _fresh()
    got = [chunks(table), chunks(doubled)]
    doubled.values.mul_(2.0)
    got.append(chunks(doubled))
    assert kk.GRAPH_STATS == {"captures": 1, "replays": 8, "eager": 1}
    _eager_only(monkeypatch)
    doubled.values.mul_(0.5)
    want = [chunks(table), chunks(doubled)]
    doubled.values.mul_(2.0)
    want.append(chunks(doubled))
    c_eager = _graph_sweep(other, "reduce", cuda)
    assert kk.GRAPH_STATS["eager"] == 1 + 9 + 4
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    assert not np.array_equal(got[0], got[1])
    assert c.outputs["DM_over_B"].tobytes() == c_eager.outputs["DM_over_B"].tobytes()


def test_the_double_buffered_graphed_sweep_equals_chunk_by_chunk_eager_runs(cuda, monkeypatch):
    """3,584 points in 4 chunks of 1,024 (the last padded), one chunk in
    flight while the next is shipped and replayed into the same buffers:
    every chunk's rows are its own eager run's, bit for bit."""
    from bdlz_tpu_torch.parallel.sweep import make_chunk_runner

    base = config_from_dict(ARCHIVED)
    axes = {"m_chi_GeV": np.geomspace(0.1, 10.0, 64), "T_p_GeV": np.geomspace(30.0, 300.0, 56)}
    _fresh()
    res = _graph_sweep(base, "reduce", cuda, axes=axes, chunk_size=1024, overlap_chunks=True)
    assert res.chunks == 4 and res.n_failed == 0
    assert kk.GRAPH_STATS == {"captures": 1, "replays": 3, "eager": 1}
    assert kk.LAUNCHES["point_reduce"] == 4
    _eager_only(monkeypatch)
    grid = build_grid(base, axes)
    table = table_to_device(make_f_table(base.I_p), cuda)
    run, chunk = make_chunk_runner(grid, 1024, static_choices_from_config(base), table,
                                   impl="kernel", n_y=N_Y, device=cuda)
    want = np.concatenate([run(lo, min(lo + chunk, 3584))[:min(chunk, 3584 - lo)]
                           for lo in range(0, 3584, chunk)])
    assert res.outputs["DM_over_B"].tobytes() == want.tobytes()


def test_a_profiled_graphed_sweep_names_each_replay_and_shows_its_kernels(cuda):
    """Under ``torch.profiler`` each replayed chunk is one ``chunk.replay``
    span inside its ``chunk.step``, and the point kernel of the eager
    chunk and of each replay is a device event of the trace; a capture
    under the profiler works too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    base = config_from_dict(ARCHIVED)
    _fresh()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        first = _graph_sweep(base, "reduce", cuda)
        again = _graph_sweep(base, "reduce", cuda)
        torch.cuda.synchronize()
    assert kk.GRAPH_STATS == {"captures": 1, "replays": 7, "eager": 1}
    events = list(prof.profiler.kineto_results.events())
    host = [(e.name(), e.start_ns(), e.end_ns()) for e in events
            if e.device_type() != DeviceType.CUDA]
    replays = [h for h in host if h[0] == "chunk.replay"]
    steps = [h for h in host if h[0] == "chunk.step"]
    assert len(replays) == 7 and len(steps) == 8
    assert all(any(s[1] <= r[1] and r[2] <= s[2] for s in steps) for r in replays)
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation() and "kjma_point_kernel" in e.name()]
    assert len(kernels) == 8
    assert first.outputs["DM_over_B"].tobytes() == again.outputs["DM_over_B"].tobytes()


def test_a_graph_captures_on_a_stream_of_its_own_device(cuda, monkeypatch):
    """Each capture is given a stream of the graph's device, never torch's
    shared capture stream (made on the device of the process's first
    capture), and records one launch of its tier's kernel."""
    streams = []
    graph = torch.cuda.graph

    def recording(cuda_graph, *args, stream=None, **kw):
        streams.append(stream)
        return graph(cuda_graph, *args, stream=stream, **kw)

    monkeypatch.setattr(torch.cuda, "graph", recording)
    _fresh()
    _graph_sweep(config_from_dict(ARCHIVED), "fused_stream", cuda)
    assert len(streams) == 1 and streams[0] is not None
    assert streams[0].device == cuda
    assert kk.LAUNCHES == {k: (4 if k == "point_fused_stream" else 0) for k in kk.LAUNCHES}


@pytest.fixture(scope="module")
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return cuda, torch.device("cuda", 1)


def test_a_graph_on_the_second_card_is_bitwise_its_eager_sweep(two_cards, monkeypatch):
    """A capture on cuda:0, then one on cuda:1 with cuda:0 current: the
    second card's graph holds its own kernel launch, and its sweep equals
    the eager sweep on that card bit for bit."""
    first, second = two_cards
    base = config_from_dict(ARCHIVED)
    _fresh()
    _graph_sweep(base, "reduce", first)
    assert torch.cuda.current_device() == 0
    graphed = _graph_sweep(base, "reduce", second)
    assert kk.GRAPH_STATS == {"captures": 2, "replays": 6, "eager": 2}
    assert kk.LAUNCHES["point_reduce"] == 8
    _eager_only(monkeypatch)
    eager = _graph_sweep(base, "reduce", second)
    for f, v in eager.outputs.items():
        assert graphed.outputs[f].tobytes() == v.tobytes(), f
