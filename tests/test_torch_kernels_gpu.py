"""The port's CUDA kernels against their plain PyTorch versions, on the card.

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
    static = static_choices_from_config(base)
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
