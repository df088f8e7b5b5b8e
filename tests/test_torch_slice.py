"""The port's sweep main path end to end on the CPU: the golden point, the
sweep engine against the JAX sweep engine, chunking, the CLI summary,
and the refusals of what is not ported yet.

Tolerances: the golden point ≤1e-10 rel on the direct path (the archived
values come from the NumPy reference at full precision) and ≤1e-9 on the
kernel path (the tabulated F adds its interpolation error, ≲1e-11);
port sweep vs JAX tabulated sweep ≤1e-10 (both f64).
"""
import dataclasses
import json

import numpy as np
import pytest

from bdlz_tpu.config import config_from_dict as j_config_from_dict
from bdlz_tpu.config import static_choices_from_config as j_static
from bdlz_tpu.parallel.sweep import run_sweep as j_run_sweep

from bdlz_tpu_torch.config import (
    config_from_dict,
    point_params_from_config,
    static_choices_from_config,
)
from bdlz_tpu_torch.interop import point_params_from_numpy
from bdlz_tpu_torch.models.yields_pipeline import point_yields
from bdlz_tpu_torch.ops import kjma_kernel as kk
from bdlz_tpu_torch.ops.kjma_table import make_f_table, table_to_device
from bdlz_tpu_torch.parallel.sweep import run_sweep
from bdlz_tpu_torch.physics.percolation import make_kjma_grid

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
GOLDEN_Y_B = 8.720885362714675e-11
GOLDEN_RATIO = 5.688926334903014
AXES = {
    "m_chi_GeV": np.geomspace(0.1, 600.0, 5),
    "T_p_GeV": np.geomspace(30.0, 300.0, 3),
    "v_w": np.linspace(0.05, 0.95, 2),
}


@pytest.fixture(scope="module")
def base():
    return config_from_dict(ARCHIVED)


@pytest.mark.parametrize("path,tol", [("direct", 1e-10), ("kernel", 1e-9)])
def test_golden_point(base, path, tol):
    pp = point_params_from_numpy(point_params_from_config(base, base.P_chi_to_B), "cpu")
    static = static_choices_from_config(base)
    if path == "direct":
        res = point_yields(pp, static, make_kjma_grid("cpu"))
    else:
        table = table_to_device(make_f_table(base.I_p), "cpu")
        res = kk.point_yields_kernel(pp, static, table, n_y=8000)
    assert abs(res.Y_B.item() / GOLDEN_Y_B - 1.0) <= tol
    assert abs(res.DM_over_B.item() / GOLDEN_RATIO - 1.0) <= tol


@pytest.fixture(scope="module")
def jax_sweep(jit_warmup):
    cfg = j_config_from_dict(ARCHIVED)
    static = j_static(cfg)._replace(quad_panel_gl=False)  # the trapezoid
    kw = dict(chunk_size=16, n_y=2000, impl="tabulated")
    jit_warmup(j_run_sweep, cfg, AXES, static, **kw)
    return j_run_sweep(cfg, AXES, static, **kw)


@pytest.mark.parametrize("fuse_exp,reduce", [(False, True), (True, True), (False, False),
                                             (True, False)])
def test_kernel_sweep_matches_jax_tabulated_sweep(base, jax_sweep, fuse_exp, reduce):
    res = run_sweep(base, AXES, static_choices_from_config(base), chunk_size=16,
                    n_y=2000, impl="kernel", fuse_exp=fuse_exp, reduce=reduce,
                    device="cpu")
    assert res.n_points == jax_sweep.n_points == 30 and res.chunks == 2
    assert res.n_failed == 0 and not res.failed_mask.any()
    assert (res.quad_impl, res.n_quad_nodes) == (jax_sweep.quad_impl, jax_sweep.n_quad_nodes)
    for f, ref in jax_sweep.outputs.items():
        got = res.outputs[f]
        assert np.max(np.abs(got - ref) / np.abs(ref)) <= 1e-10, f


def test_tabulated_sweep_matches_kernel_sweep(base):
    static = static_choices_from_config(base)
    kw = dict(chunk_size=16, n_y=2000, device="cpu")
    a = run_sweep(base, AXES, static, impl="tabulated", **kw).outputs["DM_over_B"]
    b = run_sweep(base, AXES, static, impl="kernel", **kw).outputs["DM_over_B"]
    assert np.max(np.abs(a - b) / np.abs(b)) <= 1e-10


def test_chunk_size_does_not_change_bits(base):
    static = static_choices_from_config(base)
    kw = dict(n_y=2000, device="cpu")
    a = run_sweep(base, AXES, static, chunk_size=7, **kw)
    b = run_sweep(base, AXES, static, chunk_size=64, **kw)
    assert (a.chunks, b.chunks) == (5, 1)
    for f in a.outputs:
        assert np.array_equal(a.outputs[f], b.outputs[f]), f


def test_failed_points_are_masked_not_fatal(base):
    res = run_sweep(base, {"m_chi_GeV": [0.95, 1e300, 2.0]},
                    static_choices_from_config(base), n_y=2000, device="cpu")
    assert res.n_failed == 1 and res.failed_mask.tolist() == [False, True, False]


def test_sweep_cli_summary_has_the_jax_cli_keys(base, tmp_path, capsys):
    from bdlz_tpu.sweep_cli import main as j_main

    from bdlz_tpu_torch.sweep_cli import main as t_main

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(dataclasses.asdict(base)))
    args = ["--config", str(cfg), "--axis", "m_chi_GeV=geom:0.5:2:3",
            "--axis", "v_w=0.2,0.4", "--chunk", "8", "--n-y", "2000"]
    j_main(args)
    j_out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    t_main(args + ["--device", "cpu"])
    t_out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(t_out) == list(j_out)
    assert t_out["n_points"] == 6 and t_out["n_failed"] == 0
    assert t_out["closest_to_planck"]["params"] == pytest.approx(
        j_out["closest_to_planck"]["params"])


@pytest.mark.parametrize("change,axes", [
    ({"sigma_v_chi_GeV_m2": 1e-30}, {"m_chi_GeV": [1.0]}),
    ({}, {"Gamma_wash_over_H": [0.0, 1.0]}),
    ({}, {"I_p": [0.3, 0.4]}),
    ({"quad_panel_gl": True}, {"m_chi_GeV": [1.0]}),
])
def test_unported_paths_refuse_loudly(base, change, axes):
    cfg = dataclasses.replace(base, **change)
    with pytest.raises(NotImplementedError):
        run_sweep(cfg, axes, static_choices_from_config(cfg), n_y=2000, device="cpu")


def test_unknown_engine_and_fuse_exp_on_tabulated_rejected(base):
    static = static_choices_from_config(base)
    with pytest.raises(ValueError):
        run_sweep(base, {"m_chi_GeV": [1.0]}, static, impl="pallas", device="cpu")
    with pytest.raises(ValueError):
        run_sweep(base, {"m_chi_GeV": [1.0]}, static, impl="tabulated",
                  fuse_exp=True, device="cpu")
