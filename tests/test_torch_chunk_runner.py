"""The engine surface of the measurement tools, on the CPU, against the JAX
package: ``parallel.sweep.make_chunk_runner``, the tiered
``validation.engine_population_max_rel``, the
``solvers.quadrature.integrand_stream_probe`` and the provenance bench
identities (``bench_leg_identity``, ``package_source_fingerprint``).

Tolerances, with their reasons:
* the returned chunk is equal; ``DM_over_B`` ≤1e-13 rel for ``tabulated``
  (the same f64 program);
* each kernel tier's plain version (the port's ``impl="kernel"``) ≤1e-10
  rel from JAX's tabulated runner (the closed-form prefactors and the
  summation order differ) and ≤1e-6 from JAX's ``"pallas"`` runner in
  interpret mode (its streams are f32);
* gate values within the same tolerances of JAX's gate on one reference;
* the probe's stages ≤1e-13 rel from JAX's probe with ``xp=numpy``;
* the bench-leg digest byte-equal to JAX's.

``pytest -s`` prints ``RESIDUAL`` lines.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from bdlz_tpu import config as jc
from bdlz_tpu import validation as jv
from bdlz_tpu.ops.kjma_table import make_f_table as j_make_f_table
from bdlz_tpu.parallel import sweep as js

from bdlz_tpu_torch import config as tc
from bdlz_tpu_torch import validation as tv
from bdlz_tpu_torch.ops import kjma_kernel as kk
from bdlz_tpu_torch.ops.kjma_table import make_f_table, table_to_device
from bdlz_tpu_torch.parallel import make_mesh
from bdlz_tpu_torch.parallel import sweep as ts

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
N_POP, N_Y, TABLE_N = 8, 2000, 16384
TAB_RTOL, KERNEL_VS_TAB_RTOL, KERNEL_VS_PALLAS_RTOL, PROBE_RTOL = 1e-13, 1e-10, 1e-6, 1e-13
# (fuse_exp, reduce) of the four kernel tiers (P1-P4)
TIERS = {"reduce": (False, True), "stream": (False, False),
         "fused_reduce": (True, True), "fused_stream": (True, False)}


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    return float(np.max(np.abs(got / ref - 1.0)))


@pytest.fixture(scope="module")
def env():
    jb, tb = jc.config_from_dict(ARCHIVED), tc.config_from_dict(ARCHIVED)
    j_static = jc.static_choices_from_config(jb)._replace(quad_panel_gl=False)
    t_static = tc.static_choices_from_config(tb)._replace(quad_panel_gl=False)
    jpop = jv.build_audit_population(jb, N_POP)
    tpop = tv.build_audit_population(tb, N_POP)
    for a, b in zip(jpop.grid, tpop.grid):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    import jax.numpy as jnp

    return dict(jb=jb, tb=tb, js=j_static, ts=t_static, grid=tpop.grid, jgrid=jpop.grid,
                jtable=j_make_f_table(jb.I_p, jnp, n=TABLE_N),
                ttable=make_f_table(tb.I_p, n=TABLE_N),
                ref=tv.reference_ratios(tpop.grid, t_static, n_y=N_Y))


def _jax_runner(env, impl, fuse_exp=False, reduce=None):
    run, chunk = js.make_chunk_runner(env["jgrid"], N_POP, env["js"], None, None,
                                      env["jtable"], impl=impl, n_y=N_Y,
                                      fuse_exp=fuse_exp, reduce=reduce)
    return np.asarray(run(0, N_POP)), chunk


@pytest.fixture(scope="module")
def jax_tabulated(env):
    return _jax_runner(env, "tabulated")


def test_tabulated_runner_matches_jax(env, jax_tabulated):
    ref, j_chunk = jax_tabulated
    run, chunk = ts.make_chunk_runner(env["grid"], N_POP, env["ts"], env["ttable"],
                                      impl="tabulated", n_y=N_Y, device="cpu")
    got = run(0, N_POP)
    assert chunk == j_chunk == N_POP
    assert isinstance(got, np.ndarray) and got.shape == (N_POP,)
    rel = _rel(got, ref)
    print(f"RESIDUAL make_chunk_runner tabulated vs JAX: {rel:.3e}")
    assert rel <= TAB_RTOL
    # a part chunk comes back padded with its last point
    part = run(0, 5)
    assert part.shape == (N_POP,) and np.all(part[5:] == part[4])
    assert part[:5].tobytes() == got[:5].tobytes()


@pytest.mark.parametrize("tier", list(TIERS))
def test_kernel_tier_runner_matches_jax_tabulated_and_pallas(env, jax_tabulated, tier):
    fuse_exp, reduce = TIERS[tier]
    kk.reset_launches()
    run, chunk = ts.make_chunk_runner(env["grid"], N_POP, env["ts"], env["ttable"],
                                      impl="kernel", n_y=N_Y, fuse_exp=fuse_exp,
                                      reduce=reduce, device="cpu")
    got = run(0, N_POP)
    assert kk.LAUNCHES == dict.fromkeys(kk.LAUNCHES, 0)   # CPU: plain versions
    pallas, j_chunk = _jax_runner(env, "pallas", fuse_exp, reduce)
    assert chunk == j_chunk
    r_tab, r_pallas = _rel(got, jax_tabulated[0]), _rel(got, pallas)
    print(f"RESIDUAL make_chunk_runner {tier} vs JAX tabulated {r_tab:.3e}, "
          f"vs JAX pallas (interpret) {r_pallas:.3e}")
    assert r_tab <= KERNEL_VS_TAB_RTOL
    assert r_pallas <= KERNEL_VS_PALLAS_RTOL


def test_the_runner_on_a_mesh_is_the_runner_without_one(env):
    base, _ = ts.make_chunk_runner(env["grid"], N_POP, env["ts"], env["ttable"],
                                   impl="kernel", n_y=N_Y, device="cpu")
    for shape in ((2, 1), (1, 2)):
        mesh = make_mesh(shape, devices=["cpu"] * 2)
        run, chunk = ts.make_chunk_runner(env["grid"], 7, env["ts"], env["ttable"],
                                          impl="kernel", n_y=N_Y, mesh=mesh)
        assert chunk == 8        # rounded up to a multiple of the members
        assert run(0, N_POP).tobytes() == base(0, N_POP).tobytes()


@pytest.mark.parametrize("impl,tier", [("tabulated", None)] + [("kernel", t) for t in TIERS])
def test_the_gate_of_each_tier_agrees_with_jax(env, impl, tier):
    fuse_exp, reduce = TIERS.get(tier, (False, True))
    got = tv.engine_population_max_rel(
        env["grid"], env["ref"], env["ts"], table_to_device(env["ttable"], "cpu"),
        impl=impl, n_y=N_Y, fuse_exp=fuse_exp, reduce=reduce, device="cpu")
    j_tab = jv.engine_population_max_rel(env["jgrid"], env["ref"], env["js"], None, None,
                                         env["jtable"], impl="tabulated", n_y=N_Y)
    print(f"RESIDUAL gate {impl}/{tier}: port {got:.6e}, JAX tabulated {j_tab:.6e}")
    assert 0.0 <= got <= 1e-6
    if impl == "tabulated":
        assert abs(got - j_tab) <= TAB_RTOL
        return
    j_pallas = jv.engine_population_max_rel(env["jgrid"], env["ref"], env["js"], None, None,
                                            env["jtable"], impl="pallas", n_y=N_Y,
                                            fuse_exp=fuse_exp, reduce=reduce)
    print(f"RESIDUAL gate {tier}: JAX pallas (interpret) {j_pallas:.6e}")
    assert abs(got - j_tab) <= KERNEL_VS_TAB_RTOL
    assert abs(got - j_pallas) <= KERNEL_VS_PALLAS_RTOL


def test_the_default_gate_is_unchanged(env):
    """The default tier (K1's plain version) scores what a direct run of
    the sweep step over the whole population scores."""
    from bdlz_tpu_torch.interop import point_params_from_numpy

    table = table_to_device(env["ttable"], "cpu")
    gate = tv.engine_population_max_rel(env["grid"], env["ref"], env["ts"], table,
                                        impl="kernel", n_y=N_Y, device="cpu")
    step = ts.make_sweep_step(env["ts"], N_Y, "kernel")
    direct = step(point_params_from_numpy(env["grid"], "cpu"), table).DM_over_B.numpy()
    assert gate == tv.population_max_rel(lambda lo, hi: direct[lo:hi], N_POP, env["ref"])


def test_integrand_stream_probe_matches_jax_numpy(env):
    from bdlz_tpu.config import point_params_from_config as j_pp
    from bdlz_tpu.solvers.quadrature import integrand_stream_probe as j_probe

    from bdlz_tpu_torch.solvers.quadrature import (
        integrand_stream_probe,
        integrate_YB_quadrature_tabulated,
    )

    table_np = j_make_f_table(env["jb"].I_p, np, n=4096)
    ref = j_probe(j_pp(env["jb"], env["jb"].P_chi_to_B), env["js"], table_np, np, n_y=N_Y)
    pp = tc.point_params_from_config(env["tb"], env["tb"].P_chi_to_B)
    got = integrand_stream_probe(pp, env["ts"], make_f_table(env["tb"].I_p, n=4096),
                                 n_y=N_Y, device="cpu")
    assert set(got) == set(ref)
    worst = 0.0
    for k, v in got.items():
        assert v.dtype == torch.float64 and v.device.type == "cpu"
        r = np.asarray(ref[k], dtype=np.float64)
        g = v[0].numpy()
        assert g.shape == r.shape
        nz = r != 0.0
        assert np.all(g[~nz] == 0.0)
        worst = max(worst, _rel(g[nz], r[nz]))
    print(f"RESIDUAL integrand_stream_probe vs JAX (numpy): {worst:.3e}")
    assert worst <= PROBE_RTOL
    # the probe's sum is the fast path's Y_B
    from bdlz_tpu_torch.interop import point_params_from_numpy

    yb = integrate_YB_quadrature_tabulated(
        point_params_from_numpy(pp, "cpu"), env["ts"].chi_stats,
        table_to_device(make_f_table(env["tb"].I_p, n=4096), "cpu"), n_y=N_Y)
    assert got["trapezoid_YB"].numpy().tobytes() == yb.numpy().tobytes()


@pytest.mark.parametrize("leg,context", [
    ("sweep_kernel", {"platform": "gpu", "n_devices": 1, "env": {"BDLZ_BENCH_NY": "8000"},
                      "fingerprint": "0123456789abcdef"}),
    ("emulator", {"platform": "cpu", "n_devices": 8, "env": {}}),
])
def test_bench_leg_identity_digest_equals_jax(leg, context):
    from bdlz_tpu.provenance import bench_leg_identity as j_identity

    from bdlz_tpu_torch.provenance import bench_leg_identity

    got, ref = bench_leg_identity(leg, context), j_identity(leg, context)
    assert got.kind == ref.kind == "bench_leg"
    assert got.digest(24) == ref.digest(24) and got.digest() == ref.digest()


def test_package_source_fingerprint_keys_every_py_and_cu(tmp_path, monkeypatch):
    import bdlz_tpu_torch
    from bdlz_tpu_torch.provenance import package_source_fingerprint

    first = package_source_fingerprint()
    assert first == package_source_fingerprint() and len(first) == 16
    src = os.path.dirname(os.path.abspath(bdlz_tpu_torch.__file__))
    copy = tmp_path / "bdlz_tpu_torch"
    shutil.copytree(src, copy, ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(bdlz_tpu_torch, "__file__", str(copy / "__init__.py"))
    assert package_source_fingerprint() == first       # the same bytes, the same key
    extra = tmp_path / "extra.txt"
    extra.write_text("x")
    with_extra = package_source_fingerprint(str(extra))
    assert with_extra != first
    assert package_source_fingerprint(str(tmp_path / "missing.txt")) == first
    keys = {first, with_extra}
    for rel in ("csrc/kjma_point.cu", "parallel/sweep.py"):
        with open(copy / rel, "a") as f:
            f.write("\n")
        now = package_source_fingerprint()
        assert now not in keys
        keys.add(now)
    (copy / "notes.txt").write_text("not source")
    assert package_source_fingerprint() == now
