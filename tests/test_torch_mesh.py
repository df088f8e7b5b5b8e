"""Device meshes through the port (``bdlz_tpu_torch/parallel/mesh.py``,
``gridshard.py`` and every ``mesh=`` above them) against the JAX package
on its eight forced host devices, on the CPU.

* The mesh sweep on ``make_mesh((4, 2), devices=["cpu"] * 8)`` against
  JAX's ``mesh8`` run on the grids of ``tests/test_sweep.py``: Ω_DM/Ω_b
  within 1e-15 rel of JAX and bitwise the port's own run without a mesh;
  the rounded chunk size, the manifest and the ``grid_hash`` equal, and a
  meshed directory resumes in the other package, both ways.
* The ``sp`` quadrature against JAX's ``make_sp_quadrature`` on ``mesh8``
  at n_y 8192: ≤1e-13 rel, and ≤1e-12 against the one-device trapezoid
  (JAX's own tolerance); n_y 8191 raises JAX's error.
* Pass-throughs: the stretch move, the checkpointed chain, the stiff
  engine, the emulator build, the service, the fleet and the population
  audit give with a mesh what they give without one, bit for bit; the
  stretch move on a mesh matches JAX's ``run_ensemble(mesh=mesh8)`` fed
  JAX's draws at the sampling tests' tolerance (1e-12).
* The sweep CLI refuses ``--mesh-sp 3`` over eight members with JAX's
  error.

Residuals print as ``RESIDUAL`` lines (``pytest -s``).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bdlz_tpu import config as jc
from bdlz_tpu.parallel import make_mesh as j_make_mesh
from bdlz_tpu.parallel import run_sweep as j_run_sweep

from bdlz_tpu_torch import config as tc
from bdlz_tpu_torch.parallel import make_mesh, run_sweep

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
SWEEP_RTOL = 1e-15
SP_RTOL_JAX, SP_RTOL_ONE = 1e-13, 1e-12
CHAIN_TOL = 1e-12


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8
    return j_make_mesh(shape=(4, 2))


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh((4, 2), devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def env():
    jb, tb = jc.config_from_dict(ARCHIVED), tc.config_from_dict(ARCHIVED)
    return dict(jb=jb, tb=tb, js=jc.static_choices_from_config(jb),
                ts=tc.static_choices_from_config(tb))


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)))


# ---- the mesh --------------------------------------------------------------

def test_make_mesh_mirrors_jax(mesh8, tmesh):
    assert tmesh.shape == dict(mesh8.shape) == {"dp": 4, "sp": 2}
    assert tmesh.devices.size == mesh8.devices.size == 8
    assert tmesh.axis_names == mesh8.axis_names
    assert make_mesh(devices=["cpu"] * 8).shape == dict(j_make_mesh().shape)
    with pytest.raises(ValueError) as got:
        make_mesh((3, 2), devices=["cpu"] * 8)
    with pytest.raises(ValueError) as ref:
        j_make_mesh((3, 2))
    assert str(got.value) == str(ref.value)
    # two members on one device: each its own member
    two = make_mesh((1, 2), devices=["cpu", "cpu"])
    assert two.local_devices == [torch.device("cpu")] * 2 and two.shape == {"dp": 1, "sp": 2}


def test_the_default_mesh_is_every_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


# ---- the mesh sweep ------------------------------------------------------

SWEEP_CASES = {
    "pointwise": ({"m_chi_GeV": np.geomspace(0.05, 5.0, 4),
                   "T_p_GeV": np.geomspace(50.0, 400.0, 4),
                   "P_chi_to_B": np.linspace(0.05, 0.9, 2)}, 16),
    "benchmark": ({"m_chi_GeV": [0.5, 0.95, 2.0]}, 8),
    "masking": ({"incident_flux_scale": [1.07e-9, np.inf]}, 2),
    "rounded": ({"m_chi_GeV": np.geomspace(0.1, 2.0, 24)}, 5),
}


@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_mesh_sweep_matches_jax_and_is_the_run_without_a_mesh(case, env, mesh8, tmesh,
                                                              jit_warmup):
    axes, chunk = SWEEP_CASES[case]
    jit_warmup(j_run_sweep, env["jb"], axes, env["js"], mesh=mesh8, chunk_size=chunk)
    ref = j_run_sweep(env["jb"], axes, env["js"], mesh=mesh8, chunk_size=chunk)
    got = run_sweep(env["tb"], axes, env["ts"], mesh=tmesh, chunk_size=chunk)
    plain = run_sweep(env["tb"], axes, env["ts"], chunk_size=chunk, device="cpu")
    assert (got.n_points, got.n_failed, got.chunks, got.quad_impl, got.n_quad_nodes) == (
        ref.n_points, ref.n_failed, ref.chunks, ref.quad_impl, ref.n_quad_nodes)
    ok = np.isfinite(ref.outputs["DM_over_B"])
    np.testing.assert_array_equal(np.isfinite(got.outputs["DM_over_B"]), ok)
    for f in ("DM_over_B", "Y_B"):
        rel = _rel(got.outputs[f][ok], ref.outputs[f][ok])
        print(f"RESIDUAL mesh sweep {case} {f} max_rel={rel:.3e}")
        assert rel <= SWEEP_RTOL
        np.testing.assert_array_equal(got.outputs[f], plain.outputs[f])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_meshed_directory_resumes_in_the_other_package(writer, env, mesh8, tmesh, tmp_path,
                                                         jit_warmup):
    """Chunk 5 over eight members rounds to 8 in both packages; the
    manifests and ``grid_hash`` are equal, and the other package resumes
    every chunk with the writer's outputs."""
    axes, chunk = SWEEP_CASES["rounded"]
    out = str(tmp_path / "sweep")
    runs = {
        "jax": lambda d: j_run_sweep(env["jb"], axes, env["js"], mesh=mesh8, chunk_size=chunk,
                                     out_dir=d),
        "port": lambda d: run_sweep(env["tb"], axes, env["ts"], mesh=tmesh, chunk_size=chunk,
                                    out_dir=d),
    }
    reader = "port" if writer == "jax" else "jax"
    jit_warmup(runs["jax"], str(tmp_path / "warm"))
    first = runs[writer](out)
    with open(f"{out}/manifest.json") as f:
        written = json.load(f)
    again = runs[reader](out)
    assert first.chunks == again.resumed_chunks == 3
    np.testing.assert_array_equal(again.outputs["DM_over_B"], first.outputs["DM_over_B"])
    runs[reader](str(tmp_path / "own"))
    with open(tmp_path / "own" / "manifest.json") as f:
        own = json.load(f)
    for man in (written, own):
        for rec in man["chunks"].values():
            rec.pop("file")
    assert own == written
    assert written["chunk_size"] == 8 and written["n_total"] == 24


def test_sweep_step_matches_jax(env, mesh8, tmesh):
    from bdlz_tpu.ops.kjma_table import make_f_table as j_table
    from bdlz_tpu.parallel import build_grid as j_grid
    from bdlz_tpu.parallel import sweep_step as j_step

    from bdlz_tpu_torch.ops.kjma_table import make_f_table as t_table
    from bdlz_tpu_torch.parallel import build_grid, sweep_step

    axes = {"m_chi_GeV": np.geomspace(0.3, 3.0, 16)}
    ref = j_step(j_grid(env["jb"], axes), env["js"], j_table(env["jb"].I_p, jnp), mesh=mesh8)
    got = sweep_step(build_grid(env["tb"], axes), env["ts"], t_table(env["tb"].I_p),
                     mesh=tmesh)
    assert _rel(got.DM_over_B, np.asarray(ref.DM_over_B)) <= 1e-12


# ---- the sp quadrature ---------------------------------------------------

def _sp_inputs(env, **over):
    from bdlz_tpu.ops.kjma_table import make_f_table as j_table

    from bdlz_tpu_torch.ops.kjma_table import make_f_table as t_table

    jb, tb = (jc.config_from_dict(dict(ARCHIVED, **over)),
              tc.config_from_dict(dict(ARCHIVED, **over)))
    return (jc.point_params_from_config(jb, jb.P_chi_to_B), j_table(jb.I_p, jnp),
            tc.point_params_from_config(tb, tb.P_chi_to_B), t_table(tb.I_p))


def test_sp_quadrature_matches_jax_and_the_one_device_trapezoid(env, mesh8, tmesh):
    from bdlz_tpu.parallel.gridshard import make_sp_quadrature as j_sp

    from bdlz_tpu_torch.interop import point_params_from_numpy
    from bdlz_tpu_torch.ops.kjma_table import table_to_device
    from bdlz_tpu_torch.parallel.gridshard import make_sp_quadrature
    from bdlz_tpu_torch.solvers.quadrature import integrate_YB_quadrature_tabulated

    jpp, jt, tpp, tt = _sp_inputs(env)
    ref = float(j_sp(env["js"], mesh8, n_y=8192)(jpp, jt))
    got = make_sp_quadrature(env["ts"], tmesh, n_y=8192)(tpp, tt)
    assert got.dtype == torch.float64 and got.shape == ()
    one = float(integrate_YB_quadrature_tabulated(
        point_params_from_numpy(tpp, "cpu"), env["ts"].chi_stats, table_to_device(tt, "cpu"),
        n_y=8192)[0])
    r_jax, r_one = _rel(float(got), ref), _rel(float(got), one)
    print(f"RESIDUAL sp quadrature n_y 8192 vs JAX {r_jax:.3e} vs one device {r_one:.3e}")
    assert r_jax <= SP_RTOL_JAX and r_one <= SP_RTOL_ONE


def test_sp_quadrature_of_an_empty_window_is_zero_and_odd_grids_raise(env, mesh8, tmesh):
    from bdlz_tpu.parallel.gridshard import make_sp_quadrature as j_sp

    from bdlz_tpu_torch.parallel.gridshard import make_sp_quadrature

    jpp, jt, tpp, tt = _sp_inputs(env, T_max_over_Tp=0.5, T_min_over_Tp=0.9)
    assert float(make_sp_quadrature(env["ts"], tmesh, n_y=64)(tpp, tt)) == \
        float(j_sp(env["js"], mesh8, n_y=64)(jpp, jt)) == 0.0
    with pytest.raises(ValueError) as got:
        make_sp_quadrature(env["ts"], tmesh, n_y=8191)
    with pytest.raises(ValueError) as ref:
        j_sp(env["js"], mesh8, n_y=8191)
    assert str(got.value) == str(ref.value) and "not divisible" in str(got.value)


# ---- pass-throughs -------------------------------------------------------

@pytest.fixture(scope="module")
def planck_logps(env):
    from bdlz_tpu.ops.kjma_table import make_f_table as j_table
    from bdlz_tpu.sampling import make_pipeline_logprob as j_logprob

    from bdlz_tpu_torch.ops.kjma_table import make_f_table as t_table
    from bdlz_tpu_torch.sampling import make_pipeline_logprob as t_logprob

    kw = dict(param_keys=("m_chi_GeV", "P_chi_to_B"),
              bounds={"m_chi_GeV": (0.05, 20.0), "P_chi_to_B": (1e-4, 1.0)}, n_y=2000)
    return (j_logprob(env["jb"], env["js"], j_table(env["jb"].I_p, jnp, n=4096), **kw),
            t_logprob(env["tb"], env["ts"], t_table(env["tb"].I_p, n=4096), device="cpu",
                      **kw))


def test_stretch_move_on_a_mesh_is_the_chain_without_one_and_jax_s(planck_logps, mesh8,
                                                                    tmesh):
    """Sixteen walkers split over eight members for every logp: bitwise the
    chain without a mesh; fed JAX's draws, JAX's ``run_ensemble(mesh=mesh8)``
    chain to 1e-12 with the same accepts."""
    import bdlz_tpu.sampling as js
    from test_torch_sampling import _jax_stretch_draws

    import bdlz_tpu_torch.sampling as ts
    from bdlz_tpu_torch.sampling.ensemble import make_generator

    j_logp, t_logp = planck_logps
    init = np.column_stack([np.linspace(0.8, 1.2, 16), np.linspace(0.12, 0.18, 16)])
    plain = ts.run_ensemble(t_logp, init, 6, generator=make_generator(1), device="cpu")
    meshed = ts.run_ensemble(t_logp, init, 6, generator=make_generator(1), mesh=tmesh)
    np.testing.assert_array_equal(meshed.chain.numpy(), plain.chain.numpy())
    np.testing.assert_array_equal(meshed.logp_chain.numpy(), plain.logp_chain.numpy())
    key = jax.random.PRNGKey(4)
    ref = js.run_ensemble(key, j_logp, init, n_steps=6, mesh=mesh8)
    draws = _jax_stretch_draws(key, 6, 16)
    got = ts.run_ensemble(t_logp, init, 6, draws=lambda t: draws[t], mesh=tmesh)
    rel = _rel(got.chain.numpy(), np.asarray(ref.chain))
    print(f"RESIDUAL mesh stretch 6 steps 16 walkers vs JAX mesh8 max_rel={rel:.3e}")
    assert int(got.final.n_accept) == int(ref.final.n_accept)
    assert rel <= CHAIN_TOL


def test_stiff_engine_on_a_mesh_is_the_engine_without_one():
    from bdlz_tpu_torch.interop import point_params_from_numpy
    from bdlz_tpu_torch.parallel import build_grid
    from bdlz_tpu_torch.physics.percolation import make_kjma_grid
    from bdlz_tpu_torch.solvers.batching import solve_boltzmann_esdirk_batch

    cfg = tc.config_from_dict(dict(ARCHIVED, Gamma_wash_over_H=0.01, T_min_over_Tp=0.05))
    static = tc.static_choices_from_config(cfg)
    pp = point_params_from_numpy(
        build_grid(cfg, {"m_chi_GeV": np.geomspace(0.5, 2.0, 3)}), "cpu")
    grid = make_kjma_grid("cpu")
    plain = solve_boltzmann_esdirk_batch(pp, static, grid)
    meshed = solve_boltzmann_esdirk_batch(pp, static, grid,
                                          mesh=make_mesh((2, 1), devices=["cpu"] * 2))
    for a, b in zip(plain, meshed):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_emulator_build_on_a_mesh_is_the_build_without_one(env, tmp_path):
    from bdlz_tpu_torch.emulator import AxisSpec, build_emulator

    spec = {"m_chi_GeV": AxisSpec(0.9, 1.1, 3, "log"), "T_p_GeV": AxisSpec(90.0, 110.0, 3, "log")}
    kw = dict(n_y=400, n_probe=4, n_holdout=8, max_rounds=2, chunk_size=8)
    plain, _ = build_emulator(env["tb"], spec, device="cpu", **kw)
    meshed, _ = build_emulator(env["tb"], spec, mesh=make_mesh((2, 1), devices=["cpu"] * 2),
                               **kw)
    assert meshed.identity == plain.identity
    assert [np.asarray(a).tobytes() for a in meshed.axis_nodes] == \
        [np.asarray(a).tobytes() for a in plain.axis_nodes]
    for f in plain.values:
        assert np.asarray(meshed.values[f]).tobytes() == np.asarray(plain.values[f]).tobytes()


@pytest.fixture(scope="module")
def served(tiny_emulator):
    from _serve_common import make_served

    return make_served(tiny_emulator)


def test_service_and_fleet_exact_paths_on_a_mesh_are_the_paths_without_one(served):
    from _serve_common import FakeClock, pump

    import bdlz_tpu_torch.serve as ts

    th = served.thetas[:64]
    mesh = make_mesh((2, 1), devices=["cpu"] * 2)
    svc = [ts.YieldService(served.tart, served.tbase, max_batch_size=32, device="cpu", **kw)
           for kw in ({}, {"mesh": mesh})]
    batches = [[s.process_batch(th[lo:lo + 32]) for lo in (0, 32)] for s in svc]
    assert sum(b.n_fallback for b in batches[0]) > 0
    for a, b in zip(*batches):
        assert (a.n_fallback, a.reasons) == (b.n_fallback, b.reasons)
        assert np.asarray(a.values).tobytes() == np.asarray(b.values).tobytes()
    answers = []
    for kw in ({}, {"mesh": mesh}):
        clock = FakeClock()
        f = ts.FleetService(served.tart, served.tbase, max_batch_size=32, n_replicas=1,
                            clock=clock, devices=["cpu"], **kw)
        answers.append([(r.value, r.fallback_reason) for r in pump(f, clock, th)])
    assert answers[1] == answers[0]
    assert any(reason == "ood" for _, reason in answers[0])


def test_population_audit_on_a_mesh_is_the_audit_without_one(env):
    from bdlz_tpu_torch.ops.kjma_table import make_f_table, table_to_device
    from bdlz_tpu_torch.parallel import build_grid
    from bdlz_tpu_torch.validation import engine_population_max_rel

    grid = build_grid(env["tb"], {"m_chi_GeV": np.geomspace(0.3, 3.0, 7)})
    ref = np.full(7, 5.0)
    table = make_f_table(env["tb"].I_p, n=4096)
    mesh = make_mesh((4, 1), devices=["cpu"] * 4)
    plain = engine_population_max_rel(grid, ref, env["ts"], table_to_device(table, "cpu"),
                                      impl="tabulated", n_y=2000, device="cpu")
    meshed = engine_population_max_rel(grid, ref, env["ts"], {torch.device("cpu"): table_to_device(
        table, "cpu")}, impl="tabulated", n_y=2000, mesh=mesh)
    assert meshed == plain


def test_sweep_cli_refuses_a_mesh_sp_that_does_not_divide(tmp_path, capsys):
    from bdlz_tpu.sweep_cli import main as j_main

    from bdlz_tpu_torch.sweep_cli import main as t_main

    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(ARCHIVED))
    argv = ["--config", str(path), "--axis", "m_chi_GeV=1.0", "--mesh-sp", "3"]
    with pytest.raises(SystemExit) as ref:
        j_main(argv)
    with pytest.raises(SystemExit) as got:
        t_main(argv + ["--device", ",".join(["cpu"] * 8)])
    assert got.value.code == ref.value.code == "--mesh-sp 3 does not divide device count 8"


def test_parallel_exports_jax_s_names():
    import bdlz_tpu.parallel as jp

    import bdlz_tpu_torch.parallel as tp

    assert tp.__all__ == jp.__all__
    assert all(hasattr(tp, name) for name in tp.__all__)


def test_sweep_cli_refuses_elastic_with_multihost_as_jax_does(tmp_path, capsys):
    from bdlz_tpu.sweep_cli import main as j_main

    from bdlz_tpu_torch.sweep_cli import main as t_main

    argv = ["--config", str(tmp_path / "x.json"), "--axis", "m_chi_GeV=1.0", "--elastic",
            "local", "--elastic-store", str(tmp_path / "es"), "--multihost"]
    errs = []
    for main in (j_main, t_main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1].split(": error: ")[1])
    assert errs[0] == errs[1] == ("--elastic and --multihost are mutually exclusive "
                                  "(elastic workers are single-process; scale is the fleet)")
