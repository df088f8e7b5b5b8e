"""The port's LZ scenario plane (the N-level chain, the thermal bath), its
audits, the sweep's profile door and the CLIs' profile flags, against the
JAX package on the CPU, with inputs made from a seed with numpy.

Tolerances: chain populations ≤ 1e-10 absolute; the audits' verdicts
equal and their metrics within 1e-10; ``run_sweep(lz_profile=…)`` Ω_DM/Ω_b
≤ 1e-10 relative with ``lz_identity`` equal to JAX's manifest
``hash_extra``; the single-point CLI's stdout byte-identical.
"""
import dataclasses
import json
import sys

import numpy as np
import pytest

from bdlz_tpu.config import config_from_dict as j_config_from_dict
from bdlz_tpu.config import static_choices_from_config as j_static
from bdlz_tpu.lz import chain as jc
from bdlz_tpu.lz import profile as jp
from bdlz_tpu.lz import sweep_bridge as jsb
from bdlz_tpu.parallel.sweep import run_sweep as j_run_sweep
from bdlz_tpu import validation as jv

from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
from bdlz_tpu_torch.lz import chain as tc
from bdlz_tpu_torch.lz import profile as tp
from bdlz_tpu_torch.lz import sweep_bridge as tsb
from bdlz_tpu_torch.parallel.sweep import run_sweep
from bdlz_tpu_torch import validation as tv

CPU = "cpu"
XI = np.linspace(-30.0, 30.0, 1001)


def tanh_wall(mod):
    """tests/test_scenarios.py's profile: one smooth wall crossing."""
    return mod.BounceProfile(xi=XI, delta=-0.08 * np.tanh(XI / 4.0),
                             mix=np.full_like(XI, 0.02))


def record(name, value):
    """Print a residual (``pytest -s`` shows the lines PERF.md records)."""
    print(f"RESIDUAL {name} {value!r}")
    return value


def seeded(mod, seed=5, N=193):
    rng = np.random.default_rng(seed)
    xi = np.sort(rng.uniform(-25.0, 25.0, N))
    return mod.BounceProfile(xi=xi, delta=0.2 * xi * np.cos(0.15 * xi),
                             mix=0.08 + 0.02 * rng.uniform(size=N))


ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}


# ---- the chain -----------------------------------------------------------

@pytest.mark.parametrize("n_levels", [2, 3, 4])
def test_chain_populations_match_jax(n_levels):
    v = np.random.default_rng(n_levels).uniform(0.03, 0.97, 12)
    got = tc.chain_populations_for_speeds(seeded(tp), v, n_levels, device=CPU)
    ref = jc.chain_populations_for_speeds(seeded(jp), v, n_levels)
    assert got.shape == ref.shape == (12, n_levels)
    assert record(f"chain_abs[N={n_levels}]", np.max(np.abs(got - ref))) <= 1e-10
    assert np.max(np.abs(got.sum(axis=1) - 1.0)) <= 1e-10
    one = tc.chain_populations(seeded(tp), float(v[0]), n_levels, device=CPU)
    assert np.max(np.abs(one - ref[0])) <= 1e-10
    assert tc.chain_conversion_probability(seeded(tp), float(v[0]), n_levels,
                                           device=CPU) == one[-1]


def test_chain_two_levels_is_the_coherent_kernel():
    v = np.geomspace(0.05, 0.95, 9)
    P2 = tc.chain_probabilities_for_points(tanh_wall(tp), v, 2, device=CPU)
    coh = tsb.probabilities_for_points(tanh_wall(tp), v, "coherent", device=CPU)
    assert np.max(np.abs(P2 / coh - 1.0)) <= 1e-12


def test_chain_small_budget_chunks_and_helpers_match_jax():
    v = np.linspace(0.1, 0.9, 7)
    full = tc.chain_populations_for_speeds(seeded(tp), v, 3, device=CPU)
    tiny = tc.chain_populations_for_speeds(seeded(tp), v, 3, speed_chunk_bytes=1, device=CPU)
    assert np.array_equal(full, tiny)
    assert np.array_equal(tc.chain_level_weights(5), jc.chain_level_weights(5))
    assert np.array_equal(tc.uniform_chain_populations_analytic(4, 0.3, 5.0, 0.4),
                          jc.uniform_chain_populations_analytic(4, 0.3, 5.0, 0.4))
    with pytest.raises(ValueError):
        tc.validate_n_levels(1)
    assert tc.chain_populations_for_speeds(seeded(tp), [], 3, device=CPU).shape == (0, 3)


# ---- scenario dispatch and identity --------------------------------------

@pytest.mark.parametrize("over", [{}, {"lz_mode": "chain", "lz_n_levels": 3},
                                  {"lz_mode": "thermal", "lz_bath_eta": 0.2,
                                   "lz_bath_omega_c": 30.0}])
def test_scenario_identity_and_points_match_jax(over):
    cfg = dict(ARCHIVED, **over)
    t_static = static_choices_from_config(config_from_dict(cfg))
    j_st = j_static(j_config_from_dict(cfg))
    assert tsb.scenario_identity(t_static) == jsb.scenario_identity(j_st)
    v = np.linspace(0.1, 0.9, 5)
    T = np.array([20.0, 50.0, 50.0, 100.0, np.nan])
    if not over:
        with pytest.raises(ValueError, match="two-channel"):
            tsb.scenario_probabilities_for_points(seeded(tp), t_static, v, T, device=CPU)
        return
    got = tsb.scenario_probabilities_for_points(seeded(tp), t_static, v, T, device=CPU)
    ref = jsb.scenario_probabilities_for_points(seeded(jp), j_st, v, T)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    assert np.max(np.abs(got[ok] - ref[ok]) / ref[ok]) <= 1e-10


# ---- the audits ------------------------------------------------------------

def _same_audit(t, j, tol=1e-10):
    assert t.ok == j.ok and (t.reason is None) == (j.reason is None)
    for f in t._fields:
        a, b = getattr(t, f), getattr(j, f)
        if isinstance(b, (bool, np.bool_)) or f in ("ok", "reason"):
            assert a == b, f
        else:
            assert record(f"{type(t).__name__}.{f}", abs(float(a) - float(b))) <= tol, (f, a, b)


@pytest.mark.parametrize("n_levels", [3, 4])
def test_chain_audit_matches_jax(n_levels):
    t = tv.chain_mode_audit(tanh_wall(tp), n_levels=n_levels, n_sample=8, device=CPU)
    j = jv.chain_mode_audit(tanh_wall(jp), n_levels=n_levels, n_sample=8)
    assert t.ok
    _same_audit(t, j)


@pytest.mark.parametrize("eta,omega_c", [(0.2, 30.0), (0.0, 5.0)])
def test_thermal_audit_matches_jax(eta, omega_c, jit_warmup):
    jit_warmup(jv.thermal_mode_audit, tanh_wall(jp), eta, omega_c, n_sample=6)
    t = tv.thermal_mode_audit(tanh_wall(tp), eta, omega_c, n_sample=6, device=CPU)
    j = jv.thermal_mode_audit(tanh_wall(jp), eta, omega_c, n_sample=6)
    assert t.ok and t.cold_limit_bitwise
    _same_audit(t, j)


def test_chain_audit_fails_on_a_poisoned_profile():
    bad = tanh_wall(tp)._replace(mix=np.full_like(XI, np.nan))
    res = tv.chain_mode_audit(bad, n_sample=4, device=CPU)
    assert not res.ok and res.reason


# ---- the sweep's profile door ---------------------------------------------

AXES = {"v_w": np.linspace(0.15, 0.85, 8), "T_p_GeV": [40.0, 120.0],
        "m_chi_GeV": [0.5, 2.0]}


def _pair(jit_warmup, cfg_over, **kw):
    cfg = dict(ARCHIVED, quad_panel_gl=False, **cfg_over)
    t_cfg, j_cfg = config_from_dict(cfg), j_config_from_dict(cfg)
    common = dict(chunk_size=16, n_y=2000, impl="tabulated")
    j_kw = {k: (tanh_wall(jp) if k == "lz_profile" else v) for k, v in kw.items()}
    t_kw = {k: (tanh_wall(tp) if k == "lz_profile" else v) for k, v in kw.items()}
    jit_warmup(j_run_sweep, j_cfg, AXES, j_static(j_cfg), **common, **j_kw)
    ref = j_run_sweep(j_cfg, AXES, j_static(j_cfg), **common, **j_kw)
    got = run_sweep(t_cfg, AXES, static_choices_from_config(t_cfg), device=CPU,
                    **common, **t_kw)
    return got, ref


@pytest.mark.parametrize("over,kw", [
    pytest.param({}, {"lz_method": "local"}, id="local"),
    pytest.param({}, {"lz_method": "coherent"}, id="coherent"),
    pytest.param({}, {"lz_method": "local-momentum"}, id="local-momentum"),
    pytest.param({}, {"lz_method": "dephased", "lz_gamma_phi": 0.01}, id="dephased"),
    pytest.param({"lz_mode": "chain", "lz_n_levels": 3}, {}, id="chain"),
    pytest.param({"lz_mode": "thermal", "lz_bath_eta": 0.001, "lz_bath_omega_c": 50.0},
                 {}, id="thermal"),
])
def test_profile_sweep_matches_jax(over, kw, jit_warmup):
    got, ref = _pair(jit_warmup, over, lz_profile="profile", **kw)
    assert got.n_points == ref.n_points == 32 and got.n_failed == ref.n_failed == 0
    for f, r in ref.outputs.items():
        assert record(f"sweep[{over.get('lz_mode') or kw['lz_method']}].{f}",
                      np.max(np.abs(got.outputs[f] - r) / np.abs(r))) <= 1e-10, f
    expect = {"lz_profile": jsb.profile_fingerprint(tanh_wall(jp))}
    if not over:
        expect["lz_method"] = kw["lz_method"]
        if kw["lz_method"] == "dephased":
            expect["lz_gamma_phi"] = kw["lz_gamma_phi"]
    assert got.lz_identity == expect
    assert got.lz_seconds > 0.0


def test_profile_sweep_refusals_match_jax():
    cfg = dict(ARCHIVED, quad_panel_gl=False)
    base = config_from_dict(cfg)
    st = static_choices_from_config(base)
    kw = dict(chunk_size=4, n_y=2000, impl="tabulated", device=CPU)
    with pytest.raises(ValueError, match="P_chi_to_B cannot be swept"):
        run_sweep(base, {"P_chi_to_B": [0.1, 0.2]}, st, lz_profile=tanh_wall(tp), **kw)
    with pytest.raises(ValueError, match="either bounce or lz_profile"):
        run_sweep(base, {"v_w": [0.3]}, st, lz_profile=tanh_wall(tp),
                  bounce={"lam4": 0.5}, **kw)
    chain = config_from_dict(dict(cfg, lz_mode="chain", lz_n_levels=3))
    cst = static_choices_from_config(chain)
    with pytest.raises(ValueError, match="bounce"):
        run_sweep(chain, {"v_w": [0.3]}, cst, **kw)
    with pytest.raises(ValueError, match="no effect"):
        run_sweep(chain, {"v_w": [0.3]}, cst, lz_profile=tanh_wall(tp),
                  lz_method="coherent", **kw)
    with pytest.raises(ValueError, match="no effect"):
        run_sweep(chain, {"v_w": [0.3]}, cst, lz_profile=tanh_wall(tp),
                  lz_gamma_phi=0.1, **kw)


def test_profile_without_config_P_uses_a_placeholder(tmp_path):
    path = str(tmp_path / "p.csv")
    tp.write_profile_csv(path, tanh_wall(tp))
    base = config_from_dict(dict(ARCHIVED, P_chi_to_B=None, quad_panel_gl=False))
    res = run_sweep(base, {"v_w": [0.2, 0.4]}, static_choices_from_config(base),
                    chunk_size=2, n_y=2000, impl="tabulated", device=CPU, lz_profile=path)
    assert res.n_failed == 0 and res.lz_identity["lz_method"] == "local"


# ---- the CLIs ------------------------------------------------------------

def _cli_pair(tmp_path, capsys, monkeypatch, flags):
    from bdlz_tpu.cli import main as j_main

    from bdlz_tpu_torch.cli import main as t_main

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(ARCHIVED))
    prof = str(tmp_path / "prof.csv")
    tp.write_profile_csv(prof, seeded(tp))
    outs = []
    for name, main, extra in (("j", j_main, []), ("t", t_main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        capsys.readouterr()
        main(["--config", str(cfg), "--maybe-compute-P-from-profile", prof, *flags, *extra])
        outs.append(capsys.readouterr().out)
    return outs


@pytest.mark.parametrize("flags", [[], ["--lz-method", "coherent"], ["--lz-method", "local"],
                                   ["--lz-method", "dephased", "--lz-gamma-phi", "0.05"],
                                   ["--lz-momentum-average", "--lz-method", "local"]])
def test_cli_profile_P_stdout_is_byte_identical(tmp_path, capsys, monkeypatch, flags,
                                                jit_warmup):
    j_out, t_out = _cli_pair(tmp_path, capsys, monkeypatch, flags)
    assert "[info] Using P_chi_to_B from profile:" in t_out
    assert t_out == j_out


def test_cli_profile_failure_falls_back_to_config_like_jax(tmp_path, capsys, monkeypatch):
    from bdlz_tpu.cli import main as j_main

    from bdlz_tpu_torch.cli import main as t_main

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(ARCHIVED))
    bad = tmp_path / "bad.csv"
    bad.write_text("xi,foo\n0,1\n1,2\n")
    outs = []
    for name, main, extra in (("j", j_main, []), ("t", t_main, ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        capsys.readouterr()
        main(["--config", str(cfg), "--maybe-compute-P-from-profile", str(bad),
              "--lz-method", "local", *extra])
        outs.append(capsys.readouterr().out)
    assert "[warn] Could not compute P from profile" in outs[1]
    assert outs[1] == outs[0]


def test_cli_external_hook_is_honoured_first(tmp_path, capsys, monkeypatch):
    mod = tmp_path / "hooks"
    mod.mkdir()
    (mod / "extended_LZ_lambda.py").write_text(
        "def compute_lambda_eff_from_profile(path):\n    return 0.025\n")
    monkeypatch.syspath_prepend(str(mod))
    from bdlz_tpu.cli import try_external_P_from_profile as j_hook

    from bdlz_tpu_torch.cli import try_external_P_from_profile as t_hook

    try:
        assert t_hook("x.csv", 0.3) == j_hook("x.csv", 0.3)
        assert t_hook("x.csv", 0.3)[1] == "extended_LZ_lambda"
    finally:
        # the hook imports by name: a cached fake would answer later tests
        sys.modules.pop("extended_LZ_lambda", None)


@pytest.mark.parametrize("argv,msg", [
    (["--lz-momentum-average"], "requires --maybe-compute-P-from-profile"),
    (["--lz-method", "local"], "require --maybe-compute-P-from-profile"),
    (["--maybe-compute-P-from-profile", "p.csv", "--lz-gamma-phi", "0.1"],
     "requires --lz-method dephased"),
    (["--maybe-compute-P-from-profile", "p.csv", "--lz-gamma-phi", "-1",
      "--lz-method", "dephased"], "must be >= 0"),
])
def test_cli_pairing_errors_match_jax(argv, msg, tmp_path, capsys):
    from bdlz_tpu.cli import main as j_main

    from bdlz_tpu_torch.cli import main as t_main

    errs = []
    for main in (j_main, t_main):
        with pytest.raises(SystemExit) as exc:
            main(["--config", str(tmp_path / "x.json"), *argv])
        assert exc.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ")[-1])
    assert msg in errs[1] and errs[1] == errs[0]


@pytest.mark.parametrize("argv,msg", [
    (["--lz-profile", "p.csv", "--bounce", "b.json"], "either --bounce or --lz-profile"),
    (["--lz-mode", "chain", "--lz-method", "coherent"], "has no effect with --lz-mode"),
    (["--lz-mode", "thermal", "--lz-gamma-phi", "0.1"], "derives its own dephasing"),
    (["--lz-n-levels", "3"], "--lz-n-levels requires --lz-mode chain"),
    (["--lz-bath-eta", "0.1"], "require --lz-mode thermal"),
    (["--lz-gamma-phi", "0.1"], "requires --lz-method dephased"),
    (["--lz-mode", "chain"], "pass --lz-profile or --bounce"),
])
def test_sweep_cli_pairing_errors_match_jax(argv, msg, tmp_path, capsys):
    from bdlz_tpu.sweep_cli import main as j_main

    from bdlz_tpu_torch.sweep_cli import main as t_main

    errs = []
    for main in (j_main, t_main):
        with pytest.raises(SystemExit) as exc:
            main(["--config", str(tmp_path / "x.json"), "--axis", "v_w=0.3", *argv])
        assert exc.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ")[-1])
    assert msg in errs[1] and errs[1] == errs[0]


@pytest.mark.parametrize("flags,mode", [
    (["--lz-method", "coherent"], None),
    (["--lz-mode", "chain", "--lz-n-levels", "3"], "chain"),
    (["--lz-mode", "thermal", "--lz-bath-eta", "0.001", "--lz-bath-omega-c", "50"], "thermal"),
])
def test_sweep_cli_profile_summary_matches_jax(flags, mode, tmp_path, capsys):
    from bdlz_tpu.sweep_cli import main as j_main

    from bdlz_tpu_torch.sweep_cli import main as t_main

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(dict(ARCHIVED, quad_panel_gl=False)))
    prof = str(tmp_path / "prof.csv")
    tp.write_profile_csv(prof, tanh_wall(tp))
    argv = ["--config", str(cfg), "--axis", "v_w=lin:0.2:0.6:4", "--chunk", "4",
            "--n-y", "2000", "--lz-profile", prof, *flags]
    j_main(argv)
    j_out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    t_main(argv + ["--impl", "tabulated", "--device", "cpu"])
    t_out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(t_out) == list(j_out) and t_out.get("lz_mode") == mode
    assert t_out["n_points"] == 4 and t_out["n_failed"] == 0
    assert t_out["closest_to_planck"]["DM_over_B"] == pytest.approx(
        j_out["closest_to_planck"]["DM_over_B"], rel=1e-10)


def test_sweep_cli_scenario_config_needs_a_profile(tmp_path):
    from bdlz_tpu_torch.sweep_cli import main as t_main

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(dict(ARCHIVED, lz_mode="chain", lz_n_levels=3)))
    with pytest.raises(SystemExit, match="bounce"):
        t_main(["--config", str(cfg), "--axis", "v_w=0.3", "--device", "cpu"])
    prof = str(tmp_path / "p.csv")
    tp.write_profile_csv(prof, tanh_wall(tp))
    with pytest.raises(SystemExit, match="no effect"):
        t_main(["--config", str(cfg), "--axis", "v_w=0.3", "--device", "cpu",
                "--lz-profile", prof, "--lz-gamma-phi", "0.1", "--lz-method", "dephased"])


def test_options_apply_scenario_flags_revalidates():
    from bdlz_tpu_torch.config import ConfigError
    from bdlz_tpu_torch.lz.options import apply_scenario_flags

    cfg = config_from_dict(ARCHIVED)
    ns = type("A", (), {"lz_mode": "chain", "lz_n_levels": 4})()
    assert apply_scenario_flags(cfg, ns).lz_n_levels == 4
    assert apply_scenario_flags(cfg, type("B", (), {})()) is cfg
    bad = type("C", (), {"lz_mode": "two_channel", "lz_n_levels": 4})()
    with pytest.raises(ConfigError):
        apply_scenario_flags(cfg, bad)
    assert dataclasses.is_dataclass(cfg)
