"""The port's host planes against the JAX package on the same inputs:
the sanitizer's boundaries and dtype contract, the native CSV parser,
the engine gate's reference ratios and their cache key, and the sweep
CLI's --profile-dir (one trace of the sweep, with its spans) /
--debug-nans / --sanitize.

Residuals print as ``RESIDUAL`` lines (``pytest -s``)."""
import json

import numpy as np
import pytest
import torch

import bdlz_tpu.models.yields_pipeline as jpipe
import bdlz_tpu.physics.percolation as jperc
import bdlz_tpu.solvers.quadrature as jquad
import bdlz_tpu_torch.models.yields_pipeline as tpipe
import bdlz_tpu_torch.physics.percolation as tperc
import bdlz_tpu_torch.solvers.quadrature as tquad
from bdlz_tpu import sanitize as jsan
from bdlz_tpu.config import config_from_dict as jcfg
from bdlz_tpu.config import point_params_from_config as jpoint
from bdlz_tpu.config import static_choices_from_config as jstatic
from bdlz_tpu_torch import sanitize as tsan
from bdlz_tpu_torch.config import config_from_dict as tcfg
from bdlz_tpu_torch.config import point_params_from_config as tpoint
from bdlz_tpu_torch.config import static_choices_from_config as tstatic
from bdlz_tpu_torch.interop import point_params_from_numpy
from bdlz_tpu_torch.utils.profiling import enable_nan_debugging

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}


@pytest.fixture(autouse=True)
def _disarm():
    yield
    jsan.disable()
    tsan.disable()
    enable_nan_debugging(False)


# ---- sanitizer ---------------------------------------------------------

def _nan_like(fn):
    def bad(*args, **kwargs):
        out = fn(*args, **kwargs)
        return out * np.nan
    return bad


def _inject(monkeypatch, where):
    """Make the pipeline produce a NaN first at boundary ``where``, in
    both packages, by the same change."""
    if where == "percolation":
        monkeypatch.setattr(jquad, "area_over_volume", _nan_like(jquad.area_over_volume))
        monkeypatch.setattr(tquad, "area_over_volume", _nan_like(tquad.area_over_volume))
    elif where == "source":
        monkeypatch.setattr(jquad, "source_window", _nan_like(jquad.source_window))
        monkeypatch.setattr(tquad, "source_window", _nan_like(tquad.source_window))
    elif where == "solver":
        # JAX's A/V integrates z with np.trapezoid too: poison only the
        # y-integral (its grid has n_y = 2000 nodes, z has 1200)
        trap = np.trapezoid

        def y_trap_nan(y, x=None, *args, **kwargs):
            out = trap(y, x, *args, **kwargs)
            return out * np.nan if x is not None and np.shape(x)[-1] == 2000 else out

        monkeypatch.setattr(np, "trapezoid", y_trap_nan)
        monkeypatch.setattr(tquad, "trapezoid", _nan_like(tquad.trapezoid))


def _run_both(d, quad_panel_gl=False):
    jb, tb = jcfg(d), tcfg(d)
    js = jstatic(jb)._replace(quad_panel_gl=quad_panel_gl, n_y=2000)
    ts = tstatic(tb)._replace(quad_panel_gl=quad_panel_gl, n_y=2000)
    out = []
    for run in (
        lambda: jpipe.point_yields(jpoint(jb, jb.P_chi_to_B), js,
                                   jperc.make_kjma_grid(np), np),
        lambda: tpipe.point_yields(point_params_from_numpy(tpoint(tb, tb.P_chi_to_B), "cpu"),
                                   ts, tperc.make_kjma_grid("cpu")),
    ):
        try:
            out.append(run())
        except (jsan.SanitizerError, tsan.SanitizerError) as exc:
            out.append(exc)
    return out


@pytest.mark.parametrize("where,boundary", [
    ("thermo", tsan.BOUNDARY_THERMO),
    ("percolation", tsan.BOUNDARY_PERCOLATION),
    ("source", tsan.BOUNDARY_SOURCE),
    ("solver", tsan.BOUNDARY_SOLVER),
])
def test_a_nan_trips_at_the_jax_boundary_and_names_the_quantity(monkeypatch, where, boundary):
    d = dict(ARCHIVED, T_p_GeV=-100.0) if where == "thermo" else dict(ARCHIVED)
    _inject(monkeypatch, where)
    jsan.enable(jax_nans=False)
    tsan.enable(nans=False)
    j_err, t_err = _run_both(d)
    assert isinstance(j_err, jsan.SanitizerError) and isinstance(t_err, tsan.SanitizerError)
    assert t_err.boundary == j_err.boundary == boundary
    assert t_err.name == j_err.name
    assert f"[{boundary}]" in str(t_err)


def test_the_panel_rule_checks_y_b_like_jax(monkeypatch):
    monkeypatch.setattr(jquad, "source_window", _nan_like(jquad.source_window))
    monkeypatch.setattr(tquad, "source_window", _nan_like(tquad.source_window))
    jsan.enable(jax_nans=False)
    tsan.enable(nans=False)
    j_err, t_err = _run_both(dict(ARCHIVED), quad_panel_gl=True)
    assert (t_err.boundary, t_err.name) == (j_err.boundary, j_err.name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_a_narrow_float_tensor_trips_the_dtype_check(dtype):
    tsan.enable(nans=False)
    with pytest.raises(tsan.SanitizerError) as exc:
        tsan.checkpoint(tsan.BOUNDARY_SOLVER, Y_B=torch.ones(4, dtype=dtype))
    assert str(dtype).removeprefix("torch.") in str(exc.value)
    assert "Y_B" in str(exc.value) and "float64 contract" in str(exc.value)


def test_the_dtype_message_is_jax_s():
    jsan.enable(jax_nans=False)
    tsan.enable(nans=False)
    with pytest.raises(jsan.SanitizerError) as j:
        jsan.checkpoint(jsan.BOUNDARY_SOLVER, Y_B=np.ones(4, dtype=np.float32))
    with pytest.raises(tsan.SanitizerError) as t:
        tsan.checkpoint(tsan.BOUNDARY_SOLVER, Y_B=torch.ones(4, dtype=torch.float32))
    assert str(t.value) == str(j.value)


def test_check_tree_allow_nan_keeps_only_the_dtype_contract():
    from bdlz_tpu_torch.models.yields_pipeline import YieldsResult

    tsan.enable(nans=False)
    good = YieldsResult(*(torch.tensor([v], dtype=torch.float64) for v in range(1, 6)))
    tsan.check_tree(tsan.BOUNDARY_SOLVER, good)
    bad = good._replace(Y_B=torch.tensor([float("nan")], dtype=torch.float64))
    with pytest.raises(tsan.SanitizerError, match="Y_B"):
        tsan.check_tree(tsan.BOUNDARY_SOLVER, bad)
    tsan.check_tree(tsan.BOUNDARY_SOLVER, bad, allow_nan=True)
    with pytest.raises(tsan.SanitizerError):
        tsan.check_tree(tsan.BOUNDARY_SOLVER,
                        bad._replace(Y_chi=torch.ones(2, dtype=torch.float32)), allow_nan=True)


def test_checkpoints_are_no_ops_when_disabled_or_opaque():
    nan = torch.tensor([float("nan")], dtype=torch.float64)
    tsan.checkpoint(tsan.BOUNDARY_SOLVER, Y_B=nan, bad=torch.ones(2, dtype=torch.float32))
    tsan.enable(nans=False)
    with tsan.opaque():
        tsan.checkpoint(tsan.BOUNDARY_SOLVER, Y_B=nan)
        tsan.check_tree(tsan.BOUNDARY_SOLVER, {"Y_B": nan})
    with pytest.raises(tsan.SanitizerError):
        tsan.checkpoint(tsan.BOUNDARY_SOLVER, Y_B=nan)


def test_a_disabled_run_is_bitwise_the_run_before_arming():
    tb = tcfg(ARCHIVED)
    ts = tstatic(tb)._replace(quad_panel_gl=False, n_y=2000)

    def run():
        pp = point_params_from_numpy(tpoint(tb, tb.P_chi_to_B), "cpu")
        return tpipe.point_yields(pp, ts, tperc.make_kjma_grid("cpu"))

    before = run()
    tsan.enable()
    armed = run()
    tsan.disable()
    enable_nan_debugging(False)
    after = run()
    for a, b, c in zip(before, armed, after):
        assert a.numpy().tobytes() == b.numpy().tobytes() == c.numpy().tobytes()


def _cli(monkeypatch, tmp_path, capsys, argv):
    from bdlz_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    main(argv)
    return capsys.readouterr().out, (tmp_path / "yields_out.json").read_bytes()


def test_cli_sanitize_prints_the_same_bytes(monkeypatch, tmp_path, capsys):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(ARCHIVED))
    plain = _cli(monkeypatch, tmp_path, capsys,
                 ["--config", str(cfg), "--device", "cpu", "--diagnostics"])
    sanitized = _cli(monkeypatch, tmp_path, capsys,
                     ["--config", str(cfg), "--device", "cpu", "--diagnostics", "--sanitize"])
    assert plain == sanitized
    assert "DM/B ratio= 5.68893" in plain[0]


def test_cli_sanitize_aborts_on_the_nan_config_like_jax_s_device_backend(monkeypatch, tmp_path):
    from bdlz_tpu_torch.cli import main

    cfg = tmp_path / "nan.json"
    cfg.write_text(json.dumps(dict(ARCHIVED, T_p_GeV=-100.0)))
    monkeypatch.chdir(tmp_path)
    # JAX's --backend jax raises "invalid value (nan) encountered in pow"
    with pytest.raises(FloatingPointError, match="'pow'"):
        main(["--config", str(cfg), "--device", "cpu", "--sanitize"])


def test_mcmc_cli_sanitize_prints_the_same_summary(tmp_path, capsys):
    from bdlz_tpu_torch.mcmc_cli import main

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(ARCHIVED))
    argv = ["--config", str(cfg), "--param", "m_chi_GeV=0.5:2", "--param",
            "P_chi_to_B=0.01:0.9", "--walkers", "8", "--steps", "4", "--burn", "1",
            "--device", "cpu"]
    main(argv)
    plain = capsys.readouterr().out
    main(argv + ["--sanitize"])
    assert capsys.readouterr().out == plain


# ---- native CSV parser -------------------------------------------------

FIXTURE_CSVS = {
    "sci_blank": "xi,delta,m_mix\n-1e-3,2.5E+2,0.1\n\n4,-5e-1,0.2\n",
    "crlf_spaces": "xi, delta ,m_mix\r\n1.0 , 2.0,3.0\r\n-4.5,6e-300,  7\r\n",
    "one_row": "a,b,c,d\n1,2,3,4\n",
}
MALFORMED_CSVS = {
    "short_row": "a,b\n1.0,2.0\n3.0\n",
    "non_numeric": "a,b\n1.0,spam\n",
    "empty": "",
    "blank_header": "   \n1,2\n",
    "trailing_junk": "a,b\n1.0,2.0 x\n",
}


@pytest.fixture(scope="module")
def natives():
    from bdlz_tpu import native as jn

    from bdlz_tpu_torch import native as tn

    if not jn.native_available() or not tn.native_available():
        pytest.skip("no C++ toolchain on this machine")
    return jn, tn


@pytest.mark.parametrize("name", sorted(FIXTURE_CSVS))
def test_native_parse_is_bitwise_jax_s(natives, tmp_path, name):
    jn, tn = natives
    p = tmp_path / f"{name}.csv"
    p.write_text(FIXTURE_CSVS[name])
    (jnames, jdata), (tnames, tdata) = jn.read_csv_native(str(p)), tn.read_csv_native(str(p))
    assert tnames == jnames and tdata.tobytes() == jdata.tobytes()


def test_native_parse_of_a_large_profile_is_bitwise_jax_s_and_numpy_s(natives, tmp_path,
                                                                      monkeypatch):
    from bdlz_tpu_torch import native as tn
    from bdlz_tpu_torch.lz import profile as tprof

    jn, _ = natives
    rng = np.random.default_rng(11)
    data = rng.normal(size=(100_000, 3)) * np.array([1e-3, 1e2, 1.0])
    p = tmp_path / "big.csv"
    np.savetxt(p, data, delimiter=",", header="xi,delta,m_mix", comments="",
               fmt="%.17g")
    (jnames, jdata), (tnames, tdata) = jn.read_csv_native(str(p)), tn.read_csv_native(str(p))
    assert tnames == jnames and tdata.tobytes() == jdata.tobytes()
    assert tdata.tobytes() == data.tobytes()
    # the profile reader gives the same bits through either parser
    native_read = tprof._read_csv(str(p))
    monkeypatch.setattr(tn, "_load", lambda: None)
    assert not tn.native_available()
    numpy_read = tprof._read_csv(str(p))
    assert native_read[0] == numpy_read[0]
    assert native_read[1].tobytes() == numpy_read[1].tobytes()


@pytest.mark.parametrize("name", sorted(MALFORMED_CSVS))
def test_malformed_files_give_jax_s_error_class_and_message(natives, tmp_path, name):
    jn, tn = natives
    p = tmp_path / f"{name}.csv"
    p.write_text(MALFORMED_CSVS[name])
    with pytest.raises(jn.NativeParseError) as j:
        jn.read_csv_native(str(p))
    with pytest.raises(tn.NativeParseError) as t:
        tn.read_csv_native(str(p))
    assert str(t.value) == str(j.value)


def test_missing_file_message_is_jax_s(natives):
    jn, tn = natives
    msgs = []
    for mod in (jn, tn):
        with pytest.raises(mod.NativeParseError) as exc:
            mod.read_csv_native("/nonexistent/x.csv")
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_the_profile_loader_turns_parse_errors_into_profile_errors(natives, tmp_path):
    from bdlz_tpu.lz import profile as jprof

    from bdlz_tpu_torch.lz import profile as tprof

    p = tmp_path / "bad.csv"
    p.write_text(MALFORMED_CSVS["short_row"])
    with pytest.raises(jprof.ProfileError) as j:
        jprof.load_profile_csv(str(p))
    with pytest.raises(tprof.ProfileError) as t:
        tprof.load_profile_csv(str(p))
    assert str(t.value) == str(j.value)


# ---- reference ratios --------------------------------------------------

@pytest.fixture(scope="module")
def audit32():
    from bdlz_tpu.validation import build_audit_population as jpop

    from bdlz_tpu_torch.validation import build_audit_population as tpop

    jb, tb = jcfg({"P_chi_to_B": 0.15}), tcfg({"P_chi_to_B": 0.15})
    js = jstatic(jb)._replace(n_y=2000)
    ts = tstatic(tb)._replace(n_y=2000)
    return jpop(jb, 32).grid, js, tpop(tb, 32).grid, ts


def test_reference_ratios_match_jax_on_the_audit_population(audit32):
    from bdlz_tpu.validation import reference_ratios as jref

    from bdlz_tpu_torch.validation import reference_ratios as tref

    jgrid, js, tgrid, ts = audit32
    rj, rt = jref(jgrid, js), tref(tgrid, ts)
    nz = rj != 0.0
    res = float(np.max(np.abs(rt[nz] / rj[nz] - 1.0)))
    print(f"RESIDUAL reference_ratios audit32 n_y=2000 max_rel={res:.3e}")
    assert np.array_equal(rj == 0.0, rt == 0.0)
    assert res <= 1e-11


def test_the_refcache_key_is_jax_s(audit32):
    from bdlz_tpu.provenance import refcache_identity as jid
    from bdlz_tpu.provenance import reference_code_fingerprint as jfp

    from bdlz_tpu_torch.provenance import refcache_identity as tid
    from bdlz_tpu_torch.provenance import reference_code_fingerprint as tfp

    jgrid, js, tgrid, ts = audit32
    for n_y in (None, 2000, 8000):
        assert (tid(tgrid, ts, n_y, fingerprint=jfp()).digest(24)
                == jid(jgrid, js, n_y).digest(24))
    # by default the port keys its own reference code
    assert tid(tgrid, ts, None).parts[-1] == ("text", tfp())


def test_reference_ratios_cached_hits_on_the_second_call(audit32, tmp_path):
    from bdlz_tpu_torch.validation import reference_ratios_cached

    _, _, tgrid, ts = audit32
    sub = type(tgrid)(*(np.asarray(f)[:4] for f in tgrid))
    stats = {}
    first = reference_ratios_cached(sub, ts, cache_dir=str(tmp_path / "rc"), stats=stats)
    assert stats == {"cache_hit": False}
    again = reference_ratios_cached(sub, ts, cache_dir=str(tmp_path / "rc"), stats=stats)
    assert stats == {"cache_hit": True} and again.tobytes() == first.tobytes()
    assert reference_ratios_cached(sub, ts, cache_dir="").tobytes() == first.tobytes()


def test_engine_population_max_rel_scores_the_tabulated_engine(audit32):
    from bdlz_tpu_torch.ops.kjma_table import make_f_table, table_to_device
    from bdlz_tpu_torch.validation import engine_population_max_rel, reference_ratios

    _, _, tgrid, ts = audit32
    sub = type(tgrid)(*(np.asarray(f)[:8] for f in tgrid))
    ts = ts._replace(quad_panel_gl=False)
    ref = reference_ratios(sub, ts)
    table = table_to_device(make_f_table(0.34), "cpu")
    err = engine_population_max_rel(sub, ref, ts, table, impl="tabulated", n_y=2000,
                                    device="cpu")
    print(f"RESIDUAL engine_population_max_rel tabulated vs reference: {err:.3e}")
    assert 0.0 <= err <= 1e-6


# ---- sweep CLI: --profile-dir, --debug-nans, --sanitize ----------------

def _sweep(argv, capsys):
    from bdlz_tpu_torch.sweep_cli import main

    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def cfg_path(tmp_path):
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(ARCHIVED))
    return str(p)


_VOLATILE = ("seconds", "points_per_sec")


def test_profile_dir_writes_one_trace_per_chunk(cfg_path, tmp_path, capsys):
    d = tmp_path / "traces"
    base = ["--config", cfg_path, "--axis", "m_chi_GeV=0.5,1,2,4", "--chunk", "2",
            "--n-y", "2000", "--quad", "off", "--device", "cpu"]
    traced = _sweep(base + ["--profile-dir", str(d)], capsys)
    traces = sorted(p.name for p in d.iterdir())
    assert traces == ["trace_00000.json"]
    events = json.loads((d / traces[0]).read_text())["traceEvents"]
    names = [e.get("name") for e in events if e.get("cat") == "user_annotation"]
    for name in ("sweep", "sweep.grid", "f_table", "engine.build", "sweep.loop",
                 "sweep.copy_out"):
        assert names.count(name) == 1, name
    for name in ("chunk.ship", "chunk.step", "chunk.wait", "chunk.finish"):
        assert names.count(name) == 2, name  # 4 points in chunks of 2
    plain = _sweep(base, capsys)
    assert {k: v for k, v in traced.items() if k not in _VOLATILE} == \
           {k: v for k, v in plain.items() if k not in _VOLATILE}


def test_debug_nans_aborts_on_a_nan_point_and_names_the_op(cfg_path, capsys):
    argv = ["--config", cfg_path, "--axis", "P_chi_to_B=0.1,nan", "--n-y", "2000",
            "--quad", "off", "--device", "cpu"]
    plain = _sweep(argv, capsys)
    assert plain["n_failed"] == 1 and plain["n_quarantined"] == 0
    with pytest.raises(FloatingPointError, match="NaN produced by torch op '"):
        _sweep(argv + ["--debug-nans"], capsys)


def test_debug_nans_passes_a_clean_grid_on_both_engines(cfg_path, capsys):
    for impl in ("tabulated", "kernel"):
        argv = ["--config", cfg_path, "--axis", "m_chi_GeV=geom:0.3:30:4", "--axis",
                "T_p_GeV=60,200", "--n-y", "2000", "--impl", impl, "--device", "cpu"]
        plain = _sweep(argv, capsys)
        checked = _sweep(argv + ["--debug-nans"], capsys)
        enable_nan_debugging(False)
        assert checked["n_failed"] == 0
        assert checked["closest_to_planck"] == plain["closest_to_planck"]


def test_sweep_sanitize_keeps_failed_points_in_band(cfg_path, capsys):
    argv = ["--config", cfg_path, "--axis", "P_chi_to_B=0.1,nan", "--n-y", "2000",
            "--quad", "off", "--device", "cpu"]
    plain = _sweep(argv, capsys)
    sanitized = _sweep(argv + ["--sanitize"], capsys)
    assert {k: v for k, v in sanitized.items() if k not in _VOLATILE} == \
           {k: v for k, v in plain.items() if k not in _VOLATILE}
