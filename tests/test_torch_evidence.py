"""The port's evidence tools (``scripts/torch_*.py``) on the CPU, each
against the JAX package on the same inputs.

* ``torch_accuracy_audit.py`` at 8 points and n_y 2000: the artifact has
  the keys of the one JAX's tool writes on the same arguments, plus
  ``device`` and the ``kernel`` section; JAX's stratum counts; a
  reference ≤1e-13 from JAX's NumPy ``reference_ratios``, ≤1e-6 from it
  in both sections; each section's error figures and the five worst
  points' errors within ``FIGURE_ATOL`` of JAX's tabulated ones, the
  worst points in JAX's order; and ``f_table_values`` 0.
* ``torch_ny_convergence.py`` at n_y 2000 and 4000 with two CPU sp
  members: each Y_B ≤1e-13 from JAX's ``point_yields_fast``, the sp row
  ≤1e-12 from the single-device row.
* ``torch_impl_shootout.py`` on a 16-point grid with an 8-point gate:
  all five engines, each ≤1e-9 from the reference, and its sample and
  gate figures within ``FIGURE_ATOL`` of JAX's tabulated engine's on the
  same points; exit 1 when one engine fails.
* ``torch_lz_scale_bench.py`` at 10,001 rows and 4 speeds: P ≤1e-10
  from JAX's ``probabilities_for_points`` (``tests/test_torch_lz.py``'s
  tolerance for the coherent estimator).
* ``torch_weak_scaling.py`` at 1 and 2 CPU members of 16 points each:
  JAX's row keys and no failed point.

``FIGURE_ATOL`` (2e-15, about nine ulps of a ratio near 1) bounds the gap
between two relative errors of ~1e-11: the two packages' DM/B and
references differ in the last bits, so the figures cannot agree to a
fraction of themselves, but an engine in f32 or one that lost a term of
1e-13 would miss it.

Each tool is imported from its file and its ``main(argv)`` called with
``--device cpu``; the reference cache lives in the test's directory.
``pytest -s`` prints ``RESIDUAL`` lines.
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest

from bdlz_tpu import config as jc
from bdlz_tpu import validation as jv

from bdlz_tpu_torch import config as tc
from bdlz_tpu_torch import validation as tv

REPO = pathlib.Path(__file__).resolve().parent.parent
FIGURE_ATOL = 2e-15
BENCH_POINT = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}


def tool(name, prefix="torch_"):
    path = REPO / "scripts" / f"{prefix}{name}.py"
    spec = importlib.util.spec_from_file_location(f"{prefix}{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def json_rows(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def record(name, value):
    print(f"RESIDUAL {name} {value:.3e}")
    return value


@pytest.fixture(autouse=True)
def _ref_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("BDLZ_REF_CACHE_DIR", str(tmp_path / "refcache"))


def test_accuracy_audit_matches_jax_artifact_and_reference(tmp_path, capsys, monkeypatch):
    import bdlz_tpu.utils.platform as jplatform

    out, jax_out = tmp_path / "audit.json", tmp_path / "jax_audit.json"
    assert tool("accuracy_audit").main(["--points", "8", "--n-y", "2000", "--device", "cpu",
                                        "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    assert json_rows(capsys.readouterr().out)[0] == {
        k: v for k, v in art.items() if k != "worst_points"}
    # JAX's tool on the same arguments, in this process (already on the CPU)
    monkeypatch.setattr(jplatform, "ensure_live_backend", lambda *a, **k: True)
    monkeypatch.setattr("sys.argv", ["accuracy_audit.py", "--points", "8", "--n-y", "2000",
                                     "--out", str(jax_out)])
    tool("accuracy_audit", prefix="").main()
    jax_art = json.loads(jax_out.read_text())
    assert jax_art["population"] == art["population"]
    assert set(art) - set(jax_art) == {"device", "kernel"} and set(jax_art) <= set(art)
    assert list(art["stage_attribution_worst_point"]) == list(
        jax_art["stage_attribution_worst_point"])
    assert [set(w) for w in art["worst_points"]] == [set(w) for w in jax_art["worst_points"]]

    pop_j = jv.build_audit_population(jc.config_from_dict(BENCH_POINT), 8)
    assert art["population"] == pop_j.counts and art["n_points"] == 8
    base = tc.config_from_dict(BENCH_POINT)
    stats = {}
    ref = tv.reference_ratios_cached(tv.build_audit_population(base, 8).grid,
                                     tc.static_choices_from_config(base), n_y=2000, stats=stats)
    assert stats["cache_hit"]  # the reference the tool measured against
    ref_j = jv.reference_ratios(pop_j.grid, jc.static_choices_from_config(
        jc.config_from_dict(BENCH_POINT)), n_y=2000)
    assert record("audit_reference_vs_jax", np.max(np.abs(ref / ref_j - 1.0))) <= 1e-13
    assert art["max_rel_err"] <= 1e-6 and art["contract_1e-6_ok"]
    assert art["kernel"]["max_rel_err"] <= 1e-6 and art["kernel"]["contract_1e-6_ok"]
    assert (art["kernel"]["impl"], art["kernel"]["launches"]) == ("plain", 0)
    assert art["stage_attribution_worst_point"]["f_table_values"] == 0.0
    assert (art["platform"], art["device"]) == ("cpu", "cpu")
    # the numbers JAX's run produced, beside the port's (no pallas section
    # on the CPU: P1's figures are held against JAX's tabulated ones)
    gaps = [abs(art[k] - jax_art[k]) for k in FIGURES]
    gaps += [abs(art["kernel"][k] - jax_art[k]) for k in FIGURES if k in art["kernel"]]
    for w, wj in zip(art["worst_points"], jax_art["worst_points"], strict=True):
        assert {k: v for k, v in w.items() if k != "rel_err"} == {
            k: v for k, v in wj.items() if k != "rel_err"}
        gaps.append(abs(w["rel_err"] - wj["rel_err"]))
    assert record("audit_figures_vs_jax", max(gaps)) <= FIGURE_ATOL


FIGURES = ("max_rel_err", "p99_rel_err", "p90_rel_err", "median_rel_err")


def test_the_audit_refuses_to_write_the_jax_artifact():
    with pytest.raises(SystemExit):
        tool("accuracy_audit").main(["--device", "cpu", "--out", "ACCURACY_AUDIT.json"])


def test_ny_convergence_matches_jax(capsys, jit_warmup):
    import jax.numpy as jnp

    from bdlz_tpu.models.yields_pipeline import point_yields_fast as j_fast
    from bdlz_tpu.ops.kjma_table import make_f_table as j_table

    assert tool("ny_convergence").main(["--levels", "2000,4000", "--sp", "2",
                                        "--device", "cpu"]) == 0
    rows = json_rows(capsys.readouterr().out)
    assert [r["n_y"] for r in rows] == [2000, 4000, 4000] and rows[2]["engine"] == "gridshard(sp=2)"
    base = jc.config_from_dict(BENCH_POINT)
    static, table = jc.static_choices_from_config(base), j_table(base.I_p, jnp)
    pp = jc.point_params_from_config(base, base.P_chi_to_B)
    pp = type(pp)(*(jnp.asarray(f) for f in pp))
    jit_warmup(j_fast, pp, static, table, jnp, n_y=2000)
    for r in rows[:2]:
        ref = float(j_fast(pp, static, table, jnp, n_y=r["n_y"]).Y_B)
        assert record(f"ny_convergence_YB[{r['n_y']}]", abs(r["Y_B"] / ref - 1.0)) <= 1e-13
    assert rows[0]["rel_vs_finest"] == abs(rows[0]["Y_B"] / rows[1]["Y_B"] - 1.0)
    assert record("ny_convergence_sp", rows[2]["rel_vs_single_device"]) <= 1e-12
    assert all(r["device"] == "cpu" for r in rows)


def _jax_tabulated_shootout_figures():
    """JAX's tabulated engine on the shoot-out's 16-point grid: the worst
    error of the 8-point sample and of the 8-point gate (seed 1)."""
    import jax.numpy as jnp

    from bdlz_tpu.ops.kjma_table import make_f_table as j_table
    from bdlz_tpu.parallel.sweep import build_grid, make_chunk_runner

    base = jc.config_from_dict(BENCH_POINT)
    static, table = jc.static_choices_from_config(base), j_table(base.I_p, jnp)
    axes = {"m_chi_GeV": np.geomspace(0.1, 10.0, 2), "T_p_GeV": np.geomspace(30.0, 300.0, 2),
            "P_chi_to_B": np.linspace(0.02, 0.9, 2), "v_w": np.linspace(0.05, 0.9, 2)}
    grid = build_grid(base, axes)
    sample = np.unique(np.random.default_rng(0).choice(8, size=8, replace=False))
    ref = jv.reference_ratios(type(grid)(*(np.asarray(f)[sample] for f in grid)), static)
    run_chunk, _ = make_chunk_runner(grid, 8, static, None, None, table, impl="tabulated",
                                     n_y=2000)
    got = np.asarray(run_chunk(0, 8))[sample]
    gate = jv.build_audit_population(base, 8, seed=1)
    gate_max = jv.engine_population_max_rel(
        gate.grid, jv.reference_ratios(gate.grid, static, n_y=2000), static, None, None,
        table, impl="tabulated", n_y=2000)
    return float(np.max(np.abs(got / ref - 1.0))), gate_max


def test_impl_shootout_runs_every_engine_within_the_reference(capsys):
    assert tool("impl_shootout").main(["--points", "16", "--chunk", "8", "--n-y", "2000",
                                       "--gate-points", "8", "--device", "cpu"]) == 0
    rows = json_rows(capsys.readouterr().out)
    sample_j, gate_j = _jax_tabulated_shootout_figures()
    assert [r["engine"] for r in rows] == ["tabulated", "kernel", "kernel+stream", "kernel+fuse",
                                           "kernel+fuse+stream"]
    kernels = [r.get("kernel") for r in rows]
    assert kernels == [None, "point_reduce", "point_stream", "point_fused_reduce",
                       "point_fused_stream"]
    for r in rows:
        assert "error" not in r and "gate_error" not in r, r
        assert r["n_points"] == 16 and r["n_evaluated"] == 16 and r["device"] == "cpu"
        assert record(f"shootout[{r['engine']}]", r["max_rel_err_vs_reference"]) <= 1e-9
        assert record(f"shootout_gate[{r['engine']}]", r["gate_max_rel_err"]) <= 1e-9
        assert record(f"shootout_vs_jax[{r['engine']}]", max(
            abs(r["max_rel_err_vs_reference"] - sample_j),
            abs(r["gate_max_rel_err"] - gate_j))) <= FIGURE_ATOL


def test_impl_shootout_exits_non_zero_on_a_failed_engine(capsys, monkeypatch):
    from bdlz_tpu_torch.parallel import sweep as ts

    real = ts.make_chunk_runner

    def runner(*a, fuse_exp=False, reduce=True, **kw):
        if fuse_exp and not reduce:
            raise RuntimeError("the P4 launch was refused")
        return real(*a, fuse_exp=fuse_exp, reduce=reduce, **kw)

    monkeypatch.setattr(ts, "make_chunk_runner", runner)
    assert tool("impl_shootout").main(["--points", "16", "--chunk", "8", "--n-y", "2000",
                                       "--gate-points", "0", "--device", "cpu"]) == 1
    rows = json_rows(capsys.readouterr().out)
    assert [("error" in r) for r in rows] == [False] * 4 + [True]
    assert rows[4]["engine"] == "kernel+fuse+stream"
    assert rows[4]["error"] == "RuntimeError: the P4 launch was refused"


def test_lz_scale_bench_matches_jax(capsys):
    from bdlz_tpu.lz.profile import BounceProfile
    from bdlz_tpu.lz.sweep_bridge import probabilities_for_points as j_probs

    assert tool("lz_scale_bench").main(["--rows", "10001", "--speeds", "4", "--table-n", "16",
                                        "--numpy-compare", "--device", "cpu"]) == 0
    parse, coherent, ptable = json_rows(capsys.readouterr().out)
    assert (parse["phase"], parse["rows"], coherent["phase"], ptable["phase"]) == (
        "parse", 10001, "coherent", "ptable")
    assert coherent["segments"] == ptable["segments"] == 10000 and ptable["nodes"] == 16
    assert coherent["finite"] and ptable["finite"]
    assert 0.0 <= ptable["P_range"][0] <= ptable["P_range"][1] <= 1.0
    xi = np.linspace(-300.0, 300.0, 10001)
    ref = j_probs(BounceProfile(xi=xi, delta=-0.08 * np.tanh(xi / 4.0), mix=np.full(10001, 0.02)),
                  np.linspace(0.05, 0.9, 4), method="coherent")
    got = np.asarray(coherent["P"])
    assert record("lz_scale_P", np.max(np.abs(got / ref - 1.0))) <= 1e-10
    assert all(r["device_peak_bytes"] is None and r["device"] == "cpu"
               for r in (parse, coherent, ptable))


def test_weak_scaling_rows_carry_jax_keys_and_no_failed_point(capsys):
    assert tool("weak_scaling").main(["--counts", "1,2", "--points-per-member", "16",
                                      "--device", "cpu"]) == 0
    rows = json_rows(capsys.readouterr().out)
    jax_keys = {"n_devices", "n_points", "seconds", "points_per_sec_total"}
    assert [r["n_devices"] for r in rows] == [1, 2]
    for r, n_points in zip(rows, (16, 6 * 5)):
        assert jax_keys <= set(r) and r["n_points"] == n_points and r["n_failed"] == 0
        assert r["members"] == ["cpu"] * r["n_devices"] and r["device"] == "cpu"
    assert rows[0]["vs_one_member"] == 1.0
    assert rows[1]["vs_one_member"] == rows[1]["points_per_sec_total"] / rows[0][
        "points_per_sec_total"]
