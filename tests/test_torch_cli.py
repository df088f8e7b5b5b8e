"""The port's single-point CLI, sweep CLI flags, template, identity and
analysis helpers against the JAX package, on the CPU.

The archived config prints byte-identical stdout through both CLIs, and
``yields_out.json`` has the same keys in the same order with values
within 1e-12 rel.  Flags the port does not have yet are refused.
"""
import json

import numpy as np
import pytest
import torch

from bdlz_tpu import config as jc
from bdlz_tpu.analysis import planck_comparison as j_planck
from bdlz_tpu.cli import main as j_main
from bdlz_tpu.cli import run_point as j_run_point

from bdlz_tpu_torch import config as tc
from bdlz_tpu_torch.analysis import (
    effective_probability,
    planck_comparison,
    settling_factor,
)
from bdlz_tpu_torch.cli import DEFERRED_FLAGS as CLI_DEFERRED
from bdlz_tpu_torch.cli import main as t_main
from bdlz_tpu_torch.sweep_cli import main as t_sweep_main
from bdlz_tpu_torch.utils.io import atomic_write_json

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
STIFF = dict(ARCHIVED, Gamma_wash_over_H=0.01, T_min_over_Tp=0.05)


def _run(main, argv, workdir, capsys, monkeypatch):
    """Run a CLI in ``workdir``; returns (stdout, yields_out.json text)."""
    monkeypatch.chdir(workdir)
    capsys.readouterr()
    main(argv)
    out = capsys.readouterr().out
    f = workdir / "yields_out.json"
    return out, (f.read_text() if f.exists() else None)


def _both(tmp_path, capsys, monkeypatch, cfg, flags, j_flags=()):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    j = _run(j_main, ["--config", str(path), *flags, *j_flags], tmp_path / "j", capsys,
             monkeypatch)
    t = _run(t_main, ["--config", str(path), *flags, "--device", "cpu"], tmp_path / "t",
             capsys, monkeypatch)
    return j, t


def _same_payload(j_text, t_text, rtol):
    j, t = json.loads(j_text), json.loads(t_text)
    assert list(t) == list(j) and list(t["inputs"]) == list(j["inputs"])
    assert t["inputs"] == j["inputs"]
    assert list(t["final"]) == list(j["final"])
    for k, v in j["final"].items():
        assert t["final"][k] == pytest.approx(v, rel=rtol, abs=0.0), k


@pytest.mark.parametrize("flags", [[], ["--diagnostics", "--planck"], ["--quad", "on"],
                                   ["--quad", "off", "--diagnostics"]])
def test_stdout_and_yields_out_match_the_jax_cli(tmp_path, capsys, monkeypatch, flags):
    (j_out, j_file), (t_out, t_file) = _both(tmp_path, capsys, monkeypatch, ARCHIVED, flags)
    assert t_out == j_out
    assert "DM/B ratio= 5.68893\n" in t_out and "Wrote yields_out.json\n" in t_out
    _same_payload(j_file, t_file, 1e-12)


def test_archived_ratio_in_yields_out(tmp_path, capsys, monkeypatch):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(ARCHIVED))
    _, text = _run(t_main, ["--config", str(path), "--device", "cpu"], tmp_path, capsys,
                   monkeypatch)
    final = json.loads(text)["final"]
    assert final["DM_over_B"] == pytest.approx(5.688926334903014, rel=1e-12)
    assert final["Y_B"] == pytest.approx(8.720885362714675e-11, rel=1e-12)


def test_stiff_config_matches_the_jax_esdirk_cli(tmp_path, capsys, monkeypatch, jit_warmup):
    """The stiff branch (per-point ESDIRK) against the JAX CLI on its JAX
    backend, which runs the same engine: byte-equal stdout, ≤1e-8 rel
    (the stiff parity bound; measured 8.9e-15)."""
    jit_warmup(j_run_point, jc.config_from_dict(STIFF), STIFF["P_chi_to_B"], "jax")
    (j_out, j_file), (t_out, t_file) = _both(tmp_path, capsys, monkeypatch, STIFF, [],
                                             ["--backend", "jax"])
    assert t_out == j_out and "[warn]" not in t_out
    j, t = json.loads(j_file), json.loads(t_file)
    for k, v in j["final"].items():
        assert t["final"][k] == pytest.approx(v, rel=1e-8), k
    assert np.isfinite(t["final"]["DM_over_B"])


@pytest.mark.parametrize("extensions", [False, True])
def test_write_template_is_byte_identical(tmp_path, capsys, monkeypatch, extensions):
    flags = ["--write-template"] + (["--template-extensions"] if extensions else [])
    monkeypatch.chdir(tmp_path)
    j_main(flags + ["--config", "j.json"])
    t_main(flags + ["--config", "t.json"])
    out = capsys.readouterr().out
    assert "Wrote template config to t.json" in out
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    if not extensions:
        assert list(json.loads((tmp_path / "t.json").read_text())) == list(tc.REFERENCE_KEYS)


def test_missing_config_prints_the_reference_error(capsys):
    t_main([])
    assert capsys.readouterr().out == "ERROR: --config is required (or use --write-template).\n"


@pytest.mark.parametrize("flag", sorted(CLI_DEFERRED))
def test_cli_refuses_deferred_flags(flag, tmp_path, capsys):
    takes_value, item = CLI_DEFERRED[flag]
    argv = ["--config", str(tmp_path / "x.json"), flag] + (["x"] if takes_value else [])
    with pytest.raises(SystemExit) as exc:
        t_main(argv)
    assert exc.value.code == 2
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--mesh-sp", "--multihost"])
def test_sweep_cli_takes_the_mesh_flags(flag, tmp_path, capsys, monkeypatch):
    """``--mesh-sp 2`` over eight host members and ``--multihost`` with no
    process group configured run as the JAX CLI runs them (its eight
    forced host devices): the same summary, the same results."""
    from bdlz_tpu.sweep_cli import main as j_sweep_main

    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(ARCHIVED))
    extra = ["--mesh-sp", "2"] if flag == "--mesh-sp" else ["--multihost"]
    argv = ["--config", str(path), "--axis", "m_chi_GeV=0.5,0.95,2.0", "--n-y", "2000",
            "--quad", "off", "--chunk", "5", *extra]
    j_sweep_main(argv + ["--out", str(tmp_path / "j")])
    j_sum = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    t_sweep_main(argv + ["--out", str(tmp_path / "t"), "--device", ",".join(["cpu"] * 8)])
    t_sum = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("seconds", "points_per_sec", "out_dir"):
        j_sum.pop(k), t_sum.pop(k)
    ref, got = j_sum.pop("closest_to_planck"), t_sum.pop("closest_to_planck")
    assert t_sum == j_sum
    assert got["index"] == ref["index"] and got["params"] == ref["params"]
    assert got["DM_over_B"] == pytest.approx(ref["DM_over_B"], rel=1e-12)
    with open(tmp_path / "j" / "manifest.json") as f, open(tmp_path / "t" / "manifest.json") as g:
        j_man, t_man = json.load(f), json.load(g)
    assert (t_man["hash"], t_man["chunk_size"]) == (j_man["hash"], j_man["chunk_size"]) == (
        j_man["hash"], 8)
    with np.load(tmp_path / "j" / "chunk_00000.npz") as j, \
            np.load(tmp_path / "t" / "chunk_00000.npz") as t:
        assert sorted(t.files) == sorted(j.files)
        rel = np.max(np.abs(t["DM_over_B"] / j["DM_over_B"] - 1.0))
        assert rel <= 1e-12


def test_cli_without_a_card_raises(tmp_path, capsys, monkeypatch):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(ARCHIVED))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_main(["--config", str(path)])


def test_config_backend_key_is_ignored_and_validation_is_strict(tmp_path, capsys,
                                                               monkeypatch):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(dict(ARCHIVED, backend="numpy")))
    out, _ = _run(t_main, ["--config", str(path), "--device", "cpu"], tmp_path, capsys,
                  monkeypatch)
    assert "DM/B ratio= 5.68893" in out
    # an unknown regime on the ODE path: the NumPy backend admits it, the
    # port (strict, as on a device backend) does not
    path.write_text(json.dumps(dict(STIFF, regime="auto", backend="numpy")))
    with pytest.raises(tc.ConfigError):
        t_main(["--config", str(path), "--device", "cpu"])


@pytest.mark.parametrize("quad,want", [("auto", "panel_gl"), ("off", "trap"),
                                       ("on", "panel_gl")])
def test_sweep_cli_quad_flag(tmp_path, capsys, quad, want):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(ARCHIVED))
    t_sweep_main(["--config", str(path), "--axis", "m_chi_GeV=geom:0.1:2:4", "--chunk", "4",
                  "--impl", "tabulated", "--quad", quad, "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["quad_impl"] == want
    assert summary["n_quad_nodes"] == (560 if want == "panel_gl" else 8000)


def test_sweep_cli_runs_the_stiff_engine(tmp_path, capsys):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(dict(STIFF, T_min_over_Tp=0.2)))
    t_sweep_main(["--config", str(path), "--axis", "Gamma_wash_over_H=0.01,0.05",
                  "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_points"] == 2 and summary["n_failed"] == 0
    assert summary["quad_impl"] is None


@pytest.mark.parametrize("key", ["retry_enabled", "cache_enabled", "fault_injection"])
def test_sweep_cli_refuses_unported_config_planes(tmp_path, capsys, monkeypatch, key):
    """The three planes are ported now: set to true, each is accepted and
    acts as in the JAX CLI (fault injection needs its plan)."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    over = {key: True}
    if key == "fault_injection":
        over["fault_plan"] = json.dumps([{"site": "step", "kind": "nan", "point": 1}])
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(dict(ARCHIVED, **over)))
    argv = ["--config", str(path), "--axis", "m_chi_GeV=geom:0.5:2:4", "--chunk", "2",
            "--n-y", "2000", "--device", "cpu"]
    t_sweep_main(argv)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_points"] == 4
    assert summary["n_failed"] == (1 if key == "fault_injection" else 0)
    if key == "cache_enabled":
        assert (tmp_path / "xdg" / "bdlz_store" / "sweep_chunk").is_dir()
        t_sweep_main(argv)
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["n_failed"] == 0


def _sweep_cli_argv(path, out, events, impl_flags):
    return ["--config", str(path), "--axis", "m_chi_GeV=geom:0.3:3:8",
            "--axis", "T_p_GeV=geom:50:200:4", "--chunk", "8", "--n-y", "2000",
            "--out", str(out), "--events", str(events), *impl_flags]


def test_sweep_cli_out_resumes_and_events_match_the_jax_cli(tmp_path, capsys):
    """``--out`` and ``--events`` through both CLIs on the same sweep: the
    same summary, the same events apart from ``ts`` and ``seconds``; a
    rerun of the port's CLI resumes every chunk, and so does the JAX CLI
    on the port's directory."""
    from bdlz_tpu.sweep_cli import main as j_sweep_main

    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(ARCHIVED))
    flags = ["--impl", "tabulated", "--quad", "off"]
    j_sweep_main(_sweep_cli_argv(path, tmp_path / "j", tmp_path / "j.jsonl", flags))
    j_sum = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    t_sweep_main(_sweep_cli_argv(path, tmp_path / "t", tmp_path / "t.jsonl",
                                 flags + ["--device", "cpu"]))
    t_sum = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    def events(name):
        return [{k: v for k, v in json.loads(line).items() if k not in ("ts", "seconds")}
                for line in (tmp_path / name).read_text().splitlines()]

    assert events("t.jsonl") == events("j.jsonl")
    assert [e["event"] for e in events("t.jsonl")] == ["sweep_start"] + ["chunk_done"] * 4
    for k in ("n_points", "n_failed", "n_quarantined", "n_retries", "resumed_chunks",
              "quad_impl", "n_quad_nodes"):
        assert t_sum[k] == j_sum[k], k
    assert t_sum["out_dir"] == str(tmp_path / "t")
    assert t_sum["closest_to_planck"]["index"] == j_sum["closest_to_planck"]["index"]
    t_sweep_main(_sweep_cli_argv(path, tmp_path / "t", tmp_path / "t2.jsonl",
                                 flags + ["--device", "cpu"]))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["resumed_chunks"] == 4
    j_sweep_main(_sweep_cli_argv(path, tmp_path / "t", tmp_path / "j2.jsonl", flags))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["resumed_chunks"] == 4


@pytest.mark.parametrize("over", [{}, {"n_y": 4000, "ode_rtol": 1e-9},
                                  {"retry_enabled": True, "n_replicas": 2,
                                   "quad_panel_gl": True, "m_B_GeV": 2.0}])
def test_config_identity_dict_matches_jax(over):
    d = dict(ARCHIVED, **over)
    assert tc.config_identity_dict(tc.config_from_dict(d)) == jc.config_identity_dict(
        jc.config_from_dict(d))
    assert list(tc.config_identity_dict(tc.config_from_dict(d))) == list(
        jc.config_identity_dict(jc.config_from_dict(d)))


def test_defaults_and_reference_keys_match_jax():
    assert tc.REFERENCE_KEYS == jc.REFERENCE_KEYS
    assert list(tc.default_config().items()) == list(jc.default_config().items())


@pytest.mark.parametrize("ratio", [5.688926334903014, 0.0, np.array([1.0, 5.357, np.nan])])
def test_planck_comparison_matches_jax(ratio):
    got, ref = planck_comparison(ratio, 0.149), j_planck(ratio, 0.149)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))
    t = torch.tensor([5.688926334903014], dtype=torch.float64)
    assert settling_factor(t).item() == pytest.approx(5.357 / 5.688926334903014, rel=1e-15)
    assert effective_probability(0.15, t).item() == pytest.approx(
        0.15 * 5.688926334903014 / 5.357, rel=1e-15)


def test_atomic_write_json_replaces_whole_files(tmp_path):
    p = tmp_path / "m.json"
    atomic_write_json(str(p), {"a": 1}, indent=2)
    atomic_write_json(str(p), {"b": [1, 2]}, durable=True)
    assert json.loads(p.read_text()) == {"b": [1, 2]}
    assert [f.name for f in tmp_path.iterdir()] == ["m.json"]
    with pytest.raises(TypeError):
        atomic_write_json(str(p), {"c": object()})
    assert json.loads(p.read_text()) == {"b": [1, 2]}
    assert [f.name for f in tmp_path.iterdir()] == ["m.json"]


def test_yields_out_payload_lists_changed_extension_keys():
    from bdlz_tpu.models.yields_pipeline import YieldsResult as JResult
    from bdlz_tpu.utils.io import yields_out_payload as j_payload

    from bdlz_tpu_torch.models.yields_pipeline import YieldsResult
    from bdlz_tpu_torch.utils.io import yields_out_payload

    d = dict(ARCHIVED, n_y=4000, quad_panel_gl=True)
    vals = [1e-10, 4.9e-10, 1e-28, 2e-27, 5.7]
    t = yields_out_payload(tc.config_from_dict(d), 0.149, YieldsResult(
        *(torch.tensor([v], dtype=torch.float64) for v in vals)))
    j = j_payload(jc.config_from_dict(d), np.float64(0.149), JResult(*map(np.float64, vals)))
    assert json.dumps(t) == json.dumps(j)


@pytest.mark.parametrize("over", [{}, {"Gamma_wash_over_H": 0.01}, {"sigma_v_chi_GeV_m2": 1e-12},
                                  {"deplete_DM_from_source": True}, {"regime": "thermal"}])
def test_can_use_quadrature_matches_jax(over):
    from bdlz_tpu.cli import can_use_quadrature as j_can

    from bdlz_tpu_torch.cli import can_use_quadrature

    d = dict(ARCHIVED, **over)
    assert can_use_quadrature(tc.config_from_dict(d)) is j_can(jc.config_from_dict(d))
