"""The port's emulator against the JAX package, on the CPU.

* An artifact the JAX package built (``tiny_emulator``) loads in the
  port with its content hash verified; the port's values are ≤1e-14 rel
  from JAX's query on the served ratio (measured 4.4e-16), bit for bit
  the JAX interpolation core's arithmetic, and its domain and
  predicted-error answers are equal.
* Tampered, NaN, skewed-schema and changed-knob artifacts are refused by
  both packages with the same error class and message.
* The port's build of the same box: the same nodes bit for bit, the same
  rounds, exact-evaluation count and identity, values ≤1e-12 rel
  (measured ≤4.5e-16); JAX loads what the port saved.
* The exact evaluator quarantines a dead probe chunk as JAX's does.
* The Planck-weighted and the Fisher-steered builds of the same box
  match JAX's: nodes, rounds, gradient evaluations and identity equal,
  values ≤1e-12 rel.
* Option pairings both packages refuse (a traffic signal without a
  snapshot, an elastic build without a store) give JAX's message; without
  a card nothing runs unless the CPU is asked for.

``pytest -s`` prints the ``RESIDUAL`` lines.
"""
import json
import shutil

import numpy as np
import pytest
import torch

from bdlz_tpu import config as jc
from bdlz_tpu import emulator as je
from bdlz_tpu import faults as jf
from bdlz_tpu.utils.retry import RetryPolicy as JRP

from bdlz_tpu_torch import config as tc
from bdlz_tpu_torch import emulator as te
from bdlz_tpu_torch import faults as tf
from bdlz_tpu_torch.utils.retry import RetryPolicy as TRP

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
# tests/conftest.py's tiny_emulator box and knobs
TINY = {"m_chi_GeV": (0.9, 1.1, 3, "log"), "T_p_GeV": (90.0, 110.0, 3, "log"),
        "v_w": (0.25, 0.35, 3, "lin")}
TINY_KW = dict(rtol=1e-4, n_probe=8, n_holdout=24, max_rounds=6, n_y=400, chunk_size=64,
               require_converged=True)
QUERY_RTOL, BUILD_RTOL = 1e-14, 1e-12


def _queries(n=2000, seed=1, pad=0.05):
    rng = np.random.default_rng(seed)
    cols = []
    for lo, hi, _, _ in TINY.values():
        span = hi - lo
        cols.append(rng.uniform(lo - pad * span, hi + pad * span, n))
    return np.stack(cols, axis=1)


@pytest.mark.parametrize("field", list(te.FIELDS))
def test_jax_artifact_loads_and_queries_match(tiny_emulator, field):
    """The port's query against the JAX package's interpolation core run
    with NumPy (``interp_log_fields(..., np)``, the arithmetic the jitted
    kernel traces): ≤2 ulps (measured bit for bit in log10).  Against the
    jitted kernel itself: ≤1e-14 rel on the served ratio; the densities
    (log10 ≈ −28) differ by XLA's rounding of that sum, up to ~1e-14 in
    log10 (2.5e-14 rel), so ≤1e-13 there."""
    from bdlz_tpu.emulator.grid import interp_log_fields

    _, out_dir, j_art, _ = tiny_emulator
    t_art = te.load_artifact(out_dir)
    assert t_art.content_hash == j_art.content_hash == json.load(
        open(f"{out_dir}/manifest.json"))["hash"]
    assert t_art.identity == j_art.identity and t_art.axis_scales == j_art.axis_scales
    th = _queries()
    got = te.make_query_fn(t_art, field, device="cpu")(th).numpy()
    ref = np.asarray(je.make_query_fn(j_art, field)(th))
    logv = {field: np.log10(j_art.values[field])}
    core = np.array([10.0 ** interp_log_fields(np.clip(x, *j_art.hull), j_art.axis_nodes,
                                               j_art.axis_scales, logv, np)[field]
                     for x in th])
    rel_core = float(np.max(np.abs(got / core - 1.0)))
    rel = float(np.max(np.abs(got / ref - 1.0)))
    print(f"RESIDUAL emulator query[{field}] vs numpy core max_rel={rel_core:.3e} "
          f"vs jitted kernel max_rel={rel:.3e}")
    assert rel_core <= 4.5e-16
    assert rel <= (QUERY_RTOL if field == "DM_over_B" else 1e-13)
    np.testing.assert_array_equal(te.make_domain_fn(t_art, device="cpu")(th).numpy(),
                                  np.asarray(je.make_domain_fn(j_art)(th)))
    np.testing.assert_array_equal(te.make_error_fn(t_art, device="cpu")(th).numpy(),
                                  np.asarray(je.make_error_fn(j_art)(th)))


def _refusal(loader, path, **kw):
    with pytest.raises(Exception) as exc:
        loader(path, **kw)
    return type(exc.value).__name__, str(exc.value)


@pytest.mark.parametrize("damage", ["tamper", "nan", "schema", "knob", "bundle_kind"])
def test_bad_artifacts_are_refused_like_jax(tiny_emulator, tmp_path, damage):
    base, out_dir, j_art, _ = tiny_emulator
    path = tmp_path / "art"
    shutil.copytree(out_dir, path)
    manifest = json.loads((path / "manifest.json").read_text())
    kw = {}
    if damage in ("tamper", "nan"):
        with np.load(path / "artifact.npz") as data:
            arrays = {k: np.array(data[k]) for k in data.files}
        arrays["field_DM_over_B"][1, 1, 1] = np.nan if damage == "nan" else 1.0
        np.savez(path / "artifact.npz", **arrays)
        if damage == "nan":  # a hash that verifies, so the table check speaks
            values = {n: arrays[f"field_{n}"] for n in manifest["fields"]}
            manifest["hash"] = je.artifact_hash(
                j_art.axis_names, j_art.axis_nodes, j_art.axis_scales, values,
                manifest["identity"], predicted_error=arrays["predicted_error"])
    elif damage == "schema":
        manifest["schema_version"] = 1
    elif damage == "bundle_kind":
        manifest["kind"] = "multi_domain"
    (path / "manifest.json").write_text(json.dumps(manifest))
    if damage == "knob":
        other = jc.config_from_dict(dict(ARCHIVED, n_y=4000))
        kw["expect_identity"] = je.build_identity(
            other, jc.static_choices_from_config(other)._replace(quad_panel_gl=True),
            400, "tabulated")
    got = _refusal(te.load_artifact, str(path), **kw)
    ref = _refusal(je.load_artifact, str(path), **kw)
    assert got == ref and got[0] == "EmulatorArtifactError"


def test_a_nan_table_is_refused_at_save(tiny_emulator, tmp_path):
    _, out_dir, _, _ = tiny_emulator
    art = te.load_artifact(out_dir)
    bad = dict(art.values, Y_B=np.where(art.values["Y_B"] > 0, -1.0, 1.0))
    with pytest.raises(te.EmulatorArtifactError, match="non-positive"):
        te.save_artifact(str(tmp_path / "x"), art._replace(values=bad))


def test_cell_error_estimates_equal_jax():
    rng = np.random.default_rng(5)
    nodes = [np.sort(rng.uniform(1.0, 3.0, n)) for n in (4, 2, 5)]
    logv = {f: rng.normal(size=(4, 2, 5)) for f in ("a", "b")}
    for scales in (["log", "lin", "log"], ["lin", "lin", "lin"]):
        np.testing.assert_array_equal(
            te.cell_error_estimates(logv, nodes, scales),
            je.cell_error_estimates(logv, nodes, scales))


def test_port_build_matches_jax_build_and_jax_loads_it(tmp_path, jit_warmup):
    """The tiny box built by both packages, after the JAX warm-up."""
    j_spec = {k: je.AxisSpec(*v) for k, v in TINY.items()}
    t_spec = {k: te.AxisSpec(*v) for k, v in TINY.items()}
    jbase, tbase = jc.config_from_dict(ARCHIVED), tc.config_from_dict(ARCHIVED)
    jit_warmup(je.build_emulator, jbase, j_spec, rtol=1e-1, n_probe=2, n_holdout=4,
               max_rounds=0, n_y=400, chunk_size=64)
    j_art, j_rep = je.build_emulator(jbase, j_spec, **TINY_KW)
    t_art, t_rep = te.build_emulator(tbase, t_spec, device="cpu",
                                     out_dir=str(tmp_path / "port"), **TINY_KW)
    for a, b in zip(t_art.axis_nodes, j_art.axis_nodes):
        np.testing.assert_array_equal(a, b)
    assert (len(t_rep.rounds), t_rep.n_exact_evals, t_rep.converged) == (
        len(j_rep.rounds), j_rep.n_exact_evals, j_rep.converged)
    assert [r["n_failing"] for r in t_rep.rounds] == [r["n_failing"] for r in j_rep.rounds]
    assert t_art.identity == j_art.identity
    rel = max(float(np.max(np.abs(t_art.values[f] / j_art.values[f] - 1.0)))
              for f in j_art.values)
    err = float(np.max(np.abs(t_art.predicted_error - j_art.predicted_error)))
    print(f"RESIDUAL emulator build values max_rel={rel:.3e} predicted_error max_abs={err:.3e} "
          f"held-out {t_rep.max_rel_err:.3e} vs {j_rep.max_rel_err:.3e}")
    assert rel <= BUILD_RTOL and err <= 1e-10
    assert abs(t_rep.max_rel_err - j_rep.max_rel_err) <= 1e-10
    loaded = je.load_artifact(str(tmp_path / "port"), expect_identity=j_art.identity)
    assert loaded.content_hash == t_art.content_hash
    for f in j_art.values:
        np.testing.assert_array_equal(loaded.values[f], t_art.values[f])


@pytest.mark.parametrize("knob,value", [("posterior_weight", "planck"),
                                        ("refine_signal", "fisher")])
def test_weighted_and_fisher_builds_match_jax(knob, value, jit_warmup):
    """The tiny box with the Planck weighting or the Fisher signal, built
    by both packages after the JAX warm-up: the same nodes, rounds,
    failing counts, gradient evaluations and identity; values ≤1e-12."""
    j_spec = {k: je.AxisSpec(*v) for k, v in TINY.items()}
    t_spec = {k: te.AxisSpec(*v) for k, v in TINY.items()}
    jbase, tbase = jc.config_from_dict(ARCHIVED), tc.config_from_dict(ARCHIVED)
    kw = dict(TINY_KW, require_converged=False, **{knob: value})
    jit_warmup(je.build_emulator, jbase, j_spec, rtol=1e-1, n_probe=2, n_holdout=4,
               max_rounds=0, n_y=400, chunk_size=64)
    j_art, j_rep = je.build_emulator(jbase, j_spec, **kw)
    t_art, t_rep = te.build_emulator(tbase, t_spec, device="cpu", **kw)
    for a, b in zip(t_art.axis_nodes, j_art.axis_nodes):
        np.testing.assert_array_equal(a, b)
    assert [r["n_failing"] for r in t_rep.rounds] == [r["n_failing"] for r in j_rep.rounds]
    assert (t_rep.n_exact_evals, t_rep.n_grad_evals, t_rep.converged) == (
        j_rep.n_exact_evals, j_rep.n_grad_evals, j_rep.converged)
    assert (t_rep.posterior_weight, t_rep.refine_signal) == (
        j_rep.posterior_weight, j_rep.refine_signal)
    assert t_art.identity == j_art.identity and t_art.identity[knob] == value
    assert t_art.manifest[knob] == j_art.manifest[knob] == value
    rel = max(float(np.max(np.abs(t_art.values[f] / j_art.values[f] - 1.0)))
              for f in j_art.values)
    w_err = (None if j_rep.weighted_max_rel_err is None
             else abs(t_rep.weighted_max_rel_err - j_rep.weighted_max_rel_err))
    print(f"RESIDUAL emulator {knob}={value} build values max_rel={rel:.3e} "
          f"rounds={len(t_rep.rounds)} grad_evals={t_rep.n_grad_evals} "
          f"weighted held-out abs diff={w_err}")
    assert rel <= BUILD_RTOL
    assert w_err is None or w_err <= 1e-10


def test_exact_evaluator_quarantines_a_dead_probe_chunk_like_jax():
    jbase, tbase = jc.config_from_dict(ARCHIVED), tc.config_from_dict(ARCHIVED)
    jst = jc.static_choices_from_config(jbase)._replace(quad_panel_gl=False)
    tst = tc.static_choices_from_config(tbase)._replace(quad_panel_gl=False)
    plan = [{"site": "probe", "kind": "raise", "key": 1},
            {"site": "probe", "kind": "transient", "key": 2, "times": 1}]
    axes = {"m_chi_GeV": np.geomspace(0.5, 2.0, 24), "v_w": np.linspace(0.2, 0.4, 24)}
    sinks = {"jax": [], "port": []}
    j_ev = je.make_exact_evaluator(jbase, jst, n_y=400, impl="tabulated", chunk_size=8,
                                   retry=JRP(sleep=lambda s: None),
                                   fault_plan=jf.FaultPlan.from_obj(plan),
                                   quarantine_sink=sinks["jax"].append)
    t_ev = te.make_exact_evaluator(tbase, tst, n_y=400, impl="tabulated", chunk_size=8,
                                   retry=TRP(sleep=lambda s: None),
                                   fault_plan=tf.FaultPlan.from_obj(plan),
                                   quarantine_sink=sinks["port"].append, device="cpu")
    ref, got = j_ev(axes), t_ev(axes)
    np.testing.assert_array_equal(sinks["port"][-1], sinks["jax"][-1])
    assert sinks["port"][-1][8:16].all() and sinks["port"][-1].sum() == 8
    for f in ref:
        np.testing.assert_array_equal(np.isfinite(got[f]), np.isfinite(ref[f]))
        ok = np.isfinite(ref[f])
        assert np.max(np.abs(got[f][ok] / ref[f][ok] - 1.0)) <= BUILD_RTOL


# option pairings that both packages refuse with the same message: a
# traffic signal without a snapshot, a snapshot without a traffic signal,
# and an elastic build without a shared store
REFUSED = [
    ({"posterior_weight": "planck", "elastic": 2}, {}),
    ({"traffic": object()}, {"posterior_weight": "planck"}),
    ({"refine_signal": "traffic"}, {"refine_signal": "fisher"}),
    ({"refine_signal": "traffic"}, {}),
    ({}, {"refine_signal": "traffic*planck"}),
    ({"traffic": object()}, {}),
    ({"elastic": 2}, {}),
]


@pytest.mark.parametrize("kw,cfg", REFUSED, ids=range(len(REFUSED)))
def test_refused_options_name_their_roadmap_item(kw, cfg, monkeypatch):
    monkeypatch.delenv("BDLZ_CACHE_ROOT", raising=False)
    with pytest.raises(je.EmulatorBuildError) as ref:
        je.build_emulator(jc.config_from_dict(dict(ARCHIVED, **cfg)),
                          {"m_chi_GeV": je.AxisSpec(0.9, 1.1, 2, "log")}, **kw)
    base = tc.config_from_dict(dict(ARCHIVED, **cfg))
    spec = {"m_chi_GeV": te.AxisSpec(0.9, 1.1, 2, "log")}
    with pytest.raises(te.EmulatorBuildError) as got:
        te.build_emulator(base, spec, device="cpu", **kw)
    # the messages name each package's own refine module
    assert str(got.value) == str(ref.value).replace("bdlz_tpu.", "bdlz_tpu_torch.")


def test_invalid_weighting_values_are_refused_like_jax():
    spec_t = {"m_chi_GeV": te.AxisSpec(0.9, 1.1, 2, "log")}
    spec_j = {"m_chi_GeV": je.AxisSpec(0.9, 1.1, 2, "log")}
    for kw in ({"posterior_weight": "bogus"}, {"refine_signal": "bogus"}):
        with pytest.raises(te.EmulatorBuildError) as got:
            te.build_emulator(tc.config_from_dict(ARCHIVED), spec_t, device="cpu", **kw)
        with pytest.raises(je.EmulatorBuildError) as ref:
            je.build_emulator(jc.config_from_dict(ARCHIVED), spec_j, **kw)
        assert str(got.value) == str(ref.value)


def test_without_a_card_nothing_runs_unless_the_cpu_is_asked_for(tiny_emulator, monkeypatch):
    _, out_dir, _, _ = tiny_emulator
    art = te.load_artifact(out_dir)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = tc.config_from_dict(ARCHIVED)
    static = tc.static_choices_from_config(base)
    for call in (lambda: te.build_emulator(base, {"m_chi_GeV": te.AxisSpec(0.9, 1.1, 2)}),
                 lambda: te.make_query_fn(art), lambda: te.make_domain_fn(art),
                 lambda: te.make_error_fn(art),
                 lambda: te.make_exact_evaluator(base, static, n_y=400, impl="tabulated")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert te.make_query_fn(art, device="cpu")(_queries(4)).shape == (4,)


def test_one_query_domain_and_error_match_jax():
    """``in_domain_one``/``predicted_error_one`` on (d,) queries inside,
    on the edge of and outside a 3-D box, against JAX's NumPy forms."""
    from bdlz_tpu.emulator import grid as jg

    from bdlz_tpu_torch.emulator import grid as tg

    rng = np.random.default_rng(7)
    nodes = [np.sort(rng.uniform(1.0, 3.0, n)) for n in (4, 2, 5)]
    errs = rng.uniform(1e-6, 1e-3, (3, 1, 4))
    tnodes = [torch.as_tensor(n, dtype=torch.float64) for n in nodes]
    terrs = torch.as_tensor(errs, dtype=torch.float64)
    queries = [[n[0] for n in nodes], [n[-1] for n in nodes], [2.0, 2.0, 2.0],
               [0.5, 2.0, 2.0], [2.0, 2.0, 3.5]] + rng.uniform(1.0, 3.0, (8, 3)).tolist()
    for q in queries:
        t = torch.as_tensor(q, dtype=torch.float64)
        assert bool(tg.in_domain_one(t, tnodes)) == bool(jg.in_domain_one(np.asarray(q), nodes, np))
        assert float(tg.predicted_error_one(t, tnodes, terrs, 2e-5)) == float(
            jg.predicted_error_one(np.asarray(q), nodes, errs, 2e-5, np))
