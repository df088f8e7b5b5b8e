"""Sweep robustness of the port against the JAX package, on the CPU: the
retry policy, the fault plan, the event log, the heal budget, and
``run_sweep`` under every fault kind, with resume, a torn chunk file and
sweep directories that one package writes and the other resumes.

Tolerances: retry delays, fault decisions, heal budgets, quarantined
indices, retry counts, failure masks and events (apart from ``ts`` and
``seconds``) are equal; sweep outputs ≤1e-13 rel (measured ≤4.5e-16);
outputs read back from a directory are bit for bit those written.
``pytest -s`` prints the ``RESIDUAL`` lines.
"""
import io
import json

import numpy as np
import pytest

from bdlz_tpu import config as jc
from bdlz_tpu import faults as jf
from bdlz_tpu.parallel import sweep as js
from bdlz_tpu.utils import logging as jl
from bdlz_tpu.utils import retry as jr

from bdlz_tpu_torch import config as tc
from bdlz_tpu_torch import faults as tf
from bdlz_tpu_torch.parallel import sweep as ts
from bdlz_tpu_torch.utils import logging as tl
from bdlz_tpu_torch.utils import retry as tr

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
# 64 points in 4 chunks of 16, n_y 400 (the quadrature floors it at 2000)
AXES = {"m_chi_GeV": np.geomspace(0.3, 3.0, 8), "T_p_GeV": np.geomspace(50.0, 200.0, 8)}
KW = dict(chunk_size=16, n_y=400, impl="tabulated")
OUT_RTOL = 1e-13


def _statics():
    return (jc.static_choices_from_config(jc.config_from_dict(ARCHIVED))._replace(
                quad_panel_gl=False),
            tc.static_choices_from_config(tc.config_from_dict(ARCHIVED))._replace(
                quad_panel_gl=False))


def _noop(attempts=3):
    sleeps_j, sleeps_t = [], []
    return (jr.RetryPolicy(max_attempts=attempts, sleep=sleeps_j.append),
            tr.RetryPolicy(max_attempts=attempts, sleep=sleeps_t.append), sleeps_j, sleeps_t)


def _events(stream):
    return [{k: v for k, v in json.loads(line).items() if k not in ("ts", "seconds")}
            for line in stream.getvalue().splitlines()]


def _both(plan=None, attempts=3, **kw):
    """The same sweep through both packages with no-op sleeps; returns
    (jax result, port result, jax events, port events, jax sleeps, port
    sleeps)."""
    j_static, t_static = _statics()
    pj, pt, sj, st = _noop(attempts)
    ej, et = io.StringIO(), io.StringIO()
    jres = js.run_sweep(jc.config_from_dict(ARCHIVED), AXES, j_static, **KW,
                        fault_plan=None if plan is None else jf.FaultPlan.from_obj(plan),
                        retry=pj, event_log=jl.EventLog(stream=ej),
                        **{k: v[0] for k, v in kw.items()})
    tres = ts.run_sweep(tc.config_from_dict(ARCHIVED), AXES, t_static, **KW, device="cpu",
                        fault_plan=None if plan is None else tf.FaultPlan.from_obj(plan),
                        retry=pt, event_log=tl.EventLog(stream=et),
                        **{k: v[1] for k, v in kw.items()})
    return jres, tres, _events(ej), _events(et), sj, st


def _max_rel(a, b):
    ok = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), ok)
    return float(np.max(np.abs(a[ok] / b[ok] - 1.0))) if ok.any() else 0.0


# ---- primitives --------------------------------------------------------------

@pytest.mark.parametrize("seed,label,attempt", [(0, "chunk0:0", 0), (0, "chunk3:48", 1),
                                                (7, "probe0", 2), (123, "x", 5)])
def test_retry_delays_equal_jax(seed, label, attempt):
    assert tr.deterministic_jitter(seed, label, attempt) == jr.deterministic_jitter(
        seed, label, attempt)
    for backoff, cap in ((0.05, 2.0), (0.5, 0.7)):
        kw = dict(backoff_s=backoff, max_backoff_s=cap, seed=seed)
        assert tr.backoff_delay(tr.RetryPolicy(**kw), label, attempt) == jr.backoff_delay(
            jr.RetryPolicy(**kw), label, attempt)


def test_call_with_retry_sleeps_the_same_schedule():
    pj, pt, sj, st = _noop(attempts=4)
    for call, pol in ((jr.call_with_retry, pj), (tr.call_with_retry, pt)):
        state = {"n": 0}

        def flaky(state=state):
            state["n"] += 1
            if state["n"] < 3:
                raise RuntimeError("flaky")
            return "ok"

        seen = []
        assert call(flaky, pol, label="t", on_retry=lambda a, e: seen.append(a)) == "ok"
        assert seen == [0, 1]
    assert st == sj and len(st) == 2
    with pytest.raises(RuntimeError, match="still dead"):
        tr.call_with_retry(lambda: (_ for _ in ()).throw(RuntimeError("still dead")), pt)


@pytest.mark.parametrize("over,enabled,default", [
    ({}, None, True), ({}, None, False), ({"retry_enabled": False}, None, True),
    ({"retry_enabled": True, "retry_max_attempts": 7, "retry_backoff_s": 0.5}, None, False),
    ({}, False, True),
])
def test_retry_resolution_equals_jax(over, enabled, default):
    d = dict(ARCHIVED, **over)
    got = tr.resolve_retry_policy(tc.config_from_dict(d), enabled=enabled,
                                  engine_default=default)
    ref = jr.resolve_retry_policy(jc.config_from_dict(d), enabled=enabled,
                                  engine_default=default)
    assert (got is None) == (ref is None)
    if ref is not None:
        assert got[:4] == ref[:4]
    static = tc.static_choices_from_config(tc.config_from_dict(d))
    j_static = jc.static_choices_from_config(jc.config_from_dict(d))
    e_got = tr.resolve_engine_retry(None, tc.config_from_dict(d), static, default)
    e_ref = jr.resolve_engine_retry(None, jc.config_from_dict(d), j_static, default)
    assert (e_got is None) == (e_ref is None)


PLANS = [
    [{"site": "step", "kind": "raise", "key": 2}],
    [{"site": "step", "kind": "transient", "chunk": 1, "times": 2}],
    [{"site": "step", "kind": "poison", "point": 5}, {"site": "step", "kind": "nan", "point": 9}],
    {"faults": [{"site": "chunk_write", "kind": "torn", "key": 0},
                {"site": "store_read", "kind": "corrupt", "call": 1},
                {"site": "clock", "kind": "slow", "delay_s": 0.25},
                {"site": "replica_dispatch", "kind": "nan", "times": 1}]},
    [{"site": "probe", "kind": "transient", "key": None, "times": 3}],
]


@pytest.mark.parametrize("plan", PLANS, ids=range(len(PLANS)))
def test_fault_plan_parse_describe_and_decisions_equal_jax(plan, tmp_path):
    pj, pt = jf.FaultPlan.from_obj(plan), tf.FaultPlan.from_obj(plan)
    assert pt.describe() == pj.describe()
    assert [tuple(s) for s in pt.specs] == [tuple(s) for s in pj.specs]
    assert tf.FaultPlan.from_json(json.dumps(plan)).describe() == pj.describe()
    trace_j, trace_t = [], []
    for p, trace in ((pj, trace_j), (pt, trace_t)):
        for site in ("step", "probe", "replica_dispatch", "clock"):
            for key in range(4):
                try:
                    p.fire(site, key)
                    trace.append(None)
                except Exception as exc:  # noqa: BLE001 — compared below
                    trace.append((type(exc).__name__, str(exc)))
                trace.append(p.nan_batch(site, key))
                trace.append(p.delay_s(site, key))
            for lo, hi in ((0, 4), (4, 8), (8, 16)):
                try:
                    p.check_range(site, lo, hi)
                    trace.append(None)
                except Exception as exc:  # noqa: BLE001 — compared below
                    trace.append((type(exc).__name__, str(exc)))
                if site != "replica_dispatch":  # its nan specs carry no point
                    trace.append(p.nan_points(site, lo, hi))
        for i in range(2):
            f = tmp_path / f"{id(p)}_{i}.bin"
            f.write_bytes(bytes(range(200)))
            trace.append(p.corrupt_file("chunk_write", 0, str(f)))
            trace.append(p.corrupt_bytes("store_read", 1, str(f)))
            trace.append(f.read_bytes())
    assert trace_t == trace_j


@pytest.mark.parametrize("bad", [
    [{"site": "nowhere", "kind": "raise"}], [{"site": "step", "kind": "explode"}],
    [{"site": "step", "kind": "poison"}], [{"site": "step", "kind": "nan"}],
    [{"site": "step", "kind": "transient"}], [{"site": "step", "kind": "raise", "when": 1}],
    "not a plan", "[{not json",
])
def test_fault_plan_rejections_equal_jax(bad):
    def err(mod):
        with pytest.raises(mod.FaultPlanError) as exc:
            if isinstance(bad, str):
                mod.FaultPlan.from_json(bad) if bad.startswith("[") else mod.FaultPlan.from_obj(bad)
            else:
                mod.FaultPlan.from_obj(bad)
        return str(exc.value)
    assert err(tf) == err(jf)


def test_fault_plan_resolution_equals_jax(monkeypatch):
    plan = json.dumps([{"site": "step", "kind": "raise", "key": 0}])
    for over, env in (({}, None), ({}, plan), ({"fault_plan": plan}, None),
                      ({"fault_injection": False, "fault_plan": plan}, plan)):
        if env is None:
            monkeypatch.delenv(tf.FAULT_PLAN_ENV, raising=False)
        else:
            monkeypatch.setenv(tf.FAULT_PLAN_ENV, env)
        d = dict(ARCHIVED, **over)
        got = tf.FaultPlan.resolve(None, tc.config_from_dict(d))
        ref = jf.FaultPlan.resolve(None, jc.config_from_dict(d))
        assert (got is None) == (ref is None)
        if ref is not None:
            assert got.describe() == ref.describe()
    monkeypatch.delenv(tf.FAULT_PLAN_ENV, raising=False)
    with pytest.raises(tf.FaultPlanError, match="fault_injection=true"):
        tf.FaultPlan.resolve(None, tc.config_from_dict(dict(ARCHIVED, fault_injection=True)))


def test_event_log_records_equal_jax_apart_from_ts(tmp_path):
    recs = [("sweep_start", {"n_points": 64, "hash": "abc", "use_table": True}),
            ("chunk_retry", {"chunk": 1, "error": ValueError("x"), "lo": 16}),
            ("chunk_done", {"chunk": 0, "seconds": 0.5, "nested": {"a": [1, 2.5]}})]
    for kind in ("stream", "path"):
        outs = []
        for mod in (jl, tl):
            if kind == "stream":
                buf = io.StringIO()
                log = mod.EventLog(stream=buf)
            else:
                path = tmp_path / f"{mod.__name__}.jsonl"
                log = mod.EventLog(path=str(path))
            for name, fields in recs:
                log.emit(name, **fields)
            log.close()
            text = buf.getvalue() if kind == "stream" else path.read_text()
            lines = [json.loads(line) for line in text.splitlines()]
            assert all(isinstance(r.pop("ts"), float) for r in lines)
            outs.append(lines)
        assert outs[1] == outs[0]
        assert list(outs[1][0]) == ["event", "n_points", "hash", "use_table"]


@pytest.mark.parametrize("n,attempts", [(1, 1), (2, 3), (16, 3), (8192, 3), (8192, 5), (1000, 0)])
def test_heal_budget_equals_jax(n, attempts):
    assert ts.heal_budget(n, attempts) == js.heal_budget(n, attempts)


# ---- run_sweep under each fault kind ----------------------------------------

SWEEP_PLANS = {
    "clean": None,
    "transient": [{"site": "step", "kind": "transient", "key": 1, "times": 2}],
    "raise": [{"site": "step", "kind": "raise", "key": 2}],
    "poison": [{"site": "step", "kind": "poison", "point": 37}],
    "nan": [{"site": "step", "kind": "nan", "point": 9}],
    "mixed": [{"site": "step", "kind": "poison", "point": 50},
              {"site": "step", "kind": "poison", "point": 55},
              {"site": "step", "kind": "transient", "key": 0, "times": 1},
              {"site": "step", "kind": "nan", "point": 3}],
}


@pytest.mark.parametrize("name", list(SWEEP_PLANS))
def test_run_sweep_under_faults_matches_jax(name):
    """The same quarantined indices, retries, masks, sleeps and events as
    the JAX engine; outputs ≤1e-13 where finite."""
    jres, tres, ej, et, sj, st = _both(SWEEP_PLANS[name])
    assert (tres.n_failed, tres.n_quarantined, tres.n_retries) == (
        jres.n_failed, jres.n_quarantined, jres.n_retries)
    np.testing.assert_array_equal(tres.quarantined_mask, jres.quarantined_mask)
    np.testing.assert_array_equal(tres.failed_mask, jres.failed_mask)
    assert st == sj
    assert et == ej
    rel = max(_max_rel(tres.outputs[f], jres.outputs[f]) for f in jres.outputs)
    print(f"RESIDUAL robustness run_sweep[{name}] outputs max_rel={rel:.3e} "
          f"retries={tres.n_retries} quarantined={np.flatnonzero(tres.quarantined_mask)}")
    assert rel <= OUT_RTOL
    if name == "clean":
        assert tres.n_retries == 0 and not tres.quarantined_mask.any()


def test_retry_disabled_raises_through():
    _, t_static = _statics()
    with pytest.raises(tf.FaultError, match="injected fault"):
        ts.run_sweep(tc.config_from_dict(dict(ARCHIVED, retry_enabled=False)), AXES, t_static,
                     **KW, device="cpu",
                     fault_plan=tf.FaultPlan.from_obj([{"site": "step", "kind": "raise",
                                                       "key": 0}]))


# ---- resume ------------------------------------------------------------------

def test_resume_and_torn_chunk_file(tmp_path, capsys):
    _, t_static = _statics()
    base = tc.config_from_dict(ARCHIVED)
    out = str(tmp_path / "sweep")
    first = ts.run_sweep(base, AXES, t_static, **KW, device="cpu", out_dir=out)
    manifest = json.loads((tmp_path / "sweep" / "manifest.json").read_text())
    assert sorted(manifest) == ["chunk_size", "chunks", "hash", "impl", "n_total"]
    assert manifest["chunks"]["3"] == {"file": f"{out}/chunk_00003.npz", "n_valid": 16,
                                       "n_failed": 0}
    again = ts.run_sweep(base, AXES, t_static, **KW, device="cpu", out_dir=out)
    assert again.resumed_chunks == 4 and again.out_dir == out
    for f in first.outputs:
        np.testing.assert_array_equal(again.outputs[f], first.outputs[f])

    # a torn chunk file is recomputed; the plan (spent) is the same object
    torn = tf.FaultPlan.from_obj([{"site": "chunk_write", "kind": "torn", "key": 2}])
    out2 = str(tmp_path / "torn")
    ts.run_sweep(base, AXES, t_static, **KW, device="cpu", out_dir=out2, fault_plan=torn)
    with pytest.raises(Exception):
        np.load(f"{out2}/chunk_00002.npz")["DM_over_B"]
    healed = ts.run_sweep(base, AXES, t_static, **KW, device="cpu", out_dir=out2,
                          fault_plan=torn)
    assert healed.resumed_chunks == 3
    assert "recomputing" in capsys.readouterr().err
    for f in first.outputs:
        np.testing.assert_array_equal(healed.outputs[f], first.outputs[f])

    # a clean run never adopts the chaos directory; a changed chunk size
    # starts over
    clean_rerun = ts.run_sweep(base, AXES, t_static, **KW, device="cpu", out_dir=out2)
    assert clean_rerun.resumed_chunks == 0
    other = ts.run_sweep(base, AXES, t_static, **dict(KW, chunk_size=32), device="cpu",
                         out_dir=out)
    assert other.resumed_chunks == 0 and "chunk_size 16 != current 32" in capsys.readouterr().err


def test_quarantine_survives_resume(tmp_path):
    _, t_static = _statics()
    base = tc.config_from_dict(ARCHIVED)
    pol = tr.RetryPolicy(sleep=lambda s: None)
    plan = [{"site": "step", "kind": "poison", "point": 5}]
    out = str(tmp_path / "sweep")
    first = ts.run_sweep(base, AXES, t_static, **KW, device="cpu", out_dir=out, retry=pol,
                         fault_plan=tf.FaultPlan.from_obj(plan))
    rec = json.loads((tmp_path / "sweep" / "manifest.json").read_text())["chunks"]["0"]
    assert rec["n_quarantined"] == 1 and rec["quarantined"] == [5]
    again = ts.run_sweep(base, AXES, t_static, **KW, device="cpu", out_dir=out, retry=pol,
                         fault_plan=tf.FaultPlan.from_obj(plan))
    assert again.resumed_chunks == 4 and again.n_quarantined == 1 and again.n_retries == 0
    np.testing.assert_array_equal(again.quarantined_mask, first.quarantined_mask)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_sweep_directory_resumes_in_the_other_package(writer, tmp_path):
    """Same manifest keys and hash, same chunk files: the reader resumes
    every chunk and returns the writer's outputs bit for bit."""
    j_static, t_static = _statics()
    jb, tb = jc.config_from_dict(ARCHIVED), tc.config_from_dict(ARCHIVED)
    out = str(tmp_path / "sweep")
    if writer == "jax":
        wrote = js.run_sweep(jb, AXES, j_static, **KW, out_dir=out)
        read = ts.run_sweep(tb, AXES, t_static, **KW, device="cpu", out_dir=out)
    else:
        wrote = ts.run_sweep(tb, AXES, t_static, **KW, device="cpu", out_dir=out)
        read = js.run_sweep(jb, AXES, j_static, **KW, out_dir=out)
    assert read.resumed_chunks == 4
    for f in wrote.outputs:
        np.testing.assert_array_equal(read.outputs[f], wrote.outputs[f])
    np.testing.assert_array_equal(read.failed_mask, wrote.failed_mask)


def test_grid_hash_of_a_shared_engine_equals_jax():
    j_static, t_static = _statics()
    for impl in ("tabulated", "direct"):
        got = ts.grid_hash(tc.config_from_dict(ARCHIVED), AXES, 400, impl,
                           extra=ts.engine_identity_extra(t_static, impl) or None)
        ref = js.grid_hash(jc.config_from_dict(ARCHIVED), AXES, 400, impl,
                           extra=js.engine_identity_extra(j_static, impl) or None)
        assert got == ref


# ---- the defaults and the chunk size the two packages share -----------------

# 32 points, fewer than one chunk of 4096
SMALL_AXES = {"m_chi_GeV": np.geomspace(0.3, 3.0, 8), "T_p_GeV": np.geomspace(60.0, 200.0, 4)}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_chunk_larger_than_the_grid_resumes_in_the_other_package(writer, tmp_path):
    """Chunk 4096 over 32 points: both manifests record 4096 (the requested
    size), so the reader resumes the writer's one chunk.  The panel rule
    keeps JAX's 4096-point padded chunk small."""
    j_static, t_static = (s._replace(quad_panel_gl=True) for s in _statics())
    jb, tb = jc.config_from_dict(ARCHIVED), tc.config_from_dict(ARCHIVED)
    kw = dict(chunk_size=4096, n_y=400, impl="tabulated")
    out = str(tmp_path / "sweep")
    if writer == "jax":
        wrote = js.run_sweep(jb, SMALL_AXES, j_static, **kw, out_dir=out)
        read = ts.run_sweep(tb, SMALL_AXES, t_static, **kw, device="cpu", out_dir=out)
    else:
        wrote = ts.run_sweep(tb, SMALL_AXES, t_static, **kw, device="cpu", out_dir=out)
        read = js.run_sweep(jb, SMALL_AXES, j_static, **kw, out_dir=out)
    manifest = json.loads((tmp_path / "sweep" / "manifest.json").read_text())
    assert manifest["chunk_size"] == 4096 and manifest["n_total"] == 32
    assert wrote.chunks == read.chunks == 1 and read.resumed_chunks == 1
    for f in wrote.outputs:
        np.testing.assert_array_equal(read.outputs[f], wrote.outputs[f])


def test_default_sweeps_of_the_two_packages_agree(tmp_path):
    """No ``impl`` given: both packages run the tabulated engine, resolve
    the audited panel rule on this grid, and write the same ``grid_hash``,
    so the port's default directory resumes in JAX."""
    jb, tb = jc.config_from_dict(ARCHIVED), tc.config_from_dict(ARCHIVED)
    j_static, t_static = jc.static_choices_from_config(jb), tc.static_choices_from_config(tb)
    assert j_static.quad_panel_gl is None and t_static.quad_panel_gl is None
    jres = js.run_sweep(jb, SMALL_AXES, j_static, chunk_size=16, out_dir=str(tmp_path / "j"))
    tres = ts.run_sweep(tb, SMALL_AXES, t_static, chunk_size=16, device="cpu",
                        out_dir=str(tmp_path / "t"))
    assert tres.impl == "tabulated"
    assert (tres.quad_impl, tres.n_quad_nodes) == (jres.quad_impl, jres.n_quad_nodes) == (
        "panel_gl", 560)
    j_man = json.loads((tmp_path / "j" / "manifest.json").read_text())
    t_man = json.loads((tmp_path / "t" / "manifest.json").read_text())
    assert t_man["hash"] == j_man["hash"] and t_man["impl"] == j_man["impl"]
    rel = _max_rel(tres.outputs["DM_over_B"], jres.outputs["DM_over_B"])
    print(f"RESIDUAL robustness default sweep DM_over_B max_rel={rel:.3e}")
    assert rel <= OUT_RTOL
    again = js.run_sweep(jb, SMALL_AXES, j_static, chunk_size=16, out_dir=str(tmp_path / "t"))
    assert again.resumed_chunks == 2
