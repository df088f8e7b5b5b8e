"""The port's elastic work-stealing sweep against the JAX package's and
against its own serial ``run_sweep``, on the CPU.

* The lease plane, the commit protocol and the election replay the same
  operation traces in both packages and leave the same records.
* ``run_sweep_elastic`` (in-process fleet on a manual clock), the worker
  loop and the ``--elastic`` CLI roles (in-process and in real processes)
  are bitwise the port's serial ``run_sweep``, clean and under churn; the
  same runs in the JAX package give Ω_DM/Ω_b ≤1e-12 rel and equal
  quarantined indices, retries, lease generations and failure credits.
* The emulator's elastic fill equals its serial fill.

Residuals print as ``RESIDUAL`` lines (``pytest -s``)."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import bdlz_tpu.parallel.scheduler as jsch
import bdlz_tpu.parallel.sweep as jsw
import bdlz_tpu.parallel.worker as jwk
import bdlz_tpu.provenance as jprov
import bdlz_tpu_torch.parallel.scheduler as tsch
import bdlz_tpu_torch.parallel.sweep as tsw
import bdlz_tpu_torch.parallel.worker as twk
import bdlz_tpu_torch.provenance as tprov
from bdlz_tpu.config import config_from_dict as jcfg
from bdlz_tpu.config import static_choices_from_config as jstatic
from bdlz_tpu.faults import FaultPlan as JPlan
from bdlz_tpu.parallel.multihost import elect_coordinator as j_elect
from bdlz_tpu.utils.retry import RetryPolicy as JRetry
from bdlz_tpu_torch.config import config_from_dict as tcfg
from bdlz_tpu_torch.config import static_choices_from_config as tstatic
from bdlz_tpu_torch.faults import FaultPlan as TPlan
from bdlz_tpu_torch.parallel.multihost import elect_coordinator as t_elect
from bdlz_tpu_torch.utils.retry import RetryPolicy as TRetry

REPO = pathlib.Path(__file__).resolve().parent.parent
ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
AXES = {"m_chi_GeV": [0.5, 1.0, 2.0], "T_p_GeV": [80.0, 150.0]}
CHUNK, N_Y = 2, 200
JAX_RTOL = 1e-12


def _jretry():
    return JRetry(max_attempts=2, backoff_s=0.0, sleep=lambda s: None)


def _tretry():
    return TRetry(max_attempts=2, backoff_s=0.0, sleep=lambda s: None)


@pytest.fixture(scope="module")
def bases():
    jb, tb = jcfg(ARCHIVED), tcfg(ARCHIVED)
    return jb, jstatic(jb), tb, tstatic(tb)


@pytest.fixture(scope="module")
def serial(bases):
    _, _, tb, ts = bases
    return tsw.run_sweep(tb, AXES, ts, chunk_size=CHUNK, n_y=N_Y, retry=_tretry(),
                         device="cpu")


@pytest.fixture(scope="module")
def jax_serial(bases, jit_warmup):
    jb, js, _, _ = bases
    kw = dict(mesh=None, chunk_size=CHUNK, n_y=N_Y, retry=_jretry())
    jit_warmup(lambda: jsw.run_sweep(jb, AXES, js, **kw).outputs["DM_over_B"])
    return jsw.run_sweep(jb, AXES, js, **kw)


def _elastic(mod, bases, store, **kw):
    jb, js, tb, ts = bases
    if mod is tsch:
        return tsch.run_sweep_elastic(tb, AXES, ts, store=store, chunk_size=CHUNK, n_y=N_Y,
                                      retry=_tretry(), device="cpu", **kw)
    return jsch.run_sweep_elastic(jb, AXES, js, store=store, chunk_size=CHUNK, n_y=N_Y,
                                  retry=_jretry(), **kw)


def _bitwise(res, ref, label):
    for f in ref.outputs:
        a, b = np.asarray(res.outputs[f]), np.asarray(ref.outputs[f])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f"{label}: {f}"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ok = np.isfinite(b)
    assert np.array_equal(ok, np.isfinite(a))
    return float(np.max(np.abs(a[ok] / b[ok] - 1.0))) if ok.any() else 0.0


def _leases(prov, store, job, n):
    return [prov.read_lease(store, job, ci) for ci in range(n)]


# ---- plan and job record ---------------------------------------------------

def test_the_plan_is_run_sweep_s_resolution(bases, serial):
    _, _, tb, ts = bases
    plan = tsch.plan_elastic_sweep(tb, AXES, ts, chunk_size=CHUNK, n_y=N_Y, device="cpu")
    sp = tsw.plan_sweep(tb, AXES, ts, chunk_size=CHUNK, n_y=N_Y, device="cpu")
    assert plan.job == sp.hash
    assert plan.chunk_keys == [sp.chunk_key(ci) for ci in range(sp.n_chunks)]
    assert (plan.impl, plan.quad_on, plan.quad_report()) == ("tabulated", True,
                                                             (serial.quad_impl,
                                                              serial.n_quad_nodes))
    again = tsch.plan_elastic_sweep(tb, AXES, ts, chunk_size=CHUNK, n_y=N_Y, device="cpu")
    assert again.chunk_keys == plan.chunk_keys


def test_the_job_hash_and_record_match_jax_but_for_the_platform(bases):
    jb, js, tb, ts = bases
    jplan = jsch.plan_elastic_sweep(jb, AXES, js, chunk_size=CHUNK, n_y=N_Y)
    tplan = tsch.plan_elastic_sweep(tb, AXES, ts, chunk_size=CHUNK, n_y=N_Y, device="cpu")
    assert tplan.job == jplan.job
    rec = tplan.job_record()
    assert rec.pop("platform") == "torch-cpu"
    assert rec == jplan.job_record()


@pytest.mark.parametrize("drift", ["chunk_size", "n_y", "platform"])
def test_a_drifted_role_is_refused_by_the_job_record(bases, tmp_path, drift):
    import dataclasses

    import torch

    _, _, tb, ts = bases
    store = tprov.Store(str(tmp_path / "s"))
    plan = tsch.plan_elastic_sweep(tb, AXES, ts, chunk_size=CHUNK, n_y=N_Y, device="cpu")
    assert tsch.ensure_job_record(store, plan) == plan.job_record()
    if drift == "platform":
        other = dataclasses.replace(plan, device=torch.device("cuda", 0))
    else:
        other = dataclasses.replace(plan, **{drift: getattr(plan, drift) + 1})
    with pytest.raises(tsch.ElasticError, match="does not match"):
        tsch.ensure_job_record(store, other)


def test_a_torn_job_record_is_rewritten(bases, tmp_path):
    _, _, tb, ts = bases
    store = tprov.Store(str(tmp_path / "s"))
    plan = tsch.plan_elastic_sweep(tb, AXES, ts, chunk_size=CHUNK, n_y=N_Y, device="cpu")
    tsch.ensure_job_record(store, plan)
    with open(store.path_for(f"elastic/{plan.job}.json"), "w") as f:
        f.write('{"schema": 1, "ha')
    assert tsch.ensure_job_record(store, plan) == plan.job_record()


# ---- the lease plane: one trace, both packages ------------------------------

LEASE_TRACES = {
    "exclusive_while_live": [("claim", 0, "w0"), ("claim", 0, "w1"), ("state", 0),
                             ("state", 1)],
    "heartbeat_extends": [("claim", 0, "w0"), ("adv", 8.0), ("hb", 0, "w0"), ("adv", 8.0),
                          ("claim", 0, "w1"), ("hb", 0, "w1")],
    "expired_is_stolen": [("claim", 0, "w0"), ("adv", 11.0), ("claim", 0, "w1"),
                          ("hb", 0, "w0")],
    "terminal_states": [("claim", 0, "w0"), ("complete", 0, "w0"), ("claim", 0, "w1"),
                        ("adv", 100.0), ("claim", 0, "w1")],
    "distinct_failures_quarantine": [("fail", 0, "w0"), ("state", 0), ("claim", 0, "w1"),
                                     ("fail", 0, "w1"), ("state", 0), ("claim", 0, "w2")],
    "repeat_failure_counts_once": [("fail", 0, "w0"), ("fail", 0, "w0"), ("state", 0)],
    "requeue_expired": [("claim", 0, "w0"), ("claim", 1, "w1"), ("complete", 1, "w1"),
                        ("adv", 11.0), ("requeue_expired",), ("requeue_expired",)],
    "torn_record_frees": [("claim", 0, "w0"), ("tear", 0), ("claim", 0, "w1")],
    "expiry_to_quarantine": [("claim", 0, "w0"), ("adv", 11.0), ("claim", 0, "w1"),
                             ("adv", 11.0), ("claim", 0, "w2"), ("state", 0)],
    "requeue_after_torn_fold": [("claim", 2, "w0"), ("complete", 2, "w0"), ("requeue", 2),
                                ("claim", 2, "w1")],
}


def _replay(mod, prov, plan_cls, store_root, trace, churn=None):
    clock = mod.ManualClock()
    store = prov.Store(store_root)
    faults = None if churn is None else plan_cls.from_obj(churn)
    plane = mod.LeasePlane(store, "job0", 3, ttl_s=10.0, quarantine_after=2, clock=clock,
                           faults=faults)
    out = []
    for op, *args in trace:
        if op == "adv":
            clock.advance(args[0])
        elif op == "tear":
            with open(store.path_for(prov.lease_entry_name("job0", args[0])), "w") as f:
                f.write('{"state": "le')
        elif op == "state":
            out.append(plane.state(args[0]))
        elif op == "hb":
            out.append(plane.heartbeat(*args))
        elif op == "requeue_expired":
            out.append(plane.requeue_expired())
        else:
            out.append(getattr(plane, op)(*args))
    return out, _leases(prov, store, "job0", 3)


@pytest.mark.parametrize("name", sorted(LEASE_TRACES))
def test_a_lease_trace_leaves_jax_s_records(name, tmp_path):
    trace = LEASE_TRACES[name]
    jout, jrec = _replay(jsch, jprov, JPlan, str(tmp_path / "j"), trace)
    tout, trec = _replay(tsch, tprov, TPlan, str(tmp_path / "t"), trace)
    assert tout == jout
    assert trec == jrec


@pytest.mark.parametrize("kind", ["transient", "torn"])
def test_a_lease_fault_acts_as_in_jax(kind, tmp_path):
    churn = [{"site": "lease", "kind": kind, "chunk": 0, "times": 1}]
    trace = [("claim", 0, "w0"), ("state", 0), ("claim", 0, "w1"), ("claim", 0, "w2")]
    jout, jrec = _replay(jsch, jprov, JPlan, str(tmp_path / "j"), trace, churn)
    tout, trec = _replay(tsch, tprov, TPlan, str(tmp_path / "t"), trace, churn)
    assert tout == jout and trec == jrec


def test_the_clocks_advance_as_jax_s():
    from bdlz_tpu_torch.utils.clock import ManualClock, WallClock

    m = ManualClock(3.0)
    assert m() == 3.0 and m.advance(2.5) == m() == 5.5
    t, slept = [100.0], []

    def fake_sleep(s):
        slept.append(s)
        t[0] += s

    w = WallClock(time_fn=lambda: t[0], sleep=fake_sleep)
    assert w() == 100.0 and w.advance(3.0) == 103.0 and slept == [3.0]


def test_the_election_follows_jax_s(tmp_path):
    out = {}
    for label, elect, prov in (("j", j_elect, jprov), ("t", t_elect, tprov)):
        store = prov.Store(str(tmp_path / label))
        t = [0.0]
        seq = [elect(store, "job", "a", ttl_s=10.0, clock=lambda: t[0]),
               elect(store, "job", "b", ttl_s=10.0, clock=lambda: t[0]),
               elect(store, "job", "a", ttl_s=10.0, clock=lambda: t[0])]
        t[0] = 25.0
        seq.append(elect(store, "job", "b", ttl_s=10.0, clock=lambda: t[0]))
        seq.append(elect(store, "job", "a", ttl_s=10.0, clock=lambda: t[0]))
        out[label] = (seq, prov.read_lease(store, "job_coord", 0))
    assert out["t"] == out["j"]
    assert out["t"][0] == [True, False, True, True, False]


# ---- publish-then-commit ----------------------------------------------------

def _host(plan, ci, bump=0.0):
    lo, hi = plan.chunk_bounds(ci)
    return {f: np.linspace(1.0, 2.0, hi - lo) + bump for f in plan.fields}


@pytest.mark.parametrize("case", ["first_wins", "mismatch", "qmask", "torn"])
def test_the_commit_protocol(bases, tmp_path, case):
    _, _, tb, ts = bases
    store = tprov.Store(str(tmp_path / "c"))
    plan = tsch.plan_elastic_sweep(tb, AXES, ts, chunk_size=CHUNK, n_y=N_Y, device="cpu")
    assert tsch.publish_chunk(store, plan, 0, _host(plan, 0))
    if case == "first_wins":
        assert not tsch.publish_chunk(store, plan, 0, _host(plan, 0), n_retries=3)
    elif case == "mismatch":
        with pytest.raises(tsch.CommitMismatchError, match="field"):
            tsch.publish_chunk(store, plan, 0, _host(plan, 0, bump=1e-15))
    elif case == "qmask":
        with pytest.raises(tsch.CommitMismatchError, match="quarantine mask"):
            tsch.publish_chunk(store, plan, 0, _host(plan, 0),
                               qmask=np.array([True, False]))
    else:
        with open(store.path_for(plan.entry_name(0)), "wb") as f:
            f.write(b"PK\x03")
        assert tsch.publish_chunk(store, plan, 0, _host(plan, 0))


# ---- the engine ---------------------------------------------------------------

def test_a_clean_elastic_run_is_bitwise_the_serial_sweep(bases, serial, jax_serial,
                                                         tmp_path):
    folds = []
    res = _elastic(tsch, bases, str(tmp_path / "clean"), n_workers=3,
                   on_chunk=lambda ci, lo, hi, ent: folds.append((ci, lo, hi)))
    _bitwise(res, serial, "clean")
    assert sorted(folds) == [(0, 0, 2), (1, 2, 4), (2, 4, 6)]
    assert (res.n_failed, res.cache_hits, res.cache_misses) == (0, 0, 3)
    jres = _elastic(jsch, bases, str(tmp_path / "jclean"), n_workers=3)
    r = _rel(res.outputs["DM_over_B"], jres.outputs["DM_over_B"])
    print(f"RESIDUAL elastic clean vs JAX elastic {r:.3e}")
    assert r <= JAX_RTOL
    assert _rel(serial.outputs["DM_over_B"], jax_serial.outputs["DM_over_B"]) <= JAX_RTOL


CHURN = {
    "crash_lease_torn_read": dict(churn=[
        {"site": "worker_crash", "kind": "transient", "chunk": 1, "times": 1},
        {"site": "lease", "kind": "transient", "chunk": 2, "times": 1},
        {"site": "store_read", "kind": "torn", "call": 0}],
        kw=dict(n_workers=2, lease_ttl_s=5.0, churn_schedule=[(1, "kill"), (2, "spawn")])),
    "fleet_quarantine": dict(churn=[
        {"site": "worker_crash", "kind": "transient", "chunk": 1, "times": 2}],
        kw=dict(n_workers=2, lease_ttl_s=2.0, quarantine_after=2)),
    "torn_lease": dict(churn=[{"site": "lease", "kind": "torn", "chunk": 0, "times": 1}],
                       kw=dict(n_workers=2, lease_ttl_s=3.0)),
}


@pytest.mark.parametrize("name", sorted(CHURN))
def test_churn_matches_jax_and_keeps_the_serial_bits(bases, serial, tmp_path, name):
    spec = CHURN[name]
    t_store, j_store = str(tmp_path / "t"), str(tmp_path / "j")
    res = _elastic(tsch, bases, t_store, churn_plan=TPlan.from_obj(spec["churn"]),
                   **spec["kw"])
    jres = _elastic(jsch, bases, j_store, churn_plan=JPlan.from_obj(spec["churn"]),
                    **spec["kw"])
    np.testing.assert_array_equal(res.quarantined_mask, jres.quarantined_mask)
    np.testing.assert_array_equal(res.failed_mask, jres.failed_mask)
    assert (res.n_quarantined, res.n_retries) == (jres.n_quarantined, jres.n_retries)
    plan = tsch.plan_elastic_sweep(bases[2], AXES, bases[3], chunk_size=CHUNK, n_y=N_Y,
                                   device="cpu")
    trec = _leases(tprov, tprov.Store(t_store), plan.job, plan.n_chunks)
    jrec = _leases(jprov, jprov.Store(j_store), plan.job, plan.n_chunks)
    keys = ("state", "worker", "generation", "failures", "expires_at")
    assert [{k: r.get(k) for k in keys} for r in trec] == \
           [{k: r.get(k) for k in keys} for r in jrec]
    q = res.quarantined_mask
    for f in serial.outputs:
        a, b = np.asarray(res.outputs[f]), np.asarray(serial.outputs[f])
        assert a[~q].tobytes() == b[~q].tobytes(), f
        assert np.isnan(a[q]).all()
    r = _rel(res.outputs["DM_over_B"][~q], jres.outputs["DM_over_B"][~q])
    print(f"RESIDUAL elastic churn {name} vs JAX {r:.3e}")
    assert r <= JAX_RTOL
    if name == "fleet_quarantine":
        assert q[2:4].all() and q.sum() == 2
    else:
        assert not q.any()
    if name == "crash_lease_torn_read":
        # the crashed worker's lease expired onto the failure list
        assert trec[1]["failures"] and trec[1]["state"] == "done"


def test_a_poison_point_is_bisected_out_as_in_jax(bases, serial, tmp_path):
    plan = [{"site": "step", "kind": "poison", "point": 3}]
    res = _elastic(tsch, bases, str(tmp_path / "t"), fault_plan=TPlan.from_obj(plan))
    jres = _elastic(jsch, bases, str(tmp_path / "j"), fault_plan=JPlan.from_obj(plan))
    ser = tsw.run_sweep(bases[2], AXES, bases[3], chunk_size=CHUNK, n_y=N_Y,
                        retry=_tretry(), device="cpu", fault_plan=TPlan.from_obj(plan))
    assert np.flatnonzero(res.quarantined_mask).tolist() == [3]
    for other in (jres, ser):
        np.testing.assert_array_equal(res.quarantined_mask, other.quarantined_mask)
        assert res.n_retries == other.n_retries
    _bitwise(res, ser, "poison")


def test_the_elastic_store_warms_run_sweep_s_cache_and_back(bases, serial, tmp_path):
    _, _, tb, ts = bases
    store = str(tmp_path / "warm")
    _elastic(tsch, bases, store)
    warm = tsw.run_sweep(tb, AXES, ts, chunk_size=CHUNK, n_y=N_Y, retry=_tretry(),
                         device="cpu", cache=store)
    assert (warm.cache_hits, warm.cache_misses) == (3, 0)
    _bitwise(warm, serial, "run_sweep from the elastic store")
    again = _elastic(tsch, bases, store)
    assert (again.cache_hits, again.cache_misses) == (3, 0)
    _bitwise(again, serial, "prescan fold")


def test_an_external_worker_drains_then_the_coordinator_folds(bases, serial, tmp_path):
    _, _, tb, ts = bases
    store = tprov.Store(str(tmp_path / "roles"))
    t = [0.0]
    summary = twk.run_worker_loop(
        tb, AXES, ts, store=store, worker_id="wext", chunk_size=CHUNK, n_y=N_Y,
        retry=_tretry(), device="cpu", lease_ttl_s=30.0, poll_s=0.5, clock=lambda: t[0],
        sleep=lambda s: t.__setitem__(0, t[0] + s))
    assert summary["alive"] and summary["chunks_done"] == 3
    res = _elastic(tsch, bases, store)
    assert res.cache_hits == 3
    _bitwise(res, serial, "worker then fold")


def test_a_crashed_external_worker_reports_itself_dead_as_in_jax(bases, tmp_path):
    churn = [{"site": "worker_crash", "kind": "raise", "chunk": 0}]
    out = {}
    for label, wk, plan_cls, retry, base, static, kw in (
            ("j", jwk, JPlan, _jretry(), bases[0], bases[1], {}),
            ("t", twk, TPlan, _tretry(), bases[2], bases[3], {"device": "cpu"})):
        t = [0.0]
        out[label] = wk.run_worker_loop(
            base, AXES, static, store=str(tmp_path / label), worker_id="w", chunk_size=CHUNK,
            n_y=N_Y, retry=retry, churn_plan=plan_cls.from_obj(churn), clock=lambda: t[0],
            sleep=lambda s: t.__setitem__(0, t[0] + s), **kw)
    assert out["t"] == out["j"]
    assert out["t"]["alive"] is False and out["t"]["chunks_done"] == 0


def test_a_stuck_protocol_raises_instead_of_hanging(bases, tmp_path):
    churn = TPlan.from_obj([{"site": "lease", "kind": "transient", "chunk": ci,
                             "times": 10**6} for ci in range(3)])
    with pytest.raises(tsch.ElasticError, match="no full progress"):
        _elastic(tsch, bases, str(tmp_path / "stuck"), churn_plan=churn, max_rounds=4)


def test_elastic_mode_needs_a_store_and_ships_no_profile(bases):
    _, _, tb, ts = bases
    with pytest.raises(tsch.ElasticError, match="trusted store"):
        tsch.run_sweep_elastic(tb, AXES, ts, store=None, device="cpu")
    chain = ts._replace(lz_mode="chain")
    with pytest.raises(tsch.ElasticError, match="bounce profile"):
        tsch.plan_elastic_sweep(tb, AXES, chain, device="cpu")


def test_the_emulator_s_elastic_fill_equals_its_serial_fill(bases, tmp_path):
    from bdlz_tpu_torch.emulator.build import EmulatorBuildError, _exact_fields

    _, _, tb, ts = bases
    axes = {k: np.asarray(v) for k, v in AXES.items()}
    st = ts._replace(quad_panel_gl=False)
    kw = dict(chunk_size=CHUNK, n_y=N_Y, impl="tabulated", device="cpu", retry=_tretry())
    ser, n = _exact_fields(tb, axes, st, **kw)
    el, n_el = _exact_fields(tb, axes, st, cache=str(tmp_path / "emu"), elastic=2, **kw)
    assert n == n_el == 6
    for f in ser:
        assert np.asarray(el[f]).tobytes() == np.asarray(ser[f]).tobytes(), f
    with pytest.raises(EmulatorBuildError, match="shared store"):
        _exact_fields(tb, axes, st, elastic=2, **kw)


# ---- the CLI roles -------------------------------------------------------------

def _cfg(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(ARCHIVED))
    return str(path)


AXIS_FLAGS = ["--axis", "m_chi_GeV=0.5,1.0,2.0", "--axis", "T_p_GeV=80,150",
              "--chunk", str(CHUNK), "--n-y", str(N_Y)]


def test_the_local_role_prints_the_static_summary(tmp_path, capsys):
    from bdlz_tpu_torch.sweep_cli import main

    cfg = _cfg(tmp_path)
    main(["--config", cfg, *AXIS_FLAGS, "--device", "cpu"])
    static = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    main(["--config", cfg, *AXIS_FLAGS, "--device", "cpu", "--elastic", "local",
          "--elastic-store", str(tmp_path / "store"), "--elastic-workers", "3"])
    elastic = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert elastic.pop("elastic") == "local"
    for k in ("seconds", "points_per_sec"):
        static.pop(k), elastic.pop(k)
    assert elastic == static


@pytest.mark.parametrize("argv,msg", [
    (["--elastic", "local"], "--elastic requires --elastic-store"),
    (["--elastic", "local", "--elastic-store", "s", "--out", "o"], "--out"),
    (["--elastic", "local", "--elastic-store", "s", "--profile-dir", "p"], "--profile-dir"),
    (["--elastic", "local", "--elastic-store", "s", "--lz-profile", "p.csv"], "--lz-profile"),
])
def test_the_elastic_flags_are_refused_as_in_jax(tmp_path, capsys, argv, msg):
    from bdlz_tpu_torch.sweep_cli import main

    with pytest.raises(SystemExit) as exc:
        main(["--config", _cfg(tmp_path), *AXIS_FLAGS, "--device", "cpu", *argv])
    assert exc.value.code == 2 and msg in capsys.readouterr().err


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def _role(cfg, store, worker_id, *extra):
    return [sys.executable, "-m", "bdlz_tpu_torch.sweep_cli", "--config", cfg, *AXIS_FLAGS,
            "--device", "cpu", "--elastic-store", store, "--worker-id", worker_id,
            "--poll", "0.1", *extra]


def _fold(bases, store):
    return _elastic(tsch, bases, store)


def test_processes_elect_one_coordinator_and_fold_the_serial_bits(bases, serial,
                                                                  tmp_path):
    cfg, store = _cfg(tmp_path), str(tmp_path / "mp")
    procs = [subprocess.Popen(_role(cfg, store, f"p{i}", "--elastic", "auto"),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=_child_env()) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-2000:]
            outs.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    roles = sorted("coordinator" if "elected coordinator" in err else "worker"
                   for _, err in outs)
    assert roles == ["coordinator", "worker"]
    res = _fold(bases, store)
    assert res.cache_hits == 3
    _bitwise(res, serial, "two processes")


def test_a_crashed_worker_process_is_recovered_by_the_coordinator(bases, serial,
                                                                  tmp_path):
    cfg, store = _cfg(tmp_path), str(tmp_path / "crash")
    churn = json.dumps([{"site": "worker_crash", "kind": "raise", "chunk": 0}])
    crashed = subprocess.run(_role(cfg, store, "doomed", "--elastic", "worker",
                                   "--churn-plan", churn, "--lease-ttl", "1"),
                             capture_output=True, text=True, env=_child_env(), timeout=240)
    assert crashed.returncode == 0, crashed.stderr[-2000:]
    assert json.loads(crashed.stdout.strip().splitlines()[-1])["alive"] is False
    coord = subprocess.run(_role(cfg, store, "coord", "--elastic", "coordinator",
                                 "--lease-ttl", "1"),
                           capture_output=True, text=True, env=_child_env(), timeout=240)
    assert coord.returncode == 0, coord.stderr[-2000:]
    assert json.loads(coord.stdout.strip().splitlines()[-1])["n_failed"] == 0
    plan = tsch.plan_elastic_sweep(bases[2], AXES, bases[3], chunk_size=CHUNK, n_y=N_Y,
                                   device="cpu")
    rec = tprov.read_lease(tprov.Store(store), plan.job, 0)
    assert rec["state"] == "done" and "doomed" in rec["failures"]
    _bitwise(_fold(bases, store), serial, "crash recovered")
