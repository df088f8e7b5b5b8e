"""The port's closed refinement loop against the JAX package's, on the CPU.

* C5: an armed ``ServeStats.traffic_log`` records the same entries in
  both packages (the micro-batcher, the fleet's fast path and its
  degraded path); unarmed it is a no-op and the summary schema does not
  change.
* Traffic snapshots: fingerprints byte-equal to JAX's, a snapshot saved
  by either package loads in the other, and the model folds as JAX's.
* Delivery miss scores ≤1e-14 from JAX's.
* The daemon on one fleet: the same seed artifact (built by the JAX
  package), the same drifted requests, a fake clock; the drift step,
  the snapshot fingerprints, the candidate identity and the delivery
  decision equal JAX's, the fallback rate drops at least 2×, far
  out-of-domain answers are bitwise equal across the rollout, and the
  elastic rebuild is bitwise the serial one.

Residuals print as ``RESIDUAL`` lines (``pytest -s``)."""
import dataclasses
import json
import types

import numpy as np
import pytest
from _serve_common import FakeClock, fleet, make_served, pump

import bdlz_tpu.refine as jr
import bdlz_tpu.serve as js
import bdlz_tpu_torch.refine as tr
import bdlz_tpu_torch.serve as ts
from bdlz_tpu.config import config_from_dict as jcfg
from bdlz_tpu.provenance import Store as JStore
from bdlz_tpu.utils.profiling import ServeStats as JStats
from bdlz_tpu_torch.config import config_from_dict as tcfg
from bdlz_tpu_torch.provenance import Store as TStore
from bdlz_tpu_torch.utils.profiling import ServeStats as TStats

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
AXES = ("m_chi_GeV", "T_p_GeV")
DRIFT_LO, DRIFT_HI = np.array([0.95, 95.0]), np.array([1.08, 108.0])
FAR_OOD = np.array([2.0, 150.0])
BUILD_KW = dict(n_probe=6, max_rounds=2, n_y=200, rtol=1e-3, chunk_size=16)
MISS_ATOL = 1e-14


# ---- C5: the traffic trace ----------------------------------------------------

def test_an_unarmed_trace_is_a_no_op_and_the_summary_schema_holds():
    def fill(st):
        st.record_batch(batch_index=0, size=4, occupancy=0.5, wait_s=0.01, n_fallback=1,
                        seconds=0.1)
        st.record_latency(0.02)

    plain, armed, jax_plain = TStats(), TStats(), JStats()
    for st in (plain, armed, jax_plain):
        fill(st)
    plain.record_queries(np.ones((4, 2)), "ood")
    assert plain.traffic_log is None
    armed.arm_traffic_log()
    armed.record_queries(np.ones((4, 2)), [None, "ood", None, None])
    dump = lambda st: json.dumps(st.summary(), sort_keys=True)  # noqa: E731
    assert dump(plain) == dump(armed) == dump(jax_plain)


def test_an_armed_trace_broadcasts_reasons_as_jax_s():
    logs = []
    for st in (JStats(), TStats()):
        st.arm_traffic_log()
        st.record_queries([1.0, 2.0])
        st.record_queries(np.ones((2, 2)), "degraded")
        st.record_queries(np.zeros((2, 2)), ["ood", None])
        logs.append(st.traffic_log)
    assert logs[1] == logs[0]
    assert [r for _, r in logs[1]] == [None, "degraded", "degraded", "ood", None]


@pytest.fixture(scope="module")
def served(tiny_emulator):
    return make_served(tiny_emulator)


def test_the_micro_batcher_logs_every_request_as_jax_s(served):
    th = served.thetas[:96]
    logs = []
    for mod, art, base, kw in ((js, served.jart, served.jbase, {}),
                               (ts, served.tart, served.tbase, {"device": "cpu"})):
        svc = mod.YieldService(art, base, max_batch_size=32, error_gate_tol=served.gate, **kw)
        clock = FakeClock()
        mb = svc.make_batcher(max_wait_s=0.004, clock=clock)
        mb.stats.arm_traffic_log()
        futs = [mb.submit(t) for t in th]
        while mb.run_once(force=True):
            pass
        for f in futs:
            f.result(timeout=0)
        logs.append(mb.stats.traffic_log)
    assert len(logs[1]) == len(th)
    assert logs[1] == logs[0]


@pytest.mark.parametrize("plan", [None, [{"site": "replica_dispatch", "kind": "raise"}]],
                         ids=["fast_path", "degraded_path"])
def test_the_fleet_logs_every_request_as_jax_s(served, plan):
    th = served.thetas[:96]
    logs = []
    for mod in (js, ts):
        f, clock = fleet(mod, served, n_replicas=2, plan=plan, gate=served.gate)
        f.stats.arm_traffic_log()
        pump(f, clock, th)
        logs.append(f.stats.traffic_log)
        f.close()
    assert len(logs[1]) == len(th)
    assert logs[1] == logs[0]
    if plan is not None:
        assert {r for _, r in logs[1]} == {"degraded"}


# ---- snapshots -----------------------------------------------------------------

def _snap(mod, n=8, seed=0, reasons=None, occupancy=None):
    rng = np.random.default_rng(seed)
    locs = rng.uniform([0.9, 90.0], [1.1, 110.0], (n, 2))
    if reasons is None:
        reasons = tuple(["ood", None, "predicted_error", None] * (n // 4 + 1))[:n]
    return mod.TrafficSnapshot(axis_names=AXES, locations=locs, reasons=reasons,
                               occupancy=occupancy or {"default": 0.5})


@pytest.mark.parametrize("n,seed,occ", [(8, 0, None), (40, 3, {"a": 0.25, "b": 1.0}),
                                        (3, 9, {})])
def test_snapshot_fingerprints_rates_and_splits_are_jax_s(n, seed, occ):
    j, t = _snap(jr, n, seed, occupancy=occ), _snap(tr, n, seed, occupancy=occ)
    assert t.fingerprint == j.fingerprint
    assert (t.ood_rate, t.gated_rate, t.fallback_rate) == (j.ood_rate, j.gated_rate,
                                                         j.fallback_rate)
    (jt, jh), (tt, th) = j.split_holdout(0.25), t.split_holdout(0.25)
    assert tt.fingerprint == jt.fingerprint and np.array_equal(th, jh)


def test_a_snapshot_saved_by_either_package_loads_in_the_other(tmp_path):
    for save_mod, save_store, load_mod, load_store in (
            (jr, JStore, tr, TStore), (tr, TStore, jr, JStore)):
        root = str(tmp_path / save_mod.__name__)
        fp = save_mod.save_snapshot(save_store(root), _snap(save_mod, 12, 4))
        back = load_mod.load_snapshot(load_store(root), fp)
        assert back.fingerprint == fp and back.n_queries == 12


@pytest.mark.parametrize("case", ["nan", "shape", "reasons", "missing", "skew", "tamper",
                                  "bad_frac", "empty_model", "bad_window"])
def test_bad_snapshots_are_refused_as_in_jax(tmp_path, case):
    msgs = []
    for mod, store_cls in ((jr, JStore), (tr, TStore)):
        store = store_cls(str(tmp_path / mod.__name__))
        with pytest.raises(mod.TrafficSnapshotError) as exc:
            if case == "nan":
                mod.TrafficSnapshot(AXES, np.array([[np.nan, 1.0]]), (None,))
            elif case == "shape":
                mod.TrafficSnapshot(AXES, np.ones((2, 3)), (None, None))
            elif case == "reasons":
                mod.TrafficSnapshot(AXES, np.ones((2, 2)), (None,))
            elif case == "missing":
                mod.load_snapshot(store, "0" * 16)
            elif case == "bad_frac":
                _snap(mod).split_holdout(1.5)
            elif case == "empty_model":
                mod.TrafficModel(AXES).snapshot()
            elif case == "bad_window":
                mod.TrafficModel(AXES, window=0)
            else:
                fp = mod.save_snapshot(store, _snap(mod))
                path = store.path_for(mod.snapshot_entry_name(fp))
                payload = json.load(open(path))
                if case == "skew":
                    payload["schema"] = 99
                else:
                    payload["locations"][0][0] += 1e-3
                json.dump(payload, open(path, "w"))
                mod.load_snapshot(store, fp)
        msgs.append(str(exc.value))
    assert msgs[1] == msgs[0]


def test_the_traffic_model_folds_as_jax_s():
    out = []
    for mod, stats_cls in ((jr, JStats), (tr, TStats)):
        st = stats_cls()
        st.arm_traffic_log()
        model = mod.TrafficModel(AXES, window=6)
        rows = []
        for k in range(3):
            st.record_queries(np.full((3, 2), float(k)), ["ood", None, "predicted_error"])
            st.record_batch(batch_index=k, size=3, occupancy=0.25 * (k + 1), wait_s=0.0,
                            n_fallback=2, seconds=0.0)
            rows.append((model.fold(st, pool="p"), model.n_queries, model.ood_rate,
                         model.gated_rate))
        snap = model.snapshot()
        model.reset_window()
        rows.append((model.fold(st), model.n_queries, snap.fingerprint, model.occupancy()))
        out.append(rows)
    assert out[1] == out[0]


# ---- delivery ------------------------------------------------------------------

def test_miss_scores_match_jax(served):
    rng = np.random.default_rng(11)
    lo, hi = served.jart.hull
    locs = rng.uniform(lo - 0.1 * (hi - lo), hi + 0.1 * (hi - lo), (64, 3))
    for tol in (1e-4, served.gate):
        j = jr.delivery.traffic_miss_score(served.jart, locs, tol)
        t = tr.traffic_miss_score(served.tart, locs, tol, device="cpu")
        print(f"RESIDUAL delivery miss score tol={tol:.2e} {abs(t - j):.3e}")
        assert abs(t - j) <= MISS_ATOL
    with pytest.raises(tr.DeliveryError, match="empty"):
        tr.traffic_miss_score(served.tart, np.empty((0, 3)), 1e-4, device="cpu")


def test_the_daemon_refuses_as_in_jax(served, tmp_path):
    msgs = []
    for mod, smod, art, base, kw in (
            (jr, js, served.jart, served.jbase, {}),
            (tr, ts, served.tart, served.tbase, {"devices": ["cpu"]})):
        svc = smod.FleetService(art, base, max_batch_size=8, **kw)
        off = dataclasses.replace(base, self_improve=False)
        for b, store in ((off, str(tmp_path)), (base, None)):
            with pytest.raises(mod.RefineError) as exc:
                mod.RefinementDaemon(svc, b, store=store)
            msgs.append(str(exc.value))
        assert [mod.resolve_self_improve(dataclasses.replace(base, self_improve=v), e)
                for v in (None, True, False) for e in (False, True)] == \
               [False, True, True, True, False, False]
        svc.close()
    assert msgs[2:] == msgs[:2]


# ---- the closed loop -------------------------------------------------------------

def _pump1(svc, clock):
    clock.advance(0.01)
    svc.run_once(force=True)
    svc.poll(block=True)


def _serve_block(svc, clock, thetas):
    futs = [svc.submit(t) for t in np.atleast_2d(thetas)]
    _pump1(svc, clock)
    return [f.result() for f in futs]


def _run_loop(mod, smod, store, seed_art, base, **fleet_kw):
    """The closed loop on one fleet: drifted traffic until one cycle has
    run, the same distribution on the new surface, then a second drift
    past the budget."""
    clock = FakeClock()
    svc = smod.FleetService(seed_art, base, max_batch_size=8, n_replicas=2,
                            routing="round_robin", max_wait_s=1e-3, clock=clock, **fleet_kw)
    daemon = mod.RefinementDaemon(svc, base, store=store, clock=clock, window=256,
                                  min_queries=32, drift_gated_rate=0.05, rebuild_budget=1,
                                  observe_s=0.5, build_kw=BUILD_KW, elastic=2)
    rng = np.random.default_rng(7)
    far_before = _serve_block(svc, clock, FAR_OOD)[0]
    statuses = []
    for _ in range(8):
        _serve_block(svc, clock, rng.uniform(DRIFT_LO, DRIFT_HI, (8, 2)))
        statuses.append(daemon.step())
    rows = list(svc.stats.rows)
    fb1 = sum(r.n_fallback for r in rows) / sum(r.size for r in rows)
    far_after = _serve_block(svc, clock, FAR_OOD)[0]
    candidate = svc.artifact
    h2 = len(svc.stats.rows)
    for _ in range(8):
        _serve_block(svc, clock, rng.uniform(DRIFT_LO, DRIFT_HI, (8, 2)))
    rows2 = svc.stats.rows[h2:]
    fb2 = sum(r.n_fallback for r in rows2) / sum(r.size for r in rows2)
    for _ in range(5):
        _serve_block(svc, clock, rng.uniform([1.5, 150.0], [1.6, 160.0], (8, 2)))
    exhausted = daemon.step()
    svc.close()
    return types.SimpleNamespace(
        svc=svc, daemon=daemon, statuses=statuses, history=list(daemon.history), fb1=fb1,
        fb2=fb2, far_before=far_before, far_after=far_after, candidate=candidate,
        exhausted=exhausted, store=store)


@pytest.fixture(scope="module")
def loops(tmp_path_factory, jit_warmup):
    from bdlz_tpu.emulator.build import AxisSpec, build_emulator
    from bdlz_tpu_torch.emulator import load_artifact

    root = tmp_path_factory.mktemp("refine")
    jstore = JStore(str(root / "jax_store"))
    spec = {"m_chi_GeV": AxisSpec(0.9, 1.0, 3, "log"), "T_p_GeV": AxisSpec(90.0, 100.0, 3, "log")}
    seed_dir = str(root / "seed")
    seed, _ = build_emulator(jcfg(ARCHIVED), spec, cache=jstore, out_dir=seed_dir, **BUILD_KW)
    jloop = _run_loop(jr, js, jstore, seed, jcfg(ARCHIVED))
    tloop = _run_loop(tr, ts, TStore(str(root / "port_store")), load_artifact(seed_dir),
                      tcfg(ARCHIVED), devices=["cpu"])
    return jloop, tloop, seed_dir


def _status_rows(statuses):
    keys = ("state", "folded", "window", "gated_rate", "ood_rate", "cycles", "drifted")
    return [{k: s.get(k) for k in keys} for s in statuses]


def test_the_drift_step_and_the_snapshots_are_jax_s(loops):
    jloop, tloop, _ = loops
    assert _status_rows(tloop.statuses) == _status_rows(jloop.statuses)
    assert len(tloop.history) == 1
    keys = ("snapshot", "train_snapshot", "n_queries", "snapshot_gated_rate",
            "snapshot_ood_rate", "build_converged")
    assert {k: tloop.history[0][k] for k in keys} == {k: jloop.history[0][k] for k in keys}


def test_the_candidate_identity_and_the_decision_are_jax_s(loops):
    jloop, tloop, _ = loops
    assert dict(tloop.candidate.identity) == dict(jloop.candidate.identity)
    ident = dict(tloop.candidate.identity)
    assert ident["refine_signal"] == "traffic"
    assert ident["traffic"] == tloop.history[0]["train_snapshot"]
    jd, td = jloop.history[0]["decision"], tloop.history[0]["decision"]
    skip = ("published_hash", "new_hash")
    assert {k: v for k, v in td.items() if k not in skip} == \
           {k: v for k, v in jd.items() if k not in skip}
    assert td["outcome"] == "promoted" and td["new_hash"] == tloop.candidate.content_hash
    man = tloop.candidate.manifest
    assert man["traffic_fingerprint"] == ident["traffic"] and man["traffic_queries"] > 0
    for node_t, node_j in zip(tloop.candidate.axis_nodes, jloop.candidate.axis_nodes):
        assert np.array_equal(node_t, node_j)
    r = max(float(np.max(np.abs(np.asarray(tloop.candidate.values[f])
                                / np.asarray(jloop.candidate.values[f]) - 1.0)))
            for f in jloop.candidate.values)
    print(f"RESIDUAL refined candidate table vs JAX {r:.3e}")
    assert r <= 1e-12


def test_the_rollout_events_and_the_fallback_drop_are_jax_s(loops):
    jloop, tloop, _ = loops
    assert tloop.fb1 > 0.2 and tloop.fb2 < tloop.fb1 / 2
    assert (tloop.fb1, tloop.fb2) == (jloop.fb1, jloop.fb2)
    assert tloop.far_before.fallback_reason == tloop.far_after.fallback_reason == "ood"
    assert np.float64(tloop.far_before.value).tobytes() == \
           np.float64(tloop.far_after.value).tobytes()
    assert abs(tloop.far_after.value / jloop.far_after.value - 1.0) <= 1e-12
    st, sj = tloop.exhausted, jloop.exhausted
    assert (st["state"], st["drifted"], st["cycles"]) == (sj["state"], sj["drifted"],
                                                        sj["cycles"]) == ("exhausted", True, 1)


def test_the_snapshot_of_the_cycle_loads_in_both_packages(loops):
    jloop, tloop, _ = loops
    fp = tloop.history[0]["snapshot"]
    for mod, store in ((tr, tloop.store), (jr, JStore(tloop.store.root))):
        snap = mod.load_snapshot(store, fp)
        assert snap.fingerprint == fp and "default" in snap.occupancy
    assert jr.load_snapshot(jloop.store, fp).fingerprint == fp


def test_the_elastic_rebuild_is_bitwise_the_serial_one(loops):
    from bdlz_tpu_torch.emulator import build_emulator, load_artifact

    _, tloop, seed_dir = loops
    train = tr.load_snapshot(tloop.store, tloop.history[0]["train_snapshot"])
    spec = tloop.daemon._expanded_spec(train, artifact=load_artifact(seed_dir))
    serial, _ = build_emulator(tcfg(ARCHIVED), spec, refine_signal="traffic", traffic=train,
                               device="cpu", **BUILD_KW)
    assert serial.content_hash == tloop.candidate.content_hash


def test_a_candidate_that_does_not_win_is_not_published(loops):
    import os

    from bdlz_tpu_torch.provenance.registry import ARTIFACT_KIND

    _, tloop, _ = loops
    svc = ts.FleetService(tloop.candidate, tcfg(ARCHIVED), max_batch_size=8, n_replicas=2,
                          max_wait_s=1e-3, clock=FakeClock(), devices=["cpu"])
    held = tr.load_snapshot(tloop.store, tloop.history[0]["snapshot"]).split_holdout(0.25)[1]
    reg = os.path.join(tloop.store.root, ARTIFACT_KIND)
    before = sorted(os.listdir(reg))
    decision = tr.DeliveryPipeline(svc, tloop.store).deliver(tloop.candidate, held)
    assert decision["outcome"] == "rejected" and "published_hash" not in decision
    assert sorted(os.listdir(reg)) == before
    svc.close()


# ---- the serve CLI's refusals ------------------------------------------------------

@pytest.mark.parametrize("extra,msg", [
    ([], "add --replicas N"),
    (["--tenant-map", '{"coherent": "0123456789abcdef"}'], "tenant-map"),
    (["--replicas", "1"], "provenance store"),
])
def test_self_improve_is_refused_where_jax_refuses_it(tiny_emulator, tmp_path, capsys,
                                                      monkeypatch, extra, msg):
    from bdlz_tpu.serve.serve_cli import main as jmain
    from bdlz_tpu_torch.serve.serve_cli import main as tmain

    monkeypatch.delenv("BDLZ_CACHE_ROOT", raising=False)
    _, out_dir, _, _ = tiny_emulator
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(ARCHIVED))
    argv = ["--config", str(cfg), "--self-improve", "on", "--requests", str(cfg), *extra]
    if "--tenant-map" not in extra:
        argv += ["--artifact", out_dir]
    errs = []
    for main, dev in ((jmain, []), (tmain, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as exc:
            main(argv + dev)
        assert exc.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert msg in errs[1]
    assert errs[1].split("error: ")[-1] == errs[0].split("error: ")[-1]
