"""The port's cross-host serving fabric against the JAX package's, on the
CPU, over two artifacts published by the JAX package into one store:
host-lease membership (create, extend, steal with a generation bump, a
live-seat collision refused, a torn record fenced then healed), the
router's choices and fencing (``heartbeat_loss``), whole-host failover
(``host_crash``: typed ``ServiceUnavailable`` for queued work, the
failover ladder, a fetch-by-hash readmission bitwise the dead host's
answers), ``store_partition`` answered by the loud degraded exact path
and healed, and idle-host chunk stealing bitwise the serial sweep.  Each
sequence runs in both packages and must give the same records and
events; a two-process failover runs real port processes.

Residuals print as ``RESIDUAL`` lines (``pytest -s``)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from _serve_common import FakeClock

import bdlz_tpu.parallel.multihost as jmh
import bdlz_tpu.serve as js
import bdlz_tpu_torch.parallel.multihost as tmh
import bdlz_tpu_torch.serve as ts
from bdlz_tpu.config import config_from_dict as jcfg
from bdlz_tpu.faults import FaultPlan as JPlan
from bdlz_tpu.provenance import Store as JStore
from bdlz_tpu_torch.config import config_from_dict as tcfg
from bdlz_tpu_torch.faults import FaultPlan as TPlan
from bdlz_tpu_torch.provenance import Store as TStore

PHYS = {"regime": "nonthermal", "source_shape_sigma_y": 9.0,
        "incident_flux_scale": 1.07e-9, "Y_chi_init": 4.90e-10, "P_chi_to_B": 0.1}
EXACT_RTOL = 1e-12


@pytest.fixture(scope="module")
def plane(tmp_path_factory, jit_warmup):
    from bdlz_tpu.emulator import AxisSpec, build_emulator
    from bdlz_tpu.provenance import publish_artifact

    spec = {"m_chi_GeV": AxisSpec(0.9, 1.1, 2, "log"), "v_w": AxisSpec(0.25, 0.35, 3, "lin")}
    kw = dict(rtol=1e-2, n_probe=4, n_holdout=8, max_rounds=1, n_y=400, chunk_size=64,
              require_converged=False)
    root = tmp_path_factory.mktemp("fabric")
    art_a, _ = build_emulator(jcfg(PHYS), spec, **kw)
    art_b, _ = build_emulator(jcfg(dict(PHYS, P_chi_to_B=0.2)), spec, **kw)
    seed = JStore(str(root / "seed"))
    h_a, h_b = publish_artifact(seed, art_a), publish_artifact(seed, art_b)
    return {"root": root, "seed": str(root / "seed"), "h_a": h_a, "h_b": h_b,
            "tenant_map": {"coherent": h_a, "heavy": h_b}}


def _store(mod, plane, label):
    """A fresh copy of the seed registry for one package's run."""
    import shutil

    root = str(plane["root"] / f"{label}_{mod.__name__}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(plane["seed"], root)
    return (JStore if mod is js else TStore)(root)


def _fabric(mod, plane, clock, label, n=2, host_kw=None, ttl_s=30.0):
    store = _store(mod, plane, label)
    hosts = []
    for i in range(n):
        kw = dict((host_kw or {}).get(i, {}))
        if "fault_plan" in kw:
            kw["fault_plan"] = (JPlan if mod is js else TPlan).from_obj(kw["fault_plan"])
        if "cache_root" in kw:
            kw["cache_root"] = f"{kw['cache_root']}_{mod.__name__}"
        if mod is ts:
            kw["devices"] = ["cpu"]
        cfg = jcfg(PHYS) if mod is js else tcfg(PHYS)
        hosts.append(mod.FabricHost(cfg, fabric=label, host_id=f"h{i}", host_index=i,
                                    store=store, tenant_map=plane["tenant_map"], clock=clock,
                                    ttl_s=ttl_s, max_batch_size=4, **kw))
    fab = mod.ServingFabric(hosts, mod.GlobalRouter(store, label, n, clock=clock))
    fab.register_all()
    return fab, store


def _thetas(n, seed=5):
    rng = np.random.default_rng(seed)
    return np.column_stack([rng.uniform(0.92, 1.08, n), rng.uniform(0.26, 0.34, n)])


def _outcome(fut):
    try:
        r = fut.result(timeout=0)
        return ("ok", r.artifact_hash, r.replica, r.fallback_reason, r.degraded, r.host_id,
                r.value)
    except Exception as exc:  # noqa: BLE001 — compared
        return ("err", type(exc).__name__, str(exc))


def _both(plane, label, drive, **kw):
    out = {}
    for mod in (js, ts):
        clock = FakeClock()
        fab, store = _fabric(mod, plane, clock, label, **kw)
        try:
            out[mod] = drive(mod, fab, store, clock)
        finally:
            fab.close()
    return out[js], out[ts]


def _same(jout, tout, label):
    """Equal outcomes; values bitwise for the emulator, ≤1e-12 for the
    exact pipeline."""
    assert [o[:-1] if o[0] == "ok" else o for o in tout] == \
           [o[:-1] if o[0] == "ok" else o for o in jout], label
    for t, j in zip(tout, jout):
        if t[0] == "ok":
            tol = 1e-14 if t[3] is None else EXACT_RTOL
            assert abs(t[-1] / j[-1] - 1.0) <= tol, label


def _live(fab):
    return [r["host_id"] for r in fab.router.live()]


# ---- host-lease membership -------------------------------------------------------

def test_register_and_heartbeat_advertise_as_in_jax(plane):
    def drive(mod, fab, store, clock):
        mh = jmh if mod is js else tmh
        rec0 = mh.read_host_lease(store, "adv", 0)
        fut = fab.submit(_thetas(1)[0], scenario="coherent")
        fab.drain()
        clock.t = 10.0
        fab.tick()
        return rec0, _outcome(fut), mh.read_host_lease(store, "adv", 0), \
            fab.hosts[0].summary()["heartbeats"]

    jres, tres = _both(plane, "adv", drive, n=1)
    assert tres[0] == jres[0] and tres[2] == jres[2] and tres[3] == jres[3]
    _same([jres[1]], [tres[1]], "advertised pool")
    assert tres[2]["pools"] == {"coherent": plane["h_a"]}


@pytest.mark.parametrize("case", ["collision", "steal", "torn"])
def test_membership_records_follow_jax(plane, tmp_path, case):
    out = []
    for mod, mh, store_cls in ((js, jmh, JStore), (ts, tmh, TStore)):
        store = store_cls(str(tmp_path / mod.__name__))
        clock = FakeClock()
        if case == "steal":
            old = {"schema": 1, "host_id": "dead", "host_index": 0, "generation": 4,
                   "expires_at": 5.0}
            r1 = mh.publish_host_lease(store, "st", 0, old, clock=clock)
            clock.t = 6.0
            new = dict(old, host_id="fresh", generation=0, expires_at=36.0)
            out.append((r1, mh.publish_host_lease(store, "st", 0, new, clock=clock),
                        mh.read_host_lease(store, "st", 0)))
        elif case == "collision":
            rec = {"schema": 1, "host_id": "a", "host_index": 0, "expires_at": 30.0}
            out.append((mh.publish_host_lease(store, "c", 0, rec, clock=clock),
                        mh.publish_host_lease(store, "c", 0, dict(rec, host_id="b"),
                                              clock=clock),
                        mh.read_host_lease(store, "c", 0)))
        else:
            rec = {"schema": 1, "host_id": "a", "host_index": 0, "expires_at": 30.0}
            mh.publish_host_lease(store, "t", 0, rec, clock=clock)
            from bdlz_tpu_torch.provenance import lease_entry_name

            with open(store.path_for(lease_entry_name(mh.host_lease_job("t"), 0)), "w") as f:
                f.write('{"host_id": "h')
            torn = mh.read_host_lease(store, "t", 0)
            out.append((torn, mh.publish_host_lease(store, "t", 0, rec, clock=clock),
                        mh.read_host_lease(store, "t", 0)))
    assert out[1] == out[0]


def test_a_live_seat_collision_is_refused_typed(plane):
    clock = FakeClock()
    fab, store = _fabric(ts, plane, clock, "coll", n=1)
    imposter = ts.FabricHost(tcfg(PHYS), fabric="coll", host_id="imposter", host_index=0,
                             store=store, tenant_map=plane["tenant_map"], clock=clock,
                             devices=["cpu"])
    try:
        with pytest.raises(ts.FabricError, match="collision"):
            imposter.register()
    finally:
        fab.close()
        imposter.close()


# ---- routing and fencing ----------------------------------------------------------

def test_the_router_prefers_the_advertiser_as_in_jax(plane):
    def drive(mod, fab, store, clock):
        fab.hosts[1].submit(_thetas(1)[0], scenario="coherent")
        fab.hosts[1].drain()
        fab.tick()
        return [fab.router.route(scenario="coherent")["host_id"],
                fab.router.route(artifact_hash=plane["h_a"])["host_id"],
                fab.router.route(scenario="heavy")["host_id"]]

    jres, tres = _both(plane, "pref", drive)
    assert tres == jres == ["h1", "h1", "h0"]


def test_heartbeat_loss_fences_a_live_host_as_in_jax(plane):
    plan = [{"site": "heartbeat_loss", "kind": "raise", "chunk": 0}]

    def drive(mod, fab, store, clock):
        clock.t = 31.0
        fab.tick()
        sick = fab.hosts[0]
        return (sick.alive, sick.heartbeats_lost, sick.partitioned, _live(fab),
                fab.router.route(scenario="coherent")["host_id"])

    jres, tres = _both(plane, "hbl", drive, host_kw={0: {"fault_plan": plan}})
    assert tres == jres == (True, 1, False, ["h1"], "h1")


def test_no_live_host_is_refused_typed_as_in_jax(plane):
    def drive(mod, fab, store, clock):
        clock.t = 100.0
        with pytest.raises(mod.ServiceUnavailable) as exc:
            fab.router.route(scenario="coherent")
        return str(exc.value)

    jres, tres = _both(plane, "dead", drive)
    assert tres == jres and "no live host" in tres


# ---- whole-host failover ------------------------------------------------------------

def test_crash_failover_and_readmission_follow_jax(plane, tmp_path):
    thetas = _thetas(4)

    def drive(mod, fab, store, clock):
        futs = [fab.submit(t, scenario="coherent") for t in thetas]
        fab.drain()
        v0 = [_outcome(f) for f in futs]
        fab.tick()
        doomed = [fab.submit(t, scenario="coherent") for t in thetas]
        failed = fab.hosts[0].crash()
        dead = [_outcome(f) for f in doomed]
        routed = fab.router.route(scenario="coherent")["host_id"]
        refuts = [fab.submit(t, scenario="coherent") for t in thetas]
        fab.drain()
        v1 = [_outcome(f) for f in refuts]
        ev = [{k: v for k, v in e.items() if k != "seconds"}
              for e in fab.hosts[1].service.admission_events]
        clock.t = 62.0
        fab.tick()
        return (v0, failed, dead, routed, fab.failovers, v1, ev,
                fab.hosts[1].artifact_cache.counters(), _live(fab))

    jres, tres = _both(plane, "fo", drive,
                       host_kw={1: {"cache_root": str(tmp_path / "h1cache")}})
    _same(jres[0], tres[0], "before the crash")
    _same(jres[5], tres[5], "after the failover")
    assert tres[1:5] == jres[1:5] and tres[6:] == jres[6:]
    assert {o[5] for o in tres[0]} == {"h0"} and {o[5] for o in tres[5]} == {"h1"}
    assert [o[-1] for o in tres[5]] == [o[-1] for o in tres[0]]  # bitwise
    assert tres[7] == {"hits": 0, "misses": 1, "corrupt_evictions": 0}


def test_the_host_crash_site_acts_as_in_jax(plane):
    plan = [{"site": "host_crash", "kind": "raise", "chunk": 0}]

    def drive(mod, fab, store, clock):
        fut = fab.hosts[0].submit(_thetas(1)[0], scenario="coherent")
        fab.tick()
        with pytest.raises(mod.ServiceUnavailable) as exc:
            fab.hosts[0].submit(_thetas(1)[0], scenario="coherent")
        return (fab.hosts[0].alive, fab.hosts[1].alive, _outcome(fut)[:2], str(exc.value))

    jres, tres = _both(plane, "hc", drive, host_kw={0: {"fault_plan": plan}})
    assert tres == jres and tres[:2] == (False, True)


# ---- store partition ----------------------------------------------------------------

def test_a_partition_answers_degraded_exact_then_rejoins_as_in_jax(plane):
    plan = [{"site": "store_partition", "kind": "raise", "chunk": k} for k in (1, 2, 3)]

    def drive(mod, fab, store, clock):
        host = fab.hosts[0]
        futs = [fab.submit(t, scenario="coherent") for t in _thetas(4)]
        host.drain()
        clean = [_outcome(f) for f in futs]
        hb = (host.heartbeat(), host.partitioned)
        deg = _outcome(host.submit(_thetas(1)[0], scenario="coherent"))
        row = host.service.pool("coherent").stats.as_rows()[-1]
        cold = _outcome(host.submit(_thetas(1)[0], scenario="heavy"))
        rejoin = (host.heartbeat(), host.partitioned)
        f = fab.submit(_thetas(1)[0], scenario="coherent")
        host.drain()
        return (clean, hb, deg, {k: row[k] for k in ("replica", "host_id", "n_fallback")},
                cold, rejoin, _outcome(f), host.degraded_partition_answers)

    jres, tres = _both(plane, "part", drive,
                       host_kw={0: {"fault_plan": plan, "partition_retries": 3}}, n=1)
    _same(jres[0], tres[0], "clean")
    _same([jres[2]], [tres[2]], "partitioned")
    _same([jres[6]], [tres[6]], "rejoined")
    assert tres[1] == jres[1] == (False, True)
    assert tres[2][2:6] == (-1, "store_partition", True, "h0")
    print(f"RESIDUAL fabric partition exact answer {abs(tres[2][-1] / jres[2][-1] - 1):.3e}")
    assert tres[3] == jres[3] and tres[4] == jres[4] and tres[5] == jres[5] == (True, False)
    assert tres[7] == jres[7] == 1


# ---- idle-host chunk stealing -------------------------------------------------------

SWEEP_AXES = {"m_chi_GeV": [0.5, 1.0, 2.0], "T_p_GeV": [80.0, 150.0]}


def test_an_idle_host_steals_the_queue_bitwise(plane):
    from bdlz_tpu_torch.config import static_choices_from_config
    from bdlz_tpu_torch.parallel import (
        LeasePlane,
        ensure_job_record,
        plan_elastic_sweep,
        run_sweep,
        run_sweep_elastic,
    )
    from bdlz_tpu_torch.utils.retry import RetryPolicy

    base = tcfg(PHYS)
    static = static_choices_from_config(base)
    retry = RetryPolicy(max_attempts=2, backoff_s=0.0, sleep=lambda s: None)
    kw = dict(chunk_size=2, n_y=200, retry=retry, device="cpu")
    serial = run_sweep(base, SWEEP_AXES, static, **kw)
    clock = FakeClock()
    fab, store = _fabric(ts, plane, clock, "chunks", n=1)
    host = fab.hosts[0]
    try:
        plan = plan_elastic_sweep(base, SWEEP_AXES, static, **kw)
        ensure_job_record(store, plan)
        leases = LeasePlane(store, plan.job, plan.n_chunks, ttl_s=60.0, clock=clock)
        host.attach_sweep(plan, leases)
        fab.tick()
        assert host.chunks_stolen == 1
        fut = fab.submit(_thetas(1)[0], scenario="coherent")
        assert not host.serving_idle() and host._maybe_steal_chunks() == 0
        host.drain()
        assert fut.result(timeout=0).artifact_hash == plane["h_a"]
        for _ in range(plan.n_chunks):
            fab.tick()
        assert host.chunks_stolen == plan.n_chunks
        assert fab.summary()["hosts"][0]["chunks_stolen"] == plan.n_chunks
        res = run_sweep_elastic(base, SWEEP_AXES, static, store=store, **kw)
        assert (res.cache_hits, res.cache_misses) == (plan.n_chunks, 0)
        for f in serial.outputs:
            assert res.outputs[f].tobytes() == serial.outputs[f].tobytes(), f
    finally:
        fab.close()


def test_the_fabric_sites_are_off_by_default(plane):
    clock = FakeClock()
    fab, _ = _fabric(ts, plane, clock, "off", n=1)
    host = fab.hosts[0]
    try:
        assert host._faults is None
        fut = fab.submit(_thetas(1)[0], scenario="coherent")
        host.drain()
        r = fut.result(timeout=0)
        assert not r.degraded and r.fallback_reason is None and r.host_id == "h0"
        s = host.summary()
        assert s["alive"] and not s["partitioned"] and s["heartbeats_lost"] == 0
        assert s["service"]["host_id"] == "h0"
    finally:
        fab.close()


# ---- two real processes --------------------------------------------------------------

def test_host_kill_failover_across_port_processes(tmp_path, tiny_emulator):
    from bdlz_tpu.provenance import publish_artifact

    _, _, art, _ = tiny_emulator
    shared = str(tmp_path / "shared")
    h = publish_artifact(JStore(shared), art)
    worker = os.path.join(os.path.dirname(__file__), "_mp_torch_fabric_worker.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)

    def _run(args):
        p = subprocess.run([sys.executable, worker, *args], capture_output=True, text=True,
                           timeout=240, env=env)
        assert p.returncode == 0, f"{args[0]}:\n{p.stdout}\n{p.stderr[-2000:]}"
        return json.loads(p.stdout.strip().splitlines()[-1])

    v = _run(["victim", shared, h])
    s = _run(["survivor", shared, h, str(tmp_path / "cache")])
    assert np.array(s["values"]).tobytes() == np.array(v["values"]).tobytes()
    assert s["admissions"] == 1
    assert s["cache"] == {"hits": 0, "misses": 1, "corrupt_evictions": 0}
