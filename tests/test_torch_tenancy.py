"""The port's multi-tenant plane and ``FleetService.resize`` against the
JAX package's, on the CPU, over the same two published artifacts (a
two-channel and an N=3 chain surface built by the JAX package): routing
and typed skew refusals, answers (emulator answers ≤1e-14 from JAX's,
exact-path answers ≤1e-12; bitwise a single-tenant fleet's), per-pool shedding, eviction and readmission,
autoscaler replica counts per pass, the ``pool_evict`` and ``autoscale``
fault sites, the ``close()`` contract and the serve CLI's ``--tenant-map``
records.  Every policy runs on a fake clock; polls block.

Residuals print as ``RESIDUAL`` lines (``pytest -s``)."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from _serve_common import FakeClock

import bdlz_tpu.serve as js
import bdlz_tpu_torch.serve as ts
from bdlz_tpu.config import config_from_dict as jcfg
from bdlz_tpu.lz.profile import BounceProfile as JProfile
from bdlz_tpu.provenance import Store as JStore
from bdlz_tpu_torch.config import config_from_dict as tcfg
from bdlz_tpu_torch.lz.profile import BounceProfile as TProfile
from bdlz_tpu_torch.provenance import Store as TStore

REPO = pathlib.Path(__file__).resolve().parent.parent
XI = np.linspace(-30.0, 30.0, 1001)
PROFILE = dict(xi=XI, delta=-0.08 * np.tanh(XI / 4.0), mix=np.full_like(XI, 0.02))
PHYS = {"regime": "nonthermal", "source_shape_sigma_y": 9.0,
        "incident_flux_scale": 1.07e-9, "Y_chi_init": 4.90e-10, "P_chi_to_B": 0.1}
#: Emulator answers against JAX's; answers of the exact pipeline (out of
#: domain, gated, evicted) hold the sweep's contract with JAX instead.
ANSWER_RTOL, EXACT_RTOL = 1e-14, 1e-12
#: Wall-clock fields (compiles and warm-ups are real seconds on any clock).
WALL = ("warmup_seconds", "admission_seconds")


@pytest.fixture(scope="module")
def plane(tmp_path_factory, jit_warmup):
    """Two tiny artifacts published by the JAX package into one store:
    the coherent two-channel surface and the N=3 chain surface."""
    from bdlz_tpu.emulator import AxisSpec, build_emulator
    from bdlz_tpu.provenance import publish_artifact

    base = jcfg(PHYS)
    spec = {"m_chi_GeV": AxisSpec(0.9, 1.1, 2, "log"), "v_w": AxisSpec(0.25, 0.35, 3, "lin")}
    kw = dict(rtol=1e-2, n_probe=4, n_holdout=8, max_rounds=1, n_y=400, chunk_size=64,
              require_converged=False)
    root = tmp_path_factory.mktemp("tenancy")
    art_coh, _ = build_emulator(base, spec, **kw)
    art_chain, _ = build_emulator(dataclasses.replace(base, lz_mode="chain", lz_n_levels=3),
                                  spec, lz_profile=JProfile(**PROFILE), **kw)
    store_root = str(root / "store")
    jstore = JStore(store_root)
    h_coh, h_chain = publish_artifact(jstore, art_coh), publish_artifact(jstore, art_chain)
    return {"root": root, "store": store_root, "h_coh": h_coh, "h_chain": h_chain,
            "tenant_map": {"coherent": h_coh, "chain": h_chain}}


def _svc(mod, plane, clock=None, **kw):
    kw.setdefault("max_batch_size", 4)
    if mod is js:
        kw.setdefault("lz_profile", JProfile(**PROFILE))
        return js.MultiTenantService(jcfg(PHYS), tenant_map=plane["tenant_map"],
                                     store=JStore(plane["store"]),
                                     clock=clock or FakeClock(), **kw)
    kw.setdefault("lz_profile", TProfile(**PROFILE))
    return ts.MultiTenantService(tcfg(PHYS), tenant_map=plane["tenant_map"],
                                 store=TStore(plane["store"]), clock=clock or FakeClock(),
                                 devices=["cpu"], **kw)


def _thetas(n, seed=5):
    rng = np.random.default_rng(seed)
    return np.column_stack([rng.uniform(0.92, 1.08, n), rng.uniform(0.26, 0.34, n)])


def _strip(summary):
    summary = json.loads(json.dumps(summary))
    for pool in summary.get("pools", {}).values():
        for k in WALL:
            pool.pop(k, None)
    return summary


def _resp(r):
    return (r.artifact_hash, r.replica, r.fallback_reason, r.degraded, r.lz_mode, r.host_id)


def _outcome(fut):
    try:
        r = fut.result(timeout=0)
        return ("ok", _resp(r), r.value)
    except Exception as exc:  # noqa: BLE001 — the outcome is compared
        return ("err", type(exc).__name__, str(exc))


def _both(plane, drive, **kw):
    """Run ``drive(mod, svc, clock)`` on both packages' services and
    return both results (each service closed afterwards)."""
    out = {}
    for mod in (js, ts):
        clock = FakeClock()
        svc = _svc(mod, plane, clock=clock, **kw)
        try:
            out[mod] = drive(mod, svc, clock)
        finally:
            svc.close()
    return out[js], out[ts]


def _same_outcomes(jout, tout, label):
    assert [o[:2] for o in tout] == [o[:2] for o in jout], label
    for exact, tol in ((False, ANSWER_RTOL), (True, EXACT_RTOL)):
        vals = [(t[2], j[2]) for t, j in zip(tout, jout)
                if t[0] == "ok" and (t[1][2] is not None) == exact]
        if vals:
            a, b = np.array(vals).T
            r = float(np.max(np.abs(a / b - 1.0)))
            print(f"RESIDUAL tenancy {label} {'exact' if exact else 'emulator'} {r:.3e}")
            assert r <= tol


# ---- routing and skew -----------------------------------------------------------

REFUSALS = {
    "unknown_scenario": dict(scenario="nope"),
    "conflicting_tags": dict(scenario="coherent", artifact_hash="h_chain"),
    "stated_mode_skew": dict(scenario="chain", lz_mode="thermal"),
    "no_tag_under_scenario_routing": dict(),
    "unknown_axis_mapping": dict(scenario="coherent", theta={"m_chi_GeV": 1.0, "x": 1.0}),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_routing_and_skew_refusals_are_jax_s(plane, name):
    kw = dict(REFUSALS[name])
    if kw.get("artifact_hash") == "h_chain":
        kw["artifact_hash"] = plane["h_chain"]
    theta = kw.pop("theta", _thetas(1)[0])

    def drive(mod, svc, clock):
        svc.submit(_thetas(1)[0], scenario="coherent").result  # admits a pool
        try:
            svc.submit(theta, **kw)
        except Exception as exc:  # noqa: BLE001 — compared below
            return type(exc).__name__, str(exc)
        return None

    jerr, terr = _both(plane, drive)
    assert terr is not None and terr == jerr


@pytest.mark.parametrize("kw", [{"tenant_map": {"x": "not-a-hash"}},
                                {"tenant_routing": "scenario", "tenant_map": {}},
                                {"pool_min_replicas": 0}, {"memory_budget_bytes": 0},
                                {"autoscale_interval_s": 0.0}])
def test_bad_tenant_configuration_is_refused_as_in_jax(plane, kw):
    errs = []
    for mod, cfg, store in ((js, jcfg, JStore), (ts, tcfg, TStore)):
        extra = {} if mod is js else {"devices": ["cpu"]}
        args = {"tenant_map": plane["tenant_map"], **kw}
        with pytest.raises(mod.TenancyError) as exc:
            mod.MultiTenantService(cfg(PHYS), store=store(plane["store"]), **args, **extra)
        errs.append(str(exc.value))
    assert errs[0] == errs[1]


def test_pool_base_and_bytes_follow_jax(plane):
    from bdlz_tpu.provenance import fetch_artifact as jfetch
    from bdlz_tpu.serve.tenancy import pool_base as jpb
    from bdlz_tpu.serve.tenancy import pool_bytes_per_replica as jbytes
    from bdlz_tpu_torch.provenance import fetch_artifact as tfetch
    from bdlz_tpu_torch.serve.tenancy import pool_base as tpb
    from bdlz_tpu_torch.serve.tenancy import pool_bytes_per_replica as tbytes

    for h in (plane["h_coh"], plane["h_chain"]):
        ja, ta = jfetch(JStore(plane["store"]), h), tfetch(TStore(plane["store"]), h)
        jb, tb = jpb(jcfg(PHYS), ja), tpb(tcfg(PHYS), ta)
        assert (tb.lz_mode, tb.lz_n_levels) == (jb.lz_mode, jb.lz_n_levels)
        for gate in (True, False):
            assert tbytes(ta, error_gate=gate) == jbytes(ja, error_gate=gate)


# ---- answers -------------------------------------------------------------------

def test_answers_match_jax_and_a_single_tenant_fleet_bitwise(plane):
    thetas = _thetas(12)

    def drive(mod, svc, clock):
        futs = [svc.submit(t, scenario=s) for t in thetas for s in ("coherent", "chain")]
        svc.drain()
        return [_outcome(f) for f in futs], _strip(svc.summary())

    (jout, jsum), (tout, tsum) = _both(plane, drive)
    _same_outcomes(jout, tout, "two pools")
    assert tsum == jsum
    from bdlz_tpu_torch.provenance import fetch_artifact

    for k, (scn, h) in enumerate((("coherent", plane["h_coh"]), ("chain", plane["h_chain"]))):
        art = fetch_artifact(TStore(plane["store"]), h)
        base = tcfg(dict(PHYS, **({"lz_mode": "chain", "lz_n_levels": 3}
                                  if scn == "chain" else {})))
        ref = ts.FleetService(art, base, max_batch_size=4, devices=["cpu"],
                              lz_profile=TProfile(**PROFILE) if scn == "chain" else None)
        rf = [ref.submit(t) for t in thetas]
        ref.drain()
        got = np.array([o[2] for o in tout[k::2]])
        assert got.tobytes() == np.array([f.result().value for f in rf]).tobytes()
        ref.close()


def test_a_saturated_tenant_sheds_alone_as_in_jax(plane):
    def drive(mod, svc, clock):
        rejected = 0
        for t in _thetas(16):
            try:
                svc.submit(t, scenario="coherent")
            except mod.QueueFull:
                rejected += 1
        for t in _thetas(4):
            svc.submit(t, scenario="chain")
        svc.drain()
        return rejected, _strip(svc.summary())

    (jrej, jsum), (trej, tsum) = _both(plane, drive, queue_bound=4)
    assert trej == jrej > 0
    assert tsum == jsum
    assert tsum["pools"][plane["h_chain"]]["shed_rate"] == 0.0


# ---- eviction and readmission ------------------------------------------------------

def test_evict_degraded_readmit_round_trip_matches_jax(plane):
    plan = '{"faults": [{"site": "pool_evict", "kind": "raise", "key": 0}]}'
    thetas = _thetas(8)

    def drive(mod, svc, clock):
        pre = [svc.submit(t, scenario="coherent") for t in thetas]
        svc.drain()
        svc.run_once()  # the idle pool: the forced eviction fires
        evicted = (svc.pool("coherent").evicted, svc.pool("coherent").resident_bytes)
        deg = [svc.submit(t, scenario="coherent") for t in thetas]
        svc.drain()
        svc.readmit("coherent")
        post = [svc.submit(t, scenario="coherent") for t in thetas]
        svc.drain()
        return ([_outcome(f) for f in pre], [_outcome(f) for f in deg],
                [_outcome(f) for f in post], evicted, _strip(svc.summary()),
                [{k: v for k, v in e.items() if k != "seconds"} for e in svc.admission_events])

    jres, tres = _both(plane, drive, fault_plan=plan)
    for k, label in enumerate(("pre", "degraded", "post")):
        _same_outcomes(jres[k], tres[k], label)
    pre, deg, post = (np.array([o[2] for o in tres[k]]) for k in range(3))
    assert pre.tobytes() == post.tobytes()
    assert all(o[1][1:4] == (-1, "pool_evicted", True) for o in tres[1])
    assert tres[3] == jres[3] == (True, 0)
    assert tres[4] == jres[4] and tres[4]["readmissions"] == 1
    assert tres[5] == jres[5]


def test_the_memory_budget_evicts_the_lru_idle_pool_as_in_jax(plane):
    def drive(mod, svc, clock):
        a = [svc.submit(t, scenario="coherent") for t in _thetas(4)]
        clock.advance(1.0)
        b = [svc.submit(t, scenario="chain") for t in _thetas(4)]
        svc.drain()
        svc.memory_budget_bytes = svc.pool("chain").resident_bytes
        svc.run_once()
        return ([_outcome(f) for f in a + b], svc.pool("coherent").evicted,
                svc.pool("chain").evicted, svc.evictions, svc.forced_evictions)

    jres, tres = _both(plane, drive)
    _same_outcomes(jres[0], tres[0], "before the budget")
    assert tres[1:] == jres[1:] == (True, False, 1, 0)


# ---- autoscaling ---------------------------------------------------------------------

def _pump_full_batch(svc, clock, scenario="coherent"):
    for t in _thetas(4):
        svc.submit(t, scenario=scenario)
    svc.run_once()
    svc.poll(block=True)
    # past the interval, then an idle tick: the pass runs with nothing in flight
    clock.advance(1.0)
    svc.run_once()


@pytest.mark.parametrize("load", ["oscillating", "sustained", "sustained_then_idle"])
def test_autoscaler_replica_counts_per_pass_match_jax(plane, load):
    def drive(mod, svc, clock):
        counts = []
        if load == "oscillating":
            for _ in range(4):
                _pump_full_batch(svc, clock)
                clock.advance(1.0)
                svc.run_once()
                counts.append(svc.pool("coherent").n_replicas)
        else:
            for _ in range(3):
                _pump_full_batch(svc, clock)
                counts.append(svc.pool("coherent").n_replicas)
            if load == "sustained_then_idle":
                for _ in range(4):
                    clock.advance(1.0)
                    svc.run_once()
                    counts.append(svc.pool("coherent").n_replicas)
        s = svc.summary()
        return counts, s["resizes"], s["autoscale_passes"], s["total_replicas"]

    jres, tres = _both(plane, drive, autoscale_interval_s=1.0, n_replicas=1)
    assert tres == jres
    if load == "oscillating":
        assert tres[1] == 0
    else:
        assert 2 in tres[0] and tres[1] >= 1


def test_an_autoscale_fault_skips_a_pass_as_in_jax(plane):
    plan = '{"faults": [{"site": "autoscale", "kind": "raise", "key": 0}]}'

    def drive(mod, svc, clock):
        for _ in range(3):
            _pump_full_batch(svc, clock)
        s = svc.summary()
        return s["autoscale_skipped"], s["autoscale_passes"], s["resizes"]

    jres, tres = _both(plane, drive, autoscale_interval_s=1.0, fault_plan=plan,
                       n_replicas=1)
    assert tres == jres and tres[0] == 1


# ---- close() and the replica budget ---------------------------------------------------

def test_close_fails_pending_and_degraded_futures_typed(plane):
    plan = '{"faults": [{"site": "pool_evict", "kind": "raise", "key": 0}]}'
    svc = _svc(ts, plane, fault_plan=plan)
    try:
        warm = [svc.submit(t, scenario="coherent") for t in _thetas(4)]
        svc.drain()
        for f in warm:
            f.result()
        svc.run_once()
        assert svc.pool("coherent").evicted
        pend = [svc.submit(t, scenario="chain") for t in _thetas(2)]
        deg = [svc.submit(t, scenario="coherent") for t in _thetas(2)]
    finally:
        n = svc.close()
    assert n == 4
    for f in pend + deg:
        with pytest.raises(ts.ServiceUnavailable):
            f.result(timeout=0)
    with pytest.raises(ts.ServiceUnavailable):
        svc.submit(_thetas(1)[0], scenario="chain")
    assert svc.close() == 0


def test_the_replica_budget_refusal_is_typed_as_in_jax(plane):
    def drive(mod, svc, clock):
        svc.submit(_thetas(1)[0], scenario="coherent")
        with pytest.raises(mod.TenancyError, match="replica budget") as exc:
            svc.submit(_thetas(1)[0], scenario="chain")
        return str(exc.value)

    jerr, terr = _both(plane, drive, n_replicas=1, replica_budget=1)
    assert terr == jerr


# ---- FleetService.resize ----------------------------------------------------------------

def test_resize_keeps_the_bits_and_rebuilds_the_health_plane(tiny_emulator):
    from _serve_common import make_served, pump

    served = make_served(tiny_emulator)
    th = served.thetas[:96]
    out = {}
    for mod, art, base, kw in ((js, served.jart, served.jbase, {}),
                               (ts, served.tart, served.tbase, {"devices": ["cpu"]})):
        clock = FakeClock()
        f = mod.FleetService(art, base, max_batch_size=32, n_replicas=1, clock=clock, **kw)
        before = pump(f, clock, th)
        f.submit(th[0])
        f.run_once(force=True)
        with pytest.raises(ValueError, match="in flight"):
            f.resize(2)
        f.drain()
        assert f.resize(3) == 3 and f.replica_set.n_replicas == 3
        assert len(f.health.summary()["states"]) == 3
        after = pump(f, clock, th)
        assert f.resize(3) == 3
        f.close()
        with pytest.raises(mod.ServiceUnavailable):
            f.resize(1)
        with pytest.raises(ValueError, match=">= 1"):
            mod.FleetService(art, base, max_batch_size=32, clock=clock, **kw).resize(0)
        out[mod] = (before, after)
    tb, ta = out[ts]
    assert np.array([r.value for r in tb]).tobytes() == np.array([r.value for r in ta]).tobytes()
    assert [r.replica for r in ta] == [r.replica for r in out[js][1]]
    assert max(abs(a.value / b.value - 1) for a, b in zip(ta, out[js][1])) <= 1e-10


# ---- the serve CLI ----------------------------------------------------------------------

def test_the_serve_cli_tenant_map_records_are_jax_s(plane, tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(dict(PHYS, cache_root=plane["store"])))
    tmap = tmp_path / "tenants.json"
    tmap.write_text(json.dumps(plane["tenant_map"]))
    prof = tmp_path / "prof.csv"
    np.savetxt(prof, np.column_stack([XI, PROFILE["delta"], PROFILE["mix"]]), delimiter=",",
               header="xi,delta,mix", comments="")
    req = tmp_path / "req.jsonl"
    lines = [{"id": i, "scenario": s, "m_chi_GeV": float(t[0]), "v_w": float(t[1])}
             for i, (t, s) in enumerate(zip(_thetas(6), ["coherent", "chain"] * 3))]
    lines += [{"id": 90, "scenario": "nope", "m_chi_GeV": 1.0, "v_w": 0.3},
              {"id": 91, "scenario": "chain", "lz_mode": "thermal", "m_chi_GeV": 1.0,
               "v_w": 0.3}]
    req.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    argv = ["--config", str(cfg), "--tenant-map", str(tmap), "--requests", str(req),
            "--lz-profile", str(prof), "--max-batch", "4"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("BDLZ_CACHE_ROOT", None)
    recs = {}
    for mod, extra in (("bdlz_tpu.serve", []), ("bdlz_tpu_torch.serve", ["--device", "cpu"])):
        proc = subprocess.run([sys.executable, "-m", mod, *argv, *extra], capture_output=True,
                              text=True, env=env, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        recs[mod] = [json.loads(ln) for ln in proc.stdout.strip().splitlines()]
    jrecs, trecs = recs["bdlz_tpu.serve"], recs["bdlz_tpu_torch.serve"]
    assert len(trecs) == len(jrecs) == 8
    for t, j in zip(trecs, jrecs):
        t.pop("latency_s", None), j.pop("latency_s", None)
        if "value" in j:
            tol = ANSWER_RTOL if j["fallback_reason"] is None else EXACT_RTOL
            assert abs(t.pop("value") / j.pop("value") - 1.0) <= tol
        assert t == j
