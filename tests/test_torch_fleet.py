"""The port's fleet, health plane, registry and rollout against the JAX
package's, on the same requests and the same artifact directory: answers,
replica routing, breaker transitions, degraded answers, typed errors and
the hashes every response carries.  Every policy runs on a fake clock.

Residuals print as ``RESIDUAL`` lines (``pytest -s``)."""
import numpy as np
import pytest
from _serve_common import fleet, make_served, outcome, pump, rel, summary

import bdlz_tpu.serve as js
import bdlz_tpu_torch.serve as ts
from bdlz_tpu.faults import FaultPlan as JPlan
from bdlz_tpu_torch.faults import FaultPlan as TPlan


@pytest.fixture(scope="module")
def served(tiny_emulator):
    return make_served(tiny_emulator)


# ---- fleet ---------------------------------------------------------------

@pytest.mark.parametrize("n_replicas,routing", [(1, "least_loaded"), (2, "least_loaded"),
                                                (3, "round_robin")])
def test_fleet_answers_match_jax_and_do_not_depend_on_the_replica_count(
        served, n_replicas, routing):
    th = served.thetas[:160]
    jf, jc = fleet(js, served, n_replicas=n_replicas, routing=routing, gate=served.gate)
    tf, tc = fleet(ts, served, n_replicas=n_replicas, routing=routing, gate=served.gate)
    jr, tr = pump(jf, jc, th), pump(tf, tc, th)
    assert [(r.replica, r.fallback_reason, r.artifact_hash, r.degraded) for r in tr] == \
           [(r.replica, r.fallback_reason, r.artifact_hash, r.degraded) for r in jr]
    assert rel([r.value for r in tr], [r.value for r in jr]) <= 1e-10
    assert summary(tf.stats) == summary(jf.stats)
    one, oc = fleet(ts, served, n_replicas=1, gate=served.gate)
    single = pump(one, oc, th)
    assert np.array([r.value for r in tr]).tobytes() == \
           np.array([r.value for r in single]).tobytes()


@pytest.mark.parametrize("kind", ["raise", "nan"])
def test_a_replica_fault_opens_jax_s_breaker_and_is_reanswered_bitwise(served, kind):
    th = served.thetas[:192]
    plan = [{"site": "replica_dispatch", "kind": kind, "key": 0}]
    jf, jc = fleet(js, served, n_replicas=2, plan=plan)
    tf, tc = fleet(ts, served, n_replicas=2, plan=plan)
    jr, tr = pump(jf, jc, th), pump(tf, tc, th)
    assert tf.health.events == jf.health.events
    assert tf.health.opens >= 1
    assert summary(tf.stats) == summary(jf.stats)
    assert [(r.replica, r.fallback_reason) for r in tr] == \
           [(r.replica, r.fallback_reason) for r in jr]
    clean, cc = fleet(ts, served, n_replicas=2)
    ref = pump(clean, cc, th)
    assert np.array([r.value for r in tr]).tobytes() == \
           np.array([r.value for r in ref]).tobytes()


def test_all_breakers_open_serve_degraded_through_the_exact_path(served):
    th = served.thetas[:64]
    plan = [{"site": "replica_dispatch", "kind": "raise"}]
    jf, jc = fleet(js, served, n_replicas=2, plan=plan)
    tf, tc = fleet(ts, served, n_replicas=2, plan=plan)
    jr, tr = pump(jf, jc, th), pump(tf, tc, th)
    assert all(r.degraded and r.replica == -1 and r.fallback_reason == "degraded"
               for r in tr)
    assert tf.health.events == jf.health.events
    assert tf.stats.summary()["health"] == jf.stats.summary()["health"]
    res = rel([r.value for r in tr], [r.value for r in jr])
    print(f"RESIDUAL fleet degraded exact path {res:.3e}")
    assert res <= 1e-10


def test_a_dead_exact_path_under_open_breakers_is_service_unavailable(served):
    plan = [{"site": "replica_dispatch", "kind": "raise"}, {"site": "serve_exact",
                                                           "kind": "raise"}]
    names = []
    for mod in (js, ts):
        f, c = fleet(mod, served, n_replicas=1, plan=plan)
        fut = f.submit(served.thetas[0])
        c.advance(0.01)
        f.drain()
        names.append(outcome(fut))
    assert names[0] == names[1] == ("err", "ServiceUnavailable")


def test_a_sick_replica_is_reprovisioned_from_the_registry_like_jax(served, tmp_path):
    from bdlz_tpu.provenance import Store as JStore
    from bdlz_tpu.provenance import publish_artifact as jpub

    from bdlz_tpu_torch.provenance import Store as TStore
    from bdlz_tpu_torch.provenance import publish_artifact as tpub

    summaries = []
    for mod, store_cls, pub in ((js, JStore, jpub), (ts, TStore, tpub)):
        store = store_cls(str(tmp_path / mod.__name__))
        art = served.jart if mod is js else served.tart
        assert pub(store, art) == art.content_hash
        plan = [{"site": "replica_dispatch", "kind": "transient", "key": 0, "times": 40}]
        f, c = fleet(mod, served, n_replicas=2, plan=plan, store=store)
        for _ in range(6):
            pump(f, c, served.thetas[:64])
            c.advance(1.5)  # past the breaker cooldown: a probe per pass
        summaries.append((f.health.events, f.stats.summary()["health"]))
    assert summaries[1] == summaries[0]
    assert summaries[1][1]["reprovisions"] >= 1


# ---- registry ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["torn", "corrupt"])
def test_a_persistent_registry_fault_gives_jax_s_typed_error(served, tmp_path, kind):
    from bdlz_tpu.emulator import EmulatorArtifactError as JErr
    from bdlz_tpu.provenance import Store as JStore
    from bdlz_tpu.provenance import fetch_artifact_with_retry as jfetch
    from bdlz_tpu.provenance import publish_artifact as jpub
    from bdlz_tpu.utils.retry import RetryPolicy as JRetry

    from bdlz_tpu_torch.emulator import EmulatorArtifactError as TErr
    from bdlz_tpu_torch.provenance import Store as TStore
    from bdlz_tpu_torch.provenance import fetch_artifact_with_retry as tfetch
    from bdlz_tpu_torch.provenance import publish_artifact as tpub
    from bdlz_tpu_torch.utils.retry import RetryPolicy as TRetry

    plan = [{"site": "registry_fetch", "kind": kind}]
    msgs = []
    for store_cls, pub, fetch, err_cls, retry_cls, plan_cls, art in (
        (JStore, jpub, jfetch, JErr, JRetry, JPlan, served.jart),
        (TStore, tpub, tfetch, TErr, TRetry, TPlan, served.tart),
    ):
        root = tmp_path / err_cls.__module__
        store = store_cls(str(root))
        pub(store, art)
        with pytest.raises(err_cls) as exc:
            fetch(store, art.content_hash, fault_plan=plan_cls.from_obj(plan),
                  retry=retry_cls(max_attempts=2, backoff_s=0.0, seed=0,
                                  sleep=lambda s: None))
        msgs.append((type(exc.value).__name__,
                     str(exc.value).replace(str(root), "<root>"),
                     store.stats.dropped_corrupt))
    assert msgs[1] == msgs[0]


def test_the_registry_is_shared_by_the_two_packages(served, tmp_path):
    from bdlz_tpu.provenance import Store as JStore
    from bdlz_tpu.provenance import fetch_artifact as jfetch

    from bdlz_tpu_torch.provenance import ArtifactCache, publish_artifact
    from bdlz_tpu_torch.provenance import Store as TStore

    h = publish_artifact(TStore(str(tmp_path / "reg")), served.out_dir)
    assert jfetch(JStore(str(tmp_path / "reg")), h).content_hash == h
    cache = ArtifactCache(str(tmp_path / "local"))
    for _ in range(2):
        assert cache.fetch(TStore(str(tmp_path / "reg")), h).content_hash == h
    assert cache.counters() == {"hits": 1, "misses": 1, "corrupt_evictions": 0}


# ---- rollout -------------------------------------------------------------

@pytest.fixture(scope="module")
def second_artifact(served, tmp_path_factory):
    """The same physics with the values scaled by 1.001: a second content
    hash the rollout can stage (saved by the port, loaded by both)."""
    from bdlz_tpu_torch.emulator import save_artifact

    art = served.tart
    manifest = {k: v for k, v in art.manifest.items() if k != "hash"}
    art2 = art._replace(values={k: np.asarray(v) * 1.001 for k, v in art.values.items()},
                        manifest=manifest)
    out = str(tmp_path_factory.mktemp("rollout") / "art2")
    save_artifact(out, art2)
    return out


def test_a_cutover_under_load_drops_nothing_and_mixes_no_batch(served, second_artifact):
    th = served.thetas[:192]
    runs = []
    for mod in (js, ts):
        f, c = fleet(mod, served, n_replicas=2)
        ro = mod.ArtifactRollout(f)
        futs = []
        for i, t in enumerate(th):
            futs.append(f.submit(t))
            if i % 16 == 15:
                c.advance(0.004)
                f.run_once()
            if i == 95:
                old_new = (ro.active_hash, ro.stage(second_artifact))
                assert ro.ready()
                assert ro.cutover() == old_new
            if i % 32 == 31:
                f.poll(block=True)
        c.advance(0.01)
        f.drain()
        answers = [fu.result(timeout=0) for fu in futs]
        assert len(answers) == len(th)
        rows = f.stats.as_rows()
        assert sum(r["size"] for r in rows) == len(th)
        assert {a.artifact_hash for a in answers} == set(old_new)
        runs.append(([(a.artifact_hash, a.replica) for a in answers],
                     [(r["batch_index"], r["artifact_hash"], r["size"]) for r in rows]))
    assert runs[1] == runs[0]


def test_auto_rollback_records_what_jax_records(served, second_artifact):
    recs = []
    for mod in (js, ts):
        f, c = fleet(mod, served, n_replicas=2, gate=served.gate)
        ro = mod.ArtifactRollout(f)
        first = ro.active_hash
        ro.stage(second_artifact)
        ro.cutover(observe_s=10.0, budget=0.01)
        pump(f, c, served.thetas[:128])
        assert ro.active_hash == first
        recs.append(f.stats.extras["rollbacks"])
    assert recs[1] == recs[0]


def test_rollout_refusals_and_hash_shapes(served):
    f, _ = fleet(ts, served, n_replicas=1)
    ro = ts.ArtifactRollout(f)
    with pytest.raises(ts.RolloutError, match="nothing staged"):
        ro.cutover()
    ro.stage(served.tart, warm=False)
    with pytest.raises(ts.RolloutError, match="cold"):
        ro.cutover()
    ro.abort()
    assert ro.staged_hash is None
    for s in ("0123456789abcdef", "0123456789ABCDEF", "abc", served.tart.content_hash):
        assert ts.looks_like_content_hash(s) == js.looks_like_content_hash(s)
