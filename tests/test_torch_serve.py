"""The port's serving plane against the JAX package's, on the same
requests and the same artifact directory (built once by the JAX package,
loaded by both): the single service, the micro-batcher and the serve
CLI.  Every policy runs on a fake clock: nothing sleeps.  The fleet,
registry and rollout are in ``test_torch_fleet.py``.

Residuals print as ``RESIDUAL`` lines (``pytest -s``)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from _serve_common import (
    ARCHIVED,
    BATCH,
    N_REQ,
    FakeClock,
    make_served,
    outcome,
    rel,
    summary,
)

import bdlz_tpu.serve as js
import bdlz_tpu_torch.serve as ts
from bdlz_tpu.faults import FaultPlan as JPlan
from bdlz_tpu.utils.profiling import ServeStats as JStats
from bdlz_tpu_torch.faults import FaultPlan as TPlan
from bdlz_tpu_torch.serve.serve_cli import DEFERRED_FLAGS
from bdlz_tpu_torch.utils.profiling import ServeStats as TStats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def served(tiny_emulator):
    return make_served(tiny_emulator)


# ---- single service ----------------------------------------------------

def test_yield_service_matches_jax(served):
    jsvc = js.YieldService(served.jart, served.jbase, max_batch_size=BATCH,
                           error_gate_tol=served.gate)
    tsvc = ts.YieldService(served.tart, served.tbase, max_batch_size=BATCH,
                           error_gate_tol=served.gate, device="cpu")
    assert tsvc.exact_engine == "tabulated" and tsvc.error_gate_tol == jsvc.error_gate_tol
    jv, tv, jr, tr = [], [], [], []
    for lo in range(0, N_REQ, BATCH):
        jb = jsvc.process_batch(served.thetas[lo:lo + BATCH])
        tb = tsvc.process_batch(served.thetas[lo:lo + BATCH])
        assert (tb.n_fallback, tb.n_gated, tb.n_retries) == (jb.n_fallback, jb.n_gated,
                                                             jb.n_retries)
        jv += list(jb.values)
        tv += list(tb.values)
        jr += list(jb.reasons)
        tr += list(tb.reasons)
    assert tr == jr
    fast = np.array([r is None for r in jr])
    assert 0 < (~fast).sum() < N_REQ
    assert {"ood", "predicted_error"} <= set(jr)
    r_fast, r_exact = rel(np.array(tv)[fast], np.array(jv)[fast]), \
        rel(np.array(tv)[~fast], np.array(jv)[~fast])
    print(f"RESIDUAL serve fast path {r_fast:.3e} exact fallback {r_exact:.3e} "
          f"({int((~fast).sum())}/{N_REQ} exact)")
    assert r_fast <= 1e-12 and r_exact <= 1e-10


def test_batched_service_stats_match_jax_on_a_fake_clock(served):
    outs = []
    for mod, art, base, kw in (
        (js, served.jart, served.jbase, {}),
        (ts, served.tart, served.tbase, {"device": "cpu"}),
    ):
        clock = FakeClock()
        svc = mod.YieldService(art, base, max_batch_size=BATCH, error_gate_tol=served.gate,
                               **kw)
        mb = svc.make_batcher(max_wait_s=0.005, clock=clock, deadline_s=0.05, annotate=True)
        futs = []
        for i, th in enumerate(served.thetas[:200]):
            futs.append(mb.submit(th))
            if i % 37 == 36:
                clock.advance(0.006)
                mb.run_once()
        clock.advance(0.01)
        while mb.run_once(force=True):
            pass
        outs.append(([f.result(timeout=0) for f in futs], summary(svc.stats),
                     svc.stats.as_rows()))
    (jans, jsum, jrows), (tans, tsum, trows) = outs
    assert tsum == jsum
    assert trows == jrows
    assert [a.fallback_reason for a in tans] == [a.fallback_reason for a in jans]
    assert rel([a.value for a in tans], [a.value for a in jans]) <= 1e-10


# ---- micro-batcher policy ------------------------------------------------

def _echo(mod, stats_cls, **kw):
    clock = FakeClock()

    def process(thetas):
        return mod.BatchResult(values=[float(t[0]) for t in thetas], n_fallback=0)

    return mod.MicroBatcher(process, clock=clock, stats=stats_cls(), **kw), clock


SCENARIOS = {
    "partial_waits": dict(kw=dict(max_batch_size=4, max_wait_s=0.01),
                          steps=[("submit", 3), ("run",), ("adv", 0.011), ("run",)]),
    "full_batch": dict(kw=dict(max_batch_size=4, max_wait_s=0.01),
                       steps=[("submit", 4), ("run",)]),
    "overfull": dict(kw=dict(max_batch_size=4, max_wait_s=0.01),
                     steps=[("submit", 10), ("run",), ("run",), ("run",), ("force",)]),
    "deadline_shed": dict(kw=dict(max_batch_size=4, max_wait_s=0.01, deadline_s=0.02),
                          steps=[("submit", 2), ("adv", 0.03), ("submit", 1), ("adv", 0.011),
                                 ("run",)]),
    "admission": dict(kw=dict(max_batch_size=2, max_wait_s=0.01, queue_bound=3),
                      steps=[("submit", 5), ("run",), ("submit", 2), ("force",)]),
    "clock_fault": dict(kw=dict(max_batch_size=4, max_wait_s=0.01, deadline_s=0.02,
                                fault_plan=[{"site": "clock", "kind": "slow", "key": 0,
                                             "delay_s": 0.05}]),
                        steps=[("submit", 2), ("run",), ("submit", 1), ("adv", 0.02),
                               ("run",)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_batcher_decisions_match_jax(name):
    sc = SCENARIOS[name]
    results = []
    for mod, stats_cls, plan_cls in ((js, JStats, JPlan), (ts, TStats, TPlan)):
        kw = dict(sc["kw"])
        if "fault_plan" in kw:
            kw["fault_plan"] = plan_cls.from_obj(kw["fault_plan"])
        mb, clock = _echo(mod, stats_cls, **kw)
        futs, log, n = [], [], 0
        for step in sc["steps"]:
            if step[0] == "submit":
                for _ in range(step[1]):
                    try:
                        futs.append(mb.submit([float(n)]))
                    except mod.QueueFull:
                        log.append(("rejected", n))
                    n += 1
            elif step[0] == "adv":
                clock.advance(step[1])
            else:
                log.append(("served", mb.run_once(force=step[0] == "force")))
        results.append((log, [outcome(f) for f in futs], mb.stats.summary(),
                        mb.stats.as_rows()))
    assert results[1] == results[0]


# ---- serve CLI -----------------------------------------------------------

@pytest.fixture(scope="module")
def cli_files(served, tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_cli")
    (d / "cfg.json").write_text(json.dumps(ARCHIVED))
    lines = [json.dumps({"id": i, **dict(zip(served.tart.axis_names, map(float, t)))})
             for i, t in enumerate(served.thetas[:40])]
    lines += ["not json", json.dumps({"id": "short", "theta": [1.0, 100.0]}),
              json.dumps({"id": "mode", "theta": list(map(float, served.thetas[0])),
                          "lz_mode": "chain"})]
    (d / "req.jsonl").write_text("\n".join(lines) + "\n")
    return d


def _records(text):
    out = []
    for line in text.strip().splitlines():
        rec = json.loads(line)
        rec.pop("latency_s", None)
        out.append(rec)
    return out


@pytest.mark.parametrize("extra", [[], ["--replicas", "2"]], ids=["service", "fleet"])
def test_serve_cli_records_equal_jax_s(served, cli_files, capsys, extra):
    from bdlz_tpu.serve.serve_cli import main as jmain

    argv = ["--config", str(cli_files / "cfg.json"), "--artifact", served.out_dir,
            "--requests", str(cli_files / "req.jsonl"), *extra]
    assert jmain(argv) == 0
    jrecs = _records(capsys.readouterr().out)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "bdlz_tpu_torch.serve", *argv,
                           "--device", "cpu"], capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    trecs = _records(proc.stdout)
    assert len(trecs) == len(jrecs) == 43
    for t, j in zip(trecs, jrecs):
        assert t.keys() == j.keys()
        if "value" in j:
            assert abs(t.pop("value") / j.pop("value") - 1.0) <= 1e-10
        assert t == j
    done = [json.loads(ln) for ln in proc.stderr.splitlines() if '"serve_done"' in ln]
    assert done and done[0]["requests"] == 40


@pytest.mark.parametrize("flag", sorted(DEFERRED_FLAGS) + ["--self-improve"])
def test_serve_cli_refuses_what_is_not_ported_naming_d7b(served, cli_files, capsys, flag):
    from bdlz_tpu_torch.serve.serve_cli import main

    value = ["on"] if flag == "--self-improve" else (["1"] if DEFERRED_FLAGS[flag][0]
                                                      else [])
    with pytest.raises(SystemExit) as exc:
        main(["--config", str(cli_files / "cfg.json"), "--artifact", served.out_dir,
              "--bench", "4", "--device", "cpu", flag, *value])
    assert exc.value.code == 2
    assert "ROADMAP D7b, serving and elastic sweeps" in capsys.readouterr().err


def test_serve_cli_bench_on_the_cpu(served, cli_files, capsys):
    from bdlz_tpu_torch.serve.serve_cli import main

    assert main(["--config", str(cli_files / "cfg.json"), "--artifact", served.out_dir,
                 "--bench", "300", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "serve_bench_queries_per_sec"
    assert rec["finite"] == rec["requests"] == 300 and rec["fallbacks"] == 0
