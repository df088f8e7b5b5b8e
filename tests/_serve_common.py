"""Shared inputs and helpers of the serving-plane parity tests
(``test_torch_serve.py``, ``test_torch_fleet.py``): one artifact
directory loaded by both packages, seeded requests, a fake clock."""
from types import SimpleNamespace

import numpy as np

import bdlz_tpu.serve as js
from bdlz_tpu.emulator import load_any_artifact as jload
from bdlz_tpu.faults import FaultPlan as JPlan
from bdlz_tpu_torch.config import config_from_dict as tcfg
from bdlz_tpu_torch.emulator import load_any_artifact as tload
from bdlz_tpu_torch.faults import FaultPlan as TPlan

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
N_REQ, BATCH = 512, 64


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt



def make_served(tiny_emulator):
    """Both packages' view of one artifact directory, the two configs,
    512 seeded requests (10% outside the box) and an error gate that
    routes part of the in-domain traffic to the exact path."""
    jbase, out_dir, _, _ = tiny_emulator
    jart, tart = jload(out_dir), tload(out_dir)
    rng = np.random.default_rng(2024)
    lo, hi = jart.hull
    inside = rng.uniform(lo, hi, size=(N_REQ, 3))
    n_out = N_REQ // 10
    outside = rng.uniform(lo, hi, size=(n_out, 3))
    axis = rng.integers(0, 3, n_out)
    side = rng.integers(0, 2, n_out)
    for i, (k, s) in enumerate(zip(axis, side)):
        outside[i, k] = (lo[k] - 0.05 * (hi[k] - lo[k])) if s == 0 else (hi[k] * 1.05)
    thetas = inside.copy()
    thetas[rng.choice(N_REQ, n_out, replace=False)] = outside
    gate = float(np.quantile(np.asarray(jart.predicted_error), 0.8))
    return SimpleNamespace(jart=jart, tart=tart, jbase=jbase, tbase=tcfg(ARCHIVED),
                           thetas=thetas, gate=gate, out_dir=out_dir)


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a / b - 1.0))) if a.size else 0.0


_WALL = ("warmup_seconds",)


def summary(stats):
    return {k: v for k, v in stats.summary().items() if k not in _WALL}


def outcome(fut):
    try:
        return ("ok", fut.result(timeout=0))
    except Exception as exc:  # noqa: BLE001 — the outcome is compared
        return ("err", type(exc).__name__)


def fleet(mod, served, *, n_replicas, plan=None, routing="least_loaded", health=None,
           store=None, gate=None):
    clock = FakeClock()
    art, base = (served.jart, served.jbase) if mod is js else (served.tart, served.tbase)
    kw = {} if mod is js else {"devices": ["cpu"]}
    plan_cls = JPlan if mod is js else TPlan
    f = mod.FleetService(
        art, base, max_batch_size=32, n_replicas=n_replicas, routing=routing, clock=clock,
        fault_plan=None if plan is None else plan_cls.from_obj(plan), health=health,
        store=store, error_gate_tol=gate, **kw)
    return f, clock


def pump(fleet, clock, thetas, step=16, dt=0.004):
    """Submit, launch every ``step`` requests and resolve what is in
    flight (blocking: readiness of an asynchronous dispatch is a wall-
    clock fact, the fake clock decides everything else)."""
    futs = []
    for i, th in enumerate(thetas):
        futs.append(fleet.submit(th))
        if i % step == step - 1:
            clock.advance(dt)
            fleet.run_once()
            while fleet.in_flight():
                fleet.poll(block=True)
    clock.advance(0.01)
    fleet.drain()
    return [f.result(timeout=0) for f in futs]
