"""The micro-batching query front-end.

    python -m bdlz_tpu_torch.serve --config cfg.json --artifact emu_dir/ \\
        [--requests queries.jsonl | --bench N] [--max-batch 256] \\
        [--max-wait-ms 5] [--field DM_over_B] [--events events.jsonl] \\
        [--replicas N] [--queue-bound Q] [--routing least_loaded] \\
        [--device cuda|cpu]

Counterpart of ``bdlz_tpu/serve/serve_cli.py``, with its flags and
defaults, its stdout records and its ``serve_start`` / ``serve_done``
events.  ``--device`` (default ``cuda``; fails without a card) takes the
place of the backend; ``cpu`` runs the plain PyTorch path on the host.
It serves one artifact through the single-service micro-batcher, or a
fleet with ``--replicas N`` (0 = one replica per visible card).

Requests are JSON lines, one query each: an object mapping the
artifact's axis names to values, or ``{"theta": [...]}`` in axis order,
with an optional ``"id"`` echoed back and an optional ``"lz_mode"``
checked against the artifact's.  Answers go to stdout in request order;
``fallback_reason`` is null on the emulator path, ``"ood"`` or
``"predicted_error"`` on the exact path.  ``--bench N`` pushes N random
in-domain queries through the front and prints its throughput.

The multi-tenant plane, its autoscaler and memory budget, and the
closed-loop refinement (``--tenant-map``, ``--memory-budget``,
``--tenant-routing``, ``--autoscale-interval-s``, ``--pool-min-replicas``,
``--self-improve on``, ``--drift-gated-rate``, ``--rebuild-budget``) are
refused, naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np

from bdlz_tpu_torch.utils.deferred import add_deferred_flags, refuse_deferred_flags

_D7B = "ROADMAP D7b, serving and elastic sweeps"
#: Flags of the JAX serve CLI that the port does not have yet.
DEFERRED_FLAGS = {
    "--tenant-map": (True, _D7B), "--memory-budget": (True, _D7B),
    "--tenant-routing": (True, _D7B), "--autoscale-interval-s": (True, _D7B),
    "--pool-min-replicas": (True, _D7B), "--drift-gated-rate": (True, _D7B),
    "--rebuild-budget": (True, _D7B),
}


def _error_record(rid, exc, host_id=None, **extra) -> dict:
    """One structured JSONL error record; ``typed_error`` flags the
    typed serve surface, whose class names are a stable contract."""
    from bdlz_tpu_torch.serve import (
        DeadlineExceeded,
        QueueFull,
        RolloutError,
        ServiceUnavailable,
    )

    typed = (QueueFull, DeadlineExceeded, ServiceUnavailable, RolloutError)
    name = type(exc).__name__
    return {
        "id": rid,
        "error": f"{name}: {exc}",
        "error_type": name,
        "typed_error": isinstance(exc, typed),
        "host_id": host_id,
        **extra,
    }


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bdlz_tpu_torch.serve",
        description="Microbatched yield-surface query service "
        "(emulator fast path + exact out-of-domain fallback)",
    )
    ap.add_argument("--config", required=True,
                    help="yields_config JSON the artifact was built for")
    ap.add_argument("--artifact", default=None,
                    help="emulator artifact directory (manifest.json + artifact.npz)")
    ap.add_argument("--requests", default=None,
                    help="JSON-lines request file ('-' = stdin)")
    ap.add_argument("--bench", type=int, default=None, metavar="N",
                    help="skip --requests; time N random in-domain queries")
    ap.add_argument("--field", default="DM_over_B",
                    help="served output field (default DM_over_B)")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline: a request older than this "
                         "at dispatch is answered with DeadlineExceeded "
                         "(default: none)")
    ap.add_argument("--replicas", type=int, default=None, metavar="N",
                    help="serve through the fleet: N query replicas with "
                         "least-loaded routing; 0 = one per visible card "
                         "(default: the single-service micro-batcher)")
    ap.add_argument("--queue-bound", type=int, default=None,
                    help="admission-control bound: submits beyond this many "
                         "waiting requests get a QueueFull error record")
    ap.add_argument("--routing", default="least_loaded",
                    choices=("least_loaded", "round_robin"),
                    help="fleet micro-batch routing policy (--replicas only)")
    ap.add_argument("--health", default="auto", choices=("auto", "on", "off"),
                    help="replica health plane / circuit breakers "
                         "(--replicas only): auto = the config tri-state "
                         "(fleet default on)")
    ap.add_argument("--breaker-window", type=int, default=None, dest="breaker_window",
                    help="circuit-breaker window in batch outcomes (default: config)")
    ap.add_argument("--breaker-threshold", type=float, default=None,
                    dest="breaker_threshold",
                    help="bad-outcome fraction that opens a breaker (default: config)")
    ap.add_argument("--breaker-cooldown-s", type=float, default=None,
                    dest="breaker_cooldown_s",
                    help="seconds before a half-open probe (default: config)")
    ap.add_argument("--breaker-latency-slo-s", type=float, default=None,
                    dest="breaker_latency_slo_s",
                    help="per-batch latency SLO scored as a bad outcome "
                         "(default: config)")
    ap.add_argument("--rollback-budget", type=float, default=None,
                    dest="rollback_budget",
                    help="post-cutover bad-request fraction that triggers "
                         "rollout auto-rollback (default: config)")
    ap.add_argument("--self-improve", default=None, dest="self_improve",
                    choices=("auto", "on", "off"),
                    help=f"closed-loop refinement; on is not ported yet ({_D7B})")
    ap.add_argument("--lz-profile", default=None, dest="lz_profile",
                    help="Bounce-profile CSV for a chain/thermal artifact's "
                         "exact fallback (must fingerprint-match its build)")
    from bdlz_tpu_torch.lz.options import add_bounce_flag, bounce_flag_error

    add_bounce_flag(ap)
    ap.add_argument("--events", default=None,
                    help="JSON-lines event log path (default stderr)")
    ap.add_argument("--host-id", default=None, dest="host_id",
                    help="host identity stamped on every record (default none)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    add_deferred_flags(ap, DEFERRED_FLAGS)
    args = ap.parse_args(argv)
    refuse_deferred_flags(ap, args, DEFERRED_FLAGS)
    _berr = bounce_flag_error(args)
    if _berr:
        ap.error(_berr)

    from bdlz_tpu_torch.backend import resolve_device
    from bdlz_tpu_torch.config import load_config, validate
    from bdlz_tpu_torch.emulator import load_any_artifact
    from bdlz_tpu_torch.serve.service import YieldService
    from bdlz_tpu_torch.utils.logging import EventLog

    device = resolve_device(args.device)
    event_log = EventLog(path=args.events) if args.events else EventLog()
    base = validate(load_config(args.config))
    overrides = {
        k: getattr(args, k)
        for k in ("breaker_window", "breaker_threshold", "breaker_cooldown_s",
                  "breaker_latency_slo_s", "rollback_budget")
        if getattr(args, k) is not None
    }
    if args.self_improve is not None:
        overrides["self_improve"] = {"auto": None, "on": True, "off": False}[args.self_improve]
    if overrides:
        base = validate(dataclasses.replace(base, **overrides))
    if base.self_improve:
        ap.error(f"--self-improve / self_improve=true is not ported to "
                 f"bdlz_tpu_torch yet ({_D7B})")
    if args.artifact is None:
        ap.error("--artifact is required")
    artifact = load_any_artifact(args.artifact)
    fleet = service = None
    if args.replicas is not None:
        from bdlz_tpu_torch.serve.fleet import FleetService

        devices = None if device.type == "cuda" else [device]
        fleet = FleetService(
            artifact, base, field=args.field, max_batch_size=args.max_batch,
            n_replicas=args.replicas if args.replicas > 0 else None,
            devices=devices, queue_bound=args.queue_bound, routing=args.routing,
            max_wait_s=args.max_wait_ms / 1e3,
            deadline_s=None if args.deadline_ms is None else args.deadline_ms / 1e3,
            health={"auto": None, "on": True, "off": False}[args.health],
            lz_profile=args.lz_profile, bounce=args.bounce, host_id=args.host_id,
        )
    else:
        service = YieldService(
            artifact, base, field=args.field, max_batch_size=args.max_batch,
            lz_profile=args.lz_profile, bounce=args.bounce, device=device,
        )
    front = fleet if fleet is not None else service
    event_log.emit(
        "serve_start",
        artifact=args.artifact,
        lz_mode=front.lz_mode,
        axes=list(artifact.axis_names),
        n_grid_points=artifact.n_points,
        max_rel_err=artifact.manifest.get("max_rel_err"),
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        **(
            {} if fleet is None else {
                "replicas": fleet.replica_set.n_replicas,
                "routing": fleet.replica_set.routing,
                "queue_bound": fleet.queue_bound,
                "artifact_hash": fleet.artifact_hash,
            }
        ),
    )

    if args.bench is not None:
        if fleet is not None:
            return _bench_fleet(fleet, int(args.bench), event_log)
        return _bench(service, int(args.bench), args, event_log)
    if args.requests is None:
        ap.error("one of --requests or --bench is required")

    # per-line fault tolerance: a malformed line gets an error record and
    # the stream keeps draining; exit nonzero only when every line failed
    n_lines = 0
    n_ok = 0
    fh = sys.stdin if args.requests == "-" else open(args.requests, encoding="utf-8")
    try:
        requests = []
        for ln, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            n_lines += 1
            try:
                obj = json.loads(line)
            except Exception as exc:  # noqa: BLE001 — report per request
                print(json.dumps(_error_record(None, exc, host_id=args.host_id, line=ln)))
                continue
            rid = obj.get("id", ln) if isinstance(obj, dict) else ln
            try:
                if "theta" in obj:
                    stated = obj.get("lz_mode")
                    if stated is not None and str(stated) != front.lz_mode:
                        raise ValueError(
                            f"request states lz_mode={str(stated)!r} but "
                            f"this artifact serves lz_mode="
                            f"{front.lz_mode!r} — cross-mode "
                            "artifact/request skew"
                        )
                    theta = np.asarray(obj["theta"], dtype=np.float64)
                else:
                    theta = front.theta_from_mapping(
                        {k: v for k, v in obj.items() if k != "id"})
            except Exception as exc:  # noqa: BLE001 — report per request
                print(json.dumps(_error_record(rid, exc, host_id=args.host_id, line=ln)))
                continue
            if theta.shape != (len(artifact.axis_names),):
                print(json.dumps(_error_record(rid, ValueError(
                    f"theta has {theta.size} coordinates, this "
                    f"artifact takes {len(artifact.axis_names)}"
                ), host_id=args.host_id, line=ln)))
                continue
            requests.append((rid, theta))
    finally:
        if fh is not sys.stdin:
            fh.close()

    if fleet is not None:
        try:
            n_ok = _serve_requests_fleet(fleet, requests)
        finally:
            fleet.close()
        event_log.emit("serve_done", **fleet.stats.summary())
        return 1 if (n_lines and n_ok == 0) else 0

    # warm the exact-fallback path too, so the first latency_s measures
    # serving and not a first call
    from bdlz_tpu_torch.emulator import artifact_hull

    service.evaluate(np.array([artifact_hull(artifact)[0]]))
    batcher = service.make_batcher(
        max_wait_s=args.max_wait_ms / 1e3,
        deadline_s=None if args.deadline_ms is None else args.deadline_ms / 1e3,
        annotate=True,
    )
    batcher.start()
    futures = [(rid, time.monotonic(), batcher.submit(theta)) for rid, theta in requests]
    try:
        for rid, t0, fut in futures:
            try:
                answer = fut.result()
            except Exception as exc:  # noqa: BLE001 — report per request
                print(json.dumps(_error_record(
                    rid, exc, host_id=args.host_id,
                    latency_s=round(time.monotonic() - t0, 6),
                )))
                continue
            n_ok += 1
            print(json.dumps({
                "id": rid,
                "value": float(answer.value),
                "lz_mode": service.lz_mode,
                "fallback_reason": answer.fallback_reason,
                "host_id": args.host_id,
                "latency_s": round(time.monotonic() - t0, 6),
            }))
    finally:
        batcher.stop()
    event_log.emit("serve_done", **service.stats.summary())
    return 1 if (n_lines and n_ok == 0) else 0


def _serve_requests_fleet(fleet, requests) -> int:
    """Drain parsed requests through the fleet, pumping it between
    submits; admission rejections become error records.  Returns the
    number of requests answered with a value."""
    from bdlz_tpu_torch.serve.batcher import QueueFull

    n_ok = 0
    submitted = []  # (rid, future | None, error | None)
    resolved_at = {}  # submitted index -> resolve-time latency

    def _stamp(index, t0):
        def cb(_fut):
            resolved_at[index] = time.monotonic() - t0

        return cb

    for rid, theta in requests:
        t0 = time.monotonic()
        try:
            fut = fleet.submit(theta)
            fut.add_done_callback(_stamp(len(submitted), t0))
            submitted.append((rid, fut, None))
        except QueueFull as exc:
            submitted.append((rid, None, exc))
        fleet.run_once()
        fleet.poll(block=False)
    fleet.drain()
    for index, (rid, fut, err) in enumerate(submitted):
        if err is not None:
            print(json.dumps(_error_record(rid, err, host_id=fleet.host_id, latency_s=0.0)))
            continue
        latency = round(resolved_at.get(index, 0.0), 6)
        try:
            resp = fut.result(timeout=0)
        except Exception as exc:  # noqa: BLE001 — report per request
            print(json.dumps(_error_record(rid, exc, host_id=fleet.host_id,
                                           latency_s=latency)))
            continue
        n_ok += 1
        print(json.dumps({
            "id": rid,
            "value": float(resp.value),
            "pool": resp.artifact_hash,
            "scenario": None,
            "artifact_hash": resp.artifact_hash,
            "replica": resp.replica,
            "lz_mode": resp.lz_mode,
            "fallback_reason": resp.fallback_reason,
            "degraded": resp.degraded,
            "host_id": resp.host_id,
            "latency_s": latency,
        }))
    return n_ok


def _bench_fleet(fleet, n: int, event_log) -> int:
    """--bench through the fleet: random in-domain traffic, pumped so
    the replicas stay overlapped."""
    from bdlz_tpu_torch.emulator import artifact_hull

    rng = np.random.default_rng(0)
    lo, hi = artifact_hull(fleet.artifact)
    thetas = rng.uniform(lo, hi, size=(n, len(lo)))
    t0 = time.monotonic()
    futures = []
    for t in thetas:
        futures.append(fleet.submit(t))
        fleet.run_once()
        fleet.poll(block=False)
    fleet.drain()
    values = [f.result(timeout=0).value for f in futures]
    seconds = time.monotonic() - t0
    summary = fleet.stats.summary()
    print(json.dumps({
        "metric": "serve_bench_queries_per_sec",
        "value": round(n / max(seconds, 1e-9), 1),
        "n_queries": n,
        "wall_seconds": round(seconds, 4),
        "finite": int(np.isfinite(np.asarray(values)).sum()),
        "n_replicas": fleet.replica_set.n_replicas,
        "routing": fleet.replica_set.routing,
        "artifact_hash": fleet.artifact_hash,
        **summary,
    }))
    event_log.emit("serve_bench_done", n_queries=n, wall_seconds=round(seconds, 4),
                   **summary)
    return 0


def _bench(service, n: int, args, event_log) -> int:
    """--bench: random in-domain traffic through the real batcher."""
    from bdlz_tpu_torch.emulator import artifact_hull

    rng = np.random.default_rng(0)
    lo, hi = artifact_hull(service.artifact)
    thetas = rng.uniform(lo, hi, size=(n, len(lo)))
    service.evaluate(thetas[: min(n, service.max_batch_size)])
    batcher = service.make_batcher(max_wait_s=args.max_wait_ms / 1e3)
    batcher.start()
    t0 = time.monotonic()
    futures = [batcher.submit(t) for t in thetas]
    values = [f.result() for f in futures]
    seconds = time.monotonic() - t0
    batcher.stop()
    summary = service.stats.summary()
    print(json.dumps({
        "metric": "serve_bench_queries_per_sec",
        "value": round(n / max(seconds, 1e-9), 1),
        "n_queries": n,
        "seconds": round(seconds, 4),
        "finite": int(np.isfinite(np.asarray(values)).sum()),
        **summary,
    }))
    event_log.emit("serve_bench_done", n_queries=n, wall_seconds=round(seconds, 4),
                   **summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
