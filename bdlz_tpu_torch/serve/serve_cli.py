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

``--tenant-map`` serves many artifacts through the multi-tenant plane
(``tenancy.py``: pools cold-admitted from the registry by content hash,
``--memory-budget`` eviction, ``--tenant-routing``,
``--autoscale-interval-s`` and ``--pool-min-replicas``); every record
names its ``pool`` and ``scenario``.  ``--self-improve on`` (with
``--replicas``) attaches the refinement daemon (``bdlz_tpu_torch/refine``:
``--drift-gated-rate``, ``--rebuild-budget``), which needs a provenance
store (``cache_root`` or ``BDLZ_CACHE_ROOT``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np



def _error_record(rid, exc, host_id=None, **extra) -> dict:
    """One structured JSONL error record; ``typed_error`` flags the
    typed serve surface, whose class names are a stable contract."""
    from bdlz_tpu_torch.serve import (
        DeadlineExceeded,
        QueueFull,
        RolloutError,
        ServiceUnavailable,
        TenancyError,
    )

    typed = (QueueFull, DeadlineExceeded, ServiceUnavailable, RolloutError, TenancyError)
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
                    help="closed-loop continuous delivery (bdlz_tpu_torch/refine; "
                         "--replicas only): the refinement daemon watches the "
                         "served traffic for drift, rebuilds traffic-weighted "
                         "and publishes a winning candidate through the "
                         "rollout.  auto = the config tri-state (off here); "
                         "needs a provenance store (cache_root/BDLZ_CACHE_ROOT)")
    ap.add_argument("--drift-gated-rate", type=float, default=None,
                    dest="drift_gated_rate",
                    help="gated or out-of-domain traffic fraction above which "
                         "the refinement daemon declares drift (default: config)")
    ap.add_argument("--rebuild-budget", type=int, default=None, dest="rebuild_budget",
                    help="maximum autonomous rebuild and rollout cycles per "
                         "serve session (default: config)")
    ap.add_argument("--tenant-routing", default=None, dest="tenant_routing",
                    choices=("scenario", "hash"),
                    help="multi-tenant routing-tag policy (--tenant-map only; "
                         "default: config, whose None lets the engine decide)")
    ap.add_argument("--autoscale-interval-s", type=float, default=None,
                    dest="autoscale_interval_s",
                    help="seconds between autoscaler passes (--tenant-map only; "
                         "default: config)")
    ap.add_argument("--pool-min-replicas", type=int, default=None,
                    dest="pool_min_replicas",
                    help="autoscaler floor per resident pool (--tenant-map "
                         "only; default: config)")
    ap.add_argument("--tenant-map", default=None, dest="tenant_map",
                    help="multi-tenant plane (serve/tenancy.py): JSON text or "
                         "path mapping scenario labels to artifact content "
                         "hashes; pools are cold-admitted from the registry "
                         "(cache_root/BDLZ_CACHE_ROOT) on first request")
    ap.add_argument("--memory-budget", type=int, default=None, dest="memory_budget",
                    metavar="BYTES",
                    help="device-memory budget across resident pools "
                         "(--tenant-map only): idle pools are LRU-evicted "
                         "beyond it and answer through the degraded exact "
                         "path until readmitted (default: unbounded)")
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
    args = ap.parse_args(argv)
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
                  "breaker_latency_slo_s", "rollback_budget", "tenant_routing",
                  "autoscale_interval_s", "pool_min_replicas", "drift_gated_rate",
                  "rebuild_budget")
        if getattr(args, k) is not None
    }
    if args.self_improve is not None:
        overrides["self_improve"] = {"auto": None, "on": True, "off": False}[args.self_improve]
    if overrides:
        base = validate(dataclasses.replace(base, **overrides))
    devices = None if device.type == "cuda" else [device]
    if args.tenant_map is not None:
        return _serve_tenant(args, ap, base, event_log, devices)
    if args.artifact is None:
        ap.error("--artifact is required (or serve pools via --tenant-map)")
    from bdlz_tpu_torch.refine import RefinementDaemon, resolve_self_improve

    artifact = load_any_artifact(args.artifact)
    fleet = service = daemon = None
    if args.replicas is not None:
        from bdlz_tpu_torch.serve.fleet import FleetService

        fleet = FleetService(
            artifact, base, field=args.field, max_batch_size=args.max_batch,
            n_replicas=args.replicas if args.replicas > 0 else None,
            devices=devices, queue_bound=args.queue_bound, routing=args.routing,
            max_wait_s=args.max_wait_ms / 1e3,
            deadline_s=None if args.deadline_ms is None else args.deadline_ms / 1e3,
            health={"auto": None, "on": True, "off": False}[args.health],
            lz_profile=args.lz_profile, bounce=args.bounce, host_id=args.host_id,
        )
        if resolve_self_improve(base):
            from bdlz_tpu_torch.provenance import resolve_store

            refine_store = resolve_store(None, base, label="refine")
            if refine_store is None:
                ap.error("--self-improve needs a provenance store for snapshots "
                         "and candidate publishing; set cache_root in the config "
                         "or BDLZ_CACHE_ROOT")
            daemon = RefinementDaemon(fleet, base, store=refine_store,
                                      event_log=event_log)
    else:
        if resolve_self_improve(base):
            ap.error("--self-improve drives the fleet front's rollout pipeline; "
                     "add --replicas N")
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
            n_ok = _serve_requests_fleet(fleet, requests, daemon=daemon)
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


def _load_tenant_map(text_or_path: str) -> dict:
    """A ``--tenant-map`` value: JSON text, or a path to a JSON file.
    Its labels and hashes are checked by the service."""
    text = text_or_path
    if not text_or_path.lstrip().startswith("{"):
        with open(text_or_path, encoding="utf-8") as f:
            text = f.read()
    obj = json.loads(text)
    if not isinstance(obj, dict):
        raise ValueError("tenant map must be a JSON object mapping scenario labels "
                         "to artifact content hashes")
    return obj


def _serve_tenant(args, ap, base, event_log, devices) -> int:
    """``--tenant-map``: drain the request stream through the multi-tenant
    plane.  Every record names its ``pool`` (the answering artifact hash)
    and ``scenario``; routing and skew refusals (``TenancyError``) and a
    pool's overload (``QueueFull``) are per-request error records.
    Closing the service fails anything still queued with a typed
    ``ServiceUnavailable``."""
    from bdlz_tpu_torch.refine import resolve_self_improve
    from bdlz_tpu_torch.serve.tenancy import MultiTenantService

    if args.artifact is not None:
        ap.error("--artifact is not used with --tenant-map (pools are fetched "
                 "from the registry by content hash)")
    if args.bench is not None:
        ap.error("--bench is not supported with --tenant-map")
    if resolve_self_improve(base):
        ap.error("--self-improve watches ONE fleet's traffic; it is not supported "
                 "with --tenant-map")
    if args.requests is None:
        ap.error("one of --requests or --bench is required")
    try:
        tenant_map = _load_tenant_map(args.tenant_map)
    except Exception as exc:  # noqa: BLE001 — a flag-layer refusal
        ap.error(f"--tenant-map: {exc}")
    svc = MultiTenantService(
        base, tenant_map=tenant_map, field=args.field, max_batch_size=args.max_batch,
        n_replicas=args.replicas if args.replicas else None, devices=devices,
        queue_bound=args.queue_bound, routing=args.routing,
        max_wait_s=args.max_wait_ms / 1e3,
        deadline_s=None if args.deadline_ms is None else args.deadline_ms / 1e3,
        health={"auto": None, "on": True, "off": False}[args.health],
        lz_profile=args.lz_profile, bounce=args.bounce,
        memory_budget_bytes=args.memory_budget, host_id=args.host_id,
    )
    event_log.emit("serve_start", tenant_map=dict(tenant_map),
                   tenant_routing=svc.tenant_routing,
                   memory_budget_bytes=svc.memory_budget_bytes,
                   max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)
    n_lines = n_ok = 0
    submitted = []  # (rid, scenario, future)
    resolved_at = {}  # submitted index -> resolve-time latency

    def _stamp(index, t0):
        def cb(_fut):
            resolved_at[index] = time.monotonic() - t0

        return cb

    fh = sys.stdin if args.requests == "-" else open(args.requests, encoding="utf-8")
    try:
        for ln, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            n_lines += 1
            try:
                obj = json.loads(line)
            except Exception as exc:  # noqa: BLE001 — report per request
                print(json.dumps(_error_record(None, exc, host_id=svc.host_id, line=ln,
                                               pool=None, scenario=None)))
                continue
            if not isinstance(obj, dict):
                print(json.dumps(_error_record(ln, ValueError(
                    "request line must be a JSON object"), host_id=svc.host_id,
                    line=ln, pool=None, scenario=None)))
                continue
            rid = obj.get("id", ln)
            scenario = obj.get("scenario")
            ahash = obj.get("artifact_hash")
            pool = ahash if ahash else tenant_map.get(scenario)
            t0 = time.monotonic()
            try:
                if "theta" in obj:
                    fut = svc.submit(np.asarray(obj["theta"], dtype=np.float64),
                                     scenario=scenario, artifact_hash=ahash,
                                     lz_mode=obj.get("lz_mode"))
                else:
                    # a mapping keeps its stated lz_mode inside (checked per pool)
                    point = {k: v for k, v in obj.items()
                             if k not in ("id", "scenario", "artifact_hash")}
                    fut = svc.submit(point, scenario=scenario, artifact_hash=ahash)
            except Exception as exc:  # noqa: BLE001 — report per request
                print(json.dumps(_error_record(rid, exc, host_id=svc.host_id, line=ln,
                                               pool=pool, scenario=scenario)))
                continue
            fut.add_done_callback(_stamp(len(submitted), t0))
            submitted.append((rid, scenario, fut))
            svc.run_once()
            svc.poll(block=False)
    finally:
        if fh is not sys.stdin:
            fh.close()
    try:
        svc.drain()
        for index, (rid, scenario, fut) in enumerate(submitted):
            latency = round(resolved_at.get(index, 0.0), 6)
            try:
                resp = fut.result(timeout=0)
            except Exception as exc:  # noqa: BLE001 — report per request
                print(json.dumps(_error_record(rid, exc, host_id=svc.host_id,
                                               latency_s=latency, pool=None,
                                               scenario=scenario)))
                continue
            n_ok += 1
            print(json.dumps({
                "id": rid,
                "value": float(resp.value),
                "pool": resp.artifact_hash,
                "scenario": (scenario if scenario is not None
                             else svc.scenario_for(resp.artifact_hash)),
                "artifact_hash": resp.artifact_hash,
                "replica": resp.replica,
                "lz_mode": resp.lz_mode,
                "fallback_reason": resp.fallback_reason,
                "degraded": resp.degraded,
                "host_id": resp.host_id,
                "latency_s": latency,
            }))
    finally:
        svc.close()
    event_log.emit("serve_done", **svc.summary())
    return 1 if (n_lines and n_ok == 0) else 0


def _serve_requests_fleet(fleet, requests, daemon=None) -> int:
    """Drain parsed requests through the fleet, pumping it between
    submits; admission rejections become error records.  With a
    refinement ``daemon``, one daemon tick follows each pump (a detected
    drift runs its rebuild and delivery there).  Returns the number of
    requests answered with a value."""
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
        if daemon is not None:
            daemon.step()
    fleet.drain()
    if daemon is not None:
        daemon.step()
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
