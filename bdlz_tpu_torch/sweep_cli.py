"""Sweep command line, on the card, a mesh of cards or many processes:

    python -m bdlz_tpu_torch.sweep_cli \\
        --config yields_config_equal_mass.json \\
        --axis "m_chi_GeV=geom:0.1:10:64" --axis "v_w=lin:0.05:0.95:16"

Axis syntax: ``name=geom:start:stop:n`` (geomspace), ``lin:start:stop:n``
(linspace), or an explicit comma list ``name=0.1,0.5,1.0``.  A JSON
summary with the JAX sweep CLI's keys goes to stdout.  ``--device cpu``
runs the plain PyTorch path on the host; the default is the card.

The sweep runs on a mesh of ``--device``'s members, as the JAX CLI runs
on ``jax.devices()``: ``cuda`` (the default) is every visible card, and a
comma list names the members (``cuda:0,cuda:1``; ``cpu,cpu`` is a
two-member host mesh).  ``--mesh-sp N`` reserves N members for the sp
axis (it must divide the member count).  ``--multihost`` joins the
process group from JAX's env vars (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) before the mesh is built: run
one identical invocation per process, each adding its members to the
mesh; the coordinator writes ``--out``.

``--lz-profile``/``--bounce`` derive each point's P from its wall speed
through the LZ layer (``--lz-method``, ``--lz-gamma-phi``, and the
scenario flags ``--lz-mode``/``--lz-n-levels``/``--lz-bath-*``), with the
JAX sweep CLI's pairing errors.  ``--out`` writes the chunk files and the
manifest (a rerun resumes; the JAX CLI resumes the same directory for the
engines the two share) and ``--events`` the JSON-lines event log; the
config's ``retry_enabled``, ``cache_enabled``/``cache_root`` and
``fault_injection``/``fault_plan`` act as in the JAX CLI.  ``--sanitize``
checks the outputs' float64 contract, ``--debug-nans`` aborts at the
first torch op (or kernel) that makes a NaN, and ``--profile-dir`` writes
one ``torch.profiler`` Chrome trace of the sweep, with the spans of
``utils/profiling.SPANS`` (the grid, the F table, the audit, the engine's
build, per chunk ``chunk.ship``/``chunk.step``/``chunk.wait``/``chunk.finish``).

``--elastic {local,coordinator,worker,auto}`` runs the sweep on the
elastic work-stealing fleet (``parallel/scheduler.py``) over the shared
store ``--elastic-store``: every role derives the plan from the same
flags, and a role on another device (or of the JAX package) is refused
by the job record; it is refused with ``--multihost``, as in the JAX CLI.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np


def parse_axis(spec: str):
    name, _, rhs = spec.partition("=")
    if not rhs:
        raise ValueError(f"--axis must look like name=geom:a:b:n, got {spec!r}")
    if rhs.startswith(("geom:", "lin:")):
        kind, a, b, n = rhs.split(":")
        a, b, n = float(a), float(b), int(n)
        vals = np.geomspace(a, b, n) if kind == "geom" else np.linspace(a, b, n)
    else:
        vals = np.asarray([float(v) for v in rhs.split(",")])
    return name.strip(), vals


def _run_elastic(args, cfg, static, axes, event_log):
    """Run one ``--elastic`` role.  Every role derives the plan from the
    same ``--config``/``--axis`` flags; the store's job record only checks
    it.  Returns the folded ``SweepResult`` (local, coordinator), or None
    for the worker role, which prints its own JSON summary."""
    import os
    import sys

    from bdlz_tpu_torch.parallel import (
        WallClock,
        elect_coordinator,
        plan_elastic_sweep,
        run_sweep_elastic,
        run_worker_loop,
    )
    from bdlz_tpu_torch.provenance import resolve_store

    store = resolve_store(args.elastic_store, cfg, label="elastic-cli")
    if store is None:
        raise SystemExit(
            f"--elastic-store {args.elastic_store!r} did not resolve to a "
            "trusted store (check ownership/permissions)"
        )
    worker_id = args.worker_id or f"pid{os.getpid()}"
    common = dict(chunk_size=args.chunk, n_y=args.n_y, impl=args.impl,
                  fuse_exp=args.fuse_exp, device=args.device)
    role = args.elastic
    if role == "auto":
        plan = plan_elastic_sweep(cfg, axes, static, **common)
        won = elect_coordinator(store, plan.job, worker_id, ttl_s=args.lease_ttl)
        role = "coordinator" if won else "worker"
        print(f"[elastic] {worker_id}: elected {role}", file=sys.stderr)
    if role == "worker":
        summary = run_worker_loop(
            cfg, axes, static, store=store, worker_id=worker_id,
            lease_ttl_s=args.lease_ttl, quarantine_after=args.quarantine_after,
            churn_plan=args.churn_plan, poll_s=args.poll, event_log=event_log,
            **common,
        )
        print(json.dumps({"elastic": "worker", **summary}))
        return None
    # local: a deterministic in-process fleet; coordinator: the wall
    # clock, so its lease arithmetic agrees with external workers
    clock = None if role == "local" else WallClock()
    return run_sweep_elastic(
        cfg, axes, static, store=store, n_workers=args.elastic_workers,
        lease_ttl_s=args.lease_ttl, quarantine_after=args.quarantine_after,
        churn_plan=args.churn_plan, clock=clock,
        tick_s=(1.0 if clock is None else args.poll), event_log=event_log,
        **common,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="bdlz_tpu_torch parameter sweep")
    ap.add_argument("--config", required=True, help="Base yields_config JSON")
    ap.add_argument("--axis", action="append", default=[],
                    help="Sweep axis, e.g. m_chi_GeV=geom:0.1:10:64 (repeatable)")
    ap.add_argument("--out", default=None, help="Output dir (chunks + manifest; resumable)")
    ap.add_argument("--events", default=None,
                    help="Write JSON-lines sweep events to this file")
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--n-y", type=int, default=8000, dest="n_y")
    ap.add_argument("--mesh-sp", type=int, default=1,
                    help="Devices reserved for the sp (grid) mesh axis")
    ap.add_argument("--impl", default="tabulated",
                    choices=("kernel", "tabulated", "direct", "esdirk",
                             "esdirk_lockstep"),
                    help="Per-point engine: tabulated (default, as in the "
                         "JAX CLI: the quadrature in plain PyTorch, on the "
                         "audited panel rule per --quad), kernel (the "
                         "hand-written CUDA interpolate-and-reduce kernels, "
                         "trapezoid only), direct (the "
                         "exact (n_y x n_z) integrand; forced when I_p is "
                         "swept), esdirk (the lane-repacking stiff Boltzmann "
                         "engine; forced when sigma_v, washout or depletion "
                         "are active), esdirk_lockstep (the same stepper run "
                         "to completion over the whole chunk, kept for A/B)")
    ap.add_argument("--fuse-exp", action="store_true", dest="fuse_exp",
                    help="With --impl kernel: evaluate the merged exponential "
                         "inside the kernel (native f64 exp)")
    ap.add_argument("--quad", default="auto", choices=("auto", "on", "off"),
                    help="y-quadrature on the tabulated engine: auto (default: "
                         "snapped-panel Gauss-Legendre once the population "
                         "audit passes, else the reference trapezoid, "
                         "loudly), on (the panel rule, no audit), off (the "
                         "reference trapezoid).  Overrides the config's "
                         "quad_panel_gl")
    ap.add_argument("--device", default="cuda",
                    help="The mesh's members: cuda (default: every visible card; "
                         "fails without one), cpu, or a comma list such as "
                         "cuda:0,cuda:1 or cpu,cpu")
    ap.add_argument("--profile-dir", default=None,
                    help="Write one torch.profiler Chrome trace of the sweep here, "
                         "with its spans (sweep.grid, f_table, audit, chunk.*)")
    ap.add_argument("--debug-nans", action="store_true",
                    help="Raise on the first torch op or kernel that makes a "
                         "NaN (sanitizer mode; the sweep aborts, nothing is "
                         "quarantined)")
    ap.add_argument("--sanitize", action="store_true",
                    help="Runtime sanitizer: float64 dtype-drift check on "
                         "the sweep outputs (failed points stay in-band NaN)")
    from bdlz_tpu_torch.lz.options import (
        SWEEP_METHODS,
        add_bounce_flag,
        add_lz_method_flags,
        add_lz_scenario_flags,
        apply_scenario_flags,
        bounce_flag_error,
        lz_flags_error,
    )

    add_lz_method_flags(
        ap, default="local", choices=SWEEP_METHODS,
        profile_help="Bounce-profile CSV: derive each point's P_chi_to_B "
                     "from its own wall speed through the two-channel LZ "
                     "kernel (v_w scans then exercise the distributed-LZ "
                     "physics end to end)",
        method_help="Per-point LZ estimator with --lz-profile: local "
                    "(analytic composition, spectrally exact — the "
                    "1e-6-contract default), coherent (full transfer "
                    "matrix, carries Stueckelberg oscillations), "
                    "local-momentum (thermal flux-weighted average), "
                    "dephased (density-matrix transport with "
                    "--lz-gamma-phi dephasing)",
    )
    add_lz_scenario_flags(ap)
    add_bounce_flag(ap)
    ap.add_argument("--multihost", action="store_true",
                    help="Join the process group from JAX_COORDINATOR_ADDRESS/"
                         "JAX_NUM_PROCESSES/JAX_PROCESS_ID before building the mesh "
                         "(run one identical invocation per process)")
    ap.add_argument("--elastic", default=None,
                    choices=("local", "coordinator", "worker", "auto"),
                    help="Elastic work-stealing mode (parallel/scheduler.py): "
                         "local (in-process fleet, deterministic clock), "
                         "coordinator (drive and fold beside external "
                         "workers, wall clock), worker (claim/compute/commit "
                         "only; prints a worker summary), auto (the first "
                         "process to win the coordinator lease drives, the "
                         "rest work).  Every role derives the plan from the "
                         "same --config/--axis flags; drift fails loudly")
    ap.add_argument("--elastic-store", default=None,
                    help="Shared store root of the elastic lease/commit plane "
                         "(required with --elastic)")
    ap.add_argument("--elastic-workers", type=int, default=2,
                    help="In-process fleet size for --elastic local/coordinator")
    ap.add_argument("--worker-id", default=None,
                    help="Stable worker name for --elastic worker/auto "
                         "(default: from the pid)")
    ap.add_argument("--lease-ttl", type=float, default=60.0,
                    help="Elastic lease TTL in seconds (expired leases are "
                         "stolen or requeued)")
    ap.add_argument("--quarantine-after", type=int, default=3,
                    help="Quarantine a chunk fleet-wide after it failed on "
                         "this many distinct workers")
    ap.add_argument("--churn-plan", default=None,
                    help="Operational fault plan JSON or path (sites "
                         "worker_crash/lease/store_read); never joins the "
                         "result identity")
    ap.add_argument("--poll", type=float, default=1.0,
                    help="Elastic worker/coordinator poll interval (seconds)")
    args = ap.parse_args(argv)
    if args.fuse_exp and args.impl != "kernel":
        ap.error("--fuse-exp requires --impl kernel")
    if args.elastic:
        if not args.elastic_store:
            ap.error("--elastic requires --elastic-store (the shared "
                     "lease/commit plane)")
        if args.multihost:
            ap.error("--elastic and --multihost are mutually exclusive "
                     "(elastic workers are single-process; scale is the fleet)")
        if "," in args.device:
            ap.error("--elastic roles run on one device; give --device one")
        if args.out:
            ap.error("--elastic results are committed to the store; "
                     "--out is the static engine's resume dir")
        if args.profile_dir:
            ap.error("--profile-dir is not supported with --elastic")
        if args.lz_profile:
            ap.error("--lz-profile sweeps are not supported with --elastic "
                     "(profiles are not shipped to workers); drop --elastic")
        if args.bounce:
            ap.error("--bounce sweeps are not supported with --elastic "
                     "(the derived profile is not shipped to workers); "
                     "drop --elastic")
    err = bounce_flag_error(args) or lz_flags_error(args, default_method="local")
    if err:
        ap.error(err)
    if args.lz_mode in ("chain", "thermal") and not (args.lz_profile or args.bounce):
        ap.error(f"--lz-mode {args.lz_mode} derives P per point from a "
                 "bounce profile; pass --lz-profile or --bounce")

    if args.multihost:
        from bdlz_tpu_torch.parallel import init_multihost

        init_multihost()

    if args.sanitize:
        from bdlz_tpu_torch import sanitize

        # no op-level NaN check here: the sweep reports failed points as
        # in-band NaN by design; that stricter mode is --debug-nans
        sanitize.enable(nans=False)
    if args.debug_nans:
        from bdlz_tpu_torch.utils.profiling import enable_nan_debugging

        enable_nan_debugging(True)

    from bdlz_tpu_torch.config import load_config, static_choices_from_config, validate
    from bdlz_tpu_torch.constants import PLANCK_DM_OVER_B
    from bdlz_tpu_torch.parallel.sweep import run_sweep

    # the sweep runs on a device backend: strict validation
    cfg = validate(load_config(args.config), backend="gpu")
    # explicit scenario flags override the config's lz_* keys
    cfg = apply_scenario_flags(cfg, args)
    if cfg.lz_mode != "two_channel":
        if not (args.lz_profile or args.bounce):
            raise SystemExit(
                f"lz_mode={cfg.lz_mode!r} derives P per point from a bounce "
                "profile; pass --lz-profile or --bounce"
            )
        if args.lz_method != "local" or args.lz_gamma_phi:
            raise SystemExit(
                f"--lz-method/--lz-gamma-phi have no effect with "
                f"lz_mode={cfg.lz_mode!r} (the scenario owns the kernel)"
            )
    axes: Dict[str, np.ndarray] = dict(parse_axis(s) for s in args.axis)
    if not axes:
        raise SystemExit("at least one --axis is required")

    mesh = None
    if not args.elastic:  # elastic workers are single-process; scale is the fleet
        from bdlz_tpu_torch.parallel import make_mesh, process_count

        members = None if args.device == "cuda" else [d.strip() for d in args.device.split(",")]
        n_local = len(members) if members is not None else _visible_cards()
        n_dev = n_local * process_count()
        sp = max(1, args.mesh_sp)
        if n_dev % sp:
            raise SystemExit(f"--mesh-sp {sp} does not divide device count {n_dev}")
        mesh = make_mesh(shape=(n_dev // sp, sp), devices=members)

    event_log = None
    if args.events:
        from bdlz_tpu_torch.utils.logging import EventLog

        event_log = EventLog(path=args.events)
    static = static_choices_from_config(cfg)
    if args.quad != "auto":
        static = static._replace(quad_panel_gl=args.quad == "on")
    if args.elastic:
        res = _run_elastic(args, cfg, static, axes, event_log)
        if res is None:
            return  # the worker role printed its own summary
    else:
        res = run_sweep(
            cfg, axes, static, mesh=mesh, chunk_size=args.chunk,
            n_y=args.n_y, out_dir=args.out, event_log=event_log,
            impl=args.impl, fuse_exp=args.fuse_exp,
            lz_profile=args.lz_profile, lz_method=args.lz_method,
            lz_gamma_phi=args.lz_gamma_phi, bounce=args.bounce,
            trace_dir=args.profile_dir,
        )
    if args.sanitize:
        # the output boundary: dtype drift is a hard error; failed points
        # are in-band NaN, counted by n_failed
        sanitize.check_tree("L4:solver -> output (sweep)", res.outputs, allow_nan=True)

    ratios = res.outputs["DM_over_B"]
    finite = np.isfinite(ratios)
    if finite.any():
        best = int(np.argmin(np.abs(np.where(finite, ratios, np.inf) - PLANCK_DM_OVER_B)))
        shape = tuple(len(v) for v in axes.values())
        best_idx = np.unravel_index(best, shape)
        closest = {
            "index": best,
            "DM_over_B": float(ratios[best]),
            "target": PLANCK_DM_OVER_B,
            "params": {
                name: float(vals[i]) for (name, vals), i in zip(axes.items(), best_idx)
            },
        }
    else:
        closest = None  # every point failed; keep the summary strict JSON
    print(json.dumps({
        # omit-at-default, as in the JAX CLI
        **({"lz_mode": cfg.lz_mode} if cfg.lz_mode != "two_channel" else {}),
        **({"elastic": args.elastic} if args.elastic else {}),
        "n_points": res.n_points,
        "n_failed": res.n_failed,
        "n_quarantined": res.n_quarantined,
        "n_retries": res.n_retries,
        "seconds": round(res.seconds, 3),
        "points_per_sec": round(res.points_per_sec, 1),
        "resumed_chunks": res.resumed_chunks,
        "quad_impl": res.quad_impl,
        "n_quad_nodes": res.n_quad_nodes,
        "out_dir": res.out_dir,
        "closest_to_planck": closest,
    }))


def _visible_cards() -> int:
    """Every visible card; none raises, as an entry point without a card
    does (the port never falls back)."""
    from bdlz_tpu_torch.backend import resolve_device
    import torch

    resolve_device("cuda")
    return torch.cuda.device_count()


if __name__ == "__main__":
    main()
