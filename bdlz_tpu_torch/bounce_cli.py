"""Bounce solver command line: potential → profile → P.

    python -m bdlz_tpu_torch.bounce_cli --bounce potential.json \\
        --v-w 0.3 --out profile.csv [--device cuda|cpu]
    python -m bdlz_tpu_torch.bounce_cli --audit

Counterpart of ``bdlz_tpu/bounce_cli.py``, with the same flags, JSON
summary and exit codes, plus ``--device``: solve one spec (the shoot runs
as one CUDA kernel on the card), report the release point, wall radius
and Euclidean action against the thin-wall S₄, optionally archive the
derived wall profile as an ``--lz-profile`` CSV and evaluate P at a wall
speed.  ``--audit`` runs ``validation.bounce_audit`` and exits non-zero
on a breach.  On the CPU (``--device cpu``) the shoot is the plain eager
version and takes minutes.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="bdlz_tpu_torch.bounce_cli",
        description="Solve an O(4) bounce from a quartic potential spec "
                    "(bdlz_tpu_torch.bounce): shoot the release point, derive "
                    "the two-channel wall profile, evaluate P",
    )
    from bdlz_tpu_torch.lz.options import add_bounce_flag

    add_bounce_flag(ap)
    ap.add_argument("--v-w", type=float, default=None, dest="v_w",
                    help="Evaluate P_chi_to_B at this wall speed through "
                         "the local LZ composition of the derived profile")
    ap.add_argument("--out", default=None,
                    help="Write the derived wall profile CSV here "
                         "(atomic; loadable via --lz-profile everywhere)")
    ap.add_argument("--schema", default="delta",
                    choices=("delta", "matrix"),
                    help="--out column schema: delta (xi,delta,m_mix) or "
                         "matrix (xi,m11,m22,m12) — both round-trip "
                         "through lz.profile.load_profile_csv")
    ap.add_argument("--n-xi", type=int, default=None, dest="n_xi",
                    help="Profile samples across the wall window "
                         "(default 801)")
    ap.add_argument("--audit", action="store_true",
                    help="Run validation.bounce_audit (reference-potential "
                         "archived-P + thin-wall action gate) and exit "
                         "non-zero on a breach")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    if args.audit:
        if args.bounce or args.out or args.v_w is not None:
            ap.error("--audit pins the reference potential; it takes no "
                     "--bounce/--out/--v-w")
        from bdlz_tpu_torch.validation import bounce_audit

        audit = bounce_audit(device=args.device, **(
            {"n_xi": args.n_xi} if args.n_xi is not None else {}
        ))
        print(json.dumps({
            "audit": "bounce",
            "ok": bool(audit.ok),
            "P_vs_archived": float(audit.P_vs_archived),
            "action_vs_thin_wall": float(audit.action_vs_thin_wall),
            "n_crossings": int(audit.n_crossings),
            **({"reason": audit.reason} if audit.reason else {}),
        }))
        return 0 if audit.ok else 1

    if not args.bounce:
        ap.error("--bounce is required (or --audit)")
    from bdlz_tpu_torch.bounce import (
        as_potential_spec,
        bounce_profile,
        potential_fingerprint,
        solve_bounce,
        thin_wall_action,
        thin_wall_radius,
    )
    from bdlz_tpu_torch.lz.sweep_bridge import profile_fingerprint

    spec = as_potential_spec(args.bounce)
    sol = solve_bounce(spec, device=args.device)
    s4 = thin_wall_action(spec)
    summary = {
        "potential": dict(spec._asdict()),
        "fingerprint": potential_fingerprint(spec),
        "converged": bool(sol.converged),
        "phi0": float(sol.phi0),
        "r_wall": float(sol.r_wall),
        "action": float(sol.action),
        "thin_wall_S4": float(s4),
        "thin_wall_R": float(thin_wall_radius(spec)),
        "action_vs_thin_wall": float(abs(float(sol.action) / s4 - 1.0)),
    }
    if not sol.converged:
        # the summary still says how the shoot failed; nothing downstream
        # is derived from a bad release point
        print(json.dumps(summary))
        return 1
    profile_knobs = {"n_xi": args.n_xi} if args.n_xi is not None else {}
    profile = bounce_profile(spec, solution=sol, **profile_knobs)
    summary["profile_fingerprint"] = profile_fingerprint(profile)
    if args.v_w is not None:
        from bdlz_tpu_torch.lz.sweep_bridge import probabilities_for_points

        P = probabilities_for_points(profile, [args.v_w], method="local")
        summary["v_w"] = float(args.v_w)
        summary["P_chi_to_B"] = float(P[0])
    if args.out:
        from bdlz_tpu_torch.lz.profile import write_profile_csv

        write_profile_csv(args.out, profile, schema=args.schema)
        summary["profile_csv"] = args.out
        summary["schema"] = args.schema
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
