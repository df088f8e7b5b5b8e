"""CLI for the port's bdlz-lint (counterpart of ``python -m bdlz_tpu.lint``).

    python -m bdlz_tpu_torch.lint [paths ...] [--format text|json|sarif]
        [--rules R1,R2] [--changed-only] [--cache auto|on|off]
        [--cache-root DIR]

Exit status: 0 when every finding is suppressed (or none exist) and no
suppression comment is stale, 1 when unsuppressed findings or stale
suppressions remain, 2 on usage errors.  The JSON mode emits the full
report (findings, suppressions, stale suppressions, per-rule counts)
for tooling; ``--format sarif`` emits a SARIF 2.1.0 log for CI code
scanning.

``--changed-only`` restricts *reporting* to files touched in the git
working tree (staged, unstaged, untracked) — the analysis itself always
runs whole-program, because the contract rules (R8–R11) are cross-file:
an edit to ``config.py`` can surface a finding in an unchanged CLI
module, and that finding still reports (a changed file is always
reported at full strength; only findings in files you did not touch
are elided).

``--cache`` keys a whole-run result on the analyzer source + every
linted file's content hash through the provenance store (the
``resolve_store`` tri-state: ``auto`` caches exactly when a root is
configured via ``--cache-root``/``BDLZ_CACHE_ROOT``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import List, Optional

from bdlz_tpu_torch.lint.rules import RULES


def _git_changed_files() -> Optional[List[str]]:
    """Python files touched in the working tree (staged + unstaged +
    untracked), repo-root-relative; None when git is unavailable."""
    try:
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        out: List[str] = []
        for cmd in (
            ["git", "diff", "--name-only", "HEAD"],
            ["git", "ls-files", "--others", "--exclude-standard"],
        ):
            res = subprocess.run(
                cmd, capture_output=True, text=True, check=True, cwd=top,
            )
            out.extend(line for line in res.stdout.splitlines() if line)
        import os

        return sorted({
            os.path.join(top, p) for p in out if p.endswith(".py")
        })
    except (OSError, subprocess.CalledProcessError):
        return None


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bdlz_tpu_torch.lint",
        description="PyTorch-aware static analysis for the bdlz_tpu_torch "
        "port's device and knob-contract conventions (rules R1-R13)",
    )
    ap.add_argument("paths", nargs="*", default=None,
                    help="Files or directories to lint (default: bdlz_tpu_torch/)")
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default="text")
    ap.add_argument("--rules", default=None,
                    help="Comma-separated subset of rule ids (default: all)")
    ap.add_argument("--changed-only", action="store_true",
                    help="Report findings only in git-changed files "
                         "(analysis still runs whole-program)")
    ap.add_argument("--cache", choices=("auto", "on", "off"),
                    default="auto",
                    help="Whole-run result cache through the provenance "
                         "store: auto = on iff a root is configured "
                         "(--cache-root/BDLZ_CACHE_ROOT)")
    ap.add_argument("--cache-root", default=None,
                    help="Store root for --cache (default: BDLZ_CACHE_ROOT)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="Also print suppressed findings in text mode "
                         "(JSON/SARIF modes always carry them)")
    ap.add_argument("--list-rules", action="store_true",
                    help="Print the rule table and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, rule in RULES.items():
            print(f"{rid}  {rule.title}\n    fix: {rule.hint}")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in RULES]
        if unknown:
            print(f"unknown rule id(s): {', '.join(unknown)}", file=sys.stderr)
            return 2

    paths = args.paths or ["bdlz_tpu_torch"]

    store = None
    if args.cache != "off":
        from bdlz_tpu_torch.provenance.store import resolve_store

        # "on" with no root falls back to the default user cache root
        # via a cache_enabled=True surrogate; "auto" is the bare
        # tri-state (cache iff a root is configured)
        class _Gate:
            cache_enabled = True if args.cache == "on" else None
            cache_root = None

        store = resolve_store(args.cache_root, _Gate(), label="lint-cache")

    from bdlz_tpu_torch.lint.cache import cached_lint_paths

    report, cache_hit = cached_lint_paths(paths, rules=rules, store=store)

    if args.changed_only:
        changed = _git_changed_files()
        if changed is None:
            print("bdlz-lint: --changed-only needs git; reporting all "
                  "files", file=sys.stderr)
        else:
            report = report.restrict_to(changed)

    failed = bool(report.active or report.stale_suppressions)
    if args.format == "json":
        payload = report.to_dict()
        payload["cache_hit"] = cache_hit
        print(json.dumps(payload, indent=2))
    elif args.format == "sarif":
        from bdlz_tpu_torch.lint.sarif import to_sarif

        print(json.dumps(to_sarif(report), indent=2))
    else:
        shown = report.findings if args.show_suppressed else report.active
        for f in shown:
            print(f.render())
        for s in report.stale_suppressions:
            print(s.render())
        cached = " [cached]" if cache_hit else ""
        print(
            f"bdlz-lint: {len(report.active)} finding(s), "
            f"{len(report.suppressed)} suppressed, "
            f"{len(report.stale_suppressions)} stale suppression(s), "
            f"{report.files_scanned} file(s) scanned{cached}"
        )
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
