"""Content-hash-keyed incremental cache for the port's bdlz-lint runs
(counterpart of ``bdlz_tpu/lint/cache.py``).

The unit of caching is the WHOLE RUN, not the file: the contract rules
(R8–R11) are cross-file — editing ``config.py`` can change findings in
an unchanged CLI module — so a per-file cache would serve stale
cross-file results.  The key therefore folds in

* the analyzer's own source (``lint/rules.py`` + ``lint/analyzer.py`` +
  ``lint/contracts.py``, via the provenance ``code_fingerprint``), so a
  rule change invalidates every cached verdict,
* the selected rule set, and
* every linted file's path and content hash.

Storage goes through the port's provenance
:class:`~bdlz_tpu_torch.provenance.store.Store` (``resolve_store``
tri-state: caching is on exactly when a root is configured), reusing its atomic-write/corrupt-entry-quarantine
discipline instead of inventing a second on-disk format.  A hit
reconstructs the full :class:`LintReport` — findings, suppressed ones,
stale-suppression records — bit-for-bit with what the live run printed.
"""
from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Sequence, Tuple

from bdlz_tpu_torch.lint import analyzer as _analyzer_mod
from bdlz_tpu_torch.lint import contracts as _contracts_mod
from bdlz_tpu_torch.lint import rules as _rules_mod
from bdlz_tpu_torch.lint.analyzer import (
    Finding,
    LintReport,
    StaleSuppression,
    _iter_py_files,
    lint_paths,
)
from bdlz_tpu_torch.lint.rules import RULES


def analyzer_fingerprint() -> str:
    """Source hash of the analyzer itself — part of every cache key."""
    from bdlz_tpu_torch.provenance.identity import code_fingerprint

    return code_fingerprint((_rules_mod, _analyzer_mod, _contracts_mod))


def run_key(paths: Sequence[str], rules: Optional[Sequence[str]]) -> str:
    """Deterministic key for one lint run over the current tree state."""
    selected = sorted(rules) if rules else sorted(RULES)
    h = hashlib.sha256()
    h.update(analyzer_fingerprint().encode())
    h.update(("rules:" + ",".join(selected)).encode())
    for path in sorted(_iter_py_files(paths)):
        h.update(os.path.normpath(path).encode())
        with open(path, "rb") as fh:
            h.update(hashlib.sha256(fh.read()).digest())
    return h.hexdigest()[:32]


def report_from_payload(payload: dict) -> LintReport:
    """Rebuild a report from a cached ``LintReport.to_dict`` payload."""
    findings: List[Finding] = [
        Finding(
            path=f["path"],
            line=f["line"],
            col=f["col"],
            rule=f["rule"],
            message=f["message"],
            suppressed=f["suppressed"],
        )
        for f in payload["findings"]
    ]
    stale = [
        StaleSuppression(path=s["path"], line=s["line"], rule=s["rule"])
        for s in payload.get("stale_suppressions", [])
    ]
    return LintReport(
        findings=findings,
        files_scanned=payload["files_scanned"],
        stale_suppressions=stale,
    )


def cached_lint_paths(
    paths: Sequence[str],
    rules: Optional[Sequence[str]] = None,
    store=None,
) -> Tuple[LintReport, bool]:
    """``lint_paths`` through the store: returns ``(report, cache_hit)``.

    ``store=None`` (caching unresolved/off) degrades to a plain live
    run — same report, ``cache_hit=False``.
    """
    if store is None:
        return lint_paths(paths, rules=rules), False
    name = f"lint_{run_key(paths, rules)}"
    payload = store.get_json(name)
    if payload is not None:
        return report_from_payload(payload), True
    report = lint_paths(paths, rules=rules)
    store.put_json(name, report.to_dict())
    return report, False
