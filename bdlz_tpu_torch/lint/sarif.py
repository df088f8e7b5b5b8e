"""SARIF 2.1.0 rendering of the port's bdlz-lint report (counterpart of
``bdlz_tpu/lint/sarif.py``).

One run, one tool (``bdlz-lint-torch``), one result per finding.  Suppressed
findings are carried as SARIF in-source suppressions (CI viewers show
them greyed out instead of dropping them), and stale suppression
comments surface as ``stale-suppression`` warnings so the satellite
contract — a disable comment must suppress something — is visible in
the same upload.  Columns are converted from the analyzer's 0-based
``col_offset`` to SARIF's 1-based ``startColumn``.
"""
from __future__ import annotations

from typing import Any, Dict

from bdlz_tpu_torch.lint.analyzer import LintReport
from bdlz_tpu_torch.lint.rules import RULES

SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)

#: Synthetic rule id for stale ``# bdlz-lint: disable=`` comments.
STALE_RULE_ID = "stale-suppression"


def _location(path: str, line: int, col: int) -> Dict[str, Any]:
    return {
        "physicalLocation": {
            "artifactLocation": {"uri": path},
            "region": {"startLine": line, "startColumn": col + 1},
        }
    }


def to_sarif(report: LintReport) -> Dict[str, Any]:
    """The report as a SARIF 2.1.0 log object (``json.dumps``-ready)."""
    driver_rules = [
        {
            "id": rid,
            "shortDescription": {"text": rule.title},
            "help": {"text": rule.hint},
            "defaultConfiguration": {"level": "error"},
        }
        for rid, rule in RULES.items()
    ]
    driver_rules.append({
        "id": STALE_RULE_ID,
        "shortDescription": {
            "text": "bdlz-lint disable comment that suppresses nothing"
        },
        "help": {"text": "delete the stale comment"},
        "defaultConfiguration": {"level": "warning"},
    })
    rule_index = {r["id"]: i for i, r in enumerate(driver_rules)}

    results = []
    for f in report.findings:
        result: Dict[str, Any] = {
            "ruleId": f.rule,
            "ruleIndex": rule_index[f.rule],
            "level": "error",
            "message": {"text": f"{f.message} — {f.hint}"},
            "locations": [_location(f.path, f.line, f.col)],
        }
        if f.suppressed:
            result["suppressions"] = [{"kind": "inSource"}]
        results.append(result)
    for s in report.stale_suppressions:
        results.append({
            "ruleId": STALE_RULE_ID,
            "ruleIndex": rule_index[STALE_RULE_ID],
            "level": "warning",
            "message": {
                "text": (
                    f"`bdlz-lint: disable={s.rule}` suppresses no "
                    f"{s.rule} finding on this line; delete the comment"
                )
            },
            "locations": [_location(s.path, s.line, 0)],
        })

    return {
        "$schema": SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "bdlz-lint-torch",
                        "informationUri": (
                            "https://example.invalid/bdlz_tpu/"
                            "docs/static_analysis_torch.md"
                        ),
                        "rules": driver_rules,
                    }
                },
                "results": results,
            }
        ],
    }
