"""bdlz-lint for the port — PyTorch-aware static analysis of its contracts.

Counterpart of ``bdlz_tpu/lint``.  The port must stay bit-reproducible
in float64 on the card and the host, and the regressions that break
that are silent: branches and host syncs that stall the card in hot
paths (R2, R3), magic-number drift in the physics layer (R4), global
torch state (R5), bare sleeps (R7) and tensors built without an
explicit dtype, which then take the process's default (R13).  On top of
those, the KNOB CONTRACT that keeps result identities honest is policed
whole-program (:mod:`bdlz_tpu_torch.lint.contracts`): identity homes
(R8), validation coverage (R9), tri-state conformance (R10) and
CLI↔config parity (R11).  R1, R6 and R12 concern ``jax.jit`` and never
fire in the port.  Everything is stdlib ``ast``, with per-line
suppression (``# bdlz-lint: disable=R3``), stale-suppression
detection, JSON and SARIF 2.1.0 output, and a content-hash-keyed run
cache through the port's provenance store:

    python -m bdlz_tpu_torch.lint bdlz_tpu_torch/ --format json
    python -m bdlz_tpu_torch.lint --changed-only
    python -m bdlz_tpu_torch.lint --format sarif > lint.sarif

Tier-1 pins ``bdlz_tpu_torch/`` at zero unsuppressed findings and zero
stale suppressions (``tests/test_torch_lint.py``).  Rule table:
docs/static_analysis_torch.md.
"""
from bdlz_tpu_torch.lint.analyzer import (  # noqa: F401
    LintReport,
    StaleSuppression,
    lint_paths,
    lint_source,
)
from bdlz_tpu_torch.lint.rules import RULES, Finding, Rule  # noqa: F401
