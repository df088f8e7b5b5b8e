"""Rule registry and finding type for the port's bdlz-lint.

Rule ids keep the JAX package's numbers wherever the meaning carries
over (``bdlz_tpu/lint/rules.py``).  R1, R6 and R12 concern code compiled
by ``jax.jit``; the port compiles nothing with ``torch.compile`` or
``torch.jit``, so they stay in the table, marked as not applying, and
never fire.  R13 is the port's own: the f64 rule, a tensor built without
an explicit dtype.  The analyzer (:mod:`bdlz_tpu_torch.lint.analyzer`)
decides where a rule applies; this module owns what each rule means and
how a finding renders.
"""
from __future__ import annotations

from dataclasses import dataclass

NOT_IN_PORT = " (does not apply to the port: it compiles nothing with torch.compile or torch.jit)"


@dataclass(frozen=True)
class Rule:
    """One lint rule: stable id, what it catches, and how to fix it."""

    id: str
    title: str
    hint: str


_RULE_LIST = (
    Rule(
        "R1",
        "host numpy/scipy call reachable from jit-compiled code" + NOT_IN_PORT,
        "nothing to fix in the port: the rule never fires",
    ),
    Rule(
        "R2",
        "Python if/while/assert on a tensor-valued test in a hot-path module",
        "a torch.* call or .any()/.all()/.item() of a tensor in a branch "
        "test waits for the device; use torch.where, or keep the decision "
        "on the host side of the layer boundary",
    ),
    Rule(
        "R3",
        "host-sync call inside a hot-path module",
        ".item()/.cpu()/.tolist()/.numpy()/torch.cuda.synchronize() and "
        "float()/int()/bool() of a tensor wait for the device and copy to "
        "the host; keep values on the device until the layer boundary",
    ),
    Rule(
        "R4",
        "bare float literal in a physics module",
        "name it in constants.py — the bit-identical contract needs every "
        "magic number to have exactly one home",
    ),
    Rule(
        "R5",
        "global torch state written outside backend.py",
        "torch.set_default_dtype/set_default_device and torch.backends.* "
        "change every later tensor of the process: pass dtype= and "
        "device= explicitly instead",
    ),
    Rule(
        "R6",
        "jitted entry point missing static_argnums/static_argnames" + NOT_IN_PORT,
        "nothing to fix in the port: the rule never fires",
    ),
    Rule(
        "R7",
        "bare time.sleep call outside utils/retry.py",
        "waiting has one owner: route delays through an injectable "
        "sleep seam (RetryPolicy.sleep, a sleep=... parameter) so "
        "tests and the elastic scheduler can drive time "
        "deterministically; a sleep=time.sleep default-arg REFERENCE "
        "is the sanctioned pattern",
    ),
    Rule(
        "R8",
        "Config field with zero or two identity homes",
        "every Config field joins result identity through exactly one "
        "home: the shared config payload (config_identity_dict), an "
        "explicit identity key (provenance/identity.py, hash_extra, "
        "build_identity) or StaticChoices membership for tri-state "
        "knobs, OR membership in exactly one *_CONFIG_FIELDS exclusion "
        "tuple that config_identity_dict consults (directly or through "
        "one module-level union of such tuples)",
    ),
    Rule(
        "R9",
        "Config field with no validate() check and no exemption",
        "check the field in config.validate() or list it in "
        "VALIDATION_EXEMPT_FIELDS with a justification — a knob the "
        "schema accepts but nothing bounds fails three layers later "
        "with a worse message",
    ),
    Rule(
        "R10",
        "direct truthiness test on a tri-state (None/bool) knob",
        "None means 'engine decides', not False: route the knob "
        "through its sanctioned resolver (resolve_* seam) or compare "
        "explicitly (is None / is True / is False) — a bare truth "
        "test silently collapses the tri-state",
    ),
    Rule(
        "R11",
        "CLI flag without a config twin, or serving knob without a flag",
        "a CLI flag's dest must name its Config field (or a "
        "declared alias / operational-flag entry in lint.contracts), "
        "and every SERVE/SCENARIO/SAMPLER config knob must be "
        "reachable from some CLI flag — orphans drift",
    ),
    Rule(
        "R12",
        "jitted callable re-invoked in a Python loop with a varying "
        "structural argument" + NOT_IN_PORT,
        "nothing to fix in the port: the rule never fires",
    ),
    Rule(
        "R13",
        "tensor constructor without an explicit dtype=",
        "pin dtype= (torch.float64 for physics values) on every "
        "torch.tensor/as_tensor/zeros/ones/empty/full/arange/linspace/"
        "logspace/eye/rand/randn: the default dtype is float32 and "
        "process-wide state; the *_like forms inherit theirs",
    ),
)

RULES = {r.id: r for r in _RULE_LIST}


@dataclass
class Finding:
    """One lint finding, suppressed or not, at a file:line:col location."""

    path: str
    line: int
    col: int
    rule: str
    message: str
    suppressed: bool = False

    @property
    def hint(self) -> str:
        return RULES[self.rule].hint

    def render(self) -> str:
        tag = " [suppressed]" if self.suppressed else ""
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule} "
            f"{self.message}{tag}\n    hint: {self.hint}"
        )

    def to_dict(self) -> dict:
        return {
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "rule": self.rule,
            "message": self.message,
            "hint": self.hint,
            "suppressed": self.suppressed,
        }
