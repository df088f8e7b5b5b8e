"""The port's bdlz-lint AST pass: collect, check, report.

Counterpart of ``bdlz_tpu/lint/analyzer.py``, with PyTorch's rules.
Pipeline (stdlib ``ast`` and ``tokenize`` only; the linted code is never
imported):

1. **Collect** — parse every ``.py`` file and record its import aliases,
   so that ``th.zeros`` and ``from torch import zeros`` both resolve to
   ``torch.zeros``, and its ``# bdlz-lint: disable=`` comments.
2. **Check** — walk each module once for the per-file rules: tensor-valued
   branch tests (R2) and host syncs (R3) in the hot-path directories,
   magic floats in physics modules (R4), global torch state (R5), bare
   sleeps (R7) and tensor constructors without a dtype (R13).  Whether an
   expression is a tensor is judged locally and syntactically: a
   ``torch.*`` call that is not a host query, a method, attribute or
   index of a tensor, an operator with a tensor operand, or a name the
   enclosing function last bound to one of these.
3. **Contracts** — the knob-contract rules R8–R11 over the whole file
   set (:mod:`bdlz_tpu_torch.lint.contracts`).
4. **Report** — a finding on a physical line carrying
   ``# bdlz-lint: disable=R3[,R13...]`` (or ``disable=all``) is kept in
   the report but does not count toward the exit status; a comment that
   suppresses nothing is a stale suppression, which does.

R1, R6 and R12 need ``jax.jit`` call sites; the port has none, so the
pass never emits them.  The judgement of tensor-ness is deliberately
heuristic (no type inference across calls or modules); the rules are
tuned so that the port stays quiet and each seeded violation of
``tests/fixtures/lint_torch/`` is caught — ``tests/test_torch_lint.py``
pins both directions.
"""
from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from bdlz_tpu_torch.lint.rules import RULES, Finding

#: Directories whose modules hold hot-path code (R2 and R3 scope).
HOT_DIRS = ("physics", "lz", "solvers", "ops")

#: Modules allowed to write global torch state (R5).
CONFIG_OWNERS = ("backend.py", "conftest.py")

#: Modules allowed to CALL time.sleep directly (R7); ``sleep=time.sleep``
#: as a default-arg REFERENCE is the sanctioned seam everywhere else.
SLEEP_OWNERS = ("retry.py",)

#: Constructors whose dtype defaults to process-wide state (R13).  The
#: ``*_like`` forms inherit their input's dtype and are not listed.
TENSOR_CONSTRUCTORS = frozenset(
    "torch." + name for name in (
        "tensor", "as_tensor", "zeros", "ones", "empty", "full", "arange",
        "linspace", "logspace", "eye", "rand", "randn",
    )
)

#: Global torch state setters (R5); assignments to ``torch.backends.*``
#: are the other half of the rule.
GLOBAL_STATE_SETTERS = frozenset({
    "torch.set_default_dtype", "torch.set_default_device", "torch.set_default_tensor_type",
})

#: ``torch.*`` calls that return host values (devices, dtypes, flags,
#: contexts), not tensors: a branch on them waits for nothing.
HOST_TORCH_PREFIXES = (
    "torch.cuda.", "torch.backends.", "torch.distributed.", "torch.utils.",
    "torch.testing.", "torch.profiler.", "torch.multiprocessing.",
)
HOST_TORCH_CALLS = frozenset(
    "torch." + name for name in (
        "device", "dtype", "finfo", "iinfo", "Size", "Generator", "is_tensor",
        "is_floating_point", "is_complex", "numel", "get_default_dtype",
        "get_default_device", "no_grad", "enable_grad", "inference_mode",
        "set_grad_enabled", "manual_seed", "promote_types", "result_type", "can_cast",
    )
)

#: Tensor methods that return host values.
HOST_METHODS = frozenset({
    "item", "tolist", "numpy", "size", "dim", "numel", "nelement", "ndimension",
    "stride", "data_ptr", "element_size", "is_contiguous", "get_device",
    "storage_offset", "is_floating_point", "is_complex",
})

#: Tensor attributes that are tensors themselves (``.shape`` and the
#: like are host metadata).
TENSOR_ATTRS = frozenset({"T", "mT", "H", "real", "imag", "data", "grad"})

#: Modules whose calls return host values.
HOST_MODULES = ("numpy.", "math.")

#: Host syncs by method (R3), and branch-test methods that reduce a
#: tensor to a host bool or number (R2): both fire on a receiver the pass
#: cannot show to be a host value — in a hot-path module an array is a
#: tensor unless it came from NumPy.
SYNC_METHODS = ("item", "cpu", "tolist", "numpy")
BRANCH_REDUCTIONS = ("any", "all", "item")

TENSOR, HOST = "tensor", "host"

_SUPPRESS_RE = re.compile(r"bdlz-lint:\s*disable=([A-Za-z0-9_,\s]+)")


# ---------------------------------------------------------------------------
# collection


class ModuleInfo:
    def __init__(self, path: str, modname: str, source: str) -> None:
        self.path = path
        self.modname = modname
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.basename = os.path.basename(path)
        # local name -> canonical dotted module ("torch", "numpy", ...)
        self.import_alias: Dict[str, str] = {}
        # local name -> (module, attr) for `from module import attr as name`
        self.from_alias: Dict[str, Tuple[str, str]] = {}
        self.suppressions = _collect_suppressions(source)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.import_alias[alias.asname or alias.name.split(".")[0]] = (
                        alias.name if alias.asname else alias.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for alias in node.names:
                    self.from_alias[alias.asname or alias.name] = (node.module, alias.name)

    def _dir_parts(self) -> List[str]:
        return self.path.replace("\\", "/").split("/")

    def in_hot_dir(self) -> bool:
        return any(d in self._dir_parts() for d in HOT_DIRS)

    def in_physics_dir(self) -> bool:
        return "physics" in self._dir_parts()

    def canonical(self, node: ast.AST) -> Optional[str]:
        """``th.zeros`` -> "torch.zeros" through this module's imports;
        None for a chain not rooted in an imported name."""
        chain = _attr_chain(node)
        if chain is None:
            return None
        root = chain[0]
        if root in self.import_alias:
            return ".".join([self.import_alias[root]] + chain[1:])
        if root in self.from_alias:
            module, attr = self.from_alias[root]
            return ".".join([f"{module}.{attr}"] + chain[1:])
        return None


def _collect_suppressions(source: str) -> Dict[int, Set[str]]:
    """Map physical line -> set of suppressed rule ids (or {"all"})."""
    out: Dict[int, Set[str]] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
            out.setdefault(tok.start[0], set()).update({"all"} if "all" in ids else ids)
    except (tokenize.TokenError, SyntaxError):  # pragma: no cover
        pass  # ast.parse already succeeded; degrade to no-suppressions
    return out


def _attr_chain(node: ast.AST) -> Optional[List[str]]:
    """``a.b.c`` -> ["a", "b", "c"]; None for non-name-rooted chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _torch_returns_tensor(canon: str) -> bool:
    return canon.startswith("torch.") and not (
        canon in HOST_TORCH_CALLS or canon.startswith(HOST_TORCH_PREFIXES))


# ---------------------------------------------------------------------------
# rule pass


class _RulePass(ast.NodeVisitor):
    def __init__(self, mod: ModuleInfo, findings: List[Finding], selected: Set[str]) -> None:
        self.mod = mod
        self.findings = findings
        self.selected = selected
        self.hot = mod.in_hot_dir()
        # name -> kind of the value it was last bound to, per enclosing
        # function (module level first)
        self.scopes: List[Dict[str, str]] = [{}]

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        if rule in self.selected:
            self.findings.append(Finding(path=self.mod.path, line=node.lineno,
                                         col=node.col_offset, rule=rule, message=message))

    # -- tensor-ness ------------------------------------------------------
    def kind(self, node: ast.AST) -> Optional[str]:
        """The kind of ``node``'s value: TENSOR, HOST (NumPy, Python or
        torch metadata) or None when the pass cannot tell."""
        if isinstance(node, ast.Call):
            canon = self.mod.canonical(node.func)
            if canon is not None:
                if canon.startswith("torch."):
                    return TENSOR if _torch_returns_tensor(canon) else HOST
                return HOST if canon.startswith(HOST_MODULES) else None
            if isinstance(node.func, ast.Attribute):
                recv = self.kind(node.func.value)
                if recv == TENSOR and node.func.attr in HOST_METHODS:
                    return HOST
                return recv
            return None
        if isinstance(node, ast.Name):
            return self.scopes[-1].get(node.id)
        if isinstance(node, ast.Attribute):
            recv = self.kind(node.value)
            if recv == TENSOR and node.attr not in TENSOR_ATTRS:
                return HOST  # .shape, .dtype, .device, ...
            return recv
        if isinstance(node, ast.Subscript):
            return self.kind(node.value)
        if isinstance(node, ast.Compare) and any(
            isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops
        ):
            return HOST
        if isinstance(node, ast.BinOp):
            return self._combined([node.left, node.right])
        if isinstance(node, ast.Compare):
            return self._combined([node.left, *node.comparators])
        if isinstance(node, ast.IfExp):
            return self._combined([node.body, node.orelse])
        if isinstance(node, ast.UnaryOp):
            return self.kind(node.operand)
        if isinstance(node, (ast.Constant, ast.List, ast.Tuple, ast.Dict, ast.Set,
                             ast.JoinedStr)):
            return HOST
        return None

    def _combined(self, operands: List[ast.AST]) -> Optional[str]:
        """An operator's kind: a tensor if any operand is one, a host value
        if all are."""
        kinds = {self.kind(x) for x in operands}
        if TENSOR in kinds:
            return TENSOR
        return HOST if kinds == {HOST} else None

    def is_tensor(self, node: ast.AST) -> bool:
        return self.kind(node) == TENSOR

    def _bind(self, target: ast.AST, kind: Optional[str]) -> None:
        if isinstance(target, ast.Name):
            if kind is None:
                self.scopes[-1].pop(target.id, None)
            else:
                self.scopes[-1][target.id] = kind
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:  # unpacking: the kind per element is unknown
                self._bind(elt, None)

    # -- traversal --------------------------------------------------------
    def _visit_func(self, node) -> None:
        for dec in node.decorator_list:
            self.visit(dec)
        a = node.args
        params = a.posonlyargs + a.args + a.kwonlyargs
        self.scopes.append({p.arg: TENSOR for p in params
                            if p.annotation is not None and "Tensor" in ast.unparse(p.annotation)})
        for child in node.body:
            self.visit(child)
        self.scopes.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self.scopes.append({})
        self.visit(node.body)
        self.scopes.pop()

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        kind = self.kind(node.value)
        for target in node.targets:
            self._bind(target, kind)
            self._check_backends_write(target)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self.generic_visit(node)
        if node.value is not None:
            self._bind(node.target, self.kind(node.value))
        self._check_backends_write(node.target)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.generic_visit(node)
        self._check_backends_write(node.target)

    def _check_backends_write(self, target: ast.AST) -> None:
        # R5 — torch.backends.* flags are process-wide
        canon = self.mod.canonical(target) if isinstance(target, ast.Attribute) else None
        if canon and canon.startswith("torch.backends.") and (
            self.mod.basename not in CONFIG_OWNERS
        ):
            self._emit("R5", target, f"`{canon}` written outside backend.py")

    def visit_Call(self, node: ast.Call) -> None:
        canon = self.mod.canonical(node.func)

        # R5 — global default dtype/device
        if canon in GLOBAL_STATE_SETTERS and self.mod.basename not in CONFIG_OWNERS:
            self._emit("R5", node, f"`{canon}()` outside backend.py")

        # R7 — bare waits outside the retry seam (only CALLS: passing
        # time.sleep as a default-arg reference is the sanctioned seam)
        if canon == "time.sleep" and self.mod.basename not in SLEEP_OWNERS:
            self._emit("R7", node, "time.sleep() called outside utils/retry.py")

        # R13 — the dtype comes from process-wide state
        if canon in TENSOR_CONSTRUCTORS and not any(
            kw.arg == "dtype" or kw.arg is None for kw in node.keywords
        ):
            self._emit("R13", node, f"`{canon}()` without an explicit dtype=")

        # R3 — host syncs in hot-path modules
        if self.hot:
            if (
                canon is None
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in SYNC_METHODS
                and self.kind(node.func.value) != HOST
            ):
                self._emit("R3", node, f".{node.func.attr}() waits for the device")
            elif canon == "torch.cuda.synchronize":
                self._emit("R3", node, "torch.cuda.synchronize() waits for the device")
            elif (
                isinstance(node.func, ast.Name)
                and node.func.id in ("float", "int", "bool")
                and node.func.id not in self.mod.from_alias
                and node.args
                and self.is_tensor(node.args[0])
            ):
                self._emit("R3", node, f"{node.func.id}() of a tensor waits for the device")

        self.generic_visit(node)

    def _tensor_test(self, test: ast.AST) -> Optional[str]:
        """Why a branch test is tensor-valued, or None."""
        for sub in ast.walk(test):
            if not isinstance(sub, ast.Call):
                continue
            canon = self.mod.canonical(sub.func)
            if canon is not None:  # a module's function, not a method
                if _torch_returns_tensor(canon):
                    return f"`{canon}()` in the test"
            elif (
                isinstance(sub.func, ast.Attribute)
                and sub.func.attr in BRANCH_REDUCTIONS
                and self.kind(sub.func.value) != HOST
            ):
                return f"`.{sub.func.attr}()` of a device value in the test"
        return None

    def _check_branch(self, node: ast.AST, test: ast.AST, kind: str) -> None:
        if not self.hot or len(self.scopes) == 1:
            return  # R2 is about functions of hot-path modules
        why = self._tensor_test(test)
        if why:
            self._emit("R2", node, f"Python `{kind}` waits for the device: {why}")

    def visit_If(self, node: ast.If) -> None:
        self._check_branch(node, node.test, "if")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_branch(node, node.test, "while")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._check_branch(node, node.test, "assert")
        self.generic_visit(node)

    def visit_Constant(self, node: ast.Constant) -> None:
        # R4 — magic floats in physics modules
        if (
            self.mod.in_physics_dir()
            and isinstance(node.value, float)
            and _significant_digits(node.value) > 2
        ):
            self._emit("R4", node, f"bare float literal {node.value!r} in a physics module")
        self.generic_visit(node)


def _significant_digits(value: float) -> int:
    """Decimal significant digits of a float's shortest repr mantissa.

    Guard-rail values (0.5, 1e-30, 50.0) have <=2; physical constants
    (1.66, 106.75, 2891.0) have more — that asymmetry is the rule.
    """
    mantissa = repr(abs(value)).split("e")[0].split("E")[0]
    return len(mantissa.replace(".", "").strip("0"))


# ---------------------------------------------------------------------------
# running the pass


@dataclass
class StaleSuppression:
    """A ``# bdlz-lint: disable=Rx`` comment that suppresses nothing."""

    path: str
    line: int
    rule: str  # the stale id from the comment ("all" included)

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}: stale suppression "
            f"`bdlz-lint: disable={self.rule}` — no {self.rule} finding "
            "on this line; delete the comment"
        )

    def to_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "rule": self.rule}


@dataclass
class LintReport:
    findings: List[Finding]
    files_scanned: int
    stale_suppressions: List[StaleSuppression] = field(default_factory=list)

    @property
    def active(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> List[Finding]:
        return [f for f in self.findings if f.suppressed]

    def restrict_to(self, paths: Sequence[str]) -> "LintReport":
        """Report view filtered to ``paths`` (for ``--changed-only``).

        The ANALYSIS always runs whole-program — a changed config.py can
        break a contract whose finding lands in an unchanged CLI module,
        so restriction is a reporting concern only, applied after the
        full cross-file pass.
        """
        keep = {os.path.abspath(p) for p in paths}
        return LintReport(
            findings=[f for f in self.findings if os.path.abspath(f.path) in keep],
            files_scanned=self.files_scanned,
            stale_suppressions=[s for s in self.stale_suppressions
                                if os.path.abspath(s.path) in keep],
        )

    def to_dict(self) -> dict:
        counts: Dict[str, int] = {}
        for f in self.active:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return {
            "files_scanned": self.files_scanned,
            "n_findings": len(self.active),
            "n_suppressed": len(self.suppressed),
            "n_stale_suppressions": len(self.stale_suppressions),
            "counts_by_rule": counts,
            "findings": [f.to_dict() for f in self.findings],
            "stale_suppressions": [s.to_dict() for s in self.stale_suppressions],
            "rules": {rid: {"title": r.title, "hint": r.hint} for rid, r in RULES.items()},
        }


def _iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                if "__pycache__" in root:
                    continue
                for f in sorted(files):
                    if f.endswith(".py"):
                        out.append(os.path.join(root, f))
        elif p.endswith(".py"):
            out.append(p)
    return out


def _modname_for(path: str) -> str:
    rel = os.path.normpath(path).replace("\\", "/")
    rel = rel[:-3] if rel.endswith(".py") else rel
    parts = [p for p in rel.split("/") if p not in (".", "")]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    # anchor at the package root if the file lives inside one
    if "bdlz_tpu_torch" in parts:
        parts = parts[parts.index("bdlz_tpu_torch"):]
    return ".".join(parts)


def lint_paths(paths: Sequence[str], rules: Optional[Sequence[str]] = None) -> LintReport:
    """Lint files/directories; returns every finding (suppressed included)."""
    modules: List[ModuleInfo] = []
    for path in _iter_py_files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        modules.append(ModuleInfo(path, _modname_for(path), source))
    return _run(modules, set(rules) if rules else set(RULES))


def lint_source(source: str, path: str = "<memory>",
                rules: Optional[Sequence[str]] = None) -> LintReport:
    """Lint one in-memory source blob (test/tooling convenience)."""
    return _run([ModuleInfo(path, _modname_for(path), source)],
                set(rules) if rules else set(RULES))


def _run(modules: List[ModuleInfo], selected: Set[str]) -> LintReport:
    from bdlz_tpu_torch.lint.contracts import emit_contract_findings

    findings: List[Finding] = []
    for mod in modules:
        _RulePass(mod, findings, selected).visit(mod.tree)
    emit_contract_findings(modules, findings, selected)
    by_path = {mod.path: mod for mod in modules}
    for f in findings:
        rules_off = by_path[f.path].suppressions.get(f.line, set())
        if "all" in rules_off or f.rule in rules_off:
            f.suppressed = True
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return LintReport(
        findings=findings,
        files_scanned=len(modules),
        stale_suppressions=_stale_suppressions(modules, findings, selected),
    )


def _stale_suppressions(
    modules: List[ModuleInfo], findings: List[Finding], selected: Set[str]
) -> List[StaleSuppression]:
    """Suppression comments that no longer suppress any finding.

    A rule id is only judged when it was part of this run (``R4`` can't
    be called stale by a run that never evaluated R4); ``disable=all``
    is only judged on a full-rule-set run.  Unknown rule ids are always
    stale — they never suppressed anything.
    """
    present: Dict[Tuple[str, int], Set[str]] = {}
    for f in findings:
        present.setdefault((f.path, f.line), set()).add(f.rule)
    full_run = selected >= set(RULES)
    stale: List[StaleSuppression] = []
    for mod in modules:
        for line, ids in sorted(mod.suppressions.items()):
            hit = present.get((mod.path, line), set())
            for rid in sorted(ids):
                if rid == "all":
                    if full_run and not hit:
                        stale.append(StaleSuppression(mod.path, line, rid))
                elif rid not in RULES or (rid in selected and rid not in hit):
                    stale.append(StaleSuppression(mod.path, line, rid))
    return stale
