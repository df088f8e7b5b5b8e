"""Whole-program knob-contract analysis for the port's bdlz-lint (R8–R11).

Counterpart of ``bdlz_tpu/lint/contracts.py``, run over the port's
``config.py``, ``provenance/identity.py``, ``lz/options.py`` and ``*_cli.py``.
The per-file rules police *code*; these rules police the repo's
**configuration contract** — the conventions that keep the bit-identical
reproducibility guarantee true as the knob surface grows
(docs/static_analysis.md, docs/static_analysis_torch.md):

* **R8 — identity-home coverage.**  Every ``Config`` field joins result
  identity through *exactly one* home: the shared config payload
  (``config_identity_dict``'s omit-at-default loop), an explicit
  identity key (a string in ``provenance/identity.py``, a
  ``hash_extra``/``build_identity`` payload, or — for tri-state knobs —
  membership in the ``StaticChoices`` tuple that ``static_payload``
  hashes), or membership in exactly one ``*_CONFIG_FIELDS`` exclusion
  tuple that ``config_identity_dict`` actually consults.  The port's
  ``config_identity_dict`` consults one module-level union of the
  tuples (``_IDENTITY_EXCLUDED = frozenset(A + B + ...)``); the table
  follows one such alias to its members.
* **R9 — validation coverage.**  Every field is either checked in
  ``validate()`` or listed (with a justification) in
  ``VALIDATION_EXEMPT_FIELDS`` — and never both.  Beside ``cfg.X`` reads
  and loops of ``getattr(cfg, k)`` over literal names, the port's
  ``validate()`` checks fields in two more shapes, both read here:
  tuple-target loops over literal tuples of tuples whose first element
  is the name (``for name, valid in (("sampler", ...), ...)``), and
  helper calls taking ``cfg`` and a literal name
  (``_fraction(cfg, "target_accept")``).
* **R10 — tri-state conformance.**  A possibly-``None`` bool knob
  must flow through a sanctioned resolver (a ``resolve*`` function) or
  an explicit ``is None`` / ``is True`` / ``is False`` comparison.
* **R11 — CLI parity.**  Every CLI flag's dest names its Config
  twin (directly, through :data:`CLI_TWIN_ALIASES`, or as a declared
  operational flag in :data:`CLI_OPERATIONAL_DESTS`), and every knob in
  the CLI-contract exclusion tuples (serve/scenario/sampler) is
  reachable from some flag.

When the linted file set contains no ``Config`` definition, the
contract rules are silent.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from bdlz_tpu_torch.lint.rules import Finding

#: Exclusion tuples (by name, in the Config module) whose members form
#: the CLI contract surface: each member must be reachable from a
#: CLI flag (R11's config→flag direction).  Reference-physics keys
#: deliberately are NOT here — they are set through the config JSON,
#: not flags.
CLI_CONTRACT_TUPLES = (
    "SERVE_CONFIG_FIELDS",
    "SCENARIO_CONFIG_FIELDS",
    "SAMPLER_CONFIG_FIELDS",
)

#: Flag dests whose spelling differs from their Config twin — the
#: declared aliases (flag → field).  Keep this list SHORT: new flags
#: should set ``dest`` to the field name so the twin is structural.
CLI_TWIN_ALIASES = {
    "replicas": "n_replicas",          # serve_cli: 0 = one per device
    "memory_budget": "memory_budget_bytes",
    "health": "health_enabled",        # auto/on/off -> tri-state
    "quad": "quad_panel_gl",           # auto/on/off -> tri-state
}

#: Flag dests that deliberately have NO Config twin: run-shape inputs
#: (paths, seeds, output selection), per-run identity inputs whose
#: single home is a hash_extra key (lz_profile / bounce / lz_method /
#: lz_gamma_phi — see parallel.sweep.engine_identity_extra), sampler
#: SPEC knobs homed in the MCMC checkpoint identity (nuts_warmup /
#: max_tree_depth), and host-orchestration knobs that never touch a
#: Config (elastic fleet shape, fleet routing policy).  An undeclared
#: dest with no twin is an R11 finding — this registry is the
#: suppress-with-justification surface.
CLI_OPERATIONAL_DESTS = frozenset({
    # io / run shape (every CLI)
    "config", "out", "events", "sanitize", "multihost", "seed",
    # single-point CLI (cli.py)
    "write_template", "template_extensions", "profile_csv",
    "diagnostics", "lz_momentum_average", "planck",
    # sweep CLI: grid/engine/run-shape knobs (axes + impl join the
    # sweep identity directly, not through Config)
    "axis", "chunk", "mesh_sp", "profile_dir", "debug_nans", "impl",
    "fuse_exp",
    # elastic fleet shape (parallel/scheduler.py — operational churn is
    # forbidden from joining any result identity, docs/robustness.md)
    "elastic", "elastic_store", "elastic_workers", "worker_id",
    "lease_ttl", "quarantine_after", "churn_plan", "poll",
    # MCMC CLI: chain shape + checkpointing (homed in the MCMC
    # segment identity, provenance.mcmc_segment_identity)
    "param", "walkers", "steps", "burn", "checkpoint_dir",
    "checkpoint_every", "lz_table_n", "nuts_warmup", "max_tree_depth",
    # serve CLI: service/batcher shape (constructor-level, identity-
    # excluded by the SERVE_CONFIG_FIELDS rule) + tenant-map payload;
    # host_id is cross-host attribution only (who answered, never what
    # was answered — forbidden from joining any result identity,
    # docs/serving.md "Cross-host fabric")
    "artifact", "requests", "bench", "field", "max_batch",
    "max_wait_ms", "deadline_ms", "routing", "tenant_map", "host_id",
    # LZ per-run identity inputs (lz/options.py): their single home is
    # the engine_identity_extra / build_identity hash_extra key
    "lz_profile", "lz_method", "lz_gamma_phi", "bounce",
    # bounce CLI (bounce_cli.py): solver resolution + archive shape
    "schema", "n_xi", "audit",
    # config override surface shared with the config key of the same
    # name is structural (dest == field) and needs no entry here
    # the port's one addition: where the CLI runs (cuda or cpu), on
    # every CLI — it chooses a device, never a result
    "device",
})

#: Function-name pattern of the sanctioned tri-state resolvers (R10):
#: inside these, truthiness on a knob is the resolution itself.
_RESOLVER_RE = re.compile(r"(^|_)resolve")

#: Identity-constructing function names beyond the ``provenance/
#: identity.py`` module itself (R8's identity-string surface).
_IDENTITY_FUNC_RE = re.compile(
    r"(_identity|identity_|^grid_hash$|^chunk_cache_key$|"
    r"^build_identity$|^artifact_hash$)"
)

#: Only identifier-shaped strings can be identity keys for field names.
_KEYISH_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")

_CONFIG_TUPLE_RE = re.compile(r"^[A-Z][A-Z0-9_]*_CONFIG_FIELDS$")
_STATIC_TUPLE_RE = re.compile(r"^[A-Z][A-Z0-9_]*_STATIC_FIELDS$")


@dataclass
class FieldInfo:
    name: str
    line: int
    col: int
    annotation: str
    default_is_none: bool

    @property
    def is_tristate_bool(self) -> bool:
        """The ``ode_*`` pattern: Optional-annotated bool, default None."""
        return self.default_is_none and "bool" in self.annotation and (
            "Optional" in self.annotation or "None" in self.annotation
        )


@dataclass
class FlagInfo:
    module: object  # ModuleInfo
    line: int
    col: int
    flag: str
    dest: str


@dataclass
class ContractTable:
    """The cross-file symbol table the contract rules run against."""

    config_mod: Optional[object] = None  # ModuleInfo defining Config
    fields: Dict[str, FieldInfo] = field(default_factory=dict)
    #: tuple name -> (line, member names) for ``*_CONFIG_FIELDS``
    exclusion_tuples: Dict[str, Tuple[int, Tuple[str, ...]]] = field(
        default_factory=dict
    )
    #: names membership-tested inside config_identity_dict (None when
    #: the function is absent from the linted set — check skipped)
    consulted: Optional[Set[str]] = None
    #: module-level unions of exclusion tuples: alias -> member tuple names
    unions: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    reference_keys: Set[str] = field(default_factory=set)
    static_fields: Set[str] = field(default_factory=set)
    static_excluded: Set[str] = field(default_factory=set)
    has_validate: bool = False
    validated: Set[str] = field(default_factory=set)
    exempt: Set[str] = field(default_factory=set)
    exempt_line: int = 0
    identity_strings: Set[str] = field(default_factory=set)
    cli_flags: List[FlagInfo] = field(default_factory=list)

    @property
    def tristate_names(self) -> Set[str]:
        return {f.name for f in self.fields.values() if f.is_tristate_bool}


def _tuple_of_strings(node: ast.AST) -> Optional[Tuple[str, ...]]:
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            if not (isinstance(elt, ast.Constant)
                    and isinstance(elt.value, str)):
                return None
            out.append(elt.value)
        return tuple(out)
    return None


def _union_of_names(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """``frozenset(A + B + C)`` (or ``set``/``tuple`` of it, or the bare
    sum) of ``*_CONFIG_FIELDS`` names -> ("A", "B", "C"); else None."""
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id in ("frozenset", "set", "tuple")
        and len(node.args) == 1
        and not node.keywords
    ):
        node = node.args[0]
    names = []
    while isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        if not isinstance(node.right, ast.Name):
            return None
        names.append(node.right.id)
        node = node.left
    if not isinstance(node, ast.Name):
        return None
    names.append(node.id)
    names.reverse()
    if len(names) < 2 or not all(_CONFIG_TUPLE_RE.match(n) for n in names):
        return None
    return tuple(names)


def _keyish_strings(node: ast.AST) -> Set[str]:
    """Identifier-shaped string constants under ``node``, docstrings
    excluded (a prose mention of a field name is not an identity key)."""
    out: Set[str] = set()
    skip: Set[int] = set()
    for sub in ast.walk(node):
        body = getattr(sub, "body", None)
        if (
            isinstance(sub, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef))
            and body
            and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)
        ):
            skip.add(id(body[0].value))
    for sub in ast.walk(node):
        if (
            isinstance(sub, ast.Constant)
            and isinstance(sub.value, str)
            and id(sub) not in skip
            and _KEYISH_RE.match(sub.value)
        ):
            out.add(sub.value)
    return out


def _collect_config_module(table: ContractTable, mod) -> None:
    """Fields, exclusion tuples, validate coverage from one module that
    defines ``class Config``."""
    table.config_mod = mod
    for node in mod.tree.body:
        # ---- tuples of strings at module level -------------------------
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and (
            isinstance(node.targets[0], ast.Name)
        ):
            name = node.targets[0].id
            members = _tuple_of_strings(node.value)
            if members is None:
                union = _union_of_names(node.value)
                if union:
                    table.unions[name] = union
                continue
            if _CONFIG_TUPLE_RE.match(name):
                table.exclusion_tuples[name] = (node.lineno, members)
            elif _STATIC_TUPLE_RE.match(name):
                table.static_excluded.update(members)
            elif name == "REFERENCE_KEYS":
                table.reference_keys.update(members)
            elif name == "VALIDATION_EXEMPT_FIELDS":
                table.exempt.update(members)
                table.exempt_line = node.lineno
        # ---- the dataclasses -------------------------------------------
        elif isinstance(node, ast.ClassDef) and node.name == "Config":
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    table.fields[stmt.target.id] = FieldInfo(
                        name=stmt.target.id,
                        line=stmt.lineno,
                        col=stmt.col_offset,
                        annotation=ast.unparse(stmt.annotation),
                        default_is_none=(
                            isinstance(stmt.value, ast.Constant)
                            and stmt.value.value is None
                        ),
                    )
        elif isinstance(node, ast.ClassDef) and node.name == "StaticChoices":
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    table.static_fields.add(stmt.target.id)
        # ---- the two contract functions --------------------------------
        elif isinstance(node, ast.FunctionDef):
            if node.name == "config_identity_dict":
                table.consulted = set()
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Compare) and any(
                        isinstance(op, (ast.In, ast.NotIn)) for op in sub.ops
                    ):
                        for cmp_ in sub.comparators:
                            if isinstance(cmp_, ast.Name):
                                table.consulted.add(cmp_.id)
            elif node.name == "validate":
                table.has_validate = True
                _collect_validate_coverage(table, node)
    # one level of alias: a union consulted by name consults its members
    if table.consulted is not None:
        for alias in table.consulted & set(table.unions):
            table.consulted.update(table.unions[alias])


def _collect_validate_coverage(table: ContractTable, fn: ast.FunctionDef) -> None:
    """Field names ``validate()`` actually touches: ``cfg.X`` attribute
    reads, literal tuples looped over with ``getattr(cfg, k)`` (a name
    target over names, or a tuple target over tuples whose first element
    is the name), and calls taking ``cfg`` and a literal name."""
    args = fn.args
    params = [a.arg for a in args.posonlyargs + args.args]
    cfg_name = params[0] if params else "cfg"
    for sub in ast.walk(fn):
        if (
            isinstance(sub, ast.Attribute)
            and isinstance(sub.value, ast.Name)
            and sub.value.id == cfg_name
        ):
            table.validated.add(sub.attr)
        elif isinstance(sub, ast.For):
            key, members = _loop_names(sub)
            if members and _calls_getattr(sub, cfg_name, key):
                table.validated.update(members)
        elif (
            isinstance(sub, ast.Call)
            and len(sub.args) >= 2
            and isinstance(sub.args[0], ast.Name)
            and sub.args[0].id == cfg_name
            and isinstance(sub.args[1], ast.Constant)
            and isinstance(sub.args[1].value, str)
        ):
            table.validated.add(sub.args[1].value)


def _loop_names(loop: ast.For) -> Tuple[Optional[str], Tuple[str, ...]]:
    """(loop variable holding the name, the literal names it takes) of
    ``for k in ("a", "b")`` or ``for k, v in (("a", x), ("b", y))``."""
    if isinstance(loop.target, ast.Name):
        return loop.target.id, _tuple_of_strings(loop.iter) or ()
    if (
        isinstance(loop.target, ast.Tuple)
        and loop.target.elts
        and isinstance(loop.target.elts[0], ast.Name)
        and isinstance(loop.iter, (ast.Tuple, ast.List))
    ):
        names = []
        for row in loop.iter.elts:
            head = row.elts[0] if isinstance(row, (ast.Tuple, ast.List)) and row.elts else None
            if not (isinstance(head, ast.Constant) and isinstance(head.value, str)):
                return None, ()
            names.append(head.value)
        return loop.target.elts[0].id, tuple(names)
    return None, ()


def _calls_getattr(loop: ast.For, cfg_name: str, key: Optional[str]) -> bool:
    return any(
        isinstance(c, ast.Call)
        and isinstance(c.func, ast.Name)
        and c.func.id == "getattr"
        and len(c.args) >= 2
        and isinstance(c.args[0], ast.Name)
        and c.args[0].id == cfg_name
        and isinstance(c.args[1], ast.Name)
        and c.args[1].id == key
        for body_stmt in loop.body
        for c in ast.walk(body_stmt)
    )


def _collect_identity_strings(table: ContractTable, mod) -> None:
    """R8's identity-key surface in one module: the whole identity
    module, identity-constructing functions anywhere, and dict payloads
    passed/assigned as ``extra``/``hash_extra``."""
    if mod.basename == "identity.py":
        table.identity_strings |= _keyish_strings(mod.tree)
        return
    for sub in ast.walk(mod.tree):
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
            _IDENTITY_FUNC_RE.search(sub.name)
        ):
            table.identity_strings |= _keyish_strings(sub)
        elif isinstance(sub, ast.Call):
            for kw in sub.keywords:
                if kw.arg in ("extra", "hash_extra"):
                    table.identity_strings |= _keyish_strings(kw.value)
        elif isinstance(sub, ast.Assign) and len(sub.targets) == 1 and (
            isinstance(sub.targets[0], ast.Name)
            and "extra" in sub.targets[0].id
        ):
            table.identity_strings |= _keyish_strings(sub.value)


def _collect_cli_flags(table: ContractTable, mod) -> None:
    if not (mod.basename.endswith("cli.py") or mod.basename == "options.py"):
        return
    for sub in ast.walk(mod.tree):
        if not (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "add_argument"
            and sub.args
            and isinstance(sub.args[0], ast.Constant)
            and isinstance(sub.args[0].value, str)
            and sub.args[0].value.startswith("--")
        ):
            continue
        flag = sub.args[0].value
        dest = None
        for kw in sub.keywords:
            if kw.arg == "dest" and isinstance(kw.value, ast.Constant):
                dest = str(kw.value.value)
        if dest is None:
            dest = flag.lstrip("-").replace("-", "_")
        table.cli_flags.append(
            FlagInfo(module=mod, line=sub.lineno, col=sub.col_offset,
                     flag=flag, dest=dest)
        )


def build_contract_table(modules) -> ContractTable:
    """One pass over the linted modules: find Config, then pool identity
    strings and CLI flags from every linted module."""
    table = ContractTable()
    config_mods = [
        m for m in modules
        if any(
            isinstance(n, ast.ClassDef) and n.name == "Config"
            and any(isinstance(s, ast.AnnAssign) for s in n.body)
            for n in m.tree.body
        )
    ]
    if not config_mods:
        return table
    # prefer the canonical basename when several modules define a Config
    config_mods.sort(key=lambda m: (m.basename != "config.py", m.path))
    _collect_config_module(table, config_mods[0])
    for mod in modules:
        _collect_identity_strings(table, mod)
        _collect_cli_flags(table, mod)
    return table


# ---------------------------------------------------------------------------
# rule emission
# ---------------------------------------------------------------------------


def _emit(findings: List[Finding], selected: Set[str], rule: str, mod,
          line: int, col: int, message: str) -> None:
    if rule in selected:
        findings.append(Finding(path=mod.path, line=line, col=col,
                                rule=rule, message=message))


def _emit_r8(table: ContractTable, findings: List[Finding],
             selected: Set[str]) -> None:
    mod = table.config_mod
    static_home = table.static_fields - table.static_excluded
    # dangling exclusion entries + unconsulted tuples, once per tuple
    for tname, (tline, members) in sorted(table.exclusion_tuples.items()):
        for m in members:
            if m not in table.fields:
                _emit(findings, selected, "R8", mod, tline, 0,
                      f"exclusion tuple {tname} names unknown Config "
                      f"field {m!r} (stale or typo — a misspelled "
                      "exclusion silently re-admits the real field)")
        if table.consulted is not None and tname not in table.consulted:
            _emit(findings, selected, "R8", mod, tline, 0,
                  f"exclusion tuple {tname} is not consulted by "
                  "config_identity_dict — its members keep the shared "
                  "payload home, so each has TWO homes")
    for fname, info in table.fields.items():
        owners = [t for t, (_l, members) in table.exclusion_tuples.items()
                  if fname in members]
        if len(owners) >= 2:
            _emit(findings, selected, "R8", mod, info.line, info.col,
                  f"Config field {fname!r} is in two exclusion tuples "
                  f"({', '.join(sorted(owners))}) — exactly one home "
                  "allowed")
        elif not owners and info.is_tristate_bool:
            # omit-at-default cannot carry a resolved tri-state: it
            # needs an explicit identity key or a StaticChoices berth
            if fname not in table.identity_strings and (
                fname not in static_home
            ):
                _emit(findings, selected, "R8", mod, info.line, info.col,
                      f"tri-state knob {fname!r} has no identity home: "
                      "the omit-at-default config payload cannot carry "
                      "its RESOLVED value, and it is neither an "
                      "identity key nor a StaticChoices field nor "
                      "excluded — the PR-7 quad_panel_gl silent-resume "
                      "drift class")


def _emit_r9(table: ContractTable, findings: List[Finding],
             selected: Set[str]) -> None:
    if not table.has_validate:
        return
    mod = table.config_mod
    for fname, info in table.fields.items():
        checked = fname in table.validated
        exempt = fname in table.exempt
        if not checked and not exempt:
            _emit(findings, selected, "R9", mod, info.line, info.col,
                  f"Config field {fname!r} has no validate() check and "
                  "no VALIDATION_EXEMPT_FIELDS entry")
        elif checked and exempt:
            _emit(findings, selected, "R9", mod, table.exempt_line, 0,
                  f"VALIDATION_EXEMPT_FIELDS lists {fname!r} but "
                  "validate() checks it — stale exemption")
    for fname in sorted(table.exempt - set(table.fields)):
        _emit(findings, selected, "R9", mod, table.exempt_line, 0,
              f"VALIDATION_EXEMPT_FIELDS names unknown Config field "
              f"{fname!r}")


class _TristateWalker(ast.NodeVisitor):
    """R10: direct truthiness tests on tri-state knob attributes."""

    def __init__(self, mod, tristate: Set[str], findings: List[Finding],
                 selected: Set[str]) -> None:
        self.mod = mod
        self.tristate = tristate
        self.findings = findings
        self.selected = selected
        self.fn_stack: List[str] = []

    def _in_resolver(self) -> bool:
        return any(_RESOLVER_RE.search(n) for n in self.fn_stack)

    def _visit_func(self, node) -> None:
        self.fn_stack.append(node.name)
        self.generic_visit(node)
        self.fn_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _check(self, test: ast.AST, kind: str) -> None:
        if self._in_resolver():
            return
        nodes = list(test.values) if isinstance(test, ast.BoolOp) else [test]
        for n in nodes:
            if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.Not):
                n = n.operand
            if isinstance(n, ast.Attribute) and n.attr in self.tristate:
                self.findings.append(Finding(
                    path=self.mod.path, line=n.lineno, col=n.col_offset,
                    rule="R10",
                    message=(
                        f"direct truthiness test on tri-state knob "
                        f"`.{n.attr}` in `{kind}` — None ('engine "
                        "decides') collapses to False here; use the "
                        "resolver seam or an explicit is None/True/False"
                    ),
                ))

    def visit_If(self, node: ast.If) -> None:
        self._check(node.test, "if")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check(node.test, "while")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._check(node.test, "assert")
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._check(node.test, "conditional expression")
        self.generic_visit(node)

    def visit_comprehension(self, node: ast.comprehension) -> None:
        for test in node.ifs:
            self._check(test, "comprehension filter")
        self.generic_visit(node)


def _emit_r10(table: ContractTable, modules, findings: List[Finding],
              selected: Set[str]) -> None:
    tristate = table.tristate_names
    if not tristate or "R10" not in selected:
        return
    for mod in modules:
        _TristateWalker(mod, tristate, findings, selected).visit(mod.tree)


def _emit_r11(table: ContractTable, findings: List[Finding],
              selected: Set[str]) -> None:
    if not table.cli_flags:
        return
    flagged: Set[str] = set()
    for fl in table.cli_flags:
        twin = None
        if fl.dest in table.fields:
            twin = fl.dest
        elif fl.dest in CLI_TWIN_ALIASES:
            twin = CLI_TWIN_ALIASES[fl.dest]
            if twin not in table.fields:
                _emit(findings, selected, "R11", fl.module, fl.line, fl.col,
                      f"flag {fl.flag} aliases unknown Config field "
                      f"{twin!r} (lint.contracts.CLI_TWIN_ALIASES is "
                      "stale)")
                twin = None
        if twin is not None:
            flagged.add(twin)
        elif fl.dest not in CLI_OPERATIONAL_DESTS:
            _emit(findings, selected, "R11", fl.module, fl.line, fl.col,
                  f"flag {fl.flag} (dest {fl.dest!r}) has no Config "
                  "twin: name the field via dest, add a "
                  "CLI_TWIN_ALIASES entry, or declare it operational "
                  "in lint.contracts.CLI_OPERATIONAL_DESTS")
    mod = table.config_mod
    for tname in CLI_CONTRACT_TUPLES:
        if tname not in table.exclusion_tuples:
            continue
        _tline, members = table.exclusion_tuples[tname]
        for fname in members:
            info = table.fields.get(fname)
            if info is not None and fname not in flagged:
                _emit(findings, selected, "R11", mod, info.line, info.col,
                      f"{tname} knob {fname!r} has no CLI flag — "
                      "operators cannot set it per-run (add a flag "
                      "with dest equal to the field name)")


def emit_contract_findings(modules, findings: List[Finding],
                           selected: Set[str]) -> None:
    """Run R8–R11 over the linted modules (no-op without a Config definition)."""
    if not selected & {"R8", "R9", "R10", "R11"}:
        return
    table = build_contract_table(modules)
    if table.config_mod is None:
        return
    _emit_r8(table, findings, selected)
    _emit_r9(table, findings, selected)
    _emit_r10(table, modules, findings, selected)
    _emit_r11(table, findings, selected)
