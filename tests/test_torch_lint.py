"""The port's bdlz-lint (``bdlz_tpu_torch/lint``) against the JAX package's.

Both directions, as ``tests/test_lint.py`` pins them for ``bdlz_tpu/``:

* the port itself stays at ZERO unsuppressed findings and zero stale
  suppressions, every suppression carries its reason on or next to its
  line, and none is ``disable=all``;
* the analyzer catches each class: ``tests/fixtures/lint_torch/`` seeds
  one violation per torch rule (R2, R3, R4, R5, R7, R13), and the
  contract rules R8–R11 give JAX's findings, rule for rule and line for
  line, over JAX's own ``contractpkg`` fixture.

And the contract the rules read holds across the packages: the port's
``validate()`` accepts and rejects what JAX's does for every field and a
list of bad values, and ``config_identity_dict`` gives the same payload.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from bdlz_tpu import config as jc
from bdlz_tpu.lint import lint_paths as j_lint_paths

from bdlz_tpu_torch import config as tc
from bdlz_tpu_torch.lint import RULES, lint_paths, lint_source

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO_ROOT / "bdlz_tpu_torch"
FIXTURE = REPO_ROOT / "tests" / "fixtures" / "lint_torch" / "physics" / "seeded_violations.py"
CONTRACT_FIXTURE = REPO_ROOT / "tests" / "fixtures" / "lint" / "contractpkg"

TORCH_RULES = {"R2", "R3", "R4", "R5", "R7", "R13"}
CONTRACT_RULES = {"R8", "R9", "R10", "R11"}
NOT_IN_PORT = {"R1", "R6", "R12"}


def _run_cli(*argv: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "bdlz_tpu_torch.lint", *argv],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
    )


# ---- the port itself -------------------------------------------------------

def test_port_has_zero_unsuppressed_findings_and_every_suppression_says_why():
    report = lint_paths([str(PACKAGE)])
    assert report.files_scanned > 90
    offenders = "\n".join(f.render() for f in report.active)
    assert not report.active, f"unsuppressed findings:\n{offenders}"
    stale = "\n".join(s.render() for s in report.stale_suppressions)
    assert not report.stale_suppressions, f"stale suppressions:\n{stale}"
    assert report.suppressed  # the layer-boundary syncs are suppressed, not unseen
    for f in report.suppressed:
        lines = pathlib.Path(f.path).read_text().splitlines()
        here, above = lines[f.line - 1], lines[f.line - 2].strip()
        assert "disable=all" not in here, f"{f.path}:{f.line}"
        tail = here.split("bdlz-lint: disable=", 1)[1].lstrip("R0123456789, ")
        assert tail.startswith("—") or above.startswith("#"), (
            f"{f.path}:{f.line}: a suppression without its reason")


@pytest.mark.parametrize("target, rc", [("bdlz_tpu_torch", 0), (str(FIXTURE), 1)],
                         ids=["port", "fixture"])
def test_cli_exit_status_and_json_report(target, rc):
    proc = _run_cli(target, "--format", "json", "--cache", "off")
    assert proc.returncode == rc, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    if rc == 0:
        assert payload["n_findings"] == 0 and payload["n_stale_suppressions"] == 0
        return
    assert payload["n_findings"] == 6
    assert payload["counts_by_rule"] == dict.fromkeys(TORCH_RULES, 1)
    assert all({"path", "line", "col", "rule", "message", "hint", "suppressed"} <= set(f)
               for f in payload["findings"])


def test_rule_table_keeps_jax_s_ids_and_marks_the_jit_rules():
    from bdlz_tpu.lint import RULES as J_RULES

    assert set(RULES) == set(J_RULES) | {"R13"}
    for rid in NOT_IN_PORT:
        assert "does not apply to the port" in RULES[rid].title
    proc = _run_cli("--list-rules")
    assert proc.returncode == 0
    assert [line.split()[0] for line in proc.stdout.splitlines()
            if not line.startswith(" ")] == list(RULES)
    report = lint_paths([str(PACKAGE), str(FIXTURE), str(CONTRACT_FIXTURE)])
    assert not {f.rule for f in report.findings} & NOT_IN_PORT


# ---- each rule catches its class -------------------------------------------

def test_fixture_trips_each_torch_rule_once():
    report = lint_paths([str(FIXTURE)])
    assert sorted(f.rule for f in report.active) == sorted(TORCH_RULES)


@pytest.mark.parametrize("source", [
    "import torch\ndef f(x):\n    return torch.{}_like(x)\n".format(name)
    for name in ("zeros", "ones", "empty", "rand", "randn")
] + [
    "import torch\ndef f(x):\n    return torch.full_like(x, 2.0) + x.new_zeros(3)\n",
    "import torch\nF64 = torch.float64\ndef f(n):\n    return torch.arange(n, dtype=F64)\n",
    "import torch\ndef f(n, **kw):\n    return torch.zeros(n, **kw)\n",
])
def test_constructors_with_an_inherited_or_explicit_dtype_are_not_findings(source):
    assert not lint_source(source, path="ops/ctor.py").findings


@pytest.mark.parametrize("source, rule", [
    ("import torch\ndef f(x):\n    y = torch.exp(x)\n    return float(y.sum())\n", "R3"),
    ("import torch\ndef f(x):\n    torch.cuda.synchronize()\n    return x\n", "R3"),
    ("import torch\ndef f(x):\n    return x.cpu()\n", "R3"),
    ("import torch\ndef f(x):\n    while torch.any(x > 0):\n        x = x - 1\n    return x\n",
     "R2"),
    ("import torch\ndef f(x):\n    assert torch.isfinite(x).all()\n    return x\n", "R2"),
    ("import torch\ntorch.backends.cuda.matmul.allow_tf32 = True\n", "R5"),
    ("import torch as th\nx = th.linspace(0, 1, 5)\n", "R13"),
    ("from torch import ones\nx = ones(5)\n", "R13"),
])
def test_each_torch_rule_in_its_other_spellings(source, rule):
    report = lint_source(source, path="solvers/seeded.py")
    assert [f.rule for f in report.active] == [rule], report.active


@pytest.mark.parametrize("source", [
    # shapes, devices and host NumPy are host control flow
    "import torch\ndef f(xs):\n    while xs.shape[0] > 1:\n        xs = xs[::2]\n    return xs\n",
    "import numpy as np\ndef f(a):\n    a = np.asarray(a)\n"
    "    if np.all(np.isfinite(a)) and a.any():\n        return a.tolist()\n    return a\n",
    "import torch\ndef f(x):\n    if torch.cuda.is_available() and torch.is_tensor(x):\n"
    "        return x\n    return None\n",
])
def test_host_values_in_hot_paths_are_not_findings(source):
    assert not lint_source(source, path="lz/host.py").findings


def test_syncs_outside_the_hot_path_directories_are_not_findings():
    source = "import torch\ndef f(x):\n    if x.any():\n        return x.cpu().numpy()\n"
    assert not lint_source(source, path="serve/batcher.py").findings
    assert {f.rule for f in lint_source(source, path="ops/batcher.py").findings} == {"R2", "R3"}


# ---- the ten cases of tests/test_lint.py, through the port -----------------

def test_per_line_suppression_syntax():
    source = FIXTURE.read_text()
    suppressed = source.replace("z = x.sum().item()",
                                "z = x.sum().item()  # bdlz-lint: disable=R3")
    report = lint_source(suppressed, path="physics/seeded_variant.py")
    assert {f.rule for f in report.active} == TORCH_RULES - {"R3"}
    assert [f.rule for f in report.suppressed] == ["R3"]
    all_off = "\n".join(line + "  # bdlz-lint: disable=all" for line in source.splitlines())
    report = lint_source(all_off, path="physics/seeded_variant.py")
    assert not report.active
    assert len(report.suppressed) == 6


def test_rule_subset_selection():
    proc = _run_cli(str(FIXTURE), "--rules", "R5", "--format", "json", "--cache", "off")
    assert proc.returncode == 1
    assert set(json.loads(proc.stdout)["counts_by_rule"]) == {"R5"}
    assert _run_cli(str(FIXTURE), "--rules", "R99").returncode == 2


def test_stale_suppression_detected_and_fails_cli(tmp_path):
    clean = "def f():\n    return 1  # bdlz-lint: disable=R13\n"
    report = lint_source(clean, path="ops/clean.py")
    assert not report.active
    assert [(s.rule, s.line) for s in report.stale_suppressions] == [("R13", 2)]
    mod = tmp_path / "clean.py"
    mod.write_text(clean)
    proc = _run_cli(str(mod), "--cache", "off")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "stale suppression" in proc.stdout


def test_live_suppression_is_not_stale_and_unknown_ids_always_are():
    source = FIXTURE.read_text().replace(
        "w = torch.zeros(3)", "w = torch.zeros(3)  # bdlz-lint: disable=R13")
    assert not lint_source(source, path="physics/seeded_variant.py").stale_suppressions
    report = lint_source("x = 1  # bdlz-lint: disable=R99\n", path="ops/clean.py")
    assert [s.rule for s in report.stale_suppressions] == ["R99"]
    # a jit rule never fires in the port, so a suppression of it is stale
    report = lint_source("x = 1  # bdlz-lint: disable=R1\n", path="ops/clean.py")
    assert [s.rule for s in report.stale_suppressions] == ["R1"]


def test_rule_subset_does_not_misreport_other_rules_as_stale():
    source = FIXTURE.read_text().replace(
        "z = x.sum().item()", "z = x.sum().item()  # bdlz-lint: disable=R3")
    report = lint_source(source, path="physics/seeded_variant.py", rules=["R5"])
    assert not report.stale_suppressions


_CROSSFILE_CONFIG = textwrap.dedent(
    """
    from dataclasses import dataclass
    from typing import Optional

    REFERENCE_KEYS = ("x0",)
    {tuples}

    @dataclass
    class Config:
        x0: float = 1.0
        tri: Optional[bool] = None
        extra: int = 0


    def config_identity_dict(cfg):
        return {{k: v for k, v in vars(cfg).items() if k not in {consulted}}}
    """
)
_CROSSFILE_IDENTITY = textwrap.dedent(
    """
    def build_identity(cfg):
        hash_extra = {extra}
        return repr(sorted(hash_extra.items()))
    """
)


@pytest.mark.parametrize("tuples, consulted, extra, expect", [
    # the tri-state's one home is the hash_extra key of the SIBLING module
    ("", "REFERENCE_KEYS", '{"tri": cfg.tri}', []),
    # identity key removed: zero homes, the silent-resume drift class
    ("", "REFERENCE_KEYS", '{"unrelated": 1}', ["no identity home"]),
    # membership in TWO exclusion tuples: two subsystems claim the knob
    ('A_CONFIG_FIELDS = ("tri",)\nB_CONFIG_FIELDS = ("tri",)\n'
     "_EXCL = frozenset(A_CONFIG_FIELDS + B_CONFIG_FIELDS)",
     "_EXCL", '{"tri": cfg.tri}', ["two exclusion tuples"]),
    # the port's shape: one union consulted by name consults its members
    ('A_CONFIG_FIELDS = ("tri",)\nB_CONFIG_FIELDS = ("extra",)\n'
     "_EXCL = frozenset(A_CONFIG_FIELDS + B_CONFIG_FIELDS)",
     "_EXCL", '{"x": 1}', []),
    # ... and a tuple left out of the union keeps its payload home too
    ('A_CONFIG_FIELDS = ("tri",)\nB_CONFIG_FIELDS = ("extra",)\n'
     "_EXCL = tuple(A_CONFIG_FIELDS + A_CONFIG_FIELDS)",
     "_EXCL", '{"x": 1}', ["B_CONFIG_FIELDS is not consulted"]),
], ids=["one-home", "zero-homes", "two-tuples", "union", "union-misses-one"])
def test_cross_file_symbol_table_r8(tmp_path, tuples, consulted, extra, expect):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "config.py").write_text(_CROSSFILE_CONFIG.format(tuples=tuples, consulted=consulted))
    (pkg / "identity.py").write_text(_CROSSFILE_IDENTITY.format(extra=extra))
    found = [f.message for f in lint_paths([str(pkg)], rules=["R8"]).active]
    assert len(found) == len(expect) and all(e in m for e, m in zip(expect, found)), found


_VALIDATE = textwrap.dedent(
    """
    from dataclasses import dataclass


    @dataclass
    class Config:
        a: float = 1.0
        b: str = "x"
        c: float = 0.5
        d: float = 0.0


    VALIDATION_EXEMPT_FIELDS = ({exempt})


    def _fraction(cfg, name):
        if not 0.0 < getattr(cfg, name) <= 1.0:
            raise ValueError(name)


    def validate(cfg):
        for name, valid in (("b", ("x", "y")),):
            if getattr(cfg, name) not in valid:
                raise ValueError(name)
        _fraction(cfg, "c")
        if cfg.a < 0:
            raise ValueError("a")
        return cfg
    """
)


@pytest.mark.parametrize("exempt, expect", [
    ('"d",', []),
    ("", ["'d' has no validate() check"]),
    ('"d", "c"', ["lists 'c' but validate() checks it"]),
], ids=["partition", "unchecked", "stale-exemption"])
def test_validate_coverage_reads_the_port_s_shapes_r9(tmp_path, exempt, expect):
    (tmp_path / "config.py").write_text(_VALIDATE.format(exempt=exempt))
    found = [f.message for f in lint_paths([str(tmp_path)], rules=["R9"]).active]
    assert len(found) == len(expect) and all(e in m for e, m in zip(expect, found)), found


def test_sarif_output_schema_and_contents():
    proc = _run_cli(str(FIXTURE), str(CONTRACT_FIXTURE), "--format", "sarif", "--cache", "off")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    log = json.loads(proc.stdout)
    assert log["version"] == "2.1.0"
    (run,) = log["runs"]
    assert run["tool"]["driver"]["name"] == "bdlz-lint-torch"
    assert set(RULES) <= {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert {r["ruleId"] for r in run["results"]} == TORCH_RULES | CONTRACT_RULES
    for r in run["results"]:
        region = r["locations"][0]["physicalLocation"]["region"]
        assert region["startLine"] >= 1 and region["startColumn"] >= 1  # 1-based


def test_cache_roundtrip_hit_and_content_invalidation(tmp_path):
    from bdlz_tpu_torch.lint.cache import cached_lint_paths
    from bdlz_tpu_torch.provenance.store import Store

    src = tmp_path / "mod.py"
    src.write_text("import time\ntime.sleep(0.0)\n")
    store = Store(str(tmp_path / "store"))
    live, hit = cached_lint_paths([str(src)], store=store)
    assert not hit and [f.rule for f in live.active] == ["R7"]
    cached, hit = cached_lint_paths([str(src)], store=store)
    assert hit and cached.to_dict() == live.to_dict()
    src.write_text("import time\n")
    fresh, hit = cached_lint_paths([str(src)], store=store)
    assert not hit and not fresh.active
    proc = _run_cli(str(src), "--cache", "on", "--cache-root", str(tmp_path / "cli"))
    again = _run_cli(str(src), "--cache", "on", "--cache-root", str(tmp_path / "cli"))
    assert proc.returncode == again.returncode == 0
    assert "[cached]" not in proc.stdout and "[cached]" in again.stdout


def test_changed_only_restriction_is_reporting_not_analysis():
    report = lint_paths([str(FIXTURE), str(CONTRACT_FIXTURE)])
    view = report.restrict_to([str(CONTRACT_FIXTURE / "config.py")])
    assert {f.rule for f in view.active} == {"R8", "R9"}
    assert view.files_scanned == report.files_scanned
    assert {f.rule for f in report.active} == TORCH_RULES | CONTRACT_RULES
    proc = _run_cli("bdlz_tpu_torch", "--changed-only", "--cache", "off")
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---- parity with the JAX package -------------------------------------------

def _contract_findings(report):
    return sorted((f.rule, pathlib.Path(f.path).name, f.line) for f in report.active
                  if f.rule in CONTRACT_RULES)


def test_contract_rules_match_jax_s_on_the_contract_fixture():
    got = _contract_findings(lint_paths([str(CONTRACT_FIXTURE)]))
    ref = _contract_findings(j_lint_paths([str(CONTRACT_FIXTURE)]))
    assert got == ref and {r for r, _, _ in got} == CONTRACT_RULES


BAD_VALUES = (-1, 0, -0.5, float("nan"), float("inf"), 1e9, "bogus", None, True, [1.0])


def _outcome(mod, raw):
    try:
        mod.validate(mod.config_from_dict(raw))
    except Exception as exc:  # noqa: BLE001 — the rejection's type is the outcome
        return type(exc).__name__
    return None


@pytest.mark.parametrize("name", [f.name for f in dataclasses.fields(tc.Config)])
def test_validate_accepts_and_rejects_what_jax_s_does(name):
    for value in BAD_VALUES:
        raw = {"P_chi_to_B": 0.15, name: value}
        assert _outcome(tc, raw) == _outcome(jc, raw), (name, value)


@pytest.mark.parametrize("seed", range(8))
def test_config_identity_dict_is_jax_s(seed):
    rng = np.random.default_rng(seed)
    fields = dataclasses.fields(tc.Config)
    raw = {}
    for f in rng.choice(len(fields), size=8, replace=False):
        name, default = fields[f].name, fields[f].default
        if isinstance(default, bool) or default is None:
            raw[name] = bool(rng.integers(2))
        elif isinstance(default, (int, float)):
            raw[name] = type(default)(default + rng.integers(1, 4))
    got = tc.config_identity_dict(tc.config_from_dict(raw))
    ref = jc.config_identity_dict(jc.config_from_dict(raw))
    assert json.dumps(got, sort_keys=False) == json.dumps(ref, sort_keys=False)
