"""The benchmark measures the port alone: no file of it imports JAX or the
JAX package, its reference imports nothing of the port, and a dry run of
its code on the CPU loads neither.  Module names are compared whole, by
their top-level name: the port's ``bdlz_tpu_torch`` starts with
``bdlz_tpu``."""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import guard, spec

FILES = sorted(spec.BENCH_DIR.rglob("*.py"))


def test_whole_names_are_compared():
    assert guard.forbidden_loaded(["bdlz_tpu_torch", "bdlz_tpu_torch.ops", "jaxtyping"]) == []
    assert guard.forbidden_loaded(["bdlz_tpu.physics", "jax.numpy", "flax"]) == [
        "bdlz_tpu", "flax", "jax"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(spec.BENCH_DIR)))
def test_no_file_imports_jax_or_the_jax_package(path):
    found = guard.imports_of(path) & guard.FORBIDDEN
    assert not found, f"{path} imports {sorted(found)}"


@pytest.mark.parametrize("path", sorted((spec.BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert guard.PROGRAM not in guard.imports_of(path)


DRY_RUN = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.harness import guard, spec
from benchmark.tests.conftest import run_cell, shrink
cell = shrink(spec.load_cell("equal_mass.scan_kernel"), 3)
_, res = run_cell(cell, seconds=3.0, trace=True)
print(json.dumps({{"correct": res["correct"], "forbidden": guard.forbidden_loaded(),
                  "port": "bdlz_tpu_torch" in sys.modules}}))
"""


def test_a_dry_run_loads_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", DRY_RUN.format(root=str(spec.ROOT))],
                         capture_output=True, text=True, env=env, timeout=600, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "forbidden": [], "port": True}


def _run_py(cwd: pathlib.Path):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "equal_mass.scan_kernel", "--seed", "7", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=600)


def test_without_a_card_the_run_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: this checks the run on a host without one")
    out = _run_py(spec.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_the_run_fails_and_prints_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
