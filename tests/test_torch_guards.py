"""Structural guards of the port: it imports nothing of JAX or of the JAX
package, and it never carries on without a card unless asked to."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "bdlz_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "test_torch_kernels_gpu.py",
]
FORBIDDEN = ("jax", "jaxlib", "bdlz_tpu")


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path} imports {bad}"


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, importlib, pkgutil, bdlz_tpu_torch\n"
        "for m in pkgutil.walk_packages(bdlz_tpu_torch.__path__, 'bdlz_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import bdlz_tpu_torch.sweep_cli\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'bdlz_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_clean_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_run_sweep_without_a_card_raises(monkeypatch):
    """Decided inside the test: with no CUDA device (forced here), the
    default device is refused instead of silently becoming the CPU."""
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.parallel.sweep import run_sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = config_from_dict({"P_chi_to_B": 0.15})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sweep(base, {"m_chi_GeV": [1.0]}, static_choices_from_config(base), n_y=2000)


def test_kernel_wrappers_on_the_cpu_launch_nothing():
    from bdlz_tpu_torch.ops import kjma_kernel as kk

    g = torch.ones(2, 8, dtype=torch.float64)
    i1 = torch.full((2, 8), 5, dtype=torch.int32)
    s = torch.full((2, 8), 0.25, dtype=torch.float64)
    v = torch.arange(32, dtype=torch.float64)
    kk.reset_launches()
    out = kk.interp_reduce(g, i1, s, v)
    # a cubic reproduces a linear table exactly: F(5.25) = 5.25 per node
    assert torch.allclose(out, torch.full((2,), 8 * 5.25, dtype=torch.float64),
                          rtol=1e-15, atol=0.0)
    assert kk.LAUNCHES == dict.fromkeys(kk.LAUNCHES, 0)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_without_the_repo(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card exit cannot be shown here")
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
