"""Structural guards of the port: it imports nothing of JAX or of the JAX
package, and it never carries on without a card unless asked to."""
import ast
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "bdlz_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "test_torch_kernels_gpu.py",
    REPO / "tests" / "test_torch_bloch_kernel_gpu.py",
] + sorted((REPO / "scripts").glob("torch_*.py"))
EVIDENCE_TOOLS = ("accuracy_audit", "ny_convergence", "impl_shootout", "lz_scale_bench",
                  "weak_scaling")
FORBIDDEN = ("jax", "jaxlib", "bdlz_tpu")


@pytest.fixture(autouse=True)
def _disarm():
    """A CLI called with ``--sanitize`` or ``--debug-nans`` that raises
    (no card) leaves the port's sanitizer or NaN check armed in this
    process; later tests in the same worker must not inherit it."""
    yield
    from bdlz_tpu_torch import sanitize
    from bdlz_tpu_torch.utils.profiling import enable_nan_debugging

    sanitize.disable()
    enable_nan_debugging(False)


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


def _imported_modules(path):
    """Every module ``path`` imports from, with each name it takes from
    one, relative imports resolved."""
    package = list(path.relative_to(REPO).with_suffix("").parts[:-1])
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level else []
            module = ".".join(base + ([node.module] if node.module else []))
            yield from (f"{module}.{a.name}" for a in node.names)


@pytest.mark.parametrize(
    "path", sorted(p for layer in ("ops", "lz", "models")
                   for p in (REPO / "bdlz_tpu_torch" / layer).rglob("*.py")),
    ids=lambda p: str(p.relative_to(REPO)))
def test_the_layers_below_the_sweep_import_nothing_of_it(path):
    """Imports point one way: the kernels, the LZ layer and the models
    never reach up into ``parallel/``."""
    up = "bdlz_tpu_torch.parallel"
    bad = sorted(m for m in _imported_modules(path) if m == up or m.startswith(up + "."))
    assert not bad, f"{path} imports {bad}"


def test_the_sweep_loop_names_no_engine_s_step_class():
    """The chunk loop reaches every engine through the step interface
    (``ship``/``launch``), never by telling one engine's class apart."""
    assert "KernelStep" not in (REPO / "bdlz_tpu_torch" / "parallel" / "sweep.py").read_text()


@pytest.mark.parametrize("name", EVIDENCE_TOOLS)
def test_each_evidence_tool_without_a_card_exits_non_zero_naming_it(name):
    """Run as a user runs it, with no card visible and no ``--device cpu``."""
    assert REPO / "scripts" / f"torch_{name}.py" in PORT_FILES
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / f"torch_{name}.py")],
                          cwd=REPO, env=dict(_clean_env(), CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""
    assert f"torch_{name}: no CUDA device is available" in proc.stderr
    assert "--device cpu" in proc.stderr


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
    from bdlz_tpu_torch.config import config_from_dict
    from bdlz_tpu_torch.interop import point_params_from_numpy
    from bdlz_tpu_torch.ops import kjma_kernel as kk
    from bdlz_tpu_torch.ops.kjma_table import make_f_table, table_to_device
    from bdlz_tpu_torch.parallel.sweep import build_grid

    base = config_from_dict({"P_chi_to_B": 0.15})
    table = table_to_device(make_f_table(base.I_p, n=256), "cpu")
    pp = point_params_from_numpy(build_grid(base, {"m_chi_GeV": [0.95, 300.0]}), "cpu")
    s = kk.point_scalars(pp, "fermion", table, 2000)
    kk.reset_launches()
    for name in kk.LAUNCHES:  # each wrapper runs its plain version on the CPU
        assert torch.equal(getattr(kk, name)(s, table, 2000),
                           getattr(kk, name + "_plain")(s, table, 2000))
    # a stream wrapper's rows sum to its reduce wrapper's sums, bit for bit
    assert torch.equal(kk.point_stream(s, table, 2000).sum(-1), kk.point_reduce(s, table, 2000))
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


SEAM_BOX = {"m_chi_GeV": (20.0, 600.0, 3, "log"), "T_p_GeV": (95.0, 105.0, 2, "log")}


def _seam_call(name, device):
    from bdlz_tpu_torch.config import config_from_dict
    from bdlz_tpu_torch.emulator import AxisSpec, multidomain

    base = config_from_dict({"P_chi_to_B": 0.15, "source_shape_sigma_y": 1.5})
    spec = {k: AxisSpec(*v) for k, v in SEAM_BOX.items()}
    kw = {} if device is None else {"device": device}
    if name == "seam_band_for_box":
        return multidomain.seam_band_for_box(base, spec, rtol=1e-3, n_scan=65, **kw)
    if name == "resolve_seam_split":
        return multidomain.resolve_seam_split(base, spec, None, rtol=1e-3, safety=2.0, **kw)
    return multidomain.build_seam_split_emulator(
        base, spec, rtol=1e-3, n_probe=2, n_holdout=2, max_rounds=1, n_y=2000,
        chunk_size=16, **kw)


@pytest.mark.parametrize("name", ["seam_band_for_box", "resolve_seam_split",
                                  "build_seam_split_emulator"])
def test_the_seam_scan_without_a_card_raises_unless_asked_for_the_cpu(monkeypatch, name):
    """C4: the seam scan used to default to the CPU while the build ran
    on the card; every seam entry point now resolves its device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _seam_call(name, None)
    if name != "build_seam_split_emulator":  # the build itself is tested elsewhere
        assert _seam_call(name, "cpu") is not None


def test_make_panel_scheme_takes_its_device_explicitly():
    from bdlz_tpu_torch.solvers.panels import make_panel_scheme

    with pytest.raises(TypeError):
        make_panel_scheme()
    assert make_panel_scheme("cpu").nodes.device.type == "cpu"


def _tiny_artifact():
    from bdlz_tpu_torch.emulator import EmulatorArtifact

    nodes = (np.array([0.9, 1.1]), np.array([90.0, 110.0]))
    return EmulatorArtifact(
        axis_names=("m_chi_GeV", "T_p_GeV"), axis_nodes=nodes, axis_scales=("log", "log"),
        values={"DM_over_B": np.full((2, 2), 5.0)}, identity={}, manifest={})


@pytest.mark.parametrize("entry", ["YieldService", "FleetService", "ReplicaSet",
                                   "ArtifactRollout.stage"])
def test_serving_entry_points_without_a_card_raise(monkeypatch, entry):
    from bdlz_tpu_torch import serve
    from bdlz_tpu_torch.config import config_from_dict

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = config_from_dict({"P_chi_to_B": 0.15})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "YieldService":
            serve.YieldService(_tiny_artifact(), base)
        elif entry == "FleetService":
            serve.FleetService(_tiny_artifact(), base)
        elif entry == "ReplicaSet":
            serve.ReplicaSet(_tiny_artifact())
        else:
            # a rollout stages on its service's devices: the card's
            svc = SimpleNamespace(
                expected_identity={}, stats=None,
                replica_set=SimpleNamespace(
                    field="DM_over_B", n_replicas=1, max_batch_size=4,
                    routing="least_loaded", error_gate=True, _faults=None,
                    replicas=[SimpleNamespace(device=torch.device("cuda", 0))]))
            serve.ArtifactRollout(svc).stage(_tiny_artifact())


@pytest.mark.parametrize("cli", ["serve", "sweep_cli", "mcmc_cli"])
def test_clis_without_a_card_raise_unless_asked_for_the_cpu(monkeypatch, tmp_path, cli):
    import json

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"P_chi_to_B": 0.15}))
    if cli == "serve":
        from bdlz_tpu_torch.serve.serve_cli import main

        argv = ["--config", str(cfg), "--artifact", str(tmp_path), "--bench", "4"]
    elif cli == "sweep_cli":
        from bdlz_tpu_torch.sweep_cli import main

        argv = ["--config", str(cfg), "--axis", "m_chi_GeV=1", "--sanitize"]
    else:
        from bdlz_tpu_torch.mcmc_cli import main

        argv = ["--config", str(cfg), "--param", "m_chi_GeV=0.5:2", "--walkers", "4",
                "--steps", "2", "--burn", "0", "--sanitize"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def _d7b_call(entry, device, tmp_path):
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config

    base = config_from_dict({"P_chi_to_B": 0.15})
    static = static_choices_from_config(base)
    axes = {"m_chi_GeV": [1.0, 2.0]}
    dev = {} if device is None else {"device": device}
    devs = {} if device is None else {"devices": [device]}
    if entry == "plan_elastic_sweep":
        from bdlz_tpu_torch.parallel import plan_elastic_sweep

        return plan_elastic_sweep(base, axes, static, n_y=2000, **dev)
    if entry == "run_sweep_elastic":
        from bdlz_tpu_torch.parallel import run_sweep_elastic

        return run_sweep_elastic(base, axes, static, n_y=2000, store=str(tmp_path / "s"),
                                 **dev)
    if entry == "run_worker_loop":
        from bdlz_tpu_torch.parallel import run_worker_loop

        return run_worker_loop(base, axes, static, n_y=2000, store=str(tmp_path / "w"),
                               worker_id="w", **dev)
    if entry == "MultiTenantService":
        from bdlz_tpu_torch.serve import MultiTenantService

        return MultiTenantService(base, tenant_map={"a": "0123456789abcdef"},
                                  store=str(tmp_path / "t"), **devs)
    if entry == "FabricHost":
        from bdlz_tpu_torch.serve import FabricHost

        return FabricHost(base, fabric="f", host_id="h", host_index=0,
                          store=str(tmp_path / "f"), **devs)
    if entry == "traffic_miss_score":
        from bdlz_tpu_torch.refine import traffic_miss_score

        return traffic_miss_score(_tiny_artifact(), [[1.0, 100.0]], 1e-3, **dev)
    from bdlz_tpu_torch.sweep_cli import main

    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"P_chi_to_B": 0.15}')
    return main(["--config", str(cfg), "--axis", "m_chi_GeV=1,2", "--n-y", "2000",
                 "--elastic", "local", "--elastic-store", str(tmp_path / "c"),
                 *(["--device", device] if device else [])])


@pytest.mark.parametrize("entry", ["plan_elastic_sweep", "run_sweep_elastic",
                                   "run_worker_loop", "MultiTenantService", "FabricHost",
                                   "traffic_miss_score", "sweep_cli --elastic"])
def test_the_d7b_entry_points_without_a_card_raise_unless_asked_for_the_cpu(
        monkeypatch, tmp_path, capsys, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _d7b_call(entry, None, tmp_path)
    got = _d7b_call(entry, "cpu", tmp_path)
    if hasattr(got, "close"):
        got.close()


@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_jax_role_and_a_port_role_refuse_each_other_s_job(tmp_path, first):
    """The port's job record carries its platform: a fleet that mixes the
    packages would commit under different chunk keys and never fold, so
    whichever role comes second is refused at the job record."""
    import bdlz_tpu.parallel.scheduler as jsch
    import bdlz_tpu_torch.parallel.scheduler as tsch
    from bdlz_tpu.config import config_from_dict as jcfg
    from bdlz_tpu.config import static_choices_from_config as jstatic
    from bdlz_tpu.provenance import Store as JStore
    from bdlz_tpu_torch.config import config_from_dict as tcfg
    from bdlz_tpu_torch.config import static_choices_from_config as tstatic
    from bdlz_tpu_torch.provenance import Store as TStore

    cfg = {"P_chi_to_B": 0.15}
    axes = {"m_chi_GeV": [1.0, 2.0]}
    jplan = jsch.plan_elastic_sweep(jcfg(cfg), axes, jstatic(jcfg(cfg)), n_y=2000)
    tplan = tsch.plan_elastic_sweep(tcfg(cfg), axes, tstatic(tcfg(cfg)), n_y=2000,
                                    device="cpu")
    assert jplan.job == tplan.job  # one namespace: only the record tells them apart
    root = str(tmp_path / "store")
    roles = [(jsch, JStore, jplan), (tsch, TStore, tplan)]
    if first == "port":
        roles.reverse()
    (mod1, store1, plan1), (mod2, store2, plan2) = roles
    mod1.ensure_job_record(store1(root), plan1)
    with pytest.raises(mod2.ElasticError, match="does not match"):
        mod2.ensure_job_record(store2(root), plan2)


def _graft_call(entry, device):
    from bdlz_tpu_torch import graft_entry

    if entry == "entry":
        fn, args = graft_entry.entry(**({} if device is None else {"device": device}))
        return fn(*args)
    if entry == "dryrun_multichip":
        return graft_entry.dryrun_multichip(1, **({} if device is None else {"devices": device}))
    proc = subprocess.run([sys.executable, "-m", "bdlz_tpu_torch.graft_entry", "1"],
                          cwd=REPO, env=dict(_clean_env(), CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0 and "no CUDA device" in proc.stderr:
        raise RuntimeError(proc.stderr.strip().splitlines()[-1])
    return proc


@pytest.mark.parametrize("entry", ["entry", "dryrun_multichip", "python -m"])
def test_the_graft_entry_points_without_a_card_raise_unless_asked_for_the_cpu(
        monkeypatch, capsys, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _graft_call(entry, None)
    if entry != "python -m":  # the module's own run takes the cards only
        assert _graft_call(entry, "cpu") is not None


def _measurement_call(name, device):
    from bdlz_tpu_torch.config import (
        config_from_dict,
        point_params_from_config,
        static_choices_from_config,
    )
    from bdlz_tpu_torch.ops.kjma_table import make_f_table
    from bdlz_tpu_torch.parallel.sweep import build_grid, make_chunk_runner
    from bdlz_tpu_torch.solvers.quadrature import integrand_stream_probe

    base = config_from_dict({"P_chi_to_B": 0.15})
    static = static_choices_from_config(base)._replace(quad_panel_gl=False)
    table = make_f_table(base.I_p, n=4096)
    if name == "make_chunk_runner":
        run, chunk = make_chunk_runner(build_grid(base, {"m_chi_GeV": [0.5, 1.0]}), 2,
                                       static, table, impl="kernel", n_y=2000, device=device)
        return run(0, chunk)
    return integrand_stream_probe(point_params_from_config(base, base.P_chi_to_B), static,
                                  table, n_y=2000, device=device)


@pytest.mark.parametrize("name", ["make_chunk_runner", "integrand_stream_probe"])
def test_the_measurement_entry_points_without_a_card_raise_unless_asked_for_the_cpu(
        monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _measurement_call(name, None)
    assert _measurement_call(name, "cpu") is not None
