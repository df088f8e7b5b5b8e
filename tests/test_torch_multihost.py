"""The port's process-group layer (``bdlz_tpu_torch/parallel/multihost.py``)
against the JAX package's, on the CPU.

* In one process every helper is the identity, as JAX's is: the same
  bounds, the same arrays, the same strings, no process group.
* Two real processes on the ``gloo`` backend (``_mp_torch_mesh_worker.py``,
  which imports torch only), each case mirroring one of JAX's two-process
  tests: the mesh sweep with a resume pass, fault healing, the
  checkpointed chain, the divergent kernel digest, the chunk cache, and
  the rollout's cutover agreement.  Both processes must end with the same
  answer, and the sweeps with JAX's single-process answer on the same
  grid (≤1e-12 rel, the tolerance of JAX's own test) and the port's own
  one-process answer bit for bit.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from bdlz_tpu.parallel import batch_sharding as j_batch_sharding
from bdlz_tpu.parallel import make_mesh as j_make_mesh
from bdlz_tpu.parallel import multihost as jm
from bdlz_tpu.parallel import shard_global_chunk as j_shard_global_chunk

from bdlz_tpu_torch.parallel import batch_sharding, make_mesh
from bdlz_tpu_torch.parallel import multihost as tm

WORKER = os.path.join(os.path.dirname(__file__), "_mp_torch_mesh_worker.py")
ENV_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
            "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
BASE = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
AXES = {"m_chi_GeV": np.geomspace(0.3, 3.0, 8).tolist()}
RTOL = 1e-12


@pytest.fixture
def no_group_env(monkeypatch):
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)


# ---- one process: every helper is the identity ---------------------------

def test_init_multihost_single_process_noop(no_group_env):
    assert tm.init_multihost() is False and jm.init_multihost() is False
    assert (tm.process_count(), tm.process_index()) == (1, 0)
    assert tm.backend_names() == {"host": None, "device": None}


def test_init_multihost_names_what_is_missing(no_group_env, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="process_id not configured"):
        tm.init_multihost()
    assert tm.process_count() == 1


def test_process_local_bounds_single_process():
    for n in (16, 17):
        assert tm.process_local_bounds(n) == jm.process_local_bounds(n) == (0, n)


def test_gather_to_host_single_process_roundtrip():
    mesh = make_mesh(devices=["cpu"] * 8)
    chunk = {"a": np.arange(16, dtype=np.float64)}
    pieces = tm.shard_global_chunk(chunk, batch_sharding(mesh))
    back = tm.gather_to_host({"a": torch.cat([p["a"] for p in pieces])})
    np.testing.assert_array_equal(back["a"], chunk["a"])
    assert isinstance(back["a"], np.ndarray)


def test_broadcast_from_coordinator_single_process_identity():
    assert tm.is_coordinator() is True and jm.is_coordinator() is True
    plan = np.array([[1, 3], [0, 0]], dtype=np.int64)
    got = tm.broadcast_from_coordinator(plan)
    np.testing.assert_array_equal(got, plan)
    np.testing.assert_array_equal(got, jm.broadcast_from_coordinator(plan))
    knobs = np.array([5, -5, 1, -1], dtype=np.int64)
    np.testing.assert_array_equal(tm.allreduce_min(knobs), jm.allreduce_min(knobs))
    t = torch.arange(3, dtype=torch.float64)
    assert tm.allreduce_min(t) is t and tm.broadcast_from_coordinator(t) is t
    assert tm.allreduce_sum(t) is t


def test_broadcast_text_single_process_identity():
    h = "0123456789abcdef"
    assert tm.broadcast_text(h) == jm.broadcast_text(h) == h
    with pytest.raises(ValueError) as got:
        tm.broadcast_text("x" * 65)
    with pytest.raises(ValueError) as ref:
        jm.broadcast_text("x" * 65)
    assert str(got.value) == str(ref.value)


def test_shard_global_chunk_places_jax_rows():
    """The batch plan holds JAX's rows: member k of the (4, 2) mesh gets
    the slice device k of JAX's mesh gets, and the pieces are the chunk
    bit for bit."""
    j_mesh = j_make_mesh(shape=(4, 2))
    mesh = make_mesh((4, 2), devices=["cpu"] * 8)
    chunk = {"a": np.arange(16, dtype=np.float64), "b": np.ones(16)}
    placed = j_shard_global_chunk(chunk, j_batch_sharding(j_mesh))
    by_device = {s.device: s.index[0] for s in placed["a"].addressable_shards}
    j_rows = [(by_device[d].start, by_device[d].stop) for d in j_mesh.devices.reshape(-1)]
    assert batch_sharding(mesh).bounds(16) == j_rows
    pieces = tm.shard_global_chunk(chunk, batch_sharding(mesh))
    assert [tuple(p["a"].shape) for p in pieces] == [(2,)] * 8
    np.testing.assert_array_equal(torch.cat([p["a"] for p in pieces]).numpy(), chunk["a"])


# ---- two real processes on gloo -------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_pair(mode, tmp_path):
    """Both processes of one worker case; their stdouts (a hang is a
    failure at the timeout)."""
    env = dict(os.environ)
    for var in ENV_VARS + ("BDLZ_FAULT_PLAN", "BDLZ_CACHE_ROOT"):
        env.pop(var, None)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, WORKER, mode, port, str(pid), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {pid} failed (rc={rc}):\n{out}\n{err}"
        assert f"worker {pid} OK" in out
    return [out for _, out, _ in outs]


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's single-process answer on the workers' grid (its own test's
    reference run: the mesh of every host device, chunk 4, n_y 2000)."""
    from bdlz_tpu.config import config_from_dict, static_choices_from_config
    from bdlz_tpu.parallel import run_sweep

    cfg = config_from_dict(dict(BASE))
    static = static_choices_from_config(cfg)
    return {
        quad: run_sweep(cfg, AXES, static if quad is None else static._replace(quad_panel_gl=quad),
                        mesh=j_make_mesh(), chunk_size=4, n_y=2000).outputs["DM_over_B"]
        for quad in (None, False)
    }


def _port_one_process(quad=None):
    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.parallel import run_sweep

    cfg = config_from_dict(dict(BASE))
    static = static_choices_from_config(cfg)
    if quad is not None:
        static = static._replace(quad_panel_gl=quad)
    return run_sweep(cfg, AXES, static, chunk_size=4, n_y=2000, device="cpu").outputs


def _rel(got, ref):
    return float(np.max(np.abs(got - ref) / np.abs(ref)))


def test_two_process_sweep(tmp_path, jax_reference):
    _run_pair("sweep", tmp_path)
    r0, r1 = np.load(tmp_path / "result_p0.npz"), np.load(tmp_path / "result_p1.npz")
    np.testing.assert_array_equal(r0["DM_over_B"], r1["DM_over_B"])
    np.testing.assert_array_equal(r0["DM_over_B"], _port_one_process()["DM_over_B"])
    rel = _rel(r0["DM_over_B"], jax_reference[None])
    print(f"RESIDUAL multihost sweep 2 processes vs JAX max_rel={rel:.3e}")
    assert rel <= RTOL
    # only the coordinator wrote the directory: the manifest and 2 chunks
    assert sorted(os.listdir(tmp_path / "sweep")) == [
        "chunk_00000.npz", "chunk_00001.npz", "manifest.json"]


def test_two_process_fault_healing(tmp_path, jax_reference):
    _run_pair("faults", tmp_path)
    r0, r1 = np.load(tmp_path / "faults_p0.npz"), np.load(tmp_path / "faults_p1.npz")
    for k in ("quarantined", "failed", "DM_over_B", "n_retries"):
        np.testing.assert_array_equal(r0[k], r1[k])
    expected = np.zeros(8, dtype=bool)
    expected[5] = True
    np.testing.assert_array_equal(r0["quarantined"], expected)
    keep = ~expected
    assert _rel(r0["DM_over_B"][keep], jax_reference[None][keep]) <= RTOL
    np.testing.assert_array_equal(r0["DM_over_B"][keep], _port_one_process()["DM_over_B"][keep])
    assert np.isnan(r0["DM_over_B"][5])


def test_two_process_mcmc(tmp_path):
    """The checkpointed chain over a mesh that spans both processes: both
    gather the same chain, bitwise the one-process chain without a mesh;
    only the coordinator wrote the segments and the manifest."""
    sys.path.insert(0, os.path.dirname(__file__))
    import _mp_torch_mesh_worker as w

    from bdlz_tpu_torch.sampling.checkpoint import run_ensemble_checkpointed

    _run_pair("mcmc", tmp_path)
    r0, r1 = np.load(tmp_path / "mcmc_p0.npz"), np.load(tmp_path / "mcmc_p1.npz")
    np.testing.assert_array_equal(r0["chain"], r1["chain"])
    np.testing.assert_array_equal(r0["logp"], r1["logp"])
    assert sorted(os.listdir(tmp_path / "chain")) == [
        "manifest.json", "seg_00000.npz", "seg_00001.npz", "seg_00002.npz"]
    one = run_ensemble_checkpointed(3, w.mcmc_logp(), w.mcmc_init(), 24,
                                    str(tmp_path / "one"), checkpoint_every=8,
                                    identity={"toy": "gaussian-v1"})
    np.testing.assert_array_equal(r0["chain"], one.chain)


def test_divergent_kernel_digest_raises_fleetwide(tmp_path):
    outs = _run_pair("knob", tmp_path)
    for pid, out in enumerate(outs):
        assert f"worker {pid} KNOB-MISMATCH-RAISED" in out


def test_two_process_chunk_cache(tmp_path, jax_reference):
    _run_pair("cache", tmp_path)
    r0, r1 = np.load(tmp_path / "result_p0.npz"), np.load(tmp_path / "result_p1.npz")
    np.testing.assert_array_equal(r0["DM_over_B"], r1["DM_over_B"])
    np.testing.assert_array_equal(r0["DM_over_B"], _port_one_process(False)["DM_over_B"])
    assert _rel(r0["DM_over_B"], jax_reference[False]) <= RTOL
    entries = sorted(os.listdir(tmp_path / "store" / "sweep_chunk"))
    assert len(entries) == 2 and all(e.endswith(".npz") for e in entries)


def test_two_process_rollout_agreement(tmp_path):
    """An equal hash passes on both; a differing hash and a cold stage
    raise on both, each process naming JAX's reason for its own side."""
    outs = [json.loads(out.strip().splitlines()[0]) for out in _run_pair("rollout", tmp_path)]
    refused = ("rollout refused: another process reported hash skew or a cold stage")
    assert outs[0] == {"equal": None, "skew": refused, "cold": refused}
    assert outs[1]["equal"] is None
    assert outs[1]["skew"] == (
        "rollout hash skew: this process staged 'bbbbbbbbbbbbbbbb' but the coordinator is "
        "activating 'aaaaaaaaaaaaaaaa' — every host must stage the same artifact build "
        "before cutover")
    from bdlz_tpu.serve.rollout import RolloutError as JRolloutError
    from bdlz_tpu.serve.rollout import _agree_cutover as j_agree

    with pytest.raises(JRolloutError) as cold:
        j_agree("a" * 16, False)
    assert outs[1]["cold"] == str(cold.value)
