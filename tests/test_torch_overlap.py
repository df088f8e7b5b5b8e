"""The port's double-buffered chunk loop (``run_sweep(overlap_chunks=True)``)
on the CPU, against its own serial loop and against the JAX package's
default (overlapped) ``run_sweep``.

* Overlapped against serial, on one device and on meshes of ``(2, 1)`` and
  ``(1, 2)`` host members, under each fault kind at ``step`` and
  ``chunk_write``, with resume, a torn chunk file and a store: outputs,
  masks, counters, manifest, chunk files, fault-hook fire counts, retry
  sleeps and events apart from ``ts``/``seconds`` are bitwise equal.
* Overlapped against JAX's default run: outputs ≤1e-13 rel, events and
  counters equal; a directory written by either resumes in the other.
* ``impl="esdirk"`` runs serially and ``trace_dir`` keeps the
  double-buffered order (one trace of the sweep); a failure that
  surfaces at collection (an asynchronous device error) is healed there,
  with JAX's events; a ``FloatingPointError`` there aborts the sweep.
* The memory clamp's double-buffer term (22 float64 rows per point), with
  ``torch.cuda.mem_get_info`` and the device type stood in for.

64 points in 4 chunks of 16 at n_y 400 (floored to 2000 nodes), as in
``tests/test_torch_robustness.py``.  ``pytest -s`` prints ``RESIDUAL``
lines.
"""
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from bdlz_tpu import config as jc
from bdlz_tpu import faults as jf
from bdlz_tpu.parallel import sweep as js
from bdlz_tpu.utils import logging as jl
from bdlz_tpu.utils import retry as jr

from bdlz_tpu_torch import config as tc
from bdlz_tpu_torch import faults as tf
from bdlz_tpu_torch import provenance as tp
from bdlz_tpu_torch.parallel import make_mesh
from bdlz_tpu_torch.parallel import sweep as ts
from bdlz_tpu_torch.utils import logging as tl
from bdlz_tpu_torch.utils import retry as tr

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
AXES = {"m_chi_GeV": np.geomspace(0.3, 3.0, 8), "T_p_GeV": np.geomspace(50.0, 200.0, 8)}
KW = dict(chunk_size=16, n_y=400, impl="tabulated")
OUT_RTOL = 1e-13

PLANS = {
    "clean": None,
    "raise": [{"site": "step", "kind": "raise", "key": 2}],
    "transient": [{"site": "step", "kind": "transient", "key": 1, "times": 2}],
    "poison": [{"site": "step", "kind": "poison", "point": 37}],
    "nan": [{"site": "step", "kind": "nan", "point": 9}],
    "torn": [{"site": "chunk_write", "kind": "torn", "key": 2}],
    "mixed": [{"site": "step", "kind": "poison", "point": 50},
              {"site": "step", "kind": "transient", "key": 0, "times": 1},
              {"site": "step", "kind": "nan", "point": 3},
              {"site": "chunk_write", "kind": "torn", "key": 1}],
}
MESHES = {"one": None, "mesh2x1": (2, 1), "mesh1x2": (1, 2)}


def _static(pkg=tc):
    return pkg.static_choices_from_config(pkg.config_from_dict(ARCHIVED))._replace(
        quad_panel_gl=False)


def _events(stream):
    return [{k: v for k, v in json.loads(line).items() if k not in ("ts", "seconds")}
            for line in stream.getvalue().splitlines()]


def _dir_bytes(path):
    """Every file of a sweep directory: the manifest as JSON, the chunk
    files as their arrays (a torn file as its raw bytes)."""
    out = {}
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if name == "manifest.json":
            with open(full) as f:
                out[name] = json.load(f)
            continue
        try:
            with np.load(full) as data:
                out[name] = {k: data[k].tobytes() for k in sorted(data.files)}
        except Exception:  # noqa: BLE001 — a torn file compares by its bytes
            with open(full, "rb") as f:
                out[name] = f.read()
    return out


def _port(overlap, plan=None, mesh=None, out_dir=None, cache=None, **kw):
    """One port sweep with no-op sleeps: (result, events, sleeps, fire counts)."""
    sleeps, ev = [], io.StringIO()
    fp = None if plan is None else tf.FaultPlan.from_obj(plan)
    res = ts.run_sweep(
        tc.config_from_dict(ARCHIVED), AXES, _static(), **dict(KW, **kw),
        device=None if mesh is not None else "cpu", mesh=mesh, out_dir=out_dir,
        cache=cache, fault_plan=fp, retry=tr.RetryPolicy(max_attempts=3, sleep=sleeps.append),
        event_log=tl.EventLog(stream=ev), overlap_chunks=overlap)
    return res, _events(ev), sleeps, (None if fp is None else list(fp._fired))


def _assert_same_run(a, b):
    ra, rb = a[0], b[0]
    for f in ra.outputs:
        assert ra.outputs[f].tobytes() == rb.outputs[f].tobytes(), f
    assert ra.failed_mask.tobytes() == rb.failed_mask.tobytes()
    assert ra.quarantined_mask.tobytes() == rb.quarantined_mask.tobytes()
    assert (ra.n_failed, ra.n_quarantined, ra.n_retries, ra.resumed_chunks, ra.chunks,
            ra.cache_hits, ra.cache_misses) == (
        rb.n_failed, rb.n_quarantined, rb.n_retries, rb.resumed_chunks, rb.chunks,
        rb.cache_hits, rb.cache_misses)
    assert a[1] == b[1]      # events apart from ts/seconds
    assert a[2] == b[2]      # retry sleeps
    assert a[3] == b[3]      # fault-hook fire counts


def _mesh(shape):
    return None if shape is None else make_mesh(shape, devices=["cpu"] * (shape[0] * shape[1]))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("plan_name", list(PLANS))
def test_overlapped_equals_serial_bitwise(plan_name, mesh_name, tmp_path):
    """Each side writes its own directory and store; both are compared
    file by file."""
    runs = {}
    for overlap in (True, False):
        root = tmp_path / ("on" if overlap else "off")
        runs[overlap] = _port(overlap, PLANS[plan_name], _mesh(MESHES[mesh_name]),
                              out_dir=str(root / "sweep"),
                              cache=tp.Store(str(root / "store")))
    _assert_same_run(runs[True], runs[False])
    on = _dir_bytes(str(tmp_path / "on" / "sweep"))
    off = _dir_bytes(str(tmp_path / "off" / "sweep"))
    for d in (on, off):
        for rec in d["manifest.json"]["chunks"].values():
            rec["file"] = os.path.basename(rec["file"])
    assert on == off
    names = sorted(os.listdir(tmp_path / "on" / "store" / "sweep_chunk"))
    assert names == sorted(os.listdir(tmp_path / "off" / "store" / "sweep_chunk"))
    res = runs[True][0]
    print(f"RESIDUAL overlap[{plan_name},{mesh_name}] bitwise serial: retries={res.n_retries} "
          f"quarantined={np.flatnonzero(res.quarantined_mask)} failed={res.n_failed}")


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_resume_of_a_torn_directory_and_a_warm_store_equal_serial(mesh_name, tmp_path):
    """One directory written with a torn chunk file (and a poison point)
    is copied and resumed by both loops; then a warm store serves both."""
    mesh = _mesh(MESHES[mesh_name])
    plan = PLANS["mixed"]
    src = str(tmp_path / "src")
    store = tp.Store(str(tmp_path / "store"))
    _port(True, plan, mesh, out_dir=src, cache=store)
    runs = {}
    for overlap in (True, False):
        dst = str(tmp_path / f"resume_{overlap}")
        shutil.copytree(src, dst)
        runs[overlap] = _port(overlap, plan, mesh, out_dir=dst)
    _assert_same_run(runs[True], runs[False])
    assert runs[True][0].resumed_chunks == 3      # the torn chunk 1 recomputes
    warm = {overlap: _port(overlap, plan, mesh, cache=store) for overlap in (True, False)}
    _assert_same_run(warm[True], warm[False])
    assert warm[True][0].cache_hits == 4 and warm[True][0].cache_misses == 0
    for f in warm[True][0].outputs:
        assert warm[True][0].outputs[f].tobytes() == runs[True][0].outputs[f].tobytes()


def _jax(plan=None, out_dir=None):
    sleeps, ev = [], io.StringIO()
    res = js.run_sweep(
        jc.config_from_dict(ARCHIVED), AXES, _static(jc), **KW, out_dir=out_dir,
        fault_plan=None if plan is None else jf.FaultPlan.from_obj(plan),
        retry=jr.RetryPolicy(max_attempts=3, sleep=sleeps.append),
        event_log=jl.EventLog(stream=ev))
    return res, _events(ev), sleeps


def _max_rel(a, b):
    ok = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), ok)
    return float(np.max(np.abs(a[ok] / b[ok] - 1.0))) if ok.any() else 0.0


@pytest.mark.parametrize("plan_name", ["clean", "transient", "poison", "mixed"])
def test_overlapped_matches_the_jax_default(plan_name, tmp_path):
    jres, jev, jsl = _jax(PLANS[plan_name], out_dir=str(tmp_path / "j"))
    tres, tev, tsl, _ = _port(True, PLANS[plan_name], out_dir=str(tmp_path / "t"))
    assert tev == jev and tsl == jsl
    assert (tres.n_failed, tres.n_quarantined, tres.n_retries) == (
        jres.n_failed, jres.n_quarantined, jres.n_retries)
    np.testing.assert_array_equal(tres.failed_mask, jres.failed_mask)
    np.testing.assert_array_equal(tres.quarantined_mask, jres.quarantined_mask)
    rel = max(_max_rel(tres.outputs[f], jres.outputs[f]) for f in jres.outputs)
    print(f"RESIDUAL overlap[{plan_name}] port vs JAX default: outputs max_rel={rel:.3e}")
    assert rel <= OUT_RTOL


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_an_overlapped_directory_resumes_in_the_other_package(writer, tmp_path):
    out = str(tmp_path / "sweep")
    if writer == "jax":
        wrote, read = _jax(out_dir=out)[0], _port(True, out_dir=out)[0]
    else:
        wrote, read = _port(True, out_dir=out)[0], _jax(out_dir=out)[0]
    assert read.resumed_chunks == 4
    for f in wrote.outputs:
        np.testing.assert_array_equal(read.outputs[f], wrote.outputs[f])


@pytest.mark.parametrize("kind", ["tabulated", "kernel", "mesh2x1"])
def test_each_step_kind_dispatches_the_rows_of_its_step_called_directly(kind):
    """``dispatch_chunk`` then ``collect_chunk`` through the one-device
    eager step, the kernel engine's step (eager on the CPU) and the mesh
    step: the rows of the engine's step called on the whole padded chunk,
    bit for bit (10 valid points padded to 16)."""
    from bdlz_tpu_torch.interop import point_params_from_numpy

    base, static = tc.config_from_dict(ARCHIVED), _static()
    impl = "tabulated" if kind == "mesh2x1" else kind
    mesh = _mesh(MESHES.get(kind))
    engine = ts.build_chunk_engine(base, static, n_y=400, impl=impl, device="cpu",
                                   table_nodes=512, mesh=mesh)
    aux = engine[1] if mesh is None else engine[1][torch.device("cpu")]
    pp = ts.build_grid(base, AXES)
    got = ts.collect_chunk(ts.dispatch_chunk(engine, pp, 10, (20, 30, 16)))
    direct = ts.make_sweep_step(static, 400, impl)(
        point_params_from_numpy(ts._pad_chunk(pp, 20, 30, 16), "cpu"), aux)
    for f, want in zip(direct._fields, direct):
        assert got[f].shape == ((10,) if mesh is None else (16,)), f
        assert got[f][:10].tobytes() == want[:10].numpy().tobytes(), f


def _call_order(monkeypatch):
    """Record the loop's dispatches ("D<lo>") and collections ("C")."""
    order = []
    real_d, real_c = ts.dispatch_chunk, ts.collect_chunk

    def dispatch(engine, pp_np, n_valid, bounds=None):
        order.append(f"D{bounds[0]}")
        return real_d(engine, pp_np, n_valid, bounds)

    def collect(pending):
        order.append("C")
        return real_c(pending)

    monkeypatch.setattr(ts, "dispatch_chunk", dispatch)
    monkeypatch.setattr(ts, "collect_chunk", collect)
    return order


def test_overlap_keeps_one_chunk_in_flight_and_trace_dir_runs_serial(monkeypatch, tmp_path):
    order = _call_order(monkeypatch)
    _port(True)
    assert order == ["D0", "D16", "C", "D32", "C", "D48", "C", "C"]
    del order[:]
    _port(False)
    assert order == ["D0", "C", "D16", "C", "D32", "C", "D48", "C"]
    del order[:]
    res = _port(True, trace_dir=str(tmp_path / "tr"))[0]
    assert order == ["D0", "D16", "C", "D32", "C", "D48", "C", "C"]
    assert os.listdir(tmp_path / "tr") == ["trace_00000.json"] and res.n_failed == 0


def test_esdirk_runs_serial_and_only_overlap_joins_the_clamp(monkeypatch):
    """The repacked stiff engine never double-buffers (its rounds sync on
    the host); the lockstep engine does."""
    stiff = dict(ARCHIVED, Gamma_wash_over_H=0.01, T_min_over_Tp=0.05)
    base = tc.config_from_dict(stiff)
    static = tc.static_choices_from_config(base)
    axes = {"m_chi_GeV": [0.5, 1.0]}
    for impl, want in (("esdirk", False), ("esdirk_lockstep", True)):
        plan = ts.plan_sweep(base, axes, static, impl=impl, n_y=400, device="cpu")
        assert plan.impl == impl and plan.overlap is want
        assert ts.plan_sweep(base, axes, static, impl=impl, n_y=400, device="cpu",
                             overlap_chunks=False).overlap is False
    order = _call_order(monkeypatch)
    res = ts.run_sweep(base, axes, static, chunk_size=1, n_y=400, impl="esdirk",
                       device="cpu")
    assert order == ["D0", "C", "D1", "C"] and res.impl == "esdirk" and res.n_failed == 0


def test_a_failure_at_collection_is_healed_there_with_jax_s_events(monkeypatch):
    """An asynchronous device error surfaces when chunk 0 is collected,
    while chunk 1 is in flight: both engines retry chunk 0 once at
    collection and log the same events."""
    import bdlz_tpu.parallel.multihost as jmh

    err = RuntimeError("CUDA error: an illegal memory access was encountered")
    real_gather, calls = jmh.gather_to_host, [0]

    def gather_once_failing(tree):
        calls[0] += 1
        if calls[0] == 1:
            raise err
        return real_gather(tree)

    monkeypatch.setattr(jmh, "gather_to_host", gather_once_failing)
    jres, jev, jsl = _jax()
    monkeypatch.setattr(jmh, "gather_to_host", real_gather)

    order = _call_order(monkeypatch)
    real_c, seen = ts.collect_chunk, [0]

    def collect_once_failing(pending):
        seen[0] += 1
        if seen[0] == 1:
            raise err
        return real_c(pending)

    monkeypatch.setattr(ts, "collect_chunk", collect_once_failing)
    tres, tev, tsl, _ = _port(True)
    retries = [e for e in tev if e["event"] == "chunk_retry"]
    assert retries == [{"event": "chunk_retry", "chunk": 0, "lo": 0, "hi": 16, "attempt": 1,
                        "error": repr(err)}]
    # chunk 1 was dispatched before chunk 0's collection failed
    assert order[:3] == ["D0", "D16", "D0"]
    assert tev == jev and tsl == jsl
    assert tres.n_retries == jres.n_retries == 1 and tres.n_failed == 0
    ref = _port(False)[0]
    for f in ref.outputs:
        assert tres.outputs[f].tobytes() == ref.outputs[f].tobytes()


def test_a_floating_point_error_at_collection_aborts(monkeypatch):
    def collect(pending):
        raise FloatingPointError("NaN produced by torch op 'mul'")

    monkeypatch.setattr(ts, "collect_chunk", collect)
    with pytest.raises(FloatingPointError, match="NaN produced"):
        _port(True)


PER_POINT = 20 * 8000 * 8                # the fast engines' model at n_y 8000
IO_ROWS = (17 + 5) * 8                   # one more chunk's input and output rows


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_the_clamp_adds_one_chunk_s_io_rows_when_double_buffering(monkeypatch, mesh_name):
    """A free budget that holds 8192 points exactly clamps the
    double-buffered loop to the points that fit with 176 more bytes each."""
    assert IO_ROWS == (len(tc.PointParams._fields) + 5) * 8 == 176
    shape = MESHES[mesh_name]
    mesh = None
    n_dev = share = 1
    cuda = torch.device("cuda", 0)
    if shape is not None:
        mesh = make_mesh(shape, devices=["cpu"] * (shape[0] * shape[1]))
        # the members stand in for members of one card
        mesh.devices[...] = cuda
        n_dev = share = mesh.size
    free = -(-8192 * PER_POINT * share * 10 // 9) + 1000
    monkeypatch.delenv("BDLZ_CHUNK_BYTES_BUDGET", raising=False)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 2 * free))
    want_off = (int(0.9 * free) // PER_POINT // share) * n_dev
    want_on = (int(0.9 * free) // (PER_POINT + IO_ROWS) // share) * n_dev
    assert want_off == 8192 * n_dev and want_on < want_off
    big = 16384 * n_dev
    assert ts._clamp_chunk_to_memory(big, 8000, cuda, "kernel", mesh=mesh) == want_off
    assert ts._clamp_chunk_to_memory(big, 8000, cuda, "kernel", mesh=mesh,
                                     double_buffer=True) == want_on
    # the CPU is never clamped
    assert ts._clamp_chunk_to_memory(big, 8000, torch.device("cpu"), "kernel",
                                     double_buffer=True) == big


@pytest.mark.parametrize("double_buffer", [False, True], ids=["serial", "double_buffer"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("impl,quad_nodes", [("kernel", None), ("tabulated", 560),
                                             ("direct", None), ("esdirk", None)])
def test_the_clamp_reads_the_byte_budget_as_jax_does(monkeypatch, mesh_name, double_buffer,
                                                     impl, quad_nodes):
    """With ``BDLZ_CHUNK_BYTES_BUDGET`` set, the port clamps a request to
    JAX's chunk for the same budget per member, whatever the card reports
    free; the platform check of JAX's clamp is stood in for."""
    import jax
    from types import SimpleNamespace

    shape = MESHES[mesh_name]
    cuda = torch.device("cuda", 0)
    tmesh = jmesh = None
    n_dev = 1
    if shape is not None:
        tmesh = make_mesh(shape, devices=["cpu"] * (shape[0] * shape[1]))
        tmesh.devices[...] = cuda       # the members share one card
        jmesh = SimpleNamespace(devices=np.empty(shape, dtype=object))
        n_dev = tmesh.size
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [SimpleNamespace(platform="gpu")])
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (1 << 40, 1 << 41))
    for budget in (PER_POINT * 3000 + 5, 12 * 1024**3, 1):
        monkeypatch.setenv("BDLZ_CHUNK_BYTES_BUDGET", str(budget))
        for request in (7, 8192 * n_dev, 65536 * n_dev):
            want = js._clamp_chunk_to_memory(request, 8000, jmesh, impl, quad_nodes,
                                             double_buffer=double_buffer)
            got = ts._clamp_chunk_to_memory(request, 8000, cuda, impl, quad_nodes, tmesh,
                                            double_buffer=double_buffer)
            assert got == want, (budget, request)
    # JAX's default budget cuts the kernel engine's 16384 points at n_y 8000
    monkeypatch.setenv("BDLZ_CHUNK_BYTES_BUDGET", str(12 * 1024**3))
    assert ts._clamp_chunk_to_memory(16384, 8000, cuda, "kernel") == 12 * 1024**3 // PER_POINT
