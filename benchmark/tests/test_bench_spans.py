"""The readers of the program's spans (``harness/spans.py`` and the metrics
that use it) on fabricated traces, and a traced run on the CPU."""
from __future__ import annotations

import numpy as np
import pytest

from benchmark.harness import spec, trace, traffic
from benchmark.harness.main import Run
from benchmark.harness.window import Record
from benchmark.tests.conftest import run_cell

SPAN_READERS = ("grid_ms", "f_table_ms", "audit_ms", "sweep_self_ms", "chunk_step_ms",
                "chunk_wait_ms", "chunk_device_ms", "chunk_kernels")


def _record(chunks=4, traced=True, error=None, cut=False):
    req = traffic.Request(0, {"v_w": np.linspace(0.1, 0.9, 10)}, {}, 10)
    return Record(request=req, start=0.0, end=1.0, wall_s=1.0, seconds=0.5, lz_seconds=0.0,
                  chunks=chunks, n_failed=0, quad_impl="trap", sample=np.arange(2),
                  outputs={}, error=error, traced=traced, cut=cut)


def _sweep(at, chunks=2):
    """One traced sweep's host spans from ``at`` (ns): the grid, the F table
    inside the engine's build, an unnamed stretch, the loop with
    ``chunks`` chunks of ship 10, step 100, wait 5 and finish 20, the
    copy-out; and the device: a kernel and a copy per chunk, a kernel
    outside the loop."""
    host = [(trace.SPAN, at, at + 10_000), ("sweep", at + 100, at + 9_900),
            ("sweep.grid", at + 150, at + 1_150), ("engine.build", at + 1_150, at + 3_150),
            ("f_table", at + 1_200, at + 3_000), ("aten::empty", at + 1_300, at + 1_400)]
    # 3_150..3_600 is the sweep's own time; the loop runs from 3_600
    t = at + 3_600
    loop_start, device = t, [("void kjma_point_kernel<false, true>(double)", at + 2_000,
                              at + 2_050)]
    for _ in range(chunks):
        host += [("chunk.ship", t, t + 10), ("chunk.step", t + 10, t + 110),
                 ("chunk.wait", t + 110, t + 115), ("chunk.finish", t + 115, t + 135)]
        device += [("void kjma_point_kernel<false, true>(double)", t + 50, t + 150),
                   ("Memcpy DtoH (Device -> Pinned)", t + 140, t + 160)]
        t += 200
    host += [("sweep.loop", loop_start, t), ("sweep.copy_out", t, t + 300)]
    return host, device


def _fabricated(n_sweeps=2, chunks=2, audit=False):
    host, device = [], []
    for k in range(n_sweeps):
        h, d = _sweep(k * 20_000, chunks)
        host += h
        device += d
    if audit:
        host += [("audit", k * 20_000 + 3_150, k * 20_000 + 3_450) for k in range(n_sweeps)]
    return trace.Trace((0, n_sweeps * 20_000), device, host)


def _run(t, records):
    return Run({}, {}, records, 1.0, t)


def _read(name, run):
    return spec.metric_reader(name)(run)


def test_span_readers_on_a_fabricated_trace():
    run = _run(_fabricated(), [_record(chunks=2), _record(chunks=2)])
    assert _read("grid_ms", run) == pytest.approx(1_000e-6)
    assert _read("f_table_ms", run) == pytest.approx(1_800e-6)
    assert _read("chunk_step_ms", run) == pytest.approx(100e-6)
    assert _read("chunk_wait_ms", run) == pytest.approx(5e-6)
    # the sweep's 9_800 ns less its children's union: grid 1_000, build
    # 2_000 (the F table inside it counts once), loop 400, copy-out 300;
    # an op that no span names is the sweep's own
    assert _read("sweep_self_ms", run) == pytest.approx((9_800 - 3_700) * 1e-6)
    # per chunk: the kernel [50, 150) and the copy [140, 160) overlap:
    # 110 ns of device time; the kernel before the loop is not counted
    assert _read("chunk_device_ms", run) == pytest.approx(110e-6)
    assert _read("chunk_kernels", run) == pytest.approx(1.0)
    assert _read("audit_ms", run) is None


def test_the_union_of_children_takes_the_audit_inside_the_sweep():
    run = _run(_fabricated(audit=True), [_record(chunks=2), _record(chunks=2)])
    assert _read("audit_ms", run) == pytest.approx(300e-6)
    # the audit covers 300 ns of the sweep's own 450 from 3_150 to 3_600
    assert _read("sweep_self_ms", run) == pytest.approx((9_800 - 4_000) * 1e-6)


def test_only_completed_traced_sweeps_count():
    # the second traced sweep raised: its spans and chunks are left out
    run = _run(_fabricated(), [_record(chunks=2), _record(chunks=2, error="boom"),
                               _record(traced=False)])
    assert _read("grid_ms", run) == pytest.approx(1_000e-6)
    assert _read("chunk_step_ms", run) == pytest.approx(100e-6)
    assert _read("chunk_kernels", run) == pytest.approx(1.0)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_a_reader_finds_nothing_without_spans(name):
    bare = trace.Trace((0, 10_000), [("k", 0, 10)], [(trace.SPAN, 0, 10_000)])
    assert _read(name, _run(bare, [_record()])) is None
    assert _read(name, _run(None, [_record()])) is None
    # a trace that holds spans but no completed traced sweep
    assert _read(name, _run(_fabricated(n_sweeps=1), [_record(cut=True)])) is None


def test_device_readers_find_nothing_without_device_events():
    t = _fabricated()
    run = _run(t._replace(device=[]), [_record(chunks=2), _record(chunks=2)])
    assert _read("chunk_device_ms", run) is None and _read("chunk_kernels", run) is None
    assert _read("chunk_step_ms", run) == pytest.approx(100e-6)


def test_an_idle_gap_under_the_f_table_is_labelled_by_it():
    t = _fabricated(n_sweeps=1)
    # the device is idle from 0 to 2_000: the gap's middle (1_000) lies in
    # the grid; the gap after the kernel before the loop, in the F table
    assert trace.host_labels(t.host, [1_000, 2_500]) == [
        f"{trace.SPAN} > sweep.grid", f"{trace.SPAN} > f_table"]
    idle = dict(trace.breakdown(t)["idle_gaps"])
    assert f"{trace.SPAN} > (python)" not in idle


def test_a_traced_cpu_run_reports_the_span_metrics(tiny_cell):
    cell = tiny_cell("equal_mass.scan_kernel")
    run, res = run_cell(cell, seconds=1.0, trace=True)
    assert res["correct"] is True
    got = res["metrics"]
    for name in ("grid_ms", "f_table_ms", "chunk_step_ms", "chunk_wait_ms", "sweep_self_ms"):
        assert got[name]["value"] > 0.0, name
    assert got["chunk_step_ms"]["unit"] == "ms/chunk"
    # no card: no device interval to read, no audit in this cell
    for name in ("chunk_device_ms", "chunk_kernels", "audit_ms"):
        assert name not in got
    assert [r.traced for r in run.records][:1] == [True]
