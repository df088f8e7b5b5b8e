"""The spans of the port's sweep path (``utils/profiling.span``) on the CPU.

* Under ``torch.profiler`` a sweep emits the names of
  ``utils/profiling.SPANS``: one ``sweep``, ``sweep.grid``,
  ``engine.build``, ``sweep.loop`` and ``sweep.copy_out``, one
  ``f_table`` wherever the table is built, ``audit`` when the population
  audit runs, and per chunk one ``chunk.ship``, ``chunk.step``,
  ``chunk.wait`` and ``chunk.finish`` inside ``sweep.loop``; on the
  kernel and tabulated engines, on a mesh of host members and on the
  elastic fleet.
* With no profiler recording, a span is one shared null context: the
  sweep creates no ``record_function`` and gives the same outputs.
* A sweep that shoots a bounce emits ``lz.shoot`` and ``lz.points`` once.

64 points in 4 chunks of 16 at n_y 400 (floored to 2000 nodes).
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bdlz_tpu_torch import config as tc
from bdlz_tpu_torch.parallel import make_mesh
from bdlz_tpu_torch.parallel import sweep as ts
from bdlz_tpu_torch.utils import profiling

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
AXES = {"m_chi_GeV": np.geomspace(0.3, 3.0, 8), "T_p_GeV": np.geomspace(50.0, 200.0, 8)}
KW = dict(chunk_size=16, n_y=400, table_nodes=512, device="cpu")
CHUNK_SPANS = ("chunk.ship", "chunk.step", "chunk.wait", "chunk.finish")


def _static(quad=False, cfg=ARCHIVED):
    return tc.static_choices_from_config(tc.config_from_dict(cfg))._replace(
        quad_panel_gl=quad)


def _spans(fn):
    """``(result of fn(), [(name, start ns, end ns)])`` of the program's
    spans that ``fn`` emitted under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), int(e.start_ns()), int(e.end_ns()))
             for e in prof.profiler.kineto_results.events() if e.name() in profiling.SPANS]
    return out, sorted(spans, key=lambda s: s[1])


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _assert_sweep_spans(spans, chunks):
    for name in ("sweep", "sweep.grid", "engine.build", "sweep.loop", "sweep.copy_out"):
        assert len(_named(spans, name)) == 1, name
    (sweep,), (loop,) = _named(spans, "sweep"), _named(spans, "sweep.loop")
    assert all(_inside(s, sweep) for s in spans)
    for name in CHUNK_SPANS:
        got = _named(spans, name)
        assert len(got) == chunks, name
        assert all(_inside(s, loop) for s in got), name
    # per chunk: shipped, stepped, waited for, finished, in that order
    (grid,), (build,), (out,) = (_named(spans, n) for n in
                                 ("sweep.grid", "engine.build", "sweep.copy_out"))
    assert grid[2] <= build[1] <= build[2] <= loop[1] and loop[2] <= out[1]
    wait, finish = _named(spans, "chunk.wait"), _named(spans, "chunk.finish")
    assert all(w[2] <= f[1] for w, f in zip(wait, finish))


@pytest.mark.parametrize("impl,quad,overlap", [
    ("kernel", False, True), ("tabulated", False, True), ("tabulated", None, True),
    ("tabulated", False, False)], ids=["kernel", "tabulated", "tabulated_audit", "serial"])
def test_a_sweep_emits_every_span_once_and_each_chunk_s_in_the_loop(impl, quad, overlap):
    base = tc.config_from_dict(ARCHIVED)
    res, spans = _spans(lambda: ts.run_sweep(base, AXES, _static(quad), impl=impl,
                                             overlap_chunks=overlap, **KW))
    assert res.chunks == 4 and res.n_failed == 0
    _assert_sweep_spans(spans, res.chunks)
    (sweep,), (table,) = _named(spans, "sweep"), _named(spans, "f_table")
    audits = _named(spans, "audit")
    assert len(audits) == (1 if quad is None else 0)
    (build,) = _named(spans, "engine.build")
    if quad is None:
        # the audit takes the table built for the sweep
        assert table[2] <= audits[0][1] and _inside(audits[0], sweep)
    else:
        assert _inside(table, build)
    assert not _named(spans, "lz.shoot") and not _named(spans, "lz.points")


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["mesh2x1", "mesh1x2"])
def test_a_mesh_sweep_ships_and_steps_each_chunk_once(shape):
    mesh = make_mesh(shape, devices=["cpu"] * (shape[0] * shape[1]))
    kw = dict(KW, device=None)
    res, spans = _spans(lambda: ts.run_sweep(tc.config_from_dict(ARCHIVED), AXES, _static(),
                                             impl="tabulated", mesh=mesh, **kw))
    _assert_sweep_spans(spans, res.chunks)


def test_an_elastic_sweep_emits_the_planning_and_chunk_spans(tmp_path):
    from bdlz_tpu_torch.parallel.scheduler import run_sweep_elastic

    res, spans = _spans(lambda: run_sweep_elastic(
        tc.config_from_dict(ARCHIVED), AXES, _static(), store=str(tmp_path / "store"),
        impl="tabulated", chunk_size=16, n_y=400, table_nodes=512, device="cpu"))
    assert res.chunks == 4 and res.n_failed == 0
    (sweep,), (loop,) = _named(spans, "sweep"), _named(spans, "sweep.loop")
    assert len(_named(spans, "sweep.grid")) == len(_named(spans, "engine.build")) == 1
    for name in CHUNK_SPANS:
        got = _named(spans, name)
        assert len(got) == 4 and all(_inside(s, loop) for s in got), name
    assert all(_inside(s, sweep) for s in spans)


def test_with_no_profiler_a_sweep_makes_no_record_function(monkeypatch):
    import torch.autograd.profiler as autograd_profiler

    base = tc.config_from_dict(ARCHIVED)
    want = {impl: ts.run_sweep(base, AXES, _static(quad), impl=impl, **KW)
            for impl, quad in (("kernel", False), ("tabulated", None))}
    assert profiling.span("sweep") is profiling.span("chunk.step") is profiling._NO_SPAN

    def refuse(*_a, **_k):
        raise AssertionError("record_function made while no profiler records")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for impl, quad in (("kernel", False), ("tabulated", None)):
        got = ts.run_sweep(base, AXES, _static(quad), impl=impl, **KW)
        assert got.n_failed == 0
        for f in got.outputs:
            assert got.outputs[f].tobytes() == want[impl].outputs[f].tobytes(), (impl, f)


def test_a_span_records_only_while_a_profiler_records():
    assert profiling.span("sweep") is profiling._NO_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        inner = profiling.span("sweep")
        assert inner is not profiling._NO_SPAN
        with inner:
            pass
    assert profiling.span("sweep") is profiling._NO_SPAN


def _tanh_solution(spec):
    """A converged stand-in for the port's shoot: a tanh wall of the
    potential's own width from its true to its false vacuum at ρ = 60."""
    from bdlz_tpu_torch.bounce import shooting as sh

    s = sh.as_potential_spec(spec)
    phi_false, _, phi_true = sh.vacua(s)
    mu = sh.wall_width_mu(s)
    rho = np.linspace(0.0, 120.0, 12001)
    phi = 0.5 * (phi_true + phi_false) - 0.5 * (phi_true - phi_false) * np.tanh(
        mu * (rho - 60.0))
    return sh.BounceSolution(np.float64(phi[0]), np.float64(60.0), np.float64(0.0),
                             np.bool_(True), rho, phi, np.gradient(phi, rho))


def test_a_bounce_sweep_shoots_and_derives_p_once_each(monkeypatch):
    from bdlz_tpu_torch import bounce as tb
    from bdlz_tpu_torch.bounce import shooting as sh

    solve = lambda spec, **_kw: _tanh_solution(spec)  # noqa: E731
    monkeypatch.setattr(sh, "solve_bounce", solve)
    monkeypatch.setattr(tb, "solve_bounce", solve)
    cfg = dict(ARCHIVED, P_chi_to_B=None)
    base = tc.config_from_dict(cfg)
    axes = {"v_w": np.linspace(0.1, 0.9, 6), "m_chi_GeV": [0.5, 0.95]}
    res, spans = _spans(lambda: ts.run_sweep(
        base, axes, _static(cfg=cfg), impl="kernel", bounce=dict(tb.reference_potential()._asdict()),
        chunk_size=6, n_y=400, table_nodes=512, device="cpu"))
    assert res.chunks == 2 and res.lz_identity is not None
    assert np.isfinite(res.outputs["DM_over_B"]).all()
    (sweep,), (grid,) = _named(spans, "sweep"), _named(spans, "sweep.grid")
    (shoot,), (points,) = _named(spans, "lz.shoot"), _named(spans, "lz.points")
    assert shoot[2] <= grid[1] and grid[2] <= points[1]
    assert all(_inside(s, sweep) for s in (shoot, grid, points))
    _assert_sweep_spans(spans, res.chunks)
