"""The yardstick's arithmetic on fabricated inputs, and the result line's shape."""
from __future__ import annotations

import numpy as np
import pytest

from benchmark.harness import spec, trace, traffic, work
from benchmark.harness.main import Run
from benchmark.harness.window import Record
from benchmark.tests.conftest import CELLS, SEED, run_cell


def _record(start, end, n=1000, seconds=0.2, lz=0.0, chunks=4, cut=False, traced=False):
    req = traffic.Request(0, {"v_w": np.linspace(0.1, 0.9, n)}, {}, n)
    return Record(request=req, start=start, end=end, wall_s=end - start, seconds=seconds,
                  lz_seconds=lz, chunks=chunks, n_failed=0, quad_impl="trap",
                  sample=np.arange(2), outputs={}, error=None, traced=traced, cut=cut)


def _run(records, trace_=None, config=None):
    return Run(config or {}, {}, records, 12.5, trace_)


def test_union_of_device_intervals_counts_overlapping_streams_once():
    # two streams: [0, 10) and [5, 20) overlap on [5, 10); a copy [30, 40)
    # straddles the window's end at 35
    iv = [("kernel_a", 0, 10), ("kernel_b", 5, 20), ("Memcpy DtoH", 30, 40)]
    assert trace.merged(iv, 0, 35) == [(0, 20), (30, 35)]
    assert trace.busy_ns(iv, 0, 35) == 25
    assert trace.gaps(iv, 0, 35) == [(20, 30)]
    assert trace.gaps(iv, -5, 50) == [(-5, 0), (20, 30), (40, 50)]


def test_idle_gaps_are_labelled_by_the_host_op_around_them():
    t = trace.Trace((0, 100), [("k", 0, 10), ("k", 60, 100)],
                    [(trace.SPAN, 0, 100), ("aten::copy_", 20, 50), ("aten::empty", 30, 35)])
    got = trace.breakdown(t)
    assert got["device_ops"] == [["k", pytest.approx(50e-9)]]
    assert got["idle_gaps"] == [[f"{trace.SPAN} > aten::copy_", pytest.approx(50e-9)]]


def test_rate_counts_completed_sweeps_over_the_window():
    # sweeps of 1000 points over [0, 2), [2, 4), [4, 6.5); the third ended
    # after the close and counts for nothing
    read = spec.metric_reader("points_per_s")
    recs = [_record(0.0, 2.0), _record(2.0, 4.0), _record(4.0, 6.5, cut=True)]
    assert read(_run(recs)) == pytest.approx(2000 / 4.0)
    assert read(_run([_record(0.0, 3.0, cut=True)])) is None


def test_plan_loop_and_lz_arithmetic():
    recs = [_record(0.0, 1.0, seconds=0.3, lz=0.1, chunks=3),
            _record(1.0, 3.0, seconds=0.5, lz=0.3, chunks=5),
            _record(3.0, 9.0, seconds=9.0, chunks=100, cut=True)]
    run = _run(recs)
    assert spec.metric_reader("plan_ms")(run) == pytest.approx(1e3 * (0.6 + 1.2) / 2)
    assert spec.metric_reader("chunk_loop_ms")(run) == pytest.approx(1e3 * 0.8 / 8)
    assert spec.metric_reader("lz_prepass_ms")(run) == pytest.approx(1e3 * 0.4 / 2)
    assert spec.metric_reader("lz_prepass_ms")(_run([_record(0.0, 1.0)])) is None
    assert spec.metric_reader("setup_s")(run) == 12.5


def test_device_readers_find_nothing_without_a_trace():
    run = _run([_record(0.0, 1.0)])
    for name in ("shoot_ms", "p1_roofline", "device_idle_pct"):
        assert spec.metric_reader(name)(run) is None


def test_device_idle_and_shoot_from_a_fabricated_trace():
    t = trace.Trace((0, 1000), [("void bounce_tree_kernel(double const*)", 100, 400),
                                ("Memcpy HtoD", 350, 500)], [])
    run = _run([_record(0.0, 1.0)], t)
    assert spec.metric_reader("device_idle_pct")(run) == pytest.approx(60.0)
    assert spec.metric_reader("shoot_ms")(run) == pytest.approx(300e-6)


def test_p1_work_count_agrees_with_the_node_count_of_the_card_checks():
    """The frozen count against ``chip_smoke._point_bound`` on a small grid,
    with the non-empty windows counted by the port's ``point_scalars``."""
    import torch

    import chip_smoke
    from bdlz_tpu_torch.config import config_from_dict
    from bdlz_tpu_torch.interop import point_params_from_numpy
    from bdlz_tpu_torch.ops import kjma_kernel as kk
    from bdlz_tpu_torch.ops.kjma_table import make_f_table
    from bdlz_tpu_torch.parallel.sweep import build_grid

    cfg = spec.load_cell("equal_mass.scan_kernel").config
    # T_min near T_p empties the windows of the hottest points
    yc = dict(cfg["yields_config"], T_min_over_Tp=0.9, T_max_over_Tp=1.2)
    axes = {"m_chi_GeV": np.geomspace(0.1, 10, 4), "T_p_GeV": np.geomspace(30, 300, 8),
            "beta_over_H": np.linspace(-300, 300, 8)}
    base = config_from_dict(yc)
    pp = point_params_from_numpy(build_grid(base, axes), torch.device("cpu"))
    scalars = kk.point_scalars(pp, base.chi_stats, make_f_table(base.I_p, 64), 2000)
    bound = chip_smoke._point_bound(scalars, 2000, stream=False)
    inputs = {f: getattr(pp, f).numpy()
              for f in ("T_p_GeV", "beta_over_H", "T_max_over_Tp", "T_min_over_Tp")}
    ok = work.nonempty(inputs)
    assert 0 < ok.sum() < ok.size
    assert int(ok.sum()) == bound["nonempty_points"]
    assert int(ok.sum()) * 2000 * work.F64_INSTR_PER_NODE == bound["f64_instructions"]
    assert work.F64_INSTR_PER_NODE == chip_smoke.POINT_F64_INSTR_PER_NODE == 113


@pytest.mark.parametrize("name", ["scan_kernel", "potential_scan", "scan_default"])
def test_traffic_sizes_are_fixed_and_values_differ_between_seeds(name):
    cell = spec.load_cell([c for c in CELLS if c.endswith(name)][0])
    a = traffic.make_request(cell.traffic, cell.config, SEED, 0)
    b = traffic.make_request(cell.traffic, cell.config, SEED + 1, 0)
    c = traffic.make_request(cell.traffic, cell.config, SEED, 1)
    again = traffic.make_request(cell.traffic, cell.config, SEED, 0)
    for k in a.axes:
        assert a.axes[k].shape == b.axes[k].shape == c.axes[k].shape
        assert not np.array_equal(a.axes[k], b.axes[k])
        assert not np.array_equal(a.axes[k], c.axes[k])
        np.testing.assert_array_equal(a.axes[k], again.axes[k])
    assert a.n_points == b.n_points == int(np.prod([len(v) for v in a.axes.values()]))
    s = traffic.sample_points(cell.traffic, SEED, a)
    assert s[0] == 0 and s[-1] == a.n_points - 1 and len(set(s)) == len(s)
    draws = [path.split(".") for path in cell.traffic.get("draw", {})]
    for k in range(50 if draws else 0):
        kw = traffic.make_request(cell.traffic, cell.config, 2 ** 33 + k, k).kwargs
        for (outer, key), (lo, hi) in zip(draws, cell.traffic["draw"].values()):
            assert lo <= kw[outer][key] <= hi
    # drawn per request; everything else as the configuration gives it
    for outer, key in draws:
        assert a.kwargs[outer][key] != b.kwargs[outer][key]
        drawn = {k for o, k in draws if o == outer}
        assert {k: v for k, v in a.kwargs[outer].items() if k not in drawn} == {
            k: v for k, v in cell.config["sweep"][outer].items() if k not in drawn}
    assert {k: a.kwargs[k] for k in cell.traffic["engine"]} == cell.traffic["engine"]


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_line_has_exactly_its_keys_in_order(tiny_cell, traced):
    """correct, attempted, failed, metrics, device, the breakdown of a
    traced run, and last the compared numbers with their limits."""
    _, res = run_cell(tiny_cell("equal_mass.scan_kernel"), seconds=3.0, trace=traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    want = {"plan_ms", "chunk_loop_ms"} if traced else {"points_per_s", "setup_s"}
    assert want <= set(res["metrics"])


def test_a_mix_reaches_run_sweep_as_data(tiny_cell, monkeypatch):
    """A mix's ``engine`` keyword arguments and ``static`` choices reach
    ``run_sweep`` as they stand, and its ``draw`` ranges set scalar keyword
    arguments as well as keys inside one."""
    import bdlz_tpu_torch.parallel.sweep as sw

    cell = tiny_cell("equal_mass.scan_kernel")
    cell = cell._replace(traffic=dict(cell.traffic, engine={"impl": "kernel", "fuse_exp": True},
                                      static={"quad_panel_gl": False}))
    seen = []
    real = sw.run_sweep

    def spy(base, axes, static, **kw):
        seen.append((static.quad_panel_gl, kw))
        return real(base, axes, static, **kw)

    monkeypatch.setattr(sw, "run_sweep", spy)
    _, res = run_cell(cell, seconds=2.0)
    assert res["correct"] is True
    assert seen and all(q is False and kw["fuse_exp"] is True and kw["impl"] == "kernel"
                        for q, kw in seen)
    assert all(kw["n_y"] == 2000 and kw["chunk_size"] == 64 for _, kw in seen)

    mix = dict(cell.traffic, draw={"lz_gamma_phi": [0.0, 0.05], "bounce.eps": [0.04, 0.06]})
    config = dict(cell.config, sweep=dict(cell.config["sweep"], bounce={"eps": 0.05, "lam4": 0.5}))
    kw = traffic.make_request(mix, config, SEED, 3).kwargs
    assert 0.0 <= kw["lz_gamma_phi"] <= 0.05 and 0.04 <= kw["bounce"]["eps"] <= 0.06
    assert kw["bounce"]["lam4"] == 0.5 and config["sweep"]["bounce"]["eps"] == 0.05
