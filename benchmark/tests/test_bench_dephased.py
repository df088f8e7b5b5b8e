"""The bounce_lz_dephased cell's own pieces on the CPU: its plain reference
(``reference/bloch.py``, ``reference/bounce_lz_dephased.py``) against closed
forms and limits, the reference's imports, the frozen count of the
transport's work (``harness/dephase_work.py``), the readers of the
``lz.dephase`` spans on a fabricated trace, and a traced run of the cell
cut to CPU size, with the float32 control failing its limits."""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark.harness import calibrate, dephase_work, guard, spec, trace
from benchmark.harness.main import Run
from benchmark.harness.window import Record
from benchmark.harness import traffic as tr
from benchmark.reference import bloch
from benchmark.tests.conftest import SEED, run_cell

CELL = "bounce_lz_dephased.scan"
NEW_FILES = ("bloch.py", "bounce_lz_dephased.py")


def _wall(n_seg=48, seed=3):
    """A smooth single-crossing wall of ``n_seg`` segments."""
    r = np.random.default_rng(seed)
    xi = np.linspace(-20.0, 20.0, n_seg + 1)
    delta = np.tanh(xi / 3.0) + 0.05 * np.sin(r.uniform(0.5, 1.5) * xi)
    mix = 0.1 * (1.0 + 0.2 * np.cos(xi / 3.0))
    return xi, delta, mix


@pytest.mark.parametrize("v", [0.07, 0.3, 0.9])
def test_without_dephasing_the_bloch_route_is_the_amplitude_route(v):
    # Gamma = 0: the Bloch vector's transport and P = |U_10|^2 of the
    # ordered complex product U_S ... U_1 give one P by two routes; 1e-13
    # holds their rounding over 48 segments.
    xi, delta, mix = _wall()
    a, b, dxi = bloch.segments(xi, delta, mix)
    U = np.eye(2, dtype=np.complex128)
    for Uk in bloch.unitary(a, b, dxi / v).numpy():
        U = Uk @ U
    want = abs(U[1, 0]) ** 2
    got = bloch.probability(xi, delta, mix, [v], [0.0])[0]
    assert abs(got - want) <= 1e-13 * max(want, 1e-3)


def test_under_strong_dephasing_the_transport_is_incoherent():
    # e^(-Gamma tau) ~ e^(-400) per segment: every coherence dies where it
    # arises, and r_z is the product of the segments' 1 - 2 p_k, p_k =
    # |U_k,10|^2 (the incoherent composition of the segment probabilities)
    xi, delta, mix = _wall()
    v = 0.4
    a, b, dxi = bloch.segments(xi, delta, mix)
    U = bloch.unitary(a, b, dxi / v)
    p = (U[:, 1, 0].abs() ** 2).numpy()
    want = 0.5 * (1.0 - np.prod(1.0 - 2.0 * p))
    gamma = 400.0 / float(dxi.min() / v)
    got = bloch.probability(xi, delta, mix, [v], [gamma])[0]
    assert abs(got - want) <= 1e-13


@pytest.mark.parametrize("gamma", [0.0, 0.05, 5.0])
def test_one_segment_is_the_rabi_formula(gamma):
    # one segment: P = (b / w)^2 sin^2(w tau), whatever the decay that
    # follows it (it acts on the coherences only)
    a, b, width, v = 0.37, 0.11, 2.5, 0.3
    xi, delta, mix = np.array([0.0, width]), np.array([2 * a, 2 * a]), np.array([b, b])
    w, tau = np.hypot(a, b), width / v
    want = (b / w) ** 2 * np.sin(w * tau) ** 2
    got = bloch.probability(xi, delta, mix, [v], [gamma])[0]
    assert abs(got - want) <= 1e-15


def test_the_bath_rate_is_the_published_formula():
    T = np.array([1.0, 30.0, 300.0, 1e4])
    eta, omega_c = 0.001, 50.0
    np.testing.assert_allclose(bloch.bath_rate(T, eta, omega_c),
                               2 * eta * T * (1 - np.exp(-omega_c / T)), rtol=1e-14)
    # the cell's box: Gamma_phi 0.049 to 0.092 GeV over T_p 30 to 300 GeV
    lo, hi = bloch.bath_rate(np.array([30.0, 300.0]), eta, omega_c)
    assert 0.048 < lo < 0.049 and 0.092 < hi < 0.093
    with pytest.raises(ValueError):
        bloch.bath_rate(np.array([0.0]), eta, omega_c)


@pytest.mark.parametrize("name", NEW_FILES)
def test_the_reference_imports_neither_the_port_nor_jax(name):
    path = spec.BENCH_DIR / "reference" / name
    assert not guard.imports_of(path) & (guard.FORBIDDEN | {guard.PROGRAM})
    code = (f"import sys; sys.path.insert(0, {str(spec.ROOT)!r}); "
            f"import benchmark.reference.{name[:-3]}; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'bdlz_tpu', 'bdlz_tpu_torch'}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_frozen_count_of_a_hand_sized_grid():
    config = {"yields_config": {"T_p_GeV": 100.0, "v_w": 0.3, "lz_bath_eta": 0.001,
                                "lz_bath_omega_c": 50.0},
              "solver": {"n_xi": 11}}
    axes = {"T_p_GeV": np.array([30.0, 30.0, 300.0]), "v_w": np.array([0.1, 0.2, 0.2, 0.5]),
            "m_chi_GeV": np.array([1.0, 2.0])}
    # 2 distinct rates x 3 distinct speeds; 10 segments
    assert dephase_work.lanes(axes, config) == 6
    assert dephase_work.lanes({"m_chi_GeV": np.array([1.0, 2.0])}, config) == 1
    assert dephase_work.F64_INSTR_PER_LANE_SEGMENT == 79
    ops_s = 6 * 10 * 79 / 17e12
    bytes_s = (10 * 24 + 6 * 24) / 3.35e12
    assert dephase_work.least_seconds(6, 10) == pytest.approx(max(ops_s, bytes_s), rel=1e-15)
    req = tr.Request(0, axes, {}, 24)
    assert dephase_work.least_seconds_of([_record(req)] * 2, config) == pytest.approx(
        2 * max(ops_s, bytes_s), rel=1e-15)
    # the cell's own request: 128 rates x 1024 speeds, compute-bound, ~0.49 ms
    cell = spec.load_cell(CELL)
    req = tr.make_request(cell.traffic, cell.config, SEED, 0)
    assert dephase_work.lanes(req.axes, cell.config) == 128 * 1024
    assert dephase_work.least_seconds(128 * 1024, 800) == pytest.approx(
        128 * 1024 * 800 * 79 / 17e12, rel=1e-15)


def _record(req=None, traced=True, error=None):
    req = req or tr.Request(0, {"v_w": np.linspace(0.1, 0.9, 4)}, {}, 4)
    return Record(request=req, start=0.0, end=1.0, wall_s=1.0, seconds=0.5, lz_seconds=0.2,
                  chunks=1, n_failed=0, quad_impl="trap", sample=np.arange(2), outputs={},
                  error=error, traced=traced, cut=False)


def _fabricated(n_sweeps=2, passes=3):
    """Per sweep a harness span of 10_000 ns, ``lz.points`` over [1_000,
    5_000) with ``passes`` ``lz.dephase`` spans of 1_000 ns each, and on the
    device per pass a kernel of 300 ns and a copy of 100 ns overlapping it
    by 50, plus a kernel outside every pass."""
    host, device = [], []
    for k in range(n_sweeps):
        at = k * 20_000
        host += [(trace.SPAN, at, at + 10_000), ("lz.points", at + 1_000, at + 5_000)]
        for j in range(passes):
            s = at + 1_100 + j * 1_200
            host.append(("lz.dephase", s, s + 1_000))
            device += [("void elementwise_kernel", s + 100, s + 400),
                       ("Memcpy DtoH (Device -> Pageable)", s + 350, s + 450)]
        device.append(("void kjma_point_kernel<false, true>", at + 6_000, at + 7_000))
    return trace.Trace((0, n_sweeps * 20_000), device, host)


def _read(name, run):
    return spec.metric_reader(name)(run)


def test_the_dephase_readers_on_a_fabricated_trace():
    cell = spec.load_cell(CELL)
    req = tr.make_request(cell.traffic, cell.config, SEED, 0)
    run = Run(cell.config, {}, [_record(req), _record(req)], 1.0, _fabricated())
    assert _read("dephase_ms", run) == pytest.approx(3 * 1_000e-6)
    assert _read("dephase_passes", run) == 3.0
    # per pass [100, 400) and [350, 450) overlap: 350 ns of device time
    assert _read("dephase_device_ms", run) == pytest.approx(3 * 350e-6)
    least = dephase_work.least_seconds(128 * 1024, 800)
    assert _read("dephase_roofline", run) == pytest.approx(100.0 * least / (3 * 350e-9))


@pytest.mark.parametrize("name", ["dephase_ms", "dephase_passes", "dephase_device_ms",
                                  "dephase_roofline"])
def test_a_dephase_reader_finds_nothing_where_the_program_has_no_such_span(name):
    # the parent's program emits no lz.dephase: the reader returns None
    t = _fabricated()
    bare = t._replace(host=[iv for iv in t.host if iv[0] != "lz.dephase"])
    assert _read(name, Run({}, {}, [_record(), _record()], 1.0, bare)) is None
    assert _read(name, Run({}, {}, [_record()], 1.0, None)) is None


def test_a_traced_cpu_run_of_the_cell_and_its_float32_control(tiny_cell):
    cell = tiny_cell(CELL)
    run, res = run_cell(cell, seconds=1.0, trace=True)
    assert res["correct"] is True and res["failed"] == 0
    # 4 temperatures on the cut axes: one dephased pass each
    assert res["metrics"]["dephase_passes"]["value"] == 4.0
    assert res["metrics"]["dephase_ms"]["value"] > 0.0
    # no card: no device interval to read
    assert "dephase_device_ms" not in res["metrics"]
    assert res["checks"]["max_rel_err"]["value"] < 1e-12
    # the reference in float32 in the program's place fails the limits
    for name, precision in calibrate.controls(cell.config):
        got = calibrate.control_reading(cell, run.records, SEED, "cpu", precision)
        assert got["correct"] is False, name
        assert got["max_rel_err"] > 100 * cell.config["limits"]["max_rel_err"], name
