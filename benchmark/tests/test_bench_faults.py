"""``correct`` comes out false when the timed path is broken underneath, and
the control (the reference in float32 in the program's place) fails the
limits, on the CPU at a size a test run holds.  The run below skips the
harness's look for a card and drives the rest of it.

Faults a sweep cell can have: an answer altered where it is produced,
half of a chunk's points left out, and the population audit choosing the
panel rule where the contract's trapezoid differs.  A step that returns its state
unchanged and the exchange between chips do not exist here: a sweep keeps
no state from one request to the next and runs on one chip."""
from __future__ import annotations

import pytest
import torch

from benchmark.harness import calibrate
from benchmark.tests.conftest import CELLS, SEED, run_cell


def _altered(present_day):
    """The first point of every chunk reports its ratio 1e-6 high."""
    def fault(Y_B, Y_chi, m_chi_GeV, m_B_kg):
        out = present_day(Y_B, Y_chi, m_chi_GeV, m_B_kg)
        ratio = out.DM_over_B.clone()
        ratio[0] = ratio[0] * (1.0 + 1e-6)
        return out._replace(DM_over_B=ratio)
    return fault


def _half_left_out(present_day):
    """The second half of every chunk is never computed: its Y_B stays 0."""
    def fault(Y_B, Y_chi, m_chi_GeV, m_B_kg):
        Y_B = Y_B.clone()
        Y_B[Y_B.shape[0] // 2:] = 0.0
        return present_day(Y_B, Y_chi, m_chi_GeV, m_B_kg)
    return fault


@pytest.mark.parametrize("fault", [_altered, _half_left_out], ids=["altered", "half_left_out"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_reads_not_correct(tiny_cell, monkeypatch, name, fault):
    from bdlz_tpu_torch.models import yields_pipeline

    cell = tiny_cell(name)
    _, sound = run_cell(cell, seconds=3.0)
    assert sound["correct"] is True
    monkeypatch.setattr(yields_pipeline, "present_day", fault(yields_pipeline.present_day))
    _, broken = run_cell(cell, seconds=3.0)
    assert broken["attempted"] >= 1
    assert broken["correct"] is False
    assert broken["checks"]["max_rel_err"]["value"] > broken["checks"]["max_rel_err"]["limit"]


def test_a_wrong_audit_choice_reads_not_correct(tiny_cell, monkeypatch):
    """The audit turning the panel rule on where the trapezoid of the 1e-6
    contract differs (the T = m/3 seam inside the windows): the reference
    on the program's own scheme agrees, the reference on the trapezoid
    does not."""
    from bdlz_tpu_torch import validation

    cell = tiny_cell("equal_mass.scan_default")
    cell = cell._replace(traffic=dict(cell.traffic, axes=dict(
        cell.traffic["axes"], m_chi_GeV="geom:300:3000:4")))
    _, sound = run_cell(cell, seconds=3.0)
    assert sound["correct"] is True  # the audit falls back to the trapezoid
    monkeypatch.setattr(validation, "resolve_quad_panel_gl", lambda *a, **k: (True, None))
    _, wrong = run_cell(cell, seconds=3.0)
    checks = wrong["checks"]
    assert wrong["correct"] is False
    assert checks["max_rel_err"]["value"] <= checks["max_rel_err"]["limit"]
    assert checks["trap_rel_err"]["value"] > checks["trap_rel_err"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_the_float32_control_reads_not_correct(tiny_cell, name):
    cell = tiny_cell(name)
    run, res = run_cell(cell, seconds=3.0)
    assert res["correct"] is True
    limit = cell.config["limits"]["max_rel_err"]
    for ctl, precision in calibrate.controls(cell.config):
        reading = calibrate.control_reading(cell, run.records, SEED, "cpu", precision)
        if isinstance(reading, str):  # a control that raises has failed
            assert reading.startswith("raised") and precision.get("shoot_dtype") is not None
        else:
            assert reading["correct"] is False
            assert reading["max_rel_err"] > 3 * limit, (ctl, reading)
    assert torch.float32 in [p["dtype"] for _, p in calibrate.controls(cell.config)]
