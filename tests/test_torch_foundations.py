"""Port foundations against the JAX package: constants, config, grids, devices.

Both packages get the same inputs; values must be equal (exact, not
within a tolerance) — these layers do no floating-point arithmetic that
could differ.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import bdlz_tpu.config as jc
import bdlz_tpu.constants as jconst
from bdlz_tpu.parallel.sweep import AXIS_MAP as J_AXIS_MAP
from bdlz_tpu.parallel.sweep import build_grid as j_build_grid

import bdlz_tpu_torch.config as tc
import bdlz_tpu_torch.constants as tconst
from bdlz_tpu_torch.backend import F64, resolve_device
from bdlz_tpu_torch.parallel.sweep import AXIS_MAP, build_grid

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}


def test_constants_bit_identical():
    names = [n for n in dir(jconst) if n.isupper()]
    assert names == [n for n in dir(tconst) if n.isupper()]
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n


def test_config_defaults_and_fields_equal():
    assert tc.default_config() == jc.default_config()
    assert list(tc.default_config()) == list(jc.default_config())
    assert tc.PointParams._fields == jc.PointParams._fields
    assert tc.StaticChoices._fields == jc.StaticChoices._fields
    assert tc.StaticChoices() == jc.StaticChoices()


@pytest.mark.parametrize("raw", [
    {},
    ARCHIVED,
    {**ARCHIVED, "regime": "thermal", "chi_stats": "boson", "m_B_GeV": 2.0},
    {**ARCHIVED, "Y_chi_init": None, "n_chi_at_Tp_GeV3": 3.0e-3},
    {**ARCHIVED, "Y_chi_init": None},
])
def test_config_binding_equal(raw):
    t, j = tc.config_from_dict(raw), jc.config_from_dict(raw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tuple(tc.point_params_from_config(t, 0.3)) == tuple(
        jc.point_params_from_config(j, 0.3))
    assert tuple(tc.static_choices_from_config(t)) == tuple(
        jc.static_choices_from_config(j))
    assert tc.needs_ode_path(t) == jc.needs_ode_path(j)


BAD = [
    {"bogus_key": 1},
    {"regime": "auto"},
    {"n_y": 1},
    {"ode_method": "rk4"},
    {"ode_rtol": 0.0},
    {"quad_panel_gl": "yes"},
    {"error_gate_tol": True},
    {"error_gate_tol": -1.0},
    {"posterior_weight": "flat"},
    {"refine_signal": "x"},
    {"sampler": "hmc"},
    {"mass_matrix": "full"},
    {"target_accept": 1.0},
    {"retry_max_attempts": 0},
    {"retry_backoff_s": -1.0},
    {"fault_plan": 3},
    {"n_replicas": 0},
    {"queue_bound": 0},
    {"breaker_window": 0},
    {"breaker_threshold": 0.0},
    {"breaker_cooldown_s": 0.0},
    {"breaker_latency_slo_s": 0.0},
    {"rollback_budget": 2.0},
    {"drift_gated_rate": 0.0},
    {"rebuild_budget": 0},
    {"tenant_routing": "x"},
    {"memory_budget_bytes": 0},
    {"autoscale_interval_s": 0.0},
    {"pool_min_replicas": 0},
    {"cache_root": 5},
    {"lz_mode": "x"},
    {"lz_n_levels": 1},
    {"lz_n_levels": 3},
    {"lz_bath_eta": -1.0},
    {"lz_bath_eta": 0.5},
    {"lz_mode": "thermal", "lz_bath_eta": 0.5},
]


@pytest.mark.parametrize("raw", BAD, ids=[next(iter(b)) + str(i) for i, b in enumerate(BAD)])
@pytest.mark.parametrize("backend", ["gpu", "numpy"])
def test_same_rejections(raw, backend):
    """Every config the JAX package rejects, the port rejects, and the
    reverse, on a device and on the NumPy backend."""
    def outcome(mod):
        try:
            mod.validate(mod.config_from_dict(raw), backend=backend)
        except mod.ConfigError:
            return "rejected"
        return "accepted"

    assert outcome(tc) == outcome(jc)
    if next(iter(raw)) != "regime":
        assert outcome(tc) == "rejected"


def test_regime_auto_rejected_on_device_accepted_on_numpy_ode_path():
    raw = {"regime": "auto", "sigma_v_chi_GeV_m2": 1e-30}
    for mod in (tc, jc):
        with pytest.raises(mod.ConfigError):
            mod.validate(mod.config_from_dict(raw), backend="gpu")
        mod.validate(mod.config_from_dict(raw), backend="numpy")


def test_load_config_roundtrip(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(ARCHIVED))
    assert dataclasses.asdict(tc.load_config(str(path))) == dataclasses.asdict(
        jc.load_config(str(path)))


@pytest.mark.parametrize("axes,product", [
    ({"m_chi_GeV": [0.5, 1.0], "v_w": [0.1, 0.3, 0.5]}, True),
    ({"m_chi_GeV": np.geomspace(0.1, 10, 4), "T_p_GeV": np.geomspace(30, 300, 3),
      "v_w": np.linspace(0.05, 0.95, 2), "m_B_GeV": [0.938, 2.0]}, True),
    ({"m_chi_GeV": [0.5, 1.0], "P_chi_to_B": [0.1, 0.2]}, False),
])
def test_build_grid_arrays_equal(axes, product):
    assert AXIS_MAP == J_AXIS_MAP
    t = build_grid(tc.config_from_dict(ARCHIVED), axes, product=product)
    j = j_build_grid(jc.config_from_dict(ARCHIVED), axes, product=product)
    for name in tc.PointParams._fields:
        a, b = getattr(t, name), np.asarray(getattr(j, name))
        assert a.dtype == np.float64 and np.array_equal(a, b), name


def test_build_grid_rejects_unknown_axis():
    with pytest.raises(ValueError, match="Unknown sweep axes"):
        build_grid(tc.config_from_dict(ARCHIVED), {"bogus": [1.0]})


def test_resolve_device_cpu_on_request_and_no_silent_fallback(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(dev)
    with pytest.raises(ValueError):
        resolve_device("mps")
    assert F64 is torch.float64


SMI_ROWS = ("GPU-aaaa, NVIDIA H100 80GB HBM3, 700.00 W\n"
            "GPU-bbbb, NVIDIA H100 80GB HBM3, 500.00 W\n")


@pytest.mark.parametrize("index,uuid,want", [
    (0, "bbbb", "NVIDIA H100 80GB HBM3, 500.00 W"),    # renumbered: torch's 0 is smi's 1
    (1, "aaaa", "NVIDIA H100 80GB HBM3, 700.00 W"),
    (0, "cccc", None),                                 # a card nvidia-smi does not list
])
def test_device_label_finds_the_card_by_uuid(monkeypatch, index, uuid, want):
    """``device_label`` reads nvidia-smi's row of the card's UUID, not of
    torch's index, and raises for a card it cannot find; the host is
    ``cpu`` without a query."""
    import subprocess
    from types import SimpleNamespace

    from bdlz_tpu_torch.backend import device_label

    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return SimpleNamespace(stdout=SMI_ROWS)

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: SimpleNamespace(uuid={index: uuid}[i]))
    assert device_label("cpu") == "cpu" and calls == []
    if want is None:
        with pytest.raises(RuntimeError, match="GPU-cccc"):
            device_label(torch.device("cuda", index))
    else:
        assert device_label(torch.device("cuda", index)) == want
    assert calls == [["nvidia-smi", "--query-gpu=uuid,name,power.limit",
                      "--format=csv,noheader"]]


def test_valid_regimes_and_stats_match_jax():
    assert (tc.VALID_REGIMES, tc.VALID_STATS) == (jc.VALID_REGIMES, jc.VALID_STATS)
