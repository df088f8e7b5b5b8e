"""The port's bounce layer (``bdlz_tpu_torch/bounce``, ``ops/bounce_kernel``,
``bounce_cli``) against the JAX package, on the CPU.

* potential: vacua, closed forms and fingerprints bitwise / equal strings;
* the plain shoot (the kernel's plain version) at reduced knobs against
  ``bdlz_tpu.bounce.solve_bounce`` at the same knobs: φ₀ and r_wall
  ≤ 1e-10, action ≤ 1e-8, ``converged`` equal.  The full-knob plain shoot
  takes minutes on the CPU and runs on the card as a kernel instead;
* the ``bounce=`` doors (``run_sweep``, ``validation.bounce_audit``,
  ``bounce_cli``) through a shoot monkeypatched to return JAX's reference
  solution: that holds the wiring (fingerprints, profile, P) without a
  minutes-long CPU shoot;
* the constants ``chip_smoke.py`` checks the card's shoot against equal
  JAX's reference shoot.
"""
import json
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

from bdlz_tpu import bounce as jb
from bdlz_tpu import validation as jv
from bdlz_tpu.bounce import shooting as jsh
from bdlz_tpu.lz import sweep_bridge as jsb

from bdlz_tpu_torch import bounce as tb
from bdlz_tpu_torch import validation as tv
from bdlz_tpu_torch.bounce import potential as tpot
from bdlz_tpu_torch.bounce import shooting as tsh
from bdlz_tpu_torch.lz import sweep_bridge as tsb
from bdlz_tpu_torch.ops import bounce_kernel as bk

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = "cpu"
#: a second potential beside the reference: thicker wall, larger tilt
OTHER = (0.8, 1.1, 0.09, 1.3, 0.04)


def record(name, value):
    """Print a residual (``pytest -s`` shows the lines PERF.md records)."""
    print(f"RESIDUAL {name} {value!r}")
    return value


def j_spec(t):
    return jb.PotentialSpec(*t)


def t_spec(t):
    return tb.PotentialSpec(*t)


# ---- the potential ---------------------------------------------------------

def test_reference_constants_are_bit_for_bit_jax():
    for name in ("REFERENCE_LAMBDA4", "REFERENCE_VEV", "REFERENCE_EPSILON",
                 "REFERENCE_G_DELTA", "REFERENCE_V_WALL", "REFERENCE_P_CHI_TO_B",
                 "REFERENCE_M_MIX0"):
        assert getattr(tpot, name) == getattr(jb.potential, name), name
    assert tuple(tb.reference_potential()) == tuple(jb.reference_potential())
    for name in ("DEFAULT_RHO0", "DEFAULT_RHO_MAX", "DEFAULT_N_SEGMENTS", "DEFAULT_N_BISECT",
                 "DEFAULT_N_DENSE", "DEFAULT_N_XI", "DEFAULT_XI_HALFWIDTH_WALLS",
                 "DEFAULT_LANE_WIDTH", "_OVERSHOOT_FRAC", "_UNDERSHOOT_V_TOL", "_SETTLE_FRAC",
                 "_HI_OFFSET_FRAC"):
        assert getattr(tsh, name) == getattr(jsh, name), name


@pytest.mark.parametrize("spec", [tuple(jb.reference_potential()), OTHER,
                                  (0.3, 2.0, 0.5, 0.7, 0.0)])
def test_vacua_closed_forms_and_fingerprint_match_jax(spec):
    assert tb.vacua(t_spec(spec)) == jb.vacua(j_spec(spec))
    for fn in ("wall_width_mu", "wall_tension", "thin_wall_radius", "thin_wall_action"):
        assert getattr(tb, fn)(t_spec(spec)) == getattr(jb, fn)(j_spec(spec)), fn
    assert tb.potential_fingerprint(t_spec(spec)) == jb.potential_fingerprint(j_spec(spec))
    phi = np.linspace(-1.5, 1.5, 31)
    for fn in ("potential_V", "potential_dV"):
        assert np.array_equal(getattr(tb, fn)(phi, *spec[:3]), getattr(jb, fn)(phi, *spec[:3]))


@pytest.mark.parametrize("bad", [
    {"lam4": -1.0}, {"vev": 0.0}, {"eps": 0.0}, {"g_delta": 0.0}, {"m_mix0": -0.1},
    {"eps": 10.0}, {"lam4": float("nan")},
])
def test_invalid_specs_raise_what_jax_raises(bad):
    d = dict(jb.reference_potential()._asdict(), **bad)
    with pytest.raises(jb.PotentialError) as j:
        jb.as_potential_spec(d)
    with pytest.raises(tb.PotentialError) as t:
        tb.as_potential_spec(d)
    assert str(t.value) == str(j.value)


def test_potential_json_round_trip_and_mapping_errors(tmp_path):
    path = str(tmp_path / "pot.json")
    tb.write_potential_json(path, t_spec(OTHER))
    assert tb.load_potential_json(path) == t_spec(OTHER)
    assert tuple(jb.load_potential_json(path)) == OTHER
    with pytest.raises(tb.PotentialError, match="exactly the keys"):
        tb.as_potential_spec({"lam4": 0.5})
    (tmp_path / "bad.json").write_text("[1, 2]")
    with pytest.raises(tb.PotentialError, match="object"):
        tb.load_potential_json(str(tmp_path / "bad.json"))


# ---- the plain shoot at reduced knobs ---------------------------------------

KNOBS = dict(n_bisect=3, n_dense=2048, lane_width=2)


@pytest.fixture(scope="module")
def reduced_pair():
    specs = [tuple(jb.reference_potential()), OTHER]
    j = jb.solve_bounce_batch([j_spec(s) for s in specs], **KNOBS)
    t = tb.solve_bounce_batch([t_spec(s) for s in specs], device=CPU, **KNOBS)
    return j, t


def test_plain_shoot_matches_jax_at_reduced_knobs(reduced_pair):
    j, t = reduced_pair
    assert np.array_equal(t.converged, j.converged)
    assert record("shoot_phi0", np.max(np.abs(t.phi0 / j.phi0 - 1.0))) <= 1e-10
    ok = np.isfinite(j.r_wall)
    assert np.array_equal(ok, np.isfinite(t.r_wall))
    assert record("shoot_r_wall", np.max(np.abs(t.r_wall[ok] / j.r_wall[ok] - 1.0),
                                         initial=0.0)) <= 1e-10
    assert record("shoot_action", np.max(np.abs(t.action / j.action - 1.0))) <= 1e-8
    # XLA contracts ρ₀ + h·k into one FMA; the port rounds twice
    assert np.max(np.abs(t.rho / j.rho - 1.0)) <= 1e-15
    assert t.phi.shape == j.phi.shape == (2, KNOBS["n_dense"] + 1)
    assert record("shoot_phi_abs", np.max(np.abs(t.phi - j.phi))) <= 1e-10


@pytest.fixture(scope="module")
def plain_depths():
    """``shoot_plain`` at the reduced knobs at tree depths 1, 2 and 3."""
    rows = torch.as_tensor(np.stack([tsh._params_row(tb.reference_potential()),
                                     tsh._params_row(t_spec(OTHER))]))
    knobs = tsh.make_knobs(**KNOBS)
    return {d: tsh.shoot_plain(rows, knobs, depth=d, stats=True) for d in (1, 2, 3)}


def _same(a, b):
    return torch.equal(a, b) if not a.is_floating_point() else bool(
        torch.equal(torch.isnan(a), torch.isnan(b))
        and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


@pytest.mark.parametrize("depth", [2, 3])
def test_plain_tree_shoot_is_the_serial_shoot_bitwise(depth, plain_depths, reduced_pair):
    serial, serial_stats = plain_depths[1]
    tree, stats = plain_depths[depth]
    for f in tsh.ShootOut._fields:
        assert _same(getattr(tree, f), getattr(serial, f)), f
    j, _t = reduced_pair
    assert np.max(np.abs(tree.phi0.numpy() / j.phi0 - 1.0)) <= 1e-10
    assert np.max(np.abs(tree.action.numpy() / j.action - 1.0)) <= 1e-8
    assert np.array_equal(tree.converged.numpy(), j.converged)
    # one round per halving at depth 1; fewer, longer-fanned rounds deeper
    assert serial_stats[:, 0].tolist() == serial_stats[:, 1].tolist() == serial.steps.tolist()
    assert stats[:, 2].tolist() == [depth] * 2
    assert stats[:, 3].tolist() == [-(-KNOBS["n_bisect"] // depth)] * 2
    assert bool((stats[:, 0] <= tree.steps).all() and (tree.steps <= stats[:, 1]).all())


def _serial_bisection(lo, hi, n_bisect, classify):
    """The serial loop the tree must reproduce, written out."""
    ok = torch.ones_like(lo, dtype=torch.bool)
    steps = torch.zeros_like(lo, dtype=torch.int64)
    segments = torch.zeros_like(steps)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        v, ok_i, st, sg = (t[:, 0] for t in classify(mid[:, None]))
        lo, hi = torch.where(v < 0, mid, lo), torch.where(v < 0, hi, mid)
        ok, steps, segments = ok & ok_i, steps + st, segments + sg
    return lo, hi, ok, steps, segments


def _synthetic(pattern, c):
    """A classifier of release points with no ODE: the verdict, ok and the
    two counters are functions of the midpoint's bits alone."""
    def classify(mids):
        bits = mids.view(torch.int64)
        if pattern == "sign":
            v = torch.where(mids < c[:, None], -1, 1)
        elif pattern == "hash":
            v = torch.where(bits % 3 == 0, 1, -1)
        else:
            v = torch.full_like(bits, -1 if pattern == "under" else 1)
        return v, bits % 4 != 0, bits % 1000 + 1, bits % 13 + 1
    return classify


@pytest.mark.parametrize("pattern", ["sign", "hash", "under", "over"])
@pytest.mark.parametrize("depth", range(1, 7))
@pytest.mark.parametrize("n_bisect", range(1, 13))
def test_bisect_tree_is_the_serial_bisection_bitwise(n_bisect, depth, pattern):
    rng = np.random.default_rng(1000 * n_bisect + depth)
    lo = torch.as_tensor(rng.uniform(0.1, 0.5, 5))
    hi = lo + torch.as_tensor(rng.uniform(0.01, 0.5, 5))
    c = torch.as_tensor(rng.uniform(lo.numpy(), hi.numpy()))
    classify = _synthetic(pattern, c)
    s_lo, s_hi, s_ok, s_steps, s_segs = _serial_bisection(lo, hi, n_bisect, classify)
    walk = tsh.bisect_tree(lo, hi, n_bisect, depth, classify)
    assert torch.equal(walk.lo.view(torch.int64), s_lo.view(torch.int64))
    assert torch.equal(walk.ok, s_ok)
    assert torch.equal(walk.steps, s_steps) and torch.equal(walk.segments, s_segs)
    assert walk.rounds == -(-n_bisect // depth)
    assert bool((walk.critical_steps <= walk.total_steps).all())
    assert bool((walk.steps <= walk.total_steps).all())
    if depth == 1:
        assert torch.equal(walk.critical_steps, s_steps) and torch.equal(walk.total_steps,
                                                                          s_steps)


@pytest.mark.parametrize("depth", [2, 3, 5])
def test_bisect_tree_ignores_a_failed_node_off_the_path(depth):
    """Every node off the chosen path fails; the path's ok stays true."""
    rng = np.random.default_rng(depth)
    lo = torch.as_tensor(rng.uniform(0.1, 0.5, 4))
    hi = lo + 0.3
    c = lo + torch.as_tensor(rng.uniform(0.0, 0.3, 4))
    sign = _synthetic("sign", c)
    path = set()

    def record_path(mids):
        out = sign(mids)
        path.update(mids.view(torch.int64).flatten().tolist())
        return out

    n_bisect = 7
    _serial_bisection(lo, hi, n_bisect, record_path)
    seen_fail = []

    def classify(mids):
        v, _ok, st, sg = sign(mids)
        on = torch.tensor([[b in path for b in row] for row in mids.view(torch.int64).tolist()])
        seen_fail.append(bool((~on).any()))
        return v, on, st, sg

    walk = tsh.bisect_tree(lo, hi, n_bisect, depth, classify)
    assert any(seen_fail) and bool(walk.ok.all())
    assert torch.equal(walk.lo, _serial_bisection(lo, hi, n_bisect, sign)[0])


def test_plain_batch_equals_the_scalar_loop_bitwise():
    specs = [t_spec(OTHER), tb.reference_potential()]
    kn = dict(n_bisect=1, n_dense=256, lane_width=2)
    batch = tb.solve_bounce_batch(specs, device=CPU, **kn)
    loop = tb.solve_bounce_scalar_loop(specs, device=CPU, **kn)
    for f in tsh.BounceSolution._fields:
        assert np.array_equal(getattr(batch, f), getattr(loop, f), equal_nan=True), f


def test_classify_counts_what_it_ran():
    knobs = tsh.make_knobs()
    row = torch.as_tensor(tsh._params_row(tb.reference_potential())[None])
    phi_top, phi_true = float(row[0, 4]), float(row[0, 5])
    out = bk.bounce_classify(row, torch.tensor([0.5 * (phi_top + phi_true)],
                                               dtype=torch.float64), knobs)
    assert out.verdict.tolist() == [-1] and bool(out.ok)
    assert 1 <= int(out.segments) <= knobs.n_segments and int(out.steps) > int(out.segments)
    assert torch.isfinite(out.y_first).all() and torch.isfinite(out.y_end).all()


def test_wrappers_on_the_cpu_launch_nothing_and_check_inputs():
    knobs = tsh.make_knobs(n_bisect=1, n_dense=64)
    row = torch.as_tensor(tsh._params_row(tb.reference_potential())[None])
    bk.reset_launches()
    out = bk.bounce_shoot(row, knobs)
    assert out.phi.shape == (1, 65) and out.converged.dtype == torch.bool
    with_stats, stats = bk.bounce_shoot(row, knobs, stats=True)
    serial = bk.bounce_shoot_serial(row, knobs)
    for f in tsh.ShootOut._fields:
        assert _same(getattr(with_stats, f), getattr(out, f)), f
        assert _same(getattr(serial, f), getattr(out, f)), f
    assert stats.shape == (1, len(bk.STATS_FIELDS)) and stats[0, 2:].tolist() == [1, 1]
    assert bk.LAUNCHES == {"shoot": 0, "shoot_serial": 0, "classify": 0}
    with pytest.raises(ValueError, match="depth"):
        bk.bounce_shoot(row, knobs, depth=0)
    with pytest.raises(ValueError, match="CUDA"):
        bk.f64_latency_probe("cpu")
    with pytest.raises(ValueError):
        bk.bounce_shoot(row[:, :5].contiguous(), knobs)
    with pytest.raises(TypeError):
        bk.bounce_shoot(row.float(), knobs)
    with pytest.raises(ValueError):
        bk.bounce_classify(row, torch.zeros(2, dtype=torch.float64), knobs)
    with pytest.raises(tb.BounceSolveError, match="lane_width"):
        tsh.make_knobs(lane_width=0)
    with pytest.raises(tb.BounceSolveError, match="at least one"):
        tb.solve_bounce_batch([], device=CPU)


def test_solver_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.solve_bounce(tb.reference_potential())


# ---- the doors through a monkeypatched shoot ------------------------------

@pytest.fixture(scope="module")
def jax_reference():
    return jb.solve_bounce(jb.reference_potential())


@pytest.fixture
def patched_shoot(monkeypatch, jax_reference):
    """The port's shoot returns JAX's full-knob reference solution."""
    calls = []

    def fake(spec, **kw):
        assert tuple(tb.as_potential_spec(spec)) == tuple(jb.reference_potential())
        calls.append(kw)
        return tsh.BounceSolution(*(np.asarray(a) for a in jax_reference))

    monkeypatch.setattr(tsh, "solve_bounce", fake)
    monkeypatch.setattr(tb, "solve_bounce", fake)
    return calls


def test_bounce_profile_and_P_match_jax(patched_shoot, jax_reference):
    t_prof = tb.bounce_profile(tb.reference_potential(), device=CPU)
    j_prof = jb.bounce_profile(jb.reference_potential(), solution=jax_reference)
    for f in ("xi", "delta", "mix"):
        assert np.array_equal(getattr(t_prof, f), getattr(j_prof, f))
    assert tsb.profile_fingerprint(t_prof) == jsb.profile_fingerprint(j_prof)
    P = tb.bounce_probabilities(tb.reference_potential(), [0.3], device=CPU)
    assert P[0] == tpot.REFERENCE_P_CHI_TO_B
    assert patched_shoot


@pytest.mark.parametrize("ulps", [0, 1, 2, 4])
def test_wall_sample_tie_does_not_move_P(ulps, jax_reference):
    """r_wall a few ulps below JAX's leaves the centre sample's Δ residue
    positive; JAX's profile then takes the wall slope from the other
    segment and P moves 1.6e-5.  The port rounds r_wall up past the
    crossing, so P stays the archived value."""
    r = float(jax_reference.r_wall)
    for _ in range(ulps):
        r = float(np.nextafter(r, -np.inf))
    j_sol = jax_reference._replace(r_wall=np.float64(r))
    t_sol = tsh.BounceSolution(*(np.asarray(a) for a in j_sol))
    t_prof = tb.bounce_profile(tb.reference_potential(), solution=t_sol)
    j_prof = jb.bounce_profile(jb.reference_potential(), solution=j_sol)
    P_t = tsb.probabilities_for_points(t_prof, [0.3], "local")[0]
    P_j = jsb.probabilities_for_points(j_prof, np.asarray([0.3]), "local")[0]
    assert t_prof.delta[400] < 0.0
    assert abs(P_t / tpot.REFERENCE_P_CHI_TO_B - 1.0) <= 1e-12
    assert (P_j == P_t) if ulps == 0 else abs(P_j / P_t - 1.0) > 1e-5


def test_bounce_profile_rejections():
    sol = tsh.BounceSolution(np.float64(1.0), np.float64(5.0), np.float64(1.0),
                             np.bool_(False), np.linspace(0, 10, 11), np.zeros(11),
                             np.zeros(11))
    with pytest.raises(tb.BounceSolveError, match="did not converge"):
        tb.bounce_profile(tb.reference_potential(), solution=sol)
    with pytest.raises(tb.BounceSolveError, match="escapes"):
        tb.bounce_profile(tb.reference_potential(), solution=sol._replace(
            converged=np.bool_(True)))
    batched = sol._replace(phi0=np.zeros(2))
    with pytest.raises(tb.BounceSolveError, match="batched"):
        tb.bounce_profile(tb.reference_potential(), solution=batched)


def test_bounce_audit_matches_jax(patched_shoot):
    t = tv.bounce_audit(device=CPU)
    j = jv.bounce_audit()
    assert t.ok and j.ok and t.n_crossings == j.n_crossings == 1
    assert t.P_vs_archived == j.P_vs_archived == 0.0
    assert record("bounce_audit.action_vs_thin_wall",
                  abs(t.action_vs_thin_wall - j.action_vs_thin_wall)) <= 1e-10
    tight = tv.bounce_audit(rtol_action=0.01, device=CPU)
    assert not tight.ok and "action vs thin-wall" in tight.reason


def test_sweep_bounce_door_matches_jax(patched_shoot, jit_warmup):
    from bdlz_tpu.config import config_from_dict as j_cfg
    from bdlz_tpu.config import static_choices_from_config as j_static
    from bdlz_tpu.parallel.sweep import run_sweep as j_run_sweep

    from bdlz_tpu_torch.config import config_from_dict, static_choices_from_config
    from bdlz_tpu_torch.parallel.sweep import run_sweep

    cfg = {"regime": "nonthermal", "P_chi_to_B": None, "source_shape_sigma_y": 9.0,
           "incident_flux_scale": 1.07e-9, "Y_chi_init": 4.90e-10, "quad_panel_gl": False}
    axes = {"v_w": np.linspace(0.1, 0.9, 6), "m_chi_GeV": [0.5, 0.95]}
    kw = dict(chunk_size=12, n_y=2000, impl="tabulated", lz_method="coherent")
    spec = dict(jb.reference_potential()._asdict())
    jc = j_cfg(cfg)
    jit_warmup(j_run_sweep, jc, axes, j_static(jc), bounce=spec, **kw)
    ref = j_run_sweep(jc, axes, j_static(jc), bounce=spec, **kw)
    tc = config_from_dict(cfg)
    got = run_sweep(tc, axes, static_choices_from_config(tc), bounce=spec, device=CPU, **kw)
    for f, r in ref.outputs.items():
        assert record(f"sweep[bounce].{f}",
                      np.max(np.abs(got.outputs[f] - r) / np.abs(r))) <= 1e-10, f
    j_prof = jb.bounce_profile(jb.reference_potential())
    assert got.lz_identity == {"lz_profile": jsb.profile_fingerprint(j_prof),
                               "lz_method": "coherent",
                               "bounce": jb.potential_fingerprint(jb.reference_potential())}
    assert patched_shoot[-1] == {"device": torch.device("cpu")}


def _cli(main, argv, capsys):
    capsys.readouterr()
    code = main(argv)
    return code, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bounce_cli_audit_matches_jax(patched_shoot, capsys):
    from bdlz_tpu.bounce_cli import main as j_main

    from bdlz_tpu_torch.bounce_cli import main as t_main

    jc, jo = _cli(j_main, ["--audit"], capsys)
    tc, to = _cli(t_main, ["--audit", "--device", "cpu"], capsys)
    assert tc == jc == 0 and list(to) == list(jo)
    assert to["ok"] and to["n_crossings"] == 1
    assert abs(to["action_vs_thin_wall"] - jo["action_vs_thin_wall"]) <= 1e-10


@pytest.mark.parametrize("schema", ["delta", "matrix"])
def test_bounce_cli_profile_and_P_match_jax(schema, patched_shoot, tmp_path, capsys):
    from bdlz_tpu.bounce_cli import main as j_main

    from bdlz_tpu_torch.bounce_cli import main as t_main

    pot = str(tmp_path / "pot.json")
    tb.write_potential_json(pot, tb.reference_potential())
    args = ["--bounce", pot, "--v-w", "0.3", "--schema", schema]
    jc, jo = _cli(j_main, args + ["--out", str(tmp_path / "j.csv")], capsys)
    tc, to = _cli(t_main, args + ["--out", str(tmp_path / "t.csv"), "--device", "cpu"],
                  capsys)
    assert tc == jc == 0 and list(to) == list(jo)
    for k in ("potential", "fingerprint", "converged", "phi0", "r_wall", "action",
              "thin_wall_S4", "thin_wall_R", "profile_fingerprint", "v_w", "P_chi_to_B",
              "schema"):
        assert to[k] == jo[k], k
    assert to["P_chi_to_B"] == tpot.REFERENCE_P_CHI_TO_B
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def test_bounce_cli_exit_codes_match_jax(tmp_path, capsys, monkeypatch, jax_reference):
    from bdlz_tpu.bounce_cli import main as j_main

    from bdlz_tpu_torch.bounce_cli import main as t_main

    for argv in (["--audit", "--v-w", "0.3"], []):
        for main in (j_main, t_main):
            with pytest.raises(SystemExit) as exc:
                main(argv)
            assert exc.value.code == 2
    # a shoot that did not converge: the summary still lands, exit 1
    bad = tsh.BounceSolution(*(np.asarray(a) for a in jax_reference))._replace(
        converged=np.bool_(False))
    monkeypatch.setattr(tb, "solve_bounce", lambda spec, **kw: bad)
    pot = str(tmp_path / "pot.json")
    tb.write_potential_json(pot, tb.reference_potential())
    code, out = _cli(t_main, ["--bounce", pot, "--device", "cpu"], capsys)
    assert code == 1 and out["converged"] is False and "profile_fingerprint" not in out


# ---- the constants chip_smoke holds the card against ------------------------

def test_chip_smoke_constants_are_jax_reference_shoot(jax_reference):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    ref = chip_smoke.BOUNCE_REFERENCE
    assert ref["phi0"] == float(jax_reference.phi0)
    assert ref["r_wall"] == float(jax_reference.r_wall)
    assert ref["action"] == float(jax_reference.action)
    prof = jb.bounce_profile(jb.reference_potential(), solution=jax_reference)
    P = jsb.probabilities_for_points(prof, np.asarray([0.3]), method="local")[0]
    assert ref["P_at_v_w_0.3"] == P == jb.potential.REFERENCE_P_CHI_TO_B
    assert math.isfinite(ref["action"]) and bool(jax_reference.converged)
