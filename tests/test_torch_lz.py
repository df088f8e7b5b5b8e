"""The port's two-channel LZ layer (``bdlz_tpu_torch/lz``: profile, kernel,
thermal rate, momentum average, P-tables) against the JAX package, on the
CPU, with inputs made from a seed with numpy.

Tolerances (the port's residuals are recorded in PERF.md):
* profile arrays, crossings, fingerprints: bitwise / equal strings;
* local P, λ_eff, the thermal rate, the k-quadrature: ≤ 1e-14 relative;
* coherent and dephased P, the P-tables and their evaluators: ≤ 1e-10;
* momentum average: local and coherent ≤ 1e-12, dephased ≤ 1e-10;
* the thermal cold limit against the port's own coherent P, and the
  plain Bloch tree at a rate per speed against one call per rate: bitwise.
"""
import numpy as np
import pytest
import torch

from bdlz_tpu.lz import kernel as jk
from bdlz_tpu.lz import momentum as jm
from bdlz_tpu.lz import profile as jp
from bdlz_tpu.lz import sweep_bridge as jsb
from bdlz_tpu.lz import thermal as jt

from bdlz_tpu_torch.lz import kernel as tk
from bdlz_tpu_torch.lz import momentum as tm
from bdlz_tpu_torch.lz import profile as tp
from bdlz_tpu_torch.lz import sweep_bridge as tsb
from bdlz_tpu_torch.lz import thermal as tt

CPU = "cpu"


def linear(mod, alpha=1.0, kappa=0.1, L=200.0, N=40000):
    """tests/test_lz.py:20, the single-crossing linear profile."""
    xi = np.linspace(-L, L, N)
    return mod.BounceProfile(xi=xi, delta=alpha * xi, mix=np.full_like(xi, kappa))


def two_crossing(mod, alpha=0.1, kappa=0.34, x0=20.0, N=40001):
    """tests/test_lz.py:384, Δ = α(ξ² − x0²): two crossings at ±x0."""
    xi = np.linspace(-2.0 * x0, 2.0 * x0, N)
    return mod.BounceProfile(xi=xi, delta=alpha * (xi * xi - x0 * x0),
                             mix=np.full_like(xi, kappa))


def seeded(mod, seed=3, N=257):
    """A wiggly profile with several crossings, drawn from a seed."""
    rng = np.random.default_rng(seed)
    xi = np.sort(rng.uniform(-30.0, 30.0, N))
    delta = 0.3 * xi * np.sin(0.2 * xi) + rng.normal(0.0, 0.05, N)
    mix = 0.1 + 0.05 * np.cos(0.1 * xi)
    return mod.BounceProfile(xi=xi, delta=delta, mix=mix)


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def record(name, value):
    """Print a residual (``pytest -s`` shows the lines PERF.md records)."""
    print(f"RESIDUAL {name} {value!r}")
    return value


def _csv(tmp_path, text, name="p.csv"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


# ---- profile ingestion ----------------------------------------------------

@pytest.mark.parametrize("schema", ["delta", "matrix"])
def test_loaded_profile_is_bitwise_jax(tmp_path, schema):
    path = str(tmp_path / f"{schema}.csv")
    tp.write_profile_csv(path, seeded(tp), schema=schema)
    a, b = tp.load_profile_csv(path), jp.load_profile_csv(path)
    for f in ("xi", "delta", "mix"):
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes()
    # the written file re-ingests bit for bit
    assert tp.load_profile_csv(path).delta.tobytes() == seeded(tp).delta.tobytes()


def test_written_csv_is_the_jax_bytes(tmp_path):
    tp.write_profile_csv(str(tmp_path / "t.csv"), seeded(tp), schema="matrix")
    jp.write_profile_csv(str(tmp_path / "j.csv"), seeded(jp), schema="matrix")
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


@pytest.mark.parametrize("text", [
    "xi,foo\n0,1\n1,2\n",                               # schema
    "xi,delta,m_mix\n0,1,0.1\n",                        # one row
    "xi,delta,m_mix\n1.0,2.0,0.2\n-1.0,-2.0,0.1\n",     # not increasing
    "xi,delta,m_mix\n0,1,0.1\n1,1,0.1\n1,2,0.1\n",      # duplicate, data row 3
    "delta,m_mix\n0,1\n1,2\n",                          # no xi
    "xi,delta,m_mix\n0,1,0.1\n1,inf,0.1\n",             # non-finite
])
def test_profile_errors_say_what_jax_says(tmp_path, text):
    path = _csv(tmp_path, text)
    with pytest.raises(jp.ProfileError) as j:
        jp.load_profile_csv(path)
    with pytest.raises(tp.ProfileError) as t:
        tp.load_profile_csv(path)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("make", [linear, two_crossing, seeded])
def test_crossings_and_fingerprint_are_bitwise_jax(make):
    a, b = tp.find_crossings(make(tp)), jp.find_crossings(make(jp))
    for f in ("xi_star", "slope", "mix"):
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes()
    assert tsb.profile_fingerprint(make(tp)) == jsb.profile_fingerprint(make(jp))


# ---- the local composition, the thermal rate, the k-quadrature ----------

@pytest.mark.parametrize("make", [linear, two_crossing, seeded])
def test_local_lambda_and_P_match_jax(make):
    for v in (0.05, 0.3, 0.95):
        assert rel(tk.lambda_eff_from_profile(make(tp), v),
                   jk.lambda_eff_from_profile(make(jp), v)) <= 1e-14
    vs = np.random.default_rng(1).uniform(0.01, 0.99, 64)
    assert record(f"local_P[{make.__name__}]", rel(
        tsb.probabilities_for_points(make(tp), vs, "local"),
        jsb.probabilities_for_points(make(jp), vs, "local"))) <= 1e-14


def test_thermal_rate_matches_jax_and_keeps_nan():
    T = np.concatenate([np.geomspace(1e-3, 1e3, 41), [0.0, -1.0, np.nan]])
    got, ref = tt.thermal_gamma_phi(T, 0.3, 2.0), jt.thermal_gamma_phi(T, 0.3, 2.0)
    assert np.array_equal(np.isnan(got), np.isnan(ref)) and np.isnan(got[-1])
    ok = ~np.isnan(ref)
    assert record("thermal_gamma_phi", rel(got[ok][ref[ok] != 0], ref[ok][ref[ok] != 0])) <= 1e-14
    assert np.array_equal(got[ok] == 0.0, ref[ok] == 0.0)
    assert tt.thermal_gamma_phi(0.0, 0.3, 2.0) == 0.0
    assert tt.thermal_method_for(0.0) == ("coherent", 0.0)
    with pytest.raises(ValueError):
        tt.validate_bath(-1.0, 1.0)


@pytest.mark.parametrize("v_w,T,m", [(0.3, 100.0, 0.95), (0.9, 30.0, 50.0),
                                     (0.05, 10.0, 0.0), (0.6, 1.0, 20.0)])
def test_k_quadrature_matches_jax(v_w, T, m):
    for a, b in zip(tm._k_quadrature(v_w, T, m, 128), jm._k_quadrature(v_w, T, m, 128)):
        assert a.shape == b.shape
        nz = b != 0.0
        assert np.array_equal(a[~nz], b[~nz])
        assert record(f"k_quadrature[{v_w}-{T}-{m}]", rel(a[nz], b[nz])) <= 1e-14


# ---- coherent and dephased transport -------------------------------------

SPEEDS = np.array([0.05, 0.17, 0.3, 0.62, 0.95])


@pytest.mark.parametrize("make", [linear, two_crossing])
def test_coherent_P_matches_jax(make):
    got = tsb.probabilities_for_points(make(tp), SPEEDS, "coherent", device=CPU)
    ref = jsb.probabilities_for_points(make(jp), SPEEDS, "coherent")
    assert record(f"coherent_P[{make.__name__}]", rel(got, ref)) <= 1e-10
    for v in (0.3, 0.95):
        assert rel(tk.transfer_matrix_propagation(make(tp), v, device=CPU)[1],
                   jk.transfer_matrix_propagation(make(jp), v)[1]) <= 1e-10


@pytest.mark.parametrize("gamma", [0.01, 0.2, 3.0])
def test_dephased_P_matches_jax(gamma):
    got = tsb.probabilities_for_points(two_crossing(tp), SPEEDS, "dephased",
                                       gamma_phi=gamma, device=CPU)
    ref = jsb.probabilities_for_points(two_crossing(jp), SPEEDS, "dephased",
                                       gamma_phi=gamma)
    assert record(f"dephased_P[{gamma}]", rel(got, ref)) <= 1e-10
    assert rel(tk.dephased_probability(two_crossing(tp), 0.4, gamma, device=CPU),
               jk.dephased_probability(two_crossing(jp), 0.4, gamma)) <= 1e-10


def test_generic_expm_cross_check_agrees_with_the_quaternions():
    """``torch.linalg.matrix_exp`` segments sit 1.3e-14 from the closed-form
    quaternions here; JAX's vmapped ``expm`` path sits 4.3e-10 from its own
    quaternions, so the port's generic path is held to JAX's quaternion
    result, the accurate one."""
    prof = seeded(tp)
    U, P = tk.transfer_matrix_propagation(prof, 0.4, device=CPU)
    U2, P2 = tk.transfer_matrix_propagation(prof, 0.4, use_generic_expm=True, device=CPU)
    assert np.max(np.abs(U - U2)) <= 1e-12 and abs(P - P2) <= 1e-12
    jU, jP = jk.transfer_matrix_propagation(seeded(jp), 0.4)
    assert np.max(np.abs(U2 - jU)) <= 1e-10 and abs(P2 - jP) <= 1e-10


def test_gamma_zero_bloch_equals_coherent_to_roundoff():
    a, b, dxi = tk._segment_hamiltonians(two_crossing(tp), CPU)
    v = torch.tensor(SPEEDS, dtype=torch.float64)
    q = tk.propagate_quaternion(a, b, dxi, v)
    r = tk.propagate_bloch(a, b, dxi, v, 0.0)
    assert torch.allclose(0.5 * (1.0 - r[:, 2]), q[:, 1] ** 2 + q[:, 2] ** 2,
                          rtol=1e-9, atol=1e-12)
    assert torch.allclose(r.norm(dim=1), torch.ones(len(SPEEDS), dtype=torch.float64),
                          atol=1e-10)


def _bloch_tree_at_one_rate(a, b, dxi, v, gamma_phi):
    """The plain tree as it was written for one scalar rate, the decay
    e^(−max(Γ, 0)·τ) from a Python float."""
    tau = tk._traversal_times(dxi, v)
    Rs = tk._quat_to_rotations(tk._su2_quaternions(a, b, tau))
    decay = torch.exp(-max(float(gamma_phi), 0.0) * tau)
    scale = torch.stack([decay, decay, torch.ones_like(decay)], dim=-1)
    return tk._ordered_tree_product(Rs * scale[..., None], torch.matmul, np.eye(3))[:, :, 2]


@pytest.mark.parametrize("seed", [3, 8])
def test_bloch_plain_with_a_rate_per_speed_is_the_scalar_rate_calls(seed):
    """A (B,) tensor of rates gives every speed the bits of a scalar-rate
    call at its own rate (a negative rate taken as 0), the rates mixed
    and the speeds repeated across them; a float rate given to
    ``propagate_bloch`` keeps the scalar tree's bits."""
    a, b, dxi = tk._segment_hamiltonians(seeded(tp, seed=seed), CPU)
    rng = np.random.default_rng(seed)
    rates = np.array([0.0, 0.01, 0.07, 0.07, 3.0, -0.4])[rng.integers(0, 6, 30)]
    v = torch.tensor(rng.choice(SPEEDS, 30), dtype=torch.float64)
    got = tk.propagate_bloch_plain(a, b, dxi, v, torch.tensor(rates, dtype=torch.float64))
    assert got.shape == (30, 3)
    for i, g in enumerate(rates):
        assert torch.equal(got[i], _bloch_tree_at_one_rate(a, b, dxi, v[i:i + 1], g)[0])
    for g in np.unique(rates):
        sel = torch.as_tensor(rates == g)
        want = _bloch_tree_at_one_rate(a, b, dxi, v[sel], g)
        assert torch.equal(got[sel], want)
        assert torch.equal(tk.propagate_bloch(a, b, dxi, v[sel], float(g)), want)


def test_probability_from_profile_seam_matches_jax(tmp_path):
    path = str(tmp_path / "p.csv")
    tp.write_profile_csv(path, seeded(tp))
    for method, g in (("coherent", 0.0), ("local", 0.0), ("dephased", 0.07)):
        got = tk.probability_from_profile(path, 0.3, method=method, gamma_phi=g, device=CPU)
        ref = jk.probability_from_profile(path, 0.3, method=method, gamma_phi=g)
        assert rel(got, ref) <= (1e-14 if method == "local" else 1e-10), method
    with pytest.raises(ValueError, match="no effect"):
        tk.probability_from_profile(path, 0.3, method="coherent", gamma_phi=0.1, device=CPU)


def test_chunking_does_not_change_a_speed(monkeypatch):
    """Rows are independent and the tail chunk is padded: any budget gives
    the same bits."""
    prof = seeded(tp)
    vs = np.linspace(0.05, 0.95, 37)
    full = tsb.probabilities_for_points(prof, vs, "coherent", device=CPU)
    monkeypatch.setenv("BDLZ_LZ_SPEED_CHUNK_BYTES", str(512 * 8 * 4 * 5))
    assert np.array_equal(tsb.probabilities_for_points(prof, vs, "coherent", device=CPU),
                          full)


def test_thermal_cold_limit_is_the_coherent_kernel_bitwise():
    prof = two_crossing(tp)
    vs = np.geomspace(0.05, 0.95, 9)
    coh = tsb.probabilities_for_points(prof, vs, "coherent", device=CPU)
    cold = tt.thermal_probabilities_for_points(prof, vs, 0.0, 0.4, 1.5, device=CPU)
    eta0 = tt.thermal_probabilities_for_points(prof, vs, 50.0, 0.0, 1.5, device=CPU)
    assert np.array_equal(cold, coh) and np.array_equal(eta0, coh)
    hot = tt.thermal_probabilities_for_points(prof, vs, 50.0, 0.4, 1.5, device=CPU)
    ref = jt.thermal_probabilities_for_points(two_crossing(jp), vs, 50.0, 0.4, 1.5)
    assert rel(hot, ref) <= 1e-10
    assert rel(tt.thermal_probability(prof, 0.3, 50.0, 0.4, 1.5, device=CPU),
               jt.thermal_probability(two_crossing(jp), 0.3, 50.0, 0.4, 1.5)) <= 1e-10


# ---- momentum average -----------------------------------------------------

@pytest.mark.parametrize("method,gamma,tol", [("local", 0.0, 1e-12), ("coherent", 0.0, 1e-12),
                                              ("dephased", 0.05, 1e-10),
                                              ("dephased", 0.0, 1e-12)])
def test_momentum_average_matches_jax(method, gamma, tol):
    t_prof, j_prof = seeded(tp, N=129), seeded(jp, N=129)
    got = tm.momentum_averaged_probability(t_prof, 0.3, 100.0, 0.95, n_k=32, n_mu=8,
                                           method=method, gamma_phi=gamma, device=CPU)
    ref = jm.momentum_averaged_probability(j_prof, 0.3, 100.0, 0.95, n_k=32, n_mu=8,
                                           method=method, gamma_phi=gamma)
    assert record(f"momentum[{method}-{gamma}]", max(rel(got[0], ref[0]),
                                                    rel(got[1], ref[1]))) <= tol


def test_local_momentum_batch_and_sweep_points_match_jax():
    vs = np.array([0.1, 0.3, 0.3, 0.7])
    got = tm.local_momentum_average_batch(seeded(tp), vs, 50.0, 2.0, device=CPU)
    ref = jm.local_momentum_average_batch(seeded(jp), vs, 50.0, 2.0)
    assert rel(got, ref) <= 1e-12
    T = np.array([50.0, 50.0, 80.0, np.nan])
    m = np.array([2.0, 2.0, 2.0, 2.0])
    got = tsb.probabilities_for_points(seeded(tp), vs, "local-momentum", T_p_GeV=T,
                                       m_chi_GeV=m, device=CPU)
    ref = jsb.probabilities_for_points(seeded(jp), vs, "local-momentum", T_p_GeV=T,
                                       m_chi_GeV=m)
    assert np.isnan(got[-1]) and np.isnan(ref[-1])
    assert rel(got[:3], ref[:3]) <= 1e-12
    assert tm.local_momentum_average_batch(seeded(tp), [], 50.0, 2.0, device=CPU).size == 0


# ---- P-tables --------------------------------------------------------------

Q = np.random.default_rng(11).uniform(0.04, 0.99, 16)


@pytest.mark.parametrize("method,kw", [("coherent", {}), ("dephased", {"gamma_phi": 0.05}),
                                       ("local-momentum", {"T_p_GeV": 100.0,
                                                           "m_chi_GeV": 0.95})])
def test_P_table_and_evaluator_match_jax(method, kw):
    import jax.numpy as jnp

    t = tsb.make_P_of_vw_table(seeded(tp), method, 0.05, 0.95, n=64, device=CPU, **kw)
    j = jsb.make_P_of_vw_table(seeded(jp), method, 0.05, 0.95, n=64, **kw)
    assert (t.u0, t.inv_du, t.v_lo, t.v_hi, t.method) == (j.u0, j.inv_du, j.v_lo, j.v_hi,
                                                          j.method)
    assert record(f"P_table[{method}]", rel(t.values.numpy(), j.values)) <= 1e-10
    got = tsb.eval_P_table(Q, t).numpy()
    ref = np.asarray(jsb.eval_P_table(jnp.asarray(Q), j._replace(values=jnp.asarray(j.values)),
                                      jnp))
    assert record(f"eval_P_table[{method}]", rel(got, ref)) <= 1e-10


def test_P_table_2d_and_evaluator_match_jax():
    import jax.numpy as jnp

    t = tsb.make_P_of_vw_gamma_table(seeded(tp), 0.05, 0.95, 0.0, 0.4, n_v=24, n_g=8,
                                     speed_chunk=7, device=CPU)
    j = jsb.make_P_of_vw_gamma_table(seeded(jp), 0.05, 0.95, 0.0, 0.4, n_v=24, n_g=8,
                                     speed_chunk=7)
    assert t.values.shape == (24, 8)
    assert record("P_table_2d", rel(t.values.numpy(), j.values)) <= 1e-10
    gs = np.random.default_rng(2).uniform(-0.1, 0.5, len(Q))
    got = tsb.eval_P_table_2d(Q, gs, t).numpy()
    jt_ = j._replace(values=jnp.asarray(j.values))
    ref = [float(jsb.eval_P_table_2d(jnp.asarray(v), jnp.asarray(g), jt_, jnp))
           for v, g in zip(Q, gs)]
    assert record("eval_P_table_2d", rel(got, ref)) <= 1e-10
    assert tsb.resolve_table2d_shape() == jsb.resolve_table2d_shape() == (16384, 33)


def test_P_table_n_and_evaluator_match_jax():
    import jax.numpy as jnp

    t = tsb.make_P_table_n(seeded(tp), 3, 0.05, 0.95, n=32, device=CPU)
    j = jsb.make_P_table_n(seeded(jp), 3, 0.05, 0.95, n=32)
    assert record("P_table_n_abs", np.max(np.abs(t.values.numpy() - j.values))) <= 1e-10
    got = tsb.eval_P_table_n(Q, t).numpy()
    jt_ = j._replace(values=jnp.asarray(j.values))
    ref = np.stack([np.asarray(jsb.eval_P_table_n(jnp.asarray(v), jt_, jnp)) for v in Q])
    assert np.max(np.abs(got - ref)) <= 1e-10


def test_table_guards_match_jax():
    for bad in (dict(method="local", v_lo=0.1, v_hi=0.9),
                dict(method="coherent", v_lo=0.9, v_hi=0.1),
                dict(method="coherent", v_lo=0.1, v_hi=0.9, n=4)):
        with pytest.raises(ValueError):
            jsb.make_P_of_vw_table(seeded(jp), **bad)
        with pytest.raises(ValueError):
            tsb.make_P_of_vw_table(seeded(tp), device=CPU, **bad)
    with pytest.raises(ValueError):
        tsb.probabilities_for_points(seeded(tp), [0.3], "nope", device=CPU)
    with pytest.raises(ValueError, match="local-momentum"):
        tsb.probabilities_for_points(seeded(tp), [0.3], "local-momentum", device=CPU)


def test_lz_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsb.probabilities_for_points(seeded(tp), [0.3], "coherent")
    # the analytic local composition needs no device
    assert tsb.probabilities_for_points(seeded(tp), [0.3], "local").shape == (1,)
