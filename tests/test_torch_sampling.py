"""The port's sampling layer against the JAX package's, on the CPU.

Same inputs through both packages, after the ``jit_warmup`` fixture:

* the exact Planck logp ≤1e-12 rel, over the parameter semantics (linear
  and log10 parameters, the baryon mass in GeV, the panel rule, the λ₁
  law, the P(v_w) and P(v_w, Γ_φ) tables), and the emulator-backed logp
  ≤1e-12 rel on a JAX-built artifact;
* gradients ≤1e-9 rel per coordinate, the observable Jacobian, the Fisher
  matrices, the ratio gradient and the field Jacobian ≤1e-9 rel; autograd
  against central finite differences ≤1e-5 (JAX's gate) on the exact and
  the emulator logp, strictly inside the box;
* a walker outside the box leaves the other walkers' gradients finite and
  equal to their single-walker values (nothing reduces across walkers);
* the constructor refusals byte-equal; the diagnostics bitwise equal;
* the stretch move fed JAX's draws for 20 steps: the same accept
  decisions, walkers ≤1e-12;
* the MCMC segment identity: JAX's payload byte for byte without the
  port's random-stream key, another digest with it; a checkpointed chain
  resumes bitwise in the port, and each package refuses the other's chain
  directory as "different run identity".

``pytest -s`` prints the ``RESIDUAL`` lines.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bdlz_tpu import config as jc
from bdlz_tpu import sampling as js
from bdlz_tpu.ops.kjma_table import make_f_table as j_table

from bdlz_tpu_torch import config as tc
from bdlz_tpu_torch import sampling as ts
from bdlz_tpu_torch.ops.kjma_table import make_f_table as t_table
from bdlz_tpu_torch.sampling.ensemble import HalfDraws, make_generator

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
LOGP_RTOL, GRAD_RTOL, FD_TOL, CHAIN_TOL = 1e-12, 1e-9, 1e-5, 1e-12
BOUNDS = {"m_chi_GeV": (0.05, 20.0), "P_chi_to_B": (1e-4, 1.0)}
CPU = "cpu"


@pytest.fixture(scope="module")
def env():
    jb, tb = jc.config_from_dict(ARCHIVED), tc.config_from_dict(ARCHIVED)
    return dict(jb=jb, tb=tb, js=jc.static_choices_from_config(jb),
                ts=tc.static_choices_from_config(tb),
                jt=j_table(jb.I_p, jnp, n=4096), tt=t_table(tb.I_p, n=4096))


def _profile():
    xi = np.linspace(-2.0, 2.0, 201)
    return xi, 2.0 * xi, np.full_like(xi, 0.3)


def _both_logps(env, **kw):
    """The same logp spec through both packages; lz tables are built by
    each package from the same profile."""
    j_kw, t_kw = dict(kw), dict(kw)
    table = t_kw.pop("_table", None)
    j_kw.pop("_table", None)
    if table is not None:
        from bdlz_tpu.lz import profile as jp
        from bdlz_tpu.lz import sweep_bridge as jsb

        from bdlz_tpu_torch.lz import profile as tp
        from bdlz_tpu_torch.lz import sweep_bridge as tsb

        xi, delta, mix = _profile()
        j_prof = jp.BounceProfile(xi=xi, delta=delta, mix=mix)
        t_prof = tp.BounceProfile(xi=xi, delta=delta, mix=mix)
        if table == "coherent":
            j_kw["lz_P_table"] = jsb.make_P_of_vw_table(j_prof, "coherent", 0.1, 0.6, n=256,
                                                        xp=jnp)
            t_kw["lz_P_table"] = tsb.make_P_of_vw_table(t_prof, "coherent", 0.1, 0.6, n=256,
                                                        device=CPU)
        else:
            j_kw["lz_P_table2d"] = jsb.make_P_of_vw_gamma_table(
                j_prof, 0.1, 0.6, 0.0, 0.5, n_v=64, n_g=9, xp=jnp)
            t_kw["lz_P_table2d"] = tsb.make_P_of_vw_gamma_table(
                t_prof, 0.1, 0.6, 0.0, 0.5, n_v=64, n_g=9, device=CPU)
    static_over = t_kw.pop("_static", {})
    j_kw.pop("_static", None)
    jl = js.make_pipeline_logprob(env["jb"], env["js"]._replace(**static_over), env["jt"],
                                  **j_kw)
    tl = ts.make_pipeline_logprob(env["tb"], env["ts"]._replace(**static_over), env["tt"],
                                  device=CPU, **t_kw)
    return jl, tl


LOGP_CASES = {
    "m_P": (dict(param_keys=("m_chi_GeV", "P_chi_to_B"), bounds=BOUNDS, n_y=2000),
            [[0.97, 0.15], [1.5, 0.3], [0.5, 0.05]]),
    "log_m_vw_sigma": (dict(param_keys=("m_chi_GeV", "v_w", "source_shape_sigma_y"),
                            bounds={"m_chi_GeV": (np.log10(0.5), np.log10(2.0))},
                            log_params=("m_chi_GeV",), n_y=2000),
                       [[np.log10(0.97), 0.31, 8.7], [0.1, 0.5, 12.0]]),
    "panel_mB": (dict(param_keys=("m_chi_GeV", "m_B_GeV"), n_y=2000,
                      _static={"quad_panel_gl": True}),
                 [[0.97, 0.938], [2.0, 1.2]]),
    "lambda1": (dict(param_keys=("m_chi_GeV", "v_w"), lz_lambda1=0.05, n_y=2000),
                [[0.97, 0.3], [1.2, 0.45]]),
    "coherent_table": (dict(param_keys=("m_chi_GeV", "v_w"), _table="coherent", n_y=2000),
                       [[0.97, 0.3], [1.1, 0.55]]),
    "gamma_table": (dict(param_keys=("v_w", "lz_gamma_phi"), _table="gamma2d", n_y=2000),
                    [[0.3, 0.1], [0.45, 0.33]]),
}


@pytest.fixture(scope="module")
def logp_pairs(env, jit_warmup):
    pairs = {}
    for name, (kw, pts) in LOGP_CASES.items():
        jl, tl = _both_logps(env, **kw)
        pairs[name] = (jax.jit(jl), jax.jit(jax.grad(jl)), tl, np.asarray(pts, dtype=float))
        jit_warmup(pairs[name][0], jnp.asarray(pts[0], dtype=jnp.float64))
    return pairs


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)))


@pytest.mark.parametrize("name", list(LOGP_CASES))
def test_exact_logp_and_gradient_match_jax(logp_pairs, name):
    j_logp, j_grad, t_logp, pts = logp_pairs[name]
    ref = np.array([float(j_logp(jnp.asarray(p))) for p in pts])
    ref_g = np.stack([np.asarray(j_grad(jnp.asarray(p))) for p in pts])
    got, got_g = ts.make_logp_value_and_grad(t_logp)(pts)
    rel, rel_g = _rel(got.numpy(), ref), _rel(got_g.numpy(), ref_g)
    print(f"RESIDUAL sampling logp[{name}] max_rel={rel:.3e} grad max_rel={rel_g:.3e}")
    assert np.all(np.isfinite(ref))
    assert rel <= LOGP_RTOL and rel_g <= GRAD_RTOL


@pytest.mark.parametrize("name,point", [("m_P", [0.97, 0.15]),
                                        ("log_m_vw_sigma", [np.log10(0.97), 0.31, 8.7]),
                                        ("panel_mB", [0.97, 0.938])])
def test_exact_logp_finite_difference_parity(logp_pairs, name, point):
    rep = ts.gradient_parity(logp_pairs[name][2], np.asarray(point))
    print(f"RESIDUAL sampling fd parity[{name}] max_rel={rep['max_rel_err']:.3e}")
    assert np.isfinite(rep["value"]) and rep["max_rel_err"] <= FD_TOL


@pytest.fixture(scope="module")
def emu_pair(env, tiny_emulator, jit_warmup):
    from bdlz_tpu_torch.emulator import load_artifact

    base, out_dir, j_art, _ = tiny_emulator
    kw = dict(param_keys=("m_chi_GeV", "v_w"),
              bounds={"m_chi_GeV": (0.92, 1.08), "v_w": (0.26, 0.34)})
    jl = js.make_pipeline_logprob(base, jc.static_choices_from_config(base), env["jt"],
                                  emulator=j_art, **kw)
    tl = ts.make_pipeline_logprob(env["tb"], env["ts"], env["tt"], emulator=out_dir,
                                  device=CPU, **kw)
    t_art = load_artifact(out_dir)
    jit_warmup(jax.jit(jl), jnp.asarray([0.97, 0.31]))
    return jax.jit(jl), jax.jit(jax.grad(jl)), tl, t_art


def test_emulator_logp_and_gradient_match_jax(emu_pair):
    """The fast mode on the JAX-built tiny artifact, loaded from its
    directory by the port: logp ≤1e-12, gradient ≤1e-9, −inf outside the
    box; autograd against finite differences ≤1e-5 inside a cell."""
    j_logp, j_grad, t_logp, _ = emu_pair
    pts = np.array([[0.97, 0.31], [1.05, 0.27], [0.93, 0.335], [1.2, 0.3]])
    ref = np.array([float(j_logp(jnp.asarray(p))) for p in pts])
    got, got_g = ts.make_logp_value_and_grad(t_logp)(pts)
    assert np.isneginf(ref[3]) and np.isneginf(got[3].item())
    ref_g = np.stack([np.asarray(j_grad(jnp.asarray(p))) for p in pts[:3]])
    rel, rel_g = _rel(got[:3].numpy(), ref[:3]), _rel(got_g[:3].numpy(), ref_g)
    rep = ts.gradient_parity(t_logp, np.array([0.97, 0.31]), rel_step=1e-7)
    print(f"RESIDUAL sampling emulator logp max_rel={rel:.3e} grad max_rel={rel_g:.3e} "
          f"fd parity {rep['max_rel_err']:.3e}")
    assert rel <= LOGP_RTOL and rel_g <= GRAD_RTOL and rep["max_rel_err"] <= FD_TOL


def test_emulator_logp_refusals_equal_jax(env, tiny_emulator):
    from bdlz_tpu_torch.emulator import EmulatorArtifactError

    base, out_dir, j_art, _ = tiny_emulator
    cases = [dict(param_keys=("m_chi_GeV", "beta_over_H")),
             dict(param_keys=("m_chi_GeV",), lz_lambda1=0.05)]
    for kw in cases:
        with pytest.raises(ValueError) as ref:
            js.make_pipeline_logprob(base, jc.static_choices_from_config(base), env["jt"],
                                     emulator=j_art, **kw)
        with pytest.raises(ValueError) as got:
            ts.make_pipeline_logprob(env["tb"], env["ts"], env["tt"], emulator=out_dir,
                                     device=CPU, **kw)
        assert str(got.value) == str(ref.value)
    stale = tc.config_from_dict(dict(ARCHIVED, incident_flux_scale=2e-9))
    with pytest.raises(EmulatorArtifactError, match="identity mismatch"):
        ts.make_pipeline_logprob(stale, tc.static_choices_from_config(stale), env["tt"],
                                 emulator=out_dir, param_keys=("m_chi_GeV",), device=CPU)


@pytest.mark.parametrize("kw", [
    dict(param_keys=("m_chi_GeV",), lz_lambda1=0.1, lz_P_table=object()),
    dict(param_keys=("lz_gamma_phi",)),
    dict(param_keys=("bogus",)),
    dict(param_keys=("v_w",), lz_P_table2d=object()),
    dict(param_keys=("P_chi_to_B",), lz_lambda1=0.1),
    dict(param_keys=("I_p",)),
], ids=["two_lz", "gamma_no_table", "unknown", "table2d_no_gamma", "P_with_profile", "I_p"])
def test_param_spec_refusals_are_byte_equal(env, kw):
    for make in ("make_pipeline_logprob", "make_pipeline_observables"):
        with pytest.raises(ValueError) as ref:
            getattr(js, make)(env["jb"], env["js"], env["jt"], **kw)
        with pytest.raises(ValueError) as got:
            getattr(ts, make)(env["tb"], env["ts"], env["tt"], device=CPU, **kw)
        assert str(got.value) == str(ref.value)


def test_a_walker_outside_the_box_leaks_nothing(logp_pairs):
    """Four walkers, the third outside the bounds: its logp is −inf; every
    other row's value and gradient are finite and equal to that walker
    evaluated alone."""
    _, _, t_logp, _ = logp_pairs["m_P"]
    vg = ts.make_logp_value_and_grad(t_logp)
    pts = np.array([[0.97, 0.15], [1.5, 0.3], [30.0, 0.2], [0.5, 0.05]])
    lp, g = vg(pts)
    assert np.isneginf(lp[2].item())
    for i in (0, 1, 3):
        lp1, g1 = vg(pts[i:i + 1])
        assert torch.isfinite(g[i]).all()
        assert lp[i].item() == lp1[0].item()
        assert torch.equal(g[i], g1[0]), (i, g[i], g1[0])


@pytest.fixture(scope="module")
def observables(env, jit_warmup):
    keys = ("m_chi_GeV", "v_w", "source_shape_sigma_y")
    jo = js.make_pipeline_observables(env["jb"], env["js"], env["jt"], param_keys=keys)
    to = ts.make_pipeline_observables(env["tb"], env["ts"], env["tt"], param_keys=keys,
                                      device=CPU)
    pts = np.array([[0.97, 0.31, 8.7], [1.4, 0.5, 12.0], [0.6, 0.2, 5.0]])
    jac = js.make_observable_jacobian(jo)
    jit_warmup(jac, jnp.asarray(pts))
    return jo, to, pts, jac


def test_jacobian_fisher_and_ratio_gradient_match_jax(observables):
    jo, to, pts, j_jac = observables
    om_ref, jac_ref = (np.asarray(a) for a in j_jac(jnp.asarray(pts)))
    om, jac = ts.make_observable_jacobian(to)(pts)
    fisher = ts.planck_fisher_information(jac).numpy()
    fisher_ref = np.asarray(js.planck_fisher_information(jnp.asarray(jac_ref)))
    r_ref, rg_ref = (np.asarray(a) for a in js.make_ratio_and_grad(jo)(jnp.asarray(pts)))
    r, rg = ts.make_ratio_and_grad(to)(pts)
    res = {"omega": _rel(om.numpy(), om_ref), "jacobian": _rel(jac.numpy(), jac_ref),
           "fisher": _rel(fisher, fisher_ref), "ratio": _rel(r.numpy(), r_ref),
           "ratio_grad": _rel(rg.numpy(), rg_ref)}
    print("RESIDUAL sampling " + " ".join(f"{k} max_rel={v:.3e}" for k, v in res.items()))
    assert res["omega"] <= LOGP_RTOL and res["ratio"] <= LOGP_RTOL
    assert max(res["jacobian"], res["fisher"], res["ratio_grad"]) <= GRAD_RTOL


def test_field_log10_jacobian_matches_jax_and_refuses_like_it(env):
    names, scales = ("m_chi_GeV", "T_p_GeV", "v_w"), ("log", "log", "lin")
    x = np.array([[0.97, 100.0, 0.31], [1.05, 95.0, 0.27]])
    ref = np.asarray(js.grad.make_field_log10_jacobian(env["jb"], env["js"], env["jt"], names,
                                                      scales, n_y=400)(jnp.asarray(x)))
    got = ts.grad.make_field_log10_jacobian(env["tb"], env["ts"], env["tt"], names, scales,
                                            n_y=400, device=CPU)(x).numpy()
    # T_p is a symmetry of this surface: its column is roundoff (~1e-16 to
    # 1e-23) in both packages, so each entry is held relative to the
    # largest entry of its row
    rel = float(np.max(np.abs(got - ref) / np.max(np.abs(ref), axis=2, keepdims=True)))
    print(f"RESIDUAL sampling field log10 jacobian max_rel (to the row's largest)={rel:.3e}")
    assert rel <= GRAD_RTOL
    chain_j = env["js"]._replace(lz_mode="chain")
    chain_t = env["ts"]._replace(lz_mode="chain")
    for (jst, tst, nm) in ((chain_j, chain_t, names), (env["js"], env["ts"], ("I_p",)),
                           (env["js"], env["ts"], ("bogus",))):
        with pytest.raises(ValueError) as r:
            js.grad.make_field_log10_jacobian(env["jb"], jst, env["jt"], nm, ("lin",) * len(nm))
        with pytest.raises(ValueError) as g:
            ts.grad.make_field_log10_jacobian(env["tb"], tst, env["tt"], nm, ("lin",) * len(nm),
                                              device=CPU)
        assert str(g.value) == str(r.value)


# ---- diagnostics -------------------------------------------------------------

@pytest.mark.parametrize("fn", ["integrated_autocorr_time", "split_rhat",
                                "effective_sample_size", "bulk_ess",
                                "rank_normalized_split_rhat"])
def test_diagnostics_are_bitwise_jax(fn):
    rng = np.random.default_rng(8)
    x = np.zeros((200, 6, 3))
    e = rng.standard_normal(x.shape)
    for t in range(1, 200):
        x[t] = 0.7 * x[t - 1] + e[t]
    np.testing.assert_array_equal(getattr(ts, fn)(x), getattr(js, fn)(x))


# ---- the stretch move ------------------------------------------------------

def _jax_stretch_draws(key, n_steps, W, thin=1):
    """JAX's run_ensemble key tree, replayed into the port's draws."""
    half = W // 2
    out = []
    for key_t in jax.random.split(key, n_steps // thin):
        for k in jax.random.split(key_t, thin):
            halves = []
            for kh in jax.random.split(k):
                k_z, k_j, k_u = jax.random.split(kh, 3)
                halves.append(HalfDraws(
                    torch.as_tensor(np.asarray(jax.random.uniform(k_z, (half,)))),
                    torch.as_tensor(np.asarray(jax.random.randint(k_j, (half,), 0, half))).long(),
                    torch.as_tensor(np.asarray(jax.random.uniform(k_u, (half,))))))
            out.append(tuple(halves))
    return out


def test_stretch_chain_matches_jax_with_its_draws(logp_pairs, env):
    """Twenty steps of eight walkers on the Planck logp: the port's stretch
    move fed JAX's draws makes the same accept decisions (the same
    acceptance count, the same walkers moving) and its walkers are
    ≤1e-12 from JAX's."""
    jl, _ = _both_logps(env, **LOGP_CASES["m_P"][0])
    t_logp = logp_pairs["m_P"][2]
    init = np.column_stack([np.linspace(0.8, 1.2, 8), np.linspace(0.12, 0.18, 8)])
    key = jax.random.PRNGKey(4)
    ref = js.run_ensemble(key, jl, init, n_steps=20)
    draws = _jax_stretch_draws(key, 20, 8)
    got = ts.run_ensemble(t_logp, init, 20, draws=lambda t: draws[t])
    ref_chain = np.asarray(ref.chain)
    moved_ref = np.any(np.diff(ref_chain, axis=0) != 0.0, axis=2)
    moved = np.any(np.diff(got.chain.numpy(), axis=0) != 0.0, axis=2)
    rel = _rel(got.chain.numpy(), ref_chain)
    print(f"RESIDUAL sampling stretch 20 steps walkers max_rel={rel:.3e} accepted "
          f"{int(got.final.n_accept)} of {20 * 8}")
    assert int(got.final.n_accept) == int(ref.final.n_accept)
    np.testing.assert_array_equal(moved, moved_ref)
    assert rel <= CHAIN_TOL


def test_stretch_walker_checks():
    def logp(th):
        return -0.5 * (th * th).sum(dim=-1)

    g = make_generator(0)
    with pytest.raises(ValueError, match="even"):
        ts.run_ensemble(logp, np.zeros((7, 2)), 4, generator=g, device="cpu")
    with pytest.raises(ValueError, match=">= 6 walkers"):
        ts.run_ensemble(logp, np.zeros((4, 2)), 4, generator=g, device="cpu")
    with pytest.raises(ValueError, match="thin"):
        ts.run_ensemble(logp, np.zeros((8, 2)), 5, generator=g, thin=2, device="cpu")


# ---- identity and checkpoints ----------------------------------------------

@pytest.mark.parametrize("extra", [{}, {"static": True}, {"static": True, "sampler": True}])
def test_segment_identity_is_jax_payload_plus_the_rng_key(env, extra):
    from bdlz_tpu.provenance import mcmc_segment_identity as j_ident

    from bdlz_tpu_torch.provenance import MCMC_RNG_STREAM
    from bdlz_tpu_torch.provenance import mcmc_segment_identity as t_ident

    init = np.random.default_rng(1).uniform(size=(8, 2))
    sampler = {"name": "nuts", "mass_matrix": "diag", "target_accept": 0.8,
               "max_tree_depth": 8, "n_warmup": 300}
    args = (init, 3, 100, 50, 2.0, 1, {"config": {"a": 1}})
    jkw = {"static": env["js"]._replace(quad_panel_gl=False)} if extra.get("static") else {}
    tkw = {"static": env["ts"]._replace(quad_panel_gl=False)} if extra.get("static") else {}
    if extra.get("sampler"):
        jkw["sampler"] = tkw["sampler"] = sampler
    ref = j_ident(*args, **jkw)
    plain = t_ident(*args, **tkw)
    assert json.dumps(plain.parts[0][1], sort_keys=True) == json.dumps(ref.parts[0][1],
                                                                       sort_keys=True)
    assert plain.digest(16) == ref.digest(16)
    marked = t_ident(*args, rng=MCMC_RNG_STREAM, **tkw)
    assert marked.parts[0][1]["rng"] == "torch-cpu-mt19937"
    assert marked.digest(16) != ref.digest(16)


def _gauss_logps():
    def j_logp(th):
        return -0.5 * jnp.sum((th - 1.0) ** 2)

    def t_logp(th):
        return -0.5 * ((th - 1.0) ** 2).sum(dim=-1)

    return j_logp, t_logp


def test_checkpointed_stretch_chain_resumes_bitwise(tmp_path, capsys):
    """Cut after segment 1 and resumed: bitwise the uninterrupted chain; a
    missing middle segment is recomputed; the full rerun resumes all."""
    import os

    _, logp = _gauss_logps()
    init = 1.0 + 0.1 * np.random.default_rng(2).normal(size=(8, 2))
    kw = dict(n_steps=30, checkpoint_every=10, identity={"c": 1}, device="cpu")
    full = ts.run_ensemble_checkpointed(5, logp, init, out_dir=str(tmp_path / "full"), **kw)
    assert full.segments == 3 and full.resumed_segments == 0 and full.chain.shape == (30, 8, 2)
    again = ts.run_ensemble_checkpointed(5, logp, init, out_dir=str(tmp_path / "full"), **kw)
    assert again.resumed_segments == 3
    np.testing.assert_array_equal(again.chain, full.chain)
    os.remove(tmp_path / "full" / "seg_00001.npz")
    healed = ts.run_ensemble_checkpointed(5, logp, init, out_dir=str(tmp_path / "full"), **kw)
    assert healed.resumed_segments == 1 and "unreadable" in capsys.readouterr().err
    np.testing.assert_array_equal(healed.chain, full.chain)
    assert healed.acceptance == full.acceptance
    one = ts.run_ensemble(logp, init, 10, generator=make_generator(5, 0), device="cpu")
    np.testing.assert_array_equal(one.chain.numpy(), full.chain[:10])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_the_other_packages_chain_directory_is_refused(writer, tmp_path, capsys):
    """Same seed, init, identity and lengths: the digests differ by the
    port's random-stream key, so the reader recomputes from scratch and
    says why, in the JAX package's words."""
    j_logp, t_logp = _gauss_logps()
    init = 1.0 + 0.1 * np.random.default_rng(2).normal(size=(8, 2))
    kw = dict(n_steps=20, checkpoint_every=10, identity={"c": 1})
    out = str(tmp_path / "chain")
    writers = {"jax": lambda: js.run_ensemble_checkpointed(5, j_logp, init, out_dir=out, **kw),
               "port": lambda: ts.run_ensemble_checkpointed(5, t_logp, init, out_dir=out,
                                                            device="cpu", **kw)}
    writers[writer]()
    capsys.readouterr()
    read = writers["port" if writer == "jax" else "jax"]()
    err = capsys.readouterr().err
    assert read.resumed_segments == 0
    assert "was checkpointed under a different run identity" in err


def test_checkpoint_refusals():
    _, logp = _gauss_logps()
    kw = dict(n_steps=10, out_dir="unused", identity={"c": 1}, device="cpu")
    with pytest.raises(ValueError, match="sampler_opts only apply"):
        ts.run_ensemble_checkpointed(0, logp, np.zeros((8, 2)), sampler_opts={"n_warmup": 3},
                                     **kw)
    with pytest.raises(ValueError, match="unknown NUTS"):
        ts.run_ensemble_checkpointed(0, logp, np.zeros((8, 2)), sampler="nuts",
                                     sampler_opts={"step": 0.1}, **kw)


def test_checkpointed_chain_on_a_mesh_is_the_chain_without_one(tmp_path):
    """``mesh=`` splits the walkers of every logp evaluation over four host
    members: the checkpointed chain, its files and its resume are the
    chain without a mesh, bit for bit."""
    from bdlz_tpu_torch.parallel import make_mesh

    _, logp = _gauss_logps()
    init = 1.0 + 0.1 * np.random.default_rng(3).normal(size=(8, 2))
    kw = dict(n_steps=12, checkpoint_every=4, identity={"c": 1}, device="cpu")
    plain = ts.run_ensemble_checkpointed(5, logp, init, out_dir=str(tmp_path / "p"), **kw)
    mesh = make_mesh((4, 1), devices=["cpu"] * 4)
    meshed = ts.run_ensemble_checkpointed(5, logp, init, out_dir=str(tmp_path / "m"),
                                          mesh=mesh, **kw)
    np.testing.assert_array_equal(meshed.chain, plain.chain)
    np.testing.assert_array_equal(meshed.logp_chain, plain.logp_chain)
    assert meshed.acceptance == plain.acceptance
    again = ts.run_ensemble_checkpointed(5, logp, init, out_dir=str(tmp_path / "m"),
                                         mesh=mesh, **kw)
    assert again.resumed_segments == 3
    np.testing.assert_array_equal(again.chain, plain.chain)


def test_sampling_exposes_jax_all():
    assert ts.__all__ == js.__all__
    assert all(hasattr(ts, name) for name in ts.__all__)


@pytest.mark.parametrize("sampler", ["stretch", "nuts", "checkpointed"])
def test_samplers_run_on_the_card_unless_asked(sampler, monkeypatch, tmp_path):
    """No ``device`` and a logp that names none: the sampler wants the
    card, so without one it raises instead of running on the CPU;
    ``device="cpu"`` runs; a ``device`` that contradicts the logp's is
    refused."""
    _, logp = _gauss_logps()
    init = 1.0 + 0.1 * np.random.default_rng(2).normal(size=(8, 2))

    def run(fn=logp, **kw):
        if sampler == "stretch":
            return ts.run_ensemble(fn, init, 2, generator=make_generator(0), **kw)
        if sampler == "nuts":
            return ts.run_nuts(fn, init, 2, generator=make_generator(0), n_warmup=0, **kw)
        return ts.run_ensemble_checkpointed(0, fn, init, 2, str(tmp_path / sampler),
                                            identity={"c": 1}, **kw)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
    assert np.isfinite(np.asarray(run(device="cpu").chain)).all()

    def on_card(th):
        return logp(th)

    on_card.device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="but the logp runs on"):
        run(on_card, device="cpu")


def test_without_a_card_the_default_device_raises(env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.make_pipeline_logprob(env["tb"], env["ts"], env["tt"])
