"""The port's NUTS against the JAX package's, on the CPU, with JAX's draws.

JAX's threefry streams cannot be reproduced in torch, so the tests replay
JAX's key tree into the tensors the port's transition takes
(``NutsDraws``): a chain key splits into ``k_mom``/``k_tree``, ``k_tree``
into ``key, k_dir, k_sub, k_acc`` per doubling, ``k_sub`` into ``key,
k_sel`` per leaf; a phase key splits into its steps, each step into its
chains.  Fed the same draws, the two transitions agree:

* Gaussian target, diag and dense mass: the same depths, leapfrog counts
  and divergences per chain and step; positions ≤1e-12 (measured ~1e-16);
  a whole adapted run (ε search, dual averaging, mass estimation) keeps
  every tree and agrees to ≤1e-8 (dual averaging amplifies ulps);
* the pipeline logp at max depth 4, 3 draws: positions ≤1e-8;
* the free particle never U-turns (the backward-subtree regression);
* dual averaging, the ε search and the mass estimate equal JAX's.

``pytest -s`` prints the ``RESIDUAL`` lines.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bdlz_tpu.sampling import nuts as jn

from bdlz_tpu_torch.sampling import nuts as tn
from bdlz_tpu_torch.sampling.ensemble import make_generator

GAUSS_TOL, PIPE_TOL = 1e-12, 1e-8
#: A whole adapted run: the accept statistic (Σ min(1, e^w) over the
#: leaves) differs by ulps, and dual averaging moves log ε by √t/γ·h̄,
#: ~100× that per update, so ε and the chain agree to ~1e-9 while every
#: tree (depths, leapfrogs, divergences) stays equal.
ADAPTED_TOL = 1e-8
MEAN = np.array([1.0, -2.0, 0.5])
SIGMA = np.array([0.7, 1.3, 0.1])
COV = np.array([[1.0, 0.6, 0.1], [0.6, 2.0, 0.3], [0.1, 0.3, 0.5]])


@functools.lru_cache(maxsize=None)
def _chain_draws_fn(md, D):
    """jit(vmap(chain key -> the draws of one transition)), JAX's key tree;
    one compile per (depth, dimension) for the whole file."""
    L = 1 << (md - 1)

    def one(key):
        k_mom, key = jax.random.split(key)
        normal = jax.random.normal(k_mom, (D,))
        go, acc, sel = [], [], []
        for d in range(md):
            key, k_dir, k_sub, k_acc = jax.random.split(key, 4)
            go.append(jax.random.bernoulli(k_dir))
            acc.append(jax.random.uniform(k_acc))
            row = []
            for _ in range(1 << d):
                k_sub, k_sel = jax.random.split(k_sub)
                row.append(jax.random.uniform(k_sel))
            sel.append(jnp.stack(row + [jnp.zeros(())] * (L - len(row))))
        return normal, jnp.stack(go), jnp.stack(acc), jnp.stack(sel)

    return jax.jit(jax.vmap(one))


class JaxReplay:
    """A draw source for the port's ``run_nuts`` that replays the keys
    JAX's ``run_nuts(key, ...)`` consumes, phase by phase."""

    def __init__(self, key, C, D, md, n_warmup, resume=False, thin=1):
        self.C, self.D, self.md, self.thin = C, D, md, thin
        self.fn = _chain_draws_fn(md, D)
        self.keys = {"sample": jax.random.fold_in(key, 0x5A11)}
        if not resume:
            ada = jax.random.fold_in(key, 0xADA)
            if n_warmup < 40:
                self.keys["eps"], self.keys["p1"] = jax.random.split(ada, 2)
            else:
                (self.keys["eps"], self.keys["p1"], self.keys["p2"], self.keys["eps2"],
                 self.keys["p3"]) = jax.random.split(ada, 5)
        self.lengths = {}

    def set_lengths(self, **n):
        self.lengths.update(n)

    def momentum(self, phase, D):
        return np.asarray(jax.random.normal(self.keys[phase], (D,)))

    def step_key(self, phase, index):
        n = self.lengths[phase]
        thin = self.thin if phase == "sample" else 1
        outer = jax.random.split(self.keys[phase], n // thin)[index // thin]
        return jax.random.split(outer, thin)[index % thin]

    def transition(self, phase, index, C, D, md, device):
        ckeys = jax.random.split(self.step_key(phase, index), C)
        normal, go, acc, sel = (np.asarray(a) for a in self.fn(ckeys))
        t = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
        return tn.NutsDraws(normal=t(normal), go_right=t(go, torch.bool), u_acc=t(acc),
                            u_sel=t(sel))


def _gauss(dense):
    if dense:
        Li = np.linalg.cholesky(np.linalg.inv(COV))

        def j_logp(th):
            y = jnp.asarray(Li).T @ (th - MEAN)
            return -0.5 * jnp.sum(y * y)

        Li_t = torch.as_tensor(Li, dtype=torch.float64)
        mean_t = torch.as_tensor(MEAN, dtype=torch.float64)

        def t_logp(th):
            y = (th - mean_t) @ Li_t
            return -0.5 * (y * y).sum(dim=-1)
    else:
        def j_logp(th):
            r = (th - MEAN) / SIGMA
            return -0.5 * jnp.sum(r * r)

        mean_t = torch.as_tensor(MEAN, dtype=torch.float64)
        sig_t = torch.as_tensor(SIGMA, dtype=torch.float64)

        def t_logp(th):
            r = (th - mean_t) / sig_t
            return -0.5 * (r * r).sum(dim=-1)
    t_logp.device = torch.device("cpu")
    return j_logp, t_logp


def _init(C=4, D=3, seed=0):
    return MEAN + 0.05 * np.random.default_rng(seed).normal(size=(C, D)) * SIGMA


def _step_parity(j_logp, t_logp, mass, z0, eps, im, cm, md, n_steps, key):
    """Run both transitions step by step on the same draws; return the
    worst position residual and the per-step (depth, n_leapfrog,
    divergent) of each."""
    C, D = z0.shape
    j_step = jn.make_nuts_draw(j_logp, mass, md)
    t_step = tn.make_nuts_draw(t_logp, mass, md)
    fn = _chain_draws_fn(md, D)
    j_vg = jax.jit(jax.vmap(jax.value_and_grad(j_logp)))
    jz = jnp.asarray(z0)
    jlp, jg = j_vg(jz)
    tz = torch.as_tensor(z0, dtype=torch.float64)
    tlp, tg = t_step.value_and_grad(tz)
    worst, j_stats, t_stats = 0.0, [], []
    for k in jax.random.split(key, n_steps):
        ckeys = jax.random.split(k, C)
        normal, go, acc, sel = (np.asarray(a) for a in fn(ckeys))
        draws = tn.NutsDraws(torch.as_tensor(normal), torch.as_tensor(go),
                             torch.as_tensor(acc), torch.as_tensor(sel))
        jz, jlp, jg, (_a, jd, jl, jdiv) = j_step(ckeys, jz, jlp, jg, eps, jnp.asarray(im),
                                                  jnp.asarray(cm))
        tz, tlp, tg, (_b, td, tl, tdiv) = t_step(tz, tlp, tg, eps, im, cm, draws)
        j_stats.append((np.asarray(jd).tolist(), np.asarray(jl).tolist(),
                        np.asarray(jdiv).tolist()))
        t_stats.append((td.tolist(), tl.tolist(), tdiv.tolist()))
        scale = np.maximum(np.abs(np.asarray(jz)), 1.0)
        worst = max(worst, float(np.max(np.abs(tz.numpy() - np.asarray(jz)) / scale)))
    return worst, j_stats, t_stats


@pytest.mark.parametrize("mass,eps", [("diag", 0.1), ("dense", 0.4), ("diag", 3.0)],
                         ids=["diag", "dense", "diag-divergent"])
def test_gaussian_transition_matches_jax(mass, eps):
    """Twelve transitions of four chains: the same tree depth, leapfrog
    count and divergence per chain and step, positions ≤1e-12.  The
    third case's step is large enough to diverge."""
    j_logp, t_logp = _gauss(mass == "dense")
    D = 3
    im = np.ones(D) if mass == "diag" else np.eye(D)
    worst, js, ts = _step_parity(j_logp, t_logp, mass, _init(), eps, im, im, 6, 12,
                                 jax.random.PRNGKey(11))
    print(f"RESIDUAL nuts gaussian[{mass}, eps={eps}] positions max_rel={worst:.3e} "
          f"depths={[s[0] for s in ts[:3]]} divergent steps="
          f"{sum(any(s[2]) for s in ts)}")
    assert ts == js
    assert worst <= GAUSS_TOL
    if eps == 3.0:
        assert any(any(s[2]) for s in ts)


@pytest.mark.parametrize("mass", ["diag", "dense"])
def test_adapted_gaussian_run_matches_jax(mass):
    """A whole run with the three-window warmup (ε search, dual averaging,
    the pooled mass estimate, the ε re-search) then sampling, the port fed
    JAX's whole key tree: the same ε, mass, counters and chain."""
    j_logp, t_logp = _gauss(mass == "dense")
    C, D, md, warm, steps = 4, 3, 5, 40, 10
    key = jax.random.PRNGKey(3)
    init = _init(C, D, seed=2)
    ref = jn.run_nuts(key, j_logp, init, steps, n_warmup=warm, mass_matrix=mass,
                      max_tree_depth=md)
    replay = JaxReplay(key, C, D, md, warm)
    replay.set_lengths(p1=10, p2=20, p3=10, sample=steps)
    got = tn.run_nuts(t_logp, init, steps, draws=replay, n_warmup=warm, mass_matrix=mass,
                      max_tree_depth=md)
    rel = float(np.max(np.abs(got.chain - np.asarray(ref.chain))))
    print(f"RESIDUAL nuts adapted[{mass}] chain max_abs={rel:.3e} step_size "
          f"{got.step_size!r} vs {ref.step_size!r} n_leapfrog {got.n_leapfrog} "
          f"vs {ref.n_leapfrog}")
    assert (got.n_leapfrog, got.n_logp_evals, got.n_divergent) == (
        ref.n_leapfrog, ref.n_logp_evals, ref.n_divergent)
    assert got.mean_tree_depth == ref.mean_tree_depth
    assert abs(got.step_size / ref.step_size - 1.0) <= ADAPTED_TOL
    np.testing.assert_allclose(got.inv_mass, np.asarray(ref.inv_mass), rtol=ADAPTED_TOL)
    assert rel <= ADAPTED_TOL


@pytest.fixture(scope="module")
def pipeline_logps():
    from bdlz_tpu import config as jc
    from bdlz_tpu.ops.kjma_table import make_f_table as j_table
    from bdlz_tpu.sampling import make_pipeline_logprob as j_mpl

    from bdlz_tpu_torch import config as tc
    from bdlz_tpu_torch.ops.kjma_table import make_f_table as t_table
    from bdlz_tpu_torch.sampling import make_pipeline_logprob as t_mpl

    over = {"regime": "nonthermal", "P_chi_to_B": 0.14925839040304145,
            "source_shape_sigma_y": 9.0, "incident_flux_scale": 1.07e-9,
            "Y_chi_init": 4.90e-10}
    jb, tb = jc.config_from_dict(over), tc.config_from_dict(over)
    kw = dict(param_keys=("m_chi_GeV", "P_chi_to_B"),
              bounds={"m_chi_GeV": (0.05, 20.0), "P_chi_to_B": (1e-4, 1.0)}, n_y=2000)
    return (j_mpl(jb, jc.static_choices_from_config(jb), j_table(jb.I_p, jnp, n=4096), **kw),
            t_mpl(tb, tc.static_choices_from_config(tb), t_table(tb.I_p, n=4096),
                  device="cpu", **kw))


def test_pipeline_transition_matches_jax(pipeline_logps):
    """NUTS on the Planck pipeline logp, max depth 4, three draws of two
    chains on JAX's draws: positions ≤1e-8, the same trees."""
    j_logp, t_logp = pipeline_logps
    init = np.array([[0.95, 0.149], [0.96, 0.1485]])
    im = np.array([1e-4, 1e-6])   # the posterior's scales: ~1% in m_chi, ~0.7% in P
    worst, js, ts = _step_parity(j_logp, t_logp, "diag", init, 0.3, im, 1.0 / np.sqrt(im), 4,
                                 3, jax.random.PRNGKey(5))
    print(f"RESIDUAL nuts pipeline positions max_rel={worst:.3e} trees={ts}")
    assert ts == js
    assert worst <= PIPE_TOL


def test_free_particle_never_uturns():
    """On a flat log-density every trajectory is straight: a correct
    criterion never fires, so every draw exhausts the depth cap (the
    backward-subtree sign regression of the JAX package)."""
    def logp(th):
        return torch.zeros(th.shape[0], dtype=torch.float64) * th.sum(dim=-1)

    run = tn.run_nuts(logp, np.zeros((4, 2)), 32, generator=make_generator(7), n_warmup=0,
                      step_size=0.1, inv_mass=np.ones(2), max_tree_depth=6, device="cpu")
    assert run.mean_tree_depth == 6.0
    assert run.n_divergent == 0
    # every transition runs the whole tree: 2**6 − 1 batched leaves of 4 chains
    assert run.n_batched_leaves == 32 * 63
    assert run.n_leapfrog == 4 * run.n_batched_leaves


def test_dual_averaging_eps_search_and_mass_equal_jax():
    """The adaptation pieces on the same inputs: dual averaging's states
    ≤1e-13 rel over 50 updates (XLA and NumPy may round ``t**-κ``
    differently), the ε search's ε and evaluation count equal, the mass
    estimates bitwise (the same NumPy)."""
    rng = np.random.default_rng(4)
    accepts = rng.uniform(0.3, 1.0, 50)
    jda, tda = jn._da_init(0.37), tn._da_init(0.37)
    worst = 0.0
    for a in accepts:
        jda, tda = jn._da_update(jda, float(a), 0.8), tn._da_update(tda, float(a), 0.8)
        for f in ("log_eps", "log_eps_avg", "h_avg"):
            ref = float(getattr(jda, f))
            worst = max(worst, abs(getattr(tda, f) - ref) / max(abs(ref), 1e-300))
    print(f"RESIDUAL nuts dual averaging max_rel={worst:.3e}")
    assert worst <= 1e-13
    samples = rng.normal(size=(60, 3)) @ np.linalg.cholesky(COV).T
    for mass in ("diag", "dense"):
        for a, b in zip(tn._estimate_inv_mass(samples, mass), jn._estimate_inv_mass(samples,
                                                                                   mass)):
            np.testing.assert_array_equal(a, b)
        j_logp, t_logp = _gauss(mass == "dense")
        key = jax.random.PRNGKey(9)
        im, cm = tn._estimate_inv_mass(samples, mass)
        z = jnp.asarray(_init()[0])
        lp, g = jax.value_and_grad(j_logp)(z)
        ref = jn._find_reasonable_eps(jax.jit(jax.value_and_grad(j_logp)), mass, im, cm, key,
                                      z, lp, g)
        t_vg = tn.make_nuts_draw(t_logp, mass).value_and_grad
        tz = torch.as_tensor(_init()[:1])
        tlp, tg = t_vg(tz)
        got = tn._find_reasonable_eps(t_vg, mass, im, cm, np.asarray(jax.random.normal(key, (3,))),
                                      tz[0], tlp, tg[0])
        assert got == ref


def test_validation_messages_equal_jax():
    def j_logp(th):
        return -0.5 * jnp.sum(th * th)

    def t_logp(th):
        return -0.5 * (th * th).sum(dim=-1)

    init = np.zeros((2, 2))
    g = make_generator(0)
    cases = [dict(mass_matrix="full"), dict(target_accept=1.2), dict(step_size=0.1),
             dict(step_size=0.1, inv_mass=np.ones(2), n_warmup=50)]
    for kw in cases:
        with pytest.raises(ValueError) as got:
            tn.run_nuts(t_logp, init, 10, generator=g, device="cpu", **kw)
        with pytest.raises(ValueError) as ref:
            jn.run_nuts(0, j_logp, init, 10, **kw)
        assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError, match="thin"):
        tn.run_nuts(t_logp, init, 11, generator=g, thin=2, device="cpu")
    with pytest.raises(ValueError, match="finite"):
        tn.run_nuts(lambda t: torch.full((t.shape[0],), -torch.inf, dtype=torch.float64),
                    init, 10, generator=g, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        tn.run_nuts(t_logp, init, 10, device="cpu")


def test_checkpointed_nuts_resumes_bitwise(tmp_path):
    """A NUTS chain cut after segment 1 and resumed is bitwise the
    uninterrupted one: the adapted (ε, mass), the positions and the
    counters ride the segment files, segment k draws from (seed, k)."""
    import json
    import os
    import shutil

    from bdlz_tpu_torch.sampling import run_ensemble_checkpointed

    def logp(th):
        return -0.5 * ((th - 1.0) ** 2).sum(dim=-1)

    init = 1.0 + 0.1 * np.random.default_rng(3).normal(size=(3, 2))
    kw = dict(n_steps=20, checkpoint_every=10, identity={"c": 1}, sampler="nuts",
              sampler_opts={"n_warmup": 24}, device="cpu")
    full = run_ensemble_checkpointed(5, logp, init, out_dir=str(tmp_path / "full"), **kw)
    assert full.sampler == "nuts" and full.chain.shape == (20, 3, 2)
    assert full.segments == 2 and full.resumed_segments == 0
    seg0 = np.load(os.path.join(str(tmp_path / "full"), "seg_00000.npz"))
    assert {"nuts_step_size", "nuts_inv_mass", "nuts_acc_sum", "nuts_n_logp_evals",
            "nuts_n_divergent"} <= set(seg0.files)
    part = str(tmp_path / "part")
    shutil.copytree(str(tmp_path / "full"), part)
    os.remove(os.path.join(part, "seg_00001.npz"))
    with open(os.path.join(part, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["done"] = [0]
    with open(os.path.join(part, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    resumed = run_ensemble_checkpointed(5, logp, init, out_dir=part, **kw)
    assert resumed.resumed_segments == 1
    assert np.array_equal(resumed.chain, full.chain)
    assert resumed.step_size == full.step_size
    assert np.array_equal(resumed.inv_mass, full.inv_mass)
    assert (resumed.n_logp_evals, resumed.n_divergent) == (full.n_logp_evals, full.n_divergent)
