"""The port's content identities and store against the JAX package, on
the CPU.

Digests (``grid_hash``, ``sweep_identity``, ``emulator_artifact_identity``,
``multidomain_artifact_identity``, ``sweep_chunk_identity``) are
byte-equal for equal inputs; the store trusts, evicts and counts as the
JAX store does; a warm sweep is bit for bit the cold one with the JAX
engine's hit counts; a chunk key of the port never equals one of the JAX
package (its ``platform`` names the torch device), and is the JAX key
exactly when the platform is forced equal.
"""
import os

import numpy as np
import pytest

from bdlz_tpu import config as jc
from bdlz_tpu import faults as jf
from bdlz_tpu import provenance as jp
from bdlz_tpu.parallel import sweep as js

from bdlz_tpu_torch import config as tc
from bdlz_tpu_torch import faults as tf
from bdlz_tpu_torch import provenance as tp
from bdlz_tpu_torch.parallel import sweep as ts

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 9.0,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
AXES = {"m_chi_GeV": np.geomspace(0.3, 3.0, 8), "T_p_GeV": np.geomspace(50.0, 200.0, 8)}
KW = dict(chunk_size=16, n_y=400, impl="tabulated")

CONFIGS = [{}, {"n_y": 4000, "ode_rtol": 1e-9}, {"retry_enabled": True, "cache_root": "/x"},
           {"lz_mode": "chain", "lz_n_levels": 3}, {"m_B_GeV": 2.0, "quad_panel_gl": True}]


def _pair(over):
    d = dict(ARCHIVED, **over)
    jb, tb = jc.config_from_dict(d), tc.config_from_dict(d)
    return jb, tb, jc.static_choices_from_config(jb), tc.static_choices_from_config(tb)


@pytest.mark.parametrize("over", CONFIGS, ids=range(len(CONFIGS)))
def test_payloads_and_sweep_digests_equal_jax(over):
    jb, tb, jst, tst = _pair(over)
    assert tp.config_payload(tb) == jp.config_payload(jb)
    for norm in (False, True):
        assert tp.static_payload(tst, normalize_quad=norm) == jp.static_payload(
            jst, normalize_quad=norm)
    extras = [None, {"lz_profile": "ab12", "lz_method": "coherent"},
              {"quad": {"panel_gl": True, "n_panels": 28, "n_nodes": 20},
               "fault_plan": [{"site": "step", "kind": "nan", "point": 3}]}]
    for impl in ("tabulated", "direct", "esdirk"):
        for extra in extras:
            got = tp.sweep_identity(tb, AXES, 400, impl, extra=extra)
            ref = jp.sweep_identity(jb, AXES, 400, impl, extra=extra)
            assert got.digest(16) == ref.digest(16) and got.describe() == ref.describe()
            assert ts.grid_hash(tb, AXES, 400, impl, extra=extra) == js.grid_hash(
                jb, AXES, 400, impl, extra=extra)
    print(f"RESIDUAL provenance sweep digests equal for {sorted(over)}: "
          f"{ts.grid_hash(tb, AXES, 400, 'tabulated')}")


@pytest.mark.parametrize("impl,knobs,quad,plan", [
    ("tabulated", None, True, None), ("tabulated", None, False, None),
    ("esdirk", {"auto_h0": True, "pi_controller": True, "tabulated_av": False}, None, None),
    ("direct", None, None, [{"site": "step", "kind": "poison", "point": 1}]),
])
def test_engine_identity_extra_equals_jax_for_shared_engines(impl, knobs, quad, plan):
    for over in ({}, {"lz_mode": "thermal", "lz_bath_eta": 0.001, "lz_bath_omega_c": 50.0}):
        _, _, jst, tst = _pair(over)
        got = ts.engine_identity_extra(
            tst._replace(quad_panel_gl=quad), impl, esdirk_knobs=knobs,
            faults=None if plan is None else tf.FaultPlan.from_obj(plan))
        ref = js.engine_identity_extra(
            jst._replace(quad_panel_gl=quad), impl, esdirk_knobs=knobs,
            faults=None if plan is None else jf.FaultPlan.from_obj(plan))
        assert got == ref


def test_kernel_engine_carries_its_own_tier_block():
    _, _, _, tst = _pair({})
    assert ts.engine_identity_extra(tst, "kernel") == {
        "kernel": {"fuse_exp": False, "reduce": True}}
    assert ts.engine_identity_extra(tst, "kernel", fuse_exp=True, kernel_reduce=False) == {
        "kernel": {"fuse_exp": True, "reduce": False}}


def _artifact_parts(seed, with_error):
    rng = np.random.default_rng(seed)
    names = ("m_chi_GeV", "T_p_GeV", "v_w")
    nodes = [np.sort(rng.uniform(1, 2, n)) for n in (3, 4, 2)]
    values = {f: rng.uniform(0.5, 2.0, (3, 4, 2)) for f in ("DM_over_B", "Y_B")}
    err = rng.uniform(0, 1e-4, (2, 3, 1)) if with_error else None
    ident = {"base": {"m_chi_GeV": 0.95}, "static": ["fermion", 8000], "n_y": 400,
             "impl": "tabulated", "quad_panel_gl": True}
    return names, nodes, ("log", "log", "lin"), values, ident, err


@pytest.mark.parametrize("seed,with_error", [(0, False), (1, True), (2, True)])
def test_artifact_and_bundle_digests_equal_jax(seed, with_error):
    names, nodes, scales, values, ident, err = _artifact_parts(seed, with_error)
    got = tp.emulator_artifact_identity(names, nodes, scales, values, ident, 2,
                                        predicted_error=err)
    ref = jp.emulator_artifact_identity(names, nodes, scales, values, ident, 2,
                                        predicted_error=err)
    assert got.digest(16) == ref.digest(16) and got.describe() == ref.describe()
    band = {"axis": "m_chi_GeV", "lo": 267.1, "hi": 340.2, "kind": "T=m/3 flux seam",
            "band_tol": 1.25e-5}
    hashes = [got.digest(16), ref.digest(32)]
    assert tp.multidomain_artifact_identity(hashes, band, ident, 2).digest(16) == \
        jp.multidomain_artifact_identity(hashes, band, ident, 2).digest(16)


@pytest.mark.parametrize("lo,hi", [(0, 16), (16, 32), (60, 64)])
def test_chunk_keys_equal_jax_but_never_collide_across_packages(lo, hi):
    jb, tb, jst, tst = _pair({})
    pp = ts.build_grid(tb, AXES)
    core = {"schema": 1, "platform": "cpu", "n_y": 400}
    arrays = [np.asarray(f)[lo:hi] for f in pp]
    assert tp.sweep_chunk_identity(core, arrays).digest(32) == jp.sweep_chunk_identity(
        core, arrays).digest(32)
    kw = dict(n_y=400, impl="tabulated", extra={"quad": {"panel_gl": True}})
    for platform in ("cpu", "tpu"):
        forced = ts.chunk_cache_key(tb, tst, pp, lo, hi, platform=platform, **kw)
        jkey = js.chunk_cache_key(jb, jst, js.build_grid(jb, AXES), lo, hi, platform=platform,
                                  **kw)
        assert forced == jkey
        for dev in ("cpu", "cuda"):
            port = ts.chunk_cache_key(tb, tst, pp, lo, hi, platform=ts.device_platform(dev),
                                      **kw)
            assert port != jkey
    assert ts.chunk_cache_key(tb, tst, pp, lo, hi, platform="torch-cpu", **kw) != \
        ts.chunk_cache_key(tb, tst, pp, lo, hi, platform="torch-cuda", **kw)
    windowed = ts.chunk_cache_key(tb, tst, pp, lo, hi, platform="cpu",
                                  fault_ctx=("step", 0, lo, hi), **kw)
    assert windowed == js.chunk_cache_key(jb, jst, js.build_grid(jb, AXES), lo, hi,
                                          platform="cpu", fault_ctx=("step", 0, lo, hi), **kw)


def test_chunk_entry_helpers_equal_jax():
    rng = np.random.default_rng(3)
    host = {f: rng.uniform(size=5) for f in ("Y_B", "Y_chi", "rho_B_kg_m3", "rho_DM_kg_m3",
                                             "DM_over_B")}
    host["DM_over_B"][2] = np.nan
    q = np.array([0, 0, 1, 0, 0], bool)
    for qm in (None, q, np.zeros(5, bool)):
        got = ts.chunk_entry_arrays(host, n_retries=4, qmask=qm)
        ref = js.chunk_entry_arrays(host, n_retries=4, qmask=qm)
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
        assert ts.chunk_entry_ok(got, 5) and js.chunk_entry_ok(got, 5)
        assert not ts.chunk_entry_ok(got, 4) and not js.chunk_entry_ok(got, 4)
    assert not ts.chunk_entry_ok(None, 5)


# ---- the store ---------------------------------------------------------------

def test_store_refuses_untrusted_roots(tmp_path):
    loose = tmp_path / "loose"
    loose.mkdir()
    os.chmod(loose, 0o777)
    link = tmp_path / "link"
    link.symlink_to(tmp_path / "real", target_is_directory=True)
    (tmp_path / "real").mkdir()
    afile = tmp_path / "file"
    afile.write_text("x")
    for root in (loose, link, afile):
        for mod in (tp, jp):
            with pytest.raises((mod.StoreUntrustedError, FileExistsError)):
                mod.Store(str(root))
    assert tp.resolve_store(str(loose)) is None and jp.resolve_store(str(loose)) is None


def test_store_round_trip_corrupt_eviction_and_read_faults(tmp_path, capsys):
    s = tp.Store(str(tmp_path / "store"))
    assert oct(os.stat(s.root).st_mode & 0o777) == "0o700"
    arrays = {"a": np.arange(6.0), "b": np.ones(3, bool)}
    s.put_npz("sweep_chunk/k1.npz", arrays)
    s.put_array("ref/r.npy", np.arange(4.0))
    s.put_json("j.json", {"x": [1, 2]})
    got = s.get_npz("sweep_chunk/k1.npz")
    np.testing.assert_array_equal(got["a"], arrays["a"])
    np.testing.assert_array_equal(s.get_array("ref/r.npy"), np.arange(4.0))
    assert s.get_json("j.json") == {"x": [1, 2]} and s.get_npz("sweep_chunk/none.npz") is None
    assert s.stats.as_dict() == {"hits": 3, "misses": 1, "writes": 3, "dropped_corrupt": 0}
    # a torn entry: deleted, reported as a miss; the JAX store reads the
    # same root and file names
    path = s.path_for("sweep_chunk/k1.npz")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    assert s.get_npz("sweep_chunk/k1.npz") is None and not os.path.exists(path)
    assert s.stats.dropped_corrupt == 1 and "is corrupt" in capsys.readouterr().err
    # an armed store_read fault tears the second read
    s.put_npz("sweep_chunk/k2.npz", arrays)
    s.arm_faults(tf.FaultPlan.from_obj([{"site": "store_read", "kind": "torn", "key": 1}]))
    assert s.get_npz("sweep_chunk/k2.npz") is not None
    assert s.get_npz("sweep_chunk/k2.npz") is None
    assert jp.Store(s.root).get_array("ref/r.npy") is not None
    with pytest.raises(ValueError):
        s.path_for("../escape.npz")
    old = os.path.join(s.root, "sweep_chunk", "dead.tmp.npz")
    open(old, "w").close()
    os.utime(old, (0, 0))
    assert s.evict_partials(max_age_s=60.0) == 1 and not os.path.exists(old)


def test_resolve_store_tristate_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    monkeypatch.delenv("BDLZ_CACHE_ROOT", raising=False)
    root = str(tmp_path / "r")
    cases = [({}, None, None), ({}, root, None), ({"cache_root": root}, None, None),
             ({"cache_enabled": True}, None, None), ({"cache_enabled": False}, root, None),
             ({}, None, str(tmp_path / "env"))]
    for over, arg, env in cases:
        if env:
            monkeypatch.setenv("BDLZ_CACHE_ROOT", env)
        d = dict(ARCHIVED, **over)
        got = tp.resolve_store(arg, tc.config_from_dict(d))
        ref = jp.resolve_store(arg, jc.config_from_dict(d))
        assert (got is None) == (ref is None)
        if ref is not None:
            assert got.root == ref.root
        monkeypatch.delenv("BDLZ_CACHE_ROOT", raising=False)
    assert tp.default_store_root() == jp.default_store_root()


@pytest.mark.parametrize("plan", [None, [{"site": "step", "kind": "poison", "point": 21}]])
def test_warm_sweep_is_bitwise_cold_with_jax_hit_counts(plan, tmp_path):
    """Cold then warm through one root per package: the same hit and
    miss counts as the JAX engine, the warm outputs, masks and retry
    counts bit for bit the cold ones.  An armed plan is cached (keyed);
    the port's and JAX's entries share the root without a collision."""
    from bdlz_tpu.utils.retry import RetryPolicy as JRP

    from bdlz_tpu_torch.utils.retry import RetryPolicy as TRP

    jb, tb, jst, tst = _pair({})
    jst, tst = jst._replace(quad_panel_gl=False), tst._replace(quad_panel_gl=False)
    root = str(tmp_path / "store")
    runs = {}
    for name in ("cold", "warm"):
        runs[("jax", name)] = js.run_sweep(
            jb, AXES, jst, **KW, cache=jp.Store(root), retry=JRP(sleep=lambda s: None),
            fault_plan=None if plan is None else jf.FaultPlan.from_obj(plan))
        runs[("port", name)] = ts.run_sweep(
            tb, AXES, tst, **KW, device="cpu", cache=tp.Store(root),
            retry=TRP(sleep=lambda s: None),
            fault_plan=None if plan is None else tf.FaultPlan.from_obj(plan))
    for pkg in ("jax", "port"):
        cold, warm = runs[(pkg, "cold")], runs[(pkg, "warm")]
        assert (cold.cache_hits, cold.cache_misses) == (0, 4)
        assert (warm.cache_hits, warm.cache_misses) == (4, 0)
        assert (warm.n_retries, warm.n_quarantined) == (cold.n_retries, cold.n_quarantined)
        np.testing.assert_array_equal(warm.quarantined_mask, cold.quarantined_mask)
        for f in cold.outputs:
            np.testing.assert_array_equal(warm.outputs[f], cold.outputs[f])
    assert runs[("port", "warm")].n_retries == runs[("jax", "warm")].n_retries
    print(f"RESIDUAL provenance warm run hits/misses port "
          f"{runs[('port', 'warm')].cache_hits}/{runs[('port', 'warm')].cache_misses} jax "
          f"{runs[('jax', 'warm')].cache_hits}/{runs[('jax', 'warm')].cache_misses}, "
          f"retries {runs[('port', 'warm')].n_retries}, outputs bitwise")
    assert len(os.listdir(os.path.join(root, "sweep_chunk"))) == 8


def test_a_real_quarantine_is_never_cached(tmp_path, monkeypatch):
    """A chunk quarantined without a fault plan (a dispatch that keeps
    raising) recomputes on the next run instead of replaying NaN."""
    from bdlz_tpu_torch.utils.retry import RetryPolicy

    _, tb, _, tst = _pair({})
    tst = tst._replace(quad_panel_gl=False)
    root = str(tmp_path / "store")
    real_step = ts.make_sweep_step

    def flaky_step(*a, **k):
        step = real_step(*a, **k)

        def run(pp, aux):
            if float(pp.m_chi_GeV[0]) == float(AXES["m_chi_GeV"][4]):
                raise RuntimeError("device lost")
            return step(pp, aux)
        return run

    monkeypatch.setattr(ts, "make_sweep_step", flaky_step)
    first = ts.run_sweep(tb, AXES, tst, **KW, device="cpu", cache=tp.Store(root),
                         retry=RetryPolicy(sleep=lambda s: None))
    assert first.n_quarantined > 0
    monkeypatch.setattr(ts, "make_sweep_step", real_step)
    second = ts.run_sweep(tb, AXES, tst, **KW, device="cpu", cache=tp.Store(root))
    assert second.cache_hits == 3 and second.cache_misses == 1 and second.n_failed == 0
