"""The port's seam-split emulator against the JAX package, on the CPU.

The seam band of a box equals JAX's (the same scan values, so equal to
the bit); the ``seam_emulator`` box (``tests/conftest.py``) built by the
port has JAX's domains, nodes bit for bit and band, with values ≤1e-12
rel (measured ≤4.5e-16); bundles load across the two packages with
their composite hash verified, and the stitched query routes as JAX's
(the same domain per query, the same predicted errors; values within
2 ulps of the JAX interpolation core, ≤1e-13 of its jitted kernel).
``pytest -s`` prints the ``RESIDUAL`` lines.
"""
import numpy as np
import pytest

from bdlz_tpu import config as jc
from bdlz_tpu import emulator as je
from bdlz_tpu.emulator import multidomain as jm

from bdlz_tpu_torch import config as tc
from bdlz_tpu_torch import emulator as te
from bdlz_tpu_torch.emulator import multidomain as tm

ARCHIVED = {
    "regime": "nonthermal",
    "P_chi_to_B": 0.14925839040304145,
    "source_shape_sigma_y": 1.5,
    "incident_flux_scale": 1.07e-9,
    "Y_chi_init": 4.90e-10,
}
SEAM = {"m_chi_GeV": (20.0, 600.0, 3, "log"), "T_p_GeV": (95.0, 105.0, 2, "log")}
BOXES = [
    (SEAM, {}),
    ({"m_chi_GeV": (20.0, 600.0, 3, "log"), "T_p_GeV": (95.0, 105.0, 2, "log"),
      "beta_over_H": (50.0, 200.0, 2, "log")}, {"source_shape_sigma_y": 3.0}),
    ({"T_p_GeV": (20.0, 400.0, 3, "log")}, {"m_chi_GeV": 300.0}),
    ({"m_chi_GeV": (0.5, 2.0, 3, "log")}, {}),          # never touches the band
    ({"v_w": (0.2, 0.4, 3, "lin")}, {}),                # no split axis
]


@pytest.mark.parametrize("spec,over", BOXES, ids=range(len(BOXES)))
@pytest.mark.parametrize("rtol", [1e-3, 1e-5])
def test_seam_band_equals_jax(spec, over, rtol):
    d = dict(ARCHIVED, **over)
    got = te.seam_band_for_box(tc.config_from_dict(d),
                               {k: te.AxisSpec(*v) for k, v in spec.items()}, rtol=rtol,
                               device="cpu")
    ref = je.seam_band_for_box(jc.config_from_dict(d),
                               {k: je.AxisSpec(*v) for k, v in spec.items()}, rtol=rtol)
    assert got == ref


def test_seam_split_resolution_equals_jax():
    base_t, base_j = tc.config_from_dict(ARCHIVED), jc.config_from_dict(ARCHIVED)
    smooth = {"m_chi_GeV": (0.5, 2.0, 3, "log")}
    for spec, split in ((SEAM, None), (SEAM, False), (smooth, None)):
        got = tm.resolve_seam_split(
            base_t, {k: te.AxisSpec(*v) for k, v in spec.items()}, split, rtol=1e-3,
            safety=2.0, device="cpu")
        ref = jm.resolve_seam_split(
            base_j, {k: je.AxisSpec(*v) for k, v in spec.items()}, split, rtol=1e-3,
            safety=2.0)
        assert got == ref
    with pytest.raises(te.MultiDomainBuildError, match="never crosses"):
        tm.resolve_seam_split(
            base_t, {k: te.AxisSpec(*v) for k, v in smooth.items()}, True, rtol=1e-3,
            safety=2.0, device="cpu")


@pytest.fixture(scope="module")
def port_bundle(seam_emulator, tmp_path_factory):
    base, bundle_dir, bundle, report, _, _, kw = seam_emulator
    out = str(tmp_path_factory.mktemp("port_seam") / "bundle")
    t_bundle, t_report = te.build_emulator(
        tc.config_from_dict(ARCHIVED), {k: te.AxisSpec(*v) for k, v in SEAM.items()},
        device="cpu", out_dir=out, **kw)
    return t_bundle, t_report, out


def test_seam_box_built_by_both_packages(seam_emulator, port_bundle):
    _, _, j_bundle, j_report, _, _, _ = seam_emulator
    t_bundle, t_report, _ = port_bundle
    assert len(t_bundle.domains) == len(j_bundle.domains) == 2
    assert t_bundle.seam_band == j_bundle.seam_band
    assert t_bundle.identity == j_bundle.identity
    assert t_report.converged == j_report.converged
    assert t_report.n_exact_evals == j_report.n_exact_evals
    rel = 0.0
    for td, jd in zip(t_bundle.domains, j_bundle.domains):
        assert td.manifest["seam_side"] == jd.manifest["seam_side"]
        for a, b in zip(td.axis_nodes, jd.axis_nodes):
            np.testing.assert_array_equal(a, b)
        rel = max(rel, max(float(np.max(np.abs(td.values[f] / jd.values[f] - 1.0)))
                           for f in jd.values))
    print(f"RESIDUAL multidomain seam build values max_rel={rel:.3e} "
          f"band={t_bundle.seam_band['lo']:.6g}..{t_bundle.seam_band['hi']:.6g}")
    assert rel <= 1e-12


def test_bundles_load_across_packages_and_route_like_jax(seam_emulator, port_bundle):
    """The stitched query: ≤2 ulps from the JAX interpolation core run
    with NumPy on the containing domain, ≤1e-13 from the jitted kernel
    (XLA rounds the log-space sum its own way: measured 1.0e-14)."""
    from bdlz_tpu.emulator.grid import interp_log_fields

    _, bundle_dir, j_bundle, _, _, _, _ = seam_emulator
    t_bundle, _, port_dir = port_bundle
    from_jax = te.load_any_artifact(bundle_dir)
    assert isinstance(from_jax, te.MultiDomainArtifact)
    assert from_jax.content_hash == j_bundle.content_hash
    from_port = je.load_any_artifact(port_dir)
    assert from_port.content_hash == t_bundle.content_hash
    with pytest.raises(te.EmulatorArtifactError, match="MULTI-DOMAIN"):
        te.load_artifact(bundle_dir)
    rng = np.random.default_rng(3)
    th = np.stack([10 ** rng.uniform(np.log10(15.0), np.log10(700.0), 3000),
                   10 ** rng.uniform(np.log10(94.0), np.log10(106.0), 3000)], axis=1)
    inside = te.make_domain_fn(from_jax, device="cpu")(th).numpy()
    np.testing.assert_array_equal(inside, np.asarray(je.make_domain_fn(j_bundle)(th)))
    band = from_jax.seam_band
    in_band = (th[:, 0] > band["hi"]) == (th[:, 0] < band["lo"])
    assert not inside[in_band].any() and inside.any()
    got = te.make_query_fn(from_jax, device="cpu")(th).numpy()
    ref = np.asarray(je.make_query_fn(j_bundle)(th))
    # each domain's answer through the JAX interpolation core with NumPy
    core = np.empty(len(th))
    for k, x in enumerate(th):
        dom = next((d for d in j_bundle.domains[::-1]
                    if np.all((x >= d.hull[0]) & (x <= d.hull[1]))), j_bundle.domains[0])
        core[k] = 10.0 ** interp_log_fields(
            np.clip(x, *dom.hull), dom.axis_nodes, dom.axis_scales,
            {"DM_over_B": np.log10(dom.values["DM_over_B"])}, np)["DM_over_B"]
    rel_core = float(np.max(np.abs(got / core - 1.0)))
    rel = float(np.max(np.abs(got / ref - 1.0)))
    print(f"RESIDUAL multidomain stitched query vs numpy core max_rel={rel_core:.3e} "
          f"vs jitted kernel max_rel={rel:.3e}")
    assert rel_core <= 4.5e-16 and rel <= 1e-13
    np.testing.assert_array_equal(te.make_error_fn(from_jax, device="cpu")(th).numpy(),
                                  np.asarray(je.make_error_fn(j_bundle)(th)))
    with pytest.raises(te.EmulatorArtifactError, match="no single value table"):
        from_jax.values["DM_over_B"]
