"""The compile-check entry points (``bdlz_tpu_torch/graft_entry.py``) against
``__graft_entry__.py``, on the CPU.

* ``entry(device="cpu")``'s ``fn`` against JAX's ``fn`` on the same grid
  and 4096-entry table: ≤1e-12 rel (after the first-jit warm-up).
* ``dryrun_multichip(n, devices="cpu")`` for n = 8 (sp = 2), 3 (an odd
  count) and 1 (one member):
  - at n = 8 it prints JAX's own dry-run line: the same mesh, batch and
    engines, and χ² to JAX's three printed digits.  JAX's dry run needs
    its mesh to hold all eight forced devices, so it runs at n = 8 only;
  - at every n the ratios, the sp Y_B and the ESDIRK Y_B are ≤1e-12 rel
    from the same JAX calls without a mesh (the ESDIRK engine's own
    tolerance, 1e-6, is not needed: it holds at 1e-12), and the K1 ratios
    at n_y 2048 are ≤1e-12 from JAX's tabulated engine at n_y 2048;
  - at n = 3 and 1 the mesh is ``{dp: n, sp: 1}`` and there is no
    ``gridshard(sp)`` step, as JAX's code would print.

Residuals print as ``RESIDUAL`` lines (``pytest -s``).
"""
import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jg
from bdlz_tpu import config as jc
from bdlz_tpu.constants import PLANCK_DM_OVER_B
from bdlz_tpu.models.yields_pipeline import point_yields_fast as j_point_yields_fast
from bdlz_tpu.ops.kjma_table import make_f_table as j_make_f_table
from bdlz_tpu.parallel.sweep import build_grid as j_build_grid
from bdlz_tpu.parallel.sweep import make_sweep_step as j_make_sweep_step
from bdlz_tpu.physics.percolation import make_kjma_grid as j_make_kjma_grid
from bdlz_tpu.solvers.quadrature import integrate_YB_quadrature_tabulated as j_yb_tabulated

from bdlz_tpu_torch import graft_entry as ge

RTOL = 1e-12
NS = (8, 3, 1)
LINE = re.compile(r"dryrun_multichip OK: mesh=(\{.*?\}), batch=(\d+), chi2=(\S+), engines: (.*)")


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    return float(np.max(np.abs(got - ref) / np.abs(ref)))


@pytest.fixture(scope="module")
def port_runs():
    """Each n's dry run on host members, with the line it printed."""
    runs = {}
    for n in NS:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            runs[n] = ge.dryrun_multichip(n, devices="cpu")
        runs[n]["line"] = out.getvalue().strip().splitlines()[-1]
    return runs


@pytest.fixture(scope="module")
def jax_refs():
    """The dry run's JAX calls without a mesh: the tabulated engine at
    n_y 2000 and 2048 over each n's 2n points, the one-device trapezoid
    of the archived point at n_y 2048, and one ESDIRK call over every
    n's washout points at once."""
    base = jc.config_from_dict(ge.ARCHIVED)
    static = jc.static_choices_from_config(base)
    table = j_make_f_table(base.I_p, jnp, n=ge.DRYRUN_TABLE_N)

    def tabulated(n_y):
        return jax.jit(jax.vmap(lambda p: j_point_yields_fast(p, static, table, jnp, n_y=n_y)))

    def grid(cfg, lo, n):
        pp = j_build_grid(cfg, {"m_chi_GeV": np.geomspace(lo, 2.0, n)})
        return jax.tree.map(jnp.asarray, pp)

    refs = {}
    for n_y in (ge.ENTRY_N_Y, ge.DRYRUN_N_Y):
        fn = tabulated(n_y)
        fn(grid(base, 0.2, 2))  # the first jitted run can differ by ~3e-9
        refs[n_y] = {n: np.asarray(fn(grid(base, 0.2, 2 * n)).DM_over_B) for n in NS}
    pp0 = jax.tree.map(jnp.asarray, jc.point_params_from_config(base, base.P_chi_to_B))
    refs["YB_one_device"] = float(j_yb_tabulated(pp0, static.chi_stats, table, jnp,
                                                 n_y=ge.SP_N_Y))
    cfg_ode = dataclasses.replace(base, Gamma_wash_over_H=0.01, T_min_over_Tp=0.2)
    pp_ode = j_build_grid(cfg_ode, {"m_chi_GeV": np.concatenate(
        [np.geomspace(0.5, 2.0, 2 * n) for n in NS])})
    step = j_make_sweep_step(jc.static_choices_from_config(cfg_ode), impl="esdirk")
    yb = np.asarray(step(jax.tree.map(jnp.asarray, pp_ode), j_make_kjma_grid(jnp)).Y_B)
    offsets = np.cumsum([0] + [2 * n for n in NS])
    refs["esdirk"] = {n: yb[offsets[i]:offsets[i + 1]] for i, n in enumerate(NS)}
    return refs


def test_entry_matches_jax(jit_warmup):
    j_fn, j_args = jg.entry()
    jit_warmup(j_fn, *j_args)
    ref = np.asarray(j_fn(*j_args))
    fn, (pp, table) = ge.entry(device="cpu")
    got = fn(pp, table)
    assert got.shape == (8,) and got.dtype == torch.float64 and got.device.type == "cpu"
    assert pp.m_chi_GeV.device.type == "cpu" and table.values.shape == (ge.ENTRY_TABLE_N,)
    rel = _rel(got.numpy(), ref)
    print(f"RESIDUAL entry fn vs JAX max_rel={rel:.3e}")
    assert rel <= RTOL


@pytest.mark.parametrize("n", NS)
def test_dryrun_matches_the_same_jax_calls(n, port_runs, jax_refs):
    run = port_runs[n]
    sp = 2 if n % 2 == 0 else 1
    assert run["mesh"] == {"dp": n // sp, "sp": sp} and run["batch"] == 2 * n
    expected = ["tabulated(dp)", "gridshard(sp)", "pallas(shard_map)", "esdirk(dp)",
                "ensemble(dp)"]
    if sp == 1:
        expected.remove("gridshard(sp)")
        assert run["YB_sp"] is None
    assert list(run["engines"]) == expected and set(run["engines"].values()) == {"ok"}
    ratios = jax_refs[ge.ENTRY_N_Y][n]
    rels = {
        "ratios": _rel(run["ratios"], ratios),
        "ratios_kernel": _rel(run["ratios_kernel"], jax_refs[ge.DRYRUN_N_Y][n]),
        "Y_B_esdirk": _rel(run["Y_B_esdirk"], jax_refs["esdirk"][n]),
    }
    if sp == 2:
        rels["YB_sp"] = _rel(run["YB_sp"], jax_refs["YB_one_device"])
    chi2 = float(np.mean((ratios / PLANCK_DM_OVER_B - 1.0) ** 2))
    rels["chi2"] = _rel(run["chi2"], chi2)
    for key, rel in rels.items():
        print(f"RESIDUAL dryrun n={n} {key} max_rel={rel:.3e}")
    assert max(rels.values()) <= RTOL, rels
    assert _rel(run["ratios_kernel"], run["ratios"]) <= ge.KERNEL_RTOL


def test_dryrun_prints_jax_s_line(port_runs, capsys):
    jg.dryrun_multichip(8)
    ref = LINE.fullmatch(capsys.readouterr().out.strip().splitlines()[-1])
    got = LINE.fullmatch(port_runs[8]["line"])
    assert ref and got
    assert got.groups() == ref.groups()
    for n in NS:
        line = LINE.fullmatch(port_runs[n]["line"])
        assert line.group(1) == str(port_runs[n]["mesh"])
        assert line.group(3) == f"{port_runs[n]['chi2']:.3e}"
