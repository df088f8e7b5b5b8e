"""Accuracy gates: the adversarial audit population, the panel-quadrature
population audit and its tri-state resolver, and the shared scoring rules.

Counterpart of ``bdlz_tpu/validation.py:22-447``.  The audit decides a
quadrature *scheme*, so it never depends on the device: like the JAX
package's NumPy audit it runs on the host, here through the port's own
batched integrands on CPU tensors (the sample is integrated all at once
instead of in a per-point loop).  The LZ scenario and bounce gates
(``chain_mode_audit``, ``thermal_mode_audit``, ``bounce_audit``,
``bdlz_tpu/validation.py:558-862``) score the same populations with the
same tolerances; their kernels run on the ``device`` they are given.

The engine gate's truth (``reference_ratios``, ``bdlz_tpu/validation.py:
428-547``) is the port's own per-point CPU f64 loop over its direct
pipeline, cached on disk under the JAX package's key layout.
"""
from __future__ import annotations

import sys
from typing import Any, Dict, NamedTuple

import numpy as np

from bdlz_tpu_torch.ops.kjma_kernel import REDUCE_DEFAULT
from bdlz_tpu_torch.utils.profiling import span


class AuditPopulation(NamedTuple):
    grid: Any                     # PointParams, product=False flat grid
    axes: Dict[str, np.ndarray]   # the raw per-point arrays (for reports)
    counts: Dict[str, int]        # population-class sizes


def build_audit_population(base, n: int, seed: int = 0) -> AuditPopulation:
    """n randomized configs spanning the pipeline's adversarial corners:
    60% broad draws, 20% deep Maxwell–Boltzmann (m ≫ T_p), 10% windows
    against the y-support clips, 10% with the T = m/3 seam mid-window.
    The same draws as the JAX package's population for the same seed."""
    from bdlz_tpu_torch.parallel.sweep import build_grid

    rng = np.random.default_rng(seed)
    n = int(n)
    n_broad = int(0.6 * n)
    n_mb = int(0.2 * n)
    n_clip = int(0.1 * n)
    n_seam = n - n_broad - n_mb - n_clip

    m = np.concatenate([
        10 ** rng.uniform(-1.0, 1.0, n_broad),
        10 ** rng.uniform(1.5, 3.0, n_mb),
        10 ** rng.uniform(-1.0, 1.0, n_clip),
        np.full(n_seam, np.nan),
    ])
    T_p = np.concatenate([
        10 ** rng.uniform(1.5, 2.5, n_broad),
        10 ** rng.uniform(1.4, 1.7, n_mb),
        10 ** rng.uniform(1.5, 2.5, n_clip),
        10 ** rng.uniform(1.5, 2.5, n_seam),
    ])
    if n_seam:
        m[-n_seam:] = 3.0 * T_p[-n_seam:] * rng.uniform(0.8, 1.2, n_seam)

    sigma_y = rng.uniform(2.0, 20.0, n)
    beta = rng.uniform(50.0, 500.0, n)
    v_w = rng.uniform(0.05, 0.95, n)
    P = rng.uniform(0.01, 0.9, n)
    T_min = np.full(n, base.T_min_over_Tp)
    T_max = np.full(n, base.T_max_over_Tp)
    T_min[n_broad + n_mb:n_broad + n_mb + n_clip] = 10 ** rng.uniform(
        -4.0, -2.0, n_clip
    )
    T_max[n_broad + n_mb:n_broad + n_mb + n_clip] = rng.uniform(
        3.0, 8.0, n_clip
    )

    axes = {
        "m_chi_GeV": m,
        "T_p_GeV": T_p,
        "source_shape_sigma_y": sigma_y,
        "beta_over_H": beta,
        "v_w": v_w,
        "P_chi_to_B": P,
        "T_min_over_Tp": T_min,
        "T_max_over_Tp": T_max,
    }
    grid = build_grid(base, axes, product=False)
    counts = {
        "broad": n_broad, "deep_MB": n_mb,
        "clip_edges": n_clip, "seam_T=m/3": n_seam,
    }
    return AuditPopulation(grid=grid, axes=axes, counts=counts)


class PanelAuditResult(NamedTuple):
    """Outcome of one per-population panel-quadrature convergence audit."""

    ok: bool
    reason: str                       # "" when ok; the loud fallback cause
    n_sampled: int
    n_seam_inside: int                # points with the T=m/3 seam in-window
    max_rel_vs_trap: "float | None"   # GL(m) vs the reference trapezoid
    max_err_half: "float | None"      # ladder: GL(m/2) vs GL(m)
    max_err_quarter: "float | None"   # ladder: GL(m/4) vs GL(m)
    n_quad_nodes: int


def _audit_sample_indices(
    grid, y_lo: np.ndarray, y_hi: np.ndarray, n_sample: int
) -> np.ndarray:
    """Deterministic audit sample: an even stride plus the population's
    adversarial extremes (deepest Maxwell–Boltzmann, most relativistic,
    widest/narrowest window and source, boundary-layer proxy m/(T_p·β̂),
    nearest to the seam)."""
    n = int(np.asarray(grid.m_chi_GeV).shape[0])
    m = np.asarray(grid.m_chi_GeV, dtype=np.float64)
    Tp = np.asarray(grid.T_p_GeV, dtype=np.float64)
    beta = np.asarray(grid.beta_over_H, dtype=np.float64)
    sigma = np.asarray(grid.sigma_y, dtype=np.float64)
    span = np.asarray(y_hi - y_lo, dtype=np.float64)
    stride = np.linspace(0, n - 1, min(int(n_sample), n)).astype(np.int64)
    corners = np.array([
        0, n - 1,
        int(np.argmax(m / Tp)), int(np.argmin(m / Tp)),
        int(np.argmax(m / (Tp * np.maximum(beta, 1e-30)))),
        int(np.argmax(span)), int(np.argmin(span)),
        int(np.argmax(sigma)), int(np.argmin(sigma)),
        int(np.argmin(np.abs(3.0 * Tp - m))),
    ])
    return np.unique(np.concatenate([stride, corners]))


def panel_gl_population_audit(
    grid,
    chi_stats: str,
    n_y: int = 8000,
    table=None,
    n_sample: int = 24,
    rel_tol: float = 1e-9,
    decay_ratio_max: float = 0.25,
    decay_floor: float = 1e-10,
) -> PanelAuditResult:
    """Decide whether snapped-panel Gauss–Legendre may replace the
    trapezoid for THIS population (the ``quad_panel_gl: None`` resolver).

    The three checks of the JAX package's audit, on the host:

    * no point has the T = m/3 seam inside its y-window (checked on every
      point: the trapezoid carries O(h) jump error there, so the scheme
      may not change under the 1e-6 reference contract);
    * the node ladder decays spectrally on a deterministic adversarial
      sample: err(m/2) ≤ max(decay_ratio_max · err(m/4), decay_floor);
    * the rule agrees with the n_y-node trapezoid to ``rel_tol`` on the
      same sample.

    ``grid`` is a PointParams of host arrays; ``table`` a host-built
    ``KJMATable`` (built from the grid's uniform I_p when omitted).
    """
    import torch

    from bdlz_tpu_torch.interop import point_params_from_numpy
    from bdlz_tpu_torch.ops.kjma_table import make_f_table, table_to_device
    from bdlz_tpu_torch.solvers.panels import (
        integrate_YB_panel_gl,
        make_panel_scheme,
        y_branch_seam,
    )
    from bdlz_tpu_torch.solvers.quadrature import (
        integrate_YB_quadrature_tabulated,
        quadrature_bounds,
    )

    n = int(np.asarray(grid.m_chi_GeV).shape[0])
    if n == 0:
        return PanelAuditResult(
            False, "empty population", 0, 0, None, None, None, 0
        )
    I_p = np.asarray(grid.I_p, dtype=np.float64)
    if np.ptp(I_p) != 0.0:
        return PanelAuditResult(
            False, "population sweeps I_p (per-I_p table unavailable)",
            0, 0, None, None, None, 0,
        )
    host = torch.device("cpu")
    pp = point_params_from_numpy(grid, host)
    y_lo, y_hi = quadrature_bounds(pp)
    y_seam = y_branch_seam(pp)
    seam_inside = (y_seam > y_lo) & (y_seam < y_hi) & (y_hi > y_lo)
    n_seam = int(seam_inside.sum())
    scheme = make_panel_scheme(host)
    if n_seam:
        return PanelAuditResult(
            False,
            f"T=m/3 branch seam inside the y-window for {n_seam}/{n} "
            "points: the reference trapezoid carries O(h) jump error "
            "there, so the 1e-6 reference contract pins the scheme "
            "(set quad_panel_gl=true explicitly for the converged panel "
            "values)",
            0, n_seam, None, None, None, scheme.n_quad_nodes,
        )

    sample = _audit_sample_indices(grid, y_lo.numpy(), y_hi.numpy(), n_sample)
    if table is None:
        table = make_f_table(float(I_p.reshape(-1)[0]))
    table = table_to_device(table, host)
    half = make_panel_scheme(host, n_nodes=max(scheme.nodes.shape[0] // 2, 2))
    quarter = make_panel_scheme(host, n_nodes=max(scheme.nodes.shape[0] // 4, 2))
    idx = torch.as_tensor(sample, dtype=torch.int64)
    pp_s = type(pp)(*(f[idx] for f in pp))
    trap = integrate_YB_quadrature_tabulated(pp_s, chi_stats, table, n_y=int(n_y))
    vals = {key: integrate_YB_panel_gl(pp_s, chi_stats, table, scheme=sch).numpy()
            for key, sch in (("m", scheme), ("h", half), ("q", quarter))}
    try:
        errs_trap = relative_errors(vals["m"], trap.numpy())
        err_h = relative_errors(vals["h"], vals["m"])
        err_q = relative_errors(vals["q"], vals["m"])
    except GateFailure as exc:
        return PanelAuditResult(
            False, f"audit sample not scoreable: {exc}", len(sample),
            0, None, None, None, scheme.n_quad_nodes,
        )
    stalled = err_h > np.maximum(decay_ratio_max * err_q, decay_floor)
    max_trap = float(errs_trap.max())
    res = PanelAuditResult(
        ok=True, reason="", n_sampled=len(sample), n_seam_inside=0,
        max_rel_vs_trap=max_trap,
        max_err_half=float(err_h.max()),
        max_err_quarter=float(err_q.max()),
        n_quad_nodes=scheme.n_quad_nodes,
    )
    if stalled.any():
        i_bad = int(sample[int(np.argmax(err_h / np.maximum(err_q, 1e-300)))])
        return res._replace(ok=False, reason=(
            f"node ladder is not spectrally decaying on "
            f"{int(stalled.sum())}/{len(sample)} sampled points (worst at "
            f"flat index {i_bad}: err(m/2)={float(err_h.max()):.2e} vs "
            f"err(m/4)={float(err_q.max()):.2e}) — unresolved integrand "
            "feature; staying on the trapezoid"
        ))
    if max_trap > rel_tol:
        i_bad = int(sample[int(np.argmax(errs_trap))])
        return res._replace(ok=False, reason=(
            f"panel rule disagrees with the n_y={int(n_y)} reference "
            f"trapezoid by {max_trap:.2e} > {rel_tol:.0e} (worst at flat "
            f"index {i_bad}); staying on the trapezoid"
        ))
    return res


def resolve_quad_panel_gl(
    grid, static, impl: str, n_y: int, table=None, label: str = "sweep",
) -> "tuple[bool, PanelAuditResult | None]":
    """THE tri-state resolver for ``static.quad_panel_gl``.

    Engines other than ``tabulated`` resolve False (warning when the
    caller asked for the panel rule); an explicit True/False passes
    through; ``None`` runs :func:`panel_gl_population_audit` over ``grid``
    and announces the verdict on stderr.  Returns ``(resolved, audit)``,
    ``audit`` None unless it ran.
    """
    q = static.quad_panel_gl
    if impl != "tabulated":
        if q:
            print(
                f"[{label}] quad_panel_gl requires the tabulated engine; "
                f"ignoring it for impl={impl!r}",
                file=sys.stderr,
            )
        return False, None
    if q is not None:
        return bool(q), None
    with span("audit"):
        audit = panel_gl_population_audit(
            grid, static.chi_stats, n_y=int(n_y), table=table,
        )
    if audit.ok:
        print(
            f"[{label}] quad_panel_gl on: audit passed over "
            f"{audit.n_sampled} sampled points (vs trapezoid "
            f"{audit.max_rel_vs_trap:.1e}, ladder "
            f"{audit.max_err_half:.1e}/{audit.max_err_quarter:.1e}) — "
            f"{audit.n_quad_nodes} nodes/point instead of "
            f"{max(int(n_y), 2000)}",
            file=sys.stderr,
        )
    else:
        print(
            f"[{label}] quad_panel_gl off (audit fallback to trapezoid): "
            f"{audit.reason}",
            file=sys.stderr,
        )
    return audit.ok, audit


class GateFailure(ValueError):
    """An accuracy gate could not produce a trustworthy number."""


def relative_errors(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per-point relative error with the gate's zero-reference rule:
    ``|got/ref − 1|`` where ``ref != 0``, else ``|got| / median(|ref[nz]|)``.
    Non-finite values under comparison raise :class:`GateFailure`."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    bad = ~np.isfinite(got)
    if bad.any():
        raise GateFailure(
            f"{int(bad.sum())}/{got.size} non-finite values under comparison"
        )
    bad_ref = ~np.isfinite(ref)
    if bad_ref.any():
        raise GateFailure(
            f"{int(bad_ref.sum())}/{ref.size} non-finite reference values "
            "under comparison"
        )
    nz = ref != 0.0
    if not nz.any():
        raise GateFailure(
            "comparison reference is identically zero — nothing to compare"
        )
    errs = np.empty(ref.shape)
    errs[nz] = np.abs(got[nz] / ref[nz] - 1.0)
    if (~nz).any():
        abs_scale = float(np.median(np.abs(ref[nz])))
        errs[~nz] = np.abs(got[~nz]) / abs_scale
    return errs


def population_max_rel(run_chunk, chunk: int, ref: np.ndarray) -> float:
    """Max rel err of a chunk-runner (``run_chunk(lo, hi)`` returning at
    least ``hi − lo`` values) over a gate population against ``ref``.
    Zero-reference points are held to an absolute tolerance of 1e-6 ×
    the median nonzero |ref| and excluded from the max."""
    n = int(ref.shape[0])
    got = np.empty(n)
    for lo in range(0, n, int(chunk)):
        hi = min(lo + int(chunk), n)
        got[lo:hi] = np.asarray(run_chunk(lo, hi))[: hi - lo]
    errs = relative_errors(got, ref)
    nz = ref != 0.0
    n_zero = int(n - nz.sum())
    if n_zero:
        abs_tol = 1e-6 * float(np.median(np.abs(ref[nz])))
        worst = float(np.max(np.abs(got[~nz])))
        if worst > abs_tol:
            raise GateFailure(
                f"engine output {worst:.3e} at a zero-reference point "
                f"exceeds the absolute tolerance {abs_tol:.3e} "
                f"({n_zero}/{n} ref==0 points)"
            )
        print(
            f"[gate] {n_zero}/{n} ref==0 points held to |got| <= "
            f"{abs_tol:.3e} (max {worst:.3e}); excluded from max-rel",
            file=sys.stderr, flush=True,
        )
    return float(np.max(errs[nz]))


def engine_population_max_rel(
    pop_grid, ref: np.ndarray, static, table, *, impl: str, n_y: int, fuse_exp: bool = False,
    reduce: bool = REDUCE_DEFAULT, device=None, mesh=None,
) -> float:
    """Build the engine's chunk runner over the population grid
    (``parallel.sweep.make_chunk_runner``: the whole population in one
    chunk, padded to a multiple of the mesh's members, unless the memory
    clamp cuts it) and measure :func:`population_max_rel`.  ``impl`` with
    ``fuse_exp``/``reduce`` picks the engine and, for ``"kernel"``, its
    tier (P1, P2, P3, P4); ``table`` is the F-table on any device, or with a
    ``mesh`` ``{device: aux}`` as ``build_chunk_engine`` builds it."""
    from bdlz_tpu_torch.parallel.sweep import make_chunk_runner, mesh_pad

    run_chunk, chunk = make_chunk_runner(
        pop_grid, mesh_pad(int(ref.shape[0]), mesh), static, table, impl=impl, n_y=n_y,
        fuse_exp=fuse_exp, reduce=reduce, device=device, mesh=mesh)
    return population_max_rel(run_chunk, chunk, ref)


def reference_ratios(grid, static, n_y: "int | None" = None) -> np.ndarray:
    """DM_over_B per point on the port's reference path: the direct
    pipeline (``point_yields``) on the CPU in f64, one point at a time.

    ``n_y`` overrides the quadrature resolution so a gate compares at
    equal discretization; with ``static.quad_panel_gl`` resolved True the
    reference runs the same panel rule over the direct integrand."""
    from bdlz_tpu_torch.interop import point_params_from_numpy
    from bdlz_tpu_torch.models.yields_pipeline import point_yields
    from bdlz_tpu_torch.physics.percolation import make_kjma_grid

    if n_y is not None and int(n_y) != static.n_y:
        static = static._replace(n_y=int(n_y))
    kgrid = make_kjma_grid("cpu")
    n = int(np.asarray(grid.m_chi_GeV).shape[0])
    out = np.empty(n)
    for i in range(n):
        pp_i = type(grid)(*(np.asarray(f, dtype=np.float64)[i:i + 1] for f in grid))
        out[i] = float(point_yields(point_params_from_numpy(pp_i, "cpu"), static,
                                    kgrid).DM_over_B[0])
    return out


def reference_ratios_cached(
    grid, static, n_y: "int | None" = None, cache_dir: "str | None" = None,
    stats: "dict | None" = None,
) -> np.ndarray:
    """:func:`reference_ratios` with an on-disk cache in the hardened
    provenance store, keyed by ``refcache_identity`` (population bytes,
    the static choices, n_y and the reference source fingerprint), as
    ``ref_<key>.npy``.  The default directory is
    ``$XDG_CACHE_HOME``/``~/.cache`` + ``bdlz_torch_refcache``;
    ``BDLZ_REF_CACHE_DIR=''`` disables it.  ``stats`` records
    ``{"cache_hit": bool}``."""
    import os

    from bdlz_tpu_torch.provenance import Store, StoreUntrustedError
    from bdlz_tpu_torch.provenance.identity import refcache_identity

    if cache_dir is None:
        cache_root = os.environ.get(
            "XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache"))
        cache_dir = os.environ.get(
            "BDLZ_REF_CACHE_DIR", os.path.join(cache_root, "bdlz_torch_refcache"))
    if stats is not None:
        stats["cache_hit"] = False
    if not cache_dir:
        return reference_ratios(grid, static, n_y=n_y)
    try:
        store = Store(cache_dir)
    except StoreUntrustedError as exc:
        print(f"[refcache] {exc}; refusing to trust it (caching disabled)",
              file=sys.stderr)
        return reference_ratios(grid, static, n_y=n_y)
    name = f"ref_{refcache_identity(grid, static, n_y).digest(24)}.npy"
    n = int(np.asarray(grid.m_chi_GeV).shape[0])
    out = store.get_array(name)
    if out is not None and out.shape == (n,):
        if stats is not None:
            stats["cache_hit"] = True
        return out
    out = reference_ratios(grid, static, n_y=n_y)
    store.put_array(name, out)
    return out


# ---------------------------------------------------------------------------
# LZ scenario-mode and bounce gates: deterministic samples scored against
# independent references; a non-finite value is a GateFailure, never a
# small error.
# ---------------------------------------------------------------------------

class ChainAuditResult(NamedTuple):
    """Verdict of :func:`chain_mode_audit`."""

    ok: bool
    #: max rel err of the N = 2 chain vs the coherent two-channel kernel
    #: (contract <= 1e-12: the chain must reduce to it)
    n2_vs_coherent: float
    #: max abs err of the flat-band chain vs the closed-form path-graph
    #: populations (the midpoint rule is exact for a constant H)
    analytic_flat_band: float
    #: max |Σ_k P_k − 1| over the population
    unitarity_defect: float
    reason: "str | None" = None


def chain_mode_audit(
    profile,
    n_levels: int = 3,
    n_sample: int = 24,
    rtol_n2: float = 1e-12,
    atol_analytic: float = 1e-10,
    device=None,
) -> ChainAuditResult:
    """The ``lz_mode="chain"`` gate over geomspace(0.02, 0.95) speeds:
    (a) N = 2 equals the coherent kernel to ``rtol_n2``; (b) the flat band
    at ``n_levels`` reproduces the closed-form populations; (c) the
    populations stay normalized."""
    from bdlz_tpu_torch.lz.chain import (
        chain_populations_for_speeds,
        uniform_chain_populations_analytic,
        validate_n_levels,
    )
    from bdlz_tpu_torch.lz.profile import BounceProfile, load_profile_csv
    from bdlz_tpu_torch.lz.sweep_bridge import probabilities_for_points

    n_levels = validate_n_levels(n_levels)
    if isinstance(profile, str):
        profile = load_profile_csv(profile)
    v = np.geomspace(0.02, 0.95, int(n_sample))
    try:
        P2 = chain_populations_for_speeds(profile, v, 2, device=device)[:, -1]
        P_ref = probabilities_for_points(profile, v, method="coherent", device=device)
        n2_err = float(relative_errors(P2, P_ref).max())

        Pn = chain_populations_for_speeds(profile, v, n_levels, device=device)
        if not np.isfinite(Pn).all():
            raise GateFailure("non-finite chain populations")
        unit = float(np.abs(Pn.sum(axis=1) - 1.0).max())

        m_flat, L = 0.35, 6.0
        xi = np.linspace(0.0, L, 257)
        flat = BounceProfile(
            xi=xi, delta=np.zeros_like(xi), mix=np.full_like(xi, m_flat)
        )
        an_err = 0.0
        for vv in (0.2, 0.5, 0.9):
            got = chain_populations_for_speeds(flat, [vv], n_levels, device=device)[0]
            ref = uniform_chain_populations_analytic(n_levels, m_flat, L, vv)
            an_err = max(an_err, float(np.abs(got - ref).max()))
    except GateFailure as exc:
        return ChainAuditResult(
            ok=False, n2_vs_coherent=np.inf, analytic_flat_band=np.inf,
            unitarity_defect=np.inf, reason=str(exc),
        )
    ok = (n2_err <= rtol_n2 and an_err <= atol_analytic
          and unit <= atol_analytic)
    reason = None
    if not ok:
        reason = (
            f"chain gate breach: N=2 vs coherent {n2_err:.3e} "
            f"(<= {rtol_n2:.0e}), flat-band analytic {an_err:.3e}, "
            f"unitarity {unit:.3e} (<= {atol_analytic:.0e})"
        )
    return ChainAuditResult(
        ok=ok, n2_vs_coherent=n2_err, analytic_flat_band=an_err,
        unitarity_defect=unit, reason=reason,
    )


class ThermalAuditResult(NamedTuple):
    """Verdict of :func:`thermal_mode_audit`."""

    ok: bool
    #: T → 0 and η → 0 reproduce the coherent kernel bit for bit
    cold_limit_bitwise: bool
    #: max Γ_φ(T_i) − Γ_φ(T_{i+1}) on an ascending grid (<= 0: monotone)
    monotonicity_defect: float
    #: |Γ(T ≫ ω_c) / (2 η ω_c) − 1|
    saturation_err: float
    reason: "str | None" = None


def thermal_mode_audit(
    profile,
    eta: float,
    omega_c_GeV: float,
    n_sample: int = 16,
    T_grid=None,
    device=None,
) -> ThermalAuditResult:
    """The ``lz_mode="thermal"`` gate: (a) the cold limit (T = 0, and
    η = 0) equals the coherent P bit for bit; (b) Γ_φ(T) is monotone with
    Γ(0) = 0; (c) Γ saturates at 2ηω_c."""
    from bdlz_tpu_torch.lz.profile import load_profile_csv
    from bdlz_tpu_torch.lz.sweep_bridge import probabilities_for_points
    from bdlz_tpu_torch.lz.thermal import (
        thermal_gamma_phi,
        thermal_probabilities_for_points,
        validate_bath,
    )

    eta, omega_c = validate_bath(eta, omega_c_GeV)
    if isinstance(profile, str):
        profile = load_profile_csv(profile)
    v = np.geomspace(0.05, 0.95, int(n_sample))
    if T_grid is None:
        T_grid = np.geomspace(
            max(omega_c, 1e-6) * 1e-3, max(omega_c, 1e-6) * 1e3, 41
        )
    T_grid = np.asarray(T_grid, dtype=np.float64)
    try:
        P_cold = thermal_probabilities_for_points(
            profile, v, 0.0, eta, omega_c, device=device
        )
        P_eta0 = thermal_probabilities_for_points(
            profile, v, float(T_grid[-1]), 0.0, omega_c, device=device
        )
        P_ref = probabilities_for_points(profile, v, method="coherent", device=device)
        if not (np.isfinite(P_cold).all() and np.isfinite(P_eta0).all()):
            raise GateFailure("non-finite thermal-mode populations")
        cold_bitwise = bool(
            np.array_equal(P_cold, P_ref) and np.array_equal(P_eta0, P_ref)
        )
    except GateFailure as exc:
        return ThermalAuditResult(
            ok=False, cold_limit_bitwise=False,
            monotonicity_defect=np.inf, saturation_err=np.inf,
            reason=str(exc),
        )
    gam = np.asarray(thermal_gamma_phi(np.sort(T_grid), eta, omega_c))
    if not np.isfinite(gam).all():
        return ThermalAuditResult(
            ok=False, cold_limit_bitwise=cold_bitwise,
            monotonicity_defect=np.inf, saturation_err=np.inf,
            reason="non-finite derived dephasing rate",
        )
    mono = float(np.max(np.diff(gam) * -1.0, initial=0.0))
    gam0 = float(thermal_gamma_phi(0.0, eta, omega_c))
    sat_ref = 2.0 * eta * omega_c
    if sat_ref > 0.0:
        sat = abs(
            float(thermal_gamma_phi(omega_c * 1e6, eta, omega_c)) / sat_ref
            - 1.0
        )
    else:
        # η = 0 or ω_c = 0: the rate is identically zero
        sat = float(np.abs(gam).max(initial=0.0))
    ok = cold_bitwise and mono <= 0.0 and gam0 == 0.0 and sat <= 1e-3
    reason = None
    if not ok:
        reason = (
            f"thermal gate breach: cold_bitwise={cold_bitwise}, "
            f"monotonicity defect {mono:.3e} (<= 0), Gamma(0)={gam0}, "
            f"saturation err {sat:.3e} (<= 1e-3)"
        )
    return ThermalAuditResult(
        ok=ok, cold_limit_bitwise=cold_bitwise, monotonicity_defect=mono,
        saturation_err=sat, reason=reason,
    )


class BounceAuditResult(NamedTuple):
    """Verdict of :func:`bounce_audit`."""

    ok: bool
    #: rel err of the shot reference potential's P(v_w = 0.3, local) vs
    #: the archived P_chi_to_B
    P_vs_archived: float
    #: rel dev of the shot action vs the closed-form thin-wall S₄
    action_vs_thin_wall: float
    #: Δ(ξ) crossings on the derived profile (contract: exactly 1)
    n_crossings: int
    reason: "str | None" = None


def bounce_audit(
    rtol_P: float = 1e-6,
    rtol_action: float = 0.12,
    n_xi: "int | None" = None,
    device=None,
) -> BounceAuditResult:
    """The bounce-solver gate: shoot the reference potential on ``device``
    and score (a) P at the benchmark wall speed against the archived
    ``P_chi_to_B``; (b) the action against the thin-wall S₄; (c) the
    profile's crossing count.  A non-converged shoot or a non-finite
    output is a failed result."""
    from bdlz_tpu_torch.bounce.potential import (
        REFERENCE_P_CHI_TO_B,
        REFERENCE_V_WALL,
        reference_potential,
        thin_wall_action,
    )
    from bdlz_tpu_torch.bounce.shooting import (
        BounceSolveError,
        bounce_profile,
        solve_bounce,
    )
    from bdlz_tpu_torch.lz.profile import find_crossings
    from bdlz_tpu_torch.lz.sweep_bridge import probabilities_for_points

    spec = reference_potential()
    try:
        sol = solve_bounce(spec, device=device)
        if not bool(sol.converged):
            raise GateFailure(
                f"bounce shoot did not converge on the reference potential "
                f"(phi0={float(sol.phi0)!r}, action={float(sol.action)!r})"
            )
        if not np.isfinite(float(sol.action)):
            raise GateFailure("non-finite bounce action")
        try:
            kwargs = {} if n_xi is None else {"n_xi": int(n_xi)}
            profile = bounce_profile(spec, solution=sol, **kwargs)
        except BounceSolveError as exc:
            raise GateFailure(str(exc)) from exc
        crossings = find_crossings(profile)
        n_cross = int(crossings.xi_star.size)
        if n_cross != 1:
            raise GateFailure(
                f"reference wall profile must cross Δ = 0 exactly once, "
                f"found {n_cross} crossings"
            )
        P = probabilities_for_points(
            profile, np.asarray([REFERENCE_V_WALL]), method="local"
        )
        if not np.isfinite(P).all():
            raise GateFailure("non-finite bounce-derived probability")
    except GateFailure as exc:
        return BounceAuditResult(
            ok=False, P_vs_archived=np.inf, action_vs_thin_wall=np.inf,
            n_crossings=-1, reason=str(exc),
        )
    p_err = float(
        abs(float(P[0]) - REFERENCE_P_CHI_TO_B) / REFERENCE_P_CHI_TO_B
    )
    s_tw = thin_wall_action(spec)
    a_err = float(abs(float(sol.action) - s_tw) / s_tw)
    ok = p_err <= rtol_P and a_err <= rtol_action
    reason = None
    if not ok:
        reason = (
            f"bounce gate breach: P vs archived {p_err:.3e} "
            f"(<= {rtol_P:.0e}), action vs thin-wall {a_err:.3e} "
            f"(<= {rtol_action:.2f})"
        )
    return BounceAuditResult(
        ok=ok, P_vs_archived=p_err, action_vs_thin_wall=a_err,
        n_crossings=n_cross, reason=reason,
    )
