"""Adaptive tensor-grid emulator builds: populate, probe, refine, save.

Counterpart of ``bdlz_tpu/emulator/build.py``, with the same refinement:
the build fills a tensor grid of the box through the sweep engine
(``parallel.sweep.run_sweep``), then iterates

1. draw seeded random probes (``np.random.default_rng(seed)``), paid once
   into a pool that every later round re-scores;
2. score each pool probe by the gate rule (``validation.relative_errors``,
   maxed over fields) against the interim surface;
3. for each probe over the internal target ``rtol/safety``, insert a
   midpoint on the axis with the largest local curvature score, and split
   every interval whose a-posteriori estimate ``|f''|h²/8·ln10`` exceeds
   the target;
4. evaluate only the new hyperplanes and merge them into the table,

until the whole pool is clean and no estimate is over the target, or
``max_rounds`` is spent; a larger held-out draw (seed + 10000) gives the
recorded ``max_rel_err``.  ``posterior_weight="planck"`` multiplies the
probe scores and the interval estimates by the Planck likelihood weight
of the current surface (floored at 1e-3), so refinement follows the
posterior mass; ``refine_signal="fisher"`` attributes a failing probe's
error to the axis whose exact-pipeline gradient (``sampling.grad``) the
interpolant misses most, instead of the curvature stencil;
``refine_signal="traffic"`` (or ``"traffic*planck"``) weights the same
criterion by the served-query density of a ``traffic=`` snapshot
(``bdlz_tpu_torch/refine``).  Every exact evaluation goes through the
port's ``run_sweep`` (the grid; ``elastic=`` routes it through the
elastic fleet instead) or :func:`make_exact_evaluator` (the probes) with
the build's fault plan, retry policy and store, and on the card with
``impl="kernel"`` through the point kernel P1.
"""
from __future__ import annotations

import sys
import time
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np

from bdlz_tpu_torch.emulator.artifact import (
    FIELDS,
    EmulatorArtifact,
    build_identity,
    save_artifact,
)
from bdlz_tpu_torch.emulator.grid import axis_coord, host_table, interp_log_fields

VALID_SCALES = ("lin", "log")

#: Node spacing (relative to the axis span) below which no midpoint is
#: inserted: past it the error is not interpolation-limited.
_MIN_REL_GAP = 1e-9

_LN10 = float(np.log(10.0))

#: The fields whose exact gradient the Fisher signal compares.
_GRAD_FIELDS = ["rho_B_kg_m3", "rho_DM_kg_m3"]

class EmulatorBuildError(RuntimeError):
    """The build could not produce a trustworthy surface (failed exact
    points inside the box, an invalid spec or option pairing, or a spent
    refinement budget with ``require_converged=True``)."""


class AxisSpec(NamedTuple):
    """One parameter axis of the emulator box (config-schema units)."""

    lo: float
    hi: float
    n0: int = 5          # initial node count
    scale: str = "lin"   # "lin" | "log": node placement and midpoints


class BuildReport(NamedTuple):
    """Provenance of one build, mirrored into the artifact manifest (the
    JAX package's fields)."""

    rounds: List[Dict[str, Any]]
    converged: bool
    max_rel_err: float
    rtol: float
    n_exact_evals: int
    build_seconds: float
    axis_nodes: Dict[str, int]
    quarantined_probes: int = 0
    posterior_weight: "str | None" = None
    weighted_max_rel_err: "float | None" = None
    refine_signal: "str | None" = None
    n_grad_evals: int = 0


def _axis_nodes(spec: AxisSpec) -> np.ndarray:
    if not (np.isfinite(spec.lo) and np.isfinite(spec.hi) and spec.lo < spec.hi):
        raise EmulatorBuildError(f"axis bounds must be finite with lo < hi, got {spec}")
    if spec.n0 < 2:
        raise EmulatorBuildError(f"axis needs >= 2 initial nodes, got {spec}")
    if spec.scale not in VALID_SCALES:
        raise EmulatorBuildError(f"axis scale must be one of {VALID_SCALES}, got {spec.scale!r}")
    if spec.scale == "log":
        if spec.lo <= 0:
            raise EmulatorBuildError(f"log axis needs lo > 0, got {spec}")
        return np.geomspace(spec.lo, spec.hi, spec.n0)
    return np.linspace(spec.lo, spec.hi, spec.n0)


def _midpoint(lo: float, hi: float, scale: str) -> float:
    if scale == "log":
        return float(np.sqrt(lo * hi))
    return 0.5 * (lo + hi)


def _draw_probes(spec: Mapping[str, AxisSpec], n: int, rng: np.random.Generator
                 ) -> Dict[str, np.ndarray]:
    """n random points, per axis uniform in the axis's own scale."""
    cols: Dict[str, np.ndarray] = {}
    for name, ax in spec.items():
        if ax.scale == "log":
            cols[name] = 10.0 ** rng.uniform(np.log10(ax.lo), np.log10(ax.hi), n)
        else:
            cols[name] = rng.uniform(ax.lo, ax.hi, n)
    return cols


def _exact_fields(base, axes: Mapping[str, np.ndarray], static, *, chunk_size: int,
                  n_y: int, impl: str, device, fault_plan=None, retry=None, cache=None,
                  lz_profile=None, elastic=None, mesh=None
                  ) -> Tuple[Dict[str, np.ndarray], int]:
    """The exact pipeline over a product grid through ``run_sweep``
    (chunk healing included).  A point that stays failed — non-finite or
    quarantined — is an :class:`EmulatorBuildError`: the table masks
    nothing.

    ``elastic`` (a worker count, or a dict of ``run_sweep_elastic``
    arguments) runs the grid on the elastic fleet instead, folding each
    chunk as its commit lands; its results are bitwise the serial
    engine's, so both fill the same surface."""
    from bdlz_tpu_torch.parallel.sweep import run_sweep

    if elastic:
        from bdlz_tpu_torch.parallel.scheduler import run_sweep_elastic

        if lz_profile is not None:
            raise EmulatorBuildError(
                "elastic build cannot ship per-point bounce profiles; "
                "drop elastic=... or lz_profile=...")
        if cache is None:
            raise EmulatorBuildError(
                "elastic build needs a shared store for the lease/commit "
                "plane; pass cache=... (a store root or Store)")
        opts = dict(elastic) if isinstance(elastic, Mapping) else {"n_workers": int(elastic)}
        n_total = int(np.prod([len(np.asarray(v)) for v in axes.values()]))
        flat: Dict[str, np.ndarray] = {}

        def _consume(ci, lo, hi, ent):
            # the streaming fold: each chunk lands as its commit is seen
            for f in ent:
                if f in ("failed", "quarantined", "n_retries"):
                    continue
                if f not in flat:
                    flat[f] = np.full(n_total, np.nan)
                flat[f][lo:hi] = np.asarray(ent[f])

        res = run_sweep_elastic(
            base, dict(axes), static, store=cache, chunk_size=chunk_size, n_y=n_y,
            impl=impl, device=device, fault_plan=fault_plan, retry=retry,
            on_chunk=_consume, keep_outputs=False, **opts)
    else:
        res = run_sweep(base, dict(axes), static, chunk_size=chunk_size, n_y=n_y,
                        out_dir=None, keep_outputs=True, impl=impl, device=device,
                        fault_plan=fault_plan, retry=retry, cache=cache,
                        lz_profile=lz_profile, mesh=mesh)
    if res.n_failed:
        bad = np.argwhere(np.asarray(res.failed_mask))[:, 0]
        quarantined = (f", {res.n_quarantined} of them infrastructure-quarantined"
                       if res.n_quarantined else "")
        raise EmulatorBuildError(
            f"{res.n_failed}/{res.n_points} exact pipeline points failed "
            f"(non-finite) inside the emulator box{quarantined} (first flat index "
            f"{int(bad[0])}); shrink the box or fix the configuration"
        )
    return (flat if elastic else dict(res.outputs)), res.n_points


def make_exact_evaluator(base, static, *, n_y: int, impl: str, chunk_size: int = 2048,
                         retry=None, fault_plan=None, quarantine_sink=None, cache=None,
                         lz_profile=None, device=None, mesh=None):
    """Zipped exact evaluator through the sweep's engine:
    ``evaluate(axes) -> {field: (n,) array}`` for equal-length per-point
    columns.  Non-finite outputs pass through as NaN.  Chunks are padded
    to one shape.

    With a ``retry`` policy each chunk call is retried with deterministic
    backoff, and a chunk that stays dead is quarantined — NaN outputs and
    a True region in the mask handed to ``quarantine_sink`` after every
    call — instead of raising.  ``fault_plan`` fires ``probe`` faults
    keyed by the chunk-call counter.  ``cache`` (a ``Store``) reads and
    writes the same chunk entries as ``run_sweep``; the engine is built
    on the first chunk that misses.  ``device`` is the card unless the
    caller asks for the CPU; a ``mesh`` splits each chunk over its
    members (padded to a multiple of them) and gathers the rows.
    """
    from bdlz_tpu_torch.backend import resolve_device
    from bdlz_tpu_torch.models.yields_pipeline import YieldsResult
    from bdlz_tpu_torch.parallel.sweep import (
        build_chunk_engine,
        build_grid,
        chunk_cache_key,
        chunk_entry_arrays,
        chunk_entry_ok,
        device_platform,
        engine_identity_extra,
        evaluate_chunk,
        mesh_pad,
    )
    from bdlz_tpu_torch.utils.retry import call_with_retry

    dev = resolve_device(device) if mesh is None else mesh.local_devices[0]
    fields = YieldsResult._fields
    lz_mode = getattr(static, "lz_mode", "two_channel")
    if lz_mode != "two_channel":
        if lz_profile is None:
            raise ValueError(
                f"lz_mode={lz_mode!r} derives P per point from a bounce "
                "profile; pass lz_profile to the exact evaluator"
            )
        from bdlz_tpu_torch.lz.profile import load_profile_csv

        if isinstance(lz_profile, str):
            lz_profile = load_profile_csv(lz_profile)

    engine: Dict[str, Any] = {}

    def _ensure_engine():
        if "step" not in engine:
            engine["step"], engine["aux"] = build_chunk_engine(
                base, static, n_y=n_y, impl=impl, device=dev, mesh=mesh)
        return engine["step"], engine["aux"]

    def _chunk_extra(pp, lo, hi):
        esdirk_knobs = None
        if impl == "esdirk":
            from bdlz_tpu_torch.solvers.batching import resolve_engine_knobs

            esdirk_knobs = resolve_engine_knobs(static, np.asarray(pp.I_p)[lo:hi])
        return engine_identity_extra(static, impl, esdirk_knobs=esdirk_knobs,
                                     faults=fault_plan)

    calls = [0]

    def evaluate(axes: Mapping[str, Any]) -> Dict[str, np.ndarray]:
        pp = build_grid(base, dict(axes), P_base=0.0 if lz_mode != "two_channel" else None,
                        product=False)
        if lz_mode != "two_channel":
            from bdlz_tpu_torch.lz.sweep_bridge import scenario_probabilities_for_points

            pp = pp._replace(P=np.asarray(scenario_probabilities_for_points(
                lz_profile, static, np.asarray(pp.v_w), T_p_GeV=np.asarray(pp.T_p_GeV),
                device=dev), dtype=np.float64))
        n = int(np.asarray(pp.m_chi_GeV).shape[0])
        chunk = min(int(chunk_size), n) if chunk_size else n
        out: Dict[str, List[np.ndarray]] = {f: [] for f in fields}
        qmask = np.zeros(n, dtype=bool)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            # the fault key is the logical chunk call; retries share it
            call_idx = calls[0]
            calls[0] += 1
            key = None
            if cache is not None:
                key = chunk_cache_key(
                    base, static, pp, lo, hi, n_y=n_y, impl=impl,
                    platform=device_platform(dev), extra=_chunk_extra(pp, lo, hi),
                    fault_ctx=("probe", call_idx, lo, hi) if fault_plan is not None else None)
                ent = cache.get_npz(f"sweep_chunk/{key}.npz")
                if chunk_entry_ok(ent, hi - lo):
                    for f in fields:
                        out[f].append(ent[f])
                    qm = ent.get("quarantined")
                    if qm is not None:
                        qmask[lo:hi] = np.asarray(qm, dtype=bool)
                    continue
            attempts = [0]

            def one_chunk(lo=lo, hi=hi, call_idx=call_idx, attempts=attempts):
                attempts[0] += 1
                if fault_plan is not None:
                    fault_plan.fire("probe", call_idx)
                return evaluate_chunk(_ensure_engine(), pp, hi - lo,
                                      (lo, hi, mesh_pad(chunk, mesh)), mesh)

            quarantined_here = False
            try:
                host = (call_with_retry(one_chunk, retry, label=f"probe{lo}")
                        if retry is not None else one_chunk())
            except Exception:  # noqa: BLE001 — quarantined when allowed
                if quarantine_sink is None:
                    raise
                host = {f: np.full(hi - lo, np.nan) for f in fields}
                qmask[lo:hi] = True
                quarantined_here = True
            if cache is not None and (not quarantined_here or fault_plan is not None):
                cache.put_npz(f"sweep_chunk/{key}.npz", chunk_entry_arrays(
                    host, n_retries=max(attempts[0] - 1, 0),
                    qmask=np.ones(hi - lo, dtype=bool) if quarantined_here else None))
            for f in fields:
                out[f].append(host[f])
        if quarantine_sink is not None:
            quarantine_sink(qmask)
        return {f: np.concatenate(v) for f, v in out.items()}

    return evaluate


def _emulated_fields(axis_nodes: List[np.ndarray], axis_scales: List[str],
                     log_values: Dict[str, np.ndarray], probes: np.ndarray
                     ) -> Dict[str, np.ndarray]:
    """The interim surface at (n, d) probe points, through the query's own
    interpolation (on the host)."""
    import torch

    logs = interp_log_fields(torch.from_numpy(np.ascontiguousarray(probes, dtype=np.float64)),
                             host_table(axis_nodes, axis_scales, log_values))
    return {f: torch.pow(10.0, v).numpy() for f, v in logs.items()}


def _probe_errors(emu: Dict[str, np.ndarray], exact: Dict[str, np.ndarray]) -> np.ndarray:
    """Per-probe error: max over fields of the gate rule."""
    from bdlz_tpu_torch.validation import relative_errors

    return np.max(np.stack([relative_errors(emu[f], exact[f]) for f in emu]), axis=0)


def _curvature_scores(log_values: Dict[str, np.ndarray], axis_nodes: List[np.ndarray],
                      axis_scales: List[str], probe: np.ndarray) -> np.ndarray:
    """Per axis, ``|f''|·h²`` of log10(value) at the probe's nearest grid
    node (second divided difference in the axis's scale coordinate, h the
    probe's bracketing gap); a 2-node axis scores +inf."""
    d = len(axis_nodes)
    near = tuple(int(np.clip(np.searchsorted(axis_nodes[k], probe[k]), 0,
                             len(axis_nodes[k]) - 1)) for k in range(d))
    scores = np.zeros(d)
    for k in range(d):
        nodes = axis_nodes[k]
        n_k = len(nodes)
        if n_k < 3:
            scores[k] = np.inf
            continue
        i = int(np.clip(near[k], 1, n_k - 2))
        u = axis_coord(np.asarray(nodes), axis_scales[k])
        bracket = int(np.clip(np.searchsorted(nodes, probe[k]) - 1, 0, n_k - 2))
        h = float(u[bracket + 1] - u[bracket])
        du_lo = float(u[i] - u[i - 1])
        du_hi = float(u[i + 1] - u[i])
        for logv in log_values.values():
            lo = near[:k] + (i - 1,) + near[k + 1:]
            mid = near[:k] + (i,) + near[k + 1:]
            hi = near[:k] + (i + 1,) + near[k + 1:]
            f2 = 2.0 * ((float(logv[hi]) - float(logv[mid])) / du_hi
                        - (float(logv[mid]) - float(logv[lo])) / du_lo) / (du_lo + du_hi)
            scores[k] = max(scores[k], abs(f2) * h * h)
    return scores


def _axis_interval_estimates(log_values: Dict[str, np.ndarray], nodes: List[np.ndarray],
                             scales: List[str], k: int,
                             weights: "np.ndarray | None" = None) -> "np.ndarray | None":
    """Per-interval estimate ``|f''|·h²/8·ln10`` along axis ``k``, maxed
    over fields and over the rest of the grid; None for a 2-node axis.
    ``weights`` (node-level, see :func:`_posterior_node_weights`) multiply
    the curvature before the max over the rest of the grid."""
    u = np.asarray(axis_coord(np.asarray(nodes[k]), scales[k]))
    n_k = len(u)
    if n_k < 3:
        return None
    du = np.diff(u)
    c = np.zeros(n_k - 2)
    w_flat = None if weights is None else np.moveaxis(weights, k, 0).reshape(n_k, -1)
    for logv in log_values.values():
        f = np.moveaxis(logv, k, 0).reshape(n_k, -1)
        d1 = np.diff(f, axis=0) / du[:, None]
        d2 = np.abs(2.0 * np.diff(d1, axis=0) / (du[:-1] + du[1:])[:, None])
        if w_flat is not None:
            d2 = d2 * w_flat[1:-1]
        c = np.maximum(c, np.max(d2, axis=1))
    c_node = np.concatenate([c[:1], c, c[-1:]])
    return np.maximum(c_node[:-1], c_node[1:]) * du * du / 8.0 * _LN10


def _interp_grad_at(log_values: Dict[str, np.ndarray], axis_nodes: List[np.ndarray],
                    axis_scales: List[str], probe: np.ndarray) -> np.ndarray:
    """Gradient of the interpolant at one probe, (n_fields, d), in each
    axis's scale coordinate: the difference of the surface on the two
    faces of the probe's cell (the query's own interpolation, probe
    coordinate k pinned to its bracketing nodes) over Δu_k."""
    import torch

    table = host_table(axis_nodes, axis_scales, log_values)
    d = len(axis_nodes)
    fields = list(log_values)
    out = np.zeros((len(fields), d))
    for k in range(d):
        nodes = axis_nodes[k]
        i = int(np.clip(np.searchsorted(nodes, probe[k], side="right") - 1,
                        0, len(nodes) - 2))
        u = axis_coord(np.asarray(nodes[[i, i + 1]]), axis_scales[k])
        du = float(u[1] - u[0])
        faces = np.stack([probe, probe])
        faces[0, k], faces[1, k] = nodes[i], nodes[i + 1]
        vals = interp_log_fields(torch.from_numpy(np.ascontiguousarray(faces)), table)
        for f_i, f in enumerate(fields):
            out[f_i, k] = (float(vals[f][1]) - float(vals[f][0])) / du
    return out


def _fisher_axis_scores(jac_exact: np.ndarray, log_values: Dict[str, np.ndarray],
                        axis_nodes: List[np.ndarray], axis_scales: List[str],
                        probe: np.ndarray, fields: List[str]) -> np.ndarray:
    """Per-axis error attribution at one failing probe:
    ``|∂log10f/∂u_k (exact) − ∂log10f/∂u_k (interpolant)| · h_k`` maxed
    over fields, ``h_k`` the probe's bracketing gap in the axis's scale
    coordinate.  An axis along which the surface is log-linear scores ~0,
    a 2-node axis included."""
    d = len(axis_nodes)
    g_emu = _interp_grad_at(log_values, axis_nodes, axis_scales, probe)
    order = {f: i for i, f in enumerate(log_values)}
    scores = np.zeros(d)
    for k in range(d):
        nodes = axis_nodes[k]
        i = int(np.clip(np.searchsorted(nodes, probe[k], side="right") - 1,
                        0, len(nodes) - 2))
        u = axis_coord(np.asarray(nodes[[i, i + 1]]), axis_scales[k])
        h = float(u[1] - u[0])
        for f_i, f in enumerate(fields):
            mismatch = abs(float(jac_exact[f_i, k]) - g_emu[order[f], k])
            scores[k] = max(scores[k], mismatch * h)
    return scores


def _posterior_node_weights(log_values: Dict[str, np.ndarray], floor: float = 1e-3
                            ) -> Tuple[np.ndarray, float]:
    """Planck-likelihood weight of every grid node from the surface
    itself, ``clip(exp(logp − max logp), floor, 1)``; returns (weights,
    max logp)."""
    from bdlz_tpu_torch.constants import RHO_CRIT_OVER_H2_KG_M3
    from bdlz_tpu_torch.sampling.likelihoods import planck_gaussian_logp

    ob = 10.0 ** log_values["rho_B_kg_m3"] / RHO_CRIT_OVER_H2_KG_M3
    od = 10.0 ** log_values["rho_DM_kg_m3"] / RHO_CRIT_OVER_H2_KG_M3
    lp = np.asarray(planck_gaussian_logp(ob, od))
    lp_max = float(lp.max())
    return np.clip(np.exp(lp - lp_max), floor, 1.0), lp_max


def _posterior_probe_weights(exact: Dict[str, np.ndarray], lp_max: float,
                             floor: float = 1e-3) -> np.ndarray:
    """The same weight at probe points, from their exact values,
    normalised by the node grid's max logp."""
    from bdlz_tpu_torch.constants import RHO_CRIT_OVER_H2_KG_M3
    from bdlz_tpu_torch.sampling.likelihoods import planck_gaussian_logp

    lp = np.asarray(planck_gaussian_logp(exact["rho_B_kg_m3"] / RHO_CRIT_OVER_H2_KG_M3,
                                         exact["rho_DM_kg_m3"] / RHO_CRIT_OVER_H2_KG_M3))
    return np.clip(np.exp(lp - lp_max), floor, 1.0)


def _node_to_cell_max(arr: np.ndarray) -> np.ndarray:
    """Per cell, the max over its 2^d corner nodes."""
    for k in range(arr.ndim):
        lo = tuple(slice(None, -1) if j == k else slice(None) for j in range(arr.ndim))
        hi = tuple(slice(1, None) if j == k else slice(None) for j in range(arr.ndim))
        arr = np.maximum(arr[lo], arr[hi])
    return arr


def cell_error_estimates(log_values: Dict[str, np.ndarray], nodes: List[np.ndarray],
                         scales: List[str]) -> np.ndarray:
    """Per-cell a-posteriori relative-error estimate of the final table,
    shape ``(n_1-1, …, n_d-1)``: for each axis the second divided
    differences of every field, extended to the end nodes, reduced to
    cells by corner max and scaled by the cell's width (``h²/8·ln10``),
    maxed over axes and fields; a 2-node axis contributes 0."""
    d = len(nodes)
    total = np.zeros(tuple(len(a) - 1 for a in nodes))
    for k in range(d):
        u = np.asarray(axis_coord(np.asarray(nodes[k]), scales[k]))
        if len(u) < 3:
            continue
        du = np.diff(u)
        du_shape = tuple(len(du) if j == k else 1 for j in range(d))
        c_node = None
        for logv in log_values.values():
            f = np.moveaxis(logv, k, 0)
            d1 = np.diff(f, axis=0) / du.reshape(-1, *([1] * (d - 1)))
            d2 = np.abs(2.0 * np.diff(d1, axis=0)
                        / (du[:-1] + du[1:]).reshape(-1, *([1] * (d - 1))))
            ext = np.moveaxis(np.concatenate([d2[:1], d2, d2[-1:]], axis=0), 0, k)
            c_node = ext if c_node is None else np.maximum(c_node, ext)
        est_k = _node_to_cell_max(c_node) * (du.reshape(du_shape) ** 2) / 8.0 * _LN10
        total = np.maximum(total, est_k)
    return total


def _traffic_node_weights(nodes: List[np.ndarray], locations: np.ndarray,
                          floor: float = 1e-3) -> Tuple[np.ndarray, np.ndarray]:
    """Traffic weight of every grid node from a served-query snapshot:
    the locations are clipped into the box (out-of-box mass pulls
    refinement to the nearest edge cell), binned per cell on the current
    grid, normalised to ``clip(count / max count, floor, 1)``, then lifted
    to the nodes by the max over adjacent cells.  Returns ``(node_weights,
    cell_weights)``; the cell weights score probes."""
    locs = np.atleast_2d(np.asarray(locations, dtype=np.float64))
    for k, ax in enumerate(nodes):
        locs[:, k] = np.clip(locs[:, k], float(ax[0]), float(ax[-1]))
    counts, _ = np.histogramdd(locs, bins=[np.asarray(a) for a in nodes])
    top = counts.max()
    w_cell = (np.clip(counts / top, floor, 1.0) if top > 0
              else np.full(counts.shape, floor))
    # node i touches cells i-1 and i along each axis
    w_node = w_cell
    for k in range(w_node.ndim):
        edge_lo = tuple(slice(0, 1) if j == k else slice(None) for j in range(w_node.ndim))
        edge_hi = tuple(slice(-1, None) if j == k else slice(None) for j in range(w_node.ndim))
        ext = np.concatenate([w_node[edge_lo], w_node, w_node[edge_hi]], axis=k)
        lo = tuple(slice(None, -1) if j == k else slice(None) for j in range(ext.ndim))
        hi = tuple(slice(1, None) if j == k else slice(None) for j in range(ext.ndim))
        w_node = np.maximum(ext[lo], ext[hi])
    return w_node, w_cell


def _traffic_probe_weights(nodes: List[np.ndarray], probes: np.ndarray,
                           w_cell: np.ndarray) -> np.ndarray:
    """The traffic cell weight at each probe point."""
    idx = tuple(
        np.clip(np.searchsorted(nodes[k], probes[:, k], side="right") - 1,
                0, len(nodes[k]) - 2)
        for k in range(len(nodes)))
    return w_cell[idx]


def _resolve_weighting(base, posterior_weight, refine_signal, traffic, spec):
    """The JAX build's validation of the weighting knobs (explicit
    argument, else the config's) and of the traffic pairing: a traffic
    signal needs a snapshot, and a snapshot needs a traffic signal.
    Returns ``(posterior_weight, refine_signal, traffic_fp,
    traffic_locations)``."""
    from bdlz_tpu_torch.config import VALID_POSTERIOR_WEIGHTS, VALID_REFINE_SIGNALS

    pw = posterior_weight if posterior_weight is not None else getattr(
        base, "posterior_weight", None)
    if pw is not None and pw not in VALID_POSTERIOR_WEIGHTS:
        raise EmulatorBuildError(
            f"posterior_weight={pw!r} is not one of {VALID_POSTERIOR_WEIGHTS} (or None)")
    rs = refine_signal if refine_signal is not None else getattr(base, "refine_signal", None)
    if rs is not None and rs not in VALID_REFINE_SIGNALS:
        raise EmulatorBuildError(
            f"refine_signal={rs!r} is not one of {VALID_REFINE_SIGNALS} (or None = curvature)")
    traffic_on = rs in ("traffic", "traffic*planck")
    if traffic_on and traffic is None:
        raise EmulatorBuildError(
            f"refine_signal={rs!r} weights refinement by served traffic; "
            "pass traffic=<TrafficSnapshot> (bdlz_tpu_torch.refine) to "
            "build_emulator")
    if traffic is not None and not traffic_on:
        raise EmulatorBuildError(
            f"traffic=<snapshot> requires refine_signal 'traffic' or "
            f"'traffic*planck' (resolved: {rs!r}) — a snapshot the "
            "refinement never consults would silently change nothing")
    if traffic is None:
        return pw, rs, None, None
    t_axes = tuple(str(n) for n in traffic.axis_names)
    if t_axes != tuple(spec):
        raise EmulatorBuildError(
            f"traffic snapshot axes {t_axes} do not match the emulator spec "
            f"axes {tuple(spec)} (order included) — query locations would be "
            "binned against the wrong coordinates")
    locs = np.atleast_2d(np.asarray(traffic.locations, dtype=np.float64))
    if locs.shape[0] == 0:
        raise EmulatorBuildError(
            "traffic snapshot carries zero query locations; nothing to weight "
            "by — serve traffic first or drop the signal")
    return pw, rs, str(traffic.fingerprint), locs


def build_emulator(
    base,
    spec: Mapping[str, AxisSpec],
    static=None,
    *,
    rtol: float = 1e-4,
    safety: float = 2.0,
    n_probe: int = 64,
    n_holdout: Optional[int] = None,
    max_rounds: int = 8,
    max_nodes_per_axis: int = 1024,
    seed: int = 0,
    n_y: int = 2000,
    impl: str = "tabulated",
    chunk_size: int = 2048,
    out_dir: Optional[str] = None,
    event_log=None,
    require_converged: bool = False,
    fault_plan=None,
    retry=None,
    cache=None,
    seam_split: Optional[bool] = None,
    posterior_weight: Optional[str] = None,
    refine_signal: Optional[str] = None,
    lz_profile=None,
    bounce=None,
    elastic=None,
    traffic=None,
    device=None,
    mesh=None,
) -> Tuple[EmulatorArtifact, BuildReport]:
    """Build (and with ``out_dir`` save) an error-controlled yield-surface
    emulator, as ``bdlz_tpu.emulator.build_emulator`` does.

    ``spec`` maps config-schema axis names to :class:`AxisSpec` boxes;
    their order is the artifact's.  ``rtol`` is the advertised tolerance
    (the refinement targets ``rtol/safety``); the held-out
    ``max_rel_err`` is measured on ``n_holdout`` fresh points (default
    4×``n_probe``).  ``require_converged`` raises instead of returning a
    surface that missed it.  ``cache`` (a store, a root, or None —
    resolved as ``run_sweep`` resolves it) routes every exact evaluation
    through the chunk cache: a warm rebuild of the same box is bit for
    bit the cold one.  ``seam_split`` (tri-state, ``Config.seam_split``
    when None) splits a box that crosses the T = m/3 flux-seam band into
    a two-domain bundle (``emulator/multidomain.py``).  ``lz_profile`` or
    ``bounce`` feed a chain or thermal ``lz_mode``.  The engine resolves
    as the JAX build resolves it, with ``"kernel"`` (the CUDA kernels) in
    place of ``"pallas"``; ``device`` is the card unless the caller asks
    for the CPU, and a ``mesh`` splits the exact grid and the probes over
    its members (the elastic fleet fills the grid on its own workers).
    ``posterior_weight`` ("planck", or
    ``Config.posterior_weight``) and ``refine_signal`` ("fisher",
    "traffic", "traffic*planck", or ``Config.refine_signal``) steer the
    refinement as in the JAX build and join the artifact identity; a
    traffic signal takes its query locations from ``traffic`` (a
    ``TrafficSnapshot``, whose fingerprint joins the identity).
    ``elastic`` (a worker count or ``run_sweep_elastic`` arguments) fills
    the grid through the elastic fleet over the store ``cache``.
    """
    from bdlz_tpu_torch.backend import resolve_device
    from bdlz_tpu_torch.config import needs_ode_path, static_choices_from_config, validate
    from bdlz_tpu_torch.emulator.multidomain import (
        build_seam_split_emulator,
        resolve_seam_split,
    )
    from bdlz_tpu_torch.faults import FaultPlan
    from bdlz_tpu_torch.parallel.sweep import AXIS_MAP, build_grid
    from bdlz_tpu_torch.provenance import resolve_store
    from bdlz_tpu_torch.utils.retry import resolve_engine_retry
    from bdlz_tpu_torch.validation import resolve_quad_panel_gl

    t0 = time.time()
    dev = resolve_device(device) if mesh is None else mesh.local_devices[0]
    validate(base)
    if not (safety >= 1.0):
        raise EmulatorBuildError(f"safety must be >= 1, got {safety}")
    refine_tol = float(rtol) / float(safety)
    if static is None:
        static = static_choices_from_config(base)
    if not spec:
        raise EmulatorBuildError("emulator spec needs at least one axis")
    unknown = sorted(set(spec) - set(AXIS_MAP))
    if unknown:
        raise EmulatorBuildError(f"unknown emulator axes {unknown}; valid: {sorted(AXIS_MAP)}")
    pw, rs, traffic_fp, traffic_locs = _resolve_weighting(
        base, posterior_weight, refine_signal, traffic, spec)
    traffic_on = traffic_fp is not None
    # "traffic*planck" composes both weights even with posterior_weight off
    use_planck = pw is not None or rs == "traffic*planck"

    lz_mode = getattr(static, "lz_mode", "two_channel")
    bounce_fp = None
    if bounce is not None:
        if lz_profile is not None:
            raise EmulatorBuildError(
                "pass either bounce or lz_profile, not both — the bounce "
                "solver derives the profile the lz_profile seam would load")
        if elastic:
            raise EmulatorBuildError(
                "elastic build cannot ship per-point bounce profiles; "
                "drop elastic=... or bounce=...")
        if lz_mode == "two_channel":
            raise EmulatorBuildError(
                "bounce requires a scenario lz_mode ('chain'/'thermal') "
                "in the config/static — the two-channel emulator takes P "
                "from the config or a P_chi_to_B axis")
        from bdlz_tpu_torch.bounce import as_potential_spec, bounce_profile, potential_fingerprint

        bounce = as_potential_spec(bounce)
        bounce_fp = potential_fingerprint(bounce)
        lz_profile = bounce_profile(bounce, device=dev)
    lz_fp = None
    if lz_mode != "two_channel":
        if lz_profile is None:
            raise EmulatorBuildError(
                f"lz_mode={lz_mode!r} derives P per point from a bounce "
                "profile; pass lz_profile to build_emulator")
        from bdlz_tpu_torch.lz.profile import load_profile_csv
        from bdlz_tpu_torch.lz.sweep_bridge import profile_fingerprint

        if isinstance(lz_profile, str):
            lz_profile = load_profile_csv(lz_profile)
        lz_fp = profile_fingerprint(lz_profile)
        if "P_chi_to_B" in spec:
            raise EmulatorBuildError(
                "P_chi_to_B cannot be an emulator axis when the scenario "
                "derives P per point; use v_w (and T_p_GeV for thermal)")
    elif lz_profile is not None:
        raise EmulatorBuildError(
            "lz_profile requires a scenario lz_mode ('chain'/'thermal') "
            "in the config/static — the two-channel emulator takes P from "
            "the config or a P_chi_to_B axis")

    band = resolve_seam_split(base, spec, seam_split, rtol=float(rtol), safety=float(safety),
                              device=dev)
    if band is not None:
        if elastic:
            print("[emulator] seam-split builds run the serial sweep engine per "
                  "sub-domain; ignoring elastic=...", file=sys.stderr)
        return build_seam_split_emulator(
            base, spec, static, band=band, out_dir=out_dir, event_log=event_log,
            rtol=rtol, safety=safety, n_probe=n_probe, n_holdout=n_holdout,
            max_rounds=max_rounds, max_nodes_per_axis=max_nodes_per_axis, seed=seed,
            n_y=n_y, impl=impl, chunk_size=chunk_size, require_converged=require_converged,
            fault_plan=fault_plan, retry=retry, cache=cache,
            posterior_weight=pw, refine_signal=rs,
            # sub-builds re-derive the profile from the spec
            lz_profile=None if bounce_fp is not None else lz_profile, bounce=bounce,
            traffic=traffic, device=dev, mesh=mesh,
        )
    # engine resolution, once, so the grid, the probes and the identity
    # name the same engine
    if needs_ode_path(base) and impl != "esdirk_lockstep":
        impl = "esdirk"
    if "I_p" in spec and impl in ("tabulated", "kernel"):
        impl = "direct"
    spec = dict(spec)
    axis_names: List[str] = list(spec)
    nodes: List[np.ndarray] = [_axis_nodes(spec[k]) for k in axis_names]
    scales: List[str] = [spec[k].scale for k in axis_names]
    rng = np.random.default_rng(seed)

    faults = FaultPlan.resolve(fault_plan, base)
    retry_policy = resolve_engine_retry(retry, base, static)
    store = resolve_store(cache, base, label="emulator")

    # the quadrature tri-state, resolved once over the initial grid and
    # passed explicitly to every sweep and the probe evaluator
    audit_grid = None
    if impl == "tabulated" and static.quad_panel_gl is None:
        audit_grid = build_grid(base, {k: a for k, a in zip(axis_names, nodes)}, product=True)
    quad_on, _ = resolve_quad_panel_gl(audit_grid, static, impl, n_y, label="emulator")
    static = static._replace(quad_panel_gl=quad_on)

    # the Fisher-aware signal differentiates the tabulated fast path
    field_jac = None
    n_grad_evals = 0
    if rs == "fisher":
        if lz_mode != "two_channel":
            raise EmulatorBuildError(
                f"refine_signal='fisher' needs the differentiable "
                f"two-channel path; lz_mode={lz_mode!r} derives P "
                "host-side per point (no in-graph gradient — a silent "
                "zero would mis-steer every split)")
        if impl != "tabulated":
            raise EmulatorBuildError(
                f"refine_signal='fisher' differentiates the tabulated "
                f"fast path; the resolved engine is impl={impl!r} "
                "(I_p axes and stiff configs keep the curvature signal)")
        from bdlz_tpu_torch.ops.kjma_table import make_f_table
        from bdlz_tpu_torch.sampling.grad import make_field_log10_jacobian

        field_jac = make_field_log10_jacobian(base, static, make_f_table(float(base.I_p)),
                                              axis_names, scales, n_y=n_y, device=dev)
    sweep_kw = dict(chunk_size=chunk_size, n_y=n_y, impl=impl, device=dev,
                    fault_plan=faults, retry=retry_policy, cache=store, lz_profile=lz_profile,
                    elastic=elastic, mesh=mesh)

    def grid_shape() -> Tuple[int, ...]:
        return tuple(len(a) for a in nodes)

    flat, n_exact = _exact_fields(base, {k: a for k, a in zip(axis_names, nodes)}, static,
                                  **sweep_kw)
    values = {f: np.asarray(flat[f]).reshape(grid_shape()) for f in FIELDS}
    _check_positive(values)
    log_values = {f: np.log10(values[f]) for f in FIELDS}

    qsink: List[np.ndarray] = []
    exact_eval = make_exact_evaluator(
        base, static, n_y=n_y, impl=impl, chunk_size=min(int(chunk_size), int(n_probe)),
        retry=retry_policy, fault_plan=faults, quarantine_sink=qsink.append, cache=store,
        lz_profile=lz_profile, device=dev, mesh=mesh)
    n_quarantined_probes = 0

    def exact_zip(axes):
        qsink.clear()
        flat = exact_eval(axes)
        q = qsink[-1] if qsink else np.zeros(len(next(iter(flat.values()))), dtype=bool)
        # every scored field must be finite (a NaN score would pass the
        # gate silently); quarantined probes are the droppable case
        for fname in FIELDS:
            bad = ~np.isfinite(flat[fname]) & ~q
            if bad.any():
                raise EmulatorBuildError(
                    f"{int(bad.sum())}/{len(bad)} exact probe points have "
                    f"non-finite {fname} inside the emulator box; shrink "
                    "the box or fix the configuration")
        return flat, q

    pool_probes = np.empty((0, len(axis_names)))
    pool_exact: Dict[str, np.ndarray] = {f: np.empty(0) for f in FIELDS}
    rounds: List[Dict[str, Any]] = []
    converged = False
    for r in range(int(max_rounds) + 1):
        probe_cols = _draw_probes(spec, int(n_probe), rng)
        probes = np.stack([probe_cols[k] for k in axis_names], axis=1)
        exact, q_probe = exact_zip(probe_cols)
        n_exact += int(n_probe)
        if q_probe.any():
            n_quarantined_probes += int(q_probe.sum())
            probes = probes[~q_probe]
            exact = {f: exact[f][~q_probe] for f in FIELDS}
        pool_probes = np.concatenate([pool_probes, probes])
        for f in FIELDS:
            pool_exact[f] = np.concatenate([pool_exact[f], exact[f]])
        # the posterior weights of the current surface, recomputed each round
        w_nodes, lp_max = (_posterior_node_weights(log_values) if use_planck
                           else (None, 0.0))
        # traffic weights too: the locations are fixed, the cells just grew
        w_cell_traffic = None
        if traffic_on:
            w_traffic, w_cell_traffic = _traffic_node_weights(nodes, traffic_locs)
            w_nodes = w_traffic if w_nodes is None else w_nodes * w_traffic
        if pool_probes.shape[0]:
            errs = _probe_errors(_emulated_fields(nodes, scales, log_values, pool_probes),
                                 pool_exact)
            score = errs
            if use_planck:
                score = score * _posterior_probe_weights(pool_exact, lp_max)
            if w_cell_traffic is not None:
                score = score * _traffic_probe_weights(nodes, pool_probes, w_cell_traffic)
            failing = np.flatnonzero(score > refine_tol)
        else:
            errs = np.zeros(0)
            failing = np.zeros(0, dtype=np.int64)

        # estimate-driven split candidates: every interval over the target
        curv: Dict[int, List[Tuple[float, float]]] = {}
        for k in range(len(axis_names)):
            est = _axis_interval_estimates(log_values, nodes, scales, k, weights=w_nodes)
            if est is None:
                continue
            ax = nodes[k]
            span = float(ax[-1] - ax[0])
            for j in np.flatnonzero(est > refine_tol):
                j = int(j)
                if (ax[j + 1] - ax[j]) <= _MIN_REL_GAP * span:
                    continue
                curv.setdefault(k, []).append((
                    float(est[j]),
                    _midpoint(float(ax[j]), float(ax[j + 1]), spec[axis_names[k]].scale)))
        row = {
            "round": r,
            "pool_size": int(pool_probes.shape[0]),
            "n_failing": int(len(failing)),
            "n_est_splits": sum(len(v) for v in curv.values()),
            "max_rel_err": float(errs.max(initial=0.0)),
            "grid_shape": list(grid_shape()),
        }
        if event_log is not None:
            event_log.emit("emulator_refine_round", **row)
        if pool_probes.shape[0] and not len(failing) and not curv:
            rounds.append(row)
            converged = True
            break
        if r == int(max_rounds):
            rounds.append(row)
            break

        # probe-driven inserts: one midpoint per failing pool probe, on
        # its best-scoring axis with room left
        inserts: Dict[int, set] = {}
        fail_jacs = None
        if field_jac is not None and len(failing):
            # one batched Jacobian per round, failing probes only
            fail_jacs = field_jac(pool_probes[np.asarray(failing)]).cpu().numpy()
            n_grad_evals += int(len(failing))
        for j_f, p in enumerate(failing):
            if fail_jacs is not None:
                scores = _fisher_axis_scores(fail_jacs[j_f], log_values, nodes, scales,
                                             pool_probes[p], _GRAD_FIELDS)
            else:
                scores = _curvature_scores(log_values, nodes, scales, pool_probes[p])
            for k in np.argsort(-scores):
                k = int(k)
                ax = nodes[k]
                if len(ax) + len(inserts.get(k, ())) >= int(max_nodes_per_axis):
                    continue
                i = int(np.clip(np.searchsorted(ax, pool_probes[p, k]) - 1, 0, len(ax) - 2))
                mid = _midpoint(float(ax[i]), float(ax[i + 1]), spec[axis_names[k]].scale)
                span = float(ax[-1] - ax[0])
                if (ax[i + 1] - ax[i]) <= _MIN_REL_GAP * span:
                    continue
                inserts.setdefault(k, set()).add(mid)
                break
        # estimate-driven inserts, worst first, bounded by the axis cap
        for k, cands in curv.items():
            room = int(max_nodes_per_axis) - len(nodes[k]) - len(inserts.get(k, ()))
            for _, mid in sorted(cands, reverse=True)[: max(room, 0)]:
                inserts.setdefault(k, set()).add(mid)
        if not inserts:
            if not pool_probes.shape[0]:
                rounds.append({**row, "note": "pool empty (probes quarantined); redrawing"})
                continue
            rounds.append({**row, "note": "no refinable interval left"})
            break

        # evaluate only the new hyperplanes, axis by axis
        added = 0
        for k in sorted(inserts):
            new_vals = np.asarray(sorted(inserts[k]), dtype=np.float64)
            axes_eval = {name: (new_vals if j == k else nodes[j])
                         for j, name in enumerate(axis_names)}
            flat, n_new = _exact_fields(base, axes_eval, static, **sweep_kw)
            n_exact += n_new
            slab_shape = tuple(len(new_vals) if j == k else len(nodes[j])
                               for j in range(len(axis_names)))
            pos = np.searchsorted(nodes[k], new_vals)
            for f in FIELDS:
                slab = np.asarray(flat[f]).reshape(slab_shape)
                _check_positive({f: slab})
                values[f] = np.insert(values[f], pos, slab, axis=k)
                log_values[f] = np.log10(values[f])
            nodes[k] = np.insert(nodes[k], pos, new_vals)
            added += len(new_vals)
        row["nodes_added"] = added
        rounds.append(row)

    # held-out validation on points the refinement never saw
    n_holdout = max(4 * int(n_probe), 64) if n_holdout is None else int(n_holdout)
    held_cols = _draw_probes(spec, n_holdout, np.random.default_rng(seed + 10_000))
    held = np.stack([held_cols[k] for k in axis_names], axis=1)
    exact, q_held = exact_zip(held_cols)
    n_exact += n_holdout
    if q_held.any():
        n_quarantined_probes += int(q_held.sum())
        held = held[~q_held]
        exact = {f: exact[f][~q_held] for f in FIELDS}
        if held.shape[0] == 0:
            raise EmulatorBuildError(
                "every held-out probe was infrastructure-quarantined; "
                "the recorded max_rel_err would be meaningless — fix the "
                "environment and rebuild")
    held_errs = _probe_errors(_emulated_fields(nodes, scales, log_values, held), exact)
    max_rel_err = float(held_errs.max())
    weighted_max_rel_err = None
    if use_planck or traffic_on:
        w_held = np.ones_like(held_errs)
        if use_planck:
            _w, lp_max_final = _posterior_node_weights(log_values)
            w_held = w_held * _posterior_probe_weights(exact, lp_max_final)
        if traffic_on:
            _, w_cell_final = _traffic_node_weights(nodes, traffic_locs)
            w_held = w_held * _traffic_probe_weights(nodes, held, w_cell_final)
        weighted_max_rel_err = float((held_errs * w_held).max())
    if not converged:
        msg = (f"emulator refinement exhausted {max_rounds} rounds with "
               f"held-out max rel err {max_rel_err:.3e} vs target {rtol:.1e}")
        if weighted_max_rel_err is not None:
            msg += f" (weighted: {weighted_max_rel_err:.3e})"
        if require_converged:
            raise EmulatorBuildError(msg)
        print(f"[emulator] WARNING: {msg}", file=sys.stderr)

    predicted = cell_error_estimates(log_values, nodes, scales)
    seconds = time.time() - t0
    report = BuildReport(
        rounds=rounds,
        converged=converged,
        max_rel_err=max_rel_err,
        rtol=float(rtol),
        n_exact_evals=int(n_exact),
        build_seconds=round(seconds, 3),
        axis_nodes={k: len(a) for k, a in zip(axis_names, nodes)},
        quarantined_probes=int(n_quarantined_probes),
        posterior_weight=pw,
        weighted_max_rel_err=weighted_max_rel_err,
        refine_signal=rs,
        n_grad_evals=int(n_grad_evals),
    )
    manifest = {
        "rtol_target": float(rtol),
        "max_rel_err": max_rel_err,
        "converged": bool(converged),
        "refinement_rounds": len(rounds),
        "build_seconds": report.build_seconds,
        "n_exact_evals": report.n_exact_evals,
        "quarantined_probes": int(n_quarantined_probes),
        "max_cell_est": float(predicted.max(initial=0.0)),
        "axis_scales": {k: spec[k].scale for k in axis_names},
        "domain": {k: [float(a[0]), float(a[-1])] for k, a in zip(axis_names, nodes)},
    }
    if pw is not None:
        manifest["posterior_weight"] = pw
        manifest["weighted_max_rel_err"] = weighted_max_rel_err
    if rs is not None:
        manifest["refine_signal"] = rs
        manifest["n_grad_evals"] = int(n_grad_evals)
    if traffic_fp is not None:
        manifest["traffic_fingerprint"] = traffic_fp
        manifest["traffic_queries"] = int(traffic_locs.shape[0])
    artifact = EmulatorArtifact(
        axis_names=tuple(axis_names),
        axis_nodes=tuple(nodes),
        axis_scales=tuple(scales),
        values=values,
        identity=build_identity(base, static, n_y, impl, posterior_weight=pw,
                                lz_profile_fp=lz_fp, refine_signal=rs, bounce_fp=bounce_fp,
                                traffic_fp=traffic_fp),
        manifest=manifest,
        predicted_error=predicted,
    )
    if event_log is not None:
        event_log.emit(
            "emulator_build_done", converged=bool(converged), max_rel_err=max_rel_err,
            n_exact_evals=n_exact, quarantined_probes=int(n_quarantined_probes),
            seconds=report.build_seconds, grid_shape=list(grid_shape()))
    if out_dir is not None:
        save_artifact(out_dir, artifact)
    return artifact, report


def _check_positive(values: Mapping[str, np.ndarray]) -> None:
    """Loud rejection at build time, the contract the loader enforces."""
    for f, v in values.items():
        v = np.asarray(v)
        if not np.all(np.isfinite(v)):
            raise EmulatorBuildError(f"exact pipeline produced non-finite {f} inside the box")
        if not np.all(v > 0.0):
            raise EmulatorBuildError(
                f"exact pipeline produced non-positive {f} inside the box; "
                "the log-space emulator needs strictly positive fields — shrink the box")
