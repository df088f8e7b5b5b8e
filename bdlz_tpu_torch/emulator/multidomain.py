"""Seam-split emulator domains: split at the T = m/3 flux-seam band,
stitch at query time.

Counterpart of ``bdlz_tpu/emulator/multidomain.py``, the same bundle on
disk.  A box that crosses the band where the statistics seam sits inside
the y-window with non-negligible source weight carries a kink along the
m ≈ 3·T_p diagonal that axis-aligned refinement cannot resolve, so:

* :func:`seam_band_for_box` scans the split axis densely (the other
  seam-relevant parameters at their box extremes) and marks where
  ``|y_seam| <= c·sigma_y`` inside the clipped window, ``c`` set by the
  build's target;
* :func:`build_seam_split_emulator` builds one ordinary sub-artifact per
  side through ``build_emulator`` and assembles a
  :class:`MultiDomainArtifact` under a composite content hash (ordered
  domain hashes + band + shared identity);
* queries inside the band belong to no domain: they are out of domain.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from bdlz_tpu_torch.backend import resolve_device
from bdlz_tpu_torch.emulator.artifact import (
    EmulatorArtifact,
    EmulatorArtifactError,
    load_artifact,
    save_artifact,
)

#: Schema version of the BUNDLE manifest.  A pre-seam (schema-1) reader
#: pointed at a bundle fails its version check loudly; the current
#: single-domain loader rejects bundles EARLIER, on the manifest's
#: ``kind`` tag — either way a bundle directory is never misread as a
#: single artifact.
MULTI_SCHEMA_VERSION = 2

#: The manifest ``kind`` tag that dispatches bundle loading.
MULTI_DOMAIN_KIND = "multi_domain"

#: What the seam-band descriptor describes.
SEAM_BAND_KIND = "T=m/3 flux seam"

#: Headroom multiplier on the band tolerance for the seam's jump
#: amplitude (n_eq ~5.6x, v_bar ~1.09x — bounded by 10x) times the
#: probe-safety margin: the band must exclude the kink down to WELL
#: under the refinement's internal target, or edge cells of the
#: sub-boxes would still stall first-order.
_BAND_TOL_HEADROOM = 40.0

_SEAM_RELEVANT = (
    "m_chi_GeV", "T_p_GeV", "beta_over_H", "T_min_over_Tp",
    "T_max_over_Tp", "source_shape_sigma_y",
)


class MultiDomainBuildError(EmulatorArtifactError):
    """A seam-split build or bundle that cannot be trusted: no seam to
    split on under ``seam_split=true``, the whole box inside the band,
    per-domain identity skew, or a malformed bundle directory."""


class _FieldsView:
    """Field-NAME view of a bundle: supports the membership/iteration
    checks single-artifact consumers run (``field in artifact.values``,
    ``sorted(artifact.values)``) but REFUSES array access loudly —
    value tables live per domain, and silently handing out one domain's
    table as "the" surface would cover half the box."""

    def __init__(self, names):
        self._names = tuple(names)

    def __contains__(self, name) -> bool:
        return name in self._names

    def __iter__(self):
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def __getitem__(self, name):
        raise EmulatorArtifactError(
            "a MultiDomainArtifact has no single value table: read "
            "artifact.domains[i].values[...] per domain, or query the "
            "stitched surface through emulator.grid.make_query_fn"
        )

    def __repr__(self) -> str:
        return f"_FieldsView({sorted(self._names)})"


class MultiDomainArtifact(NamedTuple):
    """One seam-split emulator bundle: ordered, disjoint single-domain
    artifacts plus the seam-band descriptor separating them, behind the
    same query-facing interface as a single artifact (``axis_names``,
    ``hull``, ``content_hash``, ``manifest`` — the query functions
    dispatch through :func:`bdlz_tpu_torch.emulator.grid.domain_artifacts`)."""

    domains: Tuple[EmulatorArtifact, ...]
    seam_band: Dict[str, Any]     # {"axis", "lo", "hi", "kind", ...}
    identity: Dict[str, Any]      # the SHARED physics identity
    manifest: Dict[str, Any]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.domains[0].axis_names

    @property
    def axis_scales(self) -> Tuple[str, ...]:
        return self.domains[0].axis_scales

    @property
    def values(self) -> "_FieldsView":
        """Field-name view (for ``field in artifact.values`` checks);
        the arrays themselves live per domain — array access through
        this view raises instead of silently serving one domain."""
        return _FieldsView(self.domains[0].values)

    @property
    def domain(self) -> Dict[str, Tuple[float, float]]:
        lo, hi = self.hull
        return {
            name: (float(lo[k]), float(hi[k]))
            for k, name in enumerate(self.axis_names)
        }

    @property
    def hull(self) -> Tuple[np.ndarray, np.ndarray]:
        los, his = zip(*(d.hull for d in self.domains))
        return (
            np.min(np.stack(los), axis=0),
            np.max(np.stack(his), axis=0),
        )

    @property
    def n_points(self) -> int:
        return sum(d.n_points for d in self.domains)

    @property
    def predicted_error(self):
        """Present iff every domain persists an estimate grid (the
        serve gate asks through ``grid.has_error_grid``)."""
        grids = [d.predicted_error for d in self.domains]
        return grids if all(g is not None for g in grids) else None

    @property
    def content_hash(self) -> str:
        h = self.manifest.get("hash")
        if h is not None:
            return str(h)
        return multidomain_hash(
            [d.content_hash for d in self.domains], self.seam_band,
            self.identity,
        )


class MultiDomainBuildReport(NamedTuple):
    """Aggregate provenance of one seam-split build (headline fields
    mirror :class:`~bdlz_tpu_torch.emulator.build.BuildReport`, so a
    consumer reads either kind)."""

    domain_reports: Tuple[Any, ...]   # one BuildReport per domain
    seam_band: Dict[str, Any]
    converged: bool                   # every domain converged
    max_rel_err: float                # worst domain's held-out error
    rtol: float
    n_exact_evals: int                # summed over domains
    build_seconds: float
    rounds: List[Dict[str, Any]]      # per-domain rows, domain-tagged


def seam_band_tolerance(rtol: float, safety: float) -> float:
    """The relative seam contribution below which the band ends."""
    return float(rtol) / (_BAND_TOL_HEADROOM * float(safety))


def seam_band_for_box(
    base,
    spec,
    *,
    rtol: float = 1e-4,
    safety: float = 2.0,
    band_tol: Optional[float] = None,
    axis: Optional[str] = None,
    n_scan: int = 4097,
    device=None,
) -> Optional[Dict[str, Any]]:
    """Locate the seam band inside an emulator box, or None.

    Scans the split axis (``m_chi_GeV`` if it is in the spec, else
    ``T_p_GeV``) densely while the other seam-relevant parameters sit
    at their box extremes (they enter ``y_seam``/the window bounds
    monotonically, so extremes bound the union), and marks a scan value
    in-band when, for ANY extreme combination, the seam sits inside the
    clipped y-window with source weight above ``band_tol``:
    ``exp(-y_seam^2 / 2 sigma_y^2) > band_tol`` — outside that the
    Gaussian envelope bounds the kink's relative contribution to the
    yield integral below the refinement target and the sub-box refines
    cleanly (the same exactness reasoning the panel quadrature's
    edge-snapping uses; see docs/perf_notes.md).

    Returns ``{"axis", "lo", "hi", "kind", "band_tol"}`` with [lo, hi]
    widened by one scan step on each side (the predicate is sampled),
    intersected with the box — or None when the box never touches the
    band.  The window bounds and the seam are evaluated on ``device``
    (the card unless the caller asks for the CPU).
    """
    from bdlz_tpu_torch.interop import point_params_from_numpy
    from bdlz_tpu_torch.parallel.sweep import AXIS_MAP, build_grid
    from bdlz_tpu_torch.solvers.panels import y_branch_seam
    from bdlz_tpu_torch.solvers.quadrature import quadrature_bounds

    dev = resolve_device(device)
    if band_tol is None:
        band_tol = seam_band_tolerance(rtol, safety)
    if axis is None:
        axis = next(
            (a for a in ("m_chi_GeV", "T_p_GeV") if a in spec), None
        )
    if axis is None:
        return None
    ax = spec[axis]
    if ax.scale == "log":
        scan = np.geomspace(ax.lo, ax.hi, int(n_scan))
    else:
        scan = np.linspace(ax.lo, ax.hi, int(n_scan))

    other_extremes = []
    for name in _SEAM_RELEVANT:
        if name == axis or name not in spec or name not in AXIS_MAP:
            continue
        other_extremes.append(
            (name, (float(spec[name].lo), float(spec[name].hi)))
        )
    combos = list(itertools.product(
        *(vals for _name, vals in other_extremes)
    )) or [()]

    # the source-weight threshold in y: |y_seam| <= c * sigma_y
    c = float(np.sqrt(max(2.0 * np.log(1.0 / band_tol), 0.0)))
    inside_any = np.zeros(len(scan), dtype=bool)
    for combo in combos:
        axes = {axis: scan}
        for (name, _vals), v in zip(other_extremes, combo):
            axes[name] = np.full(len(scan), v)
        pp = point_params_from_numpy(build_grid(base, axes, product=False), dev)
        y_lo, y_hi = (t.cpu().numpy() for t in quadrature_bounds(pp))
        y_seam = y_branch_seam(pp).cpu().numpy()
        sigma = np.maximum(pp.sigma_y.cpu().numpy(), 1e-6)
        inside_any |= (
            (y_seam > y_lo) & (y_seam < y_hi) & (y_hi > y_lo)
            & (np.abs(y_seam) <= c * sigma)
        )
    if not inside_any.any():
        return None
    idx = np.flatnonzero(inside_any)
    lo = float(scan[max(int(idx[0]) - 1, 0)])
    hi = float(scan[min(int(idx[-1]) + 1, len(scan) - 1)])
    return {
        "axis": axis,
        "lo": lo,
        "hi": hi,
        "kind": SEAM_BAND_KIND,
        "band_tol": float(band_tol),
    }


def resolve_seam_split(
    base, spec, seam_split: Optional[bool], *,
    rtol: float, safety: float, device=None,
) -> Optional[Dict[str, Any]]:
    """The tri-state resolution (ode_* pattern): explicit argument wins
    over ``Config.seam_split``; ``None`` means split iff the box crosses
    the band; ``True`` REQUIRES a crossing (a smooth box has nothing to
    split at — loud error, not a silent single-domain build).  Returns
    the band descriptor when the build should split, else None."""
    resolved = (
        seam_split if seam_split is not None
        else getattr(base, "seam_split", None)
    )
    if resolved is False:
        return None
    band = seam_band_for_box(base, spec, rtol=rtol, safety=safety, device=device)
    if band is None:
        if resolved is True:
            raise MultiDomainBuildError(
                "seam_split=true but the emulator box never crosses the "
                "T = m/3 flux-seam band (no m_chi_GeV/T_p_GeV axis, or "
                "the seam's source weight is negligible across the box); "
                "drop the knob or widen the box"
            )
        return None
    return band


def multidomain_hash(
    domain_hashes, seam_band, identity, n: int = 16
) -> str:
    """The bundle's composite content hash (see
    :func:`bdlz_tpu_torch.provenance.multidomain_artifact_identity`)."""
    from bdlz_tpu_torch.provenance import multidomain_artifact_identity

    return multidomain_artifact_identity(
        list(domain_hashes), dict(seam_band), dict(identity),
        MULTI_SCHEMA_VERSION,
    ).digest(n)


def _split_spec(spec, band) -> List[Dict[str, Any]]:
    """The per-side sub-specs: the split axis truncated at the band
    edges (each side keeps its full initial node count — refinement
    redistributes), every other axis untouched.  A side swallowed by
    the band is dropped; both sides gone is an error (the whole box is
    seam band — there is nothing an emulator can honestly serve)."""
    axis, lo, hi = band["axis"], band["lo"], band["hi"]
    ax = spec[axis]
    sides = []
    if lo > ax.lo:
        sides.append(("below_seam", ax._replace(hi=lo)))
    if hi < ax.hi:
        sides.append(("above_seam", ax._replace(lo=hi)))
    if not sides:
        raise MultiDomainBuildError(
            f"the whole {axis} range [{ax.lo}, {ax.hi}] lies inside the "
            f"T = m/3 seam band [{lo}, {hi}]: no seam-free side remains "
            "— serve this box from the exact path instead of an emulator"
        )
    out = []
    for name, sub_ax in sides:
        sub = dict(spec)
        sub[axis] = sub_ax
        out.append({"name": name, "spec": sub})
    return out


def build_seam_split_emulator(
    base,
    spec,
    static=None,
    *,
    band: Optional[Dict[str, Any]] = None,
    out_dir: Optional[str] = None,
    event_log=None,
    **build_kw,
) -> Tuple[MultiDomainArtifact, MultiDomainBuildReport]:
    """Build one single-scheme sub-artifact per side of the seam band
    and stitch them into a :class:`MultiDomainArtifact`.

    Each side goes through the unchanged :func:`build_emulator` path
    (``seam_split=False`` — per-domain bytes identical to a standalone
    build of that sub-box).  The y-quadrature tri-state is resolved
    ONCE across the sides (panel-GL only when EVERY side's audit admits
    it): the bundle's exact fallback runs one scheme, so the domains
    must agree — a mixed resolution forces the reference trapezoid on
    all sides, loudly.  Per-domain identities must come out equal; the
    shared identity plus the ordered domain hashes plus the band form
    the composite identity the registry/rollout layers address the
    bundle by.
    """
    from bdlz_tpu_torch.config import static_choices_from_config, validate
    from bdlz_tpu_torch.emulator.build import EmulatorBuildError, build_emulator

    t0 = time.time()
    validate(base)
    rtol = float(build_kw.get("rtol", 1e-4))
    safety = float(build_kw.get("safety", 2.0))
    if static is None:
        static = static_choices_from_config(base)
    if band is None:
        band = seam_band_for_box(base, spec, rtol=rtol, safety=safety,
                                 device=build_kw.get("device"))
        if band is None:
            raise MultiDomainBuildError(
                "build_seam_split_emulator needs a box that crosses the "
                "T = m/3 seam band; use build_emulator for smooth boxes"
            )
    sides = _split_spec(spec, band)

    # One quadrature scheme for the whole bundle: audit each side's
    # initial grid; panel-GL only if every side passes (mirrors
    # build_emulator's own resolution — an explicit True/False in the
    # static short-circuits, exactly like there).
    static = _resolve_bundle_quad(base, static, sides, build_kw)

    artifacts: List[EmulatorArtifact] = []
    reports: List[Any] = []
    for side in sides:
        try:
            art, rep = build_emulator(
                base, side["spec"], static, seam_split=False,
                out_dir=None, event_log=event_log, **build_kw,
            )
        except EmulatorBuildError as exc:
            raise MultiDomainBuildError(
                f"seam-split sub-build {side['name']!r} failed: {exc}"
            ) from exc
        art = art._replace(manifest={
            **art.manifest, "seam_side": side["name"],
        })
        artifacts.append(art)
        reports.append(rep)

    identity = artifacts[0].identity
    for art, side in zip(artifacts[1:], sides[1:]):
        if art.identity != identity:
            raise MultiDomainBuildError(
                f"per-domain identity skew between sub-builds "
                f"{sides[0]['name']!r} and {side['name']!r} — the bundle "
                "shares ONE exact-fallback engine, so every domain must "
                "resolve the same physics/engine/quadrature"
            )

    max_rel_err = max(r.max_rel_err for r in reports)
    converged = all(r.converged for r in reports)
    seconds = time.time() - t0
    rows: List[Dict[str, Any]] = []
    for side, rep in zip(sides, reports):
        rows.extend({**row, "seam_side": side["name"]} for row in rep.rounds)
    domain_hashes = [a.content_hash for a in artifacts]
    manifest = {
        "kind": MULTI_DOMAIN_KIND,
        "seam_band": dict(band),
        "rtol_target": rtol,
        "max_rel_err": max_rel_err,
        "converged": bool(converged),
        "n_exact_evals": int(sum(r.n_exact_evals for r in reports)),
        "build_seconds": round(seconds, 3),
        "domains": domain_hashes,
        "domain_sides": [s["name"] for s in sides],
        "per_domain_max_rel_err": [float(r.max_rel_err) for r in reports],
        "error_grid": all(
            a.predicted_error is not None for a in artifacts
        ),
    }
    bundle = MultiDomainArtifact(
        domains=tuple(artifacts),
        seam_band=dict(band),
        identity=identity,
        manifest=manifest,
    )
    report = MultiDomainBuildReport(
        domain_reports=tuple(reports),
        seam_band=dict(band),
        converged=bool(converged),
        max_rel_err=float(max_rel_err),
        rtol=rtol,
        n_exact_evals=int(sum(r.n_exact_evals for r in reports)),
        build_seconds=round(seconds, 3),
        rounds=rows,
    )
    if event_log is not None:
        event_log.emit(
            "emulator_seam_split_done",
            seam_band=dict(band), n_domains=len(artifacts),
            converged=bool(converged), max_rel_err=max_rel_err,
            n_exact_evals=report.n_exact_evals, seconds=round(seconds, 3),
        )
    if out_dir is not None:
        save_multidomain_artifact(out_dir, bundle)
    return bundle, report


def _resolve_bundle_quad(base, static, sides, build_kw):
    """Resolve the y-quadrature tri-state once, across every side."""
    from bdlz_tpu_torch.config import needs_ode_path
    from bdlz_tpu_torch.emulator.build import _axis_nodes
    from bdlz_tpu_torch.validation import resolve_quad_panel_gl

    impl = str(build_kw.get("impl", "tabulated"))
    n_y = int(build_kw.get("n_y", 2000))
    if needs_ode_path(base) and impl != "esdirk_lockstep":
        impl = "esdirk"
    if static.quad_panel_gl is not None or impl != "tabulated":
        return static
    from bdlz_tpu_torch.parallel.sweep import build_grid

    resolved = []
    for side in sides:
        sub = side["spec"]
        if "I_p" in sub:  # per-I_p table unavailable: direct engine
            return static
        grid = build_grid(
            base,
            {k: _axis_nodes(ax) for k, ax in sub.items()},
            product=True,
        )
        on, _audit = resolve_quad_panel_gl(
            grid, static, impl, n_y, label=f"emulator[{side['name']}]",
        )
        resolved.append(bool(on))
    scheme = all(resolved)
    if not scheme and any(resolved):
        print(
            "[emulator] seam-split sides resolved MIXED y-quadrature "
            "schemes; forcing the reference trapezoid on every domain "
            "so the bundle serves one scheme",
            file=sys.stderr,
        )
    return static._replace(quad_panel_gl=scheme)


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

def _domain_dirname(i: int) -> str:
    return f"domain_{i:02d}"


def save_multidomain_artifact(out_dir: str, bundle: MultiDomainArtifact) -> str:
    """Write the bundle: one standard artifact directory per domain,
    then the bundle ``manifest.json`` LAST (atomic) — a reader never
    sees a manifest naming half-written domains."""
    from bdlz_tpu_torch.utils.io import atomic_write_json

    os.makedirs(out_dir, exist_ok=True)
    domain_hashes = []
    for i, dom in enumerate(bundle.domains):
        save_artifact(os.path.join(out_dir, _domain_dirname(i)), dom)
        domain_hashes.append(dom.content_hash)
    manifest = dict(bundle.manifest)
    manifest["kind"] = MULTI_DOMAIN_KIND
    manifest["schema_version"] = MULTI_SCHEMA_VERSION
    manifest["domains"] = domain_hashes
    manifest["domain_dirs"] = [
        _domain_dirname(i) for i in range(len(bundle.domains))
    ]
    manifest["seam_band"] = dict(bundle.seam_band)
    manifest["identity"] = bundle.identity
    manifest["hash"] = multidomain_hash(
        domain_hashes, bundle.seam_band, bundle.identity
    )
    atomic_write_json(
        os.path.join(out_dir, "manifest.json"), manifest, indent=2
    )
    return out_dir


def load_multidomain_artifact(path: str) -> MultiDomainArtifact:
    """Load + fully validate a seam-split bundle.

    Every rejection is a loud :class:`EmulatorArtifactError`: missing or
    unparsable manifest, schema-version or ``kind`` skew, any domain
    failing ITS full single-artifact validation (schema, content hash,
    finite/positive tables), a domain directory whose verified hash is
    not the one the bundle manifest names (an impersonating or swapped
    domain), composite-hash mismatch, per-domain identity skew, or
    domains that overlap along the split axis.
    """
    manifest_path = os.path.join(path, "manifest.json")
    try:
        with open(manifest_path, encoding="utf-8") as f:
            manifest = json.load(f)
    except Exception as exc:
        raise EmulatorArtifactError(
            f"cannot read emulator bundle manifest {manifest_path}: {exc!r}"
        ) from exc
    if manifest.get("kind") != MULTI_DOMAIN_KIND:
        raise EmulatorArtifactError(
            f"{path} is not a multi-domain bundle (kind="
            f"{manifest.get('kind')!r}); load single artifacts with "
            "emulator.load_artifact"
        )
    version = manifest.get("schema_version")
    if version != MULTI_SCHEMA_VERSION:
        raise EmulatorArtifactError(
            f"emulator bundle {path} has schema_version {version!r}, this "
            f"build reads {MULTI_SCHEMA_VERSION}; rebuild the bundle"
        )
    want_hashes = [str(h) for h in manifest.get("domains", ())]
    dirs = [str(d) for d in manifest.get("domain_dirs", ())]
    band = manifest.get("seam_band")
    if not want_hashes or len(want_hashes) != len(dirs) or not isinstance(
        band, dict
    ):
        raise EmulatorArtifactError(
            f"emulator bundle manifest {manifest_path} is missing "
            "domains/domain_dirs/seam_band"
        )
    domains: List[EmulatorArtifact] = []
    for want, sub in zip(want_hashes, dirs):
        dom = load_artifact(os.path.join(path, sub))
        if dom.content_hash != want:
            raise EmulatorArtifactError(
                f"bundle domain {sub!r} verifies as "
                f"{dom.content_hash!r}, but the bundle manifest names "
                f"{want!r}: refusing the swapped/impersonating domain"
            )
        domains.append(dom)
    identity = manifest.get("identity")
    if not isinstance(identity, dict):
        raise EmulatorArtifactError(
            f"emulator bundle manifest {manifest_path} is missing identity"
        )
    for sub, dom in zip(dirs, domains):
        if dom.identity != identity:
            raise EmulatorArtifactError(
                f"bundle domain {sub!r} carries a different physics "
                "identity than the bundle manifest — the shared exact "
                "fallback cannot serve both; rebuild the bundle"
            )
    got = multidomain_hash(want_hashes, band, identity)
    if got != manifest.get("hash"):
        raise EmulatorArtifactError(
            f"emulator bundle {path} failed its composite content-hash "
            f"check (manifest {manifest.get('hash')!r}, recomputed "
            f"{got!r}): a domain, the seam band, or the identity changed "
            "after the build — rebuild instead of serving a stale bundle"
        )
    bundle = MultiDomainArtifact(
        domains=tuple(domains),
        seam_band=dict(band),
        identity=identity,
        manifest=manifest,
    )
    _validate_bundle_geometry(bundle, where=f"load {path}")
    return bundle


def _validate_bundle_geometry(bundle: MultiDomainArtifact, where: str) -> None:
    """Domains must share axes/scales and be disjoint along the split
    axis, ordered below→above the band."""
    names = bundle.domains[0].axis_names
    scales = bundle.domains[0].axis_scales
    for dom in bundle.domains[1:]:
        if dom.axis_names != names or dom.axis_scales != scales:
            raise EmulatorArtifactError(
                f"{where}: bundle domains disagree on axis names/scales"
            )
    axis = bundle.seam_band.get("axis")
    if axis not in names:
        raise EmulatorArtifactError(
            f"{where}: seam-band axis {axis!r} is not a bundle axis "
            f"({list(names)})"
        )
    k = names.index(axis)
    spans = sorted(
        (float(d.axis_nodes[k][0]), float(d.axis_nodes[k][-1]))
        for d in bundle.domains
    )
    for (lo_a, hi_a), (lo_b, _hi_b) in zip(spans, spans[1:]):
        if lo_b < hi_a:
            raise EmulatorArtifactError(
                f"{where}: bundle domains OVERLAP along {axis!r} "
                f"([{lo_a}, {hi_a}] vs one starting at {lo_b}) — query "
                "routing would be ambiguous"
            )


def load_any_artifact(path: str):
    """Load whichever artifact kind ``path`` holds (single-domain
    :class:`EmulatorArtifact` or seam-split
    :class:`MultiDomainArtifact`), dispatching on the manifest's
    ``kind`` tag with full validation either way."""
    manifest_path = os.path.join(path, "manifest.json")
    try:
        with open(manifest_path, encoding="utf-8") as f:
            kind = json.load(f).get("kind")
    except Exception as exc:
        raise EmulatorArtifactError(
            f"cannot read emulator manifest {manifest_path}: {exc!r}"
        ) from exc
    if kind == MULTI_DOMAIN_KIND:
        return load_multidomain_artifact(path)
    return load_artifact(path)
