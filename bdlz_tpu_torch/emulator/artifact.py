"""Versioned yield-surface emulator artifacts: save, load, reject loudly.

Counterpart of ``bdlz_tpu/emulator/artifact.py``, schema 2, the same
bytes on disk: a directory holding ``artifact.npz`` (``axis_<name>``
nodes, ``field_<name>`` tables shaped ``(n_1, …, n_d)`` in axis order,
and the per-cell ``predicted_error`` grid) and ``manifest.json`` (schema
version, physics identity, build provenance and the content hash).  An
artifact either package wrote loads in the other, and its recomputed
hash verifies.  Every way an artifact can go stale — changed physics
knobs, a modified table or error grid, another schema — is an
:class:`EmulatorArtifactError` at load.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, NamedTuple, Sequence, Tuple

import numpy as np

#: Bump whenever the artifact layout or manifest meaning changes: a
#: version mismatch at load is an explicit error, never a reinterpret.
#: v2: artifacts persist the per-cell a-posteriori
#: predicted-error grid the refiner computes (the serve layer's exact-
#: fallback gate) — it joins the content hash, so v1 artifacts reject
#: LOUDLY at the version check and must be rebuilt.
SCHEMA_VERSION = 2

#: The pipeline outputs an artifact carries (YieldsResult field order).
FIELDS = ("Y_B", "Y_chi", "rho_B_kg_m3", "rho_DM_kg_m3", "DM_over_B")


class EmulatorArtifactError(ValueError):
    """A stale, tampered, or malformed emulator artifact.

    A dedicated type so callers can distinguish "this artifact must be
    rebuilt" from unrelated ValueErrors — and so tests can pin that
    every rejection path raises it explicitly."""


class EmulatorArtifact(NamedTuple):
    """One loaded (or freshly built) yield-surface emulator."""

    axis_names: Tuple[str, ...]            # config-schema axis names, in order
    axis_nodes: Tuple[np.ndarray, ...]     # strictly increasing f64 nodes
    axis_scales: Tuple[str, ...]           # "lin" | "log" interpolation coord
    values: Dict[str, np.ndarray]          # field -> (n_1, ..., n_d) f64
    identity: Dict[str, Any]               # resolved config/static/n_y/impl
    manifest: Dict[str, Any]               # full manifest payload
    #: Per-cell a-posteriori relative-error estimate (|f2|h^2/8*ln10,
    #: maxed over fields and axes), shape ``(n_1-1, ..., n_d-1)`` — the
    #: numbers the refiner steered on, persisted so the serving layer
    #: can gate exact fallback on PREDICTED error instead of only on
    #: domain membership.  None on artifacts that never computed one
    #: (hand-assembled fixtures); the serve gate then degrades to the
    #: artifact-level held-out number.
    predicted_error: "np.ndarray | None" = None

    @property
    def domain(self) -> Dict[str, Tuple[float, float]]:
        return {
            name: (float(nodes[0]), float(nodes[-1]))
            for name, nodes in zip(self.axis_names, self.axis_nodes)
        }

    @property
    def hull(self) -> Tuple[np.ndarray, np.ndarray]:
        """(lo, hi) corner vectors of the box, in axis order — the one
        rule every warm-start probe and bench trace generator uses, and
        the piece of the interface a multi-domain bundle shares."""
        return (
            np.asarray([float(n[0]) for n in self.axis_nodes]),
            np.asarray([float(n[-1]) for n in self.axis_nodes]),
        )

    @property
    def n_points(self) -> int:
        n = 1
        for nodes in self.axis_nodes:
            n *= len(nodes)
        return n

    @property
    def content_hash(self) -> str:
        """The artifact's content hash — the token the serving fleet
        stamps on every response and the rollout layer agrees on across
        hosts.  Loaded artifacts carry it in the manifest (already
        verified against the bytes at load); a freshly built, not yet
        saved artifact computes it on demand — either way the value is
        identical to what :func:`save_artifact` would write."""
        h = self.manifest.get("hash")
        if h is not None:
            return str(h)
        return artifact_hash(
            self.axis_names, self.axis_nodes, self.axis_scales,
            self.values, self.identity,
            predicted_error=self.predicted_error,
        )


def build_identity(
    base, static, n_y: int, impl: str,
    posterior_weight: "str | None" = None,
    lz_profile_fp: "str | None" = None,
    refine_signal: "str | None" = None,
    bounce_fp: "str | None" = None,
    traffic_fp: "str | None" = None,
) -> Dict[str, Any]:
    """The physics identity an artifact is valid for.

    Same ingredients as ``parallel.sweep.grid_hash`` (config through
    ``config_identity_dict`` so adding a defaulted extension field does
    not invalidate every existing artifact; resolved StaticChoices;
    n_y; engine) — an emulator is a cache of ``run_sweep`` output and
    must go stale exactly when a sweep directory would.

    The quadrature tri-state is carried as its own ``quad_panel_gl``
    key, present IFF the caller's static resolves it (True or False) —
    surfaces computed under different y-quadrature schemes hash (and
    therefore reject) differently, while a consumer whose static leaves
    the knob ``None`` emits no key and is expected to ADOPT the
    artifact's recorded scheme before checking (see
    :func:`check_identity` / the serve + likelihood layers).  The knob
    is normalized OUT of the static tuple so this key is its single
    home in the identity.

    ``posterior_weight`` follows the same single-home pattern: when the
    build's refinement criterion was posterior-weighted (explicit
    argument, else the base config's knob), the resolved weight name is
    its own ``posterior_weight`` key — weighted and unweighted surfaces
    over the same box place nodes differently and must never be
    confused, while a consumer that states no expectation matches
    either (``check_identity``'s wildcard rule).  The knob is excluded
    from the config payload (``config.EMULATOR_CONFIG_FIELDS``), so
    this key is its single home too.

    The LZ scenario plane (docs/scenarios.md) joins the same way: a
    chain/thermal surface carries its resolved scenario as its own
    ``lz_scenario`` key (mode + parameters; omit-at-default, single
    home — ``config.SCENARIO_*_FIELDS`` exclude the knobs everywhere
    else) and is STRICT both ways in ``check_identity`` — cross-mode
    artifact/consumer skew must reject loudly.  ``lz_profile_fp``
    (the bounce-profile fingerprint the per-point P was derived from)
    is its own ``lz_profile`` key with the posterior_weight wildcard
    rule: strict when the caller states a profile, wildcard when not.
    ``bounce_fp`` (the POTENTIAL fingerprint when the profile was shot
    in-framework from a :class:`~bdlz_tpu_torch.bounce.PotentialSpec` rather
    than loaded from a CSV) joins the same way as its own ``bounce``
    key — wildcard-when-unstated, so profile-fed artifacts keep their
    hashes, but two potentials can never share a surface.

    ``traffic_fp`` (the content fingerprint of the served-traffic
    snapshot a ``refine_signal="traffic"``/``"traffic*planck"`` build
    was weighted by, ``bdlz_tpu_torch/refine/traffic.py``) joins as its own
    ``traffic`` key with the same wildcard rule: two snapshots place
    nodes differently and must never share a surface, while a consumer
    that states no snapshot (every pre-closed-loop caller) matches any.
    """
    from bdlz_tpu_torch.config import (
        ROBUSTNESS_STATIC_FIELDS,
        SCENARIO_STATIC_FIELDS,
        config_identity_dict,
    )
    from bdlz_tpu_torch.lz.sweep_bridge import scenario_identity

    quad = static.quad_panel_gl
    st = static._replace(quad_panel_gl=None)
    if posterior_weight is None:
        posterior_weight = getattr(base, "posterior_weight", None)
    excluded = set(ROBUSTNESS_STATIC_FIELDS) | set(SCENARIO_STATIC_FIELDS)
    out = {
        "base": config_identity_dict(base),
        # robustness knobs (retry/fault gates) are orchestration-only
        # and excluded: with faults off they cannot change a value bit,
        # and keying them in would stale every pre-existing artifact.
        # The scenario knobs are excluded from the POSITIONAL list too —
        # their single home is the lz_scenario key below, which keeps
        # every pre-scenario artifact hash byte-stable.
        "static": [
            v for f, v in zip(type(st)._fields, st) if f not in excluded
        ],
        "n_y": int(n_y),
        "impl": str(impl),
    }
    if quad is not None:
        out["quad_panel_gl"] = bool(quad)
    if posterior_weight is not None:
        out["posterior_weight"] = str(posterior_weight)
    if refine_signal is None:
        refine_signal = getattr(base, "refine_signal", None)
    if refine_signal is not None:
        # the Fisher-aware refinement signal moves nodes exactly like a
        # posterior weighting: same single-home omit-at-default key,
        # same wildcard rule in check_identity
        out["refine_signal"] = str(refine_signal)
    if traffic_fp is not None:
        # the traffic-weighted refinement signal moves nodes per
        # SNAPSHOT, not just per signal name: the snapshot fingerprint
        # is its own key (wildcard rule in check_identity) so two
        # traffic-specialized builds over different query distributions
        # can never be confused
        out["traffic"] = str(traffic_fp)
    scen = scenario_identity(static)
    if scen is not None:
        out["lz_scenario"] = scen
    if lz_profile_fp is not None:
        out["lz_profile"] = str(lz_profile_fp)
    if bounce_fp is not None:
        out["bounce"] = str(bounce_fp)
    return out


def artifact_hash(
    axis_names: Sequence[str],
    axis_nodes: Sequence[np.ndarray],
    axis_scales: Sequence[str],
    values: Mapping[str, np.ndarray],
    identity: Mapping[str, Any],
    predicted_error: "np.ndarray | None" = None,
) -> str:
    """Content hash over axes + value bytes + error grid + identity +
    schema version.

    The axis SCALES are part of the identity: they select each axis's
    interpolation coordinate, so the same table queried under a
    different scale list returns different numbers.  The per-cell
    predicted-error grid is hashed too: the serve layer gates exact
    fallback on it, so tampering with it must be as loud as tampering
    with the value table.

    Construction lives in the shared provenance layer
    (:func:`bdlz_tpu_torch.provenance.emulator_artifact_identity`),
    byte-equal to the JAX package's.
    """
    from bdlz_tpu_torch.provenance import emulator_artifact_identity

    return emulator_artifact_identity(
        axis_names, axis_nodes, axis_scales, values, identity,
        SCHEMA_VERSION, predicted_error=predicted_error,
    ).digest(16)


def _validate_table(artifact: EmulatorArtifact, where: str) -> None:
    """Reject non-finite or non-positive cells LOUDLY.

    The query kernel interpolates in log-space: a NaN/inf cell would
    poison every query in its 2^d-cell neighborhood, and a zero or
    negative cell has no logarithm — both must fail at the boundary
    (build or load), never surface as a quietly wrong served yield.
    """
    if len(artifact.axis_names) != len(artifact.axis_nodes):
        raise EmulatorArtifactError(
            f"{where}: {len(artifact.axis_names)} axis names but "
            f"{len(artifact.axis_nodes)} node arrays"
        )
    shape = tuple(len(n) for n in artifact.axis_nodes)
    if len(artifact.axis_scales) != len(artifact.axis_names):
        raise EmulatorArtifactError(
            f"{where}: {len(artifact.axis_names)} axes but "
            f"{len(artifact.axis_scales)} scales"
        )
    for name, nodes, scale in zip(
        artifact.axis_names, artifact.axis_nodes, artifact.axis_scales
    ):
        nodes = np.asarray(nodes)
        if scale not in ("lin", "log"):
            raise EmulatorArtifactError(
                f"{where}: axis {name!r} has unknown scale {scale!r}"
            )
        if nodes.ndim != 1 or len(nodes) < 2:
            raise EmulatorArtifactError(
                f"{where}: axis {name!r} needs >= 2 one-dimensional nodes"
            )
        if not np.all(np.isfinite(nodes)) or not np.all(np.diff(nodes) > 0):
            raise EmulatorArtifactError(
                f"{where}: axis {name!r} nodes must be finite and strictly "
                "increasing"
            )
        if scale == "log" and nodes[0] <= 0.0:
            raise EmulatorArtifactError(
                f"{where}: log-scale axis {name!r} needs positive nodes"
            )
    if not artifact.values:
        raise EmulatorArtifactError(f"{where}: artifact carries no fields")
    for fname, vals in artifact.values.items():
        vals = np.asarray(vals)
        if vals.shape != shape:
            raise EmulatorArtifactError(
                f"{where}: field {fname!r} has shape {vals.shape}, expected "
                f"{shape} from the axis node counts"
            )
        bad = ~np.isfinite(vals)
        if bad.any():
            idx = tuple(int(i) for i in np.argwhere(bad)[0])
            raise EmulatorArtifactError(
                f"{where}: field {fname!r} holds {int(bad.sum())} "
                f"non-finite cell(s), first at grid index {idx} — the "
                "emulator build masks nothing; rebuild over a domain where "
                "the exact pipeline succeeds"
            )
        nonpos = vals <= 0.0
        if nonpos.any():
            idx = tuple(int(i) for i in np.argwhere(nonpos)[0])
            raise EmulatorArtifactError(
                f"{where}: field {fname!r} holds {int(nonpos.sum())} "
                f"non-positive cell(s), first at grid index {idx} — the "
                "log-space query kernel needs strictly positive values"
            )
    if artifact.predicted_error is not None:
        err = np.asarray(artifact.predicted_error)
        cells = tuple(max(n - 1, 1) for n in shape)
        if err.shape != cells:
            raise EmulatorArtifactError(
                f"{where}: predicted-error grid has shape {err.shape}, "
                f"expected the cell shape {cells} from the axis node "
                "counts"
            )
        if not np.all(np.isfinite(err)) or (err < 0.0).any():
            raise EmulatorArtifactError(
                f"{where}: predicted-error grid must be finite and "
                ">= 0 — the serve layer gates exact fallback on it"
            )


def save_artifact(out_dir: str, artifact: EmulatorArtifact) -> str:
    """Write ``artifact.npz`` + ``manifest.json`` into ``out_dir``.

    Both writes are atomic (tmp + ``os.replace``; the manifest through
    the shared ``utils.io.atomic_write_json`` helper) and the manifest
    goes LAST — a reader never sees a manifest whose hash refers to a
    half-written ``.npz``.
    """
    from bdlz_tpu_torch.utils.io import atomic_write_json

    _validate_table(artifact, where="save")
    os.makedirs(out_dir, exist_ok=True)
    npz_path = os.path.join(out_dir, "artifact.npz")

    arrays: Dict[str, np.ndarray] = {}
    for name, nodes in zip(artifact.axis_names, artifact.axis_nodes):
        arrays[f"axis_{name}"] = np.asarray(nodes, dtype=np.float64)
    for name, vals in artifact.values.items():
        arrays[f"field_{name}"] = np.asarray(vals, dtype=np.float64)
    if artifact.predicted_error is not None:
        arrays["predicted_error"] = np.asarray(
            artifact.predicted_error, dtype=np.float64
        )
    from bdlz_tpu_torch.utils.io import atomic_savez

    atomic_savez(npz_path, **arrays)

    manifest = dict(artifact.manifest)
    manifest["schema_version"] = SCHEMA_VERSION
    manifest["axes"] = list(artifact.axis_names)
    manifest["axis_scales"] = {
        n: s for n, s in zip(artifact.axis_names, artifact.axis_scales)
    }
    manifest["fields"] = sorted(artifact.values)
    manifest["error_grid"] = artifact.predicted_error is not None
    manifest["identity"] = artifact.identity
    manifest["hash"] = artifact_hash(
        artifact.axis_names, artifact.axis_nodes, artifact.axis_scales,
        artifact.values, artifact.identity,
        predicted_error=artifact.predicted_error,
    )
    atomic_write_json(os.path.join(out_dir, "manifest.json"), manifest, indent=2)
    return out_dir


def load_artifact(
    path: str, expect_identity: "Mapping[str, Any] | None" = None
) -> EmulatorArtifact:
    """Load and fully validate an artifact directory.

    Rejections (all :class:`EmulatorArtifactError`, all explicit about
    what went stale):

    * missing/unparsable manifest or ``.npz``;
    * ``schema_version`` mismatch (the reader would misinterpret the
      layout);
    * content-hash mismatch — the ``.npz`` or the manifest's identity
      was modified after the build (torn copy, hand edit, bit rot);
    * non-finite or non-positive table cells (see ``_validate_table``);
    * ``expect_identity`` given and != the stored identity — the caller
      is about to serve physics the artifact was not built for (changed
      config knobs, different engine, different n_y).
    """
    manifest_path = os.path.join(path, "manifest.json")
    npz_path = os.path.join(path, "artifact.npz")
    try:
        with open(manifest_path, encoding="utf-8") as f:
            manifest = json.load(f)
    except Exception as exc:
        raise EmulatorArtifactError(
            f"cannot read emulator manifest {manifest_path}: {exc!r}"
        ) from exc
    if manifest.get("kind") == "multi_domain":
        raise EmulatorArtifactError(
            f"{path} is a MULTI-DOMAIN emulator bundle (seam-split "
            "domains stitched at query time); load it with "
            "emulator.multidomain.load_multidomain_artifact or the "
            "kind-dispatching emulator.load_any_artifact"
        )
    version = manifest.get("schema_version")
    if version != SCHEMA_VERSION:
        raise EmulatorArtifactError(
            f"emulator artifact {path} has schema_version {version!r}, this "
            f"build reads {SCHEMA_VERSION}; rebuild the artifact"
        )
    axis_names = tuple(str(n) for n in manifest.get("axes", ()))
    field_names = [str(n) for n in manifest.get("fields", ())]
    identity = manifest.get("identity")
    scales_map = manifest.get("axis_scales")
    if (
        not axis_names or not field_names
        or not isinstance(identity, dict) or not isinstance(scales_map, dict)
    ):
        raise EmulatorArtifactError(
            f"emulator manifest {manifest_path} is missing "
            "axes/axis_scales/fields/identity"
        )
    axis_scales = tuple(str(scales_map.get(n, "lin")) for n in axis_names)
    try:
        with np.load(npz_path) as data:
            axis_nodes = tuple(
                np.asarray(data[f"axis_{n}"], dtype=np.float64)
                for n in axis_names
            )
            values = {
                n: np.asarray(data[f"field_{n}"], dtype=np.float64)
                for n in field_names
            }
            predicted_error = (
                np.asarray(data["predicted_error"], dtype=np.float64)
                if "predicted_error" in data.files else None
            )
    except EmulatorArtifactError:
        raise
    except Exception as exc:
        raise EmulatorArtifactError(
            f"cannot read emulator table {npz_path}: {exc!r}"
        ) from exc

    got_hash = artifact_hash(
        axis_names, axis_nodes, axis_scales, values, identity,
        predicted_error=predicted_error,
    )
    if got_hash != manifest.get("hash"):
        raise EmulatorArtifactError(
            f"emulator artifact {path} failed its content-hash check "
            f"(manifest {manifest.get('hash')!r}, recomputed {got_hash!r}): "
            "the table or its identity changed after the build — rebuild "
            "instead of serving a stale/tampered surface"
        )
    artifact = EmulatorArtifact(
        axis_names=axis_names,
        axis_nodes=axis_nodes,
        axis_scales=axis_scales,
        values=values,
        identity=identity,
        manifest=manifest,
        predicted_error=predicted_error,
    )
    _validate_table(artifact, where=f"load {path}")
    if expect_identity is not None:
        check_identity(artifact, expect_identity)
    return artifact


def check_identity(
    artifact: EmulatorArtifact,
    expect: Mapping[str, Any],
    exempt_config_keys: Sequence[str] = (),
) -> None:
    """Raise unless the artifact was built for the expected physics.

    ``exempt_config_keys`` names base-config keys whose stored value is
    irrelevant because they are artifact AXES (the per-point value
    overrides them) — the likelihood layer uses this so a caller whose
    base config differs only in a swept field is not falsely rejected.

    The ``quad_panel_gl`` key is strict whenever the CALLER states a
    scheme (an explicit True/False in their static): an artifact built
    under the other y-quadrature is rejected.  A caller whose
    expectation carries no key (tri-state ``None`` — "use whatever the
    artifact used") matches either; such callers must adopt the
    artifact's recorded scheme for their exact-fallback path, which the
    serve/likelihood layers do.  The ``posterior_weight`` key follows
    the same rule: strict when the caller names a weighting, wildcard
    when their knob is unset (weighting moves nodes, never what the
    exact engine computes at them — the fallback path is unaffected),
    and ``lz_profile`` (the scenario bounce-profile fingerprint) and
    ``bounce`` (the in-framework potential fingerprint) too.
    The ``lz_scenario`` key is deliberately STRICT both ways: a chain
    or thermal surface served to a two-channel consumer (or vice
    versa) is cross-mode skew and must reject loudly — there is no
    "adopt the artifact's physics scenario" story the way there is for
    a quadrature scheme.
    """
    stored = dict(artifact.identity)
    want = dict(expect)
    if "quad_panel_gl" not in want:
        stored.pop("quad_panel_gl", None)
    if "posterior_weight" not in want:
        stored.pop("posterior_weight", None)
    if "refine_signal" not in want:
        # wildcard like posterior_weight: the signal steers node
        # placement during the build, never what the exact engine
        # computes — a caller with no expectation matches either
        stored.pop("refine_signal", None)
    if "lz_profile" not in want:
        stored.pop("lz_profile", None)
    if "bounce" not in want:
        # wildcard like lz_profile: the potential fingerprint names the
        # SOURCE of the derived profile; a caller that states no
        # potential matches either, while stating one pins it strictly
        # (cross-potential artifact/consumer skew must reject loudly)
        stored.pop("bounce", None)
    if "traffic" not in want:
        # wildcard like refine_signal: the snapshot fingerprint steers
        # node placement, never what the exact engine computes — a
        # caller with no stated snapshot (every serving front) matches
        # either; stating one pins it strictly
        stored.pop("traffic", None)
    sb = dict(stored.get("base", {}))
    wb = dict(want.get("base", {}))
    for key in set(exempt_config_keys) | set(artifact.axis_names):
        sb.pop(key, None)
        wb.pop(key, None)
    stored["base"], want["base"] = sb, wb
    diffs: List[str] = []
    for key in sorted(set(stored) | set(want)):
        if stored.get(key) != want.get(key):
            diffs.append(
                f"{key}: artifact={stored.get(key)!r} caller={want.get(key)!r}"
            )
    if diffs:
        raise EmulatorArtifactError(
            "emulator artifact identity mismatch (stale artifact — the "
            "physics knobs changed since the build; rebuild it):\n  "
            + "\n  ".join(diffs)
        )
