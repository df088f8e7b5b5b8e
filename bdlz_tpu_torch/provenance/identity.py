"""Typed content identities: the hash layer of the sweep directory, the
chunk cache and the emulator artifacts.

Counterpart of ``bdlz_tpu/provenance/identity.py``.  Every digest here
is byte-equal to the JAX package's for equal inputs, so a sweep
directory, an emulator artifact or a bundle written by one package
verifies in the other.  The rules:

* JSON parts are ``json.dumps(…, sort_keys=True)``; array parts are
  contiguous float64 bytes;
* configs enter through ``config_identity_dict`` (reference keys always,
  extension keys only when not at their defaults);
* retry, fault, serve and cache knobs never enter an identity;
* an armed fault plan does (through the sweep's ``extra`` blocks), so a
  chaos result never collides with a clean one.

The ``kind`` tag is not hashed.  The MCMC segment identity carries one
key of the port's own, the random stream, so that a chain directory of one
package is never resumed by the other.  The traffic-snapshot identity is
byte-equal to the JAX package's, so a snapshot saved by either package
loads in the other, and so is the bench-leg identity.  The package-source
fingerprint hashes the port's own sources, its CUDA kernels included.
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np

#: Version of payload schemas that carry it explicitly.
SCHEMA_VERSION = 1


class Identity(NamedTuple):
    """One content identity: a ``kind`` tag and an ordered list of
    ``(tag, value)`` parts, tag one of ``"json"`` (canonical sorted-keys
    JSON), ``"text"`` (UTF-8) or ``"bytes"`` (raw).  The part order is
    the hash order."""

    kind: str
    parts: Tuple[Tuple[str, Any], ...]

    def digest(self, n: int = 16) -> str:
        """First ``n`` hex characters of the SHA-256 over the parts."""
        h = hashlib.sha256()
        for tag, value in self.parts:
            if tag == "json":
                h.update(json.dumps(value, sort_keys=True).encode())
            elif tag == "text":
                h.update(str(value).encode())
            elif tag == "bytes":
                h.update(value)
            else:
                raise ValueError(f"unknown identity part tag {tag!r}")
        return h.hexdigest()[:n]

    def describe(self) -> Dict[str, Any]:
        """Human-oriented summary (payloads verbatim, bytes as lengths)."""
        out: Dict[str, Any] = {"kind": self.kind, "parts": []}
        for tag, value in self.parts:
            if tag == "bytes":
                out["parts"].append({"tag": tag, "n_bytes": len(value)})
            else:
                out["parts"].append({"tag": tag, "value": value})
        return out


def array_part(arr: Any) -> Tuple[str, bytes]:
    """A ``bytes`` part from an array: contiguous float64 bytes."""
    return ("bytes", np.ascontiguousarray(np.asarray(arr, dtype=np.float64)).tobytes())


def config_payload(base) -> Dict[str, Any]:
    """The config side of every identity (``config_identity_dict``)."""
    from bdlz_tpu_torch.config import config_identity_dict

    return config_identity_dict(base)


def static_payload(static, *, normalize_quad: bool = False) -> list:
    """The StaticChoices values in declaration order, without the
    robustness and scenario fields; ``normalize_quad`` sets the
    quadrature tri-state to None first (for identities that carry the
    resolved scheme as a key of its own)."""
    from bdlz_tpu_torch.config import ROBUSTNESS_STATIC_FIELDS, SCENARIO_STATIC_FIELDS

    st = static._replace(quad_panel_gl=None) if normalize_quad else static
    excluded = set(ROBUSTNESS_STATIC_FIELDS) | set(SCENARIO_STATIC_FIELDS)
    return [v for f, v in zip(type(st)._fields, st) if f not in excluded]


def sweep_identity(
    base,
    axes: Mapping[str, Sequence[float]],
    n_y: int,
    impl: str = "tabulated",
    extra: Optional[Mapping[str, Any]] = None,
) -> Identity:
    """The sweep directory's resume identity (``grid_hash``); ``extra``
    enters only when it is not empty."""
    payload: Dict[str, Any] = {
        "base": config_payload(base),
        "axes": {k: list(map(float, v)) for k, v in axes.items()},
        "n_y": n_y,
        "impl": impl,
    }
    if extra:
        payload["extra"] = dict(extra)
    return Identity("sweep", (("json", payload),))


def emulator_artifact_identity(
    axis_names: Sequence[str],
    axis_nodes: Sequence[np.ndarray],
    axis_scales: Sequence[str],
    values: Mapping[str, np.ndarray],
    identity: Mapping[str, Any],
    schema_version: int,
    predicted_error: "np.ndarray | None" = None,
) -> Identity:
    """An emulator artifact's content identity: a JSON header (schema,
    axes, scales, physics identity, field list, and ``error_grid`` when
    the artifact has one), then the field-sorted value bytes, then the
    per-cell predicted-error bytes."""
    payload = {
        "schema_version": int(schema_version),
        "axes": {
            str(n): [float(v) for v in np.asarray(nodes)]
            for n, nodes in zip(axis_names, axis_nodes)
        },
        "scales": [str(s) for s in axis_scales],
        "identity": dict(identity),
        "fields": sorted(values),
    }
    if predicted_error is not None:
        payload["error_grid"] = True
    parts: list = [("json", payload)]
    for name in sorted(values):
        parts.append(("text", name))
        parts.append(array_part(values[name]))
    if predicted_error is not None:
        parts.append(("text", "predicted_error"))
        parts.append(array_part(predicted_error))
    return Identity("emulator_artifact", tuple(parts))


def multidomain_artifact_identity(
    domain_hashes: Sequence[str],
    seam_band: Mapping[str, Any],
    identity: Mapping[str, Any],
    schema_version: int,
) -> Identity:
    """A seam-split bundle's composite identity: the ordered domain
    hashes, the seam-band descriptor and the shared physics identity."""
    return Identity(
        "emulator_multidomain",
        (("json", {
            "schema_version": int(schema_version),
            "domains": [str(h) for h in domain_hashes],
            "seam_band": dict(seam_band),
            "identity": dict(identity),
        }),),
    )


def sweep_chunk_identity(
    core: Mapping[str, Any], pp_slice_arrays: Sequence[np.ndarray]
) -> Identity:
    """One sweep chunk's content key: the engine-core payload (see
    ``parallel.sweep.chunk_cache_key``) and the bytes of every
    PointParams column over the unpadded ``[lo:hi)`` slice.  The axes
    and the chunk's position are not part of it."""
    parts: list = [("json", dict(core))]
    parts.extend(array_part(a) for a in pp_slice_arrays)
    return Identity("sweep_chunk", tuple(parts))


#: The random stream of the port's samplers: every draw comes from a CPU
#: ``torch.Generator`` (Mersenne Twister), whatever device the chain runs on.
MCMC_RNG_STREAM = "torch-cpu-mt19937"


def mcmc_segment_identity(
    init_walkers,
    seed: int,
    n_steps: int,
    checkpoint_every: int,
    a: float,
    thin: int,
    identity,
    static=None,
    sampler=None,
    rng: Optional[str] = None,
) -> Identity:
    """The checkpointed chain's run identity: JAX's payload (the init
    walkers' SHA-256, seed, lengths, move and thinning, the posterior's
    ``identity``; with ``static`` the resolved StaticChoices and
    ``schema: 2``; with ``sampler`` the NUTS spec), and with ``rng`` one
    key more naming the random stream.  JAX's threefry draws cannot be
    reproduced in torch, so the port's checkpoints pass
    :data:`MCMC_RNG_STREAM` and neither package resumes the other's chain."""
    payload: Dict[str, Any] = {
        "init": hashlib.sha256(np.ascontiguousarray(init_walkers).tobytes()).hexdigest(),
        "seed": int(seed),
        "n_steps": int(n_steps),
        "checkpoint_every": int(checkpoint_every),
        "a": float(a),
        "thin": int(thin),
        "identity": identity,
    }
    if static is not None:
        payload["schema"] = 2
        payload["static"] = static_payload(static)
    if sampler is not None:
        payload["sampler"] = sampler
    if rng is not None:
        payload["rng"] = str(rng)
    return Identity("mcmc_segment", (("json", payload),))


def bench_leg_identity(leg: str, context: Mapping[str, Any]) -> Identity:
    """One bench leg's result key: the leg name and the measurement
    context (platform, device count, the ``BDLZ_*`` environment and a
    source fingerprint, so that a code change re-measures everything).
    The JAX package's payload, so equal inputs give its digest."""
    return Identity(
        "bench_leg",
        (("json", {"schema": SCHEMA_VERSION, "leg": str(leg),
                   "context": dict(context)}),),
    )


def traffic_snapshot_identity(
    axis_names: Sequence[str],
    locations: Any,
    reasons: Sequence["str | None"],
    occupancy: Mapping[str, Any],
) -> Identity:
    """One served-traffic snapshot's content key (``bdlz_tpu_torch/refine``):
    the axis names, the query-location bytes, the per-query fallback
    reasons and the occupancy summary.  Its digest is the ``traffic`` key a
    traffic-weighted emulator build stamps on its artifact identity."""
    return Identity(
        "traffic_snapshot",
        (
            ("json", {
                "schema": SCHEMA_VERSION,
                "axes": [str(n) for n in axis_names],
                "reasons": [None if r is None else str(r) for r in reasons],
                "occupancy": dict(occupancy),
            }),
            array_part(locations),
        ),
    )


def code_fingerprint(modules: Sequence[Any]) -> str:
    """Hash of the given modules' source text (16 hex chars)."""
    import inspect

    h = hashlib.sha256()
    for mod in modules:
        h.update(inspect.getsource(mod).encode())
    return h.hexdigest()[:16]


def reference_code_fingerprint() -> str:
    """Hash of the source of every port module the reference loop of
    ``validation.reference_ratios`` runs (the JAX package's module list,
    the port's modules): a code change invalidates every cached truth."""
    import bdlz_tpu_torch.constants
    import bdlz_tpu_torch.models.yields_pipeline
    import bdlz_tpu_torch.ops.kjma_table
    import bdlz_tpu_torch.physics.percolation
    import bdlz_tpu_torch.physics.source
    import bdlz_tpu_torch.physics.thermo
    import bdlz_tpu_torch.solvers.panels
    import bdlz_tpu_torch.solvers.quadrature

    return code_fingerprint((
        bdlz_tpu_torch.constants, bdlz_tpu_torch.models.yields_pipeline,
        bdlz_tpu_torch.ops.kjma_table, bdlz_tpu_torch.physics.percolation,
        bdlz_tpu_torch.physics.source, bdlz_tpu_torch.physics.thermo,
        bdlz_tpu_torch.solvers.panels, bdlz_tpu_torch.solvers.quadrature,
    ))


def package_source_fingerprint(*extra_paths: str) -> str:
    """Hash (16 hex chars) of every ``*.py`` under ``bdlz_tpu_torch/``
    and every CUDA source in its ``csrc/``, plus the existing
    ``extra_paths`` files: paths relative to the package root, then the
    bytes, in sorted order.  For identities that must go stale on any code
    change; the kernels are ``.cu`` files here, so they are hashed too."""
    import os

    import bdlz_tpu_torch

    pkg_root = os.path.dirname(os.path.abspath(bdlz_tpu_torch.__file__))
    files = []
    for dirpath, _dirnames, filenames in os.walk(pkg_root):
        files.extend(os.path.join(dirpath, fn) for fn in filenames
                     if fn.endswith(".py")
                     or (fn.endswith(".cu") and os.path.basename(dirpath) == "csrc"))
    files.sort()
    files.extend(p for p in extra_paths if os.path.exists(p))
    h = hashlib.sha256()
    for path in files:
        h.update(os.path.relpath(path, pkg_root).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def refcache_identity(grid, static, n_y: "int | None",
                      fingerprint: Optional[str] = None) -> Identity:
    """The accuracy-gate reference-cache key: population bytes, the
    robustness-stripped static tuple + n_y, and the reference source
    fingerprint (:func:`reference_code_fingerprint` unless given).  The
    parts are the JAX package's, so equal inputs and an equal fingerprint
    give JAX's digest."""
    ident = tuple(static_payload(static))
    parts = [array_part(f) for f in grid]
    parts.append(("text", repr((ident, n_y))))
    parts.append(("text", reference_code_fingerprint() if fingerprint is None
                  else fingerprint))
    return Identity("refcache", tuple(parts))
