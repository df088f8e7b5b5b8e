"""Traffic snapshots: the closed loop's observed-distribution record.

Counterpart of ``bdlz_tpu/refine/traffic.py``, with the same payload and
fingerprint, so a snapshot saved by either package loads in the other.

A :class:`TrafficModel` folds a service's per-query trace
(``ServeStats.traffic_log`` — armed by the refinement daemon, zero
overhead otherwise) into an append-only window; :meth:`TrafficModel.snapshot`
freezes the window into a :class:`TrafficSnapshot` whose content
fingerprint (``provenance.traffic_snapshot_identity``) names exactly
what the rebuild was steered by — the fingerprint joins the candidate
artifact's identity as its ``traffic`` key, so "which traffic produced
this surface" is answerable from the hash alone.

Snapshots persist through the provenance :class:`~bdlz_tpu_torch.provenance.Store`
(``put_json`` → ``utils.io.atomic_write_json``, durable): a reader
never sees a torn snapshot, and :func:`load_snapshot` rejects schema
version skew, fingerprint mismatches, and non-finite locations loudly
— the artifact-manifest rules, applied to the traffic plane.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

#: Bump on ANY change to the persisted snapshot payload shape.  A
#: version-skewed snapshot is rejected loudly at load — silently
#: re-steering a rebuild from a half-understood payload is exactly the
#: failure the artifact manifest rules exist to prevent.
TRAFFIC_SCHEMA_VERSION = 1

#: Store entry prefix.
SNAPSHOT_KIND = "traffic_snapshot"


class TrafficSnapshotError(RuntimeError):
    """A snapshot that must not be used: NaN locations, schema version
    skew, fingerprint mismatch, or shape disagreement."""


def snapshot_entry_name(fingerprint: str) -> str:
    return f"{SNAPSHOT_KIND}/{fingerprint}.json"


@dataclass(frozen=True)
class TrafficSnapshot:
    """One frozen window of served traffic: query locations in the
    emulator's axis order, the per-query fallback reason (None =
    emulator fast path), and the per-pool batch occupancy observed
    while the window accumulated."""

    axis_names: Tuple[str, ...]
    locations: np.ndarray                     # (N, d) float64
    reasons: Tuple[Optional[str], ...]        # len N
    occupancy: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self) -> None:
        locs = np.atleast_2d(np.asarray(self.locations, dtype=np.float64))
        if locs.ndim != 2 or locs.shape[1] != len(self.axis_names):
            raise TrafficSnapshotError(
                f"locations shape {locs.shape} does not match "
                f"{len(self.axis_names)} axes {tuple(self.axis_names)}"
            )
        if not np.all(np.isfinite(locs)):
            # a NaN location would silently vanish from the histogram
            # the rebuild steers on — reject at the source, loudly
            bad = int((~np.isfinite(locs)).any(axis=1).sum())
            raise TrafficSnapshotError(
                f"{bad}/{locs.shape[0]} query locations are non-finite; "
                "refusing to build a snapshot that would silently "
                "mis-weight the rebuild"
            )
        if len(self.reasons) != locs.shape[0]:
            raise TrafficSnapshotError(
                f"{len(self.reasons)} reasons for {locs.shape[0]} "
                "query locations"
            )
        object.__setattr__(self, "locations", locs)

    # ---- derived rates (the daemon's drift inputs) ------------------

    @property
    def n_queries(self) -> int:
        return int(self.locations.shape[0])

    def _rate(self, *names: str) -> float:
        if not self.reasons:
            return 0.0
        return sum(r in names for r in self.reasons) / len(self.reasons)

    @property
    def ood_rate(self) -> float:
        return self._rate("ood")

    @property
    def gated_rate(self) -> float:
        return self._rate("predicted_error")

    @property
    def fallback_rate(self) -> float:
        return sum(r is not None for r in self.reasons) / max(
            len(self.reasons), 1
        )

    # ---- identity ---------------------------------------------------

    @property
    def fingerprint(self) -> str:
        """Content hash (16 hex) of exactly what steers a rebuild."""
        from bdlz_tpu_torch.provenance import traffic_snapshot_identity

        return traffic_snapshot_identity(
            self.axis_names, self.locations, self.reasons, self.occupancy
        ).digest(16)

    # ---- held-out split (the delivery gate's scoring set) -----------

    def split_holdout(
        self, frac: float = 0.25
    ) -> Tuple["TrafficSnapshot", np.ndarray]:
        """Deterministically hold out ~``frac`` of the queries: every
        k-th row (k = round(1/frac)) becomes the held-out scoring set
        the DELIVERY gate judges candidates on, the rest steer the
        rebuild — the build must never be graded on points it was
        weighted toward.  Returns ``(train_snapshot, held_locations)``;
        with fewer than ``2/frac`` queries the full snapshot trains and
        the full location set scores (too little traffic to split)."""
        if not (0.0 < float(frac) < 1.0):
            raise TrafficSnapshotError(
                f"holdout frac must be in (0, 1), got {frac!r}"
            )
        k = max(int(round(1.0 / float(frac))), 2)
        if self.n_queries < 2 * k:
            return self, np.array(self.locations, copy=True)
        held = np.arange(self.n_queries) % k == 0
        train = TrafficSnapshot(
            axis_names=self.axis_names,
            locations=self.locations[~held],
            reasons=tuple(
                r for r, h in zip(self.reasons, held) if not h
            ),
            occupancy=dict(self.occupancy),
        )
        return train, np.array(self.locations[held], copy=True)


class TrafficModel:
    """Folds a service's ``ServeStats`` into a rolling traffic window.

    Incremental by cursor: each :meth:`fold` consumes only the
    ``traffic_log`` entries (and occupancy rows) appended since the
    last call, so the daemon can fold on every tick without rescanning
    history.  ``window`` bounds the retained queries (oldest dropped) —
    drift detection must see the CURRENT distribution, not the
    all-time mixture that a growing unbounded window converges to.
    """

    def __init__(
        self,
        axis_names,
        *,
        window: Optional[int] = 512,
    ) -> None:
        self.axis_names = tuple(str(n) for n in axis_names)
        if window is not None and int(window) < 1:
            raise TrafficSnapshotError(
                f"window must be a positive query count, got {window!r}"
            )
        self.window = None if window is None else int(window)
        self._queries: List[Tuple[Tuple[float, ...], Optional[str]]] = []
        self._log_cursor: Dict[int, int] = {}
        self._row_cursor: Dict[int, int] = {}
        self._occ_sum: Dict[str, float] = {}
        self._occ_n: Dict[str, int] = {}

    def fold(self, stats, pool: str = "default") -> int:
        """Consume the NEW entries of ``stats`` (a ``ServeStats``);
        returns how many queries were folded.  ``pool`` labels the
        occupancy stream (one key per served pool under tenancy)."""
        key = id(stats)
        folded = 0
        log = stats.traffic_log
        if log is not None:
            start = self._log_cursor.get(key, 0)
            fresh = log[start:]
            self._log_cursor[key] = len(log)
            for theta, reason in fresh:
                self._queries.append((
                    tuple(float(v) for v in theta),
                    None if reason is None else str(reason),
                ))
                folded += 1
        row_start = self._row_cursor.get(key, 0)
        for row in stats.rows[row_start:]:
            self._occ_sum[pool] = (
                self._occ_sum.get(pool, 0.0) + float(row.occupancy)
            )
            self._occ_n[pool] = self._occ_n.get(pool, 0) + 1
        self._row_cursor[key] = len(stats.rows)
        if self.window is not None and len(self._queries) > self.window:
            del self._queries[: len(self._queries) - self.window]
        return folded

    # ---- window introspection (the daemon's drift test) -------------

    @property
    def n_queries(self) -> int:
        return len(self._queries)

    def _rate(self, *names: str) -> float:
        if not self._queries:
            return 0.0
        return sum(
            r in names for _, r in self._queries
        ) / len(self._queries)

    @property
    def ood_rate(self) -> float:
        return self._rate("ood")

    @property
    def gated_rate(self) -> float:
        return self._rate("predicted_error")

    def reset_window(self) -> None:
        """Drop the accumulated queries (cursors stay — already-consumed
        log entries are never re-folded).  The daemon calls this after
        every delivery cycle: drift on the NEW surface must be measured
        from fresh traffic, not from the window that triggered the last
        rebuild."""
        self._queries = []

    def occupancy(self) -> Dict[str, float]:
        return {
            pool: round(self._occ_sum[pool] / self._occ_n[pool], 4)
            for pool in sorted(self._occ_sum)
            if self._occ_n.get(pool)
        }

    def snapshot(self) -> TrafficSnapshot:
        """Freeze the current window (raises on an empty one — there is
        nothing to steer a rebuild by)."""
        if not self._queries:
            raise TrafficSnapshotError(
                "no served queries folded yet; nothing to snapshot"
            )
        return TrafficSnapshot(
            axis_names=self.axis_names,
            locations=np.asarray(
                [q for q, _ in self._queries], dtype=np.float64
            ),
            reasons=tuple(r for _, r in self._queries),
            occupancy=self.occupancy(),
        )


# ---- persistence (provenance store; atomic + schema-pinned) ---------


def save_snapshot(store, snap: TrafficSnapshot) -> str:
    """Persist ``snap`` into the provenance store under its own
    fingerprint (``Store.put_json`` → ``atomic_write_json(durable=True)``:
    a reader concurrent with the write sees the old entry or the new
    one, never a torn file).  Returns the fingerprint."""
    fp = snap.fingerprint
    store.put_json(snapshot_entry_name(fp), {
        "schema": TRAFFIC_SCHEMA_VERSION,
        "fingerprint": fp,
        "axis_names": list(snap.axis_names),
        "locations": [[float(v) for v in row] for row in snap.locations],
        "reasons": list(snap.reasons),
        "occupancy": dict(snap.occupancy),
    })
    return fp


def load_snapshot(store, fingerprint: str) -> TrafficSnapshot:
    """Load + fully re-verify a persisted snapshot: absent entries,
    schema version skew, and content drift (recomputed fingerprint ≠
    entry name) all raise :class:`TrafficSnapshotError` — a rebuild
    steered by a snapshot that is not exactly what its name claims
    would poison the artifact identity chain downstream."""
    payload: Optional[Dict[str, Any]] = store.get_json(
        snapshot_entry_name(fingerprint)
    )
    if payload is None:
        raise TrafficSnapshotError(
            f"traffic snapshot {fingerprint} is not in the store"
        )
    schema = payload.get("schema")
    if schema != TRAFFIC_SCHEMA_VERSION:
        raise TrafficSnapshotError(
            f"traffic snapshot {fingerprint} has schema version "
            f"{schema!r}; this build reads version "
            f"{TRAFFIC_SCHEMA_VERSION} — refusing to guess at a "
            "version-skewed payload"
        )
    snap = TrafficSnapshot(
        axis_names=tuple(payload["axis_names"]),
        locations=np.asarray(payload["locations"], dtype=np.float64),
        reasons=tuple(payload["reasons"]),
        occupancy=dict(payload.get("occupancy", {})),
    )
    if snap.fingerprint != fingerprint:
        raise TrafficSnapshotError(
            f"traffic snapshot content hashes to {snap.fingerprint}, "
            f"not the requested {fingerprint} — the entry was renamed "
            "or tampered with"
        )
    return snap
