"""Closed-loop continuous delivery (counterpart of ``bdlz_tpu/refine``).

The serving plane records where traffic lands (``ServeStats.traffic_log``);
this package folds that trace into a content-hashed
:class:`TrafficSnapshot`, watches it for drift (:class:`RefinementDaemon`),
rebuilds the emulator weighted by the observed density
(``refine_signal="traffic"``, ``emulator/build.py``) and, when the
candidate beats the serving surface on held-out traffic, publishes and
cuts it over under observation with automatic rollback
(:class:`DeliveryPipeline`).
"""
from bdlz_tpu_torch.refine.daemon import (
    RefineError,
    RefinementDaemon,
    resolve_self_improve,
)
from bdlz_tpu_torch.refine.delivery import DeliveryError, DeliveryPipeline, traffic_miss_score
from bdlz_tpu_torch.refine.traffic import (
    TRAFFIC_SCHEMA_VERSION,
    TrafficModel,
    TrafficSnapshot,
    TrafficSnapshotError,
    load_snapshot,
    save_snapshot,
    snapshot_entry_name,
)

__all__ = [
    "TRAFFIC_SCHEMA_VERSION",
    "DeliveryError",
    "DeliveryPipeline",
    "RefineError",
    "RefinementDaemon",
    "TrafficModel",
    "TrafficSnapshot",
    "TrafficSnapshotError",
    "load_snapshot",
    "resolve_self_improve",
    "save_snapshot",
    "snapshot_entry_name",
    "traffic_miss_score",
]
