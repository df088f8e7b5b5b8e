"""Counters of the lane-repacking stiff engine.

Counterpart of ``CompactionStats`` in ``bdlz_tpu/utils/profiling.py``;
the JAX package's profiler traces and throughput helpers are not ported
(the port reads the card with ``torch.profiler`` directly).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass(frozen=True)
class EsdirkRound:
    """One round of the lane-repacking batched ESDIRK engine
    (``solvers/batching.py``): which lanes ran, what they did, how long
    the round took on the wall."""

    round_index: int
    batch_lanes: int       # lanes dispatched (no padding in the port)
    active_lanes: int      # live (unconverged, in-budget) lanes this round
    lanes_retired: int     # lanes that finished (or exhausted) this round
    steps_accepted: int    # accepted steps across live lanes this round
    steps_rejected: int    # rejected attempts across live lanes this round
    seconds: float


@dataclass
class CompactionStats:
    """Per-round record of a repacked batched stiff solve; ``summary``
    collapses it into totals.  ``lane_steps`` holds every lane's attempted
    steps at the end of the solve, in input lane order (a port addition:
    the rounds alone do not give the per-lane distribution)."""

    rounds: List[EsdirkRound] = field(default_factory=list)
    lane_steps: Optional[np.ndarray] = None

    def record_round(self, **kw: Any) -> None:
        self.rounds.append(EsdirkRound(**kw))

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    def summary(self) -> Dict[str, Any]:
        dispatched = sum(r.batch_lanes for r in self.rounds)
        active = sum(r.active_lanes for r in self.rounds)
        return {
            "rounds": self.n_rounds,
            "lanes_retired": sum(r.lanes_retired for r in self.rounds),
            "steps_accepted": sum(r.steps_accepted for r in self.rounds),
            "steps_rejected": sum(r.steps_rejected for r in self.rounds),
            "seconds": round(sum(r.seconds for r in self.rounds), 4),
            "pad_waste": round(1.0 - active / dispatched, 4) if dispatched else 0.0,
        }

    def as_rows(self) -> List[Dict[str, Any]]:
        """The per-round records as plain dicts (event logs, JSON)."""
        return [dataclasses.asdict(r) for r in self.rounds]
