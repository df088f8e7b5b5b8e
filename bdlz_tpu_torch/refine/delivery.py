"""The delivery gate: candidate against serving, on held-out traffic.

Counterpart of ``bdlz_tpu/refine/delivery.py``.  Before a rebuilt
surface serves anything, :class:`DeliveryPipeline` scores it and the
serving artifact on the held-out slice of the traffic that triggered the
rebuild.  The per-query miss score is 1 for an out-of-domain query (it
pays the exact fallback) and ``clip(predicted_error / tol, 0, 1)``
inside (it pays the gate with that probability).  Only a candidate whose
mean miss score beats the serving artifact's goes on: registry publish,
stage and warm, cutover under the observation window with auto-rollback
(``serve/rollout.py``).  A losing candidate is dropped unpublished.
The scores are computed on the service's own device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


class DeliveryError(RuntimeError):
    """A delivery step that must not proceed (no gate tolerance, an
    empty scoring set)."""


def traffic_miss_score(artifact, locations: np.ndarray, tol: float, device=None) -> float:
    """Mean per-query miss probability of ``artifact`` over the held-out
    ``locations`` (see the module docstring), on ``device``."""
    from bdlz_tpu_torch.emulator.grid import make_domain_fn, make_error_fn

    locs = np.atleast_2d(np.asarray(locations, dtype=np.float64))
    if locs.shape[0] == 0:
        raise DeliveryError("empty held-out traffic set; nothing to score")
    inside = make_domain_fn(artifact, device=device)(locs).cpu().numpy().astype(bool)
    err = make_error_fn(artifact, device=device)(locs).cpu().numpy().astype(np.float64)
    miss = np.where(~inside, 1.0, np.clip(err / float(tol), 0.0, 1.0))
    return float(miss.mean())


class DeliveryPipeline:
    """Score → publish → stage → cutover under observation, for one
    :class:`~bdlz_tpu_torch.serve.fleet.FleetService`."""

    def __init__(self, service, store, *, observe_s: float = 1.0,
                 rollback_budget: Optional[float] = None,
                 latency_slo_s: Optional[float] = None, tol: Optional[float] = None,
                 event_log=None) -> None:
        from bdlz_tpu_torch.serve.rollout import ArtifactRollout

        self.service = service
        self.store = store
        self.rollout = ArtifactRollout(service, store=store)
        if not float(observe_s) > 0.0:
            raise DeliveryError(f"observe_s must be > 0, got {observe_s!r}")
        self.observe_s = float(observe_s)
        self.rollback_budget = rollback_budget
        self.latency_slo_s = latency_slo_s
        self._tol = tol
        self.event_log = event_log
        #: Every delivery decision, in order.
        self.decisions: list = []

    @property
    def device(self):
        """The service's device: the scores run where the replicas run."""
        return self.service.replica_set.replicas[0].device

    def _resolve_tol(self, candidate) -> float:
        """The tolerance miss scores are normalised by: explicit ``tol`` >
        the service's error gate > the candidate's build tolerance."""
        if self._tol is not None:
            return float(self._tol)
        svc_tol = getattr(self.service, "error_gate_tol", None)
        if (isinstance(svc_tol, (int, float)) and not isinstance(svc_tol, bool)
                and float(svc_tol) > 0.0):
            return float(svc_tol)
        from bdlz_tpu_torch.emulator.grid import domain_artifacts

        rtol = getattr(domain_artifacts(candidate)[0], "manifest", {}).get("rtol_target")
        if rtol:
            return float(rtol)
        raise DeliveryError(
            "no gate tolerance anywhere (pipeline tol, service error_gate_tol, "
            "candidate manifest rtol_target) — miss scores would be "
            "unnormalizable")

    def deliver(self, candidate, holdout_locations: np.ndarray) -> Dict[str, Any]:
        """Run the gate for one candidate; returns the decision row (also
        appended to :attr:`decisions`): ``outcome`` ``"promoted"``
        (published and cut over, observation armed) or ``"rejected"``."""
        tol = self._resolve_tol(candidate)
        score_new = traffic_miss_score(candidate, holdout_locations, tol, self.device)
        score_old = traffic_miss_score(self.service.artifact, holdout_locations, tol,
                                       self.device)
        row: Dict[str, Any] = {
            "candidate_score": round(score_new, 6),
            "serving_score": round(score_old, 6),
            "tol": tol,
            "n_holdout": int(np.atleast_2d(holdout_locations).shape[0]),
            "serving_hash": self.service.artifact_hash,
        }
        if score_new >= score_old:
            row["outcome"] = "rejected"
            self.decisions.append(row)
            if self.event_log is not None:
                self.event_log.emit("delivery_decision", **row)
            return row
        from bdlz_tpu_torch.provenance import publish_artifact

        content_hash = publish_artifact(self.store, candidate)
        # stage by bare hash: the replicas serve exactly what the registry
        # re-verified, the admission path of any other host
        self.rollout.stage(content_hash, warm=True)
        old_hash, new_hash = self.rollout.cutover(
            observe_s=self.observe_s, budget=self.rollback_budget,
            latency_slo_s=self.latency_slo_s)
        row.update(outcome="promoted", published_hash=content_hash, old_hash=old_hash,
                   new_hash=new_hash, observe_s=self.observe_s)
        self.decisions.append(row)
        if self.event_log is not None:
            self.event_log.emit("delivery_decision", **row)
        return row
