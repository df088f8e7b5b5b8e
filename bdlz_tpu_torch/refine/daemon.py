"""The refinement daemon: drift watch → traffic-weighted rebuild → delivery.

Counterpart of ``bdlz_tpu/refine/daemon.py``.  :class:`RefinementDaemon`
closes the loop on one :class:`~bdlz_tpu_torch.serve.fleet.FleetService`:
it arms the service's per-query traffic trace, folds it into a
:class:`~bdlz_tpu_torch.refine.traffic.TrafficModel` on every
:meth:`~RefinementDaemon.step`, and when the window drifts (the gated or
out-of-domain rate over ``drift_gated_rate``) runs one cycle:

1. freeze and persist the traffic snapshot (content-hashed, atomic);
2. rebuild the emulator over a box widened to cover the observed traffic,
   steered by ``refine_signal="traffic"`` (the snapshot's train split),
   on the service's device (through P1 for an ``impl="kernel"``
   artifact), optionally as elastic chunks (``parallel/scheduler.py``);
3. hand the candidate to the
   :class:`~bdlz_tpu_torch.refine.delivery.DeliveryPipeline` (held-out
   scoring → publish → stage → cutover under observation).

Everything runs on the service's injectable clock.  The daemon is driven
by explicit ``step()`` calls (the serve CLI ticks it between batches); it
does not hook ``FleetService._observer``, which the rollout's observation
window owns.  ``rebuild_budget`` bounds the cycles per daemon lifetime.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from bdlz_tpu_torch.refine.delivery import DeliveryPipeline
from bdlz_tpu_torch.refine.traffic import (
    TrafficModel,
    TrafficSnapshot,
    save_snapshot,
)


class RefineError(RuntimeError):
    """Daemon misuse: self-improvement forced off, no store, or a
    rebuild attempted past the budget."""


def resolve_self_improve(base, explicit: bool = False) -> bool:
    """Resolve the tri-state ``self_improve`` knob (``Config``).

    ``None`` means the engine decides: constructing a
    :class:`RefinementDaemon` directly IS the decision (``explicit=True``
    → on), while ambient attachment points (the serve CLI) stay off.
    ``True``/``False`` force.  A forced-off config makes daemon
    construction raise — the operator said never.
    """
    v = getattr(base, "self_improve", None)
    if v is None:
        return bool(explicit)
    return bool(v)


class RefinementDaemon:
    """Closed-loop controller for one serving fleet (module docstring).

    ``build_kw`` passes through to
    :func:`~bdlz_tpu_torch.emulator.build.build_emulator` for the rebuild
    (probe counts, rounds, ``n_y`` — defaults are adopted from the
    serving artifact's identity/manifest so the candidate answers the
    same physics at the same advertised tolerance).  ``elastic``
    (worker count / kwarg dict) routes the rebuild's product sweeps
    through the elastic work-stealing fleet.
    """

    def __init__(
        self,
        service,
        base,
        *,
        store,
        clock=None,
        window: int = 512,
        min_queries: int = 32,
        drift_gated_rate: Optional[float] = None,
        rebuild_budget: Optional[int] = None,
        holdout_frac: float = 0.25,
        box_margin: float = 0.02,
        elastic=None,
        build_kw: Optional[Dict[str, Any]] = None,
        observe_s: float = 1.0,
        rollback_budget: Optional[float] = None,
        latency_slo_s: Optional[float] = None,
        event_log=None,
    ) -> None:
        if not resolve_self_improve(base, explicit=True):
            raise RefineError(
                "self_improve=False forces the closed loop off; "
                "drop the daemon or set the knob to None/True"
            )
        if store is None:
            raise RefineError(
                "the daemon persists snapshots and publishes candidates "
                "through the provenance store; pass store="
            )
        self.service = service
        self.base = base
        self.store = store
        self._clock = (
            clock if clock is not None
            else getattr(service, "_clock", time.monotonic)
        )
        self.drift_gated_rate = float(
            drift_gated_rate if drift_gated_rate is not None
            else getattr(base, "drift_gated_rate", 0.05)
        )
        self.rebuild_budget = int(
            rebuild_budget if rebuild_budget is not None
            else getattr(base, "rebuild_budget", 1)
        )
        if self.rebuild_budget < 1:
            raise RefineError(
                f"rebuild_budget must be >= 1, got {self.rebuild_budget}"
            )
        self.min_queries = int(min_queries)
        self.holdout_frac = float(holdout_frac)
        self.box_margin = float(box_margin)
        self.elastic = elastic
        self.build_kw = dict(build_kw or {})
        self.event_log = event_log
        self.model = TrafficModel(service.artifact.axis_names, window=window)
        self.pipeline = DeliveryPipeline(
            service, store,
            observe_s=observe_s, rollback_budget=rollback_budget,
            latency_slo_s=latency_slo_s, event_log=event_log,
        )
        #: "idle" | "rebuilding" | "delivering" | "exhausted"
        self.state = "idle"
        self.cycles = 0
        #: One row per completed autonomous cycle (snapshot fingerprint,
        #: drift rates, delivery decision).
        self.history: List[Dict[str, Any]] = []
        # the whole loop starts here: per-query recording is opt-in and
        # off until a daemon exists
        service.stats.arm_traffic_log()

    # ---- drift test -------------------------------------------------

    def drifted(self) -> bool:
        """True when the current window says the serving surface no
        longer fits the traffic: gated-fallback rate OR out-of-domain
        mass over ``drift_gated_rate``, with at least ``min_queries``
        observed (a 3-query window proves nothing)."""
        if self.model.n_queries < self.min_queries:
            return False
        return (
            self.model.gated_rate > self.drift_gated_rate
            or self.model.ood_rate > self.drift_gated_rate
        )

    # ---- the loop ---------------------------------------------------

    def step(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One daemon tick: fold fresh traffic, and when drift is
        detected (and budget remains) run one full rebuild + delivery
        cycle synchronously.  Returns the tick's status row."""
        now = float(self._clock() if now is None else now)
        folded = self.model.fold(self.service.stats)
        status: Dict[str, Any] = {
            "now": now,
            "state": self.state,
            "folded": folded,
            "window": self.model.n_queries,
            "gated_rate": round(self.model.gated_rate, 4),
            "ood_rate": round(self.model.ood_rate, 4),
            "cycles": self.cycles,
        }
        if not self.drifted():
            return status
        if self.cycles >= self.rebuild_budget:
            self.state = "exhausted"
            status.update(state=self.state, drifted=True)
            if self.event_log is not None:
                self.event_log.emit("refine_budget_exhausted", **status)
            return status
        status.update(drifted=True, **self._run_cycle(now))
        status["state"] = self.state
        status["cycles"] = self.cycles
        return status

    def _run_cycle(self, now: float) -> Dict[str, Any]:
        snap = self.model.snapshot()
        fp = save_snapshot(self.store, snap)
        if self.event_log is not None:
            self.event_log.emit(
                "refine_drift_detected", fingerprint=fp,
                n_queries=snap.n_queries,
                gated_rate=round(snap.gated_rate, 4),
                ood_rate=round(snap.ood_rate, 4),
            )
        train, held = snap.split_holdout(self.holdout_frac)
        # the TRAIN split is what actually steers the rebuild, so its
        # fingerprint is the one that joins the candidate identity —
        # persist it too, or the identity would name an unresolvable hash
        train_fp = save_snapshot(self.store, train)
        self.state = "rebuilding"
        candidate, report = self._rebuild(train)
        self.state = "delivering"
        decision = self.pipeline.deliver(candidate, held)
        self.cycles += 1
        self.state = "idle"
        # fresh window: drift on the (possibly new) surface must be
        # measured from traffic that surface actually served
        self.model.reset_window()
        row = {
            "snapshot": fp,
            "train_snapshot": train_fp,
            "n_queries": snap.n_queries,
            "snapshot_gated_rate": round(snap.gated_rate, 4),
            "snapshot_ood_rate": round(snap.ood_rate, 4),
            "build_converged": bool(report.converged),
            "decision": decision,
        }
        self.history.append(row)
        return row

    # ---- rebuild ----------------------------------------------------

    def _expanded_spec(self, snap: TrafficSnapshot, artifact=None):
        """The rebuild box: the serving artifact's box, widened (in
        each axis's scale coordinate, by ``box_margin`` relative pad)
        to cover every observed query — the OOD mass that triggered the
        drift is exactly what the new surface must absorb.  ``artifact``
        overrides the serving artifact (tests replay a cycle's spec
        against the surface that was serving when the cycle ran)."""
        from bdlz_tpu_torch.emulator.build import AxisSpec
        from bdlz_tpu_torch.emulator.grid import domain_artifacts

        artifact = artifact if artifact is not None else self.service.artifact
        doms = domain_artifacts(artifact)
        spec: Dict[str, AxisSpec] = {}
        for k, name in enumerate(artifact.axis_names):
            los = [float(d.axis_nodes[k][0]) for d in doms]
            his = [float(d.axis_nodes[k][-1]) for d in doms]
            scale = doms[0].axis_scales[k]
            lo, hi = min(los), max(his)
            t_lo = float(snap.locations[:, k].min())
            t_hi = float(snap.locations[:, k].max())
            if t_lo < lo or t_hi > hi:
                if scale == "log":
                    u_lo = np.log10(min(lo, t_lo))
                    u_hi = np.log10(max(hi, t_hi))
                    pad = self.box_margin * (u_hi - u_lo)
                    lo = float(10.0 ** (u_lo - pad))
                    hi = float(10.0 ** (u_hi + pad))
                else:
                    u_lo, u_hi = min(lo, t_lo), max(hi, t_hi)
                    pad = self.box_margin * (u_hi - u_lo)
                    lo, hi = float(u_lo - pad), float(u_hi + pad)
            n0 = max(3, len(doms[0].axis_nodes[k]))
            spec[name] = AxisSpec(lo, hi, n0, scale)
        return spec

    def _rebuild(self, train: TrafficSnapshot):
        from bdlz_tpu_torch.emulator.build import build_emulator

        ident = dict(self.service.artifact.identity)
        manifest = getattr(self.service.artifact, "manifest", {}) or {}
        kw: Dict[str, Any] = {
            "rtol": float(manifest.get("rtol_target", 1e-4)),
            # the rebuild runs where the service runs, never on the host
            # behind the card's back
            "device": self.pipeline.device,
        }
        if "n_y" in ident:
            kw["n_y"] = int(ident["n_y"])
        if "impl" in ident:
            kw["impl"] = str(ident["impl"])
        kw.update(self.build_kw)
        rs = getattr(self.base, "refine_signal", None)
        if rs not in ("traffic", "traffic*planck"):
            rs = "traffic"
        if self.event_log is not None:
            self.event_log.emit(
                "refine_rebuild_start", refine_signal=rs,
                n_train=train.n_queries, elastic=bool(self.elastic),
            )
        return build_emulator(
            self.base, self._expanded_spec(train),
            refine_signal=rs, traffic=train,
            cache=self.store, elastic=self.elastic,
            event_log=self.event_log,
            **kw,
        )
