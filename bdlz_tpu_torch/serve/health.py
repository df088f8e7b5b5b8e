"""Replica health plane: sliding-window scores + per-replica circuit
breakers for the serving fleet.

Counterpart of ``bdlz_tpu/serve/health.py``, with the same policy,
transitions, causes and summary keys.

At fleet scale one sick replica must cost the batches it actually
poisons, never the service: a replica that raises at dispatch, emits
NaNs (its tables are finite/positive by construction, so a non-finite
interpolant is a sick kernel, not physics), or blows the latency SLO is
scored here, and its breaker walks the classic state machine:

* **closed** — routable.  Every batch outcome lands in a sliding window
  of the last ``window`` outcomes; when bad outcomes reach
  ``threshold * window`` the breaker OPENS.
* **open** — removed from routing (``FleetService`` excludes it from
  both ``round_robin`` and ``least_loaded``).  After ``cooldown_s``
  seconds on the service's *injectable* clock the breaker becomes
  probe-eligible.
* **half-open** — exactly ONE probe batch is routed to the replica
  (scheduled through the batcher clock, so tier-1 drives the whole
  cycle with a fake clock and zero sleeps).  A successful probe CLOSES
  the breaker (window reset, recovery time recorded); a failed probe
  re-opens it and restarts the cooldown.

The plane is pure host-side bookkeeping on the injectable clock — no
sleeps, no device work — and entirely absent when disabled
(``health_enabled=false``): every fleet hook guards on
``self.health is not None``, and the ``ServeStats`` schema is
byte-identical to the pre-health service (pinned in
``tests/test_health.py``).  Semantics reference: docs/robustness.md
"Replica health plane".
"""
from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, List, NamedTuple, Optional, Tuple

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"

#: Bad-outcome causes (health events, docs/robustness.md taxonomy).
CAUSE_DISPATCH_ERROR = "dispatch_error"
CAUSE_GATHER_ERROR = "gather_error"
CAUSE_NAN = "nan"
CAUSE_SLOW = "slow"


class BreakerPolicy(NamedTuple):
    """The resolved breaker knobs one fleet runs with (config twins:
    ``breaker_window`` / ``breaker_threshold`` / ``breaker_cooldown_s``
    / ``breaker_latency_slo_s`` — all in ``SERVE_CONFIG_FIELDS``, so
    tuning a breaker stales no identity)."""

    window: int = 8
    threshold: float = 0.5
    cooldown_s: float = 1.0
    latency_slo_s: Optional[float] = None
    #: Consecutive opens (a failed half-open probe re-opens) before the
    #: replica is re-provisioned from the provenance registry — a
    #: persistent sickness gets fresh tables + a fresh kernel, not an
    #: endless probe loop.
    reprovision_after: int = 2


def resolve_health_policy(explicit, base) -> Optional[BreakerPolicy]:
    """The tri-state ``health_enabled`` resolution (ode_* pattern):
    explicit argument > ``Config.health_enabled``.  ``None`` = engine
    decides — the fleet front turns the plane ON (the production
    default), fronts without replicas have nothing to break; ``False``
    = the pre-health behavior, byte-identical and zero-overhead
    (pinned); ``True`` = force on.  Returns the policy, or None for
    "plane off"."""
    gate = explicit
    if gate is None:
        gate = getattr(base, "health_enabled", None)
    if gate is False:
        return None
    slo = getattr(base, "breaker_latency_slo_s", None)
    return BreakerPolicy(
        window=int(getattr(base, "breaker_window", 8)),
        threshold=float(getattr(base, "breaker_threshold", 0.5)),
        cooldown_s=float(getattr(base, "breaker_cooldown_s", 1.0)),
        latency_slo_s=None if slo is None else float(slo),
    )


class ReplicaBreaker:
    """One replica's circuit breaker + sliding outcome window."""

    def __init__(self, index: int, policy: BreakerPolicy):
        self.index = int(index)
        self.policy = policy
        self.state = STATE_CLOSED
        #: Last ``window`` outcomes, 1.0 = bad (the health score's
        #: numerator; the denominator is the window LENGTH, so a single
        #: hiccup in a long window does not trip a wide breaker).
        self.window: Deque[float] = deque(maxlen=policy.window)
        self.opened_at: Optional[float] = None
        #: First open of the current sickness (recovery-time anchor).
        self.first_opened_at: Optional[float] = None
        #: Consecutive opens without an intervening close.
        self.open_count = 0
        #: True while the single half-open probe batch is outstanding.
        self.probe_inflight = False
        #: True once this sickness has been re-provisioned (reset on
        #: close — a NEW sickness may re-provision again).
        self.reprovisioned = False

    def score(self) -> float:
        """Bad fraction over the FULL window length (not just the
        samples seen): a breaker needs ``threshold * window`` actual
        failures inside the window to trip."""
        return sum(self.window) / float(self.policy.window)

    def probe_due(self, now: float) -> bool:
        return (
            self.state == STATE_OPEN
            and not self.probe_inflight
            and self.opened_at is not None
            and (now - self.opened_at) >= self.policy.cooldown_s
        )


class HealthPlane:
    """Per-replica breakers + healing counters for one FleetService.

    All decisions are pure functions of (recorded outcomes, now) on the
    service's injectable clock.  A JSON summary is published into
    ``stats.extras["health"]`` on every change, so the existing
    ``ServeStats.summary()`` consumers (serve CLI events, bench lines)
    see the plane without any schema change when it is disabled.
    """

    def __init__(self, n_replicas: int, policy: BreakerPolicy, stats=None):
        self.policy = policy
        self.breakers: List[ReplicaBreaker] = [
            ReplicaBreaker(i, policy) for i in range(int(n_replicas))
        ]
        #: State transitions, in order: {"t", "replica", "to", "cause"}.
        self.events: List[Dict[str, Any]] = []
        self.opens = 0
        self.closes = 0
        self.healed_batches = 0
        self.degraded_batches = 0
        self.reprovisions = 0
        self.reprovision_failures = 0
        #: Open→re-close spans in clock seconds (the chaos bench's
        #: recovery-time metric).
        self.recoveries_s: List[float] = []
        self._stats = stats
        self._publish()

    # ---- routing ----------------------------------------------------

    def routable(self, now: float) -> Tuple[List[int], Optional[int]]:
        """(closed replica indices, half-open probe target or None).

        At most one probe target is returned (lowest open index whose
        cooldown elapsed, no probe already outstanding) — the caller
        routes exactly ONE batch there as the probe.
        """
        allowed = [b.index for b in self.breakers if b.state == STATE_CLOSED]
        probe = None
        for b in self.breakers:
            if b.probe_due(now):
                probe = b.index
                break
        return allowed, probe

    def all_open(self) -> bool:
        return not any(b.state == STATE_CLOSED for b in self.breakers)

    def probe_started(self, index: int, now: float) -> None:
        b = self.breakers[index]
        b.state = STATE_HALF_OPEN
        b.probe_inflight = True
        self._event(now, index, STATE_HALF_OPEN, "probe")

    # ---- outcomes ---------------------------------------------------

    def record_outcome(
        self,
        index: int,
        ok: bool,
        now: float,
        seconds: Optional[float] = None,
        cause: Optional[str] = None,
        probe: bool = False,
    ) -> None:
        """Score one batch outcome for replica ``index``.

        ``seconds`` (batch evaluation time) is checked against the
        latency SLO when one is configured; a breach downgrades an OK
        outcome to bad with cause ``"slow"``.  ``probe=True`` marks THE
        half-open probe batch's outcome — only it resolves the
        half-open state (success closes, failure re-opens).  A batch
        that was dispatched earlier (while the breaker was still
        closed) and resolves during the probe window must NOT decide
        the probe: its outcome only lands in the window.
        """
        b = self.breakers[index]
        slo = self.policy.latency_slo_s
        if ok and slo is not None and seconds is not None and seconds > slo:
            ok, cause = False, CAUSE_SLOW
        if probe and b.state == STATE_HALF_OPEN:
            b.probe_inflight = False
            if ok:
                self._close(b, now)
            else:
                self._open(b, now, cause)
            return
        b.window.append(0.0 if ok else 1.0)
        if not ok and b.state == STATE_CLOSED and (
            b.score() >= self.policy.threshold
        ):
            self._open(b, now, cause)
        elif not ok:
            self._publish()

    def needs_reprovision(self, index: int) -> bool:
        """True when this replica's sickness has survived enough probe
        cycles that fresh tables + a fresh kernel are warranted (once
        per sickness; the caller owns the registry fetch)."""
        b = self.breakers[index]
        return (
            b.state == STATE_OPEN
            and not b.reprovisioned
            and b.open_count >= self.policy.reprovision_after
        )

    def note_reprovision(self, index: int, ok: bool, now: float) -> None:
        b = self.breakers[index]
        b.reprovisioned = True
        if ok:
            self.reprovisions += 1
            self._event(now, index, STATE_OPEN, "reprovisioned")
        else:
            self.reprovision_failures += 1
            self._event(now, index, STATE_OPEN, "reprovision_failed")

    def note_healed_batch(self) -> None:
        self.healed_batches += 1
        self._publish()

    def note_degraded_batch(self) -> None:
        self.degraded_batches += 1
        self._publish()

    # ---- transitions ------------------------------------------------

    def _open(self, b: ReplicaBreaker, now: float, cause) -> None:
        if b.first_opened_at is None:
            b.first_opened_at = now
        b.state = STATE_OPEN
        b.opened_at = now
        b.open_count += 1
        b.probe_inflight = False
        self.opens += 1
        self._event(now, b.index, STATE_OPEN, cause)

    def _close(self, b: ReplicaBreaker, now: float) -> None:
        b.state = STATE_CLOSED
        if b.first_opened_at is not None:
            self.recoveries_s.append(float(now - b.first_opened_at))
        b.first_opened_at = None
        b.opened_at = None
        b.open_count = 0
        b.reprovisioned = False
        b.window.clear()
        self.closes += 1
        self._event(now, b.index, STATE_CLOSED, "probe_ok")

    def _event(self, now: float, index: int, to: str, cause) -> None:
        self.events.append({
            "t": float(now), "replica": int(index), "to": to,
            "cause": cause,
        })
        self._publish()

    # ---- observability ----------------------------------------------

    def summary(self) -> Dict[str, Any]:
        return {
            "states": [b.state for b in self.breakers],
            "opens": self.opens,
            "closes": self.closes,
            "healed_batches": self.healed_batches,
            "degraded_batches": self.degraded_batches,
            "reprovisions": self.reprovisions,
            "reprovision_failures": self.reprovision_failures,
            "recoveries": len(self.recoveries_s),
            "last_recovery_s": (
                round(self.recoveries_s[-1], 6) if self.recoveries_s
                else None
            ),
            "transitions": len(self.events),
        }

    def _publish(self) -> None:
        if self._stats is not None:
            self._stats.extras["health"] = self.summary()


__all__ = [
    "BreakerPolicy",
    "HealthPlane",
    "ReplicaBreaker",
    "STATE_CLOSED",
    "STATE_HALF_OPEN",
    "STATE_OPEN",
    "resolve_health_policy",
]
