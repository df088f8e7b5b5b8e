"""Bounded retry with deterministic backoff.

Counterpart of ``bdlz_tpu/utils/retry.py``, shared by the self-healing
sweep (``parallel/sweep.py``, which takes every delay from
:func:`backoff_delay`) and the emulator's probe evaluator (which runs
:func:`call_with_retry`):

* bounded attempts: a persistent failure always reaches the caller's
  bisect, quarantine or error path;
* deterministic jitter: the schedule is a pure function of
  ``(seed, label, attempt)`` through SHA-256, so it is the same on every
  process and tests can pin the delays;
* injectable sleep: tests pass ``sleep=lambda s: None``.

``retry_enabled=None`` means "the engine decides": the chunked sweep
turns healing on; ``False`` restores raise-through.
"""
from __future__ import annotations

import hashlib
import time
from typing import Any, Callable, NamedTuple, Optional, Tuple, Type


class RetryPolicy(NamedTuple):
    """How a healing call site retries: attempts, backoff, sleep seam."""

    #: Total attempts, the first one included (>= 1).
    max_attempts: int = 3
    #: Backoff before the first retry; doubles per retry.
    backoff_s: float = 0.05
    #: Ceiling of the doubled backoff.
    max_backoff_s: float = 2.0
    #: Seed of the deterministic jitter.
    seed: int = 0
    #: Injectable sleep.
    sleep: Callable[[float], None] = time.sleep


def deterministic_jitter(seed: int, label: str, attempt: int) -> float:
    """A reproducible value in [0, 1) from (seed, label, attempt)."""
    digest = hashlib.sha256(f"{seed}:{label}:{attempt}".encode()).digest()
    return int.from_bytes(digest[:8], "big") / float(2 ** 64)


def backoff_delay(policy: RetryPolicy, label: str, attempt: int) -> float:
    """Delay before retry ``attempt`` (0-based): capped exponential with
    deterministic half-to-full jitter (0.5–1.0× of the doubled base)."""
    base = float(policy.backoff_s) * (2.0 ** int(attempt))
    jitter = 0.5 + 0.5 * deterministic_jitter(policy.seed, label, attempt)
    return min(base * jitter, float(policy.max_backoff_s))


def call_with_retry(
    fn: Callable[[], Any],
    policy: RetryPolicy,
    label: str = "",
    retryable: "Tuple[Type[BaseException], ...]" = (Exception,),
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> Any:
    """Run ``fn`` under the policy; re-raise the last error when the
    attempts are spent.  ``on_retry(attempt, exc)`` fires before each
    retry's sleep (``attempt`` counts the retries from 0)."""
    attempts = max(int(policy.max_attempts), 1)
    for attempt in range(attempts):
        try:
            return fn()
        except retryable as exc:  # noqa: PERF203 — the retry loop is the point
            if attempt + 1 >= attempts:
                raise
            if on_retry is not None:
                on_retry(attempt, exc)
            policy.sleep(backoff_delay(policy, label, attempt))
    raise AssertionError("unreachable")  # pragma: no cover


def resolve_retry_policy(
    base=None,
    enabled: Optional[bool] = None,
    engine_default: bool = True,
    sleep: Optional[Callable[[float], None]] = None,
    seed: int = 0,
) -> Optional[RetryPolicy]:
    """The ``retry_enabled`` tri-state as a policy, or None when healing
    is off.  ``enabled`` overrides the config's knob; None falls to
    ``engine_default``.  ``retry_max_attempts`` and ``retry_backoff_s``
    come from the config."""
    attempts, backoff = 3, 0.05
    if base is not None:
        if enabled is None:
            enabled = getattr(base, "retry_enabled", None)
        attempts = int(getattr(base, "retry_max_attempts", attempts))
        backoff = float(getattr(base, "retry_backoff_s", backoff))
    on = engine_default if enabled is None else bool(enabled)
    if not on:
        return None
    return RetryPolicy(
        max_attempts=max(attempts, 1),
        backoff_s=backoff,
        seed=int(seed),
        sleep=time.sleep if sleep is None else sleep,
    )


def resolve_engine_retry(
    explicit: Optional[RetryPolicy],
    base,
    static=None,
    engine_default: bool = True,
) -> Optional[RetryPolicy]:
    """Explicit policy ▸ the static's tri-state ▸ the config's tri-state
    ▸ the engine default: one precedence for the sweep and the emulator
    build."""
    if explicit is not None:
        return explicit
    enabled = getattr(static, "retry_enabled", None) if static is not None else None
    if enabled is None:
        enabled = getattr(base, "retry_enabled", None)
    return resolve_retry_policy(base, enabled=enabled, engine_default=engine_default)
