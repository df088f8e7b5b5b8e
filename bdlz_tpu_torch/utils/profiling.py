"""Counters, serving statistics, profiler traces and the NaN check.

Counterpart of ``bdlz_tpu/utils/profiling.py``:

* ``CompactionStats`` — the lane-repacking stiff engine's rounds;
* ``ServeBatch`` / ``ServeStats`` — the serving plane's per-batch rows
  and their summary, with the JAX package's keys and schema rule (the
  extras are absent unless something armed them);
* :func:`span` — a named region of the program in a ``torch.profiler``
  trace, free but for one check while no profiler records (the names
  the sweep path emits are :data:`SPANS`);
* :func:`trace` — a ``torch.profiler`` region written as one Chrome
  trace per use (one per sweep, ``--profile-dir``);
* :func:`enable_nan_debugging` — the stand-in for ``jax_debug_nans``: a
  ``TorchFunctionMode`` that checks the floating outputs of every torch
  op and raises ``FloatingPointError`` at the first one that holds a
  NaN.  The hand kernels do not pass through the dispatcher, so their
  wrappers call :func:`check_kernel_output` on what they wrote.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


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


@dataclass(frozen=True)
class ServeBatch:
    """One dispatched micro-batch of the query service
    (``bdlz_tpu_torch/serve``): how full it ran, how long its oldest request
    waited, how many requests missed the emulator domain and took the
    exact-pipeline fallback, and how long the evaluation took."""

    batch_index: int
    size: int              # requests in the batch
    occupancy: float       # size / max_batch_size
    wait_s: float          # oldest request's queue wait at dispatch
    n_fallback: int        # exact-pipeline requests (OOD + error-gated)
    seconds: float         # evaluation wall time
    # degraded-mode accounting (docs/robustness.md): exact-fallback
    # retries paid, and requests answered with a per-request error after
    # the retry budget (the serve analog of sweep quarantine)
    n_retries: int = 0
    n_error: int = 0
    #: The subset of ``n_fallback`` routed to the exact path by the
    #: PREDICTED-ERROR gate (reason "predicted_error") rather than by
    #: domain membership (reason "ood") — telemetry must distinguish a
    #: box that no longer covers the traffic from a surface that covers
    #: it but is not accurate enough where the traffic lands.
    n_gated: int = 0
    # fleet provenance (docs/serving.md): which artifact answered the
    # batch and which device replica ran it.  Every request in one batch
    # shares one artifact by construction — the rollout tests pin that a
    # cutover never mixes surfaces within a dispatch.
    artifact_hash: "str | None" = None
    replica: "int | None" = None
    #: The LZ physics scenario the answering artifact serves
    #: ("two_channel" | "chain" | "thermal"; docs/scenarios.md) — every
    #: service-recorded row names its mode so cross-mode traffic audits
    #: read straight off the stats.  None only on rows recorded by a
    #: bare MicroBatcher with no service behind it.
    lz_mode: "str | None" = None
    #: The fabric host that dispatched the batch (docs/serving.md,
    #: cross-host fabric) — cross-host traces must be attributable to
    #: the host that answered.  None on single-host services (the
    #: pre-fabric row schema, extended in place, never forked).
    host_id: "str | None" = None


@dataclass
class ServeStats:
    """Per-batch record of a serving session (same shape as
    :class:`CompactionStats`: record rows, collapse to a summary for
    bench JSON / event logs).  ``occupancy`` is the quantity dynamic
    batching exists to maximize; ``fallback_rate`` is the fraction of
    traffic the emulator could not absorb — a rising rate means the
    artifact's box no longer covers the query distribution.

    Every rate/percentile field of :meth:`summary` is ``None`` — never
    NaN, never a fabricated 0.0 — when its window is empty (zero batches
    dispatched, every request shed): a dashboard must be able to tell
    "nothing measured" from "measured zero", and the summary must stay
    ``json.dumps(..., allow_nan=False)``-safe under total overload.
    """

    rows: List[ServeBatch] = field(default_factory=list)
    #: Requests answered with ``DeadlineExceeded`` at dispatch instead of
    #: aging their batch (counted here, not per row — a fully-expired
    #: dispatch records no batch row at all).
    deadline_kills: int = 0
    #: Requests rejected at submit by admission control (bounded queue,
    #: ``serve.QueueFull``) — they never entered the queue at all.
    admission_rejects: int = 0
    #: Requests the queue accepted (admission's complement: offered
    #: traffic = accepted + admission_rejects).
    accepted: int = 0
    #: Per-request submit→resolve latencies on the service's clock (the
    #: fleet records one entry per answered request; percentile source).
    latencies_s: List[float] = field(default_factory=list)
    #: Seconds spent pre-compiling query kernels (artifact load + rollout
    #: warm-up) — the compile spike the warm start keeps out of p99.
    warmup_seconds: float = 0.0
    #: Opt-in summary extensions (the replica health plane, rollout
    #: auto-rollback records).  Keys land verbatim at the END of
    #: :meth:`summary`; EMPTY by default so the summary schema is
    #: byte-identical to the pre-health service whenever nothing armed
    #: them (the zero-overhead pin in tests/test_health.py).
    extras: Dict[str, Any] = field(default_factory=dict)
    #: Opt-in per-query traffic trace (the refinement daemon's input,
    #: ``bdlz_tpu_torch/refine``): one ``(theta tuple, reason)`` entry per
    #: answered request, ``reason`` as on the response (None = the
    #: emulator answered).  ``None`` — the default — disables recording:
    #: :meth:`record_queries` is a no-op and :meth:`summary` is
    #: byte-identical to an unarmed service.  Arm with
    #: :meth:`arm_traffic_log`.
    traffic_log: "Optional[List[Tuple[Tuple[float, ...], Optional[str]]]]" = None

    def arm_traffic_log(self) -> None:
        """Start recording per-query locations and fallback reasons."""
        if self.traffic_log is None:
            self.traffic_log = []

    def record_queries(self, thetas: Any, reasons: Any = None) -> None:
        """Append one entry per request of a resolved batch (a no-op
        unless :meth:`arm_traffic_log` ran).  ``thetas`` is the (B, d)
        query block; ``reasons`` the per-request fallback reasons (a
        single string broadcasts; None = all emulator-answered)."""
        if self.traffic_log is None:
            return
        block = np.atleast_2d(np.asarray(thetas, dtype=np.float64))
        b = block.shape[0]
        if reasons is None:
            reasons = [None] * b
        elif isinstance(reasons, str):
            reasons = [reasons] * b
        for row, reason in zip(block, reasons):
            self.traffic_log.append((tuple(float(v) for v in row), reason))

    def record_batch(self, **kw: Any) -> None:
        self.rows.append(ServeBatch(**kw))

    def record_deadline_kills(self, n: int) -> None:
        self.deadline_kills += int(n)

    def record_admission_rejects(self, n: int = 1) -> None:
        self.admission_rejects += int(n)

    def record_accepted(self, n: int = 1) -> None:
        self.accepted += int(n)

    def record_latency(self, seconds: float) -> None:
        self.latencies_s.append(float(seconds))

    def record_warmup(self, seconds: float) -> None:
        self.warmup_seconds += float(seconds)

    @property
    def n_batches(self) -> int:
        return len(self.rows)

    def _percentile(self, q: float) -> "float | None":
        if not self.latencies_s:
            return None
        return round(float(np.percentile(np.asarray(self.latencies_s), q)), 6)

    def summary(self) -> Dict[str, Any]:
        requests = sum(r.size for r in self.rows)
        fallbacks = sum(r.n_fallback for r in self.rows)
        gated = sum(r.n_gated for r in self.rows)
        errors = sum(r.n_error for r in self.rows)
        shed = self.deadline_kills + self.admission_rejects
        offered = self.accepted + self.admission_rejects
        return {
            "batches": self.n_batches,
            "requests": requests,
            "fallbacks": fallbacks,
            "fallback_rate": (
                round(fallbacks / requests, 4) if requests else None
            ),
            # predicted-error-gated subset of the fallbacks ("ood" vs
            # "predicted_error" reasons — geometry misses vs accuracy
            # gating are different capacity-planning signals)
            "gated_fallbacks": gated,
            "gated_rate": (
                round(gated / requests, 4) if requests else None
            ),
            "mean_batch": (
                round(requests / self.n_batches, 2) if self.rows else None
            ),
            "mean_occupancy": (
                round(sum(r.occupancy for r in self.rows) / self.n_batches, 4)
                if self.rows else None
            ),
            "max_wait_s": (
                round(max(r.wait_s for r in self.rows), 6)
                if self.rows else None
            ),
            "seconds": round(sum(r.seconds for r in self.rows), 4),
            # degraded-mode accounting: how hard the service had to fight
            # (retries), what it shed (deadline kills), and what it could
            # not save (per-request errors = the serve quarantine rate)
            "retries": sum(r.n_retries for r in self.rows),
            "deadline_kills": self.deadline_kills,
            "errors": errors,
            "quarantine_rate": (
                round(errors / requests, 4) if requests else None
            ),
            # fleet-plane accounting (docs/serving.md): offered traffic
            # vs what overload control turned away, and the latency
            # percentiles of what was answered
            "accepted": self.accepted,
            "admission_rejects": self.admission_rejects,
            "shed_rate": round(shed / offered, 4) if offered else None,
            "p50_latency_s": self._percentile(50.0),
            "p99_latency_s": self._percentile(99.0),
            "warmup_seconds": round(self.warmup_seconds, 4),
            # health plane / auto-rollback extensions — absent entirely
            # when nothing armed them (schema pin)
            **self.extras,
        }

    def as_rows(self) -> List[Dict[str, Any]]:
        """The per-batch records as plain dicts (event logs, JSON)."""
        return [dataclasses.asdict(r) for r in self.rows]


#: The spans of the sweep path, outermost first: the sweep, its planning
#: (the grid, the bounce shoot, each point's P with each dephased
#: transport pass inside it and, inside a pass on the card, the transport
#: kernel's launch, the F table, the population audit, the engine's
#: build), the chunk loop and, per chunk, the inputs shipped, the step
#: enqueued with its copies back (inside it, on one card, the kernel
#: engine's graph replayed), the wait on those copies and the host's
#: finish, then the outputs' copy-out.
SPANS = ("sweep", "sweep.grid", "lz.shoot", "lz.points", "lz.dephase",
         "lz.dephase.kernel", "f_table", "audit", "engine.build", "sweep.loop",
         "chunk.ship", "chunk.step", "chunk.replay", "chunk.wait", "chunk.finish",
         "sweep.copy_out")

_NO_SPAN = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """The region ``name`` of the program: a ``record_function`` while a
    ``torch.profiler`` records, so that it lands in the trace on the clock
    of the card's events, nested under the spans open on this thread;
    else one shared null context, one check and no allocation."""
    if _profiler_enabled():
        return torch.autograd.profiler.record_function(name)
    return _NO_SPAN


def spanned(name: str):
    """Decorate a function so that each call of it is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """Profile a region with ``torch.profiler`` (the card's kernels too,
    when one is present) and write it as one Chrome trace,
    ``trace_dir/trace_<n>.json`` with ``n`` the next free index; the
    region's :func:`span` calls are in it.  No-op when ``trace_dir`` is
    None."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    n = len([f for f in os.listdir(trace_dir) if f.startswith("trace_")])
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{n:05d}.json"))


#: Factories whose output is uninitialized memory, not a computed value.
_UNINITIALIZED = frozenset(("empty", "empty_like", "new_empty", "empty_strided"))


def _nan_tensors(out: Any) -> List[torch.Tensor]:
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    return [t for t in leaves
            if isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
            and bool(torch.isnan(t).any())]


class _NanCheckMode(torch.overrides.TorchFunctionMode):
    """Raise at the first torch op whose floating output holds a NaN."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", repr(func))
        if name not in _UNINITIALIZED:
            bad = _nan_tensors(out)
            if bad:
                raise FloatingPointError(
                    f"NaN produced by torch op {name!r} (output shape "
                    f"{tuple(bad[0].shape)}, {int(torch.isnan(bad[0]).sum())} NaN)"
                )
        return out


_NAN_MODE: Dict[str, Any] = {"mode": None}


def enable_nan_debugging(enable: bool = True) -> None:
    """Arm (or disarm) the op-level NaN check of this thread.  Every
    torch op then pays a NaN scan of its outputs, a device sync on the
    card: a debugging mode, off by default."""
    mode = _NAN_MODE["mode"]
    if enable and mode is None:
        mode = _NanCheckMode()
        mode.__enter__()
        _NAN_MODE["mode"] = mode
    elif not enable and mode is not None:
        _NAN_MODE["mode"] = None
        mode.__exit__(None, None, None)


def nan_debugging_enabled() -> bool:
    """Whether :func:`enable_nan_debugging` is armed in this thread."""
    return _NAN_MODE["mode"] is not None


def check_kernel_output(kernel: str, out: torch.Tensor) -> None:
    """Under :func:`enable_nan_debugging`, raise when a hand kernel wrote
    a NaN (its launch bypasses the dispatcher, so the mode cannot see
    it).  One dict lookup otherwise."""
    if _NAN_MODE["mode"] is not None and bool(torch.isnan(out).any()):
        raise FloatingPointError(
            f"NaN produced by kernel {kernel!r} (output shape {tuple(out.shape)}, "
            f"{int(torch.isnan(out).sum())} NaN)"
        )
