"""The yield query service: emulator fast path + exact-pipeline fallback.

Counterpart of ``bdlz_tpu/serve/service.py``.  :class:`YieldService`
owns the evaluation paths a query can take:

* **in-domain, inside predicted error** — the artifact's batched
  log-space interpolation on the device (``emulator/grid.py``; a
  seam-split bundle routes each query to its containing domain);
* **exact fallback** — the exact pipeline through the engine the
  artifact was built with (``emulator.build.make_exact_evaluator``, the
  sweep's chunk engine: under ``impl="kernel"`` that is the CUDA
  point kernel P1), taken for a query outside every
  domain (reason ``"ood"``) or one whose cell's predicted error exceeds
  the error gate (reason ``"predicted_error"``).  Non-finite exact output
  passes through as NaN per request.

The gate, the identity rules, the padding to one bucket shape and the
per-request isolation are the JAX service's; the helpers here are the
one home both serving fronts (this service and ``fleet.py``) share.
Every entry point runs on the card unless the caller asks for the CPU
(``device="cpu"``), and raises without one.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from bdlz_tpu_torch.backend import resolve_device
from bdlz_tpu_torch.emulator.artifact import build_identity, check_identity
from bdlz_tpu_torch.emulator.build import make_exact_evaluator
from bdlz_tpu_torch.emulator.grid import (
    artifact_hull,
    domain_artifacts,
    error_floor,
    has_error_grid,
    make_domain_fn,
    make_error_fn,
    make_query_fn,
)
from bdlz_tpu_torch.serve.batcher import BatchResult, MicroBatcher
from bdlz_tpu_torch.utils.profiling import ServeStats

#: Fallback-reason tags (FleetResponse.fallback_reason, ServeStats rows,
#: serve_cli JSONL answers): None = answered by the emulator.
REASON_OOD = "ood"
REASON_PREDICTED_ERROR = "predicted_error"
#: Every replica's circuit breaker is open: the fleet serves the batch
#: through the exact pipeline, loudly marked (FleetResponse.degraded).
REASON_DEGRADED = "degraded"

class ServeAnswer(NamedTuple):
    """One annotated answer (the serve CLI's JSONL path): the value plus
    which fallback reason produced it (None = emulator fast path)."""

    value: float
    fallback_reason: Optional[str] = None


def gate_fallback_masks(inside, pred_err, tol):
    """The gating rule both serving fronts share: fallback = out-of-domain
    OR (in-domain AND predicted error over the gate), ``"ood"`` winning
    when both fire.  ``tol=None`` reduces to membership only.  Returns
    ``(fallback, gated, reasons)``."""
    inside = np.asarray(inside, dtype=bool)
    if tol is not None and pred_err is not None:
        gated = inside & (np.asarray(pred_err) > tol)
    else:
        gated = np.zeros(inside.shape, dtype=bool)
    fallback = ~inside | gated
    reason_arr = np.where(
        ~inside, REASON_OOD, np.where(gated, REASON_PREDICTED_ERROR, "")
    )
    reasons: "List[Optional[str]]" = [r if r else None for r in reason_arr.tolist()]
    return fallback, gated, reasons


def _pad_rows(arr: np.ndarray, n: int) -> np.ndarray:
    """Pad (B, d) to (n, d) by repeating the last row (masked out later)."""
    if arr.shape[0] >= n:
        return arr
    return np.concatenate([arr, np.repeat(arr[-1:], n - arr.shape[0], axis=0)])


def artifact_lz_mode(artifact) -> str:
    """The LZ physics scenario ``artifact`` serves, from its identity's
    omit-at-default ``lz_scenario`` key (``"two_channel"`` when absent)."""
    scen = dict(artifact.identity).get("lz_scenario")
    return str(scen["mode"]) if scen else "two_channel"


def resolve_service_profile(artifact, lz_profile, bounce=None, device=None):
    """The bounce profile a service's exact fallback must run with: None
    for a two-channel artifact (passing one is an error); for a chain or
    thermal artifact the very profile it was built from, checked by
    fingerprint (``bounce`` derives it from a potential on ``device``,
    checked against the artifact's potential fingerprint)."""
    mode = artifact_lz_mode(artifact)
    if mode == "two_channel":
        if lz_profile is not None or bounce is not None:
            raise ValueError(
                "lz_profile/bounce require a scenario (chain/thermal) "
                "artifact — this two-channel artifact's exact fallback "
                "takes P from the config or its axes"
            )
        return None
    if bounce is not None:
        if lz_profile is not None:
            raise ValueError(
                "pass either bounce or lz_profile, not both — the bounce "
                "solver derives the profile the lz_profile seam would load"
            )
        from bdlz_tpu_torch.bounce import (
            as_potential_spec,
            bounce_profile,
            potential_fingerprint,
        )

        bounce = as_potential_spec(bounce)
        got_pot = potential_fingerprint(bounce)
        recorded_pot = dict(artifact.identity).get("bounce")
        if recorded_pot != got_pot:
            raise ValueError(
                f"bounce potential fingerprint {got_pot} does not match "
                f"the potential this artifact was built from "
                f"({recorded_pot}): the exact fallback would answer from "
                "different physics than the emulator surface"
            )
        lz_profile = bounce_profile(bounce, device=device)
    if lz_profile is None:
        raise ValueError(
            f"this artifact serves lz_mode={mode!r}: its exact fallback "
            "derives P per point from a bounce profile; pass lz_profile "
            "(or bounce, for a surface built from a potential spec)"
        )
    from bdlz_tpu_torch.lz.profile import load_profile_csv
    from bdlz_tpu_torch.lz.sweep_bridge import profile_fingerprint

    if isinstance(lz_profile, str):
        lz_profile = load_profile_csv(lz_profile)
    recorded = dict(artifact.identity).get("lz_profile")
    got = profile_fingerprint(lz_profile)
    if recorded is not None and got != recorded:
        raise ValueError(
            f"lz_profile fingerprint {got} does not match the profile "
            f"this artifact was built from ({recorded}): the exact "
            "fallback would answer from different physics than the "
            "emulator surface"
        )
    return lz_profile


def theta_from_mapping(artifact, point: Dict[str, float]) -> np.ndarray:
    """(d,) query vector from an {axis_name: value} mapping.  A stated
    ``"lz_mode"`` that disagrees with the artifact's is cross-mode skew
    and rejects loudly."""
    point = dict(point)
    stated = point.pop("lz_mode", None)
    if stated is not None:
        mode = artifact_lz_mode(artifact)
        if str(stated) != mode:
            raise ValueError(
                f"request states lz_mode={str(stated)!r} but this "
                f"artifact serves lz_mode={mode!r} — cross-mode "
                "artifact/request skew"
            )
    missing = [n for n in artifact.axis_names if n not in point]
    if missing:
        raise ValueError(f"query is missing axes {missing}")
    unknown = sorted(set(point) - set(artifact.axis_names))
    if unknown:
        raise ValueError(
            f"query has unknown axes {unknown}; this artifact takes "
            f"{list(artifact.axis_names)}"
        )
    return np.asarray([float(point[n]) for n in artifact.axis_names])


def resolve_error_gate(artifact, base, error_gate_tol=None) -> Optional[float]:
    """The exact-fallback error-gate tolerance: explicit argument >
    ``Config.error_gate_tol`` > the artifact's recorded ``rtol_target``
    (only when it carries per-cell estimates or missed its contract).
    ``False`` disables the gate.  Returns the tolerance, or None."""
    tol = error_gate_tol
    if tol is None:
        tol = getattr(base, "error_gate_tol", None)
    if tol is False:
        return None
    if tol is True:
        raise ValueError(
            "error_gate_tol=True is ambiguous: use None for the "
            "artifact's recorded rtol_target, False to disable the "
            "gate, or a positive tolerance"
        )
    if tol is not None:
        tol = float(tol)
        if not tol > 0.0:
            raise ValueError(
                f"error_gate_tol must be a positive relative tolerance, "
                f"False, or None, got {tol!r}"
            )
        return tol
    untrusted = any(error_floor(d) > 0.0 for d in domain_artifacts(artifact))
    if not (has_error_grid(artifact) or untrusted):
        return None
    rt = artifact.manifest.get("rtol_target")
    return float(rt) if rt is not None else None


def resolve_service_static(artifact, base, static=None):
    """``(static, n_y, impl)`` a service must run with for ``artifact``:
    the caller's static (from ``base`` when absent), adopting the
    artifact's recorded y-quadrature when the tri-state is None, then
    checked against the artifact identity.  ``impl`` is the recorded
    engine, which the exact fallback runs."""
    from bdlz_tpu_torch.config import static_choices_from_config

    if static is None:
        static = static_choices_from_config(base)
    n_y = int(artifact.identity.get("n_y", 0))
    impl = str(artifact.identity.get("impl", "tabulated"))
    q_art = artifact.identity.get("quad_panel_gl")
    if static.quad_panel_gl is None and q_art is not None:
        static = static._replace(quad_panel_gl=bool(q_art))
    check_identity(artifact, build_identity(base, static, n_y, impl))
    return static, n_y, impl


class ExactFallback:
    """The exact-pipeline fallback behind its robustness seams, shared by
    :class:`YieldService` and the fleet: retried once with deterministic
    backoff when a retry policy resolves, ``serve_exact`` faults fired
    keyed by the logical call counter, a persistent failure re-raised to
    the caller.  ``engine`` is the engine it runs: the recorded one, with
    JAX's ``"pallas"`` mapped to the CUDA kernels, ``"kernel"``."""

    def __init__(
        self, base, static, *, n_y: int, impl: str, chunk_size: int,
        retry=None, fault_plan=None, lz_profile=None, device=None, mesh=None,
    ):
        from bdlz_tpu_torch.faults import FaultPlan
        from bdlz_tpu_torch.utils.retry import resolve_engine_retry

        self._retry = resolve_engine_retry(retry, base, static)
        self._faults = FaultPlan.resolve(fault_plan, base)
        self.engine = "kernel" if impl == "pallas" else impl
        self._exact = make_exact_evaluator(
            base, static, n_y=n_y, impl=self.engine, chunk_size=chunk_size,
            lz_profile=lz_profile, device=device, mesh=mesh,
        )
        self._calls = 0

    @property
    def fault_plan(self):
        return self._faults

    def __call__(self, axes, retries_box) -> Dict[str, np.ndarray]:
        """Evaluate ``axes`` exactly; ``retries_box[0]`` counts retries
        paid, success or not."""
        from bdlz_tpu_torch.utils.retry import call_with_retry

        # the fault key is the logical fallback call: retries share it
        call_idx = self._calls
        self._calls += 1

        def attempt():
            if self._faults is not None:
                self._faults.fire("serve_exact", call_idx)
            return self._exact(axes)

        if self._retry is None:
            return attempt()

        def count_retry(_attempt, _exc):
            retries_box[0] += 1

        return call_with_retry(
            attempt,
            self._retry._replace(max_attempts=min(2, self._retry.max_attempts)),
            label=f"serve_exact{call_idx}",
            on_retry=count_retry,
        )


class YieldService:
    """Batched yield queries against one artifact on one device.

    ``base``/``static`` must be the physics the artifact was built for
    (checked at construction through the artifact identity); the
    fallback runs at the artifact's recorded n_y and engine.  ``device``
    is the card unless the caller asks for the CPU; a ``mesh`` splits the
    exact fallback's chunks over its members.
    """

    def __init__(
        self,
        artifact,
        base,
        static=None,
        field: str = "DM_over_B",
        max_batch_size: int = 256,
        retry=None,
        fault_plan=None,
        warm: bool = True,
        error_gate_tol=None,
        lz_profile=None,
        bounce=None,
        device=None,
        mesh=None,
    ):
        self.device = resolve_device(device)
        static, n_y, impl = resolve_service_static(artifact, base, static)
        self.lz_mode = artifact_lz_mode(artifact)
        lz_profile = resolve_service_profile(artifact, lz_profile, bounce, self.device)
        self.artifact = artifact
        self.field = field
        self.max_batch_size = int(max_batch_size)
        self._query = make_query_fn(artifact, field=field, device=self.device)
        self._in_domain = make_domain_fn(artifact, device=self.device)
        self.error_gate_tol = resolve_error_gate(artifact, base, error_gate_tol)
        self._pred_error = (
            make_error_fn(artifact, device=self.device)
            if self.error_gate_tol is not None else None
        )
        self._exact_guarded = ExactFallback(
            base, static, n_y=n_y, impl=impl, chunk_size=self.max_batch_size,
            retry=retry, fault_plan=fault_plan, lz_profile=lz_profile,
            device=self.device, mesh=mesh,
        )
        #: The engine the exact fallback runs ("kernel" = the CUDA point kernel P1).
        self.exact_engine = self._exact_guarded.engine
        self._faults = self._exact_guarded.fault_plan
        self.stats = ServeStats()
        if warm:
            self.warm_start()

    # ---- evaluation -------------------------------------------------

    def warm_start(self) -> float:
        """Launch the padded query, domain and error functions once and
        wait for the device (not the exact fallback: only out-of-domain
        traffic pays its first call).  Recorded as ``warmup_seconds``."""
        t0 = time.monotonic()
        lower, _hi = artifact_hull(self.artifact)
        probe = np.tile(lower, (self.max_batch_size, 1))
        self._query(probe)
        self._in_domain(probe)
        if self._pred_error is not None:
            self._pred_error(probe)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.monotonic() - t0
        self.stats.record_warmup(seconds)
        return seconds

    def _evaluate_isolated(self, thetas):
        """(values, n_fallback, errors, n_retries, reasons, n_gated), with
        a dead exact fallback poisoning only the requests that needed it."""
        thetas = np.atleast_2d(np.asarray(thetas, dtype=np.float64))
        b = thetas.shape[0]
        if thetas.shape[1] != len(self.artifact.axis_names):
            raise ValueError(
                f"queries must have {len(self.artifact.axis_names)} "
                f"coordinates ({', '.join(self.artifact.axis_names)}), "
                f"got shape {thetas.shape}"
            )
        bucket = self.max_batch_size
        padded = _pad_rows(thetas, bucket)
        inside = self._in_domain(padded).cpu().numpy()[:b]
        values = np.array(self._query(padded).cpu().numpy(), dtype=np.float64)[:b]
        pred = (
            self._pred_error(padded).cpu().numpy()[:b]
            if self._pred_error is not None else None
        )
        fallback, gated, reasons = gate_fallback_masks(
            inside, pred, self.error_gate_tol if pred is not None else None
        )
        n_fallback = int(fallback.sum())
        errors: "list[Optional[BaseException]]" = [None] * b
        retries_box = [0]
        if n_fallback:
            ood = _pad_rows(thetas[fallback], bucket)
            axes = {name: ood[:, k] for k, name in enumerate(self.artifact.axis_names)}
            try:
                exact_fields = self._exact_guarded(axes, retries_box)
                values[fallback] = exact_fields[self.field][:n_fallback]
            except Exception as exc:  # noqa: BLE001 — isolated per request
                for i in np.flatnonzero(fallback):
                    errors[int(i)] = exc
                    values[int(i)] = np.nan
        return values, n_fallback, errors, retries_box[0], reasons, int(gated.sum())

    def evaluate(self, thetas) -> Tuple[np.ndarray, int]:
        """(values, n_fallback) for a (B, d) batch.  A persistently failing
        exact fallback raises here; :meth:`process_batch` isolates it."""
        values, n_fallback, errors, _, _, _ = self._evaluate_isolated(thetas)
        for e in errors:
            if e is not None:
                raise e
        return values, n_fallback

    # ---- batcher integration ---------------------------------------

    def process_batch(self, thetas) -> BatchResult:
        (values, n_fallback, errors, n_retries, reasons,
         n_gated) = self._evaluate_isolated(thetas)
        return BatchResult(
            values=list(values),
            n_fallback=n_fallback,
            errors=errors if any(e is not None for e in errors) else None,
            n_retries=n_retries,
            n_gated=n_gated,
            reasons=reasons,
        )

    def process_batch_annotated(self, thetas) -> BatchResult:
        """:meth:`process_batch` with each value a :class:`ServeAnswer`."""
        res = self.process_batch(thetas)
        reasons = res.reasons or [None] * len(res.values)
        return res._replace(values=[
            ServeAnswer(value=v, fallback_reason=r)
            for v, r in zip(res.values, reasons)
        ])

    def make_batcher(
        self,
        max_wait_s: float = 0.005,
        clock=None,
        stats: Optional[ServeStats] = None,
        deadline_s: Optional[float] = None,
        annotate: bool = False,
    ) -> MicroBatcher:
        """A MicroBatcher wired to this service (shared stats object);
        ``annotate=True`` resolves futures to :class:`ServeAnswer`."""
        return MicroBatcher(
            self.process_batch_annotated if annotate else self.process_batch,
            max_batch_size=self.max_batch_size,
            max_wait_s=max_wait_s,
            clock=time.monotonic if clock is None else clock,
            stats=self.stats if stats is None else stats,
            deadline_s=deadline_s,
            fault_plan=self._faults,
            lz_mode=self.lz_mode,
        )

    def theta_from_mapping(self, point: Dict[str, float]) -> np.ndarray:
        """(d,) query vector from an {axis_name: value} mapping."""
        return theta_from_mapping(self.artifact, point)


__all__ = [
    "ExactFallback",
    "REASON_DEGRADED",
    "REASON_OOD",
    "REASON_PREDICTED_ERROR",
    "ServeAnswer",
    "YieldService",
    "artifact_lz_mode",
    "gate_fallback_masks",
    "resolve_error_gate",
    "resolve_service_profile",
    "resolve_service_static",
    "theta_from_mapping",
]
