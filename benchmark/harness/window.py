"""Set-up and the measured window: requests back to back, one at a time.

Each request's record keeps its host timings, the ``SweepResult``'s own
counters and the program's outputs at the points the check samples.  A
request that ends after the window's close is recorded as cut and
counts for nothing.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np

from benchmark.harness import traffic as tr
from benchmark.harness.program import OUTPUTS


class Record(NamedTuple):
    request: tr.Request
    start: float              # host clock at the call
    end: float                # host clock when the call returned its host outputs
    wall_s: float
    seconds: float            # SweepResult.seconds: the chunk loop
    lz_seconds: float         # SweepResult.lz_seconds: the LZ pre-pass
    chunks: int
    n_failed: int
    quad_impl: Optional[str]
    sample: np.ndarray        # the sampled point indices
    outputs: Dict[str, np.ndarray]  # the program's outputs there
    error: Optional[str]
    traced: bool
    cut: bool                 # ended after the window closed


def call(program, request, sample, traced: bool, span: str) -> Dict[str, Any]:
    """One request through the program, timed by the host clock."""
    from torch.profiler import record_function

    ctx = record_function(span) if traced else contextlib.nullcontext()
    t0 = time.perf_counter()
    try:
        with ctx:
            res = program.sweep(request)
    except Exception as exc:  # noqa: BLE001 — a failed request is counted, not fatal
        t1 = time.perf_counter()
        return dict(start=t0, end=t1, wall_s=t1 - t0, seconds=0.0, lz_seconds=0.0, chunks=0,
                    n_failed=request.n_points, quad_impl=None, sample=sample, outputs={},
                    error=f"{type(exc).__name__}: {exc}")
    t1 = time.perf_counter()
    out = {k: np.asarray(res.outputs[k])[sample].copy() for k in OUTPUTS}
    return dict(start=t0, end=t1, wall_s=t1 - t0, seconds=float(res.seconds),
                lz_seconds=float(res.lz_seconds), chunks=int(res.chunks),
                n_failed=int(res.n_failed), quad_impl=res.quad_impl, sample=sample,
                outputs=out, error=None)


def warm(program, traffic, config, seed: int) -> None:
    """The set-up's one sweep of the cell's own shapes (a request of its
    own stream, never one the window sends)."""
    req = tr.make_request(traffic, config, seed, 0, tag=tr.WARM)
    res = program.sweep(req)
    del res


class Window(NamedTuple):
    records: List[Record]
    trace: Any                # trace.Trace of the traced requests, or None


def run(program, traffic, config, seed: int, seconds: float, trace: bool) -> Window:
    """Requests back to back for ``seconds``; with ``trace`` the first
    ``trace_sweeps`` of them run under ``torch.profiler``.  The profiler's
    start and its reduction of the trace stop the window's clock: the
    traced run's window holds ``seconds`` of requests, as the untraced
    run's does."""
    from benchmark.harness import trace as trc

    n_traced = int(traffic["trace_sweeps"]) if trace else 0
    prof, collected = None, None
    if n_traced:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    records: List[Record] = []
    t_close = time.perf_counter() + float(seconds)
    k = 0
    while time.perf_counter() < t_close:
        req = tr.make_request(traffic, config, seed, k)
        sample = tr.sample_points(traffic, seed, req)
        traced = prof is not None
        r = call(program, req, sample, traced, trc.SPAN)
        records.append(Record(request=req, traced=traced, cut=r["end"] > t_close, **r))
        k += 1
        if prof is not None and k == n_traced:
            t_pause = time.perf_counter()
            prof.__exit__(None, None, None)
            collected, prof = trc.collect(prof), None
            t_close += time.perf_counter() - t_pause
    if prof is not None:  # the window closed before every traced request ran
        prof.__exit__(None, None, None)
        collected = trc.collect(prof)
    return Window(records, collected)
