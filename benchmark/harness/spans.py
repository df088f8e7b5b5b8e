"""The program's own spans in a traced run, for the per-layer metrics.

The port names each phase of a sweep with a ``torch.profiler``
``record_function`` (``bdlz_tpu_torch/utils/profiling.span``), so the
spans are host events of the same trace as the device's intervals, on
one clock.  A reader counts only the spans inside the harness span
(``bench.sweep``) of a traced sweep that completed, divided by those
sweeps or by their chunks; without such spans (the untraced run, or a
program that emits none) it reads None.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from benchmark.harness import trace as trc

#: The program's span names (``bdlz_tpu_torch.utils.profiling.SPANS``),
#: kept here so that the readers work on a program that has none.
PROGRAM = ("sweep", "sweep.grid", "lz.shoot", "lz.points", "f_table", "audit",
           "engine.build", "sweep.loop", "chunk.ship", "chunk.step", "chunk.wait",
           "chunk.finish", "sweep.copy_out")


def windows(run) -> Optional[Tuple[List[Tuple[int, int]], list]]:
    """The harness spans of the traced sweeps that completed, with their
    records, or None when the trace does not pair them one to one."""
    if run.trace is None:
        return None
    spans = sorted((iv for iv in run.trace.host if iv[0] == trc.SPAN), key=lambda iv: iv[1])
    traced = [r for r in run.records if r.traced]
    if not spans or len(spans) != len(traced):
        return None
    pairs = [((s, t), r) for (_, s, t), r in zip(spans, traced)
             if r.error is None and not r.cut]
    if not pairs:
        return None
    return [w for w, _ in pairs], [r for _, r in pairs]


def named(run, name: str, within: Sequence[Tuple[int, int]]) -> List[trc.Interval]:
    """The host spans called ``name`` that lie inside one of ``within``."""
    return [iv for iv in run.trace.host
            if iv[0] == name and any(lo <= iv[1] and iv[2] <= hi for lo, hi in within)]


def per_sweep_ms(run, name: str) -> Optional[float]:
    """Σ of span ``name``'s durations over the completed traced sweeps / their number."""
    got = windows(run)
    if got is None:
        return None
    spans = named(run, name, got[0])
    if not spans:
        return None
    return 1e-6 * sum(t - s for _, s, t in spans) / len(got[1])


def per_chunk_ms(run, name: str) -> Optional[float]:
    """Σ of span ``name``'s durations over the completed traced sweeps / their chunks."""
    got = windows(run)
    if got is None:
        return None
    spans = named(run, name, got[0])
    chunks = sum(r.chunks for r in got[1])
    if not spans or not chunks:
        return None
    return 1e-6 * sum(t - s for _, s, t in spans) / chunks


def loops(run):
    """``(sweep.loop spans, chunks)`` of the completed traced sweeps, or
    None without a device trace or such spans."""
    got = windows(run)
    if got is None or not run.trace.device:
        return None
    spans = named(run, "sweep.loop", got[0])
    chunks = sum(r.chunks for r in got[1])
    if not spans or not chunks:
        return None
    return spans, chunks
