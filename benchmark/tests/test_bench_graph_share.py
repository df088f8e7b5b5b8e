"""``chunk_graph_share`` on fabricated traces: replays of the captured
chunk step per chunk inside the traced sweeps' loops."""
from __future__ import annotations

import pytest

from benchmark.harness import spec
from benchmark.tests.test_bench_spans import _fabricated, _record, _run


def _with_replays(t, per_sweep):
    """``t`` with ``per_sweep`` replays inside each sweep's first chunks'
    ``chunk.step``, and one replay outside every harness span."""
    steps = [iv for iv in t.host if iv[0] == "chunk.step"]
    by_sweep = {}
    for name, s, e in steps:
        by_sweep.setdefault(s // 20_000, []).append((s, e))
    replays = [("chunk.replay", s + 20, s + 60)
               for spans in by_sweep.values() for s, _ in spans[:per_sweep]]
    return t._replace(host=t.host + replays + [("chunk.replay", 90_000, 90_010)])


def _read(run):
    return spec.metric_reader("chunk_graph_share")(run)


@pytest.mark.parametrize("per_sweep,want", [(2, 1.0), (1, 0.5), (0, 0.0)])
def test_replays_per_chunk_of_the_traced_sweeps(per_sweep, want):
    run = _run(_with_replays(_fabricated(chunks=2), per_sweep),
               [_record(chunks=2), _record(chunks=2)])
    assert _read(run) == pytest.approx(want)


def test_nothing_to_read_without_a_traced_loop():
    assert _read(_run(None, [_record()])) is None
    t = _fabricated()
    no_loop = t._replace(host=[iv for iv in t.host if iv[0] != "sweep.loop"])
    assert _read(_run(no_loop, [_record(chunks=2), _record(chunks=2)])) is None
