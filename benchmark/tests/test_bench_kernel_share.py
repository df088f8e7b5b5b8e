"""``dephase_kernel_share`` on fabricated traces: the traced sweeps'
dephased passes (``lz.dephase``) that hold a launch of the transport
kernel (``lz.dephase.kernel``), over all of them."""
from __future__ import annotations

import pytest

from benchmark.harness import spec
from benchmark.harness.main import Run
from benchmark.tests.test_bench_dephased import _fabricated, _record


def _with_launches(t, per_sweep):
    """``t`` with a kernel span inside each sweep's first ``per_sweep``
    passes, and one kernel span outside every pass."""
    passes = sorted((iv for iv in t.host if iv[0] == "lz.dephase"), key=lambda iv: iv[1])
    by_sweep = {}
    for _, s, e in passes:
        by_sweep.setdefault(s // 20_000, []).append((s, e))
    launches = [("lz.dephase.kernel", s + 10, s + 30)
                for spans in by_sweep.values() for s, _ in spans[:per_sweep]]
    return t._replace(host=t.host + launches + [("lz.dephase.kernel", 6_000, 6_010)])


def _read(run):
    return spec.metric_reader("dephase_kernel_share")(run)


@pytest.mark.parametrize("per_sweep,want", [(3, 1.0), (2, 2 / 3), (1, 1 / 3), (0, 0.0)])
def test_passes_that_launched_the_kernel_over_all_passes(per_sweep, want):
    run = Run({}, {}, [_record(), _record()], 1.0, _with_launches(_fabricated(), per_sweep))
    assert _read(run) == pytest.approx(want)


def test_a_pass_counts_once_however_many_launches_it_holds():
    t = _with_launches(_fabricated(passes=2), 1)
    first = min((iv for iv in t.host if iv[0] == "lz.dephase"), key=lambda iv: iv[1])
    twice = t._replace(host=t.host + [("lz.dephase.kernel", first[1] + 40, first[1] + 60)])
    assert _read(Run({}, {}, [_record(), _record()], 1.0, twice)) == pytest.approx(0.5)


def test_only_completed_traced_sweeps_count():
    # the second traced sweep raised: its passes are left out
    run = Run({}, {}, [_record(), _record(error="boom")], 1.0, _with_launches(_fabricated(), 1))
    assert _read(run) == pytest.approx(1 / 3)


def test_nothing_to_read_without_traced_passes():
    assert _read(Run({}, {}, [_record()], 1.0, None)) is None
    t = _with_launches(_fabricated(), 3)
    bare = t._replace(host=[iv for iv in t.host if iv[0] != "lz.dephase"])
    assert _read(Run({}, {}, [_record(), _record()], 1.0, bare)) is None
