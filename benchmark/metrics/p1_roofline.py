"""p1_roofline: the point kernel P1's least time over its device time
in the traced sweeps.  The least time is the benchmark's own frozen count
(``harness/work.py``): per chunk of the configuration's size the larger of
the non-empty windows' nodes x 113 f64 instructions at 17e12 a second and
the points' inputs, the table and one result per point at 3.35 TB/s.  The
device time is every launch of ``kjma_point_kernel<false, true>`` in the
trace."""
import re

from benchmark.harness import work

P1 = re.compile(r"kjma_point_kernel(<false, true>|ILb0ELb1E)")


def read(run):
    if run.trace is None:
        return None
    device_ns = sum(t - s for name, s, t in run.trace.device if P1.search(name))
    traced = [r for r in run.records if r.traced and r.error is None]
    if not device_ns or not traced:
        return None
    return 100.0 * work.least_seconds_of(traced, run.config) / (device_ns * 1e-9)
