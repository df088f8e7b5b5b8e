"""shoot_ms: device ms per launch of the bounce shoot kernel, from the
profiler's trace of the traced sweeps."""
import re

SHOOT = re.compile(r"bounce_(tree|shoot_serial)_kernel")


def read(run):
    if run.trace is None:
        return None
    times = [t - s for name, s, t in run.trace.device if SHOOT.search(name)]
    if not times:
        return None
    return sum(times) / len(times) * 1e-6
