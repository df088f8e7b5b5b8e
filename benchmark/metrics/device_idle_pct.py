"""device_idle_pct: the share of the traced window (first traced sweep's
start to the last one's end) in which the device ran no kernel, copy or
set: one minus the union of the device intervals over the window, so that
the chunk loop's two streams count once."""
from benchmark.harness import trace as trc


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    lo, hi = run.trace.window
    if hi <= lo:
        return None
    return 100.0 * (1.0 - trc.busy_ns(run.trace.device, lo, hi) / (hi - lo))
