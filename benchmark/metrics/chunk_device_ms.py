"""chunk_device_ms: device ms per chunk inside the program's span
``sweep.loop``: the union of the device's kernel, copy and set intervals
within each traced sweep's loop, summed over the completed traced sweeps
and divided by their chunks."""
from benchmark.harness import spans
from benchmark.harness import trace as trc


def read(run):
    got = spans.loops(run)
    if got is None:
        return None
    loops, chunks = got
    return 1e-6 * sum(trc.busy_ns(run.trace.device, s, t) for _, s, t in loops) / chunks
