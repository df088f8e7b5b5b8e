"""dephase_device_ms: device ms per sweep inside the program's spans
``lz.dephase``: the union of the device's kernel, copy and set intervals
within each span (a pass ends in its host copy, so its device work lies
inside it), summed over the completed traced sweeps and divided by their
number."""
from benchmark.harness import spans
from benchmark.harness import trace as trc


def device_ns(run):
    """(device ns inside the ``lz.dephase`` spans, the completed traced
    sweeps' records), or None without a device trace or such spans."""
    got = spans.windows(run)
    if got is None or not run.trace.device:
        return None
    passes = spans.named(run, "lz.dephase", got[0])
    if not passes:
        return None
    return sum(trc.busy_ns(run.trace.device, s, t) for _, s, t in passes), got[1]


def read(run):
    got = device_ns(run)
    if got is None or not got[0]:
        return None
    return 1e-6 * got[0] / len(got[1])
