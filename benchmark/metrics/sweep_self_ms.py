"""sweep_self_ms: host ms per sweep inside the program's span ``sweep``
that none of its child spans covers (the sweep's length minus the union
of the program's other spans inside it), over the completed traced
sweeps: what the spans leave unnamed."""
from benchmark.harness import spans
from benchmark.harness import trace as trc


def read(run):
    got = spans.windows(run)
    if got is None:
        return None
    sweeps = spans.named(run, "sweep", got[0])
    if not sweeps:
        return None
    children = [iv for iv in run.trace.host if iv[0] in spans.PROGRAM and iv[0] != "sweep"]
    self_ns = sum((t - s) - trc.busy_ns(children, s, t) for _, s, t in sweeps)
    return 1e-6 * self_ns / len(got[1])
