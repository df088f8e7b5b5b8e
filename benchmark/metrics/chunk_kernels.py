"""chunk_kernels: device kernels per chunk that start inside the
program's span ``sweep.loop`` (copies and sets not counted), over the
completed traced sweeps and divided by their chunks."""
from benchmark.harness import spans

COPIES = ("Memcpy", "Memset")


def read(run):
    got = spans.loops(run)
    if got is None:
        return None
    loops, chunks = got
    n = sum(1 for name, s, _ in run.trace.device
            if not name.startswith(COPIES) and any(lo <= s < hi for _, lo, hi in loops))
    return n / chunks
