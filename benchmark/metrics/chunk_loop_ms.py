"""chunk_loop_ms: host ms per chunk of the double-buffered chunk loop,
sum of SweepResult.seconds over sum of SweepResult.chunks (the loop's
clock stops after the device synchronised)."""


def read(run):
    done = [r for r in run.records if not r.cut and r.error is None]
    chunks = sum(r.chunks for r in done)
    if not chunks:
        return None
    return 1e3 * sum(r.seconds for r in done) / chunks
