"""chunk_step_ms: host ms per chunk in the program's span ``chunk.step``
(the engine's eager preparation, the kernel's launch and the copy back
enqueued), summed over the completed traced sweeps and divided by their
chunks."""
from benchmark.harness import spans


def read(run):
    return spans.per_chunk_ms(run, "chunk.step")
