"""chunk_wait_ms: host ms per chunk in the program's span ``chunk.wait``
(the host blocked on a chunk's copies back), summed over the completed
traced sweeps and divided by their chunks: near 0 while the host is
slower than the card."""
from benchmark.harness import spans


def read(run):
    return spans.per_chunk_ms(run, "chunk.wait")
