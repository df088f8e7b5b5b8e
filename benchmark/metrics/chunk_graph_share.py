"""chunk_graph_share: replays of the kernel engine's captured chunk step
per chunk, the program's spans ``chunk.replay`` inside ``sweep.loop`` over
the completed traced sweeps' chunks.  1 where every chunk replays the
graph, 0 where the loop ran but no chunk did (an eager engine, or a
program without the graph); None without a traced loop."""
from benchmark.harness import spans


def read(run):
    got = spans.loops(run)
    if got is None:
        return None
    loops, chunks = got
    return len(spans.named(run, "chunk.replay", [(lo, hi) for _, lo, hi in loops])) / chunks
