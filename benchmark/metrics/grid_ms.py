"""grid_ms: host ms per sweep in the program's span ``sweep.grid`` (the
flattened host grid of every point, ``build_grid``), summed over the
completed traced sweeps and divided by their number."""
from benchmark.harness import spans


def read(run):
    return spans.per_sweep_ms(run, "sweep.grid")
