"""f_table_ms: host ms per sweep in the program's span ``f_table`` (the
NumPy F table, ``ops/kjma_table.make_f_table``, wherever a sweep builds
it), summed over the completed traced sweeps and divided by their number."""
from benchmark.harness import spans


def read(run):
    return spans.per_sweep_ms(run, "f_table")
