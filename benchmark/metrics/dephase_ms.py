"""dephase_ms: host ms per sweep inside the program's span ``lz.dephase``
(each dephased transport pass, one rate's speeds turned into host P),
summed over the completed traced sweeps and divided by their number."""
from benchmark.harness import spans


def read(run):
    return spans.per_sweep_ms(run, "lz.dephase")
