"""dephase_passes: the program's ``lz.dephase`` spans (dephased transport
passes, one per distinct rate) per completed traced sweep."""
from benchmark.harness import spans


def read(run):
    got = spans.windows(run)
    if got is None:
        return None
    n = len(spans.named(run, "lz.dephase", got[0]))
    return n / len(got[1]) if n else None
