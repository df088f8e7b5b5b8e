"""dephase_kernel_share: the dephased transport passes that ran the hand
kernel, the program's spans ``lz.dephase`` (inside the completed traced
sweeps) that hold at least one ``lz.dephase.kernel`` span, over all such
``lz.dephase`` spans.  1 where every pass launches the kernel, 0 where
none does (a program without it); None without a traced pass."""
from benchmark.harness import spans


def read(run):
    got = spans.windows(run)
    if got is None:
        return None
    passes = spans.named(run, "lz.dephase", got[0])
    if not passes:
        return None
    launched = spans.named(run, "lz.dephase.kernel", [(s, t) for _, s, t in passes])
    hit = sum(1 for _, s, t in passes if any(s <= ks and kt <= t for _, ks, kt in launched))
    return hit / len(passes)
