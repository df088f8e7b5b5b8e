"""setup_s: from the harness's start to the end of the warm sweep: the
imports, the CUDA context, the kernels' build or load, one sweep of the
cell's shapes (host clock)."""


def read(run):
    return run.setup_s
