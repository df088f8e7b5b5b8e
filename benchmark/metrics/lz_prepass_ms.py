"""lz_prepass_ms: the LZ pre-pass per sweep (the bounce shoot, its profile
and the per-point P, ending in host arrays): mean SweepResult.lz_seconds
over the window's sweeps that ran one."""


def read(run):
    done = [r for r in run.records if not r.cut and r.error is None and r.lz_seconds > 0.0]
    if not done:
        return None
    return 1e3 * sum(r.lz_seconds for r in done) / len(done)
