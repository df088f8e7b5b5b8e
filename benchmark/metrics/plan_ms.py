"""plan_ms: per sweep, the host time of ``run_sweep`` outside its chunk loop
and its LZ pre-pass (the grid, the F table, the quadrature's audit, the
engine's build, the copy-out), averaged over the window's sweeps:
wall time of the call - SweepResult.seconds - SweepResult.lz_seconds."""


def read(run):
    done = [r for r in run.records if not r.cut and r.error is None]
    if not done:
        return None
    return 1e3 * sum(r.wall_s - r.seconds - r.lz_seconds for r in done) / len(done)
