"""points_per_s: the points of every sweep completed in the window over the
time from the first sweep's start to the last completed sweep's end (host
clock; each sweep ends when ``run_sweep`` has returned its host outputs).
A sweep cut off by the window's close counts for nothing."""


def read(run):
    done = [r for r in run.records if not r.cut and r.error is None]
    if not done:
        return None
    return sum(r.request.n_points for r in done) / (done[-1].end - run.records[0].start)
