"""dephase_roofline: the dephased transport's least time over its device
time in the completed traced sweeps.  The least time is the benchmark's
own frozen count (``harness/dephase_work.py``): the grid's distinct
(v_w, Gamma_phi) lanes over the profile's real segments at 79 f64
instructions a lane-segment and 17e12 a second, against the segments and
each lane's inputs and P at 3.35 TB/s.  The device time is
``dephase_device_ms``'s."""
from benchmark.harness import dephase_work
from benchmark.metrics.dephase_device_ms import device_ns


def read(run):
    got = device_ns(run)
    if got is None or not got[0]:
        return None
    ns, sweeps = got
    return 100.0 * dephase_work.least_seconds_of(sweeps, run.config) / (ns * 1e-9)
