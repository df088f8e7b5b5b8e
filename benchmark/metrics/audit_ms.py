"""audit_ms: host ms per sweep in the program's span ``audit`` (the
population audit of the panel rule, ``validation.resolve_quad_panel_gl``),
summed over the completed traced sweeps and divided by their number."""
from benchmark.harness import spans


def read(run):
    return spans.per_sweep_ms(run, "audit")
