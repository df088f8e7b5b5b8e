"""Reference of the equal_mass deployment: the archived point with a fixed P."""
from __future__ import annotations

from benchmark.reference import yields


def expected(config, request, idx, *, scheme, dtype, device, cache, table_dtype=None,
             shoot_dtype=None):
    """Y_B, Y_chi and DM_over_B at the points ``idx`` of ``request``'s grid
    (``shoot_dtype`` has nothing to shoot here)."""
    yields.refuse_unmodelled(request.kwargs)
    inputs = yields.point_inputs(config["yields_config"], request.axes, idx)
    return yields.yields_at(inputs, None, config["yields_config"], request.kwargs, scheme=scheme,
                            dtype=dtype, device=device, cache=cache, table_dtype=table_dtype)
