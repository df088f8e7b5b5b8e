"""Reference of the bounce_lz deployment: P per point from the request's own
potential, shot again here, through the local Landau-Zener composition."""
from __future__ import annotations

import numpy as np

from benchmark.reference import bounce, yields


def expected(config, request, idx, *, scheme, dtype, device, cache, table_dtype=None,
             shoot_dtype=np.float64):
    """Y_B, Y_chi and DM_over_B at the points ``idx`` of ``request``'s grid.
    The shoot runs in ``shoot_dtype``; P and the yields in ``dtype``."""
    kw = request.kwargs
    yields.refuse_unmodelled(kw, also=("bounce", "lz_method"))
    if kw.get("lz_method", "local") != "local":
        raise ValueError(f"the reference models the local LZ composition, not {kw['lz_method']!r}")
    pot = kw["bounce"]
    b = bounce.shoot(pot, config["solver"], dtype=shoot_dtype)
    inputs = yields.point_inputs(config["yields_config"], request.axes, idx)
    inputs["P_chi_to_B"] = bounce.local_probability(b, pot["m_mix0"], inputs["v_w"],
                                                    dtype=yields.dtype_np(dtype))
    return yields.yields_at(inputs, None, config["yields_config"], kw, scheme=scheme,
                            dtype=dtype, device=device, cache=cache, table_dtype=table_dtype)
