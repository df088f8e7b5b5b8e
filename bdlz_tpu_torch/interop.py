"""Carry the JAX package's host state into the port's tensors.

The system has no weights; what crosses between the two packages is the
sweep's state: a ``PointParams`` of NumPy arrays (as
``bdlz_tpu.parallel.sweep.build_grid`` returns it) and an F(y) table.
The tests pass both through these two functions so that the two packages
compute on identical inputs.  Nothing here imports the JAX package: the
arguments are plain NumPy arrays and floats.
"""
from __future__ import annotations

import numpy as np
import torch

from bdlz_tpu_torch.backend import F64
from bdlz_tpu_torch.config import PointParams
from bdlz_tpu_torch.ops.kjma_table import KJMATable


def point_params_from_numpy(pp_np, device) -> PointParams:
    """A PointParams of (P,) float64 tensors on ``device`` from any object
    with the PointParams field names holding scalars or 1-D arrays."""
    return PointParams(*(
        torch.as_tensor(
            np.atleast_1d(np.asarray(getattr(pp_np, name), dtype=np.float64)),
            dtype=F64, device=device,
        )
        for name in PointParams._fields
    ))


def table_from_numpy(values, y0, inv_dy, I_p, device) -> KJMATable:
    """A device KJMATable holding exactly these (n,) values."""
    return KJMATable(
        y0=float(y0), inv_dy=float(inv_dy),
        values=torch.as_tensor(np.asarray(values, dtype=np.float64),
                               dtype=F64, device=device),
        I_p=float(I_p),
    )
