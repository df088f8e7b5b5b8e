"""Baryon source-term model (framework layer L3).

Counterpart of ``bdlz_tpu/physics/source.py``: only the Gaussian window
is a named function; each consumer assembles the S_B product inline in
the reference's operation order.
"""
from __future__ import annotations

import torch


def source_window(y: torch.Tensor, sigma_y) -> torch.Tensor:
    """Gaussian envelope W(y) = exp(−y²/2σ_y²) with σ_y floored at 1e-6."""
    return torch.exp(-0.5 * (y / torch.clamp_min(sigma_y, 1e-6)) ** 2)
