"""Planck comparison and the settling-factor diagnostic (paper §7).

Counterpart of ``bdlz_tpu/analysis.py``:

* the settling factor f_settle = (ρ_DM/ρ_b)_Planck / (ρ_DM/ρ_b)_raw
  (paper Eq. 23);
* the effective conversion probability P_eff = P / f_settle (Eq. 24).

Both are pure functions of Python floats, NumPy arrays or tensors, so they
serve a single CLI point and a sweep's outputs alike.
"""
from __future__ import annotations

from typing import Any, Dict

from bdlz_tpu_torch.constants import PLANCK_DM_OVER_B

Array = Any


def _div(a, b):
    """Division with IEEE semantics for plain Python scalars too
    (x/0 → signed inf, 0/0 → nan), as arrays and tensors have."""
    if hasattr(a, "dtype") or hasattr(b, "dtype"):
        return a / b
    try:
        return a / b
    except ZeroDivisionError:
        if a == 0:
            return float("nan")
        return float("inf") if (a > 0) == (b >= 0) else float("-inf")


def settling_factor(ratio_raw: Array, planck_ratio: float = PLANCK_DM_OVER_B) -> Array:
    """f_settle = (Ω_DM/Ω_b)_Planck / (Ω_DM/Ω_b)_raw; inf for a zero raw
    ratio, NaN propagates."""
    return _div(planck_ratio, ratio_raw)


def effective_probability(
    P_chi_to_B: Array, ratio_raw: Array, planck_ratio: float = PLANCK_DM_OVER_B
) -> Array:
    """P_eff = P·(ratio_raw/ratio_Planck) = P / f_settle."""
    return P_chi_to_B * ratio_raw / planck_ratio


def planck_comparison(
    dm_over_b: Array,
    P_chi_to_B: Array,
    planck_ratio: float = PLANCK_DM_OVER_B,
) -> Dict[str, Array]:
    """The §7 diagnostic block for scalar or batched pipeline outputs."""
    f = settling_factor(dm_over_b, planck_ratio)
    return {
        "ratio_raw": dm_over_b,
        "ratio_planck": planck_ratio,
        "f_settle": f,
        "P_eff": effective_probability(P_chi_to_B, dm_over_b, planck_ratio),
    }
