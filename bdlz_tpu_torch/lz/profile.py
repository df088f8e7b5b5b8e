"""Bounce-profile ingestion for the Landau–Zener kernels.

Counterpart of ``bdlz_tpu/lz/profile.py``.  A profile samples, along the
wall coordinate ξ, the diabatic splitting Δ(ξ) between the χ and B
channels and their mixing m_mix(ξ).  Accepted column schemas (header row
required, names case-insensitive):

* ``xi, delta, m_mix``   — the splitting and mixing directly;
* ``xi, m11, m22, m12``  — mass-matrix entries, Δ = m11 − m22, m_mix = m12.

All quantities in GeV (ξ in GeV⁻¹).  Profiles live on the host as NumPy
arrays: parsing and crossing finding are not on the hot path, and the
kernels ship the arrays to the device they run on.  The JAX package
prefers its native C++ CSV parser; the port parses with NumPy, whose
float parsing is the same correctly rounded conversion.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class BounceProfile(NamedTuple):
    """Sampled two-channel profile along the wall coordinate."""

    xi: np.ndarray      # wall coordinate, strictly increasing [GeV^-1]
    delta: np.ndarray   # diabatic splitting Δ(ξ) = m_χχ − m_BB [GeV]
    mix: np.ndarray     # off-diagonal mixing m_mix(ξ) [GeV]


class ProfileError(ValueError):
    """Raised for malformed profile files."""


def _read_csv(path: str):
    """(column_names, data[rows, cols]) — the native C++ parser
    (``bdlz_tpu_torch.native``) when it builds here, NumPy otherwise;
    both give the same bits."""
    from bdlz_tpu_torch.native import NativeParseError, read_csv_native

    try:
        return read_csv_native(path)
    except NativeParseError as e:
        raise ProfileError(str(e)) from e  # uniform parse-failure contract
    except OSError:
        return read_csv_numpy(path)  # library unavailable


def read_csv_numpy(path: str):
    """(column_names, data[rows, cols]) with NumPy's ``genfromtxt``."""
    data = np.genfromtxt(path, delimiter=",", names=True, dtype=float)
    if data.dtype.names is None:
        raise ProfileError(f"{path}: expected a CSV header row")
    names = list(data.dtype.names)
    table = np.column_stack([np.atleast_1d(np.asarray(data[n], float)) for n in names])
    return names, table


def load_profile_csv(path: str) -> BounceProfile:
    raw_names, table = _read_csv(path)
    if table.ndim != 2 or table.shape[0] < 1:
        raise ProfileError(f"{path}: no data rows")
    names = {n.lower(): i for i, n in enumerate(raw_names)}

    def col(key: str) -> np.ndarray:
        return np.atleast_1d(table[:, names[key]].astype(float))

    if "xi" not in names:
        raise ProfileError(f"{path}: missing required column 'xi' (has {list(names)})")
    xi = col("xi")
    if xi.size < 2:
        raise ProfileError(
            f"{path}: need at least 2 profile samples, got {xi.size} "
            f"(data row 1 is the only sample — the kernel needs at least "
            f"one ξ segment)"
        )
    bad = np.flatnonzero(np.diff(xi) <= 0)
    if bad.size:
        # strictly increasing ξ is the kernels' segment contract: name the
        # first offending data row (1-based, header excluded)
        i = int(bad[0])
        raise ProfileError(
            f"{path}: xi must be strictly increasing; data row {i + 2} "
            f"(xi={xi[i + 1]!r}) does not increase past data row {i + 1} "
            f"(xi={xi[i]!r})"
        )

    if "delta" in names and "m_mix" in names:
        delta, mix = col("delta"), col("m_mix")
    elif all(k in names for k in ("m11", "m22", "m12")):
        delta = col("m11") - col("m22")
        mix = col("m12")
    else:
        raise ProfileError(
            f"{path}: columns must be (xi, delta, m_mix) or (xi, m11, m22, m12); "
            f"got {list(names)}"
        )
    if not (np.all(np.isfinite(delta)) and np.all(np.isfinite(mix))):
        raise ProfileError(f"{path}: non-finite profile values")
    return BounceProfile(xi=xi, delta=delta, mix=mix)


def write_profile_csv(
    path: str,
    profile: BounceProfile,
    schema: str = "delta",
    durable: bool = False,
) -> None:
    """Archive a profile as CSV, re-ingestable bit for bit (``repr`` is the
    shortest float64 round-trip form).

    ``schema`` ``"delta"`` writes ``xi, delta, m_mix``; ``"matrix"``
    writes ``xi, m11, m22, m12`` with m11 = Δ/2, m22 = −Δ/2, m12 = m_mix
    (halving and re-summing a float64 is exact).  The write is atomic.
    """
    from bdlz_tpu_torch.utils.io import atomic_write_text

    if schema not in ("delta", "matrix"):
        raise ProfileError(
            f"write_profile_csv schema must be 'delta' or 'matrix', got {schema!r}"
        )
    xi = np.asarray(profile.xi, dtype=np.float64)
    delta = np.asarray(profile.delta, dtype=np.float64)
    mix = np.asarray(profile.mix, dtype=np.float64)
    if not (xi.shape == delta.shape == mix.shape) or xi.ndim != 1:
        raise ProfileError(
            f"profile arrays must be 1-D and same-length; got shapes "
            f"xi={xi.shape} delta={delta.shape} mix={mix.shape}"
        )
    lines = []
    # .tolist() gives Python floats, whose repr is the round-trip form
    if schema == "delta":
        lines.append("xi,delta,m_mix")
        for x, d, m in zip(xi.tolist(), delta.tolist(), mix.tolist()):
            lines.append(f"{x!r},{d!r},{m!r}")
    else:
        lines.append("xi,m11,m22,m12")
        for x, d, m in zip(xi.tolist(), delta.tolist(), mix.tolist()):
            half = d / 2.0
            lines.append(f"{x!r},{half!r},{(-half)!r},{m!r}")
    atomic_write_text(path, "\n".join(lines) + "\n", durable=durable)


class Crossings(NamedTuple):
    """Level crossings Δ(ξ*) = 0 located in a profile (host-side arrays)."""

    xi_star: np.ndarray   # crossing positions
    slope: np.ndarray     # dΔ/dξ at each crossing
    mix: np.ndarray       # m_mix interpolated at each crossing


def find_crossings(profile: BounceProfile) -> Crossings:
    """Locate sign changes of Δ(ξ) by linear interpolation between samples."""
    d, xi, mix = profile.delta, profile.xi, profile.mix
    sign_change = np.flatnonzero(d[:-1] * d[1:] < 0.0)
    exact_zero = np.flatnonzero((d[:-1] == 0.0) & (d[1:] != 0.0))
    idx = np.unique(np.concatenate([sign_change, exact_zero]))

    dxi = xi[idx + 1] - xi[idx]
    dd = d[idx + 1] - d[idx]
    frac = np.where(dd != 0.0, -d[idx] / np.where(dd == 0.0, 1.0, dd), 0.0)
    xi_star = xi[idx] + frac * dxi
    slope = np.where(dxi != 0.0, dd / np.where(dxi == 0.0, 1.0, dxi), 0.0)
    mix_star = mix[idx] + frac * (mix[idx + 1] - mix[idx])
    return Crossings(xi_star=xi_star, slope=slope, mix=mix_star)
