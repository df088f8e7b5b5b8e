"""Plain reference of the yield pipeline, written from the published equations.

Per point: the thermodynamics at T(y) = T_p / sqrt(1 + 2y/(beta/H)), the
KJMA area-to-volume kernel through its F(y) table, the Gaussian source
window, the y-quadrature of S_B / (s H T) |dT/dy| over the clipped window,
the nonthermal Y_chi, and today's densities and their ratio.  The scheme
is the configuration's: the z-integral on linspace(0, 30, 1200) by the
trapezoid, the F table over y in [-50, 50] at ``table_nodes`` nodes read
by 4-point Lagrange interpolation, and the y-integral by the n_y-node
trapezoid or by the snapped 28 x 20 Gauss-Legendre panel rule.

Plain PyTorch on any device and in any float dtype (the control runs it
in float32), a block of points at a time.  It imports nothing of the
program under test and takes nothing the program made: the table, the
grid and every per-point intermediate are worked out here again.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

ZETA3 = 1.202056903159594
MPL_GEV = 1.220890e19
HUBBLE_COEFF = 1.66
S0_M3 = 2891.0 * 1e6
GEV_TO_KG = 1.78266192e-27
M_PROTON_KG = 1.67262192369e-27

Y_CLAMP = 50.0            # e^y clamp and the hard A/V = 0 cut above it
Y_NEG_CUT, Y_POS_CUT = -80.0, 50.0
Z_MAX, N_Z = 30.0, 1200
N_Y_FLOOR = 2000
N_PANELS, NODES_PER_PANEL = 28, 20

#: Per-point inputs, in the order of the sweep's point parameters.
FIELDS = ("m_chi_GeV", "g_chi", "T_p_GeV", "beta_over_H", "v_w", "I_p", "g_star",
          "g_star_s", "P_chi_to_B", "source_shape_sigma_y", "incident_flux_scale",
          "Y_chi_init", "m_B_kg", "T_max_over_Tp", "T_min_over_Tp")

#: The sweep axes the reference works out: the configuration's keys, as the
#: sweep CLI names its axes (``m_B_GeV`` sets the baryon mass in kg).
AXES = tuple(f for f in FIELDS if f != "m_B_kg") + ("m_B_GeV",)

#: ``run_sweep`` keyword arguments that choose how the same numbers are
#: computed, not which: the reference reads the sizes and ignores the rest.
SAME_RESULT = frozenset({"chunk_size", "n_y", "table_nodes", "impl", "fuse_exp", "reduce",
                         "overlap_chunks"})


def refuse_unmodelled(kwargs: Mapping, also=()) -> None:
    """Raise for a request whose keyword arguments change the physics
    beyond what the calling reference models (``also``)."""
    unknown = sorted(set(kwargs) - SAME_RESULT - set(also))
    if unknown:
        raise ValueError(f"the reference models no {unknown}")


def point_inputs(yields_config: Mapping, axes: Mapping[str, np.ndarray],
                 idx=None) -> Dict[str, np.ndarray]:
    """The per-point inputs of a product grid over ``axes`` (C order, the
    first axis slowest) at the configuration's other values; with ``idx``
    only at those flat indices of the grid."""
    c = yields_config
    if not str(c["regime"]).lower().startswith("nontherm"):
        raise ValueError("the reference covers the nonthermal regime only")
    if c.get("sigma_v_chi_GeV_m2") or c.get("Gamma_wash_over_H") or c.get(
            "deplete_DM_from_source"):
        raise ValueError("the reference covers no annihilation, washout or depletion")
    unknown = set(axes) - set(AXES)
    if unknown:
        raise ValueError(f"the reference sweeps no axis {sorted(unknown)}")
    values = [np.asarray(v, dtype=np.float64) for v in axes.values()]
    shape = tuple(len(v) for v in values)
    flat = np.arange(int(np.prod(shape))) if idx is None else np.asarray(idx)
    cols = [v[i] for v, i in zip(values, np.unravel_index(flat, shape))]
    y_init = c.get("Y_chi_init")
    base = {f: c[f] for f in FIELDS if f in c}
    base.update({
        "P_chi_to_B": c["P_chi_to_B"] if c.get("P_chi_to_B") is not None else 0.0,
        "Y_chi_init": 1.0e-12 if y_init is None else y_init,
        "m_B_kg": M_PROTON_KG if c.get("m_B_GeV") is None else c["m_B_GeV"] * GEV_TO_KG,
    })
    out = {f: np.full(flat.shape[0], float(base[f]), dtype=np.float64) for f in FIELDS}
    for name, col in zip(axes.keys(), cols):
        if name == "m_B_GeV":
            out["m_B_kg"] = col * GEV_TO_KG
        else:
            out[name] = col
    return out


def window_bounds(T_p, beta_over_H, T_max_over_Tp, T_min_over_Tp):
    """The clipped y-window (y_lo, y_hi) of each point, with
    y(T) = (beta/H)/2 ((T_p/T)^2 - 1); works on arrays and tensors."""
    lib = torch if torch.is_tensor(T_p) else np

    def y_of_T(T):
        return 0.5 * beta_over_H * ((T_p / lib.maximum(T, T * 0 + 1e-30)) ** 2 - 1.0)

    y_lo = lib.maximum(y_of_T(T_max_over_Tp * T_p), T_p * 0 + Y_NEG_CUT)
    y_hi = lib.minimum(y_of_T(T_min_over_Tp * T_p), T_p * 0 + Y_POS_CUT)
    return y_lo, y_hi


class FTable:
    """F(y) = int_0^30 z^2 e^-z exp(-(I_p/6) e^y gamma4(z)) dz on a uniform
    y-grid over [-50, 50], built from the z-integral."""

    def __init__(self, I_p: float, n: int, dtype, device, build_dtype=None):
        build = dtype if build_dtype is None else build_dtype
        z = torch.linspace(0.0, Z_MAX, N_Z, dtype=torch.float64, device=device).to(build)
        ez = torch.exp(-z)
        gamma4 = 6.0 - ez * (z ** 3 + 3.0 * z ** 2 + 6.0 * z + 6.0)
        weight = z * z * ez
        ys = torch.linspace(-Y_CLAMP, Y_CLAMP, n, dtype=torch.float64, device=device).to(build)
        vals = []
        for lo in range(0, n, 2048):
            e = torch.exp(ys[lo:lo + 2048])[:, None]
            f = weight * torch.exp(-(I_p / 6.0) * e * gamma4)
            vals.append(torch.trapezoid(f, z, dim=-1))
        self.values = torch.cat(vals).to(dtype)
        self.n = n
        self.inv_dy = (n - 1) / (2.0 * Y_CLAMP)

    def __call__(self, y):
        t = (torch.clamp(y, -Y_CLAMP, Y_CLAMP) + Y_CLAMP) * self.inv_dy
        i = torch.clamp(torch.floor(t), 1, self.n - 3)
        s = t - i
        i = i.long()
        v = self.values
        f_m1, f_0, f_1, f_2 = v[i - 1], v[i], v[i + 1], v[i + 2]
        return (-(s * (s - 1.0) * (s - 2.0)) / 6.0 * f_m1
                + ((s + 1.0) * (s - 1.0) * (s - 2.0)) / 2.0 * f_0
                - ((s + 1.0) * s * (s - 2.0)) / 2.0 * f_1
                + ((s + 1.0) * s * (s - 1.0)) / 6.0 * f_2)


def _n_eq_and_speed(T, m, g, fermion: bool):
    """Equilibrium density and mean speed, relativistic above T = m/3."""
    c_rel = g * (3.0 * ZETA3 / (4.0 * math.pi ** 2) if fermion else ZETA3 / math.pi ** 2)
    rel = T > m / 3.0
    n_rel = c_rel * T ** 3
    n_mb = g * (m / (2.0 * math.pi)) ** 1.5 * T ** 1.5 * torch.exp(-m / torch.clamp_min(T, 1e-30))
    speed = torch.sqrt(torch.clamp_min(8.0 * T / (math.pi * torch.clamp_min(m, 1e-20)), 0.0))
    return torch.where(rel, n_rel, n_mb), torch.where(rel, torch.ones_like(T), speed)


def _integrand(y, c, table: FTable, fermion: bool):
    """dY_B/dy at nodes ``y`` (R, N) for point columns ``c`` (R, 1)."""
    B = torch.clamp_min(c["beta_over_H"], 1e-30)
    d = torch.clamp_min(1.0 + 2.0 * y / B, 1e-12)
    T = c["T_p_GeV"] / torch.sqrt(d)
    dTdy = (c["T_p_GeV"] / B) * d ** (-1.5)
    H = HUBBLE_COEFF * torch.sqrt(c["g_star"]) * T * T / MPL_GEV
    s = (2.0 * math.pi ** 2 / 45.0) * c["g_star_s"] * T ** 3
    n_eq, speed = _n_eq_and_speed(T, c["m_chi_GeV"], c["g_chi"], fermion)
    J = c["incident_flux_scale"] * 0.25 * n_eq * speed
    H_p = HUBBLE_COEFF * torch.sqrt(c["g_star"]) * c["T_p_GeV"] ** 2 / MPL_GEV
    beta = c["beta_over_H"] * H_p
    av = (c["I_p"] / 2.0) * (beta / torch.clamp_min(c["v_w"], 1e-12)) \
        * torch.exp(torch.clamp(y, -Y_CLAMP, Y_CLAMP)) * table(y)
    av = torch.where(y > Y_CLAMP, torch.zeros_like(av), av)
    window = torch.exp(-0.5 * (y / torch.clamp_min(c["source_shape_sigma_y"], 1e-6)) ** 2)
    return c["P_chi_to_B"] * J * av * window / (s * H * T) * dTdy


def _trapezoid_nodes(y_lo, y_hi, n_y: int):
    i = torch.arange(n_y, dtype=y_lo.dtype, device=y_lo.device)
    y = y_lo[:, None] + i * ((y_hi - y_lo) / (n_y - 1))[:, None]
    y[:, -1] = y_hi
    w = torch.full_like(y, 1.0)
    w[:, 0] = 0.5
    w[:, -1] = 0.5
    return y, w * ((y_hi - y_lo) / (n_y - 1))[:, None]


def _panel_nodes(c, y_lo, y_hi):
    """28 equal panels over the window, the edge nearest each breakpoint
    strictly inside it (the e^y clamp edge -50, the KJMA turn-on ln(6/I_p),
    then the T = m/3 seam) moved onto it; 20 Gauss-Legendre nodes each."""
    x, w = np.polynomial.legendre.leggauss(NODES_PER_PANEL)
    x = torch.as_tensor(x, device=y_lo.device).to(y_lo.dtype)
    w = torch.as_tensor(w, device=y_lo.device).to(y_lo.dtype)
    h = torch.clamp_min(y_hi - y_lo, 1e-30) / N_PANELS
    j = torch.arange(N_PANELS + 1, device=y_lo.device)
    edges = y_lo[:, None] + h[:, None] * j.to(y_lo.dtype)
    seam = 0.5 * c["beta_over_H"][:, 0] * (
        (c["T_p_GeV"][:, 0] / torch.clamp_min(c["m_chi_GeV"][:, 0] / 3.0, 1e-30)) ** 2 - 1.0)
    turn_on = torch.log(6.0 / torch.clamp_min(c["I_p"][:, 0], 1e-30))
    for b in (torch.full_like(y_lo, -Y_CLAMP), turn_on, seam):
        k = torch.clamp(torch.round((b - y_lo) / h), 1, N_PANELS - 1).long()
        inside = (b > y_lo) & (b < y_hi)
        edges = torch.where((j == k[:, None]) & inside[:, None], b[:, None], edges)
    half = 0.5 * (edges[:, 1:] - edges[:, :-1])
    mid = 0.5 * (edges[:, 1:] + edges[:, :-1])
    y = (mid[:, :, None] + half[:, :, None] * x).reshape(y_lo.shape[0], -1)
    wts = (half[:, :, None] * w).reshape(y_lo.shape[0], -1)
    return y, wts


def yields(inputs: Mapping[str, np.ndarray], *, chi_stats: str, n_y: int, scheme: str,
           table: FTable, dtype=torch.float64, device="cpu",
           block: int = 2048) -> Dict[str, np.ndarray]:
    """Y_B, Y_chi and DM_over_B of each point (host float64 arrays).

    ``scheme`` is the y-quadrature the program reports it ran: "trap"
    (the n_y-node trapezoid, n_y floored at 2000) or "panel_gl"; ``table``
    is the F table of the points' one I_p."""
    fermion = str(chi_stats).lower().startswith("ferm")
    n = inputs["m_chi_GeV"].shape[0]
    Y_B = np.empty(n)
    for lo in range(0, n, block):
        c = {f: torch.as_tensor(inputs[f][lo:lo + block], device=device).to(dtype)[:, None]
             for f in FIELDS}
        y_lo, y_hi = window_bounds(c["T_p_GeV"][:, 0], c["beta_over_H"][:, 0],
                                   c["T_max_over_Tp"][:, 0], c["T_min_over_Tp"][:, 0])
        if scheme == "trap":
            y, w = _trapezoid_nodes(y_lo, y_hi, max(int(n_y), N_Y_FLOOR))
        elif scheme == "panel_gl":
            y, w = _panel_nodes(c, y_lo, y_hi)
        else:
            raise ValueError(f"unknown y-quadrature {scheme!r}")
        yb = (w * _integrand(y, c, table, fermion)).sum(dim=-1)
        yb = torch.where(y_hi > y_lo, yb, torch.zeros_like(yb))
        Y_B[lo:lo + block] = yb.to(torch.float64).cpu().numpy()
    Y_chi = inputs["Y_chi_init"].astype(dtype_np(dtype)).astype(np.float64)
    rho_B = (Y_B * S0_M3 * inputs["m_B_kg"]).astype(dtype_np(dtype))
    rho_DM = (Y_chi * S0_M3 * (inputs["m_chi_GeV"] * GEV_TO_KG)).astype(dtype_np(dtype))
    tiny = np.finfo(dtype_np(dtype)).tiny
    ratio = rho_DM / np.maximum(rho_B, tiny)
    return {"Y_B": Y_B, "Y_chi": Y_chi, "DM_over_B": ratio.astype(np.float64)}


def dtype_np(dtype):
    return {torch.float64: np.float64, torch.float32: np.float32}[dtype]


def yields_at(inputs: Mapping[str, np.ndarray], idx, yields_config: Mapping, kwargs: Mapping,
              *, scheme: str, dtype, device, cache: dict,
              table_dtype=None) -> Dict[str, np.ndarray]:
    """:func:`yields` at the points ``idx`` of ``inputs`` (all of them for
    None) at the sizes of the request's keyword arguments ``kwargs``
    (``n_y``, ``table_nodes``), with one F table per (I_p, nodes, dtype,
    device) kept in ``cache``; ``table_dtype`` builds the table in another
    type than the rest (one control keeps the table's z-integral in float64)."""
    sub = inputs if idx is None else {f: np.asarray(inputs[f])[idx] for f in FIELDS}
    if np.unique(sub["I_p"]).size != 1:
        raise ValueError("the reference's F table is per I_p; the points sweep I_p")
    I_p = float(sub["I_p"][0])
    nodes = int(kwargs["table_nodes"])
    key = (I_p, nodes, dtype, table_dtype, str(device))
    if key not in cache:
        cache[key] = FTable(I_p, nodes, dtype, device, table_dtype)
    return yields(sub, chi_stats=yields_config["chi_stats"], n_y=int(kwargs["n_y"]),
                  scheme=scheme, table=cache[key], dtype=dtype, device=device)
