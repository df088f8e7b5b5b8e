"""Reference of the bounce_lz_dephased deployment: P per point from the
configuration's potential, shot again here, through the dephased
Landau-Zener transport at the rate of a thermal bath at the point's T_p.

The profile is the one ``bounce.shoot`` samples: its release point and
dense pass, then n_xi samples of Delta = g_Delta (phi(xi + r_wall) - phi_mid)
over +-halfwidth/mu, with the mixing m_mix0 at every sample.  Each point's
rate is Gamma_phi(T_p) = 2 eta T_p (1 - e^(-omega_c/T_p)) and its P the
transport of ``bloch.py`` at (v_w, Gamma_phi); the yields follow from P as
in every cell.

Departures from the program's scheme: none in the mathematics.  The
program composes the segments' 3x3 maps by a pairwise tree and builds
them from unit quaternions; this file applies complex 2x2 propagators'
adjoints to the Bloch vector one segment after the other, which differs
by rounding only.  A rate of 0 (T_p <= 0) is refused here; the program
takes the coherent path there, and the cell's temperatures are positive.
"""
from __future__ import annotations

import math
from typing import Mapping

import numpy as np

from benchmark.reference import bloch, bounce, yields


def wall_profile(potential: Mapping, solver: Mapping, dtype=np.float64):
    """(xi, delta, mix) of the shot bounce of ``potential`` as
    ``bounce.shoot`` samples it, in ``dtype``."""
    t = dtype
    lam4, v, eps = float(potential["lam4"]), float(potential["vev"]), float(potential["eps"])
    b = bounce.shoot(potential, solver, dtype=t)
    rho, phi = bounce.dense_profile(b.phi0, lam4, v, eps, rho0=solver["rho0"],
                                    rho_max=solver["rho_max"], n_dense=solver["n_dense"],
                                    dtype=t)
    phi_false, _top, phi_true = bounce.vacua(lam4, v, eps)
    phi_mid = t(0.5 * (phi_true + phi_false))
    half = t(float(solver["xi_halfwidth_walls"]) / (0.5 * v * math.sqrt(lam4)))
    xi = np.linspace(-half, half, int(solver["n_xi"])).astype(t)
    delta = t(potential["g_delta"]) * (np.interp(xi + t(b.r_wall), rho, phi).astype(t) - phi_mid)
    return xi, delta, np.full_like(xi, t(potential["m_mix0"]))


def expected(config, request, idx, *, scheme, dtype, device, cache, table_dtype=None,
             shoot_dtype=np.float64):
    """Y_B, Y_chi and DM_over_B at the points ``idx`` of ``request``'s grid.
    The shoot and the profile run in ``shoot_dtype`` (kept in ``cache``);
    the rates, the transport and the yields in ``dtype``."""
    kw = request.kwargs
    yields.refuse_unmodelled(kw, also=("bounce", "lz_method"))
    yc = config["yields_config"]
    if yc.get("lz_mode") != "thermal" or kw.get("lz_method", "local") != "local":
        raise ValueError("the reference models the thermal scenario's dephased transport only")
    pot = kw["bounce"]
    key = ("profile", tuple(sorted(pot.items())), shoot_dtype)
    if key not in cache:
        cache[key] = wall_profile(pot, config["solver"], dtype=shoot_dtype)
    xi, delta, mix = cache[key]
    inputs = yields.point_inputs(yc, request.axes, idx)
    gamma = bloch.bath_rate(inputs["T_p_GeV"], yc["lz_bath_eta"], yc["lz_bath_omega_c"],
                            dtype=yields.dtype_np(dtype))
    inputs["P_chi_to_B"] = bloch.probability(xi, delta, mix, inputs["v_w"], gamma, dtype=dtype,
                                             device=device)
    return yields.yields_at(inputs, None, yc, kw, scheme=scheme, dtype=dtype, device=device,
                            cache=cache, table_dtype=table_dtype)
