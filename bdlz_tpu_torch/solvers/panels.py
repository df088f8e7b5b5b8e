"""Spectral panel quadrature for the y-integral (framework layer L4).

Counterpart of ``bdlz_tpu/solvers/panels.py``, batched over a leading
point axis.  A composite Gauss–Legendre rule — ``N_PANELS_DEFAULT``
equal-width panels of ``NODES_PER_PANEL_DEFAULT`` nodes over the clipped
support [y_lo, y_hi] — with the panel edge nearest each analytic
breakpoint SNAPPED onto it: the e^y clamp edge at −50, the KJMA washout
turn-on y = ln(6/I_p), and the T = m/3 branch seam (a jump in n_eq and
v̄), snapped last so that the seam wins a contended edge.  560 integrand
evaluations per point reach the 8000-node trapezoid's converged value.

The Gauss–Legendre nodes and weights are scheme constants built once with
host NumPy (bitwise equal to the JAX package's) and shipped to the device
as float64.  Edges are elementwise ``where`` arithmetic per point, with no
host sync.  The population audit that decides when the rule may replace
the trapezoid is ``bdlz_tpu_torch.validation.panel_gl_population_audit``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bdlz_tpu_torch import sanitize
from bdlz_tpu_torch.backend import F64
from bdlz_tpu_torch.config import PointParams

#: 28 panels × 20 Gauss–Legendre nodes = 560 integrand evaluations per
#: point (the JAX package's default scheme).
N_PANELS_DEFAULT: int = 28
NODES_PER_PANEL_DEFAULT: int = 20

#: The reference kernel's e^y clamp edge — A/V is constant in y below it.
Y_CLAMP_EDGE: float = -50.0

#: Numerator of the KJMA washout turn-on, e^y ≈ 6/I_p (γ₄ → 6).
WASHOUT_GAMMA4_SUP: float = 6.0


class PanelScheme(NamedTuple):
    """One fixed-shape composite Gauss–Legendre rule: the per-panel rule on
    [−1, 1] as (n_nodes,) float64 tensors, and the panel count."""

    n_panels: int
    nodes: torch.Tensor
    weights: torch.Tensor

    @property
    def n_quad_nodes(self) -> int:
        return int(self.n_panels) * int(self.nodes.shape[0])


def make_panel_scheme(
    device,
    n_panels: int = N_PANELS_DEFAULT,
    n_nodes: int = NODES_PER_PANEL_DEFAULT,
) -> PanelScheme:
    """Build the composite rule: Gauss–Legendre nodes and weights from
    host NumPy, shipped to ``device``."""
    n_panels = int(n_panels)
    n_nodes = int(n_nodes)
    if n_panels < 1 or n_nodes < 2:
        raise ValueError(
            f"panel scheme needs n_panels >= 1 and n_nodes >= 2, got "
            f"({n_panels}, {n_nodes})"
        )
    x, w = np.polynomial.legendre.leggauss(n_nodes)
    return PanelScheme(
        n_panels=n_panels,
        nodes=torch.as_tensor(x, dtype=F64, device=device),
        weights=torch.as_tensor(w, dtype=F64, device=device),
    )


def y_washout_turn_on(I_p: torch.Tensor) -> torch.Tensor:
    """y where the KJMA suppression turns on: e^y ≈ 6/I_p."""
    return torch.log(WASHOUT_GAMMA4_SUP / torch.clamp_min(I_p, 1e-30))


def y_branch_seam(pp: PointParams) -> torch.Tensor:
    """y of the T = m/3 statistics seam, per point."""
    from bdlz_tpu_torch.physics.percolation import y_of_T

    return y_of_T(pp.m_chi_GeV / 3.0, pp.T_p_GeV, pp.beta_over_H)


def panel_edges(
    pp: PointParams, y_lo: torch.Tensor, y_hi: torch.Tensor, n_panels: int
) -> torch.Tensor:
    """The (P, n_panels + 1) snapped panel edges.

    Uniform edges over [y_lo, y_hi]; for each breakpoint strictly inside
    the window the nearest interior edge moves onto it (at most half a
    panel, which keeps the edges sorted).  The 1e-30 span floor only keeps
    an empty window's division finite; the caller discards its result.
    """
    n_panels = int(n_panels)
    span = torch.clamp_min(y_hi - y_lo, 1e-30)
    h = span / n_panels
    j = torch.arange(n_panels + 1, dtype=torch.int64, device=y_lo.device)
    edges = y_lo[:, None] + h[:, None] * j
    if n_panels < 2:
        # a single panel has no interior edge to snap
        return edges
    seam = y_branch_seam(pp)
    wash = y_washout_turn_on(pp.I_p)
    clampe = torch.full_like(y_lo, Y_CLAMP_EDGE)
    for b in (clampe, wash, seam):
        idx = torch.clamp(torch.round((b - y_lo) / h), 1, n_panels - 1).to(torch.int32)
        inside = (b > y_lo) & (b < y_hi)
        snap = (j == idx[:, None]) & inside[:, None]
        edges = torch.where(snap, b[:, None], edges)
    return edges


def panel_nodes(
    pp: PointParams, y_lo: torch.Tensor, y_hi: torch.Tensor, scheme: PanelScheme
):
    """``(ys, wts)``, each (P, n_panels·n_nodes): ``sum(wts · f(ys))`` is the
    composite estimate of ∫ f dy.  Zero-width panels contribute exactly 0
    through their zero half-widths."""
    edges = panel_edges(pp, y_lo, y_hi, scheme.n_panels)
    half = 0.5 * (edges[:, 1:] - edges[:, :-1])
    mid = 0.5 * (edges[:, 1:] + edges[:, :-1])
    ys = mid[:, :, None] + half[:, :, None] * scheme.nodes
    wts = half[:, :, None] * scheme.weights
    n = ys.shape[1] * ys.shape[2]
    return ys.reshape(-1, n), wts.reshape(-1, n)


def integrate_YB_panel_gl(
    pp: PointParams,
    chi_stats: str,
    aux,
    scheme: "PanelScheme | None" = None,
    tabulated: bool = True,
) -> torch.Tensor:
    """Comoving baryon yield Y_B per point by snapped-panel Gauss–Legendre;
    (P,).

    Same support clips, inverse map and integrand as the trapezoid paths
    (``solvers/quadrature.py``); only the nodes and the contraction
    change.  ``aux`` is the device ``KJMATable`` when ``tabulated`` (the
    sweep's path), else the ``KJMAGrid`` of the direct integrand.  An empty
    clipped window gives exactly 0.
    """
    from bdlz_tpu_torch.solvers.quadrature import (
        quadrature_bounds,
        yb_integrand_direct,
        yb_integrand_tabulated,
    )

    if scheme is None:
        scheme = make_panel_scheme(pp.m_chi_GeV.device)
    y_lo, y_hi = quadrature_bounds(pp)
    ys, wts = panel_nodes(pp, y_lo, y_hi, scheme)
    if tabulated:
        integrand = yb_integrand_tabulated(ys, pp, chi_stats, aux)
    else:
        integrand = yb_integrand_direct(ys, pp, chi_stats, aux)
    YB = (wts * integrand).sum(dim=-1)
    sanitize.checkpoint(sanitize.BOUNDARY_SOLVER, Y_B=YB)
    return torch.where(y_hi > y_lo, YB, 0.0)
