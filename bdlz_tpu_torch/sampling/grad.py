"""Differentiable-posterior layer: gradients, Jacobians, Fisher fields.

Counterpart of ``bdlz_tpu/sampling/grad.py``, with ``torch.autograd`` in
place of ``jax.grad``/``jacrev`` and batched functions in place of
``vmap``.  The whole Planck-likelihood path is differentiable in PyTorch:
the y-grid (``linspace_rows``' in-place last node is a tracked copy), the
panel rule's snapped edges (``where`` of differentiable breakpoints), the
``T = m/3`` branches (``where``: the taken branch's gradient), the cubic
F-table and P-table lookups and the emulator's log-space interpolation.
JAX's seam audit (``grad.py:26-59`` there) holds here as written: the
F-table values are constants in I_p, so sampling I_p is refused; the prior
box is −inf outside and its gradient is undefined on the boundary, so
parity is asserted strictly inside.

* :func:`make_logp_value_and_grad` — ``θ (W, D) → (logp (W,), ∇ (W, D))``
  from one backward pass of ``logp.sum()`` (walkers are independent rows);
* :func:`make_observable_jacobian` — ``θ → (Ω (B, 2), J (B, 2, D))`` with
  one backward pass per output row, as ``jacrev`` does, and
  :func:`planck_fisher_information` — ``F = Jᵀ Σ⁻¹ J``;
* :func:`make_ratio_and_grad` — ``d(Ω_DM/Ω_b)/dθ``;
* :func:`make_field_log10_jacobian` — ``∂log10(ρ_B, ρ_DM)/∂u`` in emulator
  axis coordinates, the Fisher-aware emulator refinement's signal;
* :func:`central_fd_grad` / :func:`gradient_parity` — the host NumPy
  finite-difference harness, sharing no code with autograd.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

from bdlz_tpu_torch.backend import F64, resolve_device
from bdlz_tpu_torch.constants import PLANCK_OMEGA_B_H2_SIGMA, PLANCK_OMEGA_DM_H2_SIGMA


def _leaf(theta, fn) -> torch.Tensor:
    """A fresh (W, D) float64 leaf that requires grad: a tensor stays on
    its device, an array goes to ``fn``'s ``.device``, else to the card."""
    if isinstance(theta, torch.Tensor):
        t = theta.detach().to(F64).clone()
    else:
        t = torch.as_tensor(np.asarray(theta, dtype=np.float64), dtype=F64,
                            device=resolve_device(getattr(fn, "device", None)))
    if t.ndim != 2:
        raise ValueError(f"theta must be a (W, D) batch, got shape {tuple(t.shape)}")
    return t.requires_grad_(True)


def _grad(out: torch.Tensor, theta: torch.Tensor, retain: bool = False) -> torch.Tensor:
    """d(out.sum())/dθ; zeros where ``out`` does not depend on θ."""
    if not out.requires_grad:
        return torch.zeros_like(theta)
    (g,) = torch.autograd.grad(out.sum(), theta, retain_graph=retain, allow_unused=True)
    return torch.zeros_like(theta) if g is None else g


def make_logp_value_and_grad(logp_fn: Callable) -> Callable:
    """``θ (W, D) → (logp (W,), ∇logp (W, D))`` of a batched logp — the
    exact pipeline or the emulator fast mode.  A walker outside the prior
    box has logp −inf and an undefined gradient; its row never reaches
    the other rows."""

    def value_and_grad(theta):
        with torch.enable_grad():
            th = _leaf(theta, logp_fn)
            lp = logp_fn(th)
            g = _grad(lp, th)
        return lp.detach(), g

    value_and_grad.device = getattr(logp_fn, "device", None)
    return value_and_grad


def central_fd_grad(fn: Callable, theta, rel_step: float = 1e-6) -> np.ndarray:
    """Host central finite differences of a batched scalar ``fn`` at one
    θ (D,): step ``h = rel_step · max(|θ_i|, 1)``, the O(h²) central rule;
    the 2D shifted points go through ``fn`` as one (2D, D) batch."""
    theta = np.asarray(theta, dtype=np.float64)
    D = theta.shape[0]
    h = np.array([rel_step * max(abs(float(t)), 1.0) for t in theta])
    pts = np.repeat(theta[None, :], 2 * D, axis=0)
    for i in range(D):
        pts[2 * i, i] += h[i]
        pts[2 * i + 1, i] -= h[i]
    vals = np.asarray(torch.as_tensor(fn(pts), dtype=F64).detach().cpu(), dtype=np.float64)
    out = np.empty(D)
    for i in range(D):
        out[i] = (float(vals[2 * i]) - float(vals[2 * i + 1])) / (2.0 * h[i])
    return out


def gradient_parity(logp_fn: Callable, theta, rel_step: float = 1e-6) -> Dict[str, Any]:
    """Autograd against central finite differences at one θ (D,):
    ``{value, grad, fd, max_rel_err}``, the error per coordinate relative
    to ``max(|fd_i|, |grad_i|, 1e-300)``."""
    theta = np.asarray(theta, dtype=np.float64)
    value, grad = make_logp_value_and_grad(logp_fn)(theta[None, :])
    grad = grad[0].detach().cpu().numpy()
    fd = central_fd_grad(logp_fn, theta, rel_step=rel_step)
    denom = np.maximum(np.maximum(np.abs(fd), np.abs(grad)), 1e-300)
    rel = np.abs(grad - fd) / denom
    return {"value": float(value[0]), "grad": grad, "fd": fd, "max_rel_err": float(rel.max())}


def make_observable_jacobian(observables_fn: Callable) -> Callable:
    """``θ (B, D) → (Ω (B, 2), J (B, 2, D))`` through a batched
    ``θ → (Ω_b h², Ω_DM h²)``, one backward pass per output row."""

    def jacobian(theta):
        with torch.enable_grad():
            th = _leaf(theta, observables_fn)
            ob, od = observables_fn(th)
            j_b = _grad(ob, th, retain=True)
            j_d = _grad(od, th)
        return torch.stack([ob, od], dim=1).detach(), torch.stack([j_b, j_d], dim=1)

    return jacobian


def planck_fisher_information(jac) -> torch.Tensor:
    """Gauss–Newton Fisher matrices ``F = Jᵀ Σ⁻¹ J`` (B, D, D) of the
    Planck Gaussian from Jacobians (B, 2, D)."""
    jac = torch.as_tensor(jac, dtype=F64)
    sigma_inv = torch.tensor([1.0 / PLANCK_OMEGA_B_H2_SIGMA**2,
                              1.0 / PLANCK_OMEGA_DM_H2_SIGMA**2],
                             dtype=F64, device=jac.device)
    return torch.einsum("bfi,f,bfj->bij", jac, sigma_inv, jac)


def make_ratio_and_grad(observables_fn: Callable) -> Callable:
    """``θ (B, D) → (Ω_DM/Ω_b (B,), d(Ω_DM/Ω_b)/dθ (B, D))``."""

    def ratio_and_grad(theta):
        with torch.enable_grad():
            th = _leaf(theta, observables_fn)
            ob, od = observables_fn(th)
            ratio = od / ob
            g = _grad(ratio, th)
        return ratio.detach(), g

    return ratio_and_grad


def make_field_log10_jacobian(
    base,
    static,
    table,
    axis_names: Sequence[str],
    axis_scales: Sequence[str],
    n_y: int = 2000,
    device=None,
) -> Callable:
    """``x (B, d) → ∂log10(ρ_B, ρ_DM)/∂u (B, 2, d)``: the exact pipeline's
    gradient field in emulator axis coordinates (``u = log10 x`` on log
    axes, ``x`` on linear ones).  A chain or thermal scenario derives P
    host-side (no gradient exists in the graph) and an I_p axis
    differentiates a table of constants: both are refused."""
    from bdlz_tpu_torch.config import point_params_from_config
    from bdlz_tpu_torch.models.yields_pipeline import point_yields_fast
    from bdlz_tpu_torch.ops.kjma_table import table_to_device
    from bdlz_tpu_torch.parallel.sweep import AXIS_MAP
    from bdlz_tpu_torch.sampling.likelihoods import _make_theta_binder

    lz_mode = getattr(static, "lz_mode", "two_channel")
    if lz_mode != "two_channel":
        raise ValueError(
            f"lz_mode={lz_mode!r} derives P host-side per point — its "
            "gradient wrt the axes does not exist in-graph, and a silent "
            "zero would mis-steer the Fisher refinement; use the "
            "curvature signal for scenario builds"
        )
    for k in axis_names:
        if k == "I_p":
            raise ValueError(
                "I_p gradients are undefined on the tabulated path (the "
                "F-table's values are constants wrt I_p); use the "
                "curvature signal for I_p boxes"
            )
        if k not in AXIS_MAP:
            raise ValueError(f"unknown axis {k!r}; valid: {sorted(AXIS_MAP)}")
    dev = resolve_device(device)
    pp0 = point_params_from_config(base, base.P_chi_to_B or 0.0)
    bind = _make_theta_binder(pp0, tuple(axis_names), (), device=dev)
    table_dev = table_to_device(table, dev)
    log_axes = torch.tensor([s == "log" for s in axis_scales], dtype=torch.bool, device=dev)
    ln10 = float(np.log(10.0))

    def log_fields(x):
        res = point_yields_fast(bind(x), static, table_dev, n_y=n_y)
        return torch.log10(res.rho_B_kg_m3), torch.log10(res.rho_DM_kg_m3)

    log_fields.device = dev
    jac_fn = make_observable_jacobian(log_fields)

    def field_jacobian(x):
        x = torch.as_tensor(x, dtype=F64, device=dev)
        _, jac = jac_fn(x)                       # d log10 f / d x
        # chain rule into the interpolation coordinate: du = dx/(x ln10)
        du = torch.where(log_axes, x * ln10, torch.ones_like(x))
        return jac * du[:, None, :]

    return field_jacobian
