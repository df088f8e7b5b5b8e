"""The emulator's query: log-space tensor-grid interpolation, batched.

Counterpart of ``bdlz_tpu/emulator/grid.py``.  Queries are ``(B, d)``
float64 parameter vectors in config-schema units, axis order the
artifact's ``axis_names``.  Values are interpolated multilinearly in
log10 of the stored field over the (non-uniform) per-axis nodes, each
axis's fraction taken in its own scale coordinate (log10 for ``"log"``
axes).  The JAX package vmaps a one-point kernel; here the leading batch
axis is written out: per axis one ``torch.searchsorted(..., right=True)``
and a clamp, then the 2^d corner weights and gathers, each a tensor
operation over the whole batch, and ``10 ** acc``.  The operations and
their order are the JAX kernel's.  This is plain PyTorch: the JAX
package computes it in XLA, not in a Pallas kernel.

Every ``make_*_fn`` takes a single-domain artifact or a seam-split bundle; a
bundle evaluates every domain's stencil and routes each query to the
domain that holds it with a ``where`` fold (:func:`select_domains`), so
a contained query's answer is bit for bit the one its domain gives
alone.  The tables go to the device once, when the function is made.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from bdlz_tpu_torch.backend import F64, resolve_device
from bdlz_tpu_torch.emulator.artifact import EmulatorArtifact


def domain_artifacts(artifact) -> Tuple[EmulatorArtifact, ...]:
    """The single-domain artifacts behind ``artifact``: itself, or a
    bundle's ordered domains."""
    domains = getattr(artifact, "domains", None)
    if domains is not None:
        return tuple(domains)
    return (artifact,)


def artifact_hull(artifact) -> Tuple[np.ndarray, np.ndarray]:
    """(lo, hi) corner vectors of the artifact's box (a bundle's union)."""
    return artifact.hull


def error_floor(artifact) -> float:
    """0 for a converged build; +inf otherwise, so that an active error
    gate sends every query of an unverified surface to the exact path."""
    return 0.0 if artifact.manifest.get("converged") is True else float("inf")


def has_error_grid(artifact) -> bool:
    """True when every domain carries a per-cell predicted-error grid."""
    return all(d.predicted_error is not None for d in domain_artifacts(artifact))


def axis_coord(x, scale: str):
    """The interpolation coordinate of axis values: log10 for ``"log"``
    axes (a power law is linear there), the value itself for ``"lin"``.
    Takes a tensor or a NumPy array."""
    if scale != "log":
        return x
    return torch.log10(x) if isinstance(x, torch.Tensor) else np.log10(x)


class DomainTable(NamedTuple):
    """One domain's tables on a device."""

    nodes: Tuple[torch.Tensor, ...]     # (n_k,) strictly increasing
    coords: Tuple[torch.Tensor, ...]    # the nodes in their scale coordinate
    scales: Tuple[str, ...]
    log_values: Dict[str, torch.Tensor]  # field -> (n_1, ..., n_d) log10


def device_tables(artifact: EmulatorArtifact, fields: Sequence[str], device) -> DomainTable:
    """The one host → device ship of a domain: nodes, their scale
    coordinates and log10 of the requested fields, computed on the host
    so every device interpolates the same table."""
    nodes_np = [np.asarray(a, dtype=np.float64) for a in artifact.axis_nodes]
    return DomainTable(
        nodes=tuple(torch.as_tensor(a, dtype=F64, device=device) for a in nodes_np),
        coords=tuple(torch.as_tensor(axis_coord(a, s), dtype=F64, device=device)
                     for a, s in zip(nodes_np, artifact.axis_scales)),
        scales=tuple(artifact.axis_scales),
        log_values={
            name: torch.as_tensor(
                np.log10(np.asarray(artifact.values[name], dtype=np.float64)),
                dtype=F64, device=device)
            for name in fields
        },
    )


def _brackets(thetas: torch.Tensor, nodes: Sequence[torch.Tensor]):
    """Per axis: the query clamped into the node range and the index of
    its bracketing interval, clamped to [0, n_k − 2]."""
    out = []
    for k, nodes_k in enumerate(nodes):
        x = torch.minimum(torch.maximum(thetas[:, k], nodes_k[0]), nodes_k[-1]).contiguous()
        i = torch.searchsorted(nodes_k, x, right=True) - 1
        out.append((x, i.clamp(0, nodes_k.shape[0] - 2)))
    return out


def _flat_index(idx: Sequence[torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    flat = idx[0]
    for i, n in zip(idx[1:], shape[1:]):
        flat = flat * n + i
    return flat


def interp_log_fields(thetas: torch.Tensor, table: DomainTable) -> Dict[str, torch.Tensor]:
    """log10 of every field of ``table`` at the ``(B, d)`` queries.

    Coordinates are clamped into the box (domain policy is the caller's,
    through :func:`in_domain`); multilinear over the 2^d cell corners in
    log10 of the values, each axis's fraction in its scale coordinate."""
    d = len(table.nodes)
    idx, frac = [], []
    for k, (x, i) in enumerate(_brackets(thetas, table.nodes)):
        u = axis_coord(x, table.scales[k])
        u0, u1 = table.coords[k][i], table.coords[k][i + 1]
        idx.append(i)
        frac.append((u - u0) / (u1 - u0))
    shape = [n.shape[0] for n in table.nodes]
    strides = [int(np.prod(shape[k + 1:], dtype=np.int64)) for k in range(d)]
    # corner c (bit k = upper node on axis k) has weight
    # ((f_0 · f_1) · f_2) · …, each f_k the fraction or its complement: the
    # JAX kernel's product order, with the shared prefixes computed once
    weights = {0: None}
    for k in range(d):
        lower, upper = 1.0 - frac[k], frac[k]
        weights = {c | (bit << k): (f if w is None else w * f)
                   for c, w in weights.items() for bit, f in ((0, lower), (1, upper))}
    w_all = torch.stack([weights[c] for c in range(1 << d)])
    offsets = torch.as_tensor(
        [sum(((c >> k) & 1) * strides[k] for k in range(d)) for c in range(1 << d)],
        dtype=idx[0].dtype, device=thetas.device)
    flat_idx = _flat_index(idx, shape)[None, :] + offsets[:, None]   # (2^d, B)
    out: Dict[str, torch.Tensor] = {}
    for name, logv in table.log_values.items():
        terms = w_all * logv.reshape(-1)[flat_idx]
        acc = terms[0]
        for t in terms[1:]:  # the corners summed in order
            acc = acc + t
        out[name] = acc
    return out


def in_domain(thetas: torch.Tensor, nodes: Sequence[torch.Tensor]) -> torch.Tensor:
    """True where every coordinate of a ``(B, d)`` query lies in the box."""
    ok = torch.ones(thetas.shape[0], dtype=torch.bool, device=thetas.device)
    for k, nodes_k in enumerate(nodes):
        ok = ok & (thetas[:, k] >= nodes_k[0]) & (thetas[:, k] <= nodes_k[-1])
    return ok


def predicted_error(thetas: torch.Tensor, nodes: Sequence[torch.Tensor],
                    error_grid: torch.Tensor, floor: float) -> torch.Tensor:
    """The persisted predicted relative error of the cell each query
    lands in (the interpolation's own bracketing), floored at ``floor``."""
    idx = [i for _, i in _brackets(thetas, nodes)]
    cells = [n.shape[0] - 1 for n in nodes]
    val = error_grid.reshape(-1)[_flat_index(idx, cells)]
    return torch.clamp_min(val, floor)


def in_domain_one(theta: torch.Tensor, nodes: Sequence[torch.Tensor]) -> torch.Tensor:
    """True iff every coordinate of one ``(d,)`` query lies in the box (0-d)."""
    return in_domain(theta[None, :], nodes)[0]


def predicted_error_one(theta: torch.Tensor, nodes: Sequence[torch.Tensor],
                        error_grid: torch.Tensor, floor: float) -> torch.Tensor:
    """:func:`predicted_error` of one ``(d,)`` query (0-d)."""
    return predicted_error(theta[None, :], nodes, error_grid, floor)[0]


def domain_error_table(dom: EmulatorArtifact, device) -> Tuple[torch.Tensor, float]:
    """(error grid on the device, floor) of one domain; a domain without
    a grid has a zero grid at its floor."""
    floor = error_floor(dom)
    if dom.predicted_error is None:
        grid = np.zeros(tuple(len(n) - 1 for n in dom.axis_nodes))
    else:
        grid = np.asarray(dom.predicted_error, dtype=np.float64)
    return torch.as_tensor(grid, dtype=F64, device=device), floor


def select_domains(thetas, tables, eval_fn):
    """The multi-domain routing rule: ``eval_fn(table, thetas) ->
    (payload_tuple, inside)`` per domain, folded by ``where`` — the first
    domain's payload is the out-of-domain default, later domains
    overwrite where they hold the query.  Domains are disjoint, so at
    most one select fires.  Returns ``(payload_tuple, inside_any)``."""
    out, inside_any = None, None
    for table in tables:
        payload, inside = eval_fn(table, thetas)
        if out is None:
            out, inside_any = list(payload), inside
        else:
            out = [torch.where(inside, p, o) for p, o in zip(payload, out)]
            inside_any = inside_any | inside
    return tuple(out), inside_any


def _as_queries(thetas, device) -> torch.Tensor:
    t = torch.as_tensor(thetas, dtype=F64, device=device)
    if t.ndim != 2:
        raise ValueError(f"queries must be a (B, d) array, got shape {tuple(t.shape)}")
    return t


def make_query_fn(artifact, field: str = "DM_over_B", device=None) -> Callable:
    """``query(thetas (B, d)) -> values (B,)`` on ``device`` (the card
    unless the caller asks for the CPU).  A query outside every domain
    returns the first domain's edge-clamped value; mask it with
    :func:`make_domain_fn`."""
    dev = resolve_device(device)
    doms = domain_artifacts(artifact)
    for dom in doms:
        if field not in dom.values:
            raise KeyError(f"field {field!r} not in artifact (has {sorted(dom.values)})")
    tables = [device_tables(d, (field,), dev) for d in doms]

    def eval_fn(table, thetas):
        val = torch.pow(10.0, interp_log_fields(thetas, table)[field])
        return (val,), in_domain(thetas, table.nodes)

    def query(thetas) -> torch.Tensor:
        (val,), _ = select_domains(_as_queries(thetas, dev), tables, eval_fn)
        return val

    return query


def make_domain_fn(artifact, device=None) -> Callable:
    """``in_domain(thetas (B, d)) -> bool (B,)``: for a bundle, True iff
    some domain holds the query (the seam band holds none)."""
    dev = resolve_device(device)
    all_nodes = [device_tables(d, (), dev).nodes for d in domain_artifacts(artifact)]

    def eval_fn(nodes, thetas):
        return (), in_domain(thetas, nodes)

    def domain(thetas) -> torch.Tensor:
        _, inside = select_domains(_as_queries(thetas, dev), all_nodes, eval_fn)
        return inside

    return domain


def make_error_fn(artifact, device=None) -> Callable:
    """``predicted_error(thetas (B, d)) -> err (B,)``: the per-cell
    estimate of the cell each query lands in, floored at
    :func:`error_floor`, routed to the containing domain as
    :func:`make_query_fn` routes values."""
    dev = resolve_device(device)
    tables = [(device_tables(d, (), dev).nodes, domain_error_table(d, dev))
              for d in domain_artifacts(artifact)]

    def eval_fn(table, thetas):
        nodes, (grid, floor) = table
        return (predicted_error(thetas, nodes, grid, floor),), in_domain(thetas, nodes)

    def error(thetas) -> torch.Tensor:
        (err,), _ = select_domains(_as_queries(thetas, dev), tables, eval_fn)
        return err

    return error


def host_table(axis_nodes, axis_scales, log_values: Dict[str, Any]) -> DomainTable:
    """A CPU :class:`DomainTable` over host arrays already in log10 (the
    build's interim surface)."""
    nodes_np = [np.asarray(a, dtype=np.float64) for a in axis_nodes]
    return DomainTable(
        nodes=tuple(torch.from_numpy(a) for a in nodes_np),
        coords=tuple(torch.as_tensor(axis_coord(a, s), dtype=F64)
                     for a, s in zip(nodes_np, axis_scales)),
        scales=tuple(axis_scales),
        log_values={k: torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=F64)
                    for k, v in log_values.items()},
    )
