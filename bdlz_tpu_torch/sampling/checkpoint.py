"""Incremental (checkpointed, resumable) chains for both samplers.

Counterpart of ``bdlz_tpu/sampling/checkpoint.py``, with its files:

* the run is cut into segments of ``checkpoint_every`` kept steps; segment
  ``k`` draws from a CPU ``torch.Generator`` seeded from ``(seed, k)`` (in
  place of JAX's ``fold_in``), so a resumed run is bitwise the
  uninterrupted one;
* after each segment ``seg_{k:05d}.npz`` stores the segment's chain slice
  and the sampler state at its end (walkers, logp, n_accept, and for NUTS
  the adapted ε and inverse mass and the cumulative counters);
* ``manifest.json`` records the run identity (``hash``), ``n_segments``
  and ``done``; a mismatched identity is discarded loudly;
* resume loads the longest prefix of loadable segments and recomputes
  from there.

The identity is JAX's payload plus the port's random stream
(``provenance.MCMC_RNG_STREAM``): JAX's threefry draws cannot be
reproduced in torch, so a chain directory of one package is refused by
the other with the "different run identity" message, never spliced.

Across processes (``parallel/multihost.py``) the coordinator reads the
manifest, validates the longest loadable prefix and broadcasts its
length; the others load that prefix from the shared directory, and only
the coordinator writes segments and the manifest.  A ``mesh`` splits the
stretch move's walkers over its members; NUTS chains stay unsharded, as
in the JAX package.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

from bdlz_tpu_torch.backend import F64


def _load_segment(seg_file):
    """(chain, logp, state) from one segment file; raises if unreadable.
    ``state`` is (walkers, logp, n_accept), and for NUTS a dict of the
    adapted step size and inverse mass and the cumulative counters."""
    with np.load(seg_file) as data:
        state = [data["walkers"], data["state_logp"], data["n_accept"].item()]
        if "nuts_step_size" in data.files:
            state.append({
                "step_size": float(data["nuts_step_size"]),
                "inv_mass": data["nuts_inv_mass"],
                "acc_sum": float(data["nuts_acc_sum"]),
                "n_logp_evals": int(data["nuts_n_logp_evals"]),
                "n_divergent": int(data["nuts_n_divergent"]),
            })
        return data["chain"], data["logp"], tuple(state)


class CheckpointedRun(NamedTuple):
    chain: np.ndarray        # (n_steps, W, D) kept states, host numpy
    logp_chain: np.ndarray   # (n_steps, W)
    acceptance: float        # accepted fraction (stretch) / mean accept
                             # probability (NUTS)
    segments: int
    resumed_segments: int
    # NUTS only: what the chain adapted to and every evaluation it paid
    # (leapfrogs, ε searches and each segment's initial re-evaluation)
    sampler: str = "stretch"
    step_size: "float | None" = None
    inv_mass: "np.ndarray | None" = None
    n_logp_evals: int = 0
    n_divergent: int = 0


def _run_hash(init_walkers, seed: int, n_steps: int, checkpoint_every: int, a: float,
              thin: int, identity, static=None, sampler=None) -> str:
    """The run identity: JAX's payload and the port's random stream."""
    from bdlz_tpu_torch.provenance import MCMC_RNG_STREAM, mcmc_segment_identity

    return mcmc_segment_identity(
        init_walkers, seed, n_steps, checkpoint_every, a, thin, identity,
        static=static, sampler=sampler, rng=MCMC_RNG_STREAM,
    ).digest(16)


def run_ensemble_checkpointed(
    seed: int,
    logp_fn: Callable,
    init_walkers,
    n_steps: int,
    out_dir: str,
    checkpoint_every: int = 100,
    a: float = 2.0,
    thin: int = 1,
    mesh=None,
    event_log=None,
    identity=None,
    static=None,
    sampler: str = "stretch",
    sampler_opts=None,
    device=None,
) -> CheckpointedRun:
    """Run (or resume) a checkpointed chain in ``out_dir``.

    Sampling semantics are :func:`run_ensemble`'s (``sampler="stretch"``)
    or :func:`run_nuts`'s (``"nuts"``; ``sampler_opts`` may set
    ``mass_matrix``/``target_accept``/``max_tree_depth``/``n_warmup``);
    where the run is cut changes no bit of the chain.  ``identity``
    fingerprints ``logp_fn`` (JSON), ``static`` is the resolved
    StaticChoices the likelihood runs with, and the resolved sampler
    spec joins the identity too: changing any of them invalidates resume
    loudly.  NUTS warms up inside segment 0 and persists the adapted
    (ε, mass) in every segment file; later segments are continuations.
    The chain runs on ``device``, else on the logp's ``.device``, else on
    the card (no card raises; pass ``device="cpu"`` for the CPU).  With a
    ``mesh`` the stretch move's walkers are split over its members (NUTS
    ignores it, as in the JAX package); across processes the coordinator
    decides the resume plan and owns the files.
    """
    from bdlz_tpu_torch.parallel.multihost import broadcast_from_coordinator, is_coordinator
    from bdlz_tpu_torch.sampling.ensemble import _sampler_device, make_generator, run_ensemble
    from bdlz_tpu_torch.utils.io import atomic_savez, atomic_write_json

    if sampler not in ("stretch", "nuts"):
        raise ValueError(f"sampler must be 'stretch' or 'nuts', got {sampler!r}")
    if sampler == "nuts":
        nuts_opts = dict(sampler_opts or {})
        unknown = set(nuts_opts) - {"mass_matrix", "target_accept", "max_tree_depth", "n_warmup"}
        if unknown:
            raise ValueError(f"unknown NUTS sampler_opts {sorted(unknown)}")
        nuts_opts.setdefault("mass_matrix", "diag")
        nuts_opts.setdefault("target_accept", 0.8)
        nuts_opts.setdefault("max_tree_depth", 8)
        nuts_opts.setdefault("n_warmup", 300)
        sampler_payload = {
            "name": "nuts",
            "mass_matrix": str(nuts_opts["mass_matrix"]),
            "target_accept": float(nuts_opts["target_accept"]),
            "max_tree_depth": int(nuts_opts["max_tree_depth"]),
            "n_warmup": int(nuts_opts["n_warmup"]),
        }
    else:
        if sampler_opts:
            raise ValueError(
                "sampler_opts only apply to sampler='nuts' (the stretch "
                "move's only knob is 'a')"
            )
        sampler_payload = None
    if mesh is not None and device is None:
        device = mesh.local_devices[0]
    device = _sampler_device(logp_fn, device)
    coordinator = is_coordinator()

    init_walkers = np.asarray(init_walkers, dtype=np.float64)
    W, D = init_walkers.shape
    if n_steps % thin:
        raise ValueError("n_steps must be divisible by thin")
    n_keep_total = n_steps // thin
    seg_keep = max(1, checkpoint_every // thin)
    n_segs = (n_keep_total + seg_keep - 1) // seg_keep

    if coordinator:
        os.makedirs(out_dir, exist_ok=True)
    manifest_path = os.path.join(out_dir, "manifest.json")
    h = _run_hash(init_walkers, seed, n_steps, checkpoint_every, a, thin, identity,
                  static=static, sampler=sampler_payload)

    # the resume plan: the coordinator reads the manifest and validates
    # the longest loadable prefix, then broadcasts its length, so that
    # no process races a coordinator still flushing the last run's files
    manifest: dict = {}
    resumed = 0
    chain_parts, logp_parts = [], []
    state = None
    if coordinator and os.path.exists(manifest_path):
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
        except Exception:  # noqa: BLE001 — an unreadable manifest resumes nothing
            manifest = {}
        if manifest.get("hash") not in (None, h):
            # a stale identity (another posterior, resolved static, sampler,
            # or the other package's random stream) is never spliced
            print(
                f"[mcmc] resume: {out_dir} was checkpointed under a "
                f"different run identity ({manifest.get('hash')} != "
                f"{h}: changed config/params/resolved static or a "
                "pre-static-identity chain); recomputing from scratch",
                file=sys.stderr,
            )
            manifest = {}
        elif manifest.get("hash") != h:
            manifest = {}
    done = set(int(i) for i in manifest.get("done", [])) if coordinator else set()
    for k in range(n_segs):
        if k not in done:
            break
        seg_file = os.path.join(out_dir, f"seg_{k:05d}.npz")
        try:
            seg_chain, seg_logp, state = _load_segment(seg_file)
            chain_parts.append(seg_chain)
            logp_parts.append(seg_logp)
        except Exception as exc:  # noqa: BLE001 — recomputed from here
            print(
                f"[mcmc] resume: segment {k} listed in manifest but "
                f"{seg_file} unreadable ({exc!r}); recomputing from here",
                file=sys.stderr,
            )
            chain_parts, logp_parts = chain_parts[:k], logp_parts[:k]
            break
        resumed += 1
    if resumed == 0:
        state = None
    resumed = int(np.asarray(broadcast_from_coordinator(np.array([resumed])))[0])
    if not coordinator:
        # the agreed prefix, from the shared checkpoint directory
        for k in range(resumed):
            seg_chain, seg_logp, state = _load_segment(os.path.join(out_dir, f"seg_{k:05d}.npz"))
            chain_parts.append(seg_chain)
            logp_parts.append(seg_logp)
    manifest["done"] = list(range(resumed))
    manifest.setdefault("hash", h)
    manifest.setdefault("n_segments", n_segs)

    nuts_state = None
    if state is None:
        walkers = torch.as_tensor(init_walkers, dtype=F64, device=device)
        logp0 = None
        n_accept = 0
    else:
        walkers = torch.as_tensor(state[0], dtype=F64, device=device)
        logp0 = torch.as_tensor(state[1], dtype=F64, device=device)
        n_accept = int(state[2])
        if len(state) > 3:
            nuts_state = state[3]
        elif sampler == "nuts" and resumed:
            raise RuntimeError(
                "checkpoint segments match the NUTS run identity but "
                "carry no NUTS state; the directory is corrupt"
            )

    for k in range(resumed, n_segs):
        keep_lo = k * seg_keep
        keep_hi = min((k + 1) * seg_keep, n_keep_total)
        steps_k = (keep_hi - keep_lo) * thin
        kept_k = keep_hi - keep_lo
        gen = make_generator(seed, k)
        nuts_extra = {}
        if sampler == "nuts":
            from bdlz_tpu_torch.sampling.nuts import run_nuts

            common = dict(
                target_accept=float(nuts_opts["target_accept"]),
                mass_matrix=str(nuts_opts["mass_matrix"]),
                max_tree_depth=int(nuts_opts["max_tree_depth"]),
                thin=thin, generator=gen, device=device,
            )
            if nuts_state is None:
                # segment 0 owns the warmup
                run = run_nuts(logp_fn, walkers, steps_k,
                               n_warmup=int(nuts_opts["n_warmup"]), **common)
                acc_sum = n_evals = n_div = 0
            else:
                run = run_nuts(logp_fn, walkers, steps_k, n_warmup=0,
                               step_size=nuts_state["step_size"],
                               inv_mass=nuts_state["inv_mass"], **common)
                acc_sum = nuts_state["acc_sum"]
                n_evals = nuts_state["n_logp_evals"]
                n_div = nuts_state["n_divergent"]
            walkers, logp0 = run.final
            seg_accept = run.acceptance
            nuts_state = {
                "step_size": run.step_size,
                "inv_mass": np.asarray(run.inv_mass),
                "acc_sum": float(acc_sum) + run.acceptance * kept_k,
                "n_logp_evals": int(n_evals) + run.n_logp_evals,
                "n_divergent": int(n_div) + run.n_divergent,
            }
            nuts_extra = {
                "nuts_step_size": np.float64(nuts_state["step_size"]),
                "nuts_inv_mass": nuts_state["inv_mass"],
                "nuts_acc_sum": np.float64(nuts_state["acc_sum"]),
                "nuts_n_logp_evals": np.int64(nuts_state["n_logp_evals"]),
                "nuts_n_divergent": np.int64(nuts_state["n_divergent"]),
            }
            seg_chain, seg_logp = run.chain, run.logp_chain
        else:
            run = run_ensemble(logp_fn, walkers, steps_k, generator=gen, a=a, thin=thin,
                               init_logp=logp0, device=device, mesh=mesh)
            walkers, logp0 = run.final.walkers, run.final.logp
            seg_accept = int(run.final.n_accept)
            n_accept += seg_accept
            seg_chain = run.chain.cpu().numpy()
            seg_logp = run.logp_chain.cpu().numpy()
        chain_parts.append(seg_chain)
        logp_parts.append(seg_logp)
        manifest["done"] = sorted(set(int(i) for i in manifest["done"]) | {k})
        if coordinator:
            # atomic: a crash mid-write leaves the previous complete segment
            atomic_savez(
                os.path.join(out_dir, f"seg_{k:05d}.npz"),
                chain=seg_chain, logp=seg_logp,
                walkers=walkers.cpu().numpy(), state_logp=logp0.cpu().numpy(),
                n_accept=np.int64(n_accept),
                **nuts_extra,
            )
            atomic_write_json(manifest_path, manifest)
        if event_log is not None:
            event_log.emit(
                "mcmc_segment_done", segment=k, steps=steps_k,
                acceptance=(seg_accept if sampler == "nuts" else seg_accept / (W * steps_k)),
            )

    chain = np.concatenate(chain_parts)
    logp_chain = np.concatenate(logp_parts)
    if sampler == "nuts":
        return CheckpointedRun(
            chain=chain,
            logp_chain=logp_chain,
            acceptance=nuts_state["acc_sum"] / n_keep_total if nuts_state else 0.0,
            segments=n_segs,
            resumed_segments=resumed,
            sampler="nuts",
            step_size=nuts_state["step_size"] if nuts_state else None,
            inv_mass=nuts_state["inv_mass"] if nuts_state else None,
            n_logp_evals=nuts_state["n_logp_evals"] if nuts_state else 0,
            n_divergent=nuts_state["n_divergent"] if nuts_state else 0,
        )
    return CheckpointedRun(
        chain=chain,
        logp_chain=logp_chain,
        acceptance=n_accept / (W * n_steps),
        segments=n_segs,
        resumed_segments=resumed,
    )
