"""Shared LZ command-line options of the port's CLIs.

Counterpart of ``bdlz_tpu/lz/options.py``: one home for the
``--lz-profile``/``--lz-method``/``--lz-gamma-phi`` flags, ``--bounce``
and the scenario flags (``--lz-mode``/``--lz-n-levels``/``--lz-bath-eta``/
``--lz-bath-omega-c``), with the same names, dests, help and pairing
errors.  Each CLI states only its default estimator and method menu.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

#: The single-point CLI's estimator menu (no sweep-only local-momentum).
POINT_METHODS = ("coherent", "local", "dephased")
#: The sweep CLI's menu.
SWEEP_METHODS = ("local", "coherent", "local-momentum", "dephased")


def add_lz_method_flags(
    ap,
    *,
    default: Optional[str],
    choices: Sequence[str],
    method_help: str,
    include_profile: bool = True,
    profile_help: str = (
        "Bounce-profile CSV: derive each point's P_chi_to_B from its own "
        "wall speed through the LZ kernel"
    ),
) -> None:
    """Register ``[--lz-profile] --lz-method --lz-gamma-phi``.  ``default``
    None is the single-point CLI's hook-eligibility sentinel; the sweep
    CLI pins "local"."""
    if include_profile:
        ap.add_argument("--lz-profile", default=None, dest="lz_profile",
                        help=profile_help)
    ap.add_argument("--lz-method", default=default, dest="lz_method",
                    choices=tuple(choices), help=method_help)
    ap.add_argument("--lz-gamma-phi", type=float, default=0.0,
                    dest="lz_gamma_phi",
                    help="Diabatic-basis dephasing rate for --lz-method "
                         "dephased (energy units of the profile's Delta)")


def add_bounce_flag(ap) -> None:
    """Register ``--bounce``: a potential-spec JSON whose O(4) bounce is
    shot in-framework (``bdlz_tpu_torch.bounce``) in place of an
    ``--lz-profile`` CSV."""
    ap.add_argument("--bounce", default=None, dest="bounce",
                    help="Potential-spec JSON (keys lam4/vev/eps/g_delta/"
                         "m_mix0): shoot the O(4) bounce profile "
                         "in-framework from the quartic potential instead "
                         "of loading an --lz-profile CSV; the potential "
                         "fingerprint joins the sweep/artifact identity. "
                         "Mutually exclusive with --lz-profile")


def bounce_flag_error(args) -> "str | None":
    """The --bounce pairing validation (None = ok)."""
    if (
        getattr(args, "bounce", None) is not None
        and getattr(args, "lz_profile", None)
    ):
        return ("pass either --bounce or --lz-profile, not both (the "
                "bounce solver derives the profile)")
    return None


def add_lz_scenario_flags(ap) -> None:
    """Register the scenario flags; each defaults to None = keep the
    config key, and an explicit flag overrides it."""
    ap.add_argument("--lz-mode", default=None, dest="lz_mode",
                    choices=("two_channel", "chain", "thermal"),
                    help="LZ physics scenario with --lz-profile: "
                         "two_channel (the legacy chi/B kernel; "
                         "--lz-method picks the estimator), chain "
                         "(N-level banded LZ chain, arXiv:1212.2907 — "
                         "multi-species dark sectors), thermal "
                         "(finite-T oscillator-bath dephasing, "
                         "arXiv:1410.0516 — Gamma_phi derived from each "
                         "point's T_p).  Default: the config's lz_mode "
                         "key; the resolved scenario joins the "
                         "sweep/artifact identities")
    ap.add_argument("--lz-n-levels", type=int, default=None,
                    dest="lz_n_levels",
                    help="Chain levels N for --lz-mode chain (>= 2; "
                         "N=2 reduces to the coherent two-channel "
                         "kernel, pinned)")
    ap.add_argument("--lz-bath-eta", type=float, default=None,
                    dest="lz_bath_eta",
                    help="Ohmic bath coupling eta for --lz-mode thermal "
                         "(Gamma_phi = 2 eta T (1 - e^(-omega_c/T)))")
    ap.add_argument("--lz-bath-omega-c", type=float, default=None,
                    dest="lz_bath_omega_c",
                    help="Bath cutoff omega_c in GeV for --lz-mode "
                         "thermal")


def lz_flags_error(args, *, default_method: str = "coherent") -> "str | None":
    """The shared flag-pairing validation (None = valid): Γ negativity and
    the Γ↔dephased pairing, outranked by the scenario rules — a scenario
    mode owns its kernel, and a scenario parameter needs its mode."""
    from bdlz_tpu_torch.lz.kernel import gamma_phi_cli_error

    method = getattr(args, "lz_method", None)
    mode = getattr(args, "lz_mode", None)
    if mode in ("chain", "thermal"):
        if getattr(args, "lz_gamma_phi", 0.0) < 0.0:
            return "--lz-gamma-phi must be >= 0"
        if method not in (None, default_method):
            return (f"--lz-method {method} has no effect with "
                    f"--lz-mode {mode} (the scenario owns the kernel)")
        if getattr(args, "lz_gamma_phi", 0.0):
            return (f"--lz-gamma-phi has no effect with --lz-mode {mode} "
                    "(the scenario derives its own dephasing)")
    else:
        err = gamma_phi_cli_error(method or default_method,
                                  getattr(args, "lz_gamma_phi", 0.0))
        if err:
            return err
    if getattr(args, "lz_n_levels", None) is not None and mode != "chain":
        return "--lz-n-levels requires --lz-mode chain"
    if mode != "thermal" and (
        getattr(args, "lz_bath_eta", None) is not None
        or getattr(args, "lz_bath_omega_c", None) is not None
    ):
        return "--lz-bath-eta/--lz-bath-omega-c require --lz-mode thermal"
    return None


def apply_scenario_flags(cfg, args):
    """Fold explicit scenario flags over the config's lz_* keys and
    re-validate (strict)."""
    from bdlz_tpu_torch.config import validate

    overrides = {}
    for key in ("lz_mode", "lz_n_levels", "lz_bath_eta", "lz_bath_omega_c"):
        v = getattr(args, key, None)
        if v is not None:
            overrides[key] = v
    if not overrides:
        return cfg
    return validate(dataclasses.replace(cfg, **overrides), backend="gpu")
