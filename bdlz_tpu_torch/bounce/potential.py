"""Quartic bounce potentials: validated specs with V, V′ and V″.

Counterpart of ``bdlz_tpu/bounce/potential.py`` (the port keeps its own
copy: it imports nothing of the JAX package).

The potential family (paper §6.1 / Appendix A conventions):

    V(φ) = (λ₄/8)(φ² − v²)² − (ε/2)(φ/v + 1)

— a symmetric double well tilted by the vacuum splitting ε, so
V(−v) − V(+v) ≈ ε > 0: the true vacuum sits at φ ≈ +v, the false one at
φ ≈ −v, and an O(4) bounce interpolates between them.  The two-channel
LZ data ride on the wall profile φ(ξ):

    Δ(ξ)     = g_Δ · (φ(ξ) − φ_mid)      (diabatic splitting, one crossing)
    m_mix(ξ) = m₀                        (constant off-diagonal mixing)

so the five knobs (λ₄, v, ε, g_Δ, m₀) fully determine the profile the
shooting solver derives and hence the conversion probability P — they
are the "potential-space axes" of docs/scenarios.md.

Everything here is host-side spec plumbing except :func:`potential_V`,
:func:`potential_dV` and :func:`_d2V`, which are written with plain
arithmetic operators only, so that they evaluate floats, NumPy arrays
and tensors alike; ``csrc/bounce_shoot.cu`` writes the same expressions
in the same order.
"""
from __future__ import annotations

import hashlib
import math
from typing import Any, NamedTuple, Union

import numpy as np

#: Reference potential (the archived-P calibration point, see
#: :func:`reference_potential`): λ₄ and v place the thin-wall scale at
#: μR = 3σμ/ε = 10 with ε = 0.05, comfortably inside the thin-wall
#: regime the validation gate's closed-form S₄ check assumes.
REFERENCE_LAMBDA4 = 0.5
REFERENCE_VEV = 1.0
REFERENCE_EPSILON = 0.05
REFERENCE_G_DELTA = 1.0
#: Wall speed the archived ``P_chi_to_B`` is reproduced at (the
#: benchmark config's v_w; validation.bounce_audit pins the value).
REFERENCE_V_WALL = 0.3
#: Archived reference conversion probability (`bench.py` benchmark
#: config / seed `yields_out.json`) — the bounce gate's target.
REFERENCE_P_CHI_TO_B = 0.14925839040304145
#: Mixing m₀ calibrated so the SHOT reference profile reproduces
#: REFERENCE_P_CHI_TO_B at v_w = REFERENCE_V_WALL through the local LZ
#: composition: m₀ = sqrt(λ_req · v_w · |Δ'(ξ*)|) with
#: λ_req = −ln(1 − P)/(2π) and Δ'(ξ*) measured on the numerically
#: solved wall (close to, but not exactly, the thin-wall kink slope
#: g_Δ·v·μ — the 3/ρ friction steepens the wall by O(1/μR)).
#: Recorded to full float64 precision; validation.bounce_audit breaks
#: LOUDLY if the solver's P drifts from the archived value.
REFERENCE_M_MIX0 = 0.05179183501529559


class PotentialSpec(NamedTuple):
    """One point in potential space (all quantities in GeV powers)."""

    lam4: float     # quartic coupling λ₄ > 0
    vev: float      # vacuum scale v > 0 [GeV]
    eps: float      # vacuum splitting ε > 0 [GeV⁴]
    g_delta: float  # Δ(ξ) coupling g_Δ > 0 [GeV³ per GeV of φ]
    m_mix0: float   # constant off-diagonal mixing m₀ ≥ 0 [GeV]


class PotentialError(ValueError):
    """Raised for invalid or degenerate potential specs."""


def potential_V(phi, lam4, vev, eps):
    """V(φ) — plain operators only."""
    q = phi * phi - vev * vev
    return 0.125 * lam4 * q * q - 0.5 * eps * (phi / vev + 1.0)


def potential_dV(phi, lam4, vev, eps):
    """V′(φ) — the shooting ODE's force term (same dual-use contract)."""
    return 0.5 * lam4 * phi * (phi * phi - vev * vev) - 0.5 * eps / vev


def _d2V(phi, lam4, vev):
    return 0.5 * lam4 * (3.0 * phi * phi - vev * vev)


def validate_potential(spec: PotentialSpec) -> PotentialSpec:
    """Validate knobs the way the lz knobs are validated: typed, loud.

    Checks are host-side and cheap: positivity/finiteness of every knob,
    plus the structural requirement that the tilted well still HAS two
    minima and a barrier (ε below the spinodal ~ λ₄v⁴/(3√3)) — a spec
    past the spinodal has no bounce and must fail here, not as a
    non-converged shoot.
    """
    spec = PotentialSpec(*(float(x) for x in spec))
    for name, val in zip(spec._fields, spec):
        if not math.isfinite(val):
            raise PotentialError(f"potential knob {name} must be finite, got {val!r}")
    if spec.lam4 <= 0.0:
        raise PotentialError(f"lam4 must be > 0, got {spec.lam4!r}")
    if spec.vev <= 0.0:
        raise PotentialError(f"vev must be > 0, got {spec.vev!r}")
    if spec.eps <= 0.0:
        raise PotentialError(
            f"eps must be > 0 (degenerate vacua have no bounce), got {spec.eps!r}"
        )
    if spec.g_delta <= 0.0:
        raise PotentialError(f"g_delta must be > 0, got {spec.g_delta!r}")
    if spec.m_mix0 < 0.0:
        raise PotentialError(f"m_mix0 must be >= 0, got {spec.m_mix0!r}")
    vacua(spec)  # raises PotentialError if the vacuum structure collapsed
    return spec


def vacua(spec: PotentialSpec) -> "tuple[float, float, float]":
    """(φ_false, φ_top, φ_true): the three real roots of V′, by Newton.

    Seeds −v / 0 / +v converge to the false vacuum, the barrier top and
    the true vacuum respectively while the well structure exists; past
    the spinodal a root merges with the barrier and the curvature checks
    below fire a :class:`PotentialError`.
    """
    lam4, v, eps = float(spec.lam4), float(spec.vev), float(spec.eps)
    roots = []
    for seed in (-v, 0.0, v):
        x = seed
        for _ in range(100):
            f = potential_dV(x, lam4, v, eps)
            fp = _d2V(x, lam4, v)
            if fp == 0.0:
                break
            step = f / fp
            x -= step
            if abs(step) < 1e-15 * max(1.0, abs(x)):
                break
        roots.append(x)
    phi_false, phi_top, phi_true = roots
    if not (phi_false < phi_top < phi_true):
        raise PotentialError(
            f"vacuum structure collapsed for {spec}: eps is past the spinodal "
            f"(need eps < lam4*vev^4/(3*sqrt(3)) ≈ "
            f"{lam4 * v**4 / (3.0 * math.sqrt(3.0)):.6g}); "
            f"roots=({phi_false:.6g}, {phi_top:.6g}, {phi_true:.6g})"
        )
    if not (
        _d2V(phi_false, lam4, v) > 0.0
        and _d2V(phi_true, lam4, v) > 0.0
        and _d2V(phi_top, lam4, v) < 0.0
    ):
        raise PotentialError(
            f"degenerate extrema for {spec}: the barrier has merged with a "
            f"vacuum (eps too large for lam4*vev^4)"
        )
    if not potential_V(phi_true, lam4, v, eps) < potential_V(phi_false, lam4, v, eps):
        raise PotentialError(
            f"no decay direction for {spec}: V(phi_true) is not below V(phi_false)"
        )
    return phi_false, phi_top, phi_true


# ---------------------------------------------------------------------------
# thin-wall closed forms (the analytic limit the validation gate pins)


def wall_width_mu(spec: PotentialSpec) -> float:
    """μ = (v/2)√λ₄ — inverse wall thickness of the ε→0 kink
    φ(ξ) = −v·tanh(μξ)."""
    return 0.5 * float(spec.vev) * math.sqrt(float(spec.lam4))


def wall_tension(spec: PotentialSpec) -> float:
    """σ = ∫dφ √(2V₀) = (2/3)√λ₄·v³ for the untilted well."""
    return (2.0 / 3.0) * math.sqrt(float(spec.lam4)) * float(spec.vev) ** 3


def thin_wall_radius(spec: PotentialSpec) -> float:
    """R = 3σ/ε — the O(4) critical-bubble radius (Coleman)."""
    return 3.0 * wall_tension(spec) / float(spec.eps)


def thin_wall_action(spec: PotentialSpec) -> float:
    """S₄ = 27π²σ⁴/(2ε³) — the closed-form thin-wall Euclidean action."""
    return 27.0 * math.pi**2 * wall_tension(spec) ** 4 / (2.0 * float(spec.eps) ** 3)


# ---------------------------------------------------------------------------
# identity + IO


def potential_fingerprint(spec: Union[PotentialSpec, str, dict]) -> str:
    """Stable identity of a potential for sweep/artifact hashing.

    Mirrors ``lz.sweep_bridge.profile_fingerprint``: sha256 over the
    float64 bytes of the five knobs, truncated to 16 hex chars.  The
    fingerprint identifies the POTENTIAL — the derived profile's own
    array-level fingerprint (``lz_profile``) rides alongside it in every
    identity, so solver-knob drift still changes an identity loudly.
    """
    spec = as_potential_spec(spec)
    h = hashlib.sha256()
    h.update(np.asarray(list(spec), dtype=np.float64).tobytes())
    return h.hexdigest()[:16]


def as_potential_spec(obj: Any) -> PotentialSpec:
    """Coerce a spec / mapping / JSON path into a validated spec."""
    if isinstance(obj, PotentialSpec):
        return validate_potential(obj)
    if isinstance(obj, str):
        return load_potential_json(obj)
    if isinstance(obj, dict):
        extra = set(obj) - set(PotentialSpec._fields)
        missing = set(PotentialSpec._fields) - set(obj)
        if extra or missing:
            raise PotentialError(
                f"potential mapping must have exactly the keys "
                f"{PotentialSpec._fields}; missing={sorted(missing)} "
                f"unknown={sorted(extra)}"
            )
        return validate_potential(PotentialSpec(**{k: float(v) for k, v in obj.items()}))
    raise PotentialError(
        f"cannot interpret {type(obj).__name__!r} as a potential spec "
        f"(want PotentialSpec, dict, or JSON path)"
    )


def load_potential_json(path: str) -> PotentialSpec:
    """Load a spec from the ``--bounce`` JSON file format."""
    import json

    try:
        with open(path, "r", encoding="utf-8") as f:
            payload = json.load(f)
    except (OSError, ValueError) as e:
        raise PotentialError(f"{path}: cannot read potential JSON: {e}") from e
    if not isinstance(payload, dict):
        raise PotentialError(f"{path}: potential JSON must be an object")
    return as_potential_spec(payload)


def write_potential_json(path: str, spec: PotentialSpec, durable: bool = False) -> None:
    """Archive a spec (atomic via utils.io; round-trips through
    :func:`load_potential_json` exactly — floats serialize via repr)."""
    from bdlz_tpu_torch.utils.io import atomic_write_json

    spec = validate_potential(spec)
    atomic_write_json(path, dict(spec._asdict()), durable=durable, indent=2)


def reference_potential() -> PotentialSpec:
    """The archived-P calibration point (the bounce gate's subject).

    λ₄, v, ε put the wall at μR = 10 (thin-wall regime); g_Δ and the
    recorded m₀ make the SHOT profile's single crossing reproduce the
    archived ``P_chi_to_B`` at v_w = 0.3 through the local LZ
    composition — see REFERENCE_M_MIX0's calibration note.
    """
    return PotentialSpec(
        lam4=REFERENCE_LAMBDA4,
        vev=REFERENCE_VEV,
        eps=REFERENCE_EPSILON,
        g_delta=REFERENCE_G_DELTA,
        m_mix0=REFERENCE_M_MIX0,
    )
