"""Config system (framework layer L5), the port's own copy.

Counterpart of ``bdlz_tpu/config.py``: the same fields, defaults and
strict merge (a JSON file is merged *over* the defaults, an unknown key
is a hard error), the same ``validate`` rejections, and the same
``PointParams`` / ``StaticChoices`` split.  In the port a batched
``PointParams`` holds (P,) float64 tensors where the JAX package vmapped
over scalars.

Fields that only modules not yet ported read (serving, sampling, LZ
scenarios, robustness knobs) are kept, so that every config the JAX
package accepts loads here unchanged.  ``write_template`` and ``config_identity_dict``
come with the port of the single-point CLI.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional

from bdlz_tpu_torch.constants import GEV_TO_KG, M_PROTON_KG

VALID_ODE_METHODS = ("sdirk4", "kvaerno3")
VALID_TENANT_ROUTING = ("scenario", "hash")
VALID_POSTERIOR_WEIGHTS = ("planck",)
VALID_REFINE_SIGNALS = ("fisher", "traffic", "traffic*planck")
VALID_SAMPLERS = ("stretch", "nuts")
VALID_MASS_MATRICES = ("diag", "dense")
VALID_LZ_MODES = ("two_channel", "chain", "thermal")


class ConfigError(ValueError):
    """Raised for unknown keys or invalid field values."""


@dataclass(frozen=True)
class Config:
    """One parameter point of the yields pipeline (reference
    `first_principles_yields.py:44-79` plus the framework extensions;
    see ``bdlz_tpu/config.py`` for what each extension knob does)."""

    # Microphysics / DM
    m_chi_GeV: float = 0.95
    g_chi: int = 2
    chi_stats: str = "fermion"
    regime: str = "nonthermal"
    sigma_v_chi_GeV_m2: float = 0.0

    # Transition / percolation inputs
    T_p_GeV: float = 100.0
    beta_over_H: float = 100.0
    v_w: float = 0.30
    I_p: float = 0.34

    # Effective relativistic dof (assumed constant over the window)
    g_star: float = 106.75
    g_star_s: float = 106.75

    # Source normalisation / shape
    P_chi_to_B: Optional[float] = None
    source_shape_sigma_y: float = 15.0
    Gamma_wash_over_H: float = 0.0

    # Incident flux scaling and optional DM depletion
    incident_flux_scale: float = 1.0
    deplete_DM_from_source: bool = False

    # Integration window
    T_max_over_Tp: float = 5.0
    T_min_over_Tp: float = 1e-3

    # Nonthermal initial condition
    Y_chi_init: Optional[float] = 4.90e-10
    n_chi_at_Tp_GeV3: Optional[float] = None

    # ---- framework extensions (absent => reference behavior) ----
    backend: str = "numpy"
    m_B_GeV: Optional[float] = None
    n_y: int = 8000
    ode_reference_step_cap: bool = True
    ode_method: str = "sdirk4"
    ode_rtol: float = 1e-8
    ode_atol: float = 1e-17
    ode_auto_h0: Optional[bool] = None
    ode_pi_controller: Optional[bool] = None
    ode_tabulated_av: Optional[bool] = None
    quad_panel_gl: Optional[bool] = None
    # robustness / fault injection
    fault_injection: Optional[bool] = None
    fault_plan: Optional[str] = None
    retry_enabled: Optional[bool] = None
    retry_max_attempts: int = 3
    retry_backoff_s: float = 0.05
    # serving fleet and health plane
    n_replicas: Optional[int] = None
    queue_bound: Optional[int] = None
    health_enabled: Optional[bool] = None
    breaker_window: int = 8
    breaker_threshold: float = 0.5
    breaker_cooldown_s: float = 1.0
    breaker_latency_slo_s: Optional[float] = None
    rollback_budget: float = 0.1
    # multi-tenant plane
    tenant_routing: Optional[str] = None
    memory_budget_bytes: Optional[int] = None
    autoscale_interval_s: float = 5.0
    pool_min_replicas: int = 1
    # closed-loop delivery
    self_improve: Optional[bool] = None
    drift_gated_rate: float = 0.05
    rebuild_budget: int = 1
    # provenance cache
    cache_enabled: Optional[bool] = None
    cache_root: Optional[str] = None
    # emulator seams and gating
    seam_split: Optional[bool] = None
    error_gate_tol: "Optional[bool | float]" = None
    posterior_weight: Optional[str] = None
    # LZ scenario plane
    lz_mode: str = "two_channel"
    lz_n_levels: int = 2
    lz_bath_eta: float = 0.0
    lz_bath_omega_c: float = 0.0
    # MCMC sampler
    sampler: str = "stretch"
    mass_matrix: str = "diag"
    target_accept: float = 0.8
    refine_signal: Optional[str] = None


def default_config() -> Dict[str, Any]:
    """Defaults as a plain dict (the template payload), reference :291-301."""
    return {f.name: f.default for f in dataclasses.fields(Config)}


def config_from_dict(raw: Dict[str, Any]) -> Config:
    """Merge ``raw`` over the defaults; unknown keys are a hard error."""
    base = default_config()
    unknown = sorted(set(raw) - set(base))
    if unknown:
        raise ConfigError(
            f"Unknown config key(s) {unknown}; valid keys are {sorted(base)}"
        )
    base.update(raw)
    return Config(**base)


def load_config(path: str) -> Config:
    """Load a yields_config JSON file (reference :303-307 semantics)."""
    with open(path, "r", encoding="utf-8") as f:
        raw = json.load(f)
    return config_from_dict(raw)


def needs_ode_path(cfg: Config) -> bool:
    """True when the fast quadrature is invalid and the ODE path runs
    (the reference's ``can_quad`` guard, :372, negated)."""
    return (
        cfg.deplete_DM_from_source
        or cfg.sigma_v_chi_GeV_m2 != 0.0
        or cfg.Gamma_wash_over_H != 0.0
    )


def _fraction(cfg: Config, name: str, closed_top: bool = True) -> None:
    v = getattr(cfg, name)
    ok = 0.0 < v <= 1.0 if closed_top else 0.0 < float(v) < 1.0
    if not ok:
        span = "(0, 1]" if closed_top else "(0, 1)"
        raise ConfigError(f"{name} must be a fraction in {span}, got {v!r}")


def validate(cfg: Config, backend: Optional[str] = None) -> Config:
    """Reject field values the reference trusts or crashes on — the same
    rejections as ``bdlz_tpu.config.validate``.

    An unknown ``regime`` (e.g. ``"auto"``) is rejected on every device
    backend, and on the NumPy backend whenever the quadrature path would
    run (the reference crashes there, :376-384).  ``backend`` is the
    effective backend; it defaults to the config's own key.
    """
    from bdlz_tpu_torch.backend import is_device_backend

    r = cfg.regime.lower()
    if not (r.startswith("therm") or r.startswith("non")):
        backend = cfg.backend if backend is None else backend
        if is_device_backend(backend) or not needs_ode_path(cfg):
            raise ConfigError(
                f"regime={cfg.regime!r} is not supported here: use 'thermal' "
                "or 'nonthermal'. (The reference's quadrature path crashes on "
                "it — rejected up-front; its ODE path treats it as the "
                "thermal default, which this framework reproduces only on "
                "the reference backend.)"
            )
    if cfg.n_y < 2:
        raise ConfigError("n_y must be >= 2")
    if cfg.ode_method not in VALID_ODE_METHODS:
        raise ConfigError(
            f"ode_method={cfg.ode_method!r} is not one of {VALID_ODE_METHODS}"
        )
    if not (cfg.ode_rtol > 0.0 and cfg.ode_atol > 0.0):
        raise ConfigError("ode_rtol and ode_atol must be positive")
    for k in ("ode_auto_h0", "ode_pi_controller", "ode_tabulated_av",
              "quad_panel_gl", "fault_injection", "retry_enabled",
              "cache_enabled", "seam_split", "health_enabled",
              "self_improve"):
        v = getattr(cfg, k)
        if v is not None and not isinstance(v, bool):
            raise ConfigError(f"{k} must be true, false, or null, got {v!r}")
    egt = cfg.error_gate_tol
    if egt is True:
        raise ConfigError(
            "error_gate_tol=true is ambiguous: use null for the artifact's "
            "recorded rtol_target, false to disable the gate, or a positive "
            "tolerance"
        )
    if egt is not None and egt is not False and not (
        isinstance(egt, (int, float)) and float(egt) > 0.0
    ):
        raise ConfigError(
            f"error_gate_tol must be null, false, or a positive relative "
            f"tolerance, got {egt!r}"
        )
    for name, valid in (
        ("posterior_weight", VALID_POSTERIOR_WEIGHTS),
        ("refine_signal", VALID_REFINE_SIGNALS),
        ("tenant_routing", VALID_TENANT_ROUTING),
    ):
        v = getattr(cfg, name)
        if v is not None and v not in valid:
            raise ConfigError(f"{name}={v!r} is not one of {valid} (or null)")
    for name, valid in (
        ("sampler", VALID_SAMPLERS),
        ("mass_matrix", VALID_MASS_MATRICES),
        ("lz_mode", VALID_LZ_MODES),
    ):
        v = getattr(cfg, name)
        if v not in valid:
            raise ConfigError(f"{name}={v!r} is not one of {valid}")
    _fraction(cfg, "target_accept", closed_top=False)
    if cfg.retry_max_attempts < 1:
        raise ConfigError("retry_max_attempts must be >= 1")
    if cfg.retry_backoff_s < 0.0:
        raise ConfigError("retry_backoff_s must be >= 0")
    if cfg.fault_plan is not None and not isinstance(cfg.fault_plan, str):
        raise ConfigError(
            f"fault_plan must be JSON text or a file path, got {cfg.fault_plan!r}"
        )
    if cfg.n_replicas is not None and cfg.n_replicas < 1:
        raise ConfigError("n_replicas must be >= 1 (or null = all devices)")
    if cfg.queue_bound is not None and cfg.queue_bound < 1:
        raise ConfigError("queue_bound must be >= 1 (or null = unbounded)")
    if cfg.breaker_window < 1:
        raise ConfigError("breaker_window must be >= 1")
    _fraction(cfg, "breaker_threshold")
    if not cfg.breaker_cooldown_s > 0.0:
        raise ConfigError("breaker_cooldown_s must be > 0")
    if cfg.breaker_latency_slo_s is not None and (
        not float(cfg.breaker_latency_slo_s) > 0.0
    ):
        raise ConfigError(
            "breaker_latency_slo_s must be > 0 (or null = latency not scored)"
        )
    _fraction(cfg, "rollback_budget")
    _fraction(cfg, "drift_gated_rate")
    if not (isinstance(cfg.rebuild_budget, int) and cfg.rebuild_budget >= 1):
        raise ConfigError(
            f"rebuild_budget must be an integer >= 1, got {cfg.rebuild_budget!r}"
        )
    if cfg.memory_budget_bytes is not None and cfg.memory_budget_bytes < 1:
        raise ConfigError("memory_budget_bytes must be >= 1 (or null = unbounded)")
    if not cfg.autoscale_interval_s > 0.0:
        raise ConfigError("autoscale_interval_s must be > 0")
    if cfg.pool_min_replicas < 1:
        raise ConfigError("pool_min_replicas must be >= 1")
    if cfg.cache_root is not None and not isinstance(cfg.cache_root, str):
        raise ConfigError(
            f"cache_root must be a directory path or null, got {cfg.cache_root!r}"
        )
    if not (isinstance(cfg.lz_n_levels, int) and cfg.lz_n_levels >= 2):
        raise ConfigError(
            f"lz_n_levels must be an integer >= 2, got {cfg.lz_n_levels!r}"
        )
    if cfg.lz_n_levels != 2 and cfg.lz_mode != "chain":
        raise ConfigError(
            f"lz_n_levels={cfg.lz_n_levels} has no effect with "
            f"lz_mode={cfg.lz_mode!r} (it parameterizes the N-level chain)"
        )
    if cfg.lz_bath_eta < 0.0 or cfg.lz_bath_omega_c < 0.0:
        raise ConfigError("lz_bath_eta and lz_bath_omega_c must be >= 0")
    if (cfg.lz_bath_eta or cfg.lz_bath_omega_c) and cfg.lz_mode != "thermal":
        raise ConfigError(
            f"lz_bath_eta/lz_bath_omega_c have no effect with "
            f"lz_mode={cfg.lz_mode!r} (they parameterize the thermal bath)"
        )
    if cfg.lz_mode == "thermal" and cfg.lz_bath_eta > 0.0 and (
        not cfg.lz_bath_omega_c > 0.0
    ):
        raise ConfigError(
            "lz_mode='thermal' with lz_bath_eta > 0 needs a positive "
            "lz_bath_omega_c cutoff"
        )
    return cfg


class PointParams(NamedTuple):
    """Dynamic (sweepable) per-point parameters: Python floats for one
    point, or (P,) float64 tensors for a batch (the written-out leading
    batch axis replaces the JAX package's vmap)."""

    m_chi_GeV: Any
    g_chi: Any
    T_p_GeV: Any
    beta_over_H: Any
    v_w: Any
    I_p: Any
    g_star: Any
    g_star_s: Any
    P: Any
    sigma_y: Any
    flux_scale: Any
    Y_chi_init: Any
    m_B_kg: Any
    T_max_over_Tp: Any
    T_min_over_Tp: Any
    sigma_v: Any
    Gamma_wash_over_H: Any


class StaticChoices(NamedTuple):
    """Structural (non-sweepable) choices of a run; same fields and
    defaults as the JAX package's ``StaticChoices``."""

    chi_stats: str = "fermion"
    regime: str = "nonthermal"
    deplete_DM_from_source: bool = False
    n_y: int = 8000
    ode_method: str = "sdirk4"
    ode_rtol: float = 1e-8
    ode_atol: float = 1e-17
    ode_auto_h0: Optional[bool] = None
    ode_pi_controller: Optional[bool] = None
    ode_tabulated_av: Optional[bool] = None
    quad_panel_gl: Optional[bool] = None
    retry_enabled: Optional[bool] = None
    fault_injection: Optional[bool] = None
    lz_mode: str = "two_channel"
    lz_n_levels: int = 2
    lz_bath_eta: float = 0.0
    lz_bath_omega_c: float = 0.0


def resolve_Y_chi_init(cfg: Config) -> float:
    """Nonthermal initial-yield policy (reference :378-384 / :392-398):
    Y_chi_init if set, else n_chi(T_p)/s(T_p), else 1e-12."""
    if cfg.Y_chi_init is not None:
        return float(cfg.Y_chi_init)
    if cfg.n_chi_at_Tp_GeV3 is not None:
        from bdlz_tpu_torch.physics.thermo import entropy_density

        s_p = entropy_density(float(cfg.T_p_GeV), float(cfg.g_star_s))
        return float(cfg.n_chi_at_Tp_GeV3) / max(s_p, 1e-300)
    return 1.0e-12


def point_params_from_config(cfg: Config, P: float) -> PointParams:
    """Bind a Config + resolved LZ probability into the dynamic parameter tuple."""
    m_B_kg = M_PROTON_KG if cfg.m_B_GeV is None else float(cfg.m_B_GeV) * GEV_TO_KG
    return PointParams(
        m_chi_GeV=float(cfg.m_chi_GeV),
        g_chi=float(cfg.g_chi),
        T_p_GeV=float(cfg.T_p_GeV),
        beta_over_H=float(cfg.beta_over_H),
        v_w=float(cfg.v_w),
        I_p=float(cfg.I_p),
        g_star=float(cfg.g_star),
        g_star_s=float(cfg.g_star_s),
        P=float(P),
        sigma_y=float(cfg.source_shape_sigma_y),
        flux_scale=float(cfg.incident_flux_scale),
        Y_chi_init=resolve_Y_chi_init(cfg),
        m_B_kg=m_B_kg,
        T_max_over_Tp=float(cfg.T_max_over_Tp),
        T_min_over_Tp=float(cfg.T_min_over_Tp),
        sigma_v=float(cfg.sigma_v_chi_GeV_m2),
        Gamma_wash_over_H=float(cfg.Gamma_wash_over_H),
    )


def static_choices_from_config(cfg: Config) -> StaticChoices:
    return StaticChoices(
        chi_stats=cfg.chi_stats,
        regime=cfg.regime,
        deplete_DM_from_source=bool(cfg.deplete_DM_from_source),
        n_y=int(cfg.n_y),
        ode_method=cfg.ode_method,
        ode_rtol=float(cfg.ode_rtol),
        ode_atol=float(cfg.ode_atol),
        ode_auto_h0=cfg.ode_auto_h0,
        ode_pi_controller=cfg.ode_pi_controller,
        ode_tabulated_av=cfg.ode_tabulated_av,
        quad_panel_gl=cfg.quad_panel_gl,
        retry_enabled=cfg.retry_enabled,
        fault_injection=cfg.fault_injection,
        lz_mode=cfg.lz_mode,
        lz_n_levels=int(cfg.lz_n_levels),
        lz_bath_eta=float(cfg.lz_bath_eta),
        lz_bath_omega_c=float(cfg.lz_bath_omega_c),
    )
