"""In-framework O(4) bounce solver: potential → profile → P → yields.

Counterpart of ``bdlz_tpu/bounce``, with the same exports: a validated
quartic :class:`PotentialSpec` is shot through the radial bubble ODE
(overshoot/undershoot bisection on the release point; one CUDA kernel on
the card), the wall profile is extracted as an ``lz`` :class:`BounceProfile`,
and the derived P flows through the two-channel, chain and thermal kernels.
"""
from bdlz_tpu_torch.bounce.potential import (  # noqa: F401
    PotentialError,
    PotentialSpec,
    as_potential_spec,
    load_potential_json,
    potential_dV,
    potential_fingerprint,
    potential_V,
    reference_potential,
    thin_wall_action,
    thin_wall_radius,
    validate_potential,
    vacua,
    wall_tension,
    wall_width_mu,
    write_potential_json,
)
from bdlz_tpu_torch.bounce.shooting import (  # noqa: F401
    BounceSolution,
    BounceSolveError,
    bounce_probabilities,
    bounce_profile,
    solve_bounce,
    solve_bounce_batch,
    solve_bounce_scalar_loop,
)
