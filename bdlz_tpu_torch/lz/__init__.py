"""Two-channel Landau–Zener transport, the N-level chain and the thermal
bath — the counterpart of ``bdlz_tpu/lz``, with the same exports.

Seam contract (reference ``maybe_P``): (profile, v_w) -> P in [0, 1].
"""
from bdlz_tpu_torch.lz.chain import (  # noqa: F401
    chain_conversion_probability,
    chain_populations,
    chain_populations_for_speeds,
    chain_probabilities_for_points,
)
from bdlz_tpu_torch.lz.kernel import (  # noqa: F401
    dephased_probability,
    lambda_eff_from_profile,
    local_lambdas,
    probability_from_lambda,
    probability_from_profile,
    propagate_bloch,
    transfer_matrix_propagation,
)
from bdlz_tpu_torch.lz.momentum import (  # noqa: F401
    momentum_averaged_probability,
)
from bdlz_tpu_torch.lz.profile import (  # noqa: F401
    BounceProfile,
    Crossings,
    ProfileError,
    find_crossings,
    load_profile_csv,
    write_profile_csv,
)
from bdlz_tpu_torch.lz.sweep_bridge import (  # noqa: F401
    PTableN,
    eval_P_table_n,
    make_P_table_n,
    probabilities_for_points,
    profile_fingerprint,
    scenario_identity,
    scenario_probabilities_for_points,
)
from bdlz_tpu_torch.lz.thermal import (  # noqa: F401
    thermal_gamma_phi,
    thermal_probabilities_for_points,
    thermal_probability,
)
