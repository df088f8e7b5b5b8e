"""Sampling layer: MCMC over the yields pipeline in PyTorch.

Counterpart of ``bdlz_tpu/sampling``, with JAX's ``__all__``.  Two
transition kernels share the batched Planck likelihood
(``likelihoods.py``): the affine-invariant stretch move (``ensemble.py``)
and multinomial NUTS (``nuts.py``) on the autograd gradient layer
(``grad.py``).  ``diagnostics.py`` holds τ_int, split-R̂ and the
rank-normalised bulk ESS/R̂; ``checkpoint.py`` cuts either sampler into
resumable segments.  Chains are functions of their seed through CPU
``torch.Generator`` draws, the same on the CPU and on the card; they are
not the JAX package's chains for the same seed.
"""
from bdlz_tpu_torch.sampling.checkpoint import CheckpointedRun, run_ensemble_checkpointed
from bdlz_tpu_torch.sampling.diagnostics import (
    bulk_ess,
    effective_sample_size,
    integrated_autocorr_time,
    rank_normalized_split_rhat,
    split_rhat,
)
from bdlz_tpu_torch.sampling.ensemble import EnsembleState, run_ensemble, stretch_step
from bdlz_tpu_torch.sampling.grad import (
    central_fd_grad,
    gradient_parity,
    make_logp_value_and_grad,
    make_observable_jacobian,
    make_ratio_and_grad,
    planck_fisher_information,
)
from bdlz_tpu_torch.sampling.likelihoods import (
    make_pipeline_logprob,
    make_pipeline_observables,
    omegas_from_result,
    planck_gaussian_logp,
)
from bdlz_tpu_torch.sampling.nuts import NUTSRun, run_nuts

__all__ = [
    "run_ensemble",
    "run_ensemble_checkpointed",
    "CheckpointedRun",
    "stretch_step",
    "EnsembleState",
    "run_nuts",
    "NUTSRun",
    "planck_gaussian_logp",
    "make_pipeline_logprob",
    "make_pipeline_observables",
    "omegas_from_result",
    "make_logp_value_and_grad",
    "make_observable_jacobian",
    "make_ratio_and_grad",
    "planck_fisher_information",
    "central_fd_grad",
    "gradient_parity",
    "integrated_autocorr_time",
    "split_rhat",
    "effective_sample_size",
    "bulk_ess",
    "rank_normalized_split_rhat",
]
