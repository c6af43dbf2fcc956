"""Posterior inference over Bayesian-network parameters.

NUTS/HMC, ADVI and SMC over CPD parameters (the reference defers inference,
README.md:110-113; BASELINE.json config 5), on tensors of the device the
caller's ``init`` lives on (``sample_chains_sharded``: over the devices of
a mesh). Counterpart of ``pybnesian_tpu/inference``.
"""

from .advi import advi
from .diagnostics import (effective_sample_size, potential_scale_reduction,
                          summarize)
from .hmc import hmc, nuts, sample_chains, sample_chains_sharded
from .logdensity import make_logdensity
from .predictive import apply_params, posterior_predictive
from .smc import smc

__all__ = [
    "make_logdensity",
    "apply_params",
    "posterior_predictive",
    "hmc",
    "nuts",
    "sample_chains",
    "sample_chains_sharded",
    "advi",
    "smc",
    "effective_sample_size",
    "potential_scale_reduction",
    "summarize",
]
