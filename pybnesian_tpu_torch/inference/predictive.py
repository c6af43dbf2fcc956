"""Posterior-predictive utilities (net-new vs the reference, which defers
inference entirely — README.md:110-113).

``apply_params`` materializes one posterior draw from
:func:`~pybnesian_tpu_torch.inference.make_logdensity`'s flat parameter vector
into a fitted clone of the model; ``posterior_predictive`` mixes ancestral
samples over many draws — the standard posterior-predictive data
distribution for model checking.

Copied from ``pybnesian_tpu/inference/predictive.py``, with the port's
factors; draws may be tensors on any device (they are read on the host).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import DataFrame

__all__ = ["apply_params", "posterior_predictive"]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def apply_params(model, df, layout, theta, _template=None):
    """Fitted clone of ``model`` with CPD parameters taken from ``theta``.

    ``layout`` is the ParamLayout returned by ``make_logdensity(model, df)``;
    ``theta`` is one flat parameter vector (a posterior draw, numpy or a
    tensor). Supports the
    same node kinds as the logdensity: plain linear-Gaussian ("lg"),
    conditional-linear-Gaussian ("clg"), and discrete CPTs ("discrete").

    ``_template``: a model previously returned by this function — its
    fitted CLG/discrete skeletons (categories, strides, partitions) are
    copied instead of re-fitting on ``df``, so mixing over many draws pays
    the data-dependent fit exactly once.
    """
    import copy

    from scipy.special import logsumexp

    from ..factors.discrete import DiscreteFactor
    from ..factors.hybrid import CLinearGaussianCPD
    from ..factors.lineargaussian import LinearGaussianCPD

    df = DataFrame.wrap(df)
    theta = _host(theta).astype(np.float64)
    out = model.clone()
    cpds = []
    for node, (lo, hi, kind) in layout.slices.items():
        parents = out.parents(node)
        block = theta[lo:hi]
        if kind == "lg":
            beta = block[:-1]
            variance = float(np.exp(block[-1]))
            cpds.append(LinearGaussianCPD(node, parents, beta, variance))
        elif kind == "clg":
            if _template is not None:
                f = copy.deepcopy(_template.cpd(node))
            else:
                f = CLinearGaussianCPD(node, parents)
                # fit once on the training frame to establish the discrete
                # partition (categories, strides); parameters are replaced
                # by the draw below. Config indexing matches
                # make_logdensity: both filter the discrete evidence in
                # parents order and use create_cardinality_strides.
                f.fit(df)
            cont = f._continuous_evidence
            k = len(cont)
            params = block.reshape(-1, k + 2)
            f._factors = [
                LinearGaussianCPD(
                    node, cont, params[c, : k + 1],
                    float(np.exp(params[c, k + 1])),
                )
                for c in range(params.shape[0])
            ]
            cpds.append(f)
        elif kind == "discrete":
            if _template is not None:
                f = copy.deepcopy(_template.cpd(node))
            else:
                f = DiscreteFactor(node, parents)
                f.fit(df)
            kcat = int(f._cardinality[0])
            logits = block.reshape(-1, kcat)
            logp = logits - logsumexp(logits, axis=1, keepdims=True)
            f._logprob = logp.reshape(-1)
            cpds.append(f)
        else:
            raise ValueError(f"Unknown parameter kind '{kind}' for {node}")
    out.add_cpds(cpds)
    return out


def posterior_predictive(model, df, layout, samples, n_rows: int,
                         seed: int = 0, max_draws: int = 20):
    """Ancestral samples mixed over posterior draws.

    ``samples``: (num_samples, dim) or (chains, num_samples, dim) array of
    posterior draws (NUTS/HMC/ADVI/SMC output). Rows are drawn from
    ``min(max_draws, len(samples))`` parameter draws, ``n_rows`` total.
    Returns a DataFrame in the model's node order.
    """
    import pandas as pd

    samples = _host(samples)
    if samples.ndim == 3:
        samples = samples.reshape(-1, samples.shape[-1])
    if samples.ndim != 2:
        raise ValueError("samples must be (S, dim) or (chains, S, dim)")
    if len(samples) == 0:
        raise ValueError("samples is empty — need at least one posterior draw")
    if n_rows <= 0:
        raise ValueError(f"n_rows must be positive (got {n_rows})")
    rng = np.random.default_rng(seed)
    n_draws = min(max_draws, len(samples))
    chosen = rng.choice(len(samples), size=n_draws, replace=False)
    per = np.full(n_draws, n_rows // n_draws)
    per[: n_rows % n_draws] += 1
    frames = []
    template = None
    for i, s_idx in enumerate(chosen):
        if per[i] == 0:
            continue
        m = apply_params(
            model, df, layout, samples[s_idx], _template=template
        )
        if template is None:
            template = m
        frames.append(
            m.sample(int(per[i]), seed=seed + 1 + i, ordered=True).to_pandas()
        )
    return pd.concat(frames, ignore_index=True)
