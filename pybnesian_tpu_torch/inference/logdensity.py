"""Joint log-densities over Bayesian-network CPD parameters.

Turns a network structure + data into a pure, differentiable
``logdensity(theta)`` over a flat parameter vector, ready for
HMC/NUTS/ADVI/SMC. Supported CPD families:

- LinearGaussian nodes: params (beta, log_variance) per node; Gaussian prior
  on beta, log-variance flat-normal prior. A node with discrete parents
  (CLG) has one such block per discrete parent configuration.
- Discrete nodes: unconstrained logits per CPT row with a Dirichlet prior via
  the softmax reparameterisation.

Copied from ``pybnesian_tpu/inference/logdensity.py``. The density is a
chain of tensor expressions over data held on :func:`default_device`: no
host read, no in-place write and no Python branch on a tensor, so
``torch.func.grad`` and ``torch.func.vmap`` take it as it is. The CLG
piece evaluates every configuration at once over an (n_configs, rows)
layout where the reference maps one configuration at a time.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..data import DataFrame
from ..factors.discrete import (
    DiscreteFactorType,
    create_cardinality_strides,
    flat_indices,
)
from ..factors.lineargaussian import LinearGaussianCPDType
from ..learning.parameters import mle_lineargaussian
from ..runtime.device import host_to_device

__all__ = ["make_logdensity", "ParamLayout"]

_LOG_2PI = math.log(2 * math.pi)


class ParamLayout:
    """Mapping node → slice of the flat parameter vector."""

    def __init__(self):
        self.slices: dict[str, tuple[int, int, str]] = {}
        self.size = 0

    def add(self, node: str, n: int, kind: str):
        self.slices[node] = (self.size, self.size + n, kind)
        self.size += n

    def unpack(self, node: str, theta):
        lo, hi, _ = self.slices[node]
        return theta[lo:hi]


def _lg_init(df, node, evidence) -> np.ndarray:
    """(beta, log variance) of the MLE; a log variance of 0 where the
    variance is not a positive number."""
    params = mle_lineargaussian(df, node, evidence)
    var0 = params.variance
    if not np.isfinite(var0) or var0 <= 0:
        var0 = 1.0
    return np.concatenate([np.nan_to_num(params.beta), [math.log(var0)]])


def make_logdensity(model, df, beta_prior_scale: float = 10.0,
                    logvar_prior_scale: float = 5.0,
                    dirichlet_alpha: float = 1.0, dtype=None):
    """(logdensity_fn, layout, init_params) for the given model + data.

    logdensity_fn: flat tensor -> scalar log p(data | params) + log prior.
    The data and ``init_params`` live on :func:`default_device` in
    ``dtype`` (numpy float32 or float64; float32 when None).
    """
    df = DataFrame.wrap(df)
    layout = ParamLayout()
    pieces = []  # list of closures theta -> scalar
    init = []

    cont_cols = df.continuous_columns()
    if dtype is None:
        dtype = np.float32
    values, valid = df.device_matrix(cont_cols, dtype=dtype)
    device = values.device
    pos = {c: i for i, c in enumerate(cont_cols)}

    def regressors(cols):
        if cols:
            return values[:, [pos[p] for p in cols]]
        return values.new_zeros((df.num_rows, 0))

    def weights(cols):
        w = valid[:, pos[cols[0]]]
        for p in cols[1:]:
            w = w * valid[:, pos[p]]
        return w

    def gaussian_prior(beta, logvar):
        """Summed over the last axis of ``beta``."""
        return (-0.5 * (beta.square() / beta_prior_scale**2).sum(-1)
                - 0.5 * logvar.square() / logvar_prior_scale**2)

    for node in model.nodes():
        node_type = model.underlying_node_type(df, node)
        parents = model.parents(node)
        if node_type == LinearGaussianCPDType() and any(
            df.is_discrete(p) for p in parents
        ):
            # CLG node: one (beta, log-variance) block per discrete parent
            # configuration (the reference's CLinearGaussianCPD partition)
            disc = [p for p in parents if df.is_discrete(p)]
            cont = [p for p in parents if not df.is_discrete(p)]
            card, strides = create_cardinality_strides(df, disc[0], disc[1:])
            n_configs = int(np.prod(card))
            cfg = flat_indices(df, disc, strides)
            k = len(cont)
            block = k + 2
            layout.add(node, n_configs * block, "clg")
            lo, _, _ = layout.slices[node]
            # (n_configs, rows): each row's weight under its configuration
            w_cfg = weights([node, *cont])[None, :] * host_to_device(
                np.stack([(cfg == c) for c in range(n_configs)]), dtype,
                device)

            def clg_piece(theta, y=values[:, pos[node]], X=regressors(cont),
                          w_cfg=w_cfg, lo=lo, k=k, block=block,
                          n_configs=n_configs):
                params = theta[lo: lo + n_configs * block].reshape(
                    n_configs, block
                )
                beta = params[:, : k + 1]
                logvar = params[:, k + 1]
                mean = beta[:, :1] + beta[:, 1:] @ X.T
                ll = (
                    -0.5 * (y[None, :] - mean).square()
                    * torch.exp(-logvar)[:, None]
                    - 0.5 * logvar[:, None]
                    - 0.5 * _LOG_2PI
                )
                return (ll * w_cfg).sum() + gaussian_prior(beta, logvar).sum()

            pieces.append(clg_piece)
            init_block = np.zeros((n_configs, block))
            all_rows = np.arange(df.num_rows)
            for c in range(n_configs):
                rows = all_rows[cfg == c]
                if len(rows) > k + 2:
                    init_block[c] = _lg_init(df.take(rows), node, cont)
            init.append(init_block.reshape(-1))
        elif node_type == LinearGaussianCPDType():
            k = len(parents)
            layout.add(node, k + 2, "lg")
            lo, hi, _ = layout.slices[node]

            def lg_piece(theta, y=values[:, pos[node]], X=regressors(parents),
                         w=weights([node, *parents]), lo=lo, hi=hi, k=k):
                beta = theta[lo: lo + k + 1]
                logvar = theta[hi - 1]
                mean = beta[0] + X @ beta[1:]
                ll = (
                    -0.5 * (y - mean).square() * torch.exp(-logvar)
                    - 0.5 * logvar
                    - 0.5 * _LOG_2PI
                )
                return (ll * w).sum() + gaussian_prior(beta, logvar)

            pieces.append(lg_piece)
            init.append(_lg_init(df, node, parents))
        elif node_type == DiscreteFactorType():
            card, strides = create_cardinality_strides(df, node, parents)
            kcat = int(card[0])
            n_configs = int(np.prod(card[1:])) if len(card) > 1 else 1
            n_par = kcat * n_configs
            layout.add(node, n_par, "discrete")
            idx = flat_indices(df, [node, *parents], strides)
            counts = np.bincount(
                idx[idx >= 0], minlength=n_par
            ).reshape(n_configs, kcat)
            lo, hi, _ = layout.slices[node]

            def disc_piece(theta, counts=host_to_device(counts, dtype, device),
                           lo=lo, hi=hi, n_configs=n_configs, kcat=kcat):
                logits = theta[lo:hi].reshape(n_configs, kcat)
                logp = logits - torch.logsumexp(logits, 1, keepdim=True)
                ll = (counts * logp).sum()
                prior = ((dirichlet_alpha - 1.0) * logp).sum() - 0.5 * (
                    logits.square().sum() * 1e-2)
                return ll + prior

            pieces.append(disc_piece)
            init.append(np.zeros(n_par))
        else:
            raise ValueError(
                f"make_logdensity does not support node type {node_type} "
                f"for node {node}"
            )

    init_flat = host_to_device(
        np.concatenate(init) if init else np.zeros(0), dtype, device)

    def logdensity(theta):
        total = theta.new_zeros(())
        for piece in pieces:
            total = total + piece(theta)
        return total

    return logdensity, layout, init_flat
