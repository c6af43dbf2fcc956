"""BGe: Bayesian Gaussian equivalent score with a Normal-Wishart prior.

Rebuild of reference learning/scores/bge.{hpp,cpp}, copied from
``pybnesian_tpu/learning/scores/bge.py`` (numpy and ``gammaln`` on the host;
per family it is a determinant of a few columns). Global means and
SSE are cached once when the data has no nulls (bge.hpp:50-75); per-family
posterior determinant ratios follow bge.hpp:155-233 exactly.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import gammaln

from ...data import DataFrame
from ...factors.lineargaussian import LinearGaussianCPDType
from .base import Score

__all__ = ["BGe"]


class BGe(Score):
    def __init__(self, df, iss_mu: float = 1.0, iss_w: float | None = None,
                 nu=None):
        self.df = DataFrame.wrap(df)
        self.iss_mu = float(iss_mu)
        ncols = self.df.num_columns
        if iss_w is not None:
            if iss_w <= ncols - 1:
                raise ValueError(
                    "Imaginary sample size for Wishart prior must be greater "
                    f"than num_columns - 1 ({ncols - 1})."
                )
            self.iss_w = float(iss_w)
        else:
            self.iss_w = float(ncols + 2)
        if nu is not None:
            nu = np.asarray(nu, dtype=np.float64)
            if len(nu) != ncols:
                raise ValueError(
                    f'"nu" argument contains {len(nu)} elements, but the '
                    f"DataFrame contains {ncols} columns."
                )
        self.nu = nu

        cont = self.df.continuous_columns()
        self._cached = self.df.null_count(*cont) == 0 if cont else False
        if self._cached:
            self._cached_pos = {c: i for i, c in enumerate(cont)}
            mat = self.df.to_numpy(cont, drop_null=False, dtype=np.float64)
            self._cached_means = mat.mean(axis=0)
            centred = mat - self._cached_means[None, :]
            self._cached_sse = centred.T @ centred

    def data(self):
        return self.df

    def local_score_node_type(self, model, node_type, variable, parents) -> float:
        if node_type != LinearGaussianCPDType():
            raise ValueError(
                f'Node type "{node_type}" not valid for score BGe'
            )
        parents = list(parents)
        total_nodes = model.num_nodes()
        if not parents:
            return self._bge_no_parents(variable, total_nodes)
        return self._bge_parents(variable, parents, total_nodes)

    # ------------------------------------------------------------- pieces
    def _nu_vector(self, variable, parents):
        if self.nu is not None:
            names = self.df.column_names()
            pos = {c: i for i, c in enumerate(names)}
            return np.array(
                [self.nu[pos[variable]]] + [self.nu[pos[p]] for p in parents]
            )
        return self.df.means([variable, *parents])

    def _bge_no_parents(self, variable, total_nodes) -> float:
        n = float(self.df.valid_rows(variable))
        nu = self._nu_vector(variable, [])[0]
        logprob = 0.5 * (math.log(self.iss_mu) - math.log(n + self.iss_mu))
        logprob += gammaln(0.5 * (n + self.iss_w - total_nodes + 1)) - gammaln(
            0.5 * (self.iss_w - total_nodes + 1)
        )
        logprob -= 0.5 * n * math.log(math.pi)
        t = self.iss_mu * (self.iss_w - total_nodes - 1) / (self.iss_mu + 1)
        logprob += 0.5 * (self.iss_w - total_nodes + 1) * math.log(t)
        col = self.df.to_numpy([variable], drop_null=True, dtype=np.float64)[:, 0]
        mean = col.mean()
        sse = float(((col - mean) ** 2).sum())
        nu_diff = mean - nu
        r = t + sse + (n * self.iss_mu) / (n + self.iss_mu) * nu_diff * nu_diff
        logprob -= 0.5 * (n + self.iss_w - total_nodes + 1) * math.log(r)
        return float(logprob)

    def _family_stats(self, variable, parents):
        cols = [variable, *parents]
        if self._cached:
            idx = [self._cached_pos[c] for c in cols]
            means = self._cached_means[idx]
            r = self._cached_sse[np.ix_(idx, idx)].copy()
            return means, r
        mat = self.df.to_numpy(cols, drop_null=True, dtype=np.float64)
        means = mat.mean(axis=0)
        centred = mat - means[None, :]
        return means, centred.T @ centred

    def _bge_parents(self, variable, parents, total_nodes) -> float:
        n = float(self.df.valid_rows(variable, *parents))
        p = float(len(parents))
        nu = self._nu_vector(variable, parents)
        logprob = 0.5 * (math.log(self.iss_mu) - math.log(n + self.iss_mu))
        logprob += gammaln(
            0.5 * (n + self.iss_w - total_nodes + p + 1)
        ) - gammaln(0.5 * (self.iss_w - total_nodes + p + 1))
        logprob -= 0.5 * n * math.log(math.pi)
        t = self.iss_mu * (self.iss_w - total_nodes - 1) / (self.iss_mu + 1)
        logprob += 0.5 * (self.iss_w - total_nodes + 2 * p + 1) * math.log(t)
        means, r = self._family_stats(variable, parents)
        r[np.diag_indices_from(r)] += t
        cte = (n * self.iss_mu) / (n + self.iss_mu)
        diff = means - nu
        r += cte * np.outer(diff, diff)
        sign_full, logdet_full = np.linalg.slogdet(r)
        sign_par, logdet_par = np.linalg.slogdet(r[1:, 1:])
        logprob -= 0.5 * (n + self.iss_w - total_nodes + p + 1) * logdet_full
        logprob += 0.5 * (n + self.iss_w - total_nodes + p) * logdet_par
        return float(logprob)

    def ToString(self) -> str:
        return "BGe"
