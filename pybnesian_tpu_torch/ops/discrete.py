"""Batched scores of discrete (multinomial) families on torch tensors.

Port of ``pybnesian_tpu/ops/discrete.py``, the device replacement for the
reference's stride-based CPT counting
(factors/discrete/discrete_indices.{hpp,cpp}) and the serial per-family
BDe/BIC count loops (learning/scores/bde.cpp, bic.cpp:66-97).

The counting is the GPU's idiom, not the TPU's: every row's joint cell is
offset by its family's slot, ``cell + f·(max_cells + 1)``, and ONE
``torch.bincount`` counts a whole block of families (the JAX package
compares every row with every cell and reduces, because scatters serialise
on a TPU). Counts are int64, so the order in which the device adds them
cannot change a result; they turn to float64 only for the closed forms.
Rows with a null (code −1) in the family go to the overflow bin
``max_cells`` of their slot. The parent-configuration counts are sums of
the cell counts, not a second pass over the rows. Nothing is padded to a
power of two: F, P, ``max_cells`` and ``max_pconfigs`` are what the batch
needs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..runtime.device import host_to_device

__all__ = ["batched_bde", "batched_bic_discrete", "family_index_tensors"]

# elements of one (families, rows) block of cell indices: 2**25 int64 is
# 256 MiB, with two or three such temporaries alive at a time
_COUNT_BLOCK = 1 << 25


def family_index_tensors(fams, cards, device):
    """The family arguments of :func:`batched_bde` and
    :func:`batched_bic_discrete` for ``fams``, a list of (variable column,
    [parent columns]) over the code block's columns with host
    cardinalities ``cards``: ``(var_idx, parent_idx, parent_mask,
    max_cells, max_pconfigs)``, the tensors on ``device``."""
    F = len(fams)
    P = max((len(ps) for _, ps in fams), default=0)
    var_idx = np.zeros(F, np.int64)
    parent_idx = np.zeros((F, P), np.int64)
    parent_mask = np.zeros((F, P), bool)
    max_cells = max_pconfigs = 1
    for f, (v, ps) in enumerate(fams):
        var_idx[f] = v
        parent_idx[f, : len(ps)] = ps
        parent_mask[f, : len(ps)] = True
        pconf = math.prod(int(cards[p]) for p in ps)
        max_pconfigs = max(max_pconfigs, pconf)
        max_cells = max(max_cells, int(cards[v]) * pconf)
    return (host_to_device(var_idx, np.int64, device),
            host_to_device(parent_idx, np.int64, device),
            torch.from_numpy(parent_mask).to(device),
            max_cells, max_pconfigs)


def _family_counts(codes, cards, var_idx, parent_idx, parent_mask,
                   max_cells: int, max_pconfigs: int):
    """Joint and parent-configuration counts of F families.

    codes: (n, D) integer codes, −1 for null; cards: (D,) cardinalities;
    var_idx: (F,) column of each family's variable; parent_idx: (F, P)
    parent columns and parent_mask: (F, P) nonzero where a slot holds a
    parent; max_cells ≥ every family's vcard·Π pcard, max_pconfigs ≥ every
    family's Π pcard. Cell index = vcode + vcard·pconfig, the first parent
    the fastest-moving (reference discrete_indices.hpp strides).

    Returns ``(counts (F, max_cells) int64, pcounts (F, max_pconfigs)
    int64, num_cells (F,), num_pconfigs (F,), vcard (F,))``, the last three
    int64."""
    n = codes.shape[0]
    F, P = parent_idx.shape
    device = codes.device
    cards = cards.to(torch.int64)
    pmb = parent_mask.to(torch.bool)
    vcard = cards[var_idx]                                      # (F,)
    pcard = torch.where(pmb, cards[parent_idx], 1)              # (F, P)
    # parent strides: stride_j = prod(pcard[:j])
    cum = torch.cumprod(pcard, dim=1)
    num_pconfigs = cum[:, -1] if P else torch.ones_like(vcard)
    pstrides = torch.cat([torch.ones_like(pcard[:, :1]), cum[:, :-1]], dim=1)

    ct = codes.T                                                # (D, n)
    slot = max_cells + 1
    counts = torch.empty((F, max_cells), dtype=torch.int64, device=device)
    step = max(1, _COUNT_BLOCK // max(n, 1))
    for s in range(0, F, step):
        e = min(s + step, F)
        vcode = ct[var_idx[s:e]].to(torch.int64)                # (f, n)
        valid = vcode >= 0
        pconfig = torch.zeros_like(vcode)
        for j in range(P):
            pc = ct[parent_idx[s:e, j]].to(torch.int64)
            used = pmb[s:e, j, None]
            valid &= (pc >= 0) | ~used
            pconfig += torch.where(used, pc, 0) * pstrides[s:e, j, None]
        cell = vcode + vcard[s:e, None] * pconfig
        cell = torch.where(valid, cell, max_cells)
        cell += torch.arange(e - s, device=device)[:, None] * slot
        block = torch.bincount(cell.reshape(-1), minlength=(e - s) * slot)
        counts[s:e] = block.view(e - s, slot)[:, :max_cells]
    # parent-configuration counts: cell c belongs to configuration c // vcard
    pidx = torch.arange(max_cells, device=device)[None, :] // vcard[:, None]
    pcounts = torch.zeros((F, max_pconfigs + 1), dtype=torch.int64,
                          device=device)
    pcounts.scatter_add_(1, pidx.clamp_(max=max_pconfigs), counts)
    return (counts, pcounts[:, :max_pconfigs], vcard * num_pconfigs,
            num_pconfigs, vcard)


def batched_bde(codes, cards, var_idx, parent_idx, parent_mask, iss,
                max_cells: int, max_pconfigs: int):
    """BDe local scores of F families in one call (formulas: reference
    learning/scores/bde.cpp:5-48), the ``iss`` prior spread uniformly over
    the joint cells. Arguments as :func:`_family_counts`. Returns (F,)
    float64."""
    counts, pcounts, num_cells, _num_pconfigs, vcard = _family_counts(
        codes, cards, var_idx, parent_idx, parent_mask, max_cells,
        max_pconfigs,
    )
    f64 = torch.float64
    alpha = (iss / num_cells.to(f64))[:, None]
    sum_alpha = alpha * vcard.to(f64)[:, None]
    # a cell or configuration past the family's own holds 0 and adds
    # lgamma(a) − lgamma(a) = 0: no mask needed
    return torch.sum(
        torch.lgamma(counts.to(f64) + alpha) - torch.lgamma(alpha), dim=1
    ) + torch.sum(
        torch.lgamma(sum_alpha) - torch.lgamma(sum_alpha + pcounts.to(f64)),
        dim=1,
    )


def batched_bic_discrete(codes, cards, var_idx, parent_idx, parent_mask,
                         max_cells: int, max_pconfigs: int):
    """Discrete BIC local scores of F families in one call (formula:
    reference learning/scores/bic.cpp:66-97). Arguments as
    :func:`_family_counts`. Returns (F,) float64."""
    counts, pcounts, _num_cells, num_pconfigs, vcard = _family_counts(
        codes, cards, var_idx, parent_idx, parent_mask, max_cells,
        max_pconfigs,
    )
    f64 = torch.float64
    n = torch.sum(counts, dim=1).to(f64)
    c = counts.to(f64)
    # cells past a family's own, and empty cells, hold 0: 0·log 1 = 0
    ll = torch.sum(c * torch.log(torch.clamp(c, min=1.0)), dim=1)
    pc = pcounts.to(f64)
    ll = ll - torch.sum(pc * torch.log(torch.clamp(pc, min=1.0)), dim=1)
    penalty = (torch.log(n) * 0.5 * (vcard.to(f64) - 1.0)
               * num_pconfigs.to(f64))
    return ll - penalty
