#!/usr/bin/env python3
"""Whether a CKDE family's float32 whitened CV parts differ between the
family scored alone and inside a batch, and at which step.

    python3 tools/whiten_check.py

Builds ``chip_smoke.py`` phase 8's CV folds (config3b's 8-column chain,
the 8,000 training rows of its 10,000, 10 folds) and its 56 one-parent
families (normal-reference rule), and measures two things:

1. ``steps``: the whitening as float32 torch ops, step by step — the fold
   means, the centred rows, the covariances, the bandwidths, their
   Cholesky factors and inverses, and the whitened train and test rows —
   as the card route formed them before the whitening had a kernel (the
   plain version, ``ops/cv_whiten_kernel.py ckde_cv_whitened_parts``, now
   takes these statistics in float64). For each step, how many of the 56
   families get other bits inside the batch of 56 than alone, then which
   steps of family 0 stay bit-equal inside batches of 1 to 56 families.
2. ``route``: the route's own parts, the outputs of
   ``ckde_cv_whiten`` (on the card the whitening kernel of
   ``csrc/cv_whiten.cu``): the same two counts over its ten outputs.

Runs on the card (float32); with no GPU it runs on the CPU, where the
route is the plain version and neither count says anything about the
card's reductions. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STEPS = ("mean", "xc", "cov", "H", "L", "Linv", "jtr", "jte")


def steps(torch, data, col_idx, col_mask, tr_idx, tr_mask, te_idx):
    """The intermediate tensors of ``ckde_cv_whitened_parts`` (no nulls,
    normal-reference rule), by name."""
    from pybnesian_tpu_torch.ops.linalg import cholesky_or_nan

    djmax = col_idx.shape[1]
    fam = data[:, col_idx].permute(1, 0, 2) * col_mask[:, None, :]
    d_col = torch.sum(col_mask, dim=1)[:, None]
    w = tr_mask[None].expand(len(col_idx), -1, -1)
    train = fam[:, tr_idx]
    n_eff = torch.sum(w, dim=2)
    out = {"mean": torch.sum(train * w[..., None], dim=2) / n_eff[..., None]}
    out["xc"] = (train - out["mean"][:, :, None, :]) * (
        w[..., None] * col_mask[:, None, None, :])
    out["cov"] = out["xc"].mT @ out["xc"] / (n_eff - 1.0)[..., None, None]
    k = (4.0 / (n_eff * (d_col + 2.0))) ** (2.0 / (d_col + 4.0))
    out["H"] = (k[..., None, None] * out["cov"]
                + torch.diag_embed(1.0 - col_mask)[:, None])
    out["L"] = cholesky_or_nan(out["H"])
    eye = torch.eye(djmax, dtype=data.dtype, device=data.device)
    out["Linv"] = torch.linalg.solve_triangular(
        out["L"], eye.expand_as(out["L"]), upper=False)
    out["jtr"] = train @ out["Linv"].mT
    out["jte"] = fam[:, te_idx] @ out["Linv"].mT
    return out


def main():
    import torch

    import chip_smoke
    from pybnesian_tpu_torch import CVLikelihood, DataFrame, use_device
    from pybnesian_tpu_torch.learning.scores.likelihood import (
        _family_columns)
    from pybnesian_tpu_torch.ops.cv_whiten_kernel import ckde_cv_whiten

    device = "cuda" if torch.cuda.is_available() else "cpu"
    if device == "cpu":
        use_device("cpu")
    data = chip_smoke.config3b_data(chip_smoke.HC_ROWS, seed=2)
    frame = DataFrame.wrap({k: v[:8000] for k, v in data.items()})
    engine = CVLikelihood(frame, k=10, seed=0)._engine
    pos, dat, _null, tr_idx, tr_mask, te_idx, _te_mask = (
        engine._device_cv_cache())
    nodes = frame.column_names()
    fams = [(t, [s]) for t in nodes for s in nodes if s != t]

    def run(fs):
        col_idx, col_mask = _family_columns(fs, pos)
        return steps(torch, dat, torch.as_tensor(col_idx, device=device),
                     torch.as_tensor(col_mask, dtype=dat.dtype,
                                     device=device),
                     tr_idx, tr_mask, te_idx)

    def route(fs):
        """The route's parts of the families ``fs``: the ten outputs of
        one ``ckde_cv_whiten`` call."""
        col_idx, col_mask = _family_columns(fs, pos)
        return ckde_cv_whiten(
            dat, _null, torch.as_tensor(col_idx, device=device),
            torch.as_tensor(col_mask, dtype=dat.dtype, device=device),
            tr_idx, tr_mask, te_idx, _te_mask, rule="nr")

    together = run(fams)
    differ = dict.fromkeys(STEPS, 0)
    for f, fam in enumerate(fams):
        alone = run([fam])
        for name in STEPS:
            differ[name] += not torch.equal(together[name][f:f + 1],
                                            alone[name])
    chip_smoke.say("whiten check", measures="steps", device=device,
                   families=len(fams),
                   folds=len(engine.folds),
                   not_bit_equal_in_batch=repr(differ))
    first = run(fams[:1])
    for size in (2, 4, 8, 16, 32, 56):
        part = run(fams[:size])
        chip_smoke.say("whiten check", measures="steps", family=0,
                       batch=size, bit_equal=repr(
                           {n: bool(torch.equal(part[n][:1], first[n]))
                            for n in STEPS}))

    K = len(engine.folds)

    def program(parts, f):
        """Family f's ten outputs of a ``ckde_cv_whiten`` call."""
        g = slice(f * K, (f + 1) * K)
        return [t[g] for t in parts[:7]] + [t[f:f + 1] for t in parts[7:]]

    together = route(fams)
    differ = dict.fromkeys(chip_smoke.WHITEN_NAMES, 0)
    for f, fam in enumerate(fams):
        for name, a, b in zip(chip_smoke.WHITEN_NAMES,
                              program(together, f), route([fam])):
            differ[name] += not torch.equal(a, b)
    chip_smoke.say("whiten check", measures="route", device=device,
                   families=len(fams), not_bit_equal_in_batch=repr(differ))
    first = program(route(fams[:1]), 0)
    for size in range(1, len(fams) + 1):
        part = program(route(fams[:size]), 0)
        unequal = [n for n, a, b in zip(chip_smoke.WHITEN_NAMES, part, first)
                   if not torch.equal(a, b)]
        if size in (1, 2, 4, 8, 16, 32, 56) or unequal:
            chip_smoke.say("whiten check", measures="route", family=0,
                           batch=size, not_bit_equal=repr(unequal))


if __name__ == "__main__":
    main()
