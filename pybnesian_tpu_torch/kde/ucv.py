"""UCV (unbiased cross-validation) bandwidth selection.

Rebuild of reference kde/UCV.{hpp,cpp}: the leave-one-out UCV objective
over the N(N−1)/2 pair triangle, minimized with Nelder–Mead.

Torch port, class surface only: ``UCV`` exists so that the CV score can
dispatch on its type; the bandwidth search raises ``NotImplementedError``
until ROADMAP.md Queue 1 item 5 ports it.
"""

from __future__ import annotations

import numpy as np

from .bandwidth import BandwidthSelector

__all__ = ["UCV", "ucv_minimize_batch"]

_NOT_PORTED = (
    "{} is not ported to torch yet (ROADMAP.md Queue 1 item 5: UCV "
    "bandwidth)"
)


def ucv_minimize_batch(Xpad, valid, Ns, x0s, d: int, chunk: int = 512):
    """Batched UCV bandwidth selection by a device Nelder–Mead."""
    raise NotImplementedError(_NOT_PORTED.format("ucv_minimize_batch"))


class UCV(BandwidthSelector):
    def bandwidth(self, df, variables) -> np.ndarray:
        raise NotImplementedError(_NOT_PORTED.format("UCV.bandwidth"))

    def diag_bandwidth(self, df, variables) -> np.ndarray:
        raise NotImplementedError(_NOT_PORTED.format("UCV.diag_bandwidth"))

    def ToString(self) -> str:
        return "UCV"
