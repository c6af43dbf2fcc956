"""CKDE: conditional kernel density estimation factor.

Rebuild of reference factors/continuous/CKDE.{hpp,cpp} (992 LoC):
``logl = logl_joint − logl_marg`` where the joint KDE covers
(variable, evidence) and the marginal KDE shares the joint's training block
and bandwidth sub-matrix (CKDE.hpp:182-254).

Torch port, class surface only: construction, ``fit`` (host) and
``bandwidth_selector()`` — what the CV score needs. The device methods
(``logl``, ``slogl``, ``sample``, ``batched_ckde_logl_many``) raise
``NotImplementedError`` until ROADMAP.md Queue 1 item 6 ports them.
"""

from __future__ import annotations

import numpy as np

from ..data import DataFrame
from ..kde.bandwidth import BandwidthSelector, NormalReferenceRule
from ..kde.kde import KDE
from .base import Factor, FactorType

__all__ = ["CKDEType", "CKDE"]


class CKDEType(FactorType):
    def new_factor(self, model, variable, evidence, *args, **kwargs):
        """CKDE over continuous evidence. Discrete evidence dispatches to
        HCKDE in the reference (CKDE.cpp:15-33); ``factors/hybrid.py`` is
        not ported yet (ROADMAP.md Queue 1 item 1)."""
        if model is not None:
            from .discrete import DiscreteFactorType

            if any(model.node_type(e) == DiscreteFactorType()
                   for e in evidence):
                raise NotImplementedError(
                    "HCKDE (CKDE with discrete evidence) is not ported to "
                    "torch yet (ROADMAP.md Queue 1 item 1: factors/hybrid.py)"
                )
        return CKDE(variable, evidence, *args, **kwargs)

    def ToString(self) -> str:
        return "CKDEFactor"


def batched_ckde_logl_many(entries, chunk: int = 256):
    """Per-row logl of many fitted CKDE factors in one device launch.
    Not ported yet: ROADMAP.md Queue 1 item 6."""
    raise NotImplementedError(
        "batched_ckde_logl_many is not ported to torch yet (ROADMAP.md "
        "Queue 1 item 6: model-level KDE/CKDE likelihood and sampling)"
    )


class CKDE(Factor):
    def __init__(self, variable, evidence=(), bandwidth_selector: BandwidthSelector | None = None):
        super().__init__(variable, evidence)
        self._bselector = bandwidth_selector or NormalReferenceRule()
        self._joint: KDE | None = None
        self._marg: KDE | None = None
        self._fitted = False

    def type(self) -> FactorType:
        return CKDEType()

    def fitted(self) -> bool:
        return self._fitted

    def data_type(self):
        if not self._fitted:
            raise ValueError("CKDE factor not fitted.")
        return self._joint.data_type()

    def kde_joint(self) -> KDE:
        self._check_fitted()
        return self._joint

    def kde_marg(self) -> KDE:
        self._check_fitted()
        return self._marg

    def num_instances(self) -> int:
        self._check_fitted()
        return self._joint.num_instances()

    def bandwidth_selector(self) -> BandwidthSelector:
        return self._bselector

    def _check_fitted(self):
        if not self._fitted:
            raise ValueError(
                f"Factor P({self._variable} | {self._evidence}) not fitted."
            )

    # ------------------------------------------------------------------ fit
    def fit(self, df) -> None:
        df = DataFrame.wrap(df)
        variables = [self._variable, *self._evidence]
        self._joint = KDE(variables, self._bselector)
        self._joint.fit(df)
        if self._evidence:
            # marginal shares the joint's training block and bandwidth
            # sub-matrix (reference CKDE.hpp:182-200)
            self._marg = KDE(list(self._evidence), self._bselector)
            self._marg._dtype = self._joint._dtype
            self._marg.fit_with_bandwidth(
                self._joint._training[:, 1:], self._joint.bandwidth[1:, 1:]
            )
        else:
            self._marg = None
        self._fitted = True

    # ----------------------------------------------------------------- logl
    def logl(self, df) -> np.ndarray:
        raise NotImplementedError(
            "CKDE.logl is not ported to torch yet (ROADMAP.md Queue 1 item 6: "
            "model-level KDE/CKDE likelihood and sampling)"
        )

    def slogl(self, df) -> float:
        return float(np.nansum(self.logl(df)))

    # ---------------------------------------------------------------- string
    def ToString(self) -> str:
        v = self._variable
        if self._evidence:
            ev = ", ".join(self._evidence)
            suffix = "" if self._fitted else " not fitted"
            return f"[CKDE] P({v} | {ev}) = CKDE{suffix}"
        suffix = "" if self._fitted else " not fitted"
        return f"[CKDE] P({v}) = CKDE{suffix}"

    # --------------------------------------------------------------- pickle
    def __getstate__(self):
        return {
            "variable": self._variable,
            "evidence": self._evidence,
            "bselector": self._bselector,
            "fitted": self._fitted,
            "joint": self._joint,
            "marg": self._marg,
        }

    def __setstate__(self, state):
        Factor.__init__(self, state["variable"], state["evidence"])
        self._bselector = state["bselector"]
        self._fitted = state["fitted"]
        self._joint = state["joint"]
        self._marg = state["marg"]
