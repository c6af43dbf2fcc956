from .bandwidth import BandwidthSelector, NormalReferenceRule, ScottsBandwidth
from .kde import KDE

__all__ = [
    "BandwidthSelector",
    "NormalReferenceRule",
    "ScottsBandwidth",
    "KDE",
]
