from .bandwidth import BandwidthSelector, NormalReferenceRule, ScottsBandwidth
from .kde import KDE, ProductKDE

__all__ = [
    "BandwidthSelector",
    "NormalReferenceRule",
    "ScottsBandwidth",
    "KDE",
    "ProductKDE",
]
