from .bandwidth import BandwidthSelector, NormalReferenceRule, ScottsBandwidth
from .kde import KDE, ProductKDE
from .ucv import UCV

__all__ = [
    "BandwidthSelector",
    "NormalReferenceRule",
    "ScottsBandwidth",
    "UCV",
    "KDE",
    "ProductKDE",
]
