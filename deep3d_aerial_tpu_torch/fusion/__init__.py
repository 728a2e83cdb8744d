from .consistency import ViewGeometry, consistency_check
from .fuse import DepthFusion, FusionConfig

__all__ = ["ViewGeometry", "consistency_check", "DepthFusion", "FusionConfig"]
