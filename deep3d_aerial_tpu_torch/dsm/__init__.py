from .rasterize import DSMFromPointCloud, DSMFromMesh, DSMConfig

__all__ = ["DSMFromPointCloud", "DSMFromMesh", "DSMConfig"]
