from .reconstruct import (MeshConfig, create_mesh_from_ply,
                          create_mesh_from_scene, delaunay_mesh_25d,
                          reconstruct_graphcut_from_mvs)
from .refine import PhotoRefineConfig, RefineConfig

__all__ = ["MeshConfig", "create_mesh_from_ply", "create_mesh_from_scene",
           "delaunay_mesh_25d", "reconstruct_graphcut_from_mvs",
           "PhotoRefineConfig", "RefineConfig"]
