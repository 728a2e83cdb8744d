"""Loader for the reference's OpenMVS mesh config YAML.

The reference drives the three OpenMVS binaries with a YAML whose keys map
1:1 onto CLI flags (reference mesh/config.yaml, consumed by
createmesh.py:51-141). This loader accepts that exact file and maps each
implemented key onto our stage configs, so a reference user's tuned
mesh config drops into this framework unchanged.

Keys without an equivalent in our redesign (process priority, archive
types, CUDA toggles, hidden file-name overrides) are accepted and
ignored; ignored keys are reported so nothing fails silently.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from .reconstruct import MeshConfig
from .refine import PhotoRefineConfig, RefineConfig

# keys that are deliberately not applicable to the in-process redesign
_IGNORED = {
    "strExportType", "nArchiveType", "nProcessPriority", "nMaxThreads",
    "strMeshFileName", "bMeshExport", "strImagePointsFileName", "bUseCUDA",
    "nReduceMemory", "nAlternatePair", "nResolutionLevel", "nMinResolution",
    "fSplitMaxArea", "bUseConstantWeight", "bUseFreeSpaceSupport",
    "nEnsureEdgeSize", "nMaxFaceArea", "fScaleStep",
    "fRatioRigidityElasticity", "fPlanarVertexRatio", "nOrthoMapResolution",
}


def load_openmvs_mesh_config(
    path,
) -> Tuple[MeshConfig, RefineConfig, PhotoRefineConfig, Dict[str, Any]]:
    """Parse an OpenMVS-style mesh YAML -> (MeshConfig, RefineConfig,
    PhotoRefineConfig, texture_kwargs). Unknown keys raise; known-but-
    inapplicable keys are collected in texture_kwargs['ignored']."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f) or {}

    mesh = MeshConfig()
    refine = RefineConfig()
    photo = PhotoRefineConfig()
    tex: Dict[str, Any] = {}
    ignored = []

    rec = doc.get("RECONSTRUCTMESH", {}) or {}
    for k, v in rec.items():
        if k == "fDistInsert":
            mesh.insert_distance = float(v)
        elif k == "fDecimateMesh":
            mesh.decimate_ratio = float(v)
        elif k == "fQualityFactor":
            mesh.quality_factor = float(v)
        elif k == "fThicknessFactor":
            mesh.thickness_factor = float(v)
        elif k == "fRemoveSpurious":
            mesh.remove_spurious = int(float(v))
        elif k == "bRemoveSpikes":
            mesh.remove_spikes = bool(v)
        elif k == "nCloseHoles":
            mesh.close_holes = int(v)
        elif k == "nSmoothMesh":
            mesh.smooth_mesh = int(v)
        elif k == "nTargetFaceNum":
            mesh.target_face_num = int(v)
        elif k in _IGNORED:
            ignored.append(f"RECONSTRUCTMESH.{k}")
        else:
            raise KeyError(f"unknown RECONSTRUCTMESH key: {k}")

    ref = doc.get("REFINEMESH", {}) or {}
    for k, v in ref.items():
        if k == "nScales":
            photo.scales = max(1, int(v))
        elif k == "fRegularityWeight":
            photo.regularity_weight = float(v)
        elif k == "fGradientStep":
            # OpenMVS expresses the step in image-pixel units (45.05 in
            # the shipped config); ours is x mean-edge-length. Normalize
            # by the same 45.05 reference point so the shipped file maps
            # to our default 0.05.
            photo.gradient_step = float(v) / 45.05 * 0.05
        elif k == "nMaxViews":
            photo.max_views = int(v)
        elif k == "fDecimateMesh":
            refine.decimate_ratio = float(v)
        elif k == "nCloseHoles":
            tex.setdefault("refine_close_holes", int(v))
        elif k in _IGNORED:
            ignored.append(f"REFINEMESH.{k}")
        else:
            raise KeyError(f"unknown REFINEMESH key: {k}")

    texb = doc.get("TEXTUREMESH", {}) or {}
    for k, v in texb.items():
        if k == "nColEmpty":
            c = int(v) & 0xFFFFFF
            tex["empty_color"] = ((c >> 16) & 255, (c >> 8) & 255, c & 255)
        elif k == "fOutlierThreshold":
            tex["outlier_threshold"] = float(v)
        elif k == "bLocalSeamLeveling":
            tex["seam_level"] = bool(v)
        elif k == "bGlobalSeamLeveling":
            tex["global_seam_level"] = bool(v)
        elif k == "nTextureSizeMultiple":
            tex["size_multiple"] = int(v)
        elif k == "nRectPackingHeuristic":
            tex["packing_heuristic"] = int(v)
        elif k == "fRatioDataSmoothness":
            tex["data_smoothness_ratio"] = float(v)
        elif k == "fDecimateMesh":
            tex["decimate_ratio"] = float(v)
        elif k == "nCloseHoles":
            tex.setdefault("close_holes", int(v))
        elif k in _IGNORED:
            ignored.append(f"TEXTUREMESH.{k}")
        else:
            raise KeyError(f"unknown TEXTUREMESH key: {k}")

    tex["ignored"] = ignored
    return mesh, refine, photo, tex
