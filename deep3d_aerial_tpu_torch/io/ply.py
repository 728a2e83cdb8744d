"""Binary PLY point-cloud codec (xyz + optional normals + colors).

Own implementation of the subset the pipeline produces/consumes
(capability parity with reference IO/points_io.py:20-113, which uses
the external `plyfile` package): binary_little_endian 1.0, float32
x y z [nx ny nz] + uchar [red green blue].
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def write_ply(
    path,
    points: np.ndarray,
    normals: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
) -> None:
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = points.shape[0]

    names = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    header = [
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {n}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if normals is not None:
        normals = np.asarray(normals, dtype=np.float32).reshape(-1, 3)
        names += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        header += ["property float nx", "property float ny", "property float nz"]
    if colors is not None:
        colors = np.asarray(colors).reshape(-1, 3)
        if colors.dtype != np.uint8:
            colors = np.clip(colors, 0, 255).astype(np.uint8)
        names += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += ["end_header"]

    rec = np.empty(n, dtype=names)
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    if normals is not None:
        rec["nx"], rec["ny"], rec["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    if colors is not None:
        rec["red"], rec["green"], rec["blue"] = colors[:, 0], colors[:, 1], colors[:, 2]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        rec.tofile(f)


_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """Read a PLY vertex cloud -> (points, normals|None, colors|None).

    Supports binary_little_endian and ascii with scalar vertex properties.
    """
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertex = 0
        props = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.strip().decode("ascii", "replace").split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                in_vertex = tokens[1] == "vertex"
                if in_vertex:
                    n_vertex = int(tokens[2])
            elif tokens[0] == "property" and in_vertex:
                if tokens[1] == "list":
                    raise ValueError(f"{path}: list vertex properties unsupported")
                props.append((tokens[2], _PLY_TYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break

        if fmt == "binary_little_endian":
            dtype = np.dtype([(nm, "<" + t) for nm, t in props])
            rec = np.fromfile(f, dtype=dtype, count=n_vertex)
        elif fmt == "ascii":
            data = np.loadtxt(f, max_rows=n_vertex, ndmin=2)
            rec = np.core.records.fromarrays(
                [data[:, i] for i in range(len(props))],
                dtype=[(nm, t) for nm, t in props],
            )
        else:
            raise ValueError(f"{path}: unsupported PLY format {fmt}")

    names = {nm for nm, _ in props}
    pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=-1).astype(np.float32)
    normals = None
    if {"nx", "ny", "nz"} <= names:
        normals = np.stack([rec["nx"], rec["ny"], rec["nz"]], -1).astype(np.float32)
    colors = None
    if {"red", "green", "blue"} <= names:
        colors = np.stack([rec["red"], rec["green"], rec["blue"]], -1).astype(np.uint8)
    return pts, normals, colors
