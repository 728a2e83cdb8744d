"""Triangle-mesh PLY IO (vertices + faces + optional vertex colors)."""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np


def write_mesh_ply(
    path,
    vertices: np.ndarray,
    faces: np.ndarray,
    colors: Optional[np.ndarray] = None,
) -> None:
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    faces = np.asarray(faces, np.int32).reshape(-1, 3)
    n, m = len(vertices), len(faces)

    header = [
        "ply", "format binary_little_endian 1.0",
        f"element vertex {n}",
        "property float x", "property float y", "property float z",
    ]
    if colors is not None:
        colors = np.clip(np.asarray(colors), 0, 255).astype(np.uint8).reshape(-1, 3)
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [
        f"element face {m}",
        "property list uchar int vertex_indices",
        "end_header",
    ]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if colors is not None:
            rec = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                     ("r", "u1"), ("g", "u1"), ("b", "u1")])
            rec["x"], rec["y"], rec["z"] = vertices.T
            rec["r"], rec["g"], rec["b"] = colors.T
        else:
            rec = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
            rec["x"], rec["y"], rec["z"] = vertices.T
        rec.tofile(f)
        frec = np.empty(m, dtype=[("k", "u1"), ("a", "<i4"), ("b", "<i4"),
                                  ("c", "<i4")])
        frec["k"] = 3
        frec["a"], frec["b"], frec["c"] = faces.T
        frec.tofile(f)


def read_mesh_ply(path) -> Tuple[np.ndarray, np.ndarray]:
    """Read vertices + triangle faces from a binary little-endian PLY."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY")
        fmt = None
        n_vertex = n_face = 0
        vprops = []
        fprops = []  # face properties: ("list", ctype, itype, name) | scalar
        element = None
        while True:
            tokens = f.readline().strip().decode("ascii", "replace").split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                element = tokens[1]
                if element == "vertex":
                    n_vertex = int(tokens[2])
                elif element == "face":
                    n_face = int(tokens[2])
            elif tokens[0] == "property" and element == "vertex":
                if tokens[1] != "list":
                    vprops.append((tokens[2], tokens[1]))
            elif tokens[0] == "property" and element == "face":
                if tokens[1] == "list":
                    fprops.append(("list", tokens[2], tokens[3], tokens[4]))
                else:
                    fprops.append(("scalar", tokens[1], None, tokens[2]))
            elif tokens[0] == "end_header":
                break
        if fmt != "binary_little_endian":
            raise ValueError(f"{path}: only binary_little_endian supported")

        tmap = {"float": "<f4", "double": "<f8", "uchar": "u1", "char": "i1",
                "int": "<i4", "uint": "<u4", "short": "<i2", "ushort": "<u2"}
        dtype = np.dtype([(nm, tmap[t]) for nm, t in vprops])
        rec = np.fromfile(f, dtype=dtype, count=n_vertex)
        verts = np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(np.float32)

        if not fprops:  # headers written before face-prop tracking
            fprops = [("list", "uchar", "int", "vertex_indices")]
        sizes = {"float": 4, "double": 8, "uchar": 1, "char": 1, "int": 4,
                 "uint": 4, "short": 2, "ushort": 2}
        faces = np.empty((n_face, 3), np.int32)
        for i in range(n_face):
            for kind, t1, t2, name in fprops:
                if kind == "list":
                    k = int(np.frombuffer(f.read(sizes[t1]), tmap[t1])[0])
                    data = f.read(sizes[t2] * k)
                    if name == "vertex_indices":
                        faces[i] = np.frombuffer(data, tmap[t2])[:3]
                else:
                    f.read(sizes[t1])
    return verts, faces
