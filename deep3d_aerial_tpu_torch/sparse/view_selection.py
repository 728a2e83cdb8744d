"""Scene blocking + reference/source view selection.

Capability parity with reference pycolmap/view_selection.py, but the
per-point Python loops (reference :69-143, O(points x views)) are replaced by
vectorized CSR track arrays + bincount — the whole selection runs in
milliseconds instead of minutes on large sparse models.

Semantics preserved:
  * blocks tile the scene border xy-plane with `block_size` and `overlap`
    (reference :53-64)
  * a block's reference views = all images observing a triangulated point
    whose xy falls in the block (reference :69-84)
  * source scoring 'triangulated_points': co-visibility count over the ref's
    tracked points; keep srcs with count > 10 and count > max/10; require
    >3 co-visible views total (reference :118-143)
  * source scoring 'tie_points': raw match counts from database.db normalized
    per ref (reference :87-115)
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import colmap


class TrackIndex:
    """CSR layout of point->image visibility built once from a COLMAP model."""

    def __init__(self, images: Dict[int, colmap.ColmapImage],
                 points: Dict[int, colmap.ColmapPoint3D]):
        pids = np.array(sorted(k for k in points.keys() if k > 0), dtype=np.int64)
        self.point_ids = pids
        self.xyz = np.stack([points[p].xyz for p in pids]) if len(pids) else np.zeros((0, 3))

        # point -> images CSR
        lens = np.array([len(points[p].image_ids) for p in pids], dtype=np.int64)
        self.track_offsets = np.concatenate([[0], np.cumsum(lens)])
        self.track_image_ids = (
            np.concatenate([points[p].image_ids for p in pids])
            if len(pids)
            else np.zeros(0, np.int64)
        )

        # image -> point-row indices (into self.xyz) for tracked points
        self.image_point_rows: Dict[int, np.ndarray] = {}
        for iid, im in images.items():
            valid = im.point3D_ids[im.point3D_ids > 0]
            rows = np.searchsorted(pids, valid)
            rows = rows[(rows < len(pids)) & (pids[np.minimum(rows, len(pids) - 1)] == valid)]
            self.image_point_rows[iid] = rows

        self.max_image_id = int(max(images.keys())) if images else 0

    def images_seeing_rows(self, rows: np.ndarray) -> np.ndarray:
        """All image ids appearing in the tracks of the given point rows."""
        if len(rows) == 0:
            return np.zeros(0, np.int64)
        segments = [
            self.track_image_ids[self.track_offsets[r]: self.track_offsets[r + 1]]
            for r in rows
        ]
        return np.concatenate(segments) if segments else np.zeros(0, np.int64)

    def covisibility_counts(self, ref_image_id: int) -> np.ndarray:
        """bincount over image ids of how many of ref's points each image sees."""
        seen = self.images_seeing_rows(self.image_point_rows.get(ref_image_id,
                                                                 np.zeros(0, np.int64)))
        return np.bincount(seen, minlength=self.max_image_id + 1)


def compute_scene_blocks(
    xyz: np.ndarray,
    block_size: Optional[Sequence[float]] = None,
    overlap: float = 1.0,
    bbx_border: Optional[Sequence[float]] = None,
) -> Tuple[List[List[float]], List[float]]:
    """Tile the scene into xy blocks.

    Returns (blocks, scene_border); each block/border is
    [x_min, x_max, y_min, y_max, z_min, z_max].
    """
    if len(xyz):
        min_x, max_x = np.percentile(xyz[:, 0], [0.5, 99.5])
        min_y, max_y = np.percentile(xyz[:, 1], [0.5, 99.5])
        min_z, max_z = np.percentile(xyz[:, 2], [0.5, 99.5])
    else:
        min_x = max_x = min_y = max_y = min_z = max_z = 0.0

    border = (
        list(bbx_border)
        if bbx_border is not None
        else [min_x, max_x, min_y, max_y, min_z, max_z]
    )

    if block_size is not None:
        size = [float(v) for v in block_size]
    else:
        size = [(max_x - min_x) / 2.0, (max_y - min_y) / 2.0, (max_z - min_z)]

    nx = max(1, math.ceil((border[1] - border[0]) / size[0]))
    ny = max(1, math.ceil((border[3] - border[2]) / size[1]))

    blocks = []
    for j in range(ny):
        for i in range(nx):
            x0 = border[0] + i * size[0] - overlap
            y0 = border[2] + j * size[1] - overlap
            blocks.append(
                [x0, x0 + size[0] + overlap, y0, y0 + size[1] + overlap,
                 float(min_z), float(max_z)]
            )
    return blocks, border


def references_in_block(index: TrackIndex, block: Sequence[float]) -> List[int]:
    """Image ids observing a triangulated point inside the block's xy range."""
    if len(index.xyz) == 0:
        return []
    m = (
        (index.xyz[:, 0] > block[0]) & (index.xyz[:, 0] < block[1])
        & (index.xyz[:, 1] > block[2]) & (index.xyz[:, 1] < block[3])
    )
    rows = np.nonzero(m)[0]
    seen = index.images_seeing_rows(rows)
    return sorted(set(int(i) for i in seen))


def score_triangulated(
    index: TrackIndex, ref_ids: Sequence[int]
) -> List[Tuple[int, List[Tuple[int, float]]]]:
    """Co-visibility scores for each candidate reference view."""
    out = []
    for ref in ref_ids:
        counts = index.covisibility_counts(ref)
        covis = np.nonzero(counts)[0]
        if len(covis) <= 3:  # require MVS: >3 co-visible views incl. ref
            continue
        covis = covis[covis != ref]
        order = np.argsort(-counts[covis], kind="stable")
        covis = covis[order]
        best = counts[covis[0]] if len(covis) else 0
        keep = [
            (int(s), float(counts[s]))
            for s in covis
            if counts[s] > 10 and counts[s] > best / 10.0
        ]
        out.append((int(ref), keep))
    return out


def score_tie_points(
    matches: Dict[int, np.ndarray], ref_ids: Sequence[int]
) -> List[Tuple[int, List[Tuple[int, float]]]]:
    """Match-count scores (normalized per ref) from the COLMAP database."""
    per_ref: Dict[int, Dict[int, int]] = {int(r): {} for r in ref_ids}
    for pair_id, arr in matches.items():
        i1, i2 = colmap.pair_id_to_image_ids(pair_id)
        n = arr.shape[0]
        if i1 in per_ref:
            per_ref[i1][i2] = per_ref[i1].get(i2, 0) + n
        if i2 in per_ref:
            per_ref[i2][i1] = per_ref[i2].get(i1, 0) + n

    out = []
    for ref in per_ref:
        total = sum(per_ref[ref].values())
        if total == 0 or len(per_ref[ref]) <= 2:
            continue
        pairs = sorted(per_ref[ref].items(), key=lambda kv: kv[1], reverse=True)
        out.append((ref, [(int(s), n / total) for s, n in pairs]))
    return out


def select_views(
    sparse_path: str,
    blocks: Sequence[Sequence[float]],
    mode: str = "triangulated_points",
    database_path: Optional[str] = None,
) -> Tuple[
    List[Tuple[List[float], List[int]]],
    List[Tuple[int, List[Tuple[int, float]]]],
]:
    """Per-block reference selection + global viewpair scoring.

    Returns (block_refs, viewpairs):
      block_refs : [(block_bbx, [ref ids scored in that block])]
      viewpairs  : [(ref_id, [(src_id, score), ...])], deduplicated
    """
    cameras, images, points = colmap.read_model(sparse_path)
    index = TrackIndex(images, points)

    matches = None
    if mode == "tie_points":
        if database_path is None or not os.path.exists(database_path):
            raise FileNotFoundError(
                f"tie_points mode needs database.db (got {database_path!r})"
            )
        matches = colmap.read_matches(database_path)
    elif mode != "triangulated_points":
        raise ValueError(f"unknown view selection mode {mode!r}")

    block_refs: List[Tuple[List[float], List[int]]] = []
    viewpairs: List[Tuple[int, List[Tuple[int, float]]]] = []
    seen_refs = set()

    for block in blocks:
        refs = references_in_block(index, block)
        if mode == "triangulated_points":
            score = score_triangulated(index, refs)
        else:
            score = score_tie_points(matches, refs)
        if score:
            block_refs.append((list(block), [s[0] for s in score]))
        for s in score:
            if s[0] not in seen_refs:
                seen_refs.add(s[0])
                viewpairs.append(s)

    return block_refs, viewpairs
