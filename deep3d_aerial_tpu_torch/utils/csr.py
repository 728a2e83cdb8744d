"""Compressed-sparse-row container for per-point variable-length id lists.

Replaces List[np.ndarray] visibility representations whose construction and
serialization were Python loops over every fused point (millions per scene
block — reference analog: the per-vertex view lists of OpenMVS Interface
vertices, reference IO/mvs_io.py:310-375).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class VisibilityCSR:
    """`values` holds the ids of all points concatenated; `counts[i]` is how
    many belong to point i. Duck-typed as a sequence of per-point arrays."""

    __slots__ = ("values", "counts", "_offsets")

    def __init__(self, values: np.ndarray, counts: np.ndarray):
        self.values = np.asarray(values)
        self.counts = np.asarray(counts, np.int64)
        self._offsets = None

    @property
    def offsets(self) -> np.ndarray:
        if self._offsets is None:
            self._offsets = np.concatenate(
                [[0], np.cumsum(self.counts)]
            ).astype(np.int64)
        return self._offsets

    def __len__(self):
        return len(self.counts)

    def __getitem__(self, i):
        o = self.offsets
        return self.values[o[i]:o[i + 1]]

    def __iter__(self):
        o = self.offsets
        for i in range(len(self.counts)):
            yield self.values[o[i]:o[i + 1]]

    @staticmethod
    def from_lists(lists: Sequence[np.ndarray]) -> "VisibilityCSR":
        counts = np.array([len(v) for v in lists], np.int64)
        values = (np.concatenate(lists) if len(lists)
                  else np.zeros(0, np.int64))
        return VisibilityCSR(values, counts)


def remap_ids(csr: VisibilityCSR, id_to_index: dict,
              out_dtype=np.uint32) -> VisibilityCSR:
    """Vectorized id->index remap; ids absent from the map are dropped
    (per-point counts shrink accordingly)."""
    if len(csr.values) == 0:
        return VisibilityCSR(np.zeros(0, out_dtype), csr.counts.copy())
    ids = np.fromiter(id_to_index.keys(), np.int64, len(id_to_index))
    idxs = np.fromiter(id_to_index.values(), np.int64, len(id_to_index))
    vals = np.asarray(csr.values, np.int64)

    id_max = int(ids.max())
    if 0 <= int(ids.min()) and id_max < 1 << 22:
        # dense lookup table: one gather per value (image ids are small)
        lut = np.full(id_max + 2, -1, np.int64)
        lut[ids] = idxs
        safe = np.clip(vals, 0, id_max)
        mapped = lut[safe]
        ok = (vals >= 0) & (vals <= id_max) & (mapped >= 0)
    else:
        order = np.argsort(ids)
        ids, idxs = ids[order], idxs[order]
        pos = np.clip(np.searchsorted(ids, vals), 0, len(ids) - 1)
        ok = ids[pos] == vals
        mapped = idxs[pos]
    point_of = np.repeat(np.arange(len(csr.counts)), csr.counts)
    new_counts = np.bincount(
        point_of[ok], minlength=len(csr.counts)
    ).astype(np.int64)
    return VisibilityCSR(mapped[ok].astype(out_dtype), new_counts)
