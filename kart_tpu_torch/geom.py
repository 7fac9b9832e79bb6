"""Ragged vertex columns: the per-feature shape store the sidecar keeps in
its ``geom_bytes`` section, and its wire encoding.

A :class:`VertexColumn` holds, per feature, a range of rings and, per ring,
a range of vertices. Coordinates are int32 in units of 1e-5 degree
(``COORD_SCALE``); kinds are 0 none, 1 point set, 2 polyline set, 3
polygon. The section is a version byte and five KTB2 streams (kinds,
rings per feature, vertices per ring, x, y), as
:func:`encode_vertex_column` writes them.

Counterpart of the write half of kart_tpu's ``geom.py``:
``VertexColumn`` (``take``, ``empty``), ``boxes_vertex_column`` and
``encode_vertex_column``, byte for byte. Decoding, extraction from blobs
and the exact refine predicates are not ported.
"""

import numpy as np

from kart_tpu_torch.tiles.streams import encode_stream

#: int32 vertex units per degree (1e-5 deg, ~1.1 m)
COORD_SCALE = 100_000

KIND_NONE, KIND_POINT, KIND_LINE, KIND_POLY = 0, 1, 2, 3

#: wire version byte of an encoded vertex column
GEOM_WIRE_VERSION = 1


def _gather_ranges(lo, hi):
    """Concatenated ``arange(lo[i], hi[i])`` without a Python loop
    -> (indices int64 (sum(hi-lo),), counts int64 (len(lo),))."""
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64), counts
    offs = np.concatenate(([0], np.cumsum(counts)[:-1]))
    idx = np.arange(total, dtype=np.int64)
    return idx - np.repeat(offs - lo, counts), counts


class VertexColumn:
    """Ragged per-feature vertex store, in block-row order.

    ``feat_offsets`` int64 (N+1,): the ring range of feature i;
    ``ring_offsets`` int64 (R+1,): the vertex range of each ring;
    ``x``/``y`` int32 (V,) quantized lon/lat; ``kinds`` uint8 (N,).
    """

    __slots__ = ("kinds", "feat_offsets", "ring_offsets", "x", "y")

    def __init__(self, kinds, feat_offsets, ring_offsets, x, y):
        self.kinds = np.ascontiguousarray(kinds, dtype=np.uint8)
        self.feat_offsets = np.ascontiguousarray(feat_offsets, dtype=np.int64)
        self.ring_offsets = np.ascontiguousarray(ring_offsets, dtype=np.int64)
        self.x = np.ascontiguousarray(x, dtype=np.int32)
        self.y = np.ascontiguousarray(y, dtype=np.int32)

    def __len__(self):
        return len(self.kinds)

    @classmethod
    def empty(cls, n):
        """n kind-0 rows (no usable geometry)."""
        return cls(np.zeros(n, np.uint8), np.zeros(n + 1, np.int64), np.zeros(1, np.int64),
                   np.zeros(0, np.int32), np.zeros(0, np.int32))

    def take(self, indices):
        """Row gather -> a new VertexColumn (vectorized)."""
        idx = np.asarray(indices, dtype=np.int64)
        ring_idx, ring_counts = _gather_ranges(self.feat_offsets[idx], self.feat_offsets[idx + 1])
        vert_idx, vert_counts = _gather_ranges(
            self.ring_offsets[ring_idx], self.ring_offsets[ring_idx + 1]
        )
        return VertexColumn(
            self.kinds[idx],
            np.concatenate(([0], np.cumsum(ring_counts))),
            np.concatenate(([0], np.cumsum(vert_counts))),
            self.x[vert_idx],
            self.y[vert_idx],
        )


def encode_vertex_column(col):
    """VertexColumn -> section bytes: the version byte, then the KTB2
    streams of kinds, rings per feature, vertices per ring, x and y."""
    return b"".join((
        bytes([GEOM_WIRE_VERSION]),
        encode_stream(col.kinds.astype(np.int64), "i8"),
        encode_stream(np.diff(col.feat_offsets), "i8"),
        encode_stream(np.diff(col.ring_offsets), "i8"),
        encode_stream(col.x.astype(np.int64), "i4"),
        encode_stream(col.y.astype(np.int64), "i4"),
    ))


def boxes_vertex_column(env):
    """(N, 4) wsen degree envelopes -> a VertexColumn of one 5-point box
    polygon per row. Non-finite or wrapping (e < w) rows become kind 0;
    coordinates clip to the world range before quantizing."""
    env = np.asarray(env, dtype=np.float64)
    n = len(env)
    if not n:
        return VertexColumn.empty(0)
    ok = np.isfinite(env).all(axis=1) & (env[:, 2] >= env[:, 0])
    qw = np.rint(np.clip(env[:, 0], -180.0, 180.0) * COORD_SCALE).astype(np.int64)
    qs = np.rint(np.clip(env[:, 1], -90.0, 90.0) * COORD_SCALE).astype(np.int64)
    qe = np.rint(np.clip(env[:, 2], -180.0, 180.0) * COORD_SCALE).astype(np.int64)
    qn = np.rint(np.clip(env[:, 3], -90.0, 90.0) * COORD_SCALE).astype(np.int64)
    idx = np.flatnonzero(ok)
    x = np.stack([qw, qe, qe, qw, qw], axis=1)[idx].ravel().astype(np.int32)
    y = np.stack([qs, qs, qn, qn, qs], axis=1)[idx].ravel().astype(np.int32)
    kinds = np.where(ok, KIND_POLY, KIND_NONE).astype(np.uint8)
    return VertexColumn(
        kinds,
        np.concatenate(([0], np.cumsum(ok.astype(np.int64)))),
        np.arange(len(idx) + 1, dtype=np.int64) * 5,
        x,
        y,
    )
