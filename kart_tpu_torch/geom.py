"""Ragged vertex columns: the per-feature shape store the sidecar keeps in
its ``geom_bytes`` section, its wire encoding, and the exact predicates of
the query's refine stage.

A :class:`VertexColumn` holds, per feature, a range of rings and, per ring,
a range of vertices. Coordinates are int32 in units of 1e-5 degree
(``COORD_SCALE``); kinds are 0 none, 1 point set, 2 polyline set, 3
polygon. The section is a version byte and five KTB2 streams (kinds,
rings per feature, vertices per ring, x, y), as
:func:`encode_vertex_column` writes them.

Exactness: |coord| <= 1.8e7 < 2^25, so a coordinate difference fits 26
bits and a product of two differences 52: :func:`seg_pairs_intersect` and
:func:`ray_crossings` are exact in int64, on the host and in kernel K6.

Fail open: NULL, undecodable, empty, non-finite or out-of-world geometry
and GeometryCollections become kind-0 rows (no rings), which the refine
stage leaves at their envelope verdict.

Counterpart of kart_tpu's ``geom.py``: ``VertexColumn``,
``vertex_column_from_blobs``, ``boxes_vertex_column``,
``bbox_vertex_column``, ``encode_vertex_column`` and
``decode_vertex_column`` (the same bytes, checks and messages), and the
predicates. The host refine ``refine_pairs_host`` is K6's plain version,
in :mod:`kart_tpu_torch.ops.geom_refine`.
"""

import os

import numpy as np

from kart_tpu_torch import faults
from kart_tpu_torch.geometry import (
    LINESTRING,
    MULTILINESTRING,
    MULTIPOINT,
    MULTIPOLYGON,
    POINT,
    POLYGON,
    Geometry,
    parse_wkb,
)
from kart_tpu_torch.tiles.streams import (
    MAX_DECODE_ROWS,
    TileEncodeError,
    decode_stream,
    encode_stream,
)

#: int32 vertex units per degree (1e-5 deg, ~1.1 m)
COORD_SCALE = 100_000

WORLD_X = 180 * COORD_SCALE
WORLD_Y = 90 * COORD_SCALE

KIND_NONE, KIND_POINT, KIND_LINE, KIND_POLY = 0, 1, 2, 3

#: wire version byte of an encoded vertex column
GEOM_WIRE_VERSION = 1

def geom_refine_enabled():
    """``KART_GEOM_REFINE``: ``0`` pins every query to envelope verdicts
    (``--approx``); anything else refines exactly."""
    return os.environ.get("KART_GEOM_REFINE", "1") != "0"


_BASE_KIND = {
    POINT: KIND_POINT,
    MULTIPOINT: KIND_POINT,
    LINESTRING: KIND_LINE,
    MULTILINESTRING: KIND_LINE,
    POLYGON: KIND_POLY,
    MULTIPOLYGON: KIND_POLY,
}


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

    __slots__ = ("kinds", "feat_offsets", "ring_offsets", "x", "y", "_seg_table",
                 "_resident")

    def __init__(self, kinds, feat_offsets, ring_offsets, x, y):
        self.kinds = np.ascontiguousarray(kinds, dtype=np.uint8)
        self.feat_offsets = np.ascontiguousarray(feat_offsets, dtype=np.int64)
        self.ring_offsets = np.ascontiguousarray(ring_offsets, dtype=np.int64)
        self.x = np.ascontiguousarray(x, dtype=np.int32)
        self.y = np.ascontiguousarray(y, dtype=np.int32)
        self._seg_table = None
        self._resident = {}  # device -> segment table tensors (ops.geom_refine)

    def __len__(self):
        return len(self.kinds)

    @classmethod
    def empty(cls, n):
        """n kind-0 rows (no usable geometry)."""
        return cls(np.zeros(n, np.uint8), np.zeros(n + 1, np.int64), np.zeros(1, np.int64),
                   np.zeros(0, np.int32), np.zeros(0, np.int32))

    def usable(self):
        """bool (N,): the rows the refine stage may trust (kind != 0)."""
        return self.kinds != KIND_NONE

    def rings(self, i):
        """Feature i -> list of (x int32 (k,), y (k,)) vertex rings."""
        out = []
        for r in range(int(self.feat_offsets[i]), int(self.feat_offsets[i + 1])):
            v0, v1 = int(self.ring_offsets[r]), int(self.ring_offsets[r + 1])
            out.append((self.x[v0:v1], self.y[v0:v1]))
        return out

    def segments(self, i):
        """Feature i -> (x0, y0, x1, y1) int64 segment endpoints: a
        k-vertex ring gives its k-1 consecutive segments, a polygon ring
        also its closing edge, a 1-vertex ring (a point) one zero-length
        segment."""
        poly = self.kinds[i] == KIND_POLY
        x0s, y0s, x1s, y1s = [], [], [], []
        for xs, ys in self.rings(i):
            if len(xs) == 1:
                x0s.append(xs)
                y0s.append(ys)
                x1s.append(xs)
                y1s.append(ys)
            elif poly:
                x0s.append(xs)
                y0s.append(ys)
                x1s.append(np.roll(xs, -1))
                y1s.append(np.roll(ys, -1))
            else:
                x0s.append(xs[:-1])
                y0s.append(ys[:-1])
                x1s.append(xs[1:])
                y1s.append(ys[1:])
        if not x0s:
            z = np.zeros(0, np.int64)
            return z, z, z, z
        return tuple(np.concatenate(parts).astype(np.int64) for parts in (x0s, y0s, x1s, y1s))

    def segment_table(self):
        """The whole column's segments, built once and cached: ``(x0, y0,
        x1, y1, offs)``, int32 (S,) endpoints in :meth:`segments` order and
        int64 ``offs`` (N+1,), feature i's segments being
        ``[offs[i], offs[i+1])``."""
        if self._seg_table is not None:
            return self._seg_table
        n_feat = len(self.kinds)
        ring_counts = np.diff(self.feat_offsets)
        k = np.diff(self.ring_offsets)  # vertices per ring
        ring_feat = np.repeat(np.arange(n_feat, dtype=np.int64), ring_counts)
        poly_ring = self.kinds[ring_feat] == KIND_POLY
        segc = np.where(k == 1, 1, np.where(poly_ring, k, np.maximum(k - 1, 0))).astype(np.int64)
        start, _ = _gather_ranges(self.ring_offsets[:-1], self.ring_offsets[:-1] + segc)
        ring_of = np.repeat(np.arange(len(k), dtype=np.int64), segc)
        base = self.ring_offsets[:-1][ring_of]
        local = start - base
        kk = k[ring_of]
        end_local = np.where(
            kk <= 1, local,
            np.where(poly_ring[ring_of], (local + 1) % np.maximum(kk, 1), local + 1),
        )
        end = base + end_local
        per_ring_offs = np.concatenate(([0], np.cumsum(segc)))
        offs = per_ring_offs[self.feat_offsets]
        self._seg_table = (self.x[start], self.y[start], self.x[end], self.y[end], offs)
        return self._seg_table

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

    @classmethod
    def concat(cls, cols):
        """Row concatenation (a derived sidecar's kept rows, then its added
        ones)."""
        cols = list(cols)
        ring_counts = np.concatenate([np.diff(c.feat_offsets) for c in cols])
        vert_counts = np.concatenate([np.diff(c.ring_offsets) for c in cols])
        return cls(
            np.concatenate([c.kinds for c in cols]),
            np.concatenate(([0], np.cumsum(ring_counts))),
            np.concatenate(([0], np.cumsum(vert_counts))),
            np.concatenate([c.x for c in cols]),
            np.concatenate([c.y for c in cols]),
        )


# --- extraction: GPKG blobs -> VertexColumn ----------------------------------

def _value_rings(value):
    """GeomValue -> (kind, list of point lists), or (0, []) for a shape with
    no columnar form (a GeometryCollection, or empty)."""
    base = value.base_type
    kind = _BASE_KIND.get(base)
    if kind is None:
        return KIND_NONE, []
    payload = value.payload
    if base == POINT:
        rings = [] if payload is None else [[payload]]
    elif base == MULTIPOINT:
        rings = [[c.payload] for c in payload if c.payload is not None]
    elif base == LINESTRING:
        rings = [payload] if payload else []
    elif base == MULTILINESTRING:
        rings = [c.payload for c in payload if c.payload]
    elif base == POLYGON:
        rings = [r for r in payload if r]
    else:  # MULTIPOLYGON
        rings = [r for c in payload for r in c.payload if r]
    if not rings:
        return KIND_NONE, []
    return kind, rings


def _quantize_rings(rings):
    """point lists -> (x int32 chunks, y chunks, vertex counts), or None
    when a coordinate is non-finite or outside the world (the feature
    becomes kind 0)."""
    xs, ys, counts = [], [], []
    for ring in rings:
        pts = np.asarray([(p[0], p[1]) for p in ring], dtype=np.float64)
        if not np.isfinite(pts).all():
            return None
        q = np.rint(pts * COORD_SCALE)
        if (np.abs(q[:, 0]).max(initial=0) > WORLD_X
                or np.abs(q[:, 1]).max(initial=0) > WORLD_Y):
            return None
        xs.append(q[:, 0].astype(np.int32))
        ys.append(q[:, 1].astype(np.int32))
        counts.append(len(ring))
    return xs, ys, counts


def vertex_column_from_blobs(blobs):
    """Iterable of GPKG geometry blobs (or None) -> VertexColumn, a row per
    blob in order; a blob that does not parse becomes kind 0. The
    ``geom.extract`` fault fires before any row is built."""
    hook = faults.hook("geom.extract")
    if hook is not None:
        hook()
    kinds, ring_counts, vert_counts = [], [], []
    x_chunks, y_chunks = [], []
    for blob in blobs:
        kind = KIND_NONE
        rings = []
        if blob:
            try:
                g = Geometry.of(bytes(blob))
                if g is not None and not g.is_empty:
                    kind, rings = _value_rings(parse_wkb(g.to_wkb()))
            except Exception:
                kind, rings = KIND_NONE, []
        if kind != KIND_NONE:
            q = _quantize_rings(rings)
            if q is None:
                kind, rings = KIND_NONE, []
            else:
                xs, ys, counts = q
                x_chunks.extend(xs)
                y_chunks.extend(ys)
                vert_counts.extend(counts)
        kinds.append(kind)
        ring_counts.append(len(rings) if kind != KIND_NONE else 0)
    return VertexColumn(
        np.asarray(kinds, np.uint8),
        np.concatenate(([0], np.cumsum(np.asarray(ring_counts, np.int64)))),
        np.concatenate(([0], np.cumsum(np.asarray(vert_counts, np.int64)))),
        np.concatenate(x_chunks) if x_chunks else np.zeros(0, np.int32),
        np.concatenate(y_chunks) if y_chunks else np.zeros(0, np.int32),
    )


# --- the wire codec of the sidecar's geom section ------------------------------

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


def decode_vertex_column(data, count, pos=0):
    """Section bytes at ``pos`` -> (VertexColumn of ``count`` rows, next
    pos). A taint boundary: only :class:`TileEncodeError` escapes. Kinds in
    [0, 3] with kind 0 exactly where a feature has no ring, counts positive
    where required and totalling at most ``MAX_DECODE_ROWS`` (summed in
    Python: no int64 wrap), coordinates inside the world, every stream
    canonical and consumed exactly."""
    if count < 0 or count > MAX_DECODE_ROWS:
        raise TileEncodeError(f"Vertex column row count {count} out of range")
    if pos + 1 > len(data):
        raise TileEncodeError("Truncated vertex column: no version byte")
    version = data[pos]
    if version != GEOM_WIRE_VERSION:
        raise TileEncodeError(f"Unknown vertex column version {version}")
    pos += 1
    kinds, pos = decode_stream(data, count, "i8", pos)
    if len(kinds) and (int(kinds.min()) < 0 or int(kinds.max()) > KIND_POLY):
        raise TileEncodeError("Vertex column kind outside [0, 3]")
    ring_counts, pos = decode_stream(data, count, "i8", pos)
    if np.any((kinds == KIND_NONE) != (ring_counts == 0)):
        raise TileEncodeError("Vertex column kind/ring-count mismatch")
    if len(ring_counts) and int(ring_counts.min()) < 0:
        raise TileEncodeError("Negative ring count")
    n_rings = sum(int(c) for c in ring_counts)
    if n_rings > MAX_DECODE_ROWS:
        raise TileEncodeError(f"Vertex column holds {n_rings} rings (cap {MAX_DECODE_ROWS})")
    vert_counts, pos = decode_stream(data, n_rings, "i8", pos)
    if len(vert_counts) and int(vert_counts.min()) < 1:
        raise TileEncodeError("Vertex ring with fewer than 1 vertex")
    n_verts = sum(int(c) for c in vert_counts)
    if n_verts > MAX_DECODE_ROWS:
        raise TileEncodeError(f"Vertex column holds {n_verts} vertices (cap {MAX_DECODE_ROWS})")
    x, pos = decode_stream(data, n_verts, "i4", pos)
    y, pos = decode_stream(data, n_verts, "i4", pos)
    if len(x) and (int(np.abs(x.astype(np.int64)).max()) > WORLD_X
                   or int(np.abs(y.astype(np.int64)).max()) > WORLD_Y):
        raise TileEncodeError("Vertex coordinate outside world range")
    return (
        VertexColumn(
            kinds.astype(np.uint8),
            np.concatenate(([0], np.cumsum(ring_counts))),
            np.concatenate(([0], np.cumsum(vert_counts))),
            x,
            y,
        ),
        pos,
    )


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


def bbox_vertex_column(query):
    """``--bbox`` wsen rectangle -> a one-row polygon VertexColumn, or None
    for a rectangle wrapping the anti-meridian (e < w), which keeps its
    envelope verdicts."""
    col = boxes_vertex_column(np.asarray(query, dtype=np.float64)[None, :])
    return col if col.kinds[0] != KIND_NONE else None


# --- the exact predicates: operator-only int64 formulas ------------------------

def seg_pairs_intersect(ax0, ay0, ax1, ay1, bx0, by0, bx1, by1):
    """Elementwise (broadcasting) inclusive segment intersection, int64 in,
    bool out: the straddle test, then the collinear or endpoint touch. A
    zero-length segment is a point. Operator-only, so numpy and torch
    tensors evaluate the same expression tree."""
    d1 = (bx1 - bx0) * (ay0 - by0) - (by1 - by0) * (ax0 - bx0)
    d2 = (bx1 - bx0) * (ay1 - by0) - (by1 - by0) * (ax1 - bx0)
    d3 = (ax1 - ax0) * (by0 - ay0) - (ay1 - ay0) * (bx0 - ax0)
    d4 = (ax1 - ax0) * (by1 - ay0) - (ay1 - ay0) * (bx1 - ax0)
    straddle = (((d1 > 0) & (d2 < 0)) | ((d1 < 0) & (d2 > 0))) & (
        ((d3 > 0) & (d4 < 0)) | ((d3 < 0) & (d4 > 0))
    )
    # d == 0 puts the point on the carrier line; the products pin it
    # inside the segment's span
    t1 = (d1 == 0) & ((bx0 - ax0) * (bx1 - ax0) <= 0) & ((by0 - ay0) * (by1 - ay0) <= 0)
    t2 = (d2 == 0) & ((bx0 - ax1) * (bx1 - ax1) <= 0) & ((by0 - ay1) * (by1 - ay1) <= 0)
    t3 = (d3 == 0) & ((ax0 - bx0) * (ax1 - bx0) <= 0) & ((ay0 - by0) * (ay1 - by0) <= 0)
    t4 = (d4 == 0) & ((ax0 - bx1) * (ax1 - bx1) <= 0) & ((ay0 - by1) * (ay1 - by1) <= 0)
    return straddle | t1 | t2 | t3 | t4


def ray_crossings(px, py, sx0, sy0, sx1, sy1):
    """Elementwise upward-ray crossing indicator of the even-odd rule, int64
    in, bool out: the half-open vertex rule ``(sy0 <= py) != (sy1 <= py)``
    counts each boundary vertex once; the left-of test is the exact cross
    product. Callers sum over segments and take the parity."""
    upward = (sy0 <= py) != (sy1 <= py)
    cr = (sx1 - sx0) * (py - sy0) - (sy1 - sy0) * (px - sx0)
    left = ((sy1 > sy0) & (cr > 0)) | ((sy1 < sy0) & (cr < 0))
    return upward & left
