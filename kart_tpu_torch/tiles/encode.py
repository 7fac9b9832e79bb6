"""Tile payload encoding. A payload is one self-describing byte string,
deterministic for a given (commit, dataset, z/x/y, layers, extent, buffer):

    [8-byte big-endian header length][JSON header][layer bytes...]

The JSON header is canonical (sorted keys, compact separators) and carries
the tile address, the pinned commit, the exact bbox and each layer's byte
length; the layers follow in name order:

* ``bin``: KTB1, from sidecar columns only: ``KTB1``, a uint32-LE row
  count, int64-LE identity keys, int32-LE (M, 4) tile-local envelope boxes.
* ``ktb2``: the same keys and boxes, each column one cost-probed KTB2 int
  stream (:mod:`kart_tpu_torch.tiles.streams`).
* ``mvt``: a Mapbox Vector Tile 2.1 protobuf of the same arrays: envelope
  boxes as polygons (degenerate boxes as points or lines), keys as feature
  ids.
* ``geom``: the same framing, each feature's own rings from the vertex
  column, projected vertex by vertex and Douglas-Peucker-simplified
  (``KART_GEOM_SIMPLIFY``); a row without usable geometry at this zoom
  takes its envelope box, so its coverage is ``mvt``'s.
* ``geojson``: newline-delimited feature JSON through the dataset's
  compiled serialisers (``diff -o json-lines``'s bytes); needs the blobs.
* ``props``: the same feature JSON, dictionary-coded; needs the blobs.

Rows are emitted in ascending key order (the sidecar's), so the bytes never
depend on scan order.

Counterpart of kart_tpu's ``tiles/encode.py``, byte for byte. The MVT
encoders here are whole-array numpy where kart_tpu's loop over features in
Python: the command words of every feature of a tile are built in one
pass, the Douglas-Peucker splits of every ring a level at a time, and the
protobuf framing of every feature with one varint pass; the bytes are the
same.
"""

import json
import logging
import os
import struct

import numpy as np

from kart_tpu_torch import faults
from kart_tpu_torch import telemetry as tm
from kart_tpu_torch.geom import _gather_ranges
from kart_tpu_torch.tiles.clip import quantize_from_merc, refine_rows
from kart_tpu_torch.tiles.grid import (
    DEFAULT_BUFFER,
    DEFAULT_EXTENT,
    tile_bounds_wsen,
    tile_query_wsen,
    validate_tile,
)
from kart_tpu_torch.tiles.streams import (
    TileEncodeError,
    decode_bytes_stream,
    decode_stream,
    encode_bytes_stream,
    encode_stream,
    varint_decode,
    varint_encode,
    varint_lengths,
    zigzag,
)

L = logging.getLogger("kart_tpu_torch.tiles.encode")

_HEADER_LEN = struct.Struct(">Q")

#: layer magics
BIN_MAGIC = b"KTB1"
KTB2_MAGIC = b"KTB2"
PROPS_MAGIC = b"KTP1"

#: payload format version (header "v")
PAYLOAD_VERSION = 3

#: the layers this encoder builds
KNOWN_LAYERS = ("bin", "geojson", "geom", "ktb2", "mvt", "props")

#: what a request without a layer list gets (``KART_TILE_ENCODING``
#: overrides)
DEFAULT_LAYERS = ("bin", "geojson")

#: default ceiling on features a tile (``KART_TILE_MAX_FEATURES``
#: overrides; 0 = unlimited)
DEFAULT_MAX_FEATURES = 65_536

#: decode-side ceiling on a compressed layer's claimed rows: RLE and FOR
#: expand far beyond their bytes, so a few crafted bytes must not demand a
#: multi-GB allocation
MAX_DECODE_ROWS = 1 << 27


class TileTooLarge(TileEncodeError):
    """More features in the tile than the configured ceiling."""

    def __init__(self, count, limit, tile):
        z, x, y = tile
        super().__init__(f"Tile {z}/{x}/{y} holds {count} features (limit {limit}); "
                         f"request a deeper zoom")
        self.count = count
        self.limit = limit


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def default_layers():
    """``KART_TILE_ENCODING`` (a comma layer list) when set and valid, else
    :data:`DEFAULT_LAYERS`; a malformed value logs one warning."""
    spec = os.environ.get("KART_TILE_ENCODING")
    if not spec:
        return DEFAULT_LAYERS
    try:
        return normalise_layers(spec)
    except TileEncodeError as e:
        L.warning("ignoring bad KART_TILE_ENCODING=%r: %s", spec, e)
        return DEFAULT_LAYERS


def normalise_layers(layers):
    """Layer spec (iterable or comma string) -> sorted tuple of known layer
    names; ``None`` is :func:`default_layers`. Raises on an unknown name."""
    if layers is None:
        return default_layers()
    if isinstance(layers, str):
        layers = [p.strip() for p in layers.split(",") if p.strip()]
    out = sorted(set(layers))
    for name in out:
        if name not in KNOWN_LAYERS:
            raise TileEncodeError(
                f"Unknown tile layer {name!r} (known: {', '.join(KNOWN_LAYERS)})")
    if not out:
        raise TileEncodeError("At least one tile layer must be requested")
    return tuple(out)


def max_features_limit():
    return _env_int("KART_TILE_MAX_FEATURES", DEFAULT_MAX_FEATURES)


# ---------------------------------------------------------------------------
# the columnar layers
# ---------------------------------------------------------------------------

def encode_bin_layer(keys, boxes):
    """KTB1: magic, row count, keys, boxes."""
    return b"".join((
        BIN_MAGIC,
        struct.pack("<I", len(keys)),
        np.ascontiguousarray(keys, dtype="<i8").tobytes(),
        np.ascontiguousarray(boxes, dtype="<i4").tobytes(),
    ))


def decode_bin_layer(data):
    """``bin`` layer bytes -> (int64 keys (M,), int32 boxes (M, 4)); a count
    that disagrees with the byte length raises :class:`TileEncodeError`."""
    if len(data) < 8 or data[:4] != BIN_MAGIC:
        raise TileEncodeError("Bad binary tile layer magic")
    (count,) = struct.unpack_from("<I", data, 4)
    expected = 8 + count * (8 + 16)
    if len(data) != expected:
        raise TileEncodeError(
            f"KTB1 layer holds {len(data)} bytes; count {count} requires exactly {expected}")
    keys = np.frombuffer(data, dtype="<i8", count=count, offset=8)
    boxes = np.frombuffer(data, dtype="<i4", count=4 * count, offset=8 + 8 * count)
    return keys, boxes.reshape(count, 4)


def encode_ktb2_layer(keys, boxes):
    """KTB2: magic, flags, row count, then one int stream for the keys and
    one for each box column. The ``tiles.streams`` fault fires first."""
    faults.fire("tiles.streams")
    count = len(keys)
    boxes = np.ascontiguousarray(boxes, dtype=np.int64).reshape(count, 4)
    parts = [KTB2_MAGIC, struct.pack("<BI", 0, count),
             encode_stream(np.asarray(keys, dtype=np.int64), "i8")]
    for col in range(4):
        parts.append(encode_stream(boxes[:, col], "i4"))
    return b"".join(parts)


def decode_ktb2_layer(data, max_count=MAX_DECODE_ROWS):
    """``ktb2`` layer bytes -> (int64 keys (M,), int32 boxes (M, 4)),
    bounds-checked; ``max_count`` caps the rows a layer may claim."""
    faults.fire("tiles.streams")
    if len(data) < 9 or data[:4] != KTB2_MAGIC:
        raise TileEncodeError("Bad KTB2 tile layer magic")
    flags, count = struct.unpack_from("<BI", data, 4)
    if flags != 0:
        raise TileEncodeError(f"Unknown KTB2 flags 0x{flags:02x}")
    if max_count and count > max_count:
        raise TileEncodeError(
            f"KTB2 layer claims {count} rows (> {max_count} ceiling; pass "
            f"max_count to decode a genuinely larger tile)")
    pos = 9
    keys, pos = decode_stream(data, count, "i8", pos)
    boxes = np.empty((count, 4), dtype=np.int32)
    for col in range(4):
        boxes[:, col], pos = decode_stream(data, count, "i4", pos)
    if pos != len(data):
        raise TileEncodeError(f"KTB2 layer length mismatch ({pos} decoded vs {len(data)} actual)")
    return keys.astype("<i8"), boxes


def encode_props_layer(lines):
    """``props``: the feature JSON byte strings, dictionary-coded."""
    faults.fire("tiles.streams")
    return b"".join((PROPS_MAGIC, struct.pack("<I", len(lines)), encode_bytes_stream(lines)))


def decode_props_layer(data, max_count=MAX_DECODE_ROWS):
    """``props`` layer bytes -> feature JSON byte strings in row order."""
    faults.fire("tiles.streams")
    if len(data) < 8 or data[:4] != PROPS_MAGIC:
        raise TileEncodeError("Bad props tile layer magic")
    (count,) = struct.unpack_from("<I", data, 4)
    if max_count and count > max_count:
        raise TileEncodeError(f"Props layer claims {count} rows (> {max_count} ceiling)")
    lines, pos = decode_bytes_stream(data, count, 8)
    if pos != len(data):
        raise TileEncodeError(f"Props layer length mismatch ({pos} decoded vs {len(data)} actual)")
    return lines


# ---------------------------------------------------------------------------
# MVT (Mapbox Vector Tile 2.1): a hand-written protobuf
# ---------------------------------------------------------------------------

#: MVT geometry types (the vertex column's kinds are the same numbers)
MVT_POINT, MVT_LINESTRING, MVT_POLYGON = 1, 2, 3

_MOVE_TO_1 = 9  # MoveTo, count 1
_CLOSE_PATH = 15


def _uvarint(v):
    """One LEB128 varint (message framing)."""
    out = bytearray()
    v = int(v)
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pb_bytes(field, data):
    return _uvarint((field << 3) | 2) + _uvarint(len(data)) + data


def _pb_varint(field, value):
    return _uvarint(field << 3) + _uvarint(value)


def _ragged_bytes(words, word_counts):
    """Command words (uint64, rows back to back) + words a row -> (LEB128
    bytes as uint8, byte offsets (rows + 1,))."""
    words = np.asarray(words, dtype=np.uint64)
    lens = varint_lengths(words)
    ends = np.cumsum(lens)
    word_ends = np.cumsum(np.asarray(word_counts, dtype=np.int64))
    offs = np.zeros(len(word_ends) + 1, dtype=np.int64)
    offs[1:] = np.where(word_ends > 0, ends[np.maximum(word_ends - 1, 0)], 0) if len(ends) else 0
    buf = np.frombuffer(varint_encode(words), dtype=np.uint8)
    return buf, offs


def _box_words(boxes):
    """(k, 4) int boxes -> (geometry types uint8 (k,), words a row int64
    (k,), the rows' command words back to back). Polygons wind (x0,y0) ->
    (x1,y0) -> (x1,y1) -> (x0,y1), positive area under the surveyor's
    formula with y down (MVT's exterior ring); a zero-extent box is a point,
    a zero-width or zero-height one a line."""
    b = np.asarray(boxes, dtype=np.int64).reshape(-1, 4)
    x0, y0, x1, y1 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    is_pt = (x0 == x1) & (y0 == y1)
    is_ln = ~is_pt & ((x0 == x1) | (y0 == y1))
    types = np.where(is_pt, MVT_POINT, np.where(is_ln, MVT_LINESTRING, MVT_POLYGON)).astype(
        np.uint8)
    counts = np.where(is_pt, 3, np.where(is_ln, 6, 11)).astype(np.int64)
    starts = _starts(counts)
    words = np.zeros(int(counts.sum()), dtype=np.uint64)
    zx0, zy0, zdx, zdy = zigzag(x0), zigzag(y0), zigzag(x1 - x0), zigzag(y1 - y0)
    for mask, cols in ((is_pt, (_MOVE_TO_1, zx0, zy0)),
                       (is_ln, (_MOVE_TO_1, zx0, zy0, (1 << 3) | 2, zdx, zdy)),
                       (~is_pt & ~is_ln, (_MOVE_TO_1, zx0, zy0, (3 << 3) | 2, zdx, 0, 0, zdy,
                                          zigzag(x0 - x1), 0, _CLOSE_PATH))):
        s = starts[mask]
        for j, c in enumerate(cols):
            words[s + j] = c[mask] if isinstance(c, np.ndarray) else c
    return types, counts, words


def _mvt_layer_bytes(layer_name, keys, types, geom_buf, geom_offs, extent):
    """Per-feature geometry types and command bytes (``geom_buf`` sliced by
    ``geom_offs``) -> one MVT Tile message holding one Layer. Keys become
    feature ids (a negative hash key as its two's-complement uint64).

    A feature is ``0x12 varint(body length)`` and the body ``0x08
    varint(id) 0x18 type 0x22 varint(geometry length) geometry``: the three
    varints of every feature are encoded in one pass and every byte is
    placed by offset arithmetic."""
    keys = np.asarray(keys, dtype=np.int64)
    m = len(keys)
    glen = np.diff(geom_offs).astype(np.int64)
    id_codes = keys.astype(np.uint64)
    li = varint_lengths(id_codes)
    lg = varint_lengths(glen.astype(np.uint64))
    body = 1 + li + 3 + lg + glen
    lb = varint_lengths(body.astype(np.uint64))
    size = 1 + lb + body
    start = np.cumsum(size) - size
    out = np.empty(int(size.sum()), dtype=np.uint8)
    # the varints, feature by feature: body length, id, geometry length
    words = np.empty((m, 3), dtype=np.uint64)
    words[:, 0] = body
    words[:, 1] = id_codes
    words[:, 2] = glen
    lens = np.stack([lb, li, lg], axis=1)
    at = np.stack([start + 1, start + 2 + lb, start + 5 + lb + li], axis=1).reshape(-1)
    flat_lens = lens.reshape(-1)
    vbytes = np.frombuffer(varint_encode(words.reshape(-1)), dtype=np.uint8)
    dest, _ = _gather_ranges(at, at + flat_lens)
    out[dest] = vbytes
    out[start] = 0x12  # field 2 (feature), length-delimited
    out[start + 1 + lb] = 0x08  # field 1 (id), varint
    tpos = start + 2 + lb + li
    out[tpos] = 0x18  # field 3 (type), varint
    out[tpos + 1] = types
    out[tpos + 2] = 0x22  # field 4 (geometry), packed
    gpos = tpos + 3 + lg
    dest, _ = _gather_ranges(gpos, gpos + glen)
    src, _ = _gather_ranges(geom_offs[:-1], geom_offs[1:])
    out[dest] = geom_buf[src]
    layer_body = b"".join((
        _pb_bytes(1, layer_name.encode()),
        out.tobytes(),
        _pb_varint(5, extent),
        _pb_varint(15, 2),  # version
    ))
    return _pb_bytes(3, layer_body)


def encode_mvt_layer(layer_name, keys, boxes, extent=DEFAULT_EXTENT):
    """MVT protobuf of the clipped, quantized arrays: one layer named after
    the dataset, each feature's envelope box as its geometry and its key as
    its id. No blob reads."""
    types, counts, words = _box_words(boxes)
    buf, offs = _ragged_bytes(words, counts)
    return _mvt_layer_bytes(layer_name, keys, types, buf, offs, extent)


def _starts(counts):
    """Where each of consecutive runs of ``counts`` items starts."""
    return np.concatenate(([0], np.cumsum(counts)[:-1])) if len(counts) else counts


def _simplify_rings(xs, ys, starts, counts, tol):
    """Douglas-Peucker keep mask over many rings at once (flat int vertex
    columns, each ring ``counts[r]`` vertices from ``starts[r]``), the
    splits of every ring taken a level at a time. The kept set is
    :func:`kart_tpu_torch.tiles.clip.simplify_ring`'s: each split depends
    only on its own chord, so the order they are taken in changes
    nothing, and the distances are computed with the same operations."""
    keep = np.zeros(len(xs), dtype=bool)
    ends = starts + counts - 1
    keep[starts] = True
    keep[ends] = True
    fx = np.asarray(xs, dtype=np.float64)
    fy = np.asarray(ys, dtype=np.float64)
    i0, i1 = starts, ends
    while True:
        live = i1 - i0 >= 2
        i0, i1 = i0[live], i1[live]
        if not len(i0):
            return keep
        pts, n_pts = _gather_ranges(i0 + 1, i1)
        seg_of = np.repeat(np.arange(len(i0)), n_pts)
        x0, y0 = fx[i0], fy[i0]
        dx, dy = fx[i1] - x0, fy[i1] - y0
        seg = np.hypot(dx, dy)
        sx, sy = fx[pts], fy[pts]
        px0, py0, pdx, pdy, pseg = x0[seg_of], y0[seg_of], dx[seg_of], dy[seg_of], seg[seg_of]
        d = np.empty(len(pts), dtype=np.float64)
        flat = pseg == 0.0
        # a closed ring's chord is a point: the distance from it instead
        d[flat] = np.hypot(sx[flat] - px0[flat], sy[flat] - py0[flat])
        lin = ~flat
        d[lin] = np.abs(pdx[lin] * (sy[lin] - py0[lin]) - pdy[lin] * (sx[lin] - px0[lin])) \
            / pseg[lin]
        first = _starts(n_pts)
        dmax = np.maximum.reduceat(d, first)
        pos = np.where(d == dmax[seg_of], np.arange(len(d)), len(d))
        k = np.minimum.reduceat(pos, first)  # np.argmax: the first maximum
        split = d[k] > tol
        mid = pts[k[split]]
        keep[mid] = True
        i0 = np.concatenate((i0[split], mid))
        i1 = np.concatenate((mid, i1[split]))


def _geom_words(kinds, ring_counts, vert_counts, tx, ty, tol):
    """Projected tile-int vertices of a tile's rows -> (has geometry bool
    (m,), words a row (m,), the rows' command words back to back).

    Each ring is cleaned as kart_tpu's ``_clean_part`` does: a polygon ring
    drops its explicit closing vertex, consecutive duplicate vertices
    collapse, lines and polygons are simplified at ``tol``, and a ring is
    kept with at least 1 vertex (point), 2 (line), or 3 with nonzero
    doubled area (polygon). A row's kept rings become one MoveTo run of
    all its points, or for a line or polygon MoveTo + LineTo (+ ClosePath)
    a ring, every coordinate relative to the vertex before it in the row
    (the first to the origin)."""
    m = len(kinds)
    ring_row = np.repeat(np.arange(m), ring_counts)
    ring_kind = np.asarray(kinds, dtype=np.int64)[ring_row]
    n_rings = len(ring_row)
    vert_ring = np.repeat(np.arange(n_rings), vert_counts)
    starts = _starts(vert_counts)
    ends = starts + vert_counts  # exclusive
    keep = np.repeat(ring_kind != 0, vert_counts)
    # a polygon ring's closing vertex
    has = vert_counts > 1
    closed = np.zeros(n_rings, dtype=bool)
    closed[has] = ((ring_kind[has] == MVT_POLYGON) & (tx[starts[has]] == tx[ends[has] - 1])
                   & (ty[starts[has]] == ty[ends[has] - 1]))
    keep[ends[closed] - 1] = False
    # consecutive duplicates (the closing vertex is the last: it has no
    # successor to compare with)
    if len(tx) > 1:
        same = np.zeros(len(tx), dtype=bool)
        same[1:] = (tx[1:] == tx[:-1]) & (ty[1:] == ty[:-1]) & (vert_ring[1:] == vert_ring[:-1])
        keep &= ~same
    idx = np.flatnonzero(keep)
    cx, cy, cring = tx[idx], ty[idx], vert_ring[idx]
    counts = np.bincount(cring, minlength=n_rings)
    cstarts = _starts(counts)
    if tol > 0:
        dp = (ring_kind != MVT_POINT) & (counts > 2)
        kept = np.ones(len(cx), dtype=bool)
        if dp.any():
            sel = np.repeat(dp, counts)
            sub = np.flatnonzero(sel)
            kept[sub] = _simplify_rings(cx[sub], cy[sub], _starts(counts[dp]), counts[dp],
                                        tol)
            cx, cy, cring = cx[kept], cy[kept], cring[kept]
            counts = np.bincount(cring, minlength=n_rings)
            cstarts = _starts(counts)
    floor = np.where(ring_kind == MVT_POINT, 1, np.where(ring_kind == MVT_LINESTRING, 2, 3))
    valid = (counts >= floor) & (ring_kind != 0)
    poly = valid & (ring_kind == MVT_POLYGON)
    if poly.any():
        # doubled area in int64, each vertex with the next of its ring
        nxt = np.arange(len(cx)) + 1
        last = cstarts + counts - 1
        nxt[last[counts > 0]] = cstarts[counts > 0]
        x64, y64 = cx.astype(np.int64), cy.astype(np.int64)
        cross = x64 * y64[nxt] - x64[nxt] * y64
        area = np.zeros(n_rings, dtype=np.int64)
        nz = counts > 0
        area[nz] = np.add.reduceat(cross, cstarts[nz])
        valid &= ~(poly & (area == 0))
    # the kept rings' vertices, in row order
    vsel = np.repeat(valid, counts)
    vx, vy = cx[vsel].astype(np.int64), cy[vsel].astype(np.int64)
    vring = cring[vsel]
    vrow = ring_row[vring]
    n_valid = np.bincount(ring_row[valid], minlength=m)
    has_geom = n_valid > 0
    first_of_row = np.ones(len(vx), dtype=bool)
    first_of_row[1:] = vrow[1:] != vrow[:-1]
    dx = np.where(first_of_row, vx, vx - np.roll(vx, 1))
    dy = np.where(first_of_row, vy, vy - np.roll(vy, 1))
    zdx, zdy = zigzag(dx), zigzag(dy)
    row_kind = np.asarray(kinds, dtype=np.int64)
    row_verts = np.bincount(vrow, minlength=m)
    # words a row: points 1 + 2 a vertex; lines 2 a ring + 2 a vertex;
    # polygons 3 a ring + 2 a vertex
    per_ring = np.where(row_kind == MVT_POLYGON, 3, 2)
    word_counts = np.where(row_kind == MVT_POINT, 1 + 2 * row_verts,
                           per_ring * n_valid + 2 * row_verts)
    word_counts = np.where(has_geom, word_counts, 0)
    row_starts = _starts(word_counts)
    words = np.zeros(int(word_counts.sum()), dtype=np.uint64)
    vrank = np.arange(len(vx)) - _starts(row_verts)[vrow]  # vertex index in its row
    pt_v = row_kind[vrow] == MVT_POINT
    # points: (n << 3) | 1, then the coordinate pairs
    pt_rows = np.flatnonzero(has_geom & (row_kind == MVT_POINT))
    words[row_starts[pt_rows]] = (row_verts[pt_rows].astype(np.uint64) << np.uint64(3)) | \
        np.uint64(1)
    at = row_starts[vrow[pt_v]] + 1 + 2 * vrank[pt_v]
    words[at] = zdx[pt_v]
    words[at + 1] = zdy[pt_v]
    # lines and polygons, ring by ring
    ln_v = ~pt_v
    if ln_v.any():
        vr = vring[ln_v]
        ring_pos = np.arange(len(vx))[ln_v]
        ring_start_v = np.flatnonzero(np.r_[True, vr[1:] != vr[:-1]])
        rings_here = vr[ring_start_v]
        ring_n = np.diff(np.r_[ring_start_v, len(vr)])
        ring_rowid = ring_row[rings_here]
        ring_close = (row_kind[ring_rowid] == MVT_POLYGON).astype(np.int64)
        ring_words = 2 * ring_n + 2 + ring_close
        # a ring's word offset: its row's start plus the rings before it
        first_ring_of_row = np.r_[True, ring_rowid[1:] != ring_rowid[:-1]]
        before = np.cumsum(ring_words) - ring_words
        row_base = np.maximum.accumulate(np.where(first_ring_of_row, before, 0))
        wpos = row_starts[ring_rowid] + before - row_base
        words[wpos] = _MOVE_TO_1
        words[wpos + 3] = ((ring_n - 1).astype(np.uint64) << np.uint64(3)) | np.uint64(2)
        words[(wpos + 2 * ring_n + 2)[ring_close == 1]] = _CLOSE_PATH
        k = np.arange(len(vr)) - np.repeat(ring_start_v, ring_n)  # vertex index in its ring
        base = np.repeat(wpos, ring_n)
        at = np.where(k == 0, base + 1, base + 2 + 2 * k)
        words[at] = zdx[ring_pos]
        words[at + 1] = zdy[ring_pos]
    return has_geom, word_counts, words


def encode_geom_layer(layer_name, keys, col, rows, boxes, z, x, y, extent=DEFAULT_EXTENT,
                      buffer=DEFAULT_BUFFER):
    """The real-geometry MVT layer: each row's rings from the
    :class:`~kart_tpu_torch.geom.VertexColumn`, projected to tile
    coordinates in one pass over every vertex of the tile, simplified at
    :func:`~kart_tpu_torch.tiles.clip.simplify_tolerance`, as
    MoveTo/LineTo/ClosePath commands. A row of kind 0, or whose rings all
    degenerate, takes its quantized envelope box (the ``mvt`` layer's
    shape), so every row appears."""
    from kart_tpu_torch.tiles.clip import project_vertices, simplify_tolerance

    rows = np.asarray(rows, dtype=np.int64)
    m = len(rows)
    tol = simplify_tolerance()
    kinds = col.kinds[rows] if m else np.zeros(0, np.uint8)
    ring_idx, ring_counts = _gather_ranges(col.feat_offsets[rows], col.feat_offsets[rows + 1])
    vert_idx, vert_counts = _gather_ranges(col.ring_offsets[ring_idx],
                                           col.ring_offsets[ring_idx + 1])
    tx, ty = project_vertices(col.x[vert_idx], col.y[vert_idx], z, x, y, extent=extent,
                              buffer=buffer)
    has_geom, g_counts, g_words = _geom_words(kinds, ring_counts, vert_counts, tx, ty, tol)
    fb = np.flatnonzero(~has_geom)
    fb_types, fb_counts, fb_words = _box_words(np.asarray(boxes).reshape(-1, 4)[fb])
    types = np.where(has_geom, kinds, 0).astype(np.uint8)
    types[fb] = fb_types
    counts = g_counts.copy()
    counts[fb] = fb_counts
    starts = _starts(counts)
    words = np.zeros(int(counts.sum()), dtype=np.uint64)
    g_rows = np.flatnonzero(has_geom)
    dest, _ = _gather_ranges(starts[g_rows], starts[g_rows] + counts[g_rows])
    words[dest] = g_words
    dest, _ = _gather_ranges(starts[fb], starts[fb] + counts[fb])
    words[dest] = fb_words
    buf, offs = _ragged_bytes(words, counts)
    return _mvt_layer_bytes(layer_name, keys, types, buf, offs, extent)


def decode_mvt_layer(data):
    """A small MVT reader (client and test side): -> dict with ``name``,
    ``extent``, ``version`` and ``features``, each a dict of ``id``,
    ``type`` and ``geometry`` (absolute coordinates per command run).
    Bounds-checked: malformed bytes raise :class:`TileEncodeError`."""
    def read_uvarint(buf, pos):
        out = shift = 0
        while True:
            if pos >= len(buf):
                raise TileEncodeError("Truncated MVT varint")
            b = buf[pos]
            pos += 1
            out |= (b & 0x7F) << shift
            if not (b & 0x80):
                return out, pos
            shift += 7
            if shift > 63:
                raise TileEncodeError("MVT varint longer than 10 bytes")

    def walk(buf):
        fields = []
        pos = 0
        while pos < len(buf):
            key, pos = read_uvarint(buf, pos)
            field, wire = key >> 3, key & 7
            if wire == 0:
                val, pos = read_uvarint(buf, pos)
                fields.append((field, val))
            elif wire == 2:
                ln, pos = read_uvarint(buf, pos)
                if pos + ln > len(buf):
                    raise TileEncodeError("Truncated MVT submessage")
                fields.append((field, buf[pos : pos + ln]))
                pos += ln
            else:
                raise TileEncodeError(f"Unsupported MVT wire type {wire}")
        return fields

    def unzz(u):
        u = int(u)
        return (u >> 1) ^ -(u & 1)

    def geometry(buf):
        n_values = int(np.count_nonzero(np.frombuffer(buf, np.uint8) < 0x80))
        vals, end = varint_decode(buf, n_values)
        if end != len(buf):
            raise TileEncodeError("Truncated MVT geometry")
        out, i, cur = [], 0, (0, 0)
        while i < len(vals):
            word = int(vals[i])
            i += 1
            cmd, n = word & 7, word >> 3
            if cmd == 7:
                if n != 1:
                    raise TileEncodeError(f"Malformed MVT geometry command {cmd} count {n}")
                out.append(("close",))
                continue
            if cmd not in (1, 2) or n == 0:
                raise TileEncodeError(f"Malformed MVT geometry command {cmd} count {n}")
            if i + 2 * n > len(vals):
                raise TileEncodeError("Truncated MVT geometry")
            pts = []
            for _ in range(n):
                cur = (cur[0] + unzz(vals[i]), cur[1] + unzz(vals[i + 1]))
                i += 2
                pts.append(cur)
            out.append(("move" if cmd == 1 else "line", pts))
        return out

    def msg(value, what):
        if not isinstance(value, (bytes, bytearray, memoryview)):
            raise TileEncodeError(f"MVT {what} has non-message wire type")
        return value

    layers = [v for f, v in walk(data) if f == 3]
    if len(layers) != 1:
        raise TileEncodeError(f"MVT tile holds {len(layers)} layers, not 1")
    out = {"features": []}
    for field, value in walk(msg(layers[0], "layer")):
        if field == 1:
            try:
                out["name"] = msg(value, "layer name").decode()
            except UnicodeDecodeError:
                raise TileEncodeError("MVT layer name is not valid UTF-8") from None
        elif field == 5:
            out["extent"] = value
        elif field == 15:
            out["version"] = value
        elif field == 2:
            feat = {}
            for ff, fv in walk(msg(value, "feature")):
                if ff == 1:
                    if not isinstance(fv, int):
                        raise TileEncodeError("MVT feature id has non-varint wire type")
                    if fv >> 64:
                        raise TileEncodeError(f"MVT feature id {fv} exceeds uint64")
                    feat["id"] = np.uint64(fv).astype(np.int64).item()
                elif ff == 3:
                    feat["type"] = fv
                elif ff == 4:
                    feat["geometry"] = geometry(msg(fv, "geometry"))
            out["features"].append(feat)
    return out


# ---------------------------------------------------------------------------
# the tile encoder
# ---------------------------------------------------------------------------

def build_layers(source, layers, rows, boxes, extent=DEFAULT_EXTENT, *, tile=None,
                 buffer=DEFAULT_BUFFER):
    """The selected, quantized arrays -> {layer name: layer bytes}; ``tile``
    (z, x, y) is needed by the geom layer."""
    built = {}
    keys = None
    if any(name in layers for name in ("bin", "ktb2", "mvt", "geom")):
        keys = np.ascontiguousarray(source.block.keys[rows], dtype="<i8")
    lines = None
    if any(name in layers for name in ("geojson", "props")):
        ds = source.dataset
        pks = source.pks_for_rows(rows)
        blobs = source.feature_blobs(rows)
        lines = [ds.feature_json_str_from_data(pk, data) for pk, data in zip(pks, blobs)]
    if "bin" in layers:
        built["bin"] = encode_bin_layer(keys, boxes)
    if "ktb2" in layers:
        built["ktb2"] = encode_ktb2_layer(keys, boxes)
    if "mvt" in layers:
        built["mvt"] = encode_mvt_layer(source.ds_path, keys, boxes, extent)
    if "geom" in layers:
        if tile is None:
            raise TileEncodeError("geom layer needs a tile address")
        z, x, y = tile
        built["geom"] = encode_geom_layer(source.ds_path, keys, source.vertices(), rows, boxes,
                                          z, x, y, extent=extent, buffer=buffer)
    if "geojson" in layers:
        built["geojson"] = ("\n".join(lines) + "\n").encode() if lines else b""
    if "props" in layers:
        built["props"] = encode_props_layer([line.encode() for line in lines])
    return built


def assemble_payload(source, z, x, y, layers, built, count, *, extent=DEFAULT_EXTENT,
                     buffer=DEFAULT_BUFFER):
    """Layer bytes -> the framed payload."""
    header = {
        "v": PAYLOAD_VERSION,
        "commit": source.commit_oid,
        "dataset": source.ds_path,
        "tile": [z, x, y],
        "bbox": list(tile_bounds_wsen(z, x, y)),
        "extent": extent,
        "buffer": buffer,
        "count": count,
        "layers": {name: len(built[name]) for name in layers},
    }
    raw_header = json.dumps(header, sort_keys=True, separators=(",", ":")).encode()
    return b"".join([_HEADER_LEN.pack(len(raw_header)), raw_header]
                    + [built[name] for name in layers])


def encode_tile(source, z, x, y, *, layers=None, extent=DEFAULT_EXTENT, buffer=DEFAULT_BUFFER,
                max_features=None, device=None):
    """One tile's payload from a :class:`~kart_tpu_torch.tiles.source
    .TileSource` (the serving encoder). -> (payload, stats): the row
    selection's pruning counters and ``count``. The refined rows are
    projected by one :func:`~kart_tpu_torch.diff.backend
    .project_envelopes` call on ``device`` (None: the card, K7; ``"cpu"``:
    numpy), to the same bytes; an empty or too large tile projects
    nothing. The ``tiles.encode`` fault fires after the row selection
    (frame 1) and after the layers are built (frame 2)."""
    from kart_tpu_torch.diff.backend import project_envelopes

    z, x, y = validate_tile(z, x, y)
    layers = normalise_layers(layers)
    if max_features is None:
        max_features = max_features_limit()
    with tm.span("tiles.encode", tile=f"{z}/{x}/{y}"):
        rows, stats = source.rows_for_bbox(tile_query_wsen(z, x, y))
        faults.fire("tiles.encode")  # frame 1: selection done
        rows, env = refine_rows(source.envelopes(), rows, z, x, y)
        count = len(rows)
        if max_features and count > max_features:
            raise TileTooLarge(count, max_features, (z, x, y))
        if count:
            merc = project_envelopes(env, device=device)
            boxes = quantize_from_merc(env, merc, z, x, y, extent=extent, buffer=buffer)
        else:
            boxes = np.zeros((0, 4), dtype=np.int32)
        built = build_layers(source, layers, rows, boxes, extent, tile=(z, x, y), buffer=buffer)
        faults.fire("tiles.encode")  # frame 2: layers built, not assembled
        payload = assemble_payload(source, z, x, y, layers, built, count, extent=extent,
                                   buffer=buffer)
    tm.incr("tiles.features_out", count)
    return payload, dict(stats, count=count)


def encode_tile_batch(source, addresses, *, layers=None, extent=DEFAULT_EXTENT,
                      buffer=DEFAULT_BUFFER, max_features=None, allow_device=True, device=None):
    """The pyramid exporter's batch encoder: the tiles of ``addresses`` with
    ONE mercator projection for all their rows, through the backend seam
    (:func:`kart_tpu_torch.diff.backend.project_envelopes`: K7 on the card,
    numpy with ``device="cpu"`` or without ``allow_device``). Selection and
    refine stay host work a tile.

    -> a list aligned with ``addresses``: ``("ok", payload, count)``,
    ``("empty", None, 0)`` or ``("too_large", None, count)``. The payloads
    equal :func:`encode_tile`'s."""
    from kart_tpu_torch.diff.backend import project_envelopes

    layers = normalise_layers(layers)
    if max_features is None:
        max_features = max_features_limit()
    envelopes = source.envelopes()

    selected = []
    for z, x, y in addresses:
        rows, _stats = source.rows_for_bbox(tile_query_wsen(z, x, y))
        rows, env = refine_rows(envelopes, rows, z, x, y)
        if len(rows) == 0:
            status = "empty"
        elif max_features and len(rows) > max_features:
            status = "too_large"  # dropped before the projection
        else:
            status = "ok"
        selected.append((z, x, y, rows, env, status))

    ok_envs = [env for *_a, env, status in selected if status == "ok"]
    env_cat = np.concatenate(ok_envs) if ok_envs else np.zeros((0, 4), np.float64)
    merc_cat = project_envelopes(env_cat, allow_device=allow_device, device=device)

    out = []
    pos = 0
    for z, x, y, rows, env, status in selected:
        count = len(rows)
        if status == "empty":
            out.append(("empty", None, 0))
            continue
        if status == "too_large":
            out.append(("too_large", None, count))
            continue
        merc = tuple(col[pos : pos + count] for col in merc_cat)
        pos += count
        boxes = quantize_from_merc(env, merc, z, x, y, extent=extent, buffer=buffer)
        built = build_layers(source, layers, rows, boxes, extent, tile=(z, x, y), buffer=buffer)
        payload = assemble_payload(source, z, x, y, layers, built, count, extent=extent,
                                   buffer=buffer)
        out.append(("ok", payload, count))
    return out


def parse_payload(data):
    """Payload bytes -> (header dict, {layer name: layer bytes}): the
    client-side decoder. A clipped or padded payload raises
    :class:`TileEncodeError` at the first inconsistency."""
    if len(data) < _HEADER_LEN.size:
        raise TileEncodeError("Tile payload shorter than its length prefix")
    (n,) = _HEADER_LEN.unpack_from(data, 0)
    pos = _HEADER_LEN.size
    if n > len(data) - pos:
        raise TileEncodeError(f"Tile header declares {n} bytes; {len(data) - pos} present")
    try:
        header = json.loads(data[pos : pos + n].decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise TileEncodeError(f"Malformed tile header: {e}")
    pos += n
    sizes = header.get("layers")
    if not isinstance(sizes, dict) or not all(
            isinstance(v, int) and v >= 0 for v in sizes.values()):
        raise TileEncodeError("Malformed tile header: bad layers table")
    layer_bytes = {}
    for name in sorted(sizes):
        size = sizes[name]
        if pos + size > len(data):
            raise TileEncodeError(
                f"Tile layer {name!r} declares {size} bytes; {len(data) - pos} remain")
        layer_bytes[name] = data[pos : pos + size]
        pos += size
    if pos != len(data):
        raise TileEncodeError(f"Tile payload length mismatch ({pos} headered vs {len(data)} actual)")
    return header, layer_bytes
