"""Clip and quantize of envelope rows into tile-local integer coordinates.

The per-feature half of a tile, whole-array numpy over the block-pruned
rows of the sidecar's f32 envelope column, in two stages:

1. **Exact refine**: the coarse scan ran against a padded rectangle (f32
   columns against f64 tile bounds must never wrongly prune), so the rows
   it admitted are tested again against the tile's exact membership
   rectangle. A feature whose envelope meets the tile is in the tile.
2. **Quantize**: the kept envelopes are projected to WebMercator and scaled
   to tile-local integers (``extent`` units a tile side, the MVT
   convention), clipped to ``[-buffer, extent + buffer]``, y growing
   southwards. An envelope wrapping the anti-meridian (e < w) takes the
   whole buffered tile width.

The projection may come from K7 or its plain version, through the backend
seam (:func:`kart_tpu_torch.diff.backend.project_envelopes`). Those differ
from numpy's by ulps, so :func:`quantize_from_merc` projects again on the
host every row whose quantized float lies within a margin of a rounding
boundary: the integers are the host path's for any projection within the
margin of the host's.

Counterpart of kart_tpu's ``tiles/clip.py``, with the same integers for the
same rows; the geom layer's vertex projection (:func:`project_vertices`)
and Douglas-Peucker simplification (:func:`simplify_ring`) live here too.
"""

import os

import numpy as np

from kart_tpu_torch.ops.bbox import bbox_intersects_np
from kart_tpu_torch.tiles.grid import (
    DEFAULT_BUFFER,
    DEFAULT_EXTENT,
    merc_xy_cols,
    tile_cover_wsen,
    validate_tile,
)

#: the geom layer's simplification tolerance, in tile units (at extent 4096
#: one unit is about a quarter of a rendered pixel, at every zoom)
DEFAULT_SIMPLIFY = 1.0


def simplify_tolerance():
    """``KART_GEOM_SIMPLIFY``: the geom layer's Douglas-Peucker tolerance in
    tile units; 0 disables simplification, a malformed value gives the
    default."""
    raw = os.environ.get("KART_GEOM_SIMPLIFY")
    if raw is None:
        return DEFAULT_SIMPLIFY
    try:
        return max(float(raw), 0.0)
    except ValueError:
        return DEFAULT_SIMPLIFY


def project_vertices(qx, qy, z, x, y, *, extent=DEFAULT_EXTENT, buffer=DEFAULT_BUFFER):
    """Quantized int32 lon/lat vertex columns (1e-5 degree units) ->
    tile-local int32 (x, y), clipped vertex by vertex to the buffered tile
    square (a ring that leaves the tile is flattened along the buffer edge,
    keeping its closure and vertex count)."""
    from kart_tpu_torch.geom import COORD_SCALE

    z, x, y = validate_tile(z, x, y)
    lon = np.asarray(qx, dtype=np.float64) / COORD_SCALE
    lat = np.asarray(qy, dtype=np.float64) / COORD_SCALE
    mx, my = merc_xy_cols(lon, lat)
    scale = float(1 << z) * extent
    tx = np.clip(mx * scale - x * extent, -buffer, extent + buffer)
    ty = np.clip(my * scale - y * extent, -buffer, extent + buffer)
    return (np.rint(tx).astype(np.int32), np.rint(ty).astype(np.int32))


def simplify_ring(xs, ys, tol):
    """Douglas-Peucker keep mask over one ring or line in tile integers:
    endpoints always kept, an explicit stack instead of recursion, ``tol``
    the largest perpendicular deviation in tile units (0 keeps all)."""
    n = len(xs)
    keep = np.zeros(n, dtype=bool)
    if not n:
        return keep
    keep[0] = keep[-1] = True
    if tol <= 0 or n <= 2:
        keep[:] = True
        return keep
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    stack = [(0, n - 1)]
    while stack:
        i0, i1 = stack.pop()
        if i1 - i0 < 2:
            continue
        sx, sy = xs[i0 + 1:i1], ys[i0 + 1:i1]
        dx, dy = xs[i1] - xs[i0], ys[i1] - ys[i0]
        seg = float(np.hypot(dx, dy))
        if seg == 0.0:
            # a closed ring's chord is a point: distance from it instead
            d = np.hypot(sx - xs[i0], sy - ys[i0])
        else:
            d = np.abs(dx * (sy - ys[i0]) - dy * (sx - xs[i0])) / seg
        k = int(np.argmax(d))
        if d[k] > tol:
            m = i0 + 1 + k
            keep[m] = True
            stack.append((i0, m))
            stack.append((m, i1))
    return keep


def refine_rows(envelopes, rows, z, x, y):
    """Candidate ``rows`` -> (kept rows int64 (M,), their f64 wsen envelopes
    (M, 4)) against the tile's membership rectangle (edge rows reach the
    poles)."""
    z, x, y = validate_tile(z, x, y)
    rows = np.asarray(rows, dtype=np.int64)
    if not len(rows):
        return rows, np.zeros((0, 4), dtype=np.float64)
    env = np.asarray(envelopes[rows], dtype=np.float64)
    bounds = np.asarray(tile_cover_wsen(z, x, y), dtype=np.float64)
    keep = bbox_intersects_np(env, bounds)
    return rows[keep], env[keep]


def _host_merc(env):
    """numpy's mercator columns of (M, 4) wsen rows: the projection every
    other one is patched against."""
    mx0, my0 = merc_xy_cols(env[:, 0], env[:, 3])  # the north edge: the smaller y
    mx1, my1 = merc_xy_cols(env[:, 2], env[:, 1])
    return mx0, my0, mx1, my1


def _float_boxes(merc, z, x, y, extent, buffer):
    mx0, my0, mx1, my1 = merc
    scale = float(1 << z) * extent
    boxes = np.empty((len(mx0), 4), dtype=np.float64)
    boxes[:, 0] = mx0 * scale - x * extent
    boxes[:, 1] = my0 * scale - y * extent
    boxes[:, 2] = mx1 * scale - x * extent
    boxes[:, 3] = my1 * scale - y * extent
    return np.clip(boxes, -buffer, extent + buffer)


def quantize_margin(z, extent=DEFAULT_EXTENT):
    """How near a rounding boundary a quantized float may lie before its row
    is projected again on the host: 1e-13 of the scale (about 450 ulps of a
    mercator value, far above any transcendental's error) plus 1e-9, capped
    at 0.05 so that deep zooms do not re-project most rows (the cap still
    exceeds the scaled ulp error at zoom 30)."""
    return min(float(1 << z) * extent * 1e-13 + 1e-9, 0.05)


def quantize_boxes(env, merc, z, x, y, extent=DEFAULT_EXTENT, buffer=DEFAULT_BUFFER):
    """The quantizer without address checks: ``x`` and ``y`` may be int
    arrays of one tile per row. -> (int32 (M, 4) boxes, rows projected
    again on the host)."""
    clipped = _float_boxes(merc, z, x, y, extent, buffer)
    margin = quantize_margin(z, extent)
    frac = clipped - np.floor(clipped)
    suspect = (np.abs(frac - 0.5) < margin).any(axis=1)
    out = np.rint(clipped).astype(np.int32)
    n_patched = int(np.count_nonzero(suspect))
    if n_patched:
        sx = x[suspect] if np.ndim(x) else x
        sy = y[suspect] if np.ndim(y) else y
        redo = _float_boxes(_host_merc(env[suspect]), z, sx, sy, extent, buffer)
        out[suspect] = np.rint(redo).astype(np.int32)
    wraps = env[:, 2] < env[:, 0]
    if wraps.any():
        out[wraps, 0] = -buffer
        out[wraps, 2] = extent + buffer
    return out, n_patched


def quantize_from_merc(env, merc, z, x, y, *, extent=DEFAULT_EXTENT, buffer=DEFAULT_BUFFER):
    """Refined envelopes + their mercator columns -> int32 (M, 4) boxes
    (x0, y0, x1, y1), y0 the north edge. ``merc`` may come from the host
    (then this is the serving math) or from a device; rows within
    :func:`quantize_margin` of a rounding boundary are projected again on
    the host before ``rint``, so the integers equal the host path's."""
    z, x, y = validate_tile(z, x, y)
    if not len(env):
        return np.zeros((0, 4), dtype=np.int32)
    return quantize_boxes(env, merc, z, x, y, extent, buffer)[0]
