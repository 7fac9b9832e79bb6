"""WebMercator XYZ tile grid math: EPSG:3857 slippy-map tiles over EPSG:4326
data, addressed ``z/x/y`` as MapLibre and OSM do.

Pure geometry, no repository access, and vectorized where a column is
involved (:func:`merc_xy_cols` runs over every kept envelope row of a
tile). Conventions:

* ``z`` in [0, MAX_ZOOM]; ``x``, ``y`` in [0, 2**z).
* y grows southwards: tile (z, 0, 0) is the north-west corner of the world.
* Tile bounds are ``(w, s, e, n)`` EPSG:4326 degrees, the shape of the
  sidecar envelope columns and of the block classifier
  (:func:`kart_tpu_torch.ops.bbox.classify_env_blocks_np`).
* Latitudes clamp to +-:data:`MERC_MAX_LAT`; data beyond the clamp lands in
  the edge rows of tiles (a polar feature is served by the top or bottom
  row, never dropped).

Counterpart of kart_tpu's ``tiles/grid.py``, float for float: every bound
is computed with ``math`` on the host, never with torch, so tile headers
are byte for byte kart_tpu's.
"""

import math

import numpy as np

#: the WebMercator latitude clamp: atan(sinh(pi)) in degrees
MERC_MAX_LAT = 85.05112877980659

#: the deepest zoom an address may name (2**30 tiles an axis)
MAX_ZOOM = 30

#: integer coordinate extent of one tile (the MVT convention)
DEFAULT_EXTENT = 4096

#: clip buffer around a tile, in extent units (MVT convention: geometry is
#: kept this far outside the tile so strokes cross tile seams)
DEFAULT_BUFFER = 64

#: pad of a tile's block-pruning query rectangle: the envelope columns are
#: f32 and the tile bounds f64, so a borderline feature must be admitted by
#: the coarse scan and decided by the exact refine (tiles/clip.py)
QUERY_PAD = 1e-4


class TileAddressError(ValueError):
    """Malformed z/x/y address or zoom spec."""


def validate_tile(z, x, y):
    """-> (z, x, y) as ints, or raise :class:`TileAddressError`."""
    try:
        z, x, y = int(z), int(x), int(y)
    except (TypeError, ValueError):
        raise TileAddressError(f"Tile address must be integers: {z}/{x}/{y}")
    if not (0 <= z <= MAX_ZOOM):
        raise TileAddressError(f"Zoom {z} out of range 0..{MAX_ZOOM}")
    n = 1 << z
    if not (0 <= x < n and 0 <= y < n):
        raise TileAddressError(f"Tile {z}/{x}/{y} out of range (0..{n - 1} at zoom {z})")
    return z, x, y


def _lat_to_merc_y(lat_deg):
    """Latitude degrees -> normalized mercator y in [0, 1] (0 = north)."""
    lat = max(-MERC_MAX_LAT, min(MERC_MAX_LAT, lat_deg))
    s = math.sin(math.radians(lat))
    return 0.5 - math.log((1.0 + s) / (1.0 - s)) / (4.0 * math.pi)


def _merc_y_to_lat(y):
    """Normalized mercator y in [0, 1] -> latitude degrees."""
    return math.degrees(math.atan(math.sinh(math.pi * (1.0 - 2.0 * y))))


def tile_bounds_wsen(z, x, y):
    """-> (w, s, e, n) degree bounds of tile ``z/x/y``: the north and south
    edges are the mercator row edges, w and e exact."""
    z, x, y = validate_tile(z, x, y)
    n_tiles = 1 << z
    w = x / n_tiles * 360.0 - 180.0
    e = (x + 1) / n_tiles * 360.0 - 180.0
    n = _merc_y_to_lat(y / n_tiles)
    s = _merc_y_to_lat((y + 1) / n_tiles)
    return (w, s, e, n)


def tile_cover_wsen(z, x, y):
    """The tile's membership rectangle: :func:`tile_bounds_wsen` with the
    top and bottom rows extended to the poles, so that a feature beyond the
    mercator clamp belongs to an edge row."""
    z, x, y = validate_tile(z, x, y)
    w, s, e, n = tile_bounds_wsen(z, x, y)
    if y == 0:
        n = 90.0
    if y == (1 << z) - 1:
        s = -90.0
    return (w, s, e, n)


def tile_query_wsen(z, x, y, pad=QUERY_PAD):
    """The padded (w, s, e, n) rectangle of a tile's block-pruned envelope
    scan: a superset of :func:`tile_cover_wsen`, latitudes clamped to
    +-90. Longitudes may pass +-180 by the pad; the cyclic overlap test
    measures ranges by width, so that never wraps into a full-world match."""
    w, s, e, n = tile_cover_wsen(z, x, y)
    return (w - pad, max(s - pad, -90.0), e + pad, min(n + pad, 90.0))


def merc_xy_cols(lon, lat):
    """EPSG:4326 columns -> normalized mercator (x, y) in [0, 1] (y = 0 at
    the north clamp), float64 in and out: the host projection every other
    one is held to."""
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.clip(np.asarray(lat, dtype=np.float64), -MERC_MAX_LAT, MERC_MAX_LAT)
    x = (lon + 180.0) / 360.0
    s = np.sin(np.radians(lat))
    y = 0.5 - np.log((1.0 + s) / (1.0 - s)) / (4.0 * np.pi)
    return x, y


def tile_range_for_bbox(z, wsen):
    """-> (x0, y0, x1, y1) inclusive tile index ranges covering a (w, s, e,
    n) degree bbox at zoom ``z``. A wrapping bbox (e < w) or a non-finite
    bound covers the whole row."""
    z = validate_tile(z, 0, 0)[0]
    n_tiles = 1 << z
    w, s, e, n = (float(v) for v in wsen)
    if not all(map(math.isfinite, (w, s, e, n))) or e < w:
        x0, x1 = 0, n_tiles - 1
    else:
        x0 = int(min(max((w + 180.0) / 360.0, 0.0), 1.0 - 1e-12) * n_tiles)
        x1 = int(min(max((e + 180.0) / 360.0, 0.0), 1.0 - 1e-12) * n_tiles)
    y_top = _lat_to_merc_y(n)
    y_bot = _lat_to_merc_y(s)
    y0 = int(min(max(y_top, 0.0), 1.0 - 1e-12) * n_tiles)
    y1 = int(min(max(y_bot, 0.0), 1.0 - 1e-12) * n_tiles)
    return x0, y0, x1, y1


def parse_zoom_spec(spec):
    """``"4"`` or ``"0-5"`` -> sorted list of zoom levels."""
    text = str(spec).strip()
    lo, sep, hi = text.partition("-")
    try:
        z0 = int(lo)
        z1 = int(hi) if sep else z0
    except ValueError:
        raise TileAddressError(f"Bad zoom spec {spec!r} (use Z or Z0-Z1)")
    if z1 < z0:
        z0, z1 = z1, z0
    validate_tile(z0, 0, 0)
    validate_tile(z1, 0, 0)
    return list(range(z0, z1 + 1))
