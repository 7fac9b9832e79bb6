"""Coordinate reference systems, PROJ-free: a WKT parser that finds
authority identifiers and parameters, CRS equality by normalised WKT, and
vectorized numpy transforms between geographic CRSes.

Counterpart of kart_tpu's ``crs.py``: ``WktNode``, ``parse_wkt_crs``,
``normalise_wkt``, ``get_authority``, ``get_identifier_str``,
``get_identifier_int``, ``make_crs`` (WKT and ``EPSG:n``), ``CRS`` and
``Transform`` with its datum shift (TOWGS84 3/7-parameter Helmert through
geocentric coordinates). Not ported yet: the projections (transverse
Mercator, Lambert conformal conic, Albers and the rest) and the NTv2 grid
shifts. A transform that needs either raises ``NotYetImplemented``, and
so do ``make_crs`` of a projected registry code: no caller may take a
transform failure for "cannot filter" and fail open.
"""

import math
import os
import re

import numpy as np

from kart_tpu_torch.core.repo import NotYetImplemented


class CrsError(ValueError):
    pass


# ---------------------------------------------------------------------------
# WKT node parsing: WKT1 and WKT2 both have the shape NAME[arg, arg, ...]
# ---------------------------------------------------------------------------


class WktNode:
    __slots__ = ("keyword", "args")

    def __init__(self, keyword, args):
        self.keyword = keyword
        self.args = args

    def find(self, *keywords, recursive=True):
        """First descendant node with one of the keywords (case-insensitive)."""
        kws = {k.upper() for k in keywords}
        for a in self.args:
            if isinstance(a, WktNode):
                if a.keyword.upper() in kws:
                    return a
                if recursive:
                    found = a.find(*keywords)
                    if found is not None:
                        return found
        return None

    def find_all(self, *keywords):
        kws = {k.upper() for k in keywords}
        out = []
        for a in self.args:
            if isinstance(a, WktNode):
                if a.keyword.upper() in kws:
                    out.append(a)
                out.extend(a.find_all(*keywords))
        return out

    def str_args(self):
        return [a for a in self.args if isinstance(a, str)]

    def num_args(self):
        return [a for a in self.args if isinstance(a, (int, float))]

    def __repr__(self):
        return f"WktNode({self.keyword}, {self.args!r})"


_WKT_TOKENS = re.compile(
    r"""\s*(
        "(?:[^"]|"")*"          # quoted string
      | [A-Za-z_][A-Za-z0-9_]*  # keyword
      | [-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?  # number
      | [\[\](),]
    )""",
    re.VERBOSE,
)


def parse_wkt_crs(wkt):
    """WKT string -> WktNode tree. Accepts WKT1 and WKT2 ('[' or '(')."""
    tokens = _WKT_TOKENS.findall(wkt)
    if not tokens:
        raise CrsError("Empty CRS definition")
    node, _pos = _parse_node(tokens, 0)
    return node


def _parse_node(tokens, pos):
    keyword = tokens[pos]
    pos += 1
    if pos >= len(tokens) or tokens[pos] not in "[(":
        return keyword, pos
    pos += 1
    args = []
    while tokens[pos] not in ")]":
        tok = tokens[pos]
        if tok == ",":
            pos += 1
            continue
        if tok.startswith('"'):
            args.append(tok[1:-1].replace('""', '"'))
            pos += 1
        elif re.fullmatch(r"[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?", tok):
            num = float(tok)
            args.append(int(num) if num == int(num) and "." not in tok else num)
            pos += 1
        else:
            # a child node, or a bare keyword (e.g. AXIS direction NORTH)
            child, pos = _parse_node(tokens, pos)
            args.append(child)
    return WktNode(keyword, args), pos + 1


def _write_node(node, indent=0, pretty=True):
    if not isinstance(node, WktNode):
        if isinstance(node, str):
            escaped = node.replace('"', '""')
            return f'"{escaped}"'
        if isinstance(node, float) and node == int(node):
            return str(node)
        return repr(node) if isinstance(node, float) else str(node)
    parts = [_write_node(a, indent + 1, pretty) for a in node.args]
    if pretty and any(isinstance(a, WktNode) for a in node.args):
        pad = "    " * (indent + 1)
        inner = (",\n" + pad).join(parts)
        return f"{node.keyword}[\n{pad}{inner}]"
    return f"{node.keyword}[{', '.join(parts)}]"


def normalise_wkt(wkt):
    """Canonical whitespace/indentation form."""
    if not wkt or not wkt.strip():
        return wkt
    try:
        return _write_node(parse_wkt_crs(wkt)) + "\n"
    except Exception:  # not parseable: the text is its own normal form
        return wkt


# ---------------------------------------------------------------------------
# Authority identifiers and naming
# ---------------------------------------------------------------------------


def get_authority(wkt_or_node):
    """-> (authority_name, code) from the outermost AUTHORITY/ID node, or
    (None, None)."""
    node = wkt_or_node if isinstance(wkt_or_node, WktNode) else parse_wkt_crs(wkt_or_node)
    # the last top-level AUTHORITY node identifies the whole CRS in WKT1;
    # nested ones identify datums and units: direct children first
    direct = [
        a for a in node.args
        if isinstance(a, WktNode) and a.keyword.upper() in ("AUTHORITY", "ID")
    ]
    found = direct[-1] if direct else node.find("AUTHORITY", "ID")
    if found is None:
        return None, None
    sargs = found.str_args() + [str(a) for a in found.num_args()]
    if len(sargs) >= 2:
        return sargs[0], sargs[1]
    return None, None


#: the code range for a CRS with no authority id
MIN_CUSTOM_ID = 200000
MAX_CUSTOM_ID = 209199
_CUSTOM_RANGE = MAX_CUSTOM_ID - MIN_CUSTOM_ID + 1


def _generate_identifier_int(crs):
    """Stable custom code in [MIN_CUSTOM_ID, MAX_CUSTOM_ID], hashed from the
    normalised WKT so that whitespace variants agree."""
    from kart_tpu_torch.core.serialise import uint32hash

    text = crs if isinstance(crs, str) else _write_node(crs)
    return MIN_CUSTOM_ID + uint32hash(normalise_wkt(text)) % _CUSTOM_RANGE


def get_identifier_str(crs):
    """Authority string like ``EPSG:4326``, or ``CUSTOM:<code>`` for a CRS
    without an authority (the code matches :func:`get_identifier_int`)."""
    auth, code = get_authority(crs)
    if auth and code:
        return f"{auth}:{code}"
    return f"CUSTOM:{_generate_identifier_int(crs)}"


def get_identifier_int(crs):
    """Integer id: the authority code when known, else the custom code."""
    _auth, code = get_authority(crs)
    if code is not None and str(code).isdigit():
        return int(code)
    return _generate_identifier_int(crs)


def parse_name(crs):
    node = crs if isinstance(crs, WktNode) else parse_wkt_crs(crs)
    sargs = node.str_args()
    return sargs[0] if sargs else None


# ---------------------------------------------------------------------------
# Well-known CRS definitions
# ---------------------------------------------------------------------------

WGS84_WKT = (
    'GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",6378137,298.257223563,'
    'AUTHORITY["EPSG","7030"]],AUTHORITY["EPSG","6326"]],'
    'PRIMEM["Greenwich",0,AUTHORITY["EPSG","8901"]],'
    'UNIT["degree",0.0174532925199433,AUTHORITY["EPSG","9122"]],'
    'AUTHORITY["EPSG","4326"]]'
)

NZGD2000_WKT = (
    'GEOGCS["NZGD2000",DATUM["New_Zealand_Geodetic_Datum_2000",'
    'SPHEROID["GRS 1980",6378137,298.257222101,AUTHORITY["EPSG","7019"]],'
    'AUTHORITY["EPSG","6167"]],PRIMEM["Greenwich",0,AUTHORITY["EPSG","8901"]],'
    'UNIT["degree",0.0174532925199433,AUTHORITY["EPSG","9122"]],'
    'AUTHORITY["EPSG","4167"]]'
)

_WELL_KNOWN = {4326: WGS84_WKT, 4167: NZGD2000_WKT}


def make_crs(user_input):
    """User input (WKT or 'EPSG:n') -> CRS. Codes resolve against the
    well-known WKT strings, then the geographic registry
    (:mod:`kart_tpu_torch.epsg`); a projected registry code raises
    NotYetImplemented and an unknown one a CrsError listing the coverage."""
    if isinstance(user_input, CRS):
        return user_input
    text = user_input.strip()
    m = re.fullmatch(r"(?i)EPSG:(\d+)", text)
    if m:
        from kart_tpu_torch import epsg

        code = int(m.group(1))
        if code in _WELL_KNOWN:
            return CRS(_WELL_KNOWN[code])
        wkt = epsg.epsg_wkt(code)
        if wkt is not None:
            return CRS(wkt)
        raise CrsError(
            f"EPSG:{code} is not in the built-in CRS registry (this build "
            f"carries no PROJ database); supply the full WKT definition "
            f"instead. Built-in coverage — {epsg.registry_summary()}"
        )
    return CRS(text)


class CRS:
    """A parsed CRS: enough structure to identify it and to run the
    transforms. Projected CRSes parse, but refuse to transform."""

    def __init__(self, wkt):
        self.wkt = wkt
        self.node = parse_wkt_crs(wkt)
        kw = self.node.keyword.upper()
        self.is_geographic = kw in ("GEOGCS", "GEOGCRS", "GEODCRS")
        self.is_projected = kw in ("PROJCS", "PROJCRS")
        self.name = parse_name(self.node)
        self.authority, self.code = get_authority(self.node)

        sph = self.node.find("SPHEROID", "ELLIPSOID")
        if sph is not None:
            nums = sph.num_args()
            self.semi_major = float(nums[0]) if nums else 6378137.0
            self.inv_flattening = float(nums[1]) if len(nums) > 1 else 298.257223563
        else:
            self.semi_major, self.inv_flattening = 6378137.0, 298.257223563

        self.projection = None
        if self.is_projected:
            proj = self.node.find("PROJECTION")
            if proj is not None:
                sargs = proj.str_args()
                self.projection = sargs[0] if sargs else None

        # datum shift to WGS84 (WKT1 TOWGS84): (dx, dy, dz[, rx, ry, rz,
        # scale_ppm]); None = the datum is taken as WGS84-equivalent
        self.towgs84 = None
        tw = self.node.find("TOWGS84")
        if tw is not None:
            nums = [float(v) for v in tw.num_args()]
            if len(nums) >= 3:
                self.towgs84 = tuple((nums + [0.0] * 7)[:7])
        datum = self.node.find("DATUM")
        self.datum_name = datum.str_args()[0] if datum is not None and datum.str_args() else None

    @property
    def identifier_str(self):
        return get_identifier_str(self.node)

    @property
    def identifier_int(self):
        return get_identifier_int(self.node)

    def __eq__(self, other):
        return isinstance(other, CRS) and normalise_wkt(self.wkt) == normalise_wkt(other.wkt)

    def __hash__(self):
        return hash(normalise_wkt(self.wkt))

    def __repr__(self):
        return f"CRS({self.identifier_str} {self.name!r})"


# ---------------------------------------------------------------------------
# Transforms (vectorized numpy): datum shifts by 7-parameter Helmert
# ---------------------------------------------------------------------------


def _geodetic_to_geocentric(a, e2, lon_deg, lat_deg):
    lon = np.radians(lon_deg)
    lat = np.radians(lat_deg)
    sin_lat = np.sin(lat)
    nu = a / np.sqrt(1 - e2 * sin_lat**2)
    x = nu * np.cos(lat) * np.cos(lon)
    y = nu * np.cos(lat) * np.sin(lon)
    z = nu * (1 - e2) * sin_lat
    return x, y, z


def _geocentric_to_geodetic(a, e2, x, y, z):
    lon = np.arctan2(y, x)
    p = np.sqrt(x**2 + y**2)
    # iterate the latitude (sub-mm after a few rounds)
    lat = np.arctan2(z, p * (1 - e2))
    for _ in range(6):
        sin_lat = np.sin(lat)
        nu = a / np.sqrt(1 - e2 * sin_lat**2)
        lat = np.arctan2(z + e2 * nu * sin_lat, p)
    return np.degrees(lon), np.degrees(lat)


def _helmert(params, x, y, z, inverse=False):
    """Position-vector 7-parameter transformation (EPSG 9606): rotations in
    arc-seconds, scale in ppm; the inverse applies the negated parameters."""
    if inverse:
        params = tuple(-v for v in params)
    dx, dy, dz, rx, ry, rz, s_ppm = params
    arc = math.pi / (180.0 * 3600.0)
    rx, ry, rz = rx * arc, ry * arc, rz * arc
    m = 1.0 + s_ppm * 1e-6
    nx = dx + m * (x - rz * y + ry * z)
    ny = dy + m * (rz * x + y - rx * z)
    nz = dz + m * (-ry * x + rx * y + z)
    return nx, ny, nz


_NULL_SHIFT = (0.0,) * 7


def _e2_of(crs):
    """Ellipsoid eccentricity squared; inv_flattening == 0 encodes a sphere."""
    if not crs.inv_flattening:
        return 0.0
    f = 1.0 / crs.inv_flattening
    return f * (2 - f)


#: the environment variable that registers NTv2 grids with kart_tpu
NTV2_GRID_DIR_ENV = "KART_NTV2_GRID_DIR"


def _same_datum(src, dst):
    return src.datum_name is not None and src.datum_name == dst.datum_name


def _datum_shift(src, dst, lon, lat):
    """Geographic coordinates on the src datum -> the dst datum via WGS84,
    by the CRSes' TOWGS84 parameters; a no-op for the same datum or equal
    declared shifts."""
    if _same_datum(src, dst):
        return lon, lat
    src_tw = src.towgs84 if src.towgs84 != _NULL_SHIFT else None
    dst_tw = dst.towgs84 if dst.towgs84 != _NULL_SHIFT else None
    if src_tw == dst_tw:  # includes None == None
        return lon, lat
    x, y, z = _geodetic_to_geocentric(src.semi_major, _e2_of(src), lon, lat)
    if src_tw is not None:
        x, y, z = _helmert(src_tw, x, y, z)
    if dst_tw is not None:
        x, y, z = _helmert(dst_tw, x, y, z, inverse=True)
    return _geocentric_to_geodetic(dst.semi_major, _e2_of(dst), x, y, z)


class Transform:
    """Vectorized coordinate transform between two CRSes. Datum shifts apply
    when either side declares TOWGS84; a datum without one is taken as
    WGS84-equivalent."""

    def __init__(self, src, dst):
        self.src = make_crs(src) if not isinstance(src, CRS) else src
        self.dst = make_crs(dst) if not isinstance(dst, CRS) else dst
        self.is_identity = normalise_wkt(self.src.wkt) == normalise_wkt(self.dst.wkt)
        if not self.is_identity:
            for crs in (self.src, self.dst):
                require_geographic(crs)
            # kart_tpu shifts a datum by an NTv2 grid registered through
            # this variable in preference to Helmert; grids are not ported
            if os.environ.get(NTV2_GRID_DIR_ENV) and not _same_datum(self.src, self.dst):
                raise NotYetImplemented(
                    f"NTv2 grid shifts ({NTV2_GRID_DIR_ENV}) are not ported yet"
                )

    def transform(self, xs, ys):
        """(xs, ys) arrays in the src CRS -> (xs, ys) in the dst CRS."""
        xs = np.asarray(xs, dtype=np.float64)
        ys = np.asarray(ys, dtype=np.float64)
        if self.is_identity:
            return xs, ys
        return _datum_shift(self.src, self.dst, xs, ys)

    def transform_envelope(self, env, densify=5):
        """(min-x, max-x, min-y, max-y) -> the transformed envelope, each
        edge densified so that curvature is captured."""
        x0, x1, y0, y1 = env
        t = np.linspace(0.0, 1.0, densify)
        xs = np.concatenate(
            [x0 + (x1 - x0) * t, np.full(densify, x1), x1 + (x0 - x1) * t, np.full(densify, x0)]
        )
        ys = np.concatenate(
            [np.full(densify, y0), y0 + (y1 - y0) * t, np.full(densify, y1), y1 + (y0 - y1) * t]
        )
        tx, ty = self.transform(xs, ys)
        return (float(tx.min()), float(tx.max()), float(ty.min()), float(ty.max()))


def require_geographic(crs):
    """Raise NotYetImplemented unless ``crs`` is geographic: the transforms
    of projected CRSes are not ported yet."""
    if not crs.is_geographic:
        raise NotYetImplemented(
            f"CRS {crs.name!r} ({crs.projection or 'not geographic'}): projected "
            "CRS transforms are not ported yet"
        )
