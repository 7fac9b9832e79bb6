"""Geometry values in GeoPackage binary form (``b"GP" + version + flags +
srs_id + [envelope] + WKB``), as Kart stores them.

Counterpart of kart_tpu's ``geometry.py`` for what the diff output and the
spatial filter need: :class:`Geometry` with its header readers, ``of``,
``from_wkb``, ``from_hex_wkb``, ``from_wkt``, ``from_string``,
``to_hex_wkb``, ``to_wkt`` and ``envelope``; the structured value
:class:`GeomValue` with ``parse_wkb``/``write_wkb``, ``parse_wkt``/
``write_wkt`` and ``wkb_envelope``; GeoJSON (``to_geojson``,
:func:`geojson_to_geometry`) and ``to_coords``/``_build_gpkg`` for
reprojection; :func:`gpkg_hex_wkb` (the fused blob->JSON path); and
``with_crs_id`` and ``normalised``, which a working copy and an import
need; and EWKB (``from_ewkb``, ``from_hex_ewkb``, ``to_ewkb``,
``to_hex_ewkb``: the SRID embedded), which the PostGIS working copy and
import source exchange with the server.

Canonical storage form: little-endian header and WKB, srs_id 0, an XY
envelope for everything but points and empties (XYZ with Z).
"""

import binascii
import json
import math
import re
import struct

EMPTY_BIT = 0b10000
LE_BIT = 0b1
ENVELOPE_BITS = 0b1110
EXTENDED_BIT = 0b100000

ENVELOPE_NONE = 0
ENVELOPE_XY = 1
ENVELOPE_XYZ = 2

# doubles per envelope kind
_ENVELOPE_DOUBLES = {0: 0, 1: 4, 2: 6, 3: 6, 4: 8}

POINT = 1
LINESTRING = 2
POLYGON = 3
MULTIPOINT = 4
MULTILINESTRING = 5
MULTIPOLYGON = 6
GEOMETRYCOLLECTION = 7

GEOMETRY_TYPE_NAMES = {
    POINT: "Point",
    LINESTRING: "LineString",
    POLYGON: "Polygon",
    MULTIPOINT: "MultiPoint",
    MULTILINESTRING: "MultiLineString",
    MULTIPOLYGON: "MultiPolygon",
    GEOMETRYCOLLECTION: "GeometryCollection",
}
_NAME_TO_TYPE = {v.upper(): k for k, v in GEOMETRY_TYPE_NAMES.items()}


class GeometryError(ValueError):
    pass


def flatten_type(wkb_type):
    """ISO (1001, 3007, ...) or EWKB type code -> base 2D type (1..7)."""
    return (wkb_type & 0x0FFFFFFF) % 1000


def type_has_z(wkb_type):
    return bool(wkb_type & 0x80000000) or (wkb_type & 0x0FFFFFFF) % 10000 // 1000 in (1, 3)


def type_has_m(wkb_type):
    return bool(wkb_type & 0x40000000) or (wkb_type & 0x0FFFFFFF) % 10000 // 1000 in (2, 3)


def gpkg_hex_wkb(buf):
    """GPKG geometry blob bytes -> upper-hex little-endian ISO WKB (the JSON
    diff representation) without building a Geometry; big-endian or
    malformed input takes the Geometry path (which raises GeometryError)."""
    if len(buf) >= 9 and buf[:2] == b"GP" and buf[2] == 0:
        flags = buf[3]
        if not flags & EXTENDED_BIT:
            n = _ENVELOPE_DOUBLES.get((flags & ENVELOPE_BITS) >> 1)
            if n is not None:
                off = 8 + n * 8
                if len(buf) == off or buf[off] == 1:  # empty or LE WKB
                    return buf[off:].hex().upper()
    return Geometry.of(buf).to_hex_wkb()


class Geometry(bytes):
    """Immutable GPKG-binary geometry value (a bytes subclass)."""

    @classmethod
    def of(cls, data):
        if not data:  # None, b"" -> no geometry
            return None
        if isinstance(data, Geometry):
            return data
        return cls(data)

    def __init__(self, data):
        super().__init__()
        if not self.startswith(b"GP"):
            raise ValueError(
                "Invalid GeoPackage geometry (no GP magic); "
                "use Geometry.from_wkb / from_wkt to construct"
            )

    def __str__(self):
        return f"G{super().__str__()}"

    def __repr__(self):
        return f"Geometry({super().__str__()})"

    def __json__(self):
        return self.to_hex_wkb()

    # -- header --------------------------------------------------------------

    @property
    def flags(self):
        version, flags = struct.unpack_from("BB", self, 2)
        if version != 0:
            raise GeometryError(f"Unsupported GPKG geometry version {version}")
        if flags & EXTENDED_BIT:
            raise GeometryError("ExtendedGeoPackageBinary is not supported")
        return flags

    @property
    def is_little_endian(self):
        return bool(self.flags & LE_BIT)

    @property
    def is_empty(self):
        return bool(self.flags & EMPTY_BIT)

    @property
    def envelope_kind(self):
        return (self.flags & ENVELOPE_BITS) >> 1

    @property
    def wkb_offset(self):
        n = _ENVELOPE_DOUBLES.get(self.envelope_kind)
        if n is None:
            raise GeometryError("Invalid envelope-contents indicator")
        return 8 + n * 8

    @property
    def crs_id(self):
        return struct.unpack_from("<i" if self.is_little_endian else ">i", self, 4)[0]

    def with_crs_id(self, crs_id):
        """A copy with the srs_id header field set (storage holds 0; a
        working copy holds the real id)."""
        if crs_id == self.crs_id:
            return self
        fmt = "<i" if self.is_little_endian else ">i"
        return Geometry(self[:4] + struct.pack(fmt, crs_id) + self[8:])

    @property
    def geometry_type(self):
        return flatten_type(self._wkb_type())

    @property
    def geometry_type_name(self):
        return GEOMETRY_TYPE_NAMES.get(self.geometry_type, "Unknown")

    def _wkb_type(self):
        off = self.wkb_offset
        return struct.unpack_from("<I" if self[off] else ">I", self, off + 1)[0]

    @property
    def has_z(self):
        return type_has_z(self._wkb_type())

    @property
    def has_m(self):
        return type_has_m(self._wkb_type())

    # -- conversions ---------------------------------------------------------

    @classmethod
    def from_wkb(cls, wkb, crs_id=0):
        if wkb is None or wkb == b"":
            return None
        return _build_gpkg(parse_wkb(wkb), crs_id=crs_id)

    @classmethod
    def from_hex_wkb(cls, hex_wkb, crs_id=0):
        if not hex_wkb:
            return None
        return cls.from_wkb(binascii.unhexlify(hex_wkb), crs_id=crs_id)

    @classmethod
    def from_hex_ewkb(cls, hex_ewkb):
        if not hex_ewkb:
            return None
        return cls.from_ewkb(binascii.unhexlify(hex_ewkb))

    @classmethod
    def from_ewkb(cls, ewkb):
        """EWKB bytes (an SRID embedded or not) -> Geometry with that srs_id."""
        if not ewkb:
            return None
        coords, srid = _parse_any_wkb(ewkb)
        return _build_gpkg(coords, crs_id=srid or 0)

    @classmethod
    def from_wkt(cls, wkt, crs_id=0):
        if not wkt:
            return None
        return _build_gpkg(parse_wkt(wkt), crs_id=crs_id)

    @classmethod
    def from_string(cls, text, allowed_types=None, allow_empty=False):
        """User-supplied WKT or hex WKB -> Geometry."""
        text = text.strip()
        try:
            if re.fullmatch(r"[0-9a-fA-F]+", text):
                geom = cls.from_hex_wkb(text)
            else:
                geom = cls.from_wkt(text)
        except Exception as e:  # any parse failure is the user's input
            raise GeometryError(f"Invalid geometry: {text!r} ({e})")
        if geom is None:
            raise GeometryError("Invalid geometry: empty input")
        if allowed_types is not None and geom.geometry_type not in allowed_types:
            names = "|".join(GEOMETRY_TYPE_NAMES[t] for t in allowed_types)
            raise GeometryError(
                f"Expected geometry of type {names} but found: {geom.geometry_type_name}"
            )
        if not allow_empty and geom.is_empty:
            raise GeometryError("A non-empty geometry is required")
        return geom

    def to_wkb(self):
        """Little-endian ISO WKB."""
        wkb = bytes(self[self.wkb_offset :])
        if wkb and wkb[0] == 0:  # stored big-endian: rewrite
            return write_wkb(parse_wkb(wkb))
        return wkb

    def to_hex_wkb(self):
        return binascii.hexlify(self.to_wkb()).decode("ascii").upper()

    def to_ewkb(self):
        """Little-endian EWKB with the srs_id embedded (none when it is 0)."""
        return write_wkb(parse_wkb(self.to_wkb()), ewkb_srid=self.crs_id or None)

    def to_hex_ewkb(self):
        return binascii.hexlify(self.to_ewkb()).decode("ascii").upper()

    def to_wkt(self):
        return write_wkt(parse_wkb(self.to_wkb()))

    def to_geojson(self):
        return _to_geojson(parse_wkb(self.to_wkb()))

    def to_coords(self):
        """-> the structured :class:`GeomValue` (see :func:`parse_wkb`)."""
        return parse_wkb(self.to_wkb())

    # -- envelope ------------------------------------------------------------

    def envelope(self, only_xy=True):
        """(min-x, max-x, min-y, max-y[, min-z, max-z...]) or None if empty:
        the stored envelope header when there is one, else computed from the
        WKB."""
        kind = self.envelope_kind
        if kind != ENVELOPE_NONE:
            n = _ENVELOPE_DOUBLES[kind]
            fmt = ("<" if self.is_little_endian else ">") + "d" * n
            env = struct.unpack_from(fmt, self, 8)
            return env[:4] if only_xy else env
        if self.is_empty:
            return None
        off = self.wkb_offset
        # 2D point fast path: canonical points carry no envelope header
        if len(self) >= off + 21:
            lt = "<" if self[off] == 1 else ">"
            (wkb_type,) = struct.unpack_from(lt + "I", self, off + 1)
            if wkb_type == 1 and only_xy:
                x, y = struct.unpack_from(lt + "2d", self, off + 5)
                if x != x and y != y:  # all-NaN coordinates: an empty point
                    return None
                return (x, x, y, y)
        env = wkb_envelope(memoryview(self)[off:])
        if env is None:
            return None
        return env[:4] if only_xy else env

    def normalised(self):
        """The canonical storage form; self when it is canonical already."""
        if self.flags & LE_BIT:
            off = self.wkb_offset
            if self[off] == 1 and self.envelope_kind == self._wanted_envelope_kind():
                if self[4:8] == b"\x00\x00\x00\x00":
                    return self
                return Geometry(self[:4] + b"\x00\x00\x00\x00" + self[8:])
        return _build_gpkg(parse_wkb(bytes(self[self.wkb_offset :])), crs_id=0)

    def _wanted_envelope_kind(self):
        if self.is_empty or self.geometry_type == POINT:
            return ENVELOPE_NONE
        return ENVELOPE_XYZ if self.has_z else ENVELOPE_XY


# ---------------------------------------------------------------------------
# The structured value: (type name, has_z, has_m, payload)
#   Point             -> tuple of 2-4 floats, or None when empty
#   LineString        -> list of point tuples
#   Polygon           -> list of rings (lists of point tuples)
#   Multi*/Collection -> list of GeomValues
# ---------------------------------------------------------------------------


class GeomValue(tuple):
    """(type_name, has_z, has_m, payload)."""

    __slots__ = ()

    @property
    def base_type(self):
        return _NAME_TO_TYPE[self[0].upper()]

    @property
    def has_z(self):
        return self[1]

    @property
    def has_m(self):
        return self[2]

    @property
    def payload(self):
        return self[3]


def _geom_value(name, has_z, has_m, payload):
    return GeomValue((name, has_z, has_m, payload))


def _coord_dim(has_z, has_m):
    return 2 + (1 if has_z else 0) + (1 if has_m else 0)


def parse_wkb(buf, offset=0):
    value, _ = _parse_wkb_inner(memoryview(buf), offset)
    return value


def _parse_any_wkb(buf):
    """EWKB or ISO WKB -> (GeomValue, the embedded SRID or None)."""
    mv = memoryview(buf)
    bo = "<" if mv[0] == 1 else ">"
    (raw_type,) = struct.unpack_from(bo + "I", mv, 1)
    srid = struct.unpack_from(bo + "i", mv, 5)[0] if raw_type & 0x20000000 else None
    return _parse_wkb_inner(mv, 0)[0], srid


def _parse_wkb_inner(mv, off):
    bo = "<" if mv[off] == 1 else ">"
    (raw_type,) = struct.unpack_from(bo + "I", mv, off + 1)
    off += 5
    if raw_type & 0x20000000:  # EWKB embedded SRID: skip
        off += 4
    base = flatten_type(raw_type)
    has_z, has_m = type_has_z(raw_type), type_has_m(raw_type)
    dim = _coord_dim(has_z, has_m)
    name = GEOMETRY_TYPE_NAMES.get(base)
    if name is None:
        raise GeometryError(f"Unsupported WKB geometry type {raw_type}")
    if base == POINT:
        pt = struct.unpack_from(bo + "d" * dim, mv, off)
        off += 8 * dim
        if all(math.isnan(c) for c in pt):
            pt = None
        return _geom_value(name, has_z, has_m, pt), off
    (count,) = struct.unpack_from(bo + "I", mv, off)
    off += 4
    if base == LINESTRING:
        pts = list(struct.iter_unpack(bo + "d" * dim, mv[off : off + count * dim * 8]))
        return _geom_value(name, has_z, has_m, pts), off + count * dim * 8
    if base == POLYGON:
        rings = []
        for _ in range(count):
            (npts,) = struct.unpack_from(bo + "I", mv, off)
            off += 4
            rings.append(list(struct.iter_unpack(bo + "d" * dim, mv[off : off + npts * dim * 8])))
            off += npts * dim * 8
        return _geom_value(name, has_z, has_m, rings), off
    # Multi* / GeometryCollection: children are whole WKB geometries
    children = []
    for _ in range(count):
        child, off = _parse_wkb_inner(mv, off)
        children.append(child)
    return _geom_value(name, has_z, has_m, children), off


def write_wkb(value, ewkb_srid=None):
    """GeomValue -> little-endian ISO WKB, or EWKB with ``ewkb_srid``
    embedded in the outer geometry."""
    out = bytearray()
    _write_wkb_inner(value, out, ewkb_srid)
    return bytes(out)


def _write_wkb_inner(value, out, ewkb_srid=None):
    name, has_z, has_m, payload = value
    base = _NAME_TO_TYPE[name.upper()]
    dim = _coord_dim(has_z, has_m)
    pt = struct.Struct("<" + "d" * dim)
    if ewkb_srid is None:
        out += struct.pack("<BI", 1, base + (1000 if has_z else 0) + (2000 if has_m else 0))
    else:
        raw = base | (0x80000000 if has_z else 0) | (0x40000000 if has_m else 0) | 0x20000000
        out += struct.pack("<BIi", 1, raw, ewkb_srid)
    if base == POINT:
        out += pt.pack(*(payload if payload is not None else (math.nan,) * dim))
        return
    out += struct.pack("<I", len(payload))
    if base == LINESTRING:
        for p in payload:
            out += pt.pack(*p)
    elif base == POLYGON:
        for ring in payload:
            out += struct.pack("<I", len(ring))
            for p in ring:
                out += pt.pack(*p)
    else:
        for child in payload:
            _write_wkb_inner(child, out)


def _value_is_empty(value):
    if value.base_type == POINT:
        return value.payload is None
    return len(value.payload) == 0


def _iter_points(value):
    base = value.base_type
    if base == POINT:
        if value.payload is not None:
            yield value.payload
    elif base == LINESTRING:
        yield from value.payload
    elif base == POLYGON:
        for ring in value.payload:
            yield from ring
    else:
        for child in value.payload:
            yield from _iter_points(child)


def _envelope_of_points(value, pts):
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    env = (min(xs), max(xs), min(ys), max(ys))
    if value.has_z:
        zs = [p[2] for p in pts]
        env += (min(zs), max(zs))
    return env


def wkb_envelope(wkb):
    """WKB bytes -> (min-x, max-x, min-y, max-y[, min-z, max-z]) or None
    when empty."""
    value = parse_wkb(wkb)
    pts = list(_iter_points(value))
    return _envelope_of_points(value, pts) if pts else None


def _build_gpkg(value, crs_id=0):
    """GeomValue -> canonical-form Geometry."""
    empty = _value_is_empty(value)
    if value.base_type == POINT or empty:
        env_kind, env = ENVELOPE_NONE, ()
    else:
        full = _envelope_of_points(value, list(_iter_points(value)))
        env_kind, env = (ENVELOPE_XYZ, full) if value.has_z else (ENVELOPE_XY, full[:4])
    flags = LE_BIT | (env_kind << 1) | (EMPTY_BIT if empty else 0)
    header = b"GP\x00" + bytes([flags]) + struct.pack("<i", crs_id)
    return Geometry(header + struct.pack("<" + "d" * len(env), *env) + write_wkb(value))


# ---------------------------------------------------------------------------
# WKT
# ---------------------------------------------------------------------------

_WKT_TOKEN = re.compile(r"\s*([A-Za-z]+|\(|\)|,|[-+0-9.eE]+)")


def parse_wkt(wkt):
    tokens = _WKT_TOKEN.findall(wkt)
    try:
        value, _pos = _parse_wkt_geom(tokens, 0)
    except GeometryError:
        raise
    except (ValueError, IndexError) as e:
        raise GeometryError(f"Invalid WKT {wkt[:60]!r}: {e}") from e
    return _normalise_wkt_arity(value)


def _normalise_wkt_arity(value):
    """Infer Z/M from the coordinate arity when no marker was given
    ('POINT (1 2 3)' is 3D), then pad or trim every point to the final
    dimension."""
    has_z, has_m = value.has_z, value.has_m
    if not has_z and not has_m:
        arity = max((len(p) for p in _iter_points(value)), default=2)
        if arity == 3:
            has_z = True
        elif arity >= 4:
            has_z = has_m = True
    return _rebuild_with_dim(value, has_z, has_m, _coord_dim(has_z, has_m))


def _rebuild_with_dim(value, has_z, has_m, dim):
    base = value.base_type

    def fix_pt(p):
        return tuple(p[:dim]) + (0.0,) * (dim - len(p))

    payload = value.payload
    if base == POINT:
        new = fix_pt(payload) if payload is not None else None
    elif base == LINESTRING:
        new = [fix_pt(p) for p in payload]
    elif base == POLYGON:
        new = [[fix_pt(p) for p in ring] for ring in payload]
    else:
        new = [_rebuild_with_dim(c, has_z, has_m, dim) for c in payload]
    return _geom_value(value[0], has_z, has_m, new)


def _parse_wkt_geom(tokens, pos):
    name = tokens[pos].upper()
    if name not in _NAME_TO_TYPE:
        raise GeometryError(f"Unsupported WKT geometry type {tokens[pos]!r}")
    pos += 1
    has_z = has_m = False
    while pos < len(tokens) and tokens[pos].upper() in ("Z", "M", "ZM", "EMPTY"):
        tok = tokens[pos].upper()
        if tok == "EMPTY":
            base = _NAME_TO_TYPE[name]
            payload = None if base == POINT else []
            return _geom_value(GEOMETRY_TYPE_NAMES[base], has_z, has_m, payload), pos + 1
        has_z = "Z" in tok
        has_m = "M" in tok
        pos += 1

    base = _NAME_TO_TYPE[name]

    def parse_point_seq(pos):
        # "( x y [z [m]] , x y ... )", raw arity kept: parse_wkt's
        # normalisation infers Z/M and pads afterwards
        _check_open(tokens, pos, f"expected ( at {pos}")
        pos += 1
        pts = []
        while True:
            pt = []
            while pos < len(tokens) and tokens[pos] not in (",", ")"):
                pt.append(float(tokens[pos]))
                pos += 1
            pts.append(tuple(pt))
            if tokens[pos] == ")":
                return pts, pos + 1
            pos += 1  # skip the comma

    if base == POINT:
        pts, pos = parse_point_seq(pos)
        return _geom_value("Point", has_z, has_m, pts[0]), pos
    if base == LINESTRING:
        pts, pos = parse_point_seq(pos)
        return _geom_value("LineString", has_z, has_m, pts), pos
    if base == POLYGON:
        _check_open(tokens, pos)
        pos += 1
        rings = []
        while True:
            ring, pos = parse_point_seq(pos)
            rings.append(ring)
            if tokens[pos] == ")":
                return _geom_value("Polygon", has_z, has_m, rings), pos + 1
            pos += 1
    if base == MULTIPOINT:
        # both MULTIPOINT(1 2, 3 4) and MULTIPOINT((1 2),(3 4))
        _check_open(tokens, pos)
        if tokens[pos + 1] == "(":
            pos += 1
            children = []
            while True:
                pts, pos = parse_point_seq(pos)
                children.append(_geom_value("Point", has_z, has_m, pts[0]))
                if tokens[pos] == ")":
                    return _geom_value("MultiPoint", has_z, has_m, children), pos + 1
                pos += 1
        pts, pos = parse_point_seq(pos)
        children = [_geom_value("Point", has_z, has_m, p) for p in pts]
        return _geom_value("MultiPoint", has_z, has_m, children), pos
    if base in (MULTILINESTRING, MULTIPOLYGON):
        child_name = "LineString" if base == MULTILINESTRING else "Polygon"
        _check_open(tokens, pos)
        pos += 1
        children = []
        while True:
            if base == MULTILINESTRING:
                pts, pos = parse_point_seq(pos)
                children.append(_geom_value(child_name, has_z, has_m, pts))
            else:
                _check_open(tokens, pos)
                pos += 1
                rings = []
                while True:
                    ring, pos = parse_point_seq(pos)
                    rings.append(ring)
                    if tokens[pos] == ")":
                        pos += 1
                        break
                    pos += 1
                children.append(_geom_value(child_name, has_z, has_m, rings))
            if tokens[pos] == ")":
                return _geom_value(GEOMETRY_TYPE_NAMES[base], has_z, has_m, children), pos + 1
            pos += 1
    # GeometryCollection
    _check_open(tokens, pos)
    pos += 1
    children = []
    while True:
        child, pos = _parse_wkt_geom(tokens, pos)
        children.append(child)
        if tokens[pos] == ")":
            return _geom_value("GeometryCollection", has_z, has_m, children), pos + 1
        pos += 1


def _check_open(tokens, pos, msg=""):
    """kart_tpu asserts each opening parenthesis; the assertion (not a
    GeometryError) reaches the caller, whose message it shapes."""
    if tokens[pos] != "(":
        raise AssertionError(msg)


def _fmt_num(x):
    if math.isfinite(x) and x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return repr(x)  # nan, inf and non-integral values: repr round-trips


def _fmt_point(pt):
    return " ".join(_fmt_num(c) for c in pt)


def write_wkt(value):
    name, has_z, has_m, payload = value
    base = value.base_type
    prefix = name.upper() + (" Z" if has_z else "") + (" M" if has_m else "")
    if _value_is_empty(value):
        return f"{prefix} EMPTY"
    if base == POINT:
        return f"{prefix} ({_fmt_point(payload)})"
    if base == LINESTRING:
        return f"{prefix} ({','.join(_fmt_point(p) for p in payload)})"
    if base == POLYGON:
        rings = ",".join("(" + ",".join(_fmt_point(p) for p in ring) + ")" for ring in payload)
        return f"{prefix} ({rings})"
    if base == MULTIPOINT:
        pts = ",".join("(" + _fmt_point(c.payload) + ")" for c in payload)
        return f"{prefix} ({pts})"
    if base == MULTILINESTRING:
        lines = ",".join("(" + ",".join(_fmt_point(p) for p in c.payload) + ")" for c in payload)
        return f"{prefix} ({lines})"
    if base == MULTIPOLYGON:
        polys = ",".join(
            "(" + ",".join("(" + ",".join(_fmt_point(p) for p in ring) + ")"
                           for ring in c.payload) + ")"
            for c in payload
        )
        return f"{prefix} ({polys})"
    inner = ",".join(write_wkt(c) for c in payload)
    return f"{prefix} ({inner})"


# ---------------------------------------------------------------------------
# GeoJSON
# ---------------------------------------------------------------------------


def _strip_zm(pt, has_z):
    """GeoJSON keeps x, y and z, never m."""
    return list(pt[: 3 if has_z else 2])


def _to_geojson(value):
    name, has_z, has_m, payload = value
    base = value.base_type
    if base == POINT:
        return {"type": "Point",
                "coordinates": _strip_zm(payload, has_z) if payload is not None else []}
    if base == LINESTRING:
        return {"type": "LineString", "coordinates": [_strip_zm(p, has_z) for p in payload]}
    if base == POLYGON:
        return {"type": "Polygon",
                "coordinates": [[_strip_zm(p, has_z) for p in ring] for ring in payload]}
    if base == MULTIPOINT:
        return {"type": "MultiPoint",
                "coordinates": [_strip_zm(c.payload, c.has_z) for c in payload]}
    if base == MULTILINESTRING:
        return {"type": "MultiLineString",
                "coordinates": [[_strip_zm(p, c.has_z) for p in c.payload] for c in payload]}
    if base == MULTIPOLYGON:
        return {"type": "MultiPolygon",
                "coordinates": [[[_strip_zm(p, c.has_z) for p in ring] for ring in c.payload]
                                for c in payload]}
    return {"type": "GeometryCollection", "geometries": [_to_geojson(c) for c in payload]}


def geojson_to_geometry(obj, crs_id=0):
    """GeoJSON dict (or JSON text) -> Geometry in canonical form."""
    if isinstance(obj, str):
        obj = json.loads(obj)
    return _build_gpkg(_from_geojson(obj), crs_id=crs_id)


def _from_geojson(obj):
    t = obj["type"]
    base = _NAME_TO_TYPE.get(t.upper())
    if base is None:
        raise GeometryError(f"Unsupported GeoJSON geometry type {t!r}")
    if base == GEOMETRYCOLLECTION:
        children = [_from_geojson(g) for g in obj["geometries"]]
        return _geom_value("GeometryCollection", any(c.has_z for c in children), False,
                           children)
    coords = obj["coordinates"]

    def dims(c):
        while c and isinstance(c[0], (list, tuple)):
            c = c[0]
        return len(c) if c else 2

    has_z = dims(coords) >= 3

    def pt(c):
        return tuple(c[:2]) + ((c[2] if len(c) > 2 else 0.0,) if has_z else ())

    if base == POINT:
        return _geom_value("Point", has_z, False, pt(coords) if coords else None)
    if base == LINESTRING:
        return _geom_value("LineString", has_z, False, [pt(c) for c in coords])
    if base == POLYGON:
        return _geom_value("Polygon", has_z, False, [[pt(c) for c in ring] for ring in coords])
    if base == MULTIPOINT:
        return _geom_value("MultiPoint", has_z, False,
                           [_geom_value("Point", has_z, False, pt(c)) for c in coords])
    if base == MULTILINESTRING:
        return _geom_value(
            "MultiLineString", has_z, False,
            [_geom_value("LineString", has_z, False, [pt(p) for p in c]) for c in coords])
    return _geom_value(
        "MultiPolygon", has_z, False,
        [_geom_value("Polygon", has_z, False, [[pt(p) for p in ring] for ring in c])
         for c in coords])
