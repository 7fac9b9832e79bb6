"""Geometry values in GeoPackage binary form (``b"GP" + version + flags +
srs_id + [envelope] + WKB``), as Kart stores them.

Counterpart of the part of kart_tpu's ``geometry.py`` the diff output
needs: :class:`Geometry` with its header readers, ``of``, ``from_wkb``,
``to_hex_wkb`` and ``__json__``, and :func:`gpkg_hex_wkb` (the fused
blob->JSON path). WKT, GeoJSON, EWKB and normalisation are not ported.
"""

import binascii
import math
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

GEOMETRY_TYPE_NAMES = {
    1: "Point",
    2: "LineString",
    3: "Polygon",
    4: "MultiPoint",
    5: "MultiLineString",
    6: "MultiPolygon",
    7: "GeometryCollection",
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
                "Invalid GeoPackage geometry (no GP magic); use Geometry.from_wkb"
            )

    def __str__(self):
        return f"G{super().__str__()}"

    def __repr__(self):
        return f"Geometry({super().__str__()})"

    def __json__(self):
        return self.to_hex_wkb()

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

    @classmethod
    def from_wkb(cls, wkb, crs_id=0):
        if wkb is None or wkb == b"":
            return None
        return _build_gpkg(parse_wkb(wkb), crs_id=crs_id)

    def to_wkb(self):
        """Little-endian ISO WKB."""
        wkb = bytes(self[self.wkb_offset :])
        if wkb and wkb[0] == 0:  # stored big-endian: rewrite
            return write_wkb(parse_wkb(wkb))
        return wkb

    def to_hex_wkb(self):
        return binascii.hexlify(self.to_wkb()).decode("ascii").upper()


# structured value: (type name, has_z, has_m, payload); payload is a point
# tuple (None when empty), a point list, a ring list or a child list


def parse_wkb(buf):
    value, _ = _parse_wkb_inner(memoryview(buf), 0)
    return value


def _parse_wkb_inner(mv, off):
    bo = "<" if mv[off] == 1 else ">"
    (raw_type,) = struct.unpack_from(bo + "I", mv, off + 1)
    off += 5
    if raw_type & 0x20000000:  # EWKB embedded SRID: skip
        off += 4
    base = flatten_type(raw_type)
    has_z, has_m = type_has_z(raw_type), type_has_m(raw_type)
    dim = 2 + has_z + has_m
    name = GEOMETRY_TYPE_NAMES.get(base)
    if name is None:
        raise GeometryError(f"Unsupported WKB geometry type {raw_type}")
    if base == POINT:
        pt = struct.unpack_from(bo + "d" * dim, mv, off)
        off += 8 * dim
        if all(math.isnan(c) for c in pt):
            pt = None
        return (name, has_z, has_m, pt), off
    (count,) = struct.unpack_from(bo + "I", mv, off)
    off += 4
    if base == LINESTRING:
        pts = list(struct.iter_unpack(bo + "d" * dim, mv[off : off + count * dim * 8]))
        return (name, has_z, has_m, pts), off + count * dim * 8
    if base == POLYGON:
        rings = []
        for _ in range(count):
            (npts,) = struct.unpack_from(bo + "I", mv, off)
            off += 4
            rings.append(list(struct.iter_unpack(bo + "d" * dim, mv[off : off + npts * dim * 8])))
            off += npts * dim * 8
        return (name, has_z, has_m, rings), off
    children = []
    for _ in range(count):
        child, off = _parse_wkb_inner(mv, off)
        children.append(child)
    return (name, has_z, has_m, children), off


def write_wkb(value):
    """Structured value -> little-endian ISO WKB."""
    out = bytearray()
    _write_wkb_inner(value, out)
    return bytes(out)


def _write_wkb_inner(value, out):
    name, has_z, has_m, payload = value
    base = _NAME_TO_TYPE[name.upper()]
    dim = 2 + has_z + has_m
    pt = struct.Struct("<" + "d" * dim)
    out += struct.pack("<BI", 1, base + (1000 if has_z else 0) + (2000 if has_m else 0))
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


def _iter_points(value):
    name, _, _, payload = value
    base = _NAME_TO_TYPE[name.upper()]
    if base == POINT:
        if payload is not None:
            yield payload
    elif base == LINESTRING:
        yield from payload
    elif base == POLYGON:
        for ring in payload:
            yield from ring
    else:
        for child in payload:
            yield from _iter_points(child)


def _build_gpkg(value, crs_id=0):
    """Structured value -> canonical-form Geometry: little-endian, an XY (or
    XYZ) envelope for everything but points and empties."""
    name, has_z, _, payload = value
    base = _NAME_TO_TYPE[name.upper()]
    empty = payload is None if base == POINT else len(payload) == 0
    if base == POINT or empty:
        env_kind, env = ENVELOPE_NONE, ()
    else:
        pts = list(_iter_points(value))
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        env = (min(xs), max(xs), min(ys), max(ys))
        env_kind = ENVELOPE_XY
        if has_z:
            zs = [p[2] for p in pts]
            env += (min(zs), max(zs))
            env_kind = ENVELOPE_XYZ
    flags = LE_BIT | (env_kind << 1) | (EMPTY_BIT if empty else 0)
    header = b"GP\x00" + bytes([flags]) + struct.pack("<i", crs_id)
    return Geometry(header + struct.pack("<" + "d" * len(env), *env) + write_wkb(value))
