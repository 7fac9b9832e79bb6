"""FlatGeobuf import source, read by hand: the magic, the flatbuffers
Header, the packed Hilbert R-tree (skipped), then size-prefixed Feature
tables. No ``flatgeobuf`` or ``flatbuffers`` package: :class:`FBTable`
reads the little-endian tables through their vtables.

Column types map to V2 types; a column flagged ``primary_key`` is the pk,
else the record number is an explicit int64 ``FID`` pk. The CRS is the
header's WKT, else the EPSG registry's for its org and code. A geometry's
``ends`` split it into parts.

Counterpart of kart_tpu's ``importer/flatgeobuf.py``: the same schema,
column ids and feature WKB.
"""

import math
import os
import struct

import numpy as np

from kart_tpu_torch.geometry import GeomValue, Geometry, write_wkb
from kart_tpu_torch.importer import ImportSource, ImportSourceError
from kart_tpu_torch.models.schema import ColumnSchema, Schema

# bytes 0-3: 'fgb' + major spec version (3); bytes 4-6: 'fgb'; byte 7 is a
# patch level that may vary between writers (GDAL emits 0x01) — not compared
MAGIC = b"fgb\x03fgb"

# GeometryType enum (FGB and WKB share the numbering for 1..7)
GEOM_NAMES = {
    1: "Point", 2: "LineString", 3: "Polygon", 4: "MultiPoint",
    5: "MultiLineString", 6: "MultiPolygon", 7: "GeometryCollection",
}

# ColumnType enum -> (v2 data type, extra type info)
COLUMN_TYPES = {
    0: ("integer", {"size": 8}),    # Byte
    1: ("integer", {"size": 8}),    # UByte
    2: ("boolean", {}),             # Bool
    3: ("integer", {"size": 16}),   # Short
    4: ("integer", {"size": 16}),   # UShort
    5: ("integer", {"size": 32}),   # Int
    6: ("integer", {"size": 32}),   # UInt
    7: ("integer", {"size": 64}),   # Long
    8: ("integer", {"size": 64}),   # ULong
    9: ("float", {"size": 32}),     # Float
    10: ("float", {"size": 64}),    # Double
    11: ("text", {}),               # String
    12: ("text", {}),               # Json
    13: ("timestamp", {}),          # DateTime
    14: ("blob", {}),               # Binary
}


class FBTable:
    """Minimal flatbuffers table accessor: field slots via the vtable."""

    __slots__ = ("buf", "pos", "_vt", "_vt_size")

    def __init__(self, buf, pos):
        self.buf = buf
        self.pos = pos
        soffset = struct.unpack_from("<i", buf, pos)[0]
        self._vt = pos - soffset
        self._vt_size = struct.unpack_from("<H", buf, self._vt)[0]

    def _slot(self, field_id):
        off = 4 + 2 * field_id
        if off + 2 > self._vt_size:
            return 0
        rel = struct.unpack_from("<H", self.buf, self._vt + off)[0]
        return self.pos + rel if rel else 0

    def scalar(self, field_id, fmt, default=0):
        slot = self._slot(field_id)
        if not slot:
            return default
        return struct.unpack_from(fmt, self.buf, slot)[0]

    def _indirect(self, field_id):
        slot = self._slot(field_id)
        if not slot:
            return 0
        return slot + struct.unpack_from("<I", self.buf, slot)[0]

    def string(self, field_id):
        tgt = self._indirect(field_id)
        if not tgt:
            return None
        n = struct.unpack_from("<I", self.buf, tgt)[0]
        return self.buf[tgt + 4 : tgt + 4 + n].decode("utf-8")

    def vector(self, field_id, dtype):
        """Numeric vector as a numpy array (empty when absent)."""
        tgt = self._indirect(field_id)
        if not tgt:
            return np.empty(0, dtype=dtype)
        n = struct.unpack_from("<I", self.buf, tgt)[0]
        return np.frombuffer(self.buf, dtype=dtype, count=n, offset=tgt + 4)

    def table_vector(self, field_id):
        """Vector of table offsets -> [FBTable]."""
        tgt = self._indirect(field_id)
        if not tgt:
            return []
        n = struct.unpack_from("<I", self.buf, tgt)[0]
        out = []
        for i in range(n):
            p = tgt + 4 + 4 * i
            out.append(FBTable(self.buf, p + struct.unpack_from("<I", self.buf, p)[0]))
        return out

    def table(self, field_id):
        tgt = self._indirect(field_id)
        return FBTable(self.buf, tgt) if tgt else None

    def bytes_vector(self, field_id):
        tgt = self._indirect(field_id)
        if not tgt:
            return b""
        n = struct.unpack_from("<I", self.buf, tgt)[0]
        return self.buf[tgt + 4 : tgt + 4 + n]


def packed_rtree_size(num_items, node_size):
    """Byte size of the packed Hilbert R-tree between header and features
    (flatgeobuf packedrtree: 40 bytes/node — 4 f64 bounds + u64 offset)."""
    if num_items == 0 or node_size == 0:
        return 0
    node_size = max(int(node_size), 2)
    n = int(num_items)
    total = n
    while n != 1:
        n = math.ceil(n / node_size)
        total += n
    return total * 40


def _geom_to_value(geom_table, type_hint, has_z, has_m):
    """FGB Geometry table -> GeomValue (our WKB writer's input form)."""
    gtype = geom_table.scalar(6, "<B", 0) or type_hint
    name = GEOM_NAMES.get(gtype)
    if name is None:
        raise ImportSourceError(f"Unsupported FlatGeobuf geometry type {gtype}")
    xy = geom_table.vector(1, "<f8")
    z = geom_table.vector(2, "<f8")
    m = geom_table.vector(3, "<f8")
    ends = geom_table.vector(0, "<u4")
    pts = xy.reshape(-1, 2)
    got_z = bool(has_z and len(z))
    got_m = bool(has_m and len(m))
    if got_z:
        pts = np.column_stack([pts, z])
    if got_m:
        pts = np.column_stack([pts, m])

    def split(arr):
        if not len(ends):
            return [arr]
        out = []
        start = 0
        for e in ends.tolist():
            out.append(arr[start:e])
            start = e
        return out

    if name == "Point":
        payload = tuple(float(v) for v in pts[0]) if len(pts) else None
        return GeomValue((name, got_z, got_m, payload))
    if name == "LineString":
        return GeomValue((name, got_z, got_m, pts))
    if name == "MultiPoint":
        children = [
            GeomValue(("Point", got_z, got_m, tuple(float(v) for v in row)))
            for row in pts
        ]
        return GeomValue((name, got_z, got_m, children))
    if name == "Polygon":
        return GeomValue((name, got_z, got_m, split(pts)))
    # Multi*/GeometryCollection nest their parts
    parts = geom_table.table_vector(7)
    child_hint = {
        "MultiLineString": 2,
        "MultiPolygon": 3,
        "GeometryCollection": 0,
    }.get(name, 0)
    if parts:
        children = [
            _geom_to_value(p, child_hint, has_z, has_m) for p in parts
        ]
        return GeomValue(
            (name, any(c[1] for c in children), any(c[2] for c in children),
             children)
        )
    # flat encoding (MultiLineString without parts: ends split)
    if name == "MultiLineString":
        children = [
            GeomValue(("LineString", got_z, got_m, part))
            for part in split(pts)
        ]
        return GeomValue((name, got_z, got_m, children))
    raise ImportSourceError(f"FlatGeobuf {name} without parts is not valid")


class FgbReader:
    """Parses the container: header + lazily-iterated features."""

    def __init__(self, path):
        with open(path, "rb") as f:
            self.buf = f.read()
        if self.buf[: len(MAGIC)] != MAGIC:
            raise ImportSourceError(
                f"{path!r} is not a FlatGeobuf file (bad magic)"
            )
        pos = 8
        (hlen,) = struct.unpack_from("<I", self.buf, pos)
        pos += 4
        root = pos + struct.unpack_from("<I", self.buf, pos)[0]
        self.header = FBTable(self.buf, root)
        pos += hlen
        self.name = self.header.string(0)
        self.geometry_type = self.header.scalar(2, "<B", 0)
        self.has_z = bool(self.header.scalar(3, "<B", 0))
        self.has_m = bool(self.header.scalar(4, "<B", 0))
        self.columns = self.header.table_vector(7)
        self.features_count = self.header.scalar(8, "<Q", 0)
        index_node_size = self.header.scalar(9, "<H", 16)
        self.crs = self.header.table(10)
        self.title = self.header.string(11)
        pos += packed_rtree_size(self.features_count, index_node_size)
        self.features_pos = pos

    def iter_feature_tables(self):
        pos = self.features_pos
        buf = self.buf
        n = len(buf)
        while pos < n:
            (flen,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            root = pos + struct.unpack_from("<I", buf, pos)[0]
            yield FBTable(buf, root)
            pos += flen


_PROP_SCALARS = {
    0: ("<b", 1), 1: ("<B", 1), 2: ("<B", 1), 3: ("<h", 2), 4: ("<H", 2),
    5: ("<i", 4), 6: ("<I", 4), 7: ("<q", 8), 8: ("<Q", 8),
    9: ("<f", 4), 10: ("<d", 8),
}


def _parse_properties(raw, col_types):
    """FGB properties blob: (u16 column index, value)* pairs."""
    out = {}
    pos = 0
    n = len(raw)
    while pos + 2 <= n:
        (ci,) = struct.unpack_from("<H", raw, pos)
        pos += 2
        ctype = col_types[ci]
        if ctype in _PROP_SCALARS:
            fmt, size = _PROP_SCALARS[ctype]
            (val,) = struct.unpack_from(fmt, raw, pos)
            pos += size
            if ctype == 2:
                val = bool(val)
            elif ctype in (9, 10):
                val = float(val)
            else:
                val = int(val)
        else:  # String/Json/DateTime/Binary: u32 length + bytes
            (blen,) = struct.unpack_from("<I", raw, pos)
            pos += 4
            data = raw[pos : pos + blen]
            pos += blen
            val = bytes(data) if ctype == 14 else data.decode("utf-8")
        out[ci] = val
    return out


class FlatGeobufImportSource(ImportSource):
    """One .fgb -> one dataset."""

    GEOM_COLUMN = "geom"
    FID_COLUMN = "FID"

    def __init__(self, path, dest_path=None):
        if not os.path.exists(path):
            raise ImportSourceError(f"No such file: {path}")
        self.path = path
        self.reader = FgbReader(path)
        base, _ = os.path.splitext(os.path.basename(path))
        self.dest_path = dest_path or self.reader.name or base
        self._build_schema()

    def _build_schema(self):
        r = self.reader
        cols = []
        self._col_names = []
        self._col_types = []
        self._pk_col_index = None
        for i, col in enumerate(r.columns):
            name = col.string(0)
            ctype = col.scalar(1, "<B", 0)
            self._col_names.append(name)
            self._col_types.append(ctype)
            if col.scalar(9, "<B", 0) and self._pk_col_index is None:
                self._pk_col_index = i

        def free_name(base):
            # a source attribute literally named FID/geom must not collide
            # with the synthesized columns (GDAL round-trips do this)
            name, n = base, 0
            while name in self._col_names:
                n += 1
                name = f"{base}_{n}"
            return name

        self.fid_column = None
        if self._pk_col_index is None:
            self.fid_column = free_name(self.FID_COLUMN)
            cols.append(
                ColumnSchema(
                    ColumnSchema.deterministic_id(
                        self.path, self.fid_column, "integer"
                    ),
                    self.fid_column,
                    "integer",
                    0,
                    {"size": 64},
                )
            )

        # every FGB layer has a geometry concept (geometry_type=Unknown (0)
        # means mixed types, each Feature carrying its own)
        extra = {}
        gname = GEOM_NAMES.get(r.geometry_type)
        if gname:
            extra["geometryType"] = gname.upper() + (" Z" if r.has_z else "")
        ident = self._crs_identifier()
        if ident:
            extra["geometryCRS"] = ident
        self.geom_column = free_name(self.GEOM_COLUMN)
        cols.append(
            ColumnSchema(
                ColumnSchema.deterministic_id(
                    self.path, self.geom_column, "geometry"
                ),
                self.geom_column,
                "geometry",
                None,
                extra,
            )
        )

        for i, (name, ctype) in enumerate(zip(self._col_names, self._col_types)):
            v2_type, extra = COLUMN_TYPES.get(ctype, ("text", {}))
            pk_index = 0 if i == self._pk_col_index else None
            cols.append(
                ColumnSchema(
                    ColumnSchema.deterministic_id(self.path, name, v2_type),
                    name,
                    v2_type,
                    pk_index,
                    dict(extra),
                )
            )
        self._schema = Schema(cols)

    def _crs_identifier(self):
        crs = self.reader.crs
        if crs is None:
            return None
        org = crs.string(0)
        code = crs.scalar(1, "<i", 0)
        if org and code:
            return f"{org}:{code}"
        return None

    def crs_definitions(self):
        crs = self.reader.crs
        if crs is None:
            return {}
        ident = self._crs_identifier()
        wkt = crs.string(4)
        if not wkt and ident and ident.upper().startswith("EPSG:"):
            from kart_tpu_torch.epsg import epsg_wkt

            wkt = epsg_wkt(int(ident.split(":")[1]))
        if ident and wkt:
            return {ident: wkt}
        return {}

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def feature_count(self):
        n = self.reader.features_count
        if n:
            return int(n)
        return sum(1 for _ in self.reader.iter_feature_tables())

    def features(self):
        r = self.reader
        names = self._col_names
        col_types = self._col_types
        for fid, ftable in enumerate(r.iter_feature_tables(), start=1):
            feature = {}
            if self.fid_column is not None:
                feature[self.fid_column] = fid
            geom_table = ftable.table(0)
            geom = None
            if geom_table is not None:
                value = _geom_to_value(
                    geom_table, r.geometry_type, r.has_z, r.has_m
                )
                geom = Geometry.from_wkb(write_wkb(value))
            feature[self.geom_column] = geom
            props = _parse_properties(ftable.bytes_vector(1), col_types)
            for i, name in enumerate(names):
                feature[name] = props.get(i)
            yield feature
