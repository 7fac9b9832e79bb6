"""Shapefile import source: ``.shp``, ``.dbf`` and ``.prj`` read with
``struct`` and numpy, no OGR.

* ``.shp``: a 100-byte header, then (big-endian record header, little-endian
  shape) pairs; each record's coordinates are one ``np.frombuffer``.
* ``.dbf``: dBase III, 32-byte field descriptors and fixed-width records:
  C is text, N integer (no decimals) or numeric, F float, L boolean, D
  date; a blank or ``*``-filled field is null, a record marked ``*`` is
  deleted and its feature skipped.
* ``.prj``: the WKT of the dataset's CRS, when present.

The record number is the explicit int64 ``FID`` pk, as OGR exposes it, so
a re-import lines up row for row. A polygon's rings group by winding:
clockwise rings are shells, counter-clockwise ones holes of the shell that
contains them.

Counterpart of kart_tpu's ``importer/shapefile.py``: the same schema,
column ids and feature WKB.
"""

import datetime
import os
import struct

import numpy as np

from kart_tpu_torch.geometry import Geometry, write_wkb
from kart_tpu_torch.importer import ImportSource, ImportSourceError
from kart_tpu_torch.models.schema import ColumnSchema, Schema

SHP_NULL = 0
SHP_POINT = 1
SHP_POLYLINE = 3
SHP_POLYGON = 5
SHP_MULTIPOINT = 8

_BASE_TYPE = {
    SHP_POINT: "Point",
    SHP_POLYLINE: "MultiLineString",
    SHP_POLYGON: "MultiPolygon",
    SHP_MULTIPOINT: "MultiPoint",
}
# Z variants add +10 (with optional M), M variants +20
_VARIANTS = {t: (t % 10, t >= 10 and t < 20, t >= 20) for t in
             (0, 1, 3, 5, 8, 11, 13, 15, 18, 21, 23, 25, 28)}


def _geom_value(name, has_z, has_m, payload):
    from kart_tpu_torch.geometry import GeomValue

    return GeomValue((name, has_z, has_m, payload))


def _ring_signed_area(points):
    xs = points[:, 0]
    ys = points[:, 1]
    return 0.5 * float(
        np.sum(xs * np.roll(ys, -1)) - np.sum(np.roll(xs, -1) * ys)
    )


def _point_in_ring(pt, ring):
    """Ray-cast point-in-polygon for hole assignment."""
    x, y = pt[0], pt[1]
    inside = False
    n = len(ring)
    j = n - 1
    for i in range(n):
        xi, yi = ring[i][0], ring[i][1]
        xj, yj = ring[j][0], ring[j][1]
        if (yi > y) != (yj > y) and x < (xj - xi) * (y - yi) / (yj - yi) + xi:
            inside = not inside
        j = i
    return inside


class ShpReader:
    """Iterates (record_number, GeomValue-or-None) over a .shp file."""

    def __init__(self, path):
        with open(path, "rb") as f:
            self.data = f.read()
        if len(self.data) < 100:
            raise ImportSourceError(f"{path} is not a shapefile (too short)")
        (file_code,) = struct.unpack(">i", self.data[:4])
        if file_code != 9994:
            raise ImportSourceError(
                f"{path} is not a shapefile (bad magic {file_code})"
            )
        (self.shape_type,) = struct.unpack("<i", self.data[32:36])
        # only explicitly known types: MultiPatch (31) etc. have different
        # record layouts and must be rejected, not garbage-parsed
        if self.shape_type not in _VARIANTS:
            raise ImportSourceError(
                f"{path}: unsupported shape type {self.shape_type}"
            )

    @property
    def has_z(self):
        return _VARIANTS.get(self.shape_type, (0, False, False))[1]

    @property
    def has_m(self):
        v = _VARIANTS.get(self.shape_type, (0, False, False))
        return v[2]  # M-only files; Z files' M values are usually no-data

    def geometry_type_name(self):
        base, has_z, has_m = _VARIANTS.get(
            self.shape_type, (self.shape_type, False, False)
        )
        name = _BASE_TYPE.get(base, "Geometry").upper()
        if has_z:
            name += " Z"
        elif has_m:
            name += " M"
        return name

    def __iter__(self):
        data = self.data
        off = 100
        while off + 8 <= len(data):
            rec_no, content_len = struct.unpack(">ii", data[off : off + 8])
            off += 8
            end = off + content_len * 2
            yield rec_no, self._parse_shape(data[off:end])
            off = end

    def _parse_shape(self, buf):
        (stype,) = struct.unpack("<i", buf[:4])
        if stype == SHP_NULL:
            return None
        base, has_z, has_m = _VARIANTS.get(stype, (stype, False, False))
        if base == SHP_POINT:
            x, y = struct.unpack("<2d", buf[4:20])
            coords = [x, y]
            pos = 20
            if has_z:
                coords.append(struct.unpack("<d", buf[pos : pos + 8])[0])
                pos += 8
            if has_m and pos + 8 <= len(buf):
                coords.append(struct.unpack("<d", buf[pos : pos + 8])[0])
            return _geom_value("Point", has_z, has_m, tuple(coords))
        if base == SHP_MULTIPOINT:
            (n,) = struct.unpack("<i", buf[36:40])
            pts = np.frombuffer(buf, dtype="<f8", count=2 * n, offset=40)
            pts = pts.reshape(n, 2)
            pts = self._append_zm(buf, 40 + 16 * n, n, pts, has_z, has_m)
            return _geom_value(
                "MultiPoint",
                has_z,
                has_m,
                [
                    _geom_value("Point", has_z, has_m, tuple(p))
                    for p in pts.tolist()
                ],
            )
        # PolyLine / Polygon share the parts layout
        nparts, npoints = struct.unpack("<2i", buf[36:44])
        parts = np.frombuffer(buf, dtype="<i4", count=nparts, offset=44)
        pts_off = 44 + 4 * nparts
        pts = np.frombuffer(
            buf, dtype="<f8", count=2 * npoints, offset=pts_off
        ).reshape(npoints, 2)
        pts = self._append_zm(
            buf, pts_off + 16 * npoints, npoints, pts, has_z, has_m
        )
        bounds = list(parts) + [npoints]
        lines = [
            pts[bounds[i] : bounds[i + 1]] for i in range(nparts)
        ]
        if base == SHP_POLYLINE:
            return _geom_value(
                "MultiLineString",
                has_z,
                has_m,
                [
                    _geom_value(
                        "LineString", has_z, has_m,
                        [tuple(p) for p in line.tolist()],
                    )
                    for line in lines
                    if len(line)
                ],
            )
        return self._group_polygon_rings(lines, has_z, has_m)

    @staticmethod
    def _append_zm(buf, pos, n, pts, has_z, has_m):
        """Append Z (and M) columns read from their range-prefixed arrays."""
        cols = [pts]
        if has_z:
            z = np.frombuffer(buf, dtype="<f8", count=n, offset=pos + 16)
            cols.append(z.reshape(n, 1))
            pos += 16 + 8 * n
        if has_m and pos + 16 + 8 * n <= len(buf):
            m = np.frombuffer(buf, dtype="<f8", count=n, offset=pos + 16)
            cols.append(m.reshape(n, 1))
        elif has_m:
            cols.append(np.zeros((n, 1)))
        return np.hstack(cols) if len(cols) > 1 else pts

    @staticmethod
    def _group_polygon_rings(rings, has_z, has_m):
        rings = [r for r in rings if len(r) >= 4]
        if not rings:
            return _geom_value("MultiPolygon", has_z, has_m, [])
        outers = []  # [(ring, [holes])]
        holes = []
        for ring in rings:
            if _ring_signed_area(ring) <= 0:  # CW = outer (shapefile spec)
                outers.append((ring, []))
            else:
                holes.append(ring)
        if not outers:  # degenerate: treat all as outers
            outers = [(r, []) for r in holes]
            holes = []
        for hole in holes:
            if len(outers) == 1:
                outers[0][1].append(hole)
                continue
            for outer, outer_holes in outers:
                if _point_in_ring(hole[0], outer):
                    outer_holes.append(hole)
                    break
            else:
                outers[-1][1].append(hole)
        polys = [
            _geom_value(
                "Polygon", has_z, has_m,
                [[tuple(p) for p in outer.tolist()]]
                + [[tuple(p) for p in h.tolist()] for h in outer_holes],
            )
            for outer, outer_holes in outers
        ]
        return _geom_value("MultiPolygon", has_z, has_m, polys)


class DbfReader:
    """dBase III attribute table: fields + fixed-width records."""

    def __init__(self, path, encoding="latin-1"):
        with open(path, "rb") as f:
            self.data = f.read()
        if len(self.data) < 32:
            raise ImportSourceError(f"{path} is not a DBF file (too short)")
        self.encoding = encoding
        self.n_records = struct.unpack("<i", self.data[4:8])[0]
        # unsigned per the dBase spec: wide tables exceed 32767 bytes/record
        self.header_size = struct.unpack("<H", self.data[8:10])[0]
        self.record_size = struct.unpack("<H", self.data[10:12])[0]
        self.fields = []  # (name, type_char, length, decimals)
        pos = 32
        while pos < self.header_size - 1 and self.data[pos] != 0x0D:
            desc = self.data[pos : pos + 32]
            name = desc[:11].split(b"\x00")[0].decode(self.encoding)
            type_char = chr(desc[11])
            length = desc[16]
            decimals = desc[17]
            self.fields.append((name, type_char, length, decimals))
            pos += 32

    def v2_columns(self):
        """-> [(name, data_type, extra_type_info)]."""
        out = []
        for name, type_char, length, decimals in self.fields:
            if type_char in ("C", "M"):
                out.append((name, "text", {"length": length}))
            elif type_char in ("N",):
                if decimals == 0:
                    out.append((name, "integer", {"size": 64}))
                else:
                    out.append(
                        (name, "numeric",
                         {"precision": length, "scale": decimals})
                    )
            elif type_char == "F":
                out.append((name, "float", {"size": 64}))
            elif type_char == "L":
                out.append((name, "boolean", {}))
            elif type_char == "D":
                out.append((name, "date", {}))
            else:  # unknown dBase type: keep the bytes as text
                out.append((name, "text", {}))
        return out

    def records(self):
        """One item per *physical* record, None for deleted rows — callers
        pairing with .shp records rely on index alignment."""
        pos = self.header_size
        for _ in range(self.n_records):
            rec = self.data[pos : pos + self.record_size]
            pos += self.record_size
            if not rec or rec[0:1] == b"*":  # deleted record
                yield None
                continue
            values = {}
            off = 1
            for name, type_char, length, decimals in self.fields:
                raw = rec[off : off + length]
                off += length
                values[name] = self._convert(raw, type_char, decimals)
            yield values

    def _convert(self, raw, type_char, decimals):
        text = raw.decode(self.encoding, "replace").strip()
        if type_char in ("C", "M"):
            return text or None
        if not text or set(text) == {"*"}:
            return None
        if type_char == "N":
            try:
                return int(text) if decimals == 0 else text
            except ValueError:
                return None
        if type_char == "F":
            try:
                return float(text)
            except ValueError:
                return None
        if type_char == "L":
            if text in ("Y", "y", "T", "t"):
                return True
            if text in ("N", "n", "F", "f"):
                return False
            return None
        if type_char == "D":
            try:
                return datetime.date(
                    int(text[:4]), int(text[4:6]), int(text[6:8])
                ).isoformat()
            except ValueError:
                return None
        return text


class ShapefileImportSource(ImportSource):
    """One .shp (+.dbf/.prj) -> one dataset with an explicit FID pk."""

    GEOM_COLUMN = "geom"
    FID_COLUMN = "FID"

    def __init__(self, path, dest_path=None, schema_id_seed=None):
        if not os.path.exists(path):
            raise ImportSourceError(f"No such file: {path}")
        self.path = path
        # the seed for stable column ids: callers extracting to a temp dir
        # (zip import) pass the original spec so re-opens of the same source
        # produce the same schema ids
        self.schema_id_seed = schema_id_seed or path
        base, _ = os.path.splitext(path)
        self.dest_path = dest_path or os.path.basename(base)
        self.shp = ShpReader(path)
        dbf_path = self._sibling(base, ".dbf")
        self.dbf = DbfReader(dbf_path) if dbf_path else None
        prj_path = self._sibling(base, ".prj")
        self.crs_wkt = None
        if prj_path:
            with open(prj_path, "r", encoding="utf-8", errors="replace") as f:
                self.crs_wkt = f.read().strip() or None
        self._schema = self._build_schema()

    @staticmethod
    def _sibling(base, ext):
        for candidate in (base + ext, base + ext.upper()):
            if os.path.exists(candidate):
                return candidate
        return None

    def _crs_identifier(self):
        if not self.crs_wkt:
            return None
        from kart_tpu_torch.crs import get_identifier_str

        try:
            return get_identifier_str(self.crs_wkt)
        except Exception:
            return None

    def _build_schema(self):
        cols = [
            ColumnSchema(
                ColumnSchema.deterministic_id(self.schema_id_seed, self.FID_COLUMN),
                self.FID_COLUMN,
                "integer",
                0,
                {"size": 64},
            )
        ]
        geom_extra = {"geometryType": self.shp.geometry_type_name()}
        ident = self._crs_identifier()
        if ident:
            geom_extra["geometryCRS"] = ident
        cols.append(
            ColumnSchema(
                ColumnSchema.deterministic_id(self.schema_id_seed, self.GEOM_COLUMN),
                self.GEOM_COLUMN,
                "geometry",
                None,
                geom_extra,
            )
        )
        for name, data_type, extra in (
            self.dbf.v2_columns() if self.dbf else []
        ):
            cols.append(
                ColumnSchema(
                    ColumnSchema.deterministic_id(self.schema_id_seed, name),
                    name,
                    data_type,
                    None,
                    extra,
                )
            )
        return Schema(cols)

    @property
    def schema(self):
        return self._schema

    def crs_definitions(self):
        ident = self._crs_identifier()
        if ident and self.crs_wkt:
            return {ident: self.crs_wkt}
        return {}

    def meta_items(self):
        return {}

    @property
    def feature_count(self):
        if self.dbf is not None:
            return sum(1 for rec in self.dbf.records() if rec is not None)
        return sum(1 for _ in self.shp)

    def features(self):
        shp_iter = iter(self.shp)
        if self.dbf is None:
            for rec_no, value in shp_iter:
                yield self._feature(rec_no, value, {})
            return
        # pair by physical record index; a deleted DBF row tombstones the
        # whole feature (matching OGR's SHP driver)
        for (rec_no, value), attrs in zip(shp_iter, self.dbf.records()):
            if attrs is None:
                continue
            yield self._feature(rec_no, value, attrs)

    def _feature(self, rec_no, value, attrs):
        feature = {self.FID_COLUMN: rec_no}
        if value is None:
            feature[self.GEOM_COLUMN] = None
        else:
            feature[self.GEOM_COLUMN] = Geometry.from_wkb(
                write_wkb(value)
            ).normalised()
        for col in self._schema.columns[2:]:
            feature[col.name] = attrs.get(col.name)
        return feature
