"""Import sources: a table to import, with its schema, meta items, CRS
definitions and a stream of features.

GeoPackages are read with stdlib ``sqlite3``, GeoJSON (a FeatureCollection
or a GeoJSONSeq file) and CSV with the stdlib parsers; Shapefiles (``.shp``,
or a ``.zip`` holding one) by :mod:`.shapefile`, FlatGeobuf by
:mod:`.flatgeobuf`, and PostgreSQL, MySQL and SQL Server tables by
:mod:`.postgres`, :mod:`.mysql` and :mod:`.sqlserver` over their DBAPI
drivers, imported only when they connect.

Counterpart of kart_tpu's ``importer/__init__.py``: ``ImportSourceError``,
``ImportSource`` (``open``, ``with_primary_key``, ``get_features``),
``GPKGImportSource``, ``GeoJSONImportSource``, ``GeoJSONSeqImportSource``
and ``CSVImportSource``, each the same schema, column ids and features as
kart_tpu's, with ``feature_count`` for the importer's router. An int-pk
GPKG also streams encoded batches: ``encoded_feature_batches`` and
``batch_row_encoder`` in Python, ``native_encoded_batches`` through the
port's native IO core (the fused read and encode of the import pipeline),
all with the blobs of the per-feature route.
"""

import csv
import json
import os
import sqlite3
import time

from kart_tpu_torch.adapters import gpkg as gpkg_adapter
from kart_tpu_torch.core.serialise import msg_pack
from kart_tpu_torch.crs import get_identifier_str, make_crs
from kart_tpu_torch.geometry import Geometry, geojson_to_geometry
from kart_tpu_torch.models.schema import ColumnSchema, Schema

#: rows a GPKG cursor fetches at once
FETCH_ROWS = 10000


class ImportSourceError(ValueError):
    pass


class ImportSource:
    """A table to import: schema, streamed features and meta items, to the
    dataset path ``dest_path``."""

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def features(self):
        raise NotImplementedError

    @property
    def feature_count(self):
        """The number of features, which the importer's router reads."""
        return sum(1 for _ in self.features())

    def get_features(self, pks, ignore_missing=False):
        """The features with the given (single-column) pks, in no set order:
        one scan of :meth:`features` unless a source reads by pk."""
        wanted = set(pks)
        if not wanted:
            return
        pk_col = self.schema.pk_columns[0].name
        found = set()
        for feature in self.features():
            pk = feature.get(pk_col)
            if pk in wanted:
                found.add(pk)
                yield feature
        if not ignore_missing and found != wanted:
            missing = sorted(wanted - found, key=str)[:5]
            raise ImportSourceError(f"Source has no feature(s) with id: {missing}")

    def meta_items(self):
        """{'title': ..., 'description': ...}"""
        return {}

    def post_import_meta_items(self):
        """Meta items known only once :meth:`features` has run (a generated
        pk's state)."""
        return {}

    def crs_definitions(self):
        """{identifier: wkt}"""
        return {}

    def with_primary_key(self, pk_name):
        """This source with ``pk_name`` as its primary key (``kart import
        --primary-key``); the former pk column stays as data."""
        cols = list(self.schema.columns)
        if pk_name not in {c.name for c in cols}:
            raise ImportSourceError(
                f"--primary-key: no column named {pk_name!r} in {self.dest_path!r} "
                f"(columns: {', '.join(c.name for c in cols)})")
        if [c.name for c in self.schema.pk_columns] == [pk_name]:
            return self

        def extra_for(c):
            extra = dict(c.extra_type_info or {})
            if c.name == pk_name and c.data_type == "integer":
                # an integer pk is 64-bit everywhere, as the working copy reads it
                extra["size"] = 64
            return extra

        new_cols = [ColumnSchema(c.id, c.name, c.data_type, 0 if c.name == pk_name else None,
                                 extra_for(c)) for c in cols]
        new_cols.sort(key=lambda c: (c.pk_index is None,))  # the pk first
        return _PrimaryKeyOverrideSource(self, Schema(new_cols))

    @classmethod
    def open(cls, spec, table=None):
        """A path or URL -> [ImportSource], one a table."""
        lowered = spec.lower()
        if lowered.endswith(".gpkg"):
            return GPKGImportSource.open_all(spec, table=table)
        if lowered.endswith((".geojsonl", ".ndjson", ".geojsons")):
            return [GeoJSONSeqImportSource(spec)]
        if lowered.endswith((".geojson", ".json")):
            return [GeoJSONImportSource(spec)]
        if lowered.endswith(".csv"):
            return [CSVImportSource(spec)]
        if lowered.endswith(".shp"):
            from kart_tpu_torch.importer.shapefile import ShapefileImportSource

            return [ShapefileImportSource(spec)]
        if lowered.endswith(".fgb"):
            from kart_tpu_torch.importer.flatgeobuf import FlatGeobufImportSource

            return [FlatGeobufImportSource(spec)]
        if lowered.endswith(".zip"):
            return [_open_zipped_shapefile(spec)]
        if spec.startswith(("postgresql://", "postgres://")):
            from kart_tpu_torch.importer.postgres import PostgresImportSource

            return PostgresImportSource.open_all(spec, table=table)
        if spec.startswith("mysql://"):
            from kart_tpu_torch.importer.mysql import MySqlImportSource

            return MySqlImportSource.open_all(spec, table=table)
        if spec.startswith(("mssql://", "sqlserver://")):
            from kart_tpu_torch.importer.sqlserver import SqlServerImportSource

            return SqlServerImportSource.open_all(spec, table=table)
        raise ImportSourceError(
            f"Don't know how to import {spec!r} — supported: .gpkg, .shp, "
            f".zip (shapefile), .fgb, .geojson, .geojsonl/.ndjson, .csv, "
            f"postgresql://, mysql://, mssql://")


class _PrimaryKeyOverrideSource(ImportSource):
    """:meth:`ImportSource.with_primary_key`'s result: the same features
    under a re-keyed schema."""

    def __init__(self, inner, schema):
        self.inner = inner
        self._schema = schema
        self.dest_path = inner.dest_path

    @property
    def schema(self) -> Schema:
        return self._schema

    def features(self):
        return self.inner.features()

    @property
    def feature_count(self):
        return self.inner.feature_count

    def meta_items(self):
        return self.inner.meta_items()

    def post_import_meta_items(self):
        return self.inner.post_import_meta_items()

    def crs_definitions(self):
        return self.inner.crs_definitions()


def _open_zipped_shapefile(spec):
    """A ``.zip`` holding exactly one Shapefile (``__MACOSX/`` entries aside,
    in any folder): its files are extracted to a temporary directory that
    lives, and is removed, with the source. Column ids come from the
    archive's path and the member's name, not the temporary path."""
    import tempfile
    import zipfile

    from kart_tpu_torch.importer.shapefile import ShapefileImportSource

    try:
        zf = zipfile.ZipFile(spec)
    except (OSError, zipfile.BadZipFile) as e:
        raise ImportSourceError(f"Cannot read {spec!r}: {e}")
    with zf:
        shp_names = [n for n in zf.namelist()
                     if n.lower().endswith(".shp") and not n.startswith("__MACOSX")]
        if len(shp_names) != 1:
            raise ImportSourceError(
                f"{spec!r} must contain exactly one .shp (found {len(shp_names)})")
        stem = os.path.splitext(shp_names[0])[0]
        tmp = tempfile.TemporaryDirectory(prefix="kart-zip-import-")
        extracted_shp = None
        for name in zf.namelist():
            base, ext = os.path.splitext(name)
            if base != stem or name.endswith("/"):
                continue
            # flattened into the temporary root: no member path escapes it
            target = os.path.join(tmp.name, os.path.basename(name))
            with zf.open(name) as src, open(target, "wb") as dst:
                dst.write(src.read())
            if ext.lower() == ".shp":
                extracted_shp = target
    source = ShapefileImportSource(extracted_shp, schema_id_seed=f"{spec}!{shp_names[0]}")
    source.dest_path = os.path.splitext(os.path.basename(spec))[0]
    source._tmpdir = tmp  # the extraction lives as long as the source
    return source


class GPKGImportSource(ImportSource):
    def __init__(self, gpkg_path, table_name, dest_path=None):
        if not os.path.exists(gpkg_path):
            raise ImportSourceError(f"No such file: {gpkg_path}")
        self.gpkg_path = gpkg_path
        self.table_name = table_name
        self.dest_path = dest_path or table_name
        self._schema = None
        self._crs_defs = None

    @classmethod
    def open_all(cls, gpkg_path, table=None):
        con = sqlite3.connect(gpkg_path)
        try:
            tables = [row[0] for row in con.execute(
                "SELECT table_name FROM gpkg_contents "
                "WHERE data_type IN ('features', 'attributes') ORDER BY table_name")]
        except sqlite3.OperationalError:
            raise ImportSourceError(f"{gpkg_path} is not a GeoPackage")
        finally:
            con.close()
        if table is not None:
            if table not in tables:
                raise ImportSourceError(f"Table {table!r} not found in {gpkg_path}; has: {tables}")
            tables = [table]
        return [cls(gpkg_path, t) for t in tables]

    def _connect(self):
        con = sqlite3.connect(self.gpkg_path)
        con.row_factory = sqlite3.Row
        return con

    def _geom_info(self, con):
        try:
            row = con.execute("SELECT column_name, geometry_type_name, srs_id, z, m "
                              "FROM gpkg_geometry_columns WHERE table_name = ?",
                              (self.table_name,)).fetchone()
        except sqlite3.OperationalError:
            return None
        return dict(row) if row else None

    def _load_schema(self):
        con = self._connect()
        try:
            geom_info = self._geom_info(con)
            crs_identifier = None
            crs_defs = {}
            if geom_info and geom_info["srs_id"] is not None:
                srs = con.execute("SELECT * FROM gpkg_spatial_ref_sys WHERE srs_id = ?",
                                  (geom_info["srs_id"],)).fetchone()
                if srs is not None and srs["srs_id"] > 0:
                    wkt = srs["definition"]
                    crs_identifier = (
                        f"{srs['organization'].upper()}:{srs['organization_coordsys_id']}"
                        if srs["organization"] else get_identifier_str(wkt))
                    crs_defs[crs_identifier] = wkt
            cols = []
            for row in con.execute(f"PRAGMA table_info({gpkg_adapter.quote(self.table_name)})"):
                name = row["name"]
                is_geom = geom_info is not None and name == geom_info["column_name"]
                data_type, extra = gpkg_adapter.sqlite_type_to_v2(
                    row["type"],
                    geom_info={**geom_info, "crs_identifier": crs_identifier} if is_geom
                    else None)
                # table_info's pk is the 1-based pk ordinal (0: not a pk)
                pk_index = row["pk"] - 1 if row["pk"] > 0 else None
                if pk_index is not None and data_type == "integer":
                    extra = {**extra, "size": 64}
                cols.append(ColumnSchema(
                    ColumnSchema.deterministic_id(self.gpkg_path, self.table_name, name),
                    name, data_type, pk_index, extra))
            self._schema = Schema(cols)
            self._crs_defs = crs_defs
        finally:
            con.close()

    @property
    def schema(self):
        if self._schema is None:
            self._load_schema()
        return self._schema

    def crs_definitions(self):
        if self._crs_defs is None:
            self._load_schema()
        return self._crs_defs

    def meta_items(self):
        con = self._connect()
        try:
            out = {}
            row = con.execute("SELECT identifier, description FROM gpkg_contents "
                              "WHERE table_name = ?", (self.table_name,)).fetchone()
            if row:
                if row["identifier"]:
                    out["title"] = row["identifier"]
                if row["description"]:
                    out["description"] = row["description"]
            return out
        finally:
            con.close()

    @staticmethod
    def _feature(row, cols):
        return {col.name: gpkg_adapter.value_to_v2(row[col.name], col) for col in cols}

    def features(self):
        cols = self.schema.columns
        con = self._connect()
        try:
            cursor = con.execute(f"SELECT * FROM {gpkg_adapter.quote(self.table_name)}")
            cursor.arraysize = FETCH_ROWS
            while True:
                rows = cursor.fetchmany()
                if not rows:
                    break
                for row in rows:
                    yield self._feature(row, cols)
        finally:
            con.close()

    @property
    def feature_count(self):
        con = self._connect()
        try:
            return con.execute(
                f"SELECT COUNT(*) FROM {gpkg_adapter.quote(self.table_name)}").fetchone()[0]
        finally:
            con.close()

    def encoded_feature_batches(self, schema):
        """The serial route's batches of an int-pk table: ``(pk_list,
        blob_list)`` with the blobs :meth:`batch_row_encoder` makes, which
        are ``schema.encode_feature_blob``'s over :meth:`features`; None
        for any other pk, or with ``KART_IMPORT_FAST=0``."""
        if os.environ.get("KART_IMPORT_FAST") == "0":
            return None
        pk_cols = schema.pk_columns
        if len(pk_cols) != 1 or pk_cols[0].data_type != "integer":
            return None
        return self._encoded_batch_gen(schema)

    def _select_sql(self, schema, where=""):
        """The raw-row SELECT of the batch routes: schema column order, in
        pk order (the int pk is the rowid, so the order costs nothing)."""
        sel = ", ".join(gpkg_adapter.quote(c.name) for c in schema.columns)
        pk = gpkg_adapter.quote(schema.pk_columns[0].name)
        return f"SELECT {sel} FROM {gpkg_adapter.quote(self.table_name)}{where} ORDER BY {pk}"

    def raw_row_batches(self, schema, batch_rows=FETCH_ROWS):
        """Batches of raw row tuples (schema column order, pk order) from
        a connection of their own, so that they can be read on another
        thread; ``check_same_thread=False`` only lets an abandoned
        generator be closed from the thread that collects it."""
        con = sqlite3.connect(self.gpkg_path, check_same_thread=False)
        try:
            cursor = con.execute(self._select_sql(schema))
            cursor.arraysize = batch_rows
            while True:
                rows = cursor.fetchmany()
                if not rows:
                    break
                yield rows
        finally:
            con.close()

    def batch_row_encoder(self, schema):
        """-> ``encode(rows) -> (pk_list, blob_list)`` over raw row tuples
        in schema column order: each blob is ``schema.encode_feature_blob``
        of the row's feature, byte for byte (a cell becomes the value
        :meth:`features` gives, then the legend's non-pk values are
        packed)."""
        cols = list(schema.columns)
        by_id = {c.id: j for j, c in enumerate(cols)}
        non_pk = [(by_id[cid], cols[by_id[cid]]) for cid in schema.legend.non_pk_columns]
        pk_j = by_id[schema.legend.pk_columns[0]]
        legend_hash = schema.legend_hash
        value_to_v2 = gpkg_adapter.value_to_v2

        def encode(rows):
            pks, blobs = [], []
            for row in rows:
                values = tuple(value_to_v2(row[j], col) for j, col in non_pk)
                pks.append(row[pk_j])
                blobs.append(msg_pack([legend_hash, values]))
            return pks, blobs

        return encode

    def _encoded_batch_gen(self, schema):
        # the read and encode seconds, which the import's phase split reads
        encode = self.batch_row_encoder(schema)
        phases = self.phase_seconds = {"source_read": 0.0, "encode": 0.0}
        batches = self.raw_row_batches(schema)
        while True:
            t0 = time.perf_counter()
            rows = next(batches, None)
            phases["source_read"] += time.perf_counter() - t0
            if rows is None:
                break
            t0 = time.perf_counter()
            out = encode(rows)
            phases["encode"] += time.perf_counter() - t0
            yield out

    def native_encoded_batches(self, schema, batch_rows=FETCH_ROWS):
        """The pipeline's fused read + encode producer: a generator of
        ``("enc", pks int64, buf uint8, offsets int64)`` batches, blob i
        ``buf[offsets[i]:offsets[i+1]]``, each batch one native call that
        steps the SELECT and encodes its rows without the GIL
        (``native.open_gpkg_reader``), byte for byte
        :meth:`batch_row_encoder`'s blobs. None for a table that is not
        single-int-pk, or with ``KART_IMPORT_NATIVE_READ=0`` or
        ``KART_IMPORT_FAST=0``. A row the native encoder cannot take raises
        :class:`~kart_tpu_torch.native.GpkgReaderFallback` out of the
        generator, and the pipeline restarts through Python."""
        from kart_tpu_torch import native
        from kart_tpu_torch.core.serialise import GEOMETRY_EXT_CODE

        if os.environ.get("KART_IMPORT_NATIVE_READ") == "0":
            return None
        if os.environ.get("KART_IMPORT_FAST") == "0":
            return None
        pk_cols = schema.pk_columns
        if len(pk_cols) != 1 or pk_cols[0].data_type != "integer":
            return None
        kind_of = {"geometry": 1, "boolean": 2, "float": 3, "timestamp": 4}
        cols = list(schema.columns)
        by_id = {c.id: j for j, c in enumerate(cols)}
        legend = schema.legend
        val_cols = [by_id[cid] for cid in legend.non_pk_columns]
        kinds = [kind_of.get(cols[j].data_type, 0) for j in val_cols]
        # the blob's head: [legend hash, [n values...]] without the values
        # (each None packs as one byte)
        n = len(val_cols)
        prefix = msg_pack([schema.legend_hash, [None] * n])
        prefix = prefix[: len(prefix) - n]
        reader = native.open_gpkg_reader(self.gpkg_path, self._select_sql(schema), val_cols,
                                         kinds, by_id[legend.pk_columns[0]], prefix,
                                         GEOMETRY_EXT_CODE)

        def gen():
            phases = self.phase_seconds = {"source_read": 0.0, "encode": 0.0}
            try:
                while True:
                    t0 = time.perf_counter()
                    out = reader.next_batch(batch_rows)
                    phases["source_read"] += time.perf_counter() - t0
                    if out is None:
                        return
                    yield ("enc",) + out
            finally:
                reader.close()

        return gen()

    def get_features(self, pks, ignore_missing=False):
        """Point reads by pk (an indexed lookup, not a table scan)."""
        cols = self.schema.columns
        pk_col = self.schema.pk_columns[0].name
        con = self._connect()
        try:
            for pk in pks:
                row = con.execute(
                    f"SELECT * FROM {gpkg_adapter.quote(self.table_name)} "
                    f"WHERE {gpkg_adapter.quote(pk_col)} = ?", (pk,)).fetchone()
                if row is None:
                    if ignore_missing:
                        continue
                    raise ImportSourceError(f"Source has no feature with id: {pk!r}")
                yield self._feature(row, cols)
        finally:
            con.close()


def _crs_definitions(schema, crs):
    if any(c.data_type == "geometry" for c in schema.columns):
        try:
            return {crs: make_crs(crs).wkt}
        except Exception:
            return {}
    return {}


class GeoJSONImportSource(ImportSource):
    """A GeoJSON FeatureCollection. The properties' values make the schema;
    an integer ``id`` or ``fid`` property is the pk, else the importer
    generates one."""

    def __init__(self, path, dest_path=None, crs="EPSG:4326"):
        if not os.path.exists(path):
            raise ImportSourceError(f"No such file: {path}")
        self.path = path
        self.dest_path = dest_path or os.path.splitext(os.path.basename(path))[0]
        self.crs = crs
        self._features_json = self._load_features(path)
        self._schema_cache = None

    @property
    def schema(self):
        # built on first use: the CLI may set ``crs`` after construction (--crs)
        if self._schema_cache is None:
            self._schema_cache = self._sniff_schema()
        return self._schema_cache

    @staticmethod
    def _load_features(path):
        with open(path) as f:
            doc = json.load(f)
        if doc.get("type") != "FeatureCollection":
            raise ImportSourceError(f"{path} is not a GeoJSON FeatureCollection")
        return doc.get("features", [])

    def _sniff_schema(self):
        prop_types = {}
        has_geom = False
        pk_name = None
        for feat in self._features_json:
            if feat.get("geometry") is not None:
                has_geom = True
            for key, value in (feat.get("properties") or {}).items():
                if value is None:
                    prop_types.setdefault(key, None)
                    continue
                t = {bool: "boolean", int: "integer", float: "float", str: "text"}.get(
                    type(value), "text")
                prev = prop_types.get(key)
                if prev in (None, "integer") and t == "float":
                    prop_types[key] = "float"
                elif prev is None or prev == t:
                    prop_types[key] = t
                elif {prev, t} == {"integer", "float"}:
                    prop_types[key] = "float"
                else:
                    prop_types[key] = "text"
        for candidate in ("id", "fid"):
            if prop_types.get(candidate) == "integer":
                pk_name = candidate
                break
        cols = []
        for name, t in prop_types.items():
            cols.append(ColumnSchema(
                ColumnSchema.deterministic_id(self.path, name), name, t or "text",
                0 if name == pk_name else None,
                # JSON numbers are 64-bit, as the working copy reads them back
                {"size": 64} if (t or "text") in ("integer", "float") else {}))
        if has_geom:
            cols.append(ColumnSchema(
                ColumnSchema.deterministic_id(self.path, "__geom__"), "geom", "geometry", None,
                {"geometryType": "GEOMETRY", "geometryCRS": self.crs}))
        cols.sort(key=lambda c: 0 if c.pk_index is not None else 1)  # the pk first
        return Schema(cols)

    def crs_definitions(self):
        return _crs_definitions(self.schema, self.crs)

    @property
    def feature_count(self):
        return len(self._features_json)

    def features(self):
        for feat in self._features_json:
            props = feat.get("properties") or {}
            out = {}
            for col in self.schema.columns:
                if col.name == "geom" and col.data_type == "geometry":
                    geom = feat.get("geometry")
                    out["geom"] = geojson_to_geometry(geom) if geom else None
                else:
                    value = props.get(col.name)
                    if col.data_type == "float" and isinstance(value, int):
                        value = float(value)
                    out[col.name] = value
            yield out


class GeoJSONSeqImportSource(GeoJSONImportSource):
    """Newline-delimited GeoJSON (``.geojsonl``, ``.ndjson``, GeoJSONSeq,
    RFC 8142 records too): one Feature a line or record."""

    @staticmethod
    def _load_features(path):
        with open(path) as f:
            text = f.read()
        if "\x1e" in text:
            # RFC 8142: RS-delimited records, each of which may span lines
            records = [(i, chunk) for i, chunk in enumerate(text.split("\x1e"), 0)
                       if chunk.strip()]
            label = "record"
        else:
            records = [(i, line) for i, line in enumerate(text.splitlines(), 1)
                       if line.strip()]
            label = "line"
        features = []
        for no, chunk in records:
            try:
                obj = json.loads(chunk)
            except ValueError as e:
                raise ImportSourceError(f"{path}:{no}: not a GeoJSON Feature {label}: {e}")
            if obj.get("type") == "FeatureCollection":
                features.extend(obj.get("features", []))
            elif obj.get("type") == "Feature":
                features.append(obj)
            else:
                raise ImportSourceError(
                    f"{path}:{no}: expected a Feature, got {obj.get('type')!r}")
        return features


class CSVImportSource(ImportSource):
    """A CSV with a header row. A column is integer, float, WKT geometry
    (EPSG:4326 unless ``--crs``) or text, as all its values parse; an
    integer ``id``, ``fid`` or first column is the pk."""

    _WKT_PREFIXES = ("POINT", "LINESTRING", "POLYGON", "MULTIPOINT", "MULTILINESTRING",
                     "MULTIPOLYGON", "GEOMETRYCOLLECTION")

    def __init__(self, path, dest_path=None, crs="EPSG:4326"):
        if not os.path.exists(path):
            raise ImportSourceError(f"No such file: {path}")
        self.path = path
        self.crs = crs
        self.dest_path = dest_path or os.path.splitext(os.path.basename(path))[0]
        with open(path, newline="") as f:
            reader = csv.reader(f)
            self.header = next(reader)
            self.rows = list(reader)
        self._schema_cache = None

    def crs_definitions(self):
        return _crs_definitions(self.schema, self.crs)

    @classmethod
    def _sniff_type(cls, values):
        saw_float = saw_number = saw_wkt = False
        wkt_checked = 0
        for v in values:
            if v == "":
                continue
            if v.lstrip().upper().startswith(cls._WKT_PREFIXES):
                if wkt_checked < 100:  # a sample: features() parses them all
                    try:
                        Geometry.from_wkt(v)
                    except Exception:
                        return "text"
                    wkt_checked += 1
                saw_wkt = True
                continue
            try:
                int(v)
                saw_number = True
            except ValueError:
                try:
                    float(v)
                    saw_number = saw_float = True
                except ValueError:
                    return "text"
        if saw_wkt:
            # a geometry column is all geometries or it is text
            return "text" if saw_number else "geometry"
        return "float" if saw_float else "integer"

    def _sniff_schema(self):
        types = {name: self._sniff_type([r[i] for r in self.rows if i < len(r)])
                 for i, name in enumerate(self.header)}
        pk_name = None
        for candidate in ("id", "fid", self.header[0]):
            if types.get(candidate) == "integer":
                pk_name = candidate
                break
        cols = []
        for name in self.header:
            t = types[name]
            if t == "geometry":
                extra = {"geometryType": "GEOMETRY", "geometryCRS": self.crs}
            elif t in ("integer", "float"):
                extra = {"size": 64}
            else:
                extra = {}
            cols.append(ColumnSchema(ColumnSchema.deterministic_id(self.path, name), name, t,
                                     0 if name == pk_name else None, extra))
        cols.sort(key=lambda c: 0 if c.pk_index is not None else 1)
        return Schema(cols)

    @property
    def schema(self):
        # built on first use: the CLI may set ``crs`` after construction (--crs)
        if self._schema_cache is None:
            self._schema_cache = self._sniff_schema()
        return self._schema_cache

    @property
    def feature_count(self):
        return len(self.rows)

    def features(self):
        # values in the header's order, not the pk-first schema order
        cols_by_name = {c.name: c for c in self.schema.columns}
        for row in self.rows:
            out = {}
            for j, name in enumerate(self.header):
                col = cols_by_name[name]
                raw = row[j] if j < len(row) else ""
                if raw == "":
                    out[name] = None
                elif col.data_type == "integer":
                    out[name] = int(raw)
                elif col.data_type == "float":
                    out[name] = float(raw)
                elif col.data_type == "geometry":
                    out[name] = Geometry.from_wkt(raw)
                else:
                    out[name] = raw
            yield out
