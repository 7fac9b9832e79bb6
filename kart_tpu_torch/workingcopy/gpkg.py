"""The GeoPackage working copy, over stdlib ``sqlite3``.

A working copy is a derived cache of one commit's datasets as GPKG tables.
Edits are tracked by triggers: each insert, update or delete of a user
table records the row's pk in ``gpkg_kart_track``, and ``gpkg_kart_state``
holds the tree the copy was written from, so ``status``, ``diff`` and
``commit`` read only the tracked rows, never a whole table. The rtree
spatial index of the GPKG spec and its six triggers are kept in step, with
the envelope functions its triggers call registered on every connection
(:func:`_register_gpkg_functions`).

``reset`` moves the copy to another commit: with ``force`` it rewrites every
table, without it it diffs the copy's tree against the target's through
:func:`kart_tpu_torch.diff.engine.get_dataset_diff` on the working copy's
device (kernel K1 on the card, the host floor with ``device="cpu"``), and
writes only the changed rows, keeping the user's edits to the others.

Counterpart of kart_tpu's ``workingcopy/gpkg.py``.
"""

import contextlib
import os
import sqlite3

from kart_tpu_torch.adapters import gpkg as adapter
from kart_tpu_torch.core.odb import ObjectPromised
from kart_tpu_torch.core.repo import InvalidOperation, NotFound
from kart_tpu_torch.crs import get_identifier_int, get_identifier_str
from kart_tpu_torch.diff.structs import WORKING_COPY_EDIT, DatasetDiff, Delta, DeltaDiff, KeyValue
from kart_tpu_torch.geometry import Geometry
from kart_tpu_torch.models.schema import ColumnSchema, Schema
from kart_tpu_torch.workingcopy import (
    Mismatch,
    WorkingCopyStatus,
    can_find_renames,
    checkout_features,
    find_renames,
)

STATE_TABLE = "gpkg_kart_state"
TRACK_TABLE = "gpkg_kart_track"

_GPKG_BASE_DDL = """
CREATE TABLE IF NOT EXISTS gpkg_contents (
    table_name TEXT NOT NULL PRIMARY KEY, data_type TEXT NOT NULL,
    identifier TEXT UNIQUE, description TEXT DEFAULT '',
    last_change DATETIME NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%fZ','now')),
    min_x DOUBLE, min_y DOUBLE, max_x DOUBLE, max_y DOUBLE, srs_id INTEGER);
CREATE TABLE IF NOT EXISTS gpkg_geometry_columns (
    table_name TEXT NOT NULL, column_name TEXT NOT NULL,
    geometry_type_name TEXT NOT NULL, srs_id INTEGER NOT NULL,
    z TINYINT NOT NULL, m TINYINT NOT NULL,
    CONSTRAINT pk_geom_cols PRIMARY KEY (table_name, column_name));
CREATE TABLE IF NOT EXISTS gpkg_spatial_ref_sys (
    srs_name TEXT NOT NULL, srs_id INTEGER NOT NULL PRIMARY KEY,
    organization TEXT NOT NULL, organization_coordsys_id INTEGER NOT NULL,
    definition TEXT NOT NULL, description TEXT);
CREATE TABLE IF NOT EXISTS gpkg_kart_state (
    table_name TEXT NOT NULL, key TEXT NOT NULL, value TEXT NULL,
    CONSTRAINT _kart_state_pk PRIMARY KEY (table_name, key));
CREATE TABLE IF NOT EXISTS gpkg_kart_track (
    table_name TEXT NOT NULL, pk TEXT NULL,
    CONSTRAINT _kart_track_pk PRIMARY KEY (table_name, pk));
"""

_DEFAULT_SRS = [
    ("Undefined cartesian SRS", -1, "NONE", -1, "undefined", None),
    ("Undefined geographic SRS", 0, "NONE", 0, "undefined", None),
]

#: rows a bulk checkout inserts a statement
INSERT_BATCH = 10000
#: tracked pks read a query
TRACKED_CHUNK = 500


def _geom_envelope(value, _memo=None):
    """A GPKG blob -> (minx, maxx, miny, maxy), or None for NULL, empty or
    garbage. ``_memo`` is a connection's one-slot [blob, envelope] cache:
    the rtree triggers ask four bounds of the same blob in a row."""
    if value is None:
        return None
    b = bytes(value)
    if _memo is not None and _memo[0] == b:
        return _memo[1]
    try:
        env = Geometry.of(b).envelope()
    except Exception:
        env = None
    if _memo is not None:
        _memo[0] = b
        _memo[1] = env
    return env


def _register_gpkg_functions(con):
    """Register the ST_IsEmpty/ST_MinX/ST_MaxX/ST_MinY/ST_MaxY functions the
    GPKG rtree triggers call (other clients get them from spatialite or
    GDAL) on ``con``."""
    memo = [None, None]  # one connection runs one statement at a time

    def st_is_empty(value):
        return 1 if _geom_envelope(value, memo) is None else 0

    def bound(i):
        def f(value):
            env = _geom_envelope(value, memo)
            return env[i] if env is not None else None

        return f

    con.create_function("ST_IsEmpty", 1, st_is_empty, deterministic=True)
    con.create_function("ST_MinX", 1, bound(0), deterministic=True)
    con.create_function("ST_MaxX", 1, bound(1), deterministic=True)
    con.create_function("ST_MinY", 1, bound(2), deterministic=True)
    con.create_function("ST_MaxY", 1, bound(3), deterministic=True)


def _trigger(table, suffix):
    return adapter.quote(f"trigger_kart_{table}_{suffix}")


class GpkgWorkingCopy:
    """The GPKG working copy at ``location`` (relative to the workdir).
    ``device`` is where a non-force :meth:`reset` classifies (None: the
    card)."""

    def __init__(self, repo, location, device=None):
        self.repo = repo
        self.device = device
        # {ds_path: [pks]}: inserted rows whose pk an out-of-filter feature has
        self.spatial_filter_pk_conflicts = {}
        self.location = str(location)
        if os.path.isabs(self.location) or repo.workdir is None:
            self.full_path = self.location
        else:
            self.full_path = os.path.join(repo.workdir, self.location)

    def __str__(self):
        return self.location

    # -- connection ----------------------------------------------------------

    @contextlib.contextmanager
    def session(self):
        con = sqlite3.connect(self.full_path)
        con.row_factory = sqlite3.Row
        _register_gpkg_functions(con)
        con.execute("PRAGMA foreign_keys = OFF;")
        try:
            con.execute("BEGIN")
            yield con
            con.commit()
        except Exception:
            con.rollback()
            raise
        finally:
            con.close()

    # -- status / state ------------------------------------------------------

    def status(self):
        if not os.path.exists(self.full_path):
            return WorkingCopyStatus.NON_EXISTENT
        result = WorkingCopyStatus.CREATED
        try:
            with self.session() as con:
                if con.execute("SELECT count(*) FROM sqlite_master WHERE name = ?",
                               (STATE_TABLE,)).fetchone()[0]:
                    result |= WorkingCopyStatus.INITIALISED
        except sqlite3.DatabaseError:
            result |= WorkingCopyStatus.UNCONNECTABLE
        return result

    def create_and_initialise(self):
        os.makedirs(os.path.dirname(self.full_path) or ".", exist_ok=True)
        with self.session() as con:
            con.executescript(_GPKG_BASE_DDL)
            for row in _DEFAULT_SRS:
                con.execute("INSERT OR IGNORE INTO gpkg_spatial_ref_sys VALUES (?,?,?,?,?,?)",
                            row)

    def delete(self):
        if os.path.exists(self.full_path):
            os.remove(self.full_path)

    def get_db_tree(self):
        with self.session() as con:
            try:
                row = con.execute(f"SELECT value FROM {STATE_TABLE} "
                                  f"WHERE table_name = '*' AND key = 'tree'").fetchone()
            except sqlite3.OperationalError:
                return None
            return row[0] if row else None

    def assert_db_tree_match(self, expected_tree_oid):
        wc_tree = self.get_db_tree()
        expected = getattr(expected_tree_oid, "oid", expected_tree_oid)
        if wc_tree != expected:
            raise Mismatch(wc_tree, expected)

    @staticmethod
    def _update_state_tree(con, tree_oid):
        con.execute(f"INSERT OR REPLACE INTO {STATE_TABLE} (table_name, key, value) "
                    f"VALUES ('*', 'tree', ?)", (tree_oid,))

    # -- table naming --------------------------------------------------------

    @staticmethod
    def _table_name(ds_path):
        """A dataset path -> its GPKG table name (slashes become ``__``)."""
        return ds_path.replace("/", "__")

    # -- checkout (write_full) ----------------------------------------------

    def write_full(self, target_structure, *datasets):
        """Write ``datasets`` whole and record the target's tree."""
        if not (self.status() & WorkingCopyStatus.INITIALISED):
            self.create_and_initialise()
        with self.session() as con:
            for ds in datasets:
                self._write_one_dataset(con, ds)
            self._update_state_tree(con, target_structure.tree_oid)

    def _write_one_dataset(self, con, ds):
        table = self._table_name(ds.path)
        schema = ds.schema
        crs_id = 0
        geom_col = schema.first_geometry_column
        crs_defs = {ident: ds.get_crs_definition(ident) for ident in ds.crs_identifiers()}
        if geom_col is not None and crs_defs:
            crs_id = get_identifier_int(next(iter(crs_defs.values())))
        for ident, wkt in crs_defs.items():
            srs_id = get_identifier_int(wkt)
            org, _, code = ident.partition(":")
            con.execute(
                "INSERT OR REPLACE INTO gpkg_spatial_ref_sys "
                "(srs_name, srs_id, organization, organization_coordsys_id, definition) "
                "VALUES (?,?,?,?,?)",
                (ident, srs_id, org or "NONE", int(code) if code.isdigit() else srs_id, wkt))

        con.execute(f"DROP TABLE IF EXISTS {adapter.quote(table)}")
        self._drop_spatial_index(con, table)
        con.execute(f"CREATE TABLE {adapter.quote(table)} "
                    f"({adapter.v2_schema_to_sql_spec(schema)})")

        title = ds.get_meta_item("title") or table
        description = ds.get_meta_item("description") or ""
        data_type = "features" if geom_col is not None else "attributes"
        con.execute(
            "INSERT OR REPLACE INTO gpkg_contents "
            "(table_name, data_type, identifier, description, srs_id) VALUES (?,?,?,?,?)",
            (table, data_type, title, description, crs_id if geom_col is not None else None))
        if geom_col is not None:
            gtype = geom_col.extra_type_info.get("geometryType", "GEOMETRY").split(" ")
            has_z = 1 if "Z" in gtype[1:] or "ZM" in gtype[1:] else 0
            has_m = 1 if "M" in gtype[1:] or "ZM" in gtype[1:] else 0
            con.execute("INSERT OR REPLACE INTO gpkg_geometry_columns VALUES (?,?,?,?,?,?)",
                        (table, geom_col.name, gtype[0], crs_id, has_z, has_m))

        col_names = [c.name for c in schema.columns]
        insert_sql = (f"INSERT INTO {adapter.quote(table)} "
                      f"({','.join(adapter.quote(c) for c in col_names)}) "
                      f"VALUES ({','.join('?' for _ in col_names)})")
        batch = []
        for feature in checkout_features(self.repo, ds):
            batch.append(tuple(adapter.value_from_v2(feature[c.name], c, crs_id=crs_id)
                               for c in schema.columns))
            if len(batch) >= INSERT_BATCH:
                con.executemany(insert_sql, batch)
                batch.clear()
        if batch:
            con.executemany(insert_sql, batch)

        # the autoincrement sequence: the next insert gets an unused pk
        pk_cols = schema.pk_columns
        int_pk = len(pk_cols) == 1 and pk_cols[0].data_type == "integer"
        if int_pk:
            row = con.execute(f"SELECT MAX({adapter.quote(pk_cols[0].name)}) "
                              f"FROM {adapter.quote(table)}").fetchone()
            if row[0] is not None:
                con.execute("INSERT OR REPLACE INTO sqlite_sequence (name, seq) VALUES (?, ?)",
                            (table, row[0]))
        if geom_col is not None and int_pk:
            self._create_spatial_index(con, table, geom_col.name, pk_cols[0].name)
        self._create_triggers(con, table, schema)

    def _drop_spatial_index(self, con, table):
        """Drop the rtree index of an earlier checkout of ``table``, named
        exactly from ``gpkg_extensions`` and ``gpkg_geometry_columns`` (a
        prefix match would hit a table such as ``<table>_old``)."""
        geom_cols = set()
        if self._table_exists_in_master(con, "gpkg_extensions"):
            geom_cols.update(
                row[0] for row in con.execute(
                    "SELECT column_name FROM gpkg_extensions "
                    "WHERE table_name = ? AND extension_name = 'gpkg_rtree_index'",
                    (table,)).fetchall() if row[0])
        if self._table_exists_in_master(con, "gpkg_geometry_columns"):
            geom_cols.update(row[0] for row in con.execute(
                "SELECT column_name FROM gpkg_geometry_columns WHERE table_name = ?",
                (table,)).fetchall())
        for col in geom_cols:
            name = f"rtree_{table}_{col}"
            if self._table_exists_in_master(con, name):
                con.execute(f"DROP TABLE IF EXISTS {adapter.quote(name)}")
        if self._table_exists_in_master(con, "gpkg_extensions"):
            con.execute("DELETE FROM gpkg_extensions WHERE table_name = ? "
                        "AND extension_name = 'gpkg_rtree_index'", (table,))

    @staticmethod
    def _table_exists_in_master(con, name):
        return con.execute("SELECT 1 FROM sqlite_master WHERE name = ?",
                           (name,)).fetchone() is not None

    def _create_spatial_index(self, con, table, geom_name, pk_name):
        """The GPKG spec's ``gpkg_rtree_index`` extension: an rtree virtual
        table filled from the layer, and its six sync triggers (Annex F.3)."""
        rtree = adapter.quote(f"rtree_{table}_{geom_name}")
        qt, qg, qi = adapter.quote(table), adapter.quote(geom_name), adapter.quote(pk_name)
        con.execute(f"CREATE VIRTUAL TABLE {rtree} USING rtree(id, minx, maxx, miny, maxy)")
        con.execute(
            f"INSERT OR REPLACE INTO {rtree} "
            f"SELECT {qi}, ST_MinX({qg}), ST_MaxX({qg}), ST_MinY({qg}), ST_MaxY({qg}) "
            f"FROM {qt} WHERE {qg} NOT NULL AND NOT ST_IsEmpty({qg})")
        con.execute(
            """CREATE TABLE IF NOT EXISTS gpkg_extensions (
                table_name TEXT, column_name TEXT, extension_name TEXT NOT NULL,
                definition TEXT NOT NULL, scope TEXT NOT NULL,
                CONSTRAINT ge_tce UNIQUE (table_name, column_name, extension_name))""")
        con.execute(
            "INSERT OR REPLACE INTO gpkg_extensions VALUES "
            "(?, ?, 'gpkg_rtree_index', "
            "'http://www.geopackage.org/spec120/#extension_rtree', 'write-only')",
            (table, geom_name))

        def trig(suffix):
            return adapter.quote(f"rtree_{table}_{geom_name}_{suffix}")

        not_empty = f"(NEW.{qg} NOT NULL AND NOT ST_IsEmpty(NEW.{qg}))"
        is_empty = f"(NEW.{qg} ISNULL OR ST_IsEmpty(NEW.{qg}))"
        upsert = (f"INSERT OR REPLACE INTO {rtree} VALUES (NEW.{qi}, "
                  f"ST_MinX(NEW.{qg}), ST_MaxX(NEW.{qg}), "
                  f"ST_MinY(NEW.{qg}), ST_MaxY(NEW.{qg}));")
        con.execute(f"CREATE TRIGGER {trig('insert')} AFTER INSERT ON {qt} "
                    f"WHEN {not_empty} BEGIN {upsert} END;")
        con.execute(f"CREATE TRIGGER {trig('update1')} AFTER UPDATE OF {qg} ON {qt} "
                    f"WHEN OLD.{qi} = NEW.{qi} AND {not_empty} BEGIN {upsert} END;")
        con.execute(f"CREATE TRIGGER {trig('update2')} AFTER UPDATE OF {qg} ON {qt} "
                    f"WHEN OLD.{qi} = NEW.{qi} AND {is_empty} "
                    f"BEGIN DELETE FROM {rtree} WHERE id = OLD.{qi}; END;")
        con.execute(f"CREATE TRIGGER {trig('update3')} AFTER UPDATE ON {qt} "
                    f"WHEN OLD.{qi} != NEW.{qi} AND {not_empty} "
                    f"BEGIN DELETE FROM {rtree} WHERE id = OLD.{qi}; {upsert} END;")
        con.execute(f"CREATE TRIGGER {trig('update4')} AFTER UPDATE ON {qt} "
                    f"WHEN OLD.{qi} != NEW.{qi} AND {is_empty} "
                    f"BEGIN DELETE FROM {rtree} WHERE id IN (OLD.{qi}, NEW.{qi}); END;")
        con.execute(f"CREATE TRIGGER {trig('delete')} AFTER DELETE ON {qt} "
                    f"BEGIN DELETE FROM {rtree} WHERE id = OLD.{qi}; END;")

    def _drop_triggers(self, con, table):
        for suffix in ("ins", "upd", "del"):
            con.execute(f"DROP TRIGGER IF EXISTS {_trigger(table, suffix)}")

    def _create_triggers(self, con, table, schema):
        """The edit-tracking triggers: each changed row's pk into the track
        table."""
        pk = adapter.quote(schema.pk_columns[0].name) if schema.pk_columns else "rowid"
        qt = adapter.quote(table)
        lit = adapter.string_literal(table)
        self._drop_triggers(con, table)
        track = f"INSERT OR REPLACE INTO {TRACK_TABLE} (table_name, pk) VALUES ({lit}"
        con.execute(f"CREATE TRIGGER {_trigger(table, 'ins')} AFTER INSERT ON {qt} BEGIN "
                    f"{track}, NEW.{pk}); END;")
        con.execute(f"CREATE TRIGGER {_trigger(table, 'upd')} AFTER UPDATE ON {qt} BEGIN "
                    f"{track}, NEW.{pk}); {track}, OLD.{pk}); END;")
        con.execute(f"CREATE TRIGGER {_trigger(table, 'del')} AFTER DELETE ON {qt} BEGIN "
                    f"{track}, OLD.{pk}); END;")

    # -- reading the working copy --------------------------------------------

    @staticmethod
    def _crs_identifier(srs):
        if srs["organization"] and srs["organization"] != "NONE":
            return f"{srs['organization']}:{srs['organization_coordsys_id']}"
        return get_identifier_str(srs["definition"])

    def _wc_schema_for_table(self, con, table):
        """The table's DDL -> a V2 schema with fresh column ids (align it to
        the dataset's before diffing)."""
        geom_info = None
        row = con.execute("SELECT column_name, geometry_type_name, srs_id, z, m "
                          "FROM gpkg_geometry_columns WHERE table_name = ?", (table,)).fetchone()
        if row:
            srs = con.execute("SELECT * FROM gpkg_spatial_ref_sys WHERE srs_id = ?",
                              (row["srs_id"],)).fetchone()
            crs_identifier = (self._crs_identifier(srs)
                              if srs and srs["srs_id"] > 0 else None)
            geom_info = {**dict(row), "crs_identifier": crs_identifier}
        cols = []
        for info in con.execute(f"PRAGMA table_info({adapter.quote(table)})"):
            name = info["name"]
            is_geom = geom_info is not None and name == geom_info["column_name"]
            data_type, extra = adapter.sqlite_type_to_v2(
                info["type"], geom_info=geom_info if is_geom else None)
            pk_index = info["pk"] - 1 if info["pk"] > 0 else None
            if pk_index is not None and data_type == "integer":
                extra = {**extra, "size": 64}
            cols.append(ColumnSchema(ColumnSchema.new_id(), name, data_type, pk_index, extra))
        return Schema(cols)

    def _wc_meta_items(self, con, table, aligned_schema, dataset_title=None):
        out = {"schema.json": aligned_schema.to_column_dicts()}
        row = con.execute("SELECT identifier, description, srs_id FROM gpkg_contents "
                          "WHERE table_name = ?", (table,)).fetchone()
        if row:
            # the identifier defaults to the table name when the dataset has
            # no title: reading that default back is no edit, but a title
            # equal to the table name still round-trips
            if row["identifier"] and (row["identifier"] != table or dataset_title == table):
                out["title"] = row["identifier"]
            if row["description"]:
                out["description"] = row["description"]
        geom = con.execute("SELECT srs_id FROM gpkg_geometry_columns WHERE table_name = ?",
                           (table,)).fetchone()
        if geom is not None:
            srs = con.execute("SELECT * FROM gpkg_spatial_ref_sys WHERE srs_id = ?",
                              (geom["srs_id"],)).fetchone()
            if srs and srs["srs_id"] > 0:
                out[f"crs/{self._crs_identifier(srs)}.wkt"] = srs["definition"]
        return out

    # -- diffing -------------------------------------------------------------

    def diff_dataset_to_working_copy(self, dataset, ds_filter=None):
        """The DatasetDiff from ``dataset`` to the copy's table, reading the
        tracked rows only."""
        table = self._table_name(dataset.path)
        result = DatasetDiff()
        with self.session() as con:
            if not con.execute("SELECT count(*) FROM sqlite_master WHERE name = ?",
                               (table,)).fetchone()[0]:
                return result
            result["meta"] = self._diff_meta(con, dataset, table)
            new_schema = dataset.schema
            if "schema.json" in result["meta"]:
                new_schema = Schema.from_column_dicts(result["meta"]["schema.json"].new_value)
            result["feature"] = self._diff_features(con, dataset, table, new_schema, ds_filter)
        if can_find_renames(dataset, result["meta"]):
            find_renames(result["feature"], dataset)
        result.prune()
        return result

    def _diff_meta(self, con, dataset, table):
        wc_schema = self._wc_schema_for_table(con, table)
        aligned = dataset.schema.align_to_self(wc_schema,
                                               roundtrip_ctx=adapter.GpkgRoundtripContext)
        ds_items = dataset.meta_items()
        wc_items = self._wc_meta_items(con, table, aligned, dataset_title=ds_items.get("title"))
        out = DeltaDiff()
        for name in sorted(set(ds_items) | set(wc_items)):
            if name == "metadata.xml":
                continue  # attachments do not round-trip through the copy
            old, new = ds_items.get(name), wc_items.get(name)
            if old == new:
                continue
            out.add_delta(Delta(KeyValue((name, old)) if old is not None else None,
                                KeyValue((name, new)) if new is not None else None,
                                flags=WORKING_COPY_EDIT))
        return out

    def _diff_features(self, con, dataset, table, wc_schema, ds_filter):
        feature_filter = ds_filter["feature"] if ds_filter is not None else None
        out = DeltaDiff()
        pk_col = dataset.schema.pk_columns[0]
        geom_cols = {c.name for c in wc_schema.columns if c.data_type == "geometry"}
        tracked = [row["pk"] for row in con.execute(
            f"SELECT pk FROM {TRACK_TABLE} WHERE table_name = ?", (table,))]
        if not tracked:
            return out
        quoted = adapter.quote(pk_col.name)
        for start in range(0, len(tracked), TRACKED_CHUNK):
            chunk = tracked[start : start + TRACKED_CHUNK]
            rows = {row[pk_col.name]: row for row in con.execute(
                f"SELECT * FROM {adapter.quote(table)} WHERE {quoted} IN "
                f"({','.join('?' for _ in chunk)})", chunk)}
            for raw_pk in chunk:
                key = pk = dataset.schema.sanitise_pks(raw_pk)[0]
                if feature_filter is not None and key not in feature_filter:
                    continue
                try:
                    old_feature = dataset.get_feature([pk])
                except ObjectPromised:
                    # the pk of an out-of-filter (promised) feature: committing
                    # would overwrite it
                    old_feature = None
                    self.spatial_filter_pk_conflicts.setdefault(dataset.path, []).append(pk)
                except KeyError:
                    old_feature = None
                row = rows.get(pk)
                new_feature = None
                if row is not None:
                    new_feature = {c.name: adapter.value_to_v2(row[c.name], c)
                                   for c in wc_schema.columns if c.name in row.keys()}
                    for g in geom_cols & set(new_feature):
                        if isinstance(new_feature[g], Geometry):
                            new_feature[g] = new_feature[g].normalised()
                if old_feature is None and new_feature is None:
                    continue
                if old_feature == new_feature:
                    continue
                out.add_delta(Delta(
                    KeyValue((key, old_feature)) if old_feature is not None else None,
                    KeyValue((key, new_feature)) if new_feature is not None else None,
                    flags=WORKING_COPY_EDIT))
        return out

    def is_dirty(self):
        if not (self.status() & WorkingCopyStatus.INITIALISED):
            return False
        tree = self.get_db_tree()
        if tree is None:
            return False
        try:
            rs = self.repo.structure(tree)
        except NotFound:
            return False
        return any(self.diff_dataset_to_working_copy(ds) for ds in rs.datasets)

    # -- state after a commit or checkout --------------------------------------

    def reset_tracking_table(self, repo_key_filter=None):
        with self.session() as con:
            if repo_key_filter is None or repo_key_filter.match_all:
                con.execute(f"DELETE FROM {TRACK_TABLE}")
                return
            for ds_path in repo_key_filter.ds_paths():
                ds_filter = repo_key_filter[ds_path]
                table = self._table_name(ds_path)
                feature_filter = ds_filter["feature"]
                if ds_filter.match_all or feature_filter.match_all:
                    con.execute(f"DELETE FROM {TRACK_TABLE} WHERE table_name = ?", (table,))
                else:
                    for pk in feature_filter.keys:
                        con.execute(f"DELETE FROM {TRACK_TABLE} WHERE table_name = ? AND pk = ?",
                                    (table, str(pk)))

    def update_state_table_tree(self, tree_oid):
        with self.session() as con:
            self._update_state_tree(con, tree_oid)

    # -- reset / checkout ------------------------------------------------------

    def reset(self, target_structure, *, force=False, repo_key_filter=None,
              track_changes_as_dirty=False):
        """Move the copy to ``target_structure``. With ``force`` every table
        is written again and the tracking cleared; without it the copy's
        tree is diffed against the target's (K1 on :attr:`device` where both
        have sidecars), a dataset whose meta changed is written again, and
        the others get their changed rows only: edits to other rows stay."""
        from kart_tpu_torch.diff.engine import get_dataset_diff

        current_tree = self.get_db_tree()
        if current_tree is None:
            self.write_full(target_structure, *target_structure.datasets)
            return
        if force:
            self.write_full(target_structure, *target_structure.datasets)
            with self.session() as con:
                con.execute(f"DELETE FROM {TRACK_TABLE}")
            return

        base_rs = self.repo.structure(current_tree)
        base_paths = set(base_rs.datasets.paths())
        target_paths = set(target_structure.datasets.paths())
        with self.session() as con:
            for ds_path in sorted(base_paths - target_paths):
                table = self._table_name(ds_path)
                self._drop_spatial_index(con, table)
                con.execute(f"DROP TABLE IF EXISTS {adapter.quote(table)}")
                con.execute("DELETE FROM gpkg_contents WHERE table_name = ?", (table,))
                con.execute("DELETE FROM gpkg_geometry_columns WHERE table_name = ?", (table,))
                con.execute(f"DELETE FROM {TRACK_TABLE} WHERE table_name = ?", (table,))
            for ds_path in sorted(target_paths - base_paths):
                self._write_one_dataset(con, target_structure.datasets[ds_path])
            for ds_path in sorted(base_paths & target_paths):
                target_ds = target_structure.datasets[ds_path]
                ds_diff = get_dataset_diff(base_rs, target_structure, ds_path, device=self.device)
                if not ds_diff:
                    continue
                if ds_diff.get("meta"):
                    # a meta or schema change: write the dataset again
                    self._write_one_dataset(con, target_ds)
                    con.execute(f"DELETE FROM {TRACK_TABLE} WHERE table_name = ?",
                                (self._table_name(ds_path),))
                    continue
                self._apply_feature_diff_sql(con, target_ds, ds_diff.get("feature", {}),
                                             track_changes_as_dirty=track_changes_as_dirty)
            self._update_state_tree(con, target_structure.tree_oid)

    def _apply_feature_diff_sql(self, con, dataset, feature_diff, *,
                                track_changes_as_dirty=False):
        table = self._table_name(dataset.path)
        schema = dataset.schema
        crs_id = 0
        crs_ids = dataset.crs_identifiers()
        if schema.first_geometry_column is not None and crs_ids:
            crs_id = get_identifier_int(dataset.get_crs_definition(crs_ids[0]))
        pk_col = adapter.quote(schema.pk_columns[0].name)
        qt = adapter.quote(table)
        if not track_changes_as_dirty:
            self._drop_triggers(con, table)  # kart's own writes are no edit
        try:
            col_names = [c.name for c in schema.columns]
            upsert = (f"INSERT OR REPLACE INTO {qt} "
                      f"({','.join(adapter.quote(c) for c in col_names)}) "
                      f"VALUES ({','.join('?' for _ in col_names)})")
            for delta in feature_diff.values():
                if delta.new is None:
                    con.execute(f"DELETE FROM {qt} WHERE {pk_col} = ?", (delta.old_key,))
                    continue
                try:
                    new_value = delta.new_value
                except ObjectPromised:
                    # a partial clone's out-of-filter feature: no row for it
                    con.execute(f"DELETE FROM {qt} WHERE {pk_col} = ?", (delta.new_key,))
                    continue
                con.execute(upsert, tuple(adapter.value_from_v2(new_value[c.name], c,
                                                                crs_id=crs_id)
                                          for c in schema.columns))
        finally:
            if not track_changes_as_dirty:
                self._create_triggers(con, table, schema)

    def soft_reset_after_commit(self, new_tree_oid, repo_key_filter=None):
        """After a commit of the copy's edits: clear their tracking and
        record the new tree."""
        self.reset_tracking_table(repo_key_filter)
        self.update_state_table_tree(new_tree_oid)
