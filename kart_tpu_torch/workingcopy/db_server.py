"""Server-database working copies: the shared base of the PostGIS, SQL
Server and MySQL working copies.

A server working copy lives in one database schema (PostGIS, SQL Server) or
one database (MySQL) of a server named by a URL:

    postgresql://HOST[:PORT]/DBNAME/DBSCHEMA
    mssql://HOST[:PORT]/DBNAME/DBSCHEMA
    mysql://HOST[:PORT]/DBNAME

Its contract is the GPKG working copy's (status, write_full, diff, reset,
tracking); the SQL comes from the dialect's adapter and runs over the plain
DBAPI driver of that server. The driver is imported only by ``_connect``,
which raises :class:`~kart_tpu_torch.core.repo.NotFound` when it is missing:
everything before connecting (the URL, the SQL) works without one.

``reset`` without ``force`` diffs the copy's tree against the target's
through :func:`kart_tpu_torch.diff.engine.get_dataset_diff` on the working
copy's device (kernel K1 on the card, the host floor with ``device="cpu"``)
and writes only the changed rows as the dialect's upserts and deletes.

Counterpart of kart_tpu's ``workingcopy/db_server.py``.
"""

import contextlib
from urllib.parse import urlsplit, unquote

from kart_tpu_torch.adapters.base import KART_STATE, KART_TRACK
from kart_tpu_torch.core.odb import ObjectPromised
from kart_tpu_torch.core.repo import InvalidOperation, NotFound
from kart_tpu_torch.crs import get_identifier_int, get_identifier_str
from kart_tpu_torch.diff.structs import (
    WORKING_COPY_EDIT,
    DatasetDiff,
    Delta,
    DeltaDiff,
    KeyValue,
)
from kart_tpu_torch.models.schema import ColumnSchema, Schema
from kart_tpu_torch.workingcopy import (
    Mismatch,
    WorkingCopyStatus,
    can_find_renames,
    checkout_features,
    find_renames,
)

#: rows a checkout inserts a statement
INSERT_BATCH = 10000
#: tracked pks read a query
TRACKED_CHUNK = 500


class DatabaseServerWorkingCopy:
    """Base for PostGIS / SQL Server / MySQL working copies."""

    URI_SCHEME = None        # "postgresql" | "mssql" | "mysql"
    # path parts after the host: ("dbname", "dbschema") or ("dbname",)
    URI_PATH_PARTS = 2
    WORKING_COPY_TYPE_NAME = None
    ADAPTER = None           # BaseAdapter subclass
    PARAMSTYLE = "%s"        # DBAPI placeholder ("%s" or "?")

    def __init__(self, repo, location, device=None):
        self.repo = repo
        self.device = device
        # {ds_path: [pks]} filled during WC diffs on a filtered clone
        self.spatial_filter_pk_conflicts = {}
        self.location = str(location)
        (
            self.host,
            self.port,
            self.db_name,
            self.db_schema,
            self.username,
            self.password,
        ) = self._parse_url(self.location)

    @classmethod
    def _parse_url(cls, location):
        url = urlsplit(location)
        if url.scheme != cls.URI_SCHEME:
            raise InvalidOperation(
                f"Expecting URI in form: {cls.URI_SCHEME}://HOST[:PORT]/"
                + "/".join(p.upper() for p in cls._path_part_names())
            )
        parts = [p for p in url.path.split("/") if p]
        if len(parts) != cls.URI_PATH_PARTS:
            expected = "/".join(p.upper() for p in cls._path_part_names())
            raise InvalidOperation(
                f"Invalid {cls.WORKING_COPY_TYPE_NAME} URI - URI path must have "
                f"{cls.URI_PATH_PARTS} part(s): "
                f"expecting {cls.URI_SCHEME}://HOST[:PORT]/{expected}"
            )
        db_name = unquote(parts[0])
        db_schema = unquote(parts[1]) if cls.URI_PATH_PARTS > 1 else db_name
        username = unquote(url.username) if url.username else None
        password = unquote(url.password) if url.password else None
        return url.hostname, url.port, db_name, db_schema, username, password

    @classmethod
    def _path_part_names(cls):
        return ("dbname", "dbschema")[: cls.URI_PATH_PARTS]

    @property
    def clean_location(self):
        """Location with any password redacted."""
        url = urlsplit(self.location)
        if url.password is None:
            return self.location
        netloc = url.hostname or ""
        if url.username:
            netloc = f"{url.username}@{netloc}"
        if url.port:
            netloc = f"{netloc}:{url.port}"
        return url._replace(netloc=netloc).geturl()

    def __str__(self):
        return self.clean_location

    # -- connection (driver-gated) -------------------------------------------

    def _connect(self):
        raise NotImplementedError

    @contextlib.contextmanager
    def session(self):
        con = self._connect()
        try:
            yield con
            con.commit()
        except Exception:
            con.rollback()
            raise
        finally:
            con.close()

    def _execute(self, con, sql, params=()):
        cur = con.cursor()
        cur.execute(sql, params)
        return cur

    def _ph(self, n=1):
        return ", ".join([self.PARAMSTYLE] * n)

    # -- naming --------------------------------------------------------------

    @staticmethod
    def _table_name(ds_path):
        """dataset path -> table name; nested paths flatten with '__'."""
        return ds_path.replace("/", "__")

    def _table_identifier(self, table_name):
        return self.ADAPTER.quote_table(table_name, self.db_schema)

    # -- status / state ------------------------------------------------------

    def status(self):
        result = 0
        try:
            with self.session() as con:
                result |= WorkingCopyStatus.CREATED
                if self._schema_exists(con):
                    result |= WorkingCopyStatus.INITIALISED
                    if self._has_feature_tables(con):
                        result |= WorkingCopyStatus.HAS_DATA
        except NotFound:
            raise
        except Exception:
            result |= WorkingCopyStatus.UNCONNECTABLE
        return result

    def _schema_exists(self, con):
        raise NotImplementedError

    def _has_feature_tables(self, con):
        raise NotImplementedError

    def _list_feature_tables(self, con):
        """All non-kart tables in the WC container (information_schema works
        for PostGIS/MySQL/SQL Server; the _kart_ filter is done host-side to
        dodge per-dialect LIKE-escape rules)."""
        cur = self._execute(
            con,
            "SELECT table_name FROM information_schema.tables "
            f"WHERE table_schema = {self.PARAMSTYLE}",
            (self.db_schema,),
        )
        return [r[0] for r in cur.fetchall() if not r[0].startswith("_kart_")]

    def create_and_initialise(self):
        with self.session() as con:
            for stmt in self.ADAPTER.base_ddl(self.db_schema):
                self._execute(con, stmt)

    def delete(self):
        """Drop the whole WC container schema/database."""
        with self.session() as con:
            self._execute(con, self._drop_container_sql())

    def _drop_container_sql(self):
        raise NotImplementedError

    def get_db_tree(self):
        with self.session() as con:
            try:
                cur = self._execute(
                    con,
                    f"SELECT value FROM {self._table_identifier(KART_STATE)} "
                    f"WHERE table_name = '*' AND {self._state_key_col()} = 'tree'",
                )
            except Exception:
                return None
            row = cur.fetchone()
            return row[0] if row else None

    def _state_key_col(self):
        return self.ADAPTER.quote("key")

    def assert_db_tree_match(self, expected_tree_oid):
        wc_tree = self.get_db_tree()
        expected = (
            expected_tree_oid.oid
            if hasattr(expected_tree_oid, "oid")
            else expected_tree_oid
        )
        if wc_tree != expected:
            raise Mismatch(wc_tree, expected)

    def _update_state_tree(self, con, tree_oid):
        state = self._table_identifier(KART_STATE)
        self._execute(
            con,
            f"DELETE FROM {state} WHERE table_name = '*' "
            f"AND {self._state_key_col()} = 'tree'",
        )
        self._execute(
            con,
            f"INSERT INTO {state} (table_name, {self._state_key_col()}, value) "
            f"VALUES ('*', 'tree', {self.PARAMSTYLE})",
            (str(tree_oid),),
        )

    def update_state_table_tree(self, tree_oid):
        with self.session() as con:
            self._update_state_tree(con, tree_oid)

    # -- checkout (write_full) -----------------------------------------------

    def write_full(self, target_structure, *datasets):
        if not (self.status() & WorkingCopyStatus.INITIALISED):
            self.create_and_initialise()
        with self.session() as con:
            for ds in datasets:
                self._write_one_dataset(con, ds)
            self._update_state_tree(con, target_structure.tree_oid)

    def _dataset_crs_id(self, ds):
        schema = ds.schema
        if schema.first_geometry_column is None:
            return 0
        idents = ds.crs_identifiers()
        if not idents:
            return 0
        return get_identifier_int(ds.get_crs_definition(idents[0]))

    def _write_one_dataset(self, con, ds):
        table = self._table_name(ds.path)
        schema = ds.schema
        crs_id = self._dataset_crs_id(ds)

        for ident in ds.crs_identifiers():
            wkt = ds.get_crs_definition(ident)
            org, _, code = ident.partition(":")
            stmt = self.ADAPTER.register_crs_sql(
                get_identifier_int(wkt), org or "NONE",
                int(code) if code.isdigit() else 0, wkt,
            )
            if stmt is not None:
                with contextlib.suppress(Exception):
                    # best-effort: the SRS may exist / the def may be
                    # unsupported by this server; features still store SRIDs
                    self._execute(con, stmt[0], stmt[1])

        tbl = self._table_identifier(table)
        self._execute(con, f"DROP TABLE IF EXISTS {tbl}")
        spec = self.ADAPTER.v2_schema_to_sql_spec(schema, crs_id=crs_id or None)
        self._execute(con, f"CREATE TABLE {tbl} ({spec})")
        self._write_meta(con, ds, table)

        col_names = [c.name for c in schema.columns]
        quoted_cols = ", ".join(self.ADAPTER.quote(c) for c in col_names)
        placeholders = ", ".join(
            self.ADAPTER.insert_placeholder(c, crs_id) for c in schema.columns
        )
        insert_sql = f"INSERT INTO {tbl} ({quoted_cols}) VALUES ({placeholders})"
        batch = []
        cur = con.cursor()
        for feature in checkout_features(self.repo, ds):
            batch.append(
                tuple(
                    self.ADAPTER.value_from_v2(feature[c.name], c, crs_id=crs_id)
                    for c in schema.columns
                )
            )
            if len(batch) >= INSERT_BATCH:
                cur.executemany(insert_sql, batch)
                batch.clear()
        if batch:
            cur.executemany(insert_sql, batch)

        self._post_write_dataset(con, ds, table, crs_id)
        self._create_triggers(con, table, schema)

    def _write_meta(self, con, ds, table):
        """Backend hook: titles/comments/spatial indexes."""

    def _post_write_dataset(self, con, ds, table, crs_id):
        """Backend hook: spatial index, sequence fixup."""

    def _create_triggers(self, con, table, schema):
        pk_name = schema.pk_columns[0].name if schema.pk_columns else None
        if pk_name is None:
            return
        stmts = self.ADAPTER.create_trigger_sql(self.db_schema, table, pk_name)
        if isinstance(stmts, str):
            stmts = [stmts]
        for stmt in stmts:
            self._execute(con, stmt)

    @contextlib.contextmanager
    def _suspended_triggers(self, con, table, schema):
        pk_name = schema.pk_columns[0].name if schema.pk_columns else None
        suspend = self.ADAPTER.suspend_trigger_sql(self.db_schema, table)
        if isinstance(suspend, str):
            suspend = [suspend]
        for stmt in suspend:
            self._execute(con, stmt)
        try:
            yield
        finally:
            resume = self.ADAPTER.resume_trigger_sql(self.db_schema, table, pk_name)
            if isinstance(resume, str):
                resume = [resume]
            for stmt in resume:
                self._execute(con, stmt)

    # -- reading the WC schema back ------------------------------------------

    def _wc_schema_for_table(self, con, table):
        """information_schema -> V2 schema (fresh ids; align before diff)."""
        cols = []
        for (name, sql_type, pk_index, geom_info) in self._table_columns(con, table):
            if geom_info is not None:
                data_type, extra = "geometry", dict(geom_info)
            else:
                data_type, extra = self.ADAPTER.sql_type_to_v2(sql_type)
            if pk_index is not None and data_type == "integer":
                extra = {**extra, "size": extra.get("size", 64)}
            cols.append(
                ColumnSchema(ColumnSchema.new_id(), name, data_type, pk_index, extra)
            )
        return Schema(cols)

    def _table_columns(self, con, table):
        """Backend hook -> iterable of (name, sql_type, pk_index, geom_info)."""
        raise NotImplementedError

    def _wc_meta_items(self, con, table, aligned_schema):
        out = {"schema.json": aligned_schema.to_column_dicts()}
        out.update(self._extra_meta_items(con, table))
        return out

    def _extra_meta_items(self, con, table):
        return {}

    # Items a backend has nowhere to store; excluded from the meta diff
    # (reference: postgis.py _UNSUPPORTED_META_ITEMS).
    UNSUPPORTED_META_ITEMS = ("title", "description", "metadata.xml")

    # -- diffing -------------------------------------------------------------

    def diff_dataset_to_working_copy(self, dataset, ds_filter=None):
        table = self._table_name(dataset.path)
        result = DatasetDiff()
        with self.session() as con:
            if not self._table_exists(con, table):
                return result
            result["meta"] = self._diff_meta(con, dataset, table)
            new_schema = dataset.schema
            if "schema.json" in result["meta"]:
                new_schema = Schema.from_column_dicts(
                    result["meta"]["schema.json"].new_value
                )
            result["feature"] = self._diff_features(
                con, dataset, table, new_schema, ds_filter
            )
        if can_find_renames(dataset, result["meta"]):
            find_renames(result["feature"], dataset)
        result.prune()
        return result

    def _table_exists(self, con, table):
        raise NotImplementedError

    def _diff_meta(self, con, dataset, table):
        wc_schema = self._wc_schema_for_table(con, table)
        aligned = dataset.schema.align_to_self(
            wc_schema, roundtrip_ctx=self.ADAPTER
        )
        wc_items = self._wc_meta_items(con, table, aligned)
        ds_items = dataset.meta_items()
        out = DeltaDiff()
        for name in sorted(set(ds_items) | set(wc_items)):
            if name in self.UNSUPPORTED_META_ITEMS and name not in wc_items:
                continue
            if name.startswith("crs/") and name not in wc_items:
                # CRS defs don't roundtrip byte-exactly through server SRS
                # tables; absence in the WC is not an edit
                continue
            old = ds_items.get(name)
            new = wc_items.get(name)
            if old == new:
                continue
            out.add_delta(
                Delta(
                    KeyValue((name, old)) if old is not None else None,
                    KeyValue((name, new)) if new is not None else None,
                    flags=WORKING_COPY_EDIT,
                )
            )
        return out

    def _diff_features(self, con, dataset, table, wc_schema, ds_filter):
        feature_filter = ds_filter["feature"] if ds_filter is not None else None
        out = DeltaDiff()
        pk_col = dataset.schema.pk_columns[0]
        track = self._table_identifier(KART_TRACK)
        cur = self._execute(
            con,
            f"SELECT pk FROM {track} WHERE table_name = {self.PARAMSTYLE}",
            (table,),
        )
        tracked = [row[0] for row in cur.fetchall()]
        if not tracked:
            return out
        tbl = self._table_identifier(table)
        select_cols = ", ".join(
            self.ADAPTER.select_expression(c) for c in wc_schema.columns
        )
        quoted_pk = self.ADAPTER.quote(pk_col.name)
        names = [c.name for c in wc_schema.columns]
        for chunk_start in range(0, len(tracked), TRACKED_CHUNK):
            chunk = tracked[chunk_start : chunk_start + TRACKED_CHUNK]
            cur = self._execute(
                con,
                f"SELECT {select_cols} FROM {tbl} "
                f"WHERE {quoted_pk} IN ({self._ph(len(chunk))})",
                tuple(chunk),
            )
            rows = {}
            pk_pos = names.index(pk_col.name)
            for row in cur.fetchall():
                rows[dataset.schema.sanitise_pks(row[pk_pos])[0]] = row
            for raw_pk in chunk:
                pk = dataset.schema.sanitise_pks(raw_pk)[0]
                if feature_filter is not None and pk not in feature_filter:
                    continue
                try:
                    old_feature = dataset.get_feature([pk])
                except ObjectPromised:
                    # pk collides with an out-of-filter (promised) feature
                    old_feature = None
                    self.spatial_filter_pk_conflicts.setdefault(
                        dataset.path, []
                    ).append(pk)
                except KeyError:
                    old_feature = None
                row = rows.get(pk)
                new_feature = None
                if row is not None:
                    new_feature = {
                        c.name: self.ADAPTER.value_to_v2(row[i], c)
                        for i, c in enumerate(wc_schema.columns)
                    }
                if old_feature is None and new_feature is None:
                    continue
                if old_feature == new_feature:
                    continue
                out.add_delta(
                    Delta(
                        KeyValue((pk, old_feature)) if old_feature is not None else None,
                        KeyValue((pk, new_feature)) if new_feature is not None else None,
                        flags=WORKING_COPY_EDIT,
                    )
                )
        return out

    def is_dirty(self):
        status = self.status()
        if not (status & WorkingCopyStatus.INITIALISED):
            return False
        tree = self.get_db_tree()
        if tree is None:
            return False
        try:
            rs = self.repo.structure(tree)
        except NotFound:
            return False
        for ds in rs.datasets:
            if self.diff_dataset_to_working_copy(ds):
                return True
        return False

    # -- state updates -------------------------------------------------------

    def reset_tracking_table(self, repo_key_filter=None):
        track = self._table_identifier(KART_TRACK)
        with self.session() as con:
            if repo_key_filter is None or repo_key_filter.match_all:
                self._execute(con, f"DELETE FROM {track}")
                return
            for ds_path in repo_key_filter.ds_paths():
                ds_filter = repo_key_filter[ds_path]
                table = self._table_name(ds_path)
                feature_filter = ds_filter["feature"]
                if ds_filter.match_all or feature_filter.match_all:
                    self._execute(
                        con,
                        f"DELETE FROM {track} WHERE table_name = {self.PARAMSTYLE}",
                        (table,),
                    )
                else:
                    for pk in feature_filter.keys:
                        self._execute(
                            con,
                            f"DELETE FROM {track} WHERE table_name = "
                            f"{self.PARAMSTYLE} AND pk = {self.PARAMSTYLE}",
                            (table, str(pk)),
                        )

    def soft_reset_after_commit(self, new_tree_oid, repo_key_filter=None):
        self.reset_tracking_table(repo_key_filter)
        self.update_state_table_tree(new_tree_oid)

    # -- reset / checkout ----------------------------------------------------

    def reset(self, target_structure, *, force=False, repo_key_filter=None,
              track_changes_as_dirty=False):
        from kart_tpu_torch.diff.engine import get_dataset_diff

        current_tree = self.get_db_tree()
        if current_tree is None or force:
            # tables from datasets absent in the target would otherwise
            # linger in the schema and still count as WC data
            target_tables = {
                self._table_name(p) for p in target_structure.datasets.paths()
            }
            with self.session() as con:
                if self._schema_exists(con):
                    for table in self._list_feature_tables(con):
                        if table not in target_tables:
                            self._execute(
                                con,
                                f"DROP TABLE IF EXISTS "
                                f"{self._table_identifier(table)}",
                            )
            self.write_full(target_structure, *target_structure.datasets)
            if force:
                with self.session() as con:
                    self._execute(
                        con, f"DELETE FROM {self._table_identifier(KART_TRACK)}"
                    )
            return

        base_rs = self.repo.structure(current_tree)
        base_paths = set(base_rs.datasets.paths())
        target_paths = set(target_structure.datasets.paths())

        with self.session() as con:
            track = self._table_identifier(KART_TRACK)
            for ds_path in sorted(base_paths - target_paths):
                table = self._table_name(ds_path)
                self._execute(
                    con, f"DROP TABLE IF EXISTS {self._table_identifier(table)}"
                )
                self._execute(
                    con,
                    f"DELETE FROM {track} WHERE table_name = {self.PARAMSTYLE}",
                    (table,),
                )
            for ds_path in sorted(target_paths - base_paths):
                self._write_one_dataset(con, target_structure.datasets[ds_path])
            for ds_path in sorted(base_paths & target_paths):
                target_ds = target_structure.datasets[ds_path]
                ds_diff = get_dataset_diff(base_rs, target_structure, ds_path,
                                           device=self.device)
                if not ds_diff:
                    continue
                if "meta" in ds_diff and ds_diff["meta"]:
                    self._write_one_dataset(con, target_ds)
                    self._execute(
                        con,
                        f"DELETE FROM {track} WHERE table_name = {self.PARAMSTYLE}",
                        (self._table_name(ds_path),),
                    )
                    continue
                self._apply_feature_diff_sql(
                    con, target_ds, ds_diff.get("feature", {}),
                    track_changes_as_dirty=track_changes_as_dirty,
                )
            self._update_state_tree(con, target_structure.tree_oid)

    def _apply_feature_diff_sql(self, con, dataset, feature_diff, *,
                                track_changes_as_dirty=False):
        table = self._table_name(dataset.path)
        schema = dataset.schema
        crs_id = self._dataset_crs_id(dataset)
        pk_col = schema.pk_columns[0]
        col_names = [c.name for c in schema.columns]
        pk_names = [c.name for c in schema.pk_columns]
        upsert = self.ADAPTER.upsert_sql(
            self.db_schema, table, col_names, pk_names, crs_id=crs_id, schema=schema
        )
        tbl = self._table_identifier(table)
        ctx = (
            contextlib.nullcontext()
            if track_changes_as_dirty
            else self._suspended_triggers(con, table, schema)
        )
        with ctx:
            for delta in feature_diff.values():
                if delta.new is None:
                    self._execute(
                        con,
                        f"DELETE FROM {tbl} WHERE "
                        f"{self.ADAPTER.quote(pk_col.name)} = {self.PARAMSTYLE}",
                        (delta.old_key,),
                    )
                else:
                    try:
                        new_value = delta.new_value
                    except ObjectPromised:
                        # partial clone: target feature is out-of-filter —
                        # remove any stale row rather than materialising it
                        self._execute(
                            con,
                            f"DELETE FROM {tbl} WHERE "
                            f"{self.ADAPTER.quote(pk_col.name)} = {self.PARAMSTYLE}",
                            (delta.new_key,),
                        )
                        continue
                    values = tuple(
                        self.ADAPTER.value_from_v2(
                            new_value[c.name], c, crs_id=crs_id
                        )
                        for c in schema.columns
                    )
                    self._execute(con, upsert, values)
