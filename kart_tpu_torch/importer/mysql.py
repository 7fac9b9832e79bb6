"""MySQL import source over ``pymysql``, read in ``fetchmany`` batches from
an unbuffered ``SSCursor`` (a buffered cursor where the driver has none).
The driver is imported only when connecting; without it the import raises
:class:`~kart_tpu_torch.core.repo.NotFound`. The spec (a MySQL schema is a
database):

    mysql://HOST[:PORT]/DBNAME[/TABLE]

Without a table every table of the database that has a primary key is
imported.

Counterpart of kart_tpu's ``importer/mysql.py``.
"""

from urllib.parse import unquote, urlsplit

from kart_tpu_torch.adapters.mysql import MySqlAdapter
from kart_tpu_torch.core.repo import NotFound
from kart_tpu_torch.importer import ImportSource, ImportSourceError
from kart_tpu_torch.models.schema import ColumnSchema, Schema

BATCH_SIZE = 10_000


def _connect(host, port, dbname, user, password):
    try:
        import pymysql
    except ImportError:
        raise NotFound(
            "MySQL imports require the pymysql driver, which is not "
            "installed in this environment."
        )
    return pymysql.connect(
        host=host, port=port or 3306, database=dbname, user=user,
        password=password or "",
    )


class MySqlImportSource(ImportSource):
    def __init__(self, url_parts, dbname, table_name, dest_path=None):
        self.url_parts = url_parts  # (host, port, dbname, user, password)
        self.dbname = dbname
        self.table_name = table_name
        self.dest_path = dest_path or table_name
        self._schema = None
        self._crs_defs = None

    @classmethod
    def parse_spec(cls, spec):
        url = urlsplit(spec)
        parts = [unquote(p) for p in url.path.split("/") if p]
        if not parts:
            raise ImportSourceError(
                "Expecting mysql://HOST[:PORT]/DBNAME[/TABLE]"
            )
        dbname = parts[0]
        table = parts[1] if len(parts) > 1 else None
        conn_parts = (
            url.hostname,
            url.port,
            dbname,
            unquote(url.username) if url.username else None,
            unquote(url.password) if url.password else None,
        )
        return conn_parts, dbname, table

    @classmethod
    def open_all(cls, spec, table=None):
        conn_parts, dbname, spec_table = cls.parse_spec(spec)
        table = table or spec_table
        if table is not None:
            return [cls(conn_parts, dbname, table)]
        con = _connect(*conn_parts)
        try:
            cur = con.cursor()
            cur.execute(
                """
                SELECT DISTINCT table_name
                FROM information_schema.columns
                WHERE table_schema = %s AND column_key = 'PRI'
                ORDER BY table_name
                """,
                (dbname,),
            )
            tables = [row[0] for row in cur.fetchall()]
        finally:
            con.close()
        if not tables:
            raise ImportSourceError(
                f"No tables with primary keys found in database {dbname!r}"
            )
        return [cls(conn_parts, dbname, t) for t in tables]

    # -- schema ---------------------------------------------------------------

    def _load_schema(self):
        if self._schema is not None:
            return
        con = _connect(*self.url_parts)
        try:
            # PK column sequence first: information_schema.columns has no key
            # ordering, so PRIMARY KEY (b, a) would otherwise come out in
            # table-column order (a, b) — wrong feature paths/keys (the
            # reference reflects SQLAlchemy's PK-constraint order)
            cur = con.cursor()
            cur.execute(
                """
                SELECT column_name, ordinal_position
                FROM information_schema.key_column_usage
                WHERE table_schema = %s AND table_name = %s
                  AND constraint_name = 'PRIMARY'
                """,
                (self.dbname, self.table_name),
            )
            pk_order = {}
            for pk_name, pk_pos in cur.fetchall():
                if isinstance(pk_name, bytes):
                    pk_name = pk_name.decode()
                pk_order[pk_name] = int(pk_pos) - 1
            cur.execute(
                """
                SELECT C.column_name, C.data_type,
                       C.character_maximum_length, C.numeric_precision,
                       C.numeric_scale, C.column_key, C.srs_id
                FROM information_schema.columns C
                WHERE C.table_schema = %s AND C.table_name = %s
                ORDER BY C.ordinal_position
                """,
                (self.dbname, self.table_name),
            )
            cols = []
            crs_defs = {}
            for (name, data_type, char_len, num_prec, num_scale, column_key,
                 srs_id) in cur.fetchall():
                if isinstance(data_type, bytes):
                    data_type = data_type.decode()
                if isinstance(name, bytes):
                    name = name.decode()
                if isinstance(column_key, bytes):
                    column_key = column_key.decode()
                sql_type = (data_type or "").upper()
                pk_index = pk_order.get(name)
                if pk_index is None and column_key == "PRI":
                    # key_column_usage gave nothing (a user without the
                    # privilege to read it): the key in column order
                    pk_index = len(pk_order)
                    pk_order[name] = pk_index
                if sql_type in MySqlAdapter.GEOMETRY_TYPES:
                    extra = {}
                    if sql_type != "GEOMETRY":
                        extra["geometryType"] = sql_type
                    if srs_id:
                        crs_cur = con.cursor()
                        crs_cur.execute(
                            "SELECT name, definition FROM "
                            "information_schema.st_spatial_reference_systems "
                            "WHERE srs_id = %s",
                            (srs_id,),
                        )
                        row = crs_cur.fetchone()
                        if row:
                            from kart_tpu_torch.crs import get_identifier_str

                            ident = get_identifier_str(row[1]) or f"EPSG:{srs_id}"
                            extra["geometryCRS"] = ident
                            crs_defs[ident] = row[1]
                    data_type_v2, extra_v2 = "geometry", extra
                else:
                    if sql_type in ("VARCHAR", "CHAR") and char_len:
                        sql_type = f"VARCHAR({char_len})"
                    elif sql_type in ("NUMERIC", "DECIMAL") and num_prec:
                        sql_type = (
                            f"NUMERIC({num_prec},{num_scale})"
                            if num_scale
                            else f"NUMERIC({num_prec})"
                        )
                    data_type_v2, extra_v2 = MySqlAdapter.sql_type_to_v2(sql_type)
                cols.append(
                    ColumnSchema(
                        ColumnSchema.deterministic_id(
                            self.table_name, name, data_type_v2
                        ),
                        name,
                        data_type_v2,
                        pk_index,
                        extra_v2,
                    )
                )
            if not cols:
                raise ImportSourceError(
                    f"No such table: {self.dbname}.{self.table_name}"
                )
            self._schema = Schema(cols)
            self._crs_defs = crs_defs
        finally:
            con.close()

    @property
    def schema(self) -> Schema:
        self._load_schema()
        return self._schema

    def crs_definitions(self):
        self._load_schema()
        return dict(self._crs_defs)

    # -- features -------------------------------------------------------------

    @property
    def feature_count(self):
        con = _connect(*self.url_parts)
        try:
            cur = con.cursor()
            cur.execute(
                f"SELECT count(*) FROM "
                f"{MySqlAdapter.quote_table(self.table_name, self.dbname)}"
            )
            return cur.fetchone()[0]
        finally:
            con.close()

    def features(self):
        schema = self.schema
        con = _connect(*self.url_parts)
        try:
            select_cols = ", ".join(
                MySqlAdapter.select_expression(c) for c in schema.columns
            )
            # an unbuffered SSCursor streams from the server; a driver
            # without one gets the buffered cursor
            cursor_cls = None
            try:
                import pymysql.cursors

                cursor_cls = pymysql.cursors.SSCursor
            except (ImportError, AttributeError):
                pass
            cur = con.cursor(cursor_cls) if cursor_cls else con.cursor()
            cur.execute(
                f"SELECT {select_cols} FROM "
                f"{MySqlAdapter.quote_table(self.table_name, self.dbname)}"
            )
            names = [c.name for c in schema.columns]
            while True:
                rows = cur.fetchmany(BATCH_SIZE)
                if not rows:
                    break
                for row in rows:
                    yield {
                        name: MySqlAdapter.value_to_v2(value, col)
                        for name, value, col in zip(names, row, schema.columns)
                    }
        finally:
            con.close()
