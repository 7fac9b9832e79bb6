"""PostgreSQL/PostGIS import source over ``psycopg2``, streamed by a
server-side cursor. The driver is imported only when connecting; without it
the import raises :class:`~kart_tpu_torch.core.repo.NotFound`. The spec:

    postgresql://HOST[:PORT]/DBNAME[/DBSCHEMA[/TABLE]]

Without a table every table of the schema (default ``public``) that has a
primary key is imported.

Counterpart of kart_tpu's ``importer/postgres.py``.
"""

from urllib.parse import unquote, urlsplit

from kart_tpu_torch.adapters.postgis import PostgisAdapter
from kart_tpu_torch.core.repo import NotFound
from kart_tpu_torch.importer import ImportSource, ImportSourceError
from kart_tpu_torch.models.schema import ColumnSchema, Schema

BATCH_SIZE = 10_000


def _connect(host, port, dbname, user, password):
    try:
        import psycopg2
    except ImportError:
        raise NotFound(
            "PostgreSQL imports require the psycopg2 driver, which is not "
            "installed in this environment."
        )
    return psycopg2.connect(
        host=host, port=port or 5432, dbname=dbname, user=user,
        password=password,
    )


class PostgresImportSource(ImportSource):
    def __init__(self, url_parts, db_schema, table_name, dest_path=None):
        self.url_parts = url_parts  # (host, port, dbname, user, password)
        self.db_schema = db_schema
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
                "Expecting postgresql://HOST[:PORT]/DBNAME[/DBSCHEMA[/TABLE]]"
            )
        dbname = parts[0]
        db_schema = parts[1] if len(parts) > 1 else "public"
        table = parts[2] if len(parts) > 2 else None
        conn_parts = (
            url.hostname,
            url.port,
            dbname,
            unquote(url.username) if url.username else None,
            unquote(url.password) if url.password else None,
        )
        return conn_parts, db_schema, table

    @classmethod
    def open_all(cls, spec, table=None):
        conn_parts, db_schema, spec_table = cls.parse_spec(spec)
        table = table or spec_table
        if table is not None:
            return [cls(conn_parts, db_schema, table)]
        con = _connect(*conn_parts)
        try:
            cur = con.cursor()
            cur.execute(
                """
                SELECT DISTINCT TC.table_name
                FROM information_schema.table_constraints TC
                WHERE TC.constraint_type = 'PRIMARY KEY'
                AND TC.table_schema = %s
                ORDER BY TC.table_name
                """,
                (db_schema,),
            )
            tables = [row[0] for row in cur.fetchall()]
        finally:
            con.close()
        if not tables:
            raise ImportSourceError(
                f"No tables with primary keys found in schema {db_schema!r}"
            )
        return [cls(conn_parts, db_schema, t) for t in tables]

    # -- schema ---------------------------------------------------------------

    def _load_schema(self):
        if self._schema is not None:
            return
        con = _connect(*self.url_parts)
        try:
            # shared information_schema reader: same server dialect, same
            # V2 mapping as the PostGIS working copy
            from kart_tpu_torch.workingcopy.postgis import read_table_columns

            cols = []
            for name, sql_type, pk_index, geom_info in read_table_columns(
                con, self.db_schema, self.table_name
            ):
                if geom_info is not None:
                    data_type, extra = "geometry", dict(geom_info)
                else:
                    data_type, extra = PostgisAdapter.sql_type_to_v2(sql_type)
                cols.append(
                    ColumnSchema(
                        ColumnSchema.deterministic_id(
                            self.table_name, name, data_type
                        ),
                        name,
                        data_type,
                        pk_index,
                        extra,
                    )
                )
            if not cols:
                raise ImportSourceError(
                    f"No such table: {self.db_schema}.{self.table_name}"
                )
            self._schema = Schema(cols)
            self._crs_defs = {}
            cur = con.cursor()
            cur.execute(
                "SELECT SRS.srtext FROM geometry_columns GC "
                "INNER JOIN spatial_ref_sys SRS ON GC.srid = SRS.srid "
                "WHERE GC.f_table_schema = %s AND GC.f_table_name = %s",
                (self.db_schema, self.table_name),
            )
            from kart_tpu_torch.crs import get_identifier_str

            for (srtext,) in cur.fetchall():
                if srtext:
                    self._crs_defs[get_identifier_str(srtext)] = srtext
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
                f"{PostgisAdapter.quote_table(self.table_name, self.db_schema)}"
            )
            return cur.fetchone()[0]
        finally:
            con.close()

    def features(self):
        schema = self.schema
        con = _connect(*self.url_parts)
        try:
            select_cols = ", ".join(
                PostgisAdapter.select_expression(c) for c in schema.columns
            )
            # named cursor = server-side: streams without materialising
            cur = con.cursor(name="kart_import")
            cur.itersize = BATCH_SIZE
            cur.execute(
                f"SELECT {select_cols} FROM "
                f"{PostgisAdapter.quote_table(self.table_name, self.db_schema)}"
            )
            names = [c.name for c in schema.columns]
            for row in cur:
                yield {
                    name: PostgisAdapter.value_to_v2(value, col)
                    for name, value, col in zip(names, row, schema.columns)
                }
        finally:
            con.close()
