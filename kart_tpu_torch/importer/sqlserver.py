"""SQL Server import source over ``pyodbc``, read in ``fetchmany``
batches. The driver is imported only when connecting; without it the import
raises :class:`~kart_tpu_torch.core.repo.NotFound`. The spec:

    mssql://HOST[:PORT]/DBNAME[/DBSCHEMA[/TABLE]]

Without a table every table of the schema (default ``dbo``) that has a
primary key is imported. SQL Server keeps SRIDs on values only, so one
value's ``STSrid`` is sampled per geometry column: the column's CRS is
``EPSG:<srid>``, with the EPSG registry's WKT where it knows the code.

Counterpart of kart_tpu's ``importer/sqlserver.py``.
"""

from urllib.parse import unquote, urlsplit

from kart_tpu_torch.adapters.sqlserver import SqlServerAdapter
from kart_tpu_torch.core.repo import NotFound
from kart_tpu_torch.importer import ImportSource, ImportSourceError
from kart_tpu_torch.models.schema import ColumnSchema, Schema

BATCH_SIZE = 10_000


def _connect(host, port, dbname, user, password):
    try:
        import pyodbc
    except ImportError:
        raise NotFound(
            "SQL Server imports require the pyodbc driver, which is not "
            "installed in this environment."
        )
    server = f"{host},{port}" if port else host
    parts = [
        "DRIVER={ODBC Driver 17 for SQL Server}",
        f"SERVER={server}",
        f"DATABASE={dbname}",
    ]
    if user:
        parts.append(f"UID={user}")
        parts.append(f"PWD={password or ''}")
    else:
        parts.append("Trusted_Connection=yes")
    return pyodbc.connect(";".join(parts))


class SqlServerImportSource(ImportSource):
    def __init__(self, url_parts, db_schema, table_name, dest_path=None):
        self.url_parts = url_parts  # (host, port, dbname, user, password)
        self.db_schema = db_schema
        self.table_name = table_name
        self.dest_path = dest_path or table_name
        self._schema = None
        self._crs_defs = {}

    @classmethod
    def parse_spec(cls, spec):
        url = urlsplit(spec)
        parts = [unquote(p) for p in url.path.split("/") if p]
        if not parts:
            raise ImportSourceError(
                "Expecting mssql://HOST[:PORT]/DBNAME[/DBSCHEMA[/TABLE]]"
            )
        dbname = parts[0]
        db_schema = parts[1] if len(parts) > 1 else "dbo"
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
                AND TC.table_schema = ?
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
            cur = con.cursor()
            cur.execute(
                """
                SELECT C.column_name, C.data_type,
                       C.character_maximum_length, C.numeric_precision,
                       C.numeric_scale, PK.ordinal_position
                FROM information_schema.columns C
                LEFT OUTER JOIN (
                    SELECT KCU.table_schema, KCU.table_name, KCU.column_name,
                           KCU.ordinal_position
                    FROM information_schema.key_column_usage KCU
                    INNER JOIN information_schema.table_constraints TC
                    ON KCU.constraint_schema = TC.constraint_schema
                    AND KCU.constraint_name = TC.constraint_name
                    WHERE TC.constraint_type = 'PRIMARY KEY'
                ) PK ON PK.table_schema = C.table_schema
                    AND PK.table_name = C.table_name
                    AND PK.column_name = C.column_name
                WHERE C.table_schema = ? AND C.table_name = ?
                ORDER BY C.ordinal_position
                """,
                (self.db_schema, self.table_name),
            )
            cols = []
            for (name, data_type, char_len, num_prec, num_scale,
                 pk_pos) in cur.fetchall():
                pk_index = pk_pos - 1 if pk_pos is not None else None
                sql_type = (data_type or "").upper()
                if sql_type in ("GEOMETRY", "GEOGRAPHY"):
                    # SQL Server stores SRIDs only on values — sample one so
                    # the imported column keeps its CRS identity (the
                    # reference records EPSG:<srid> the same way)
                    data_type_v2, extra = "geometry", {}
                    srid = self._sample_srid(con, name)
                    if srid:
                        ident = f"EPSG:{srid}"
                        extra = {"geometryCRS": ident}
                        # SQL Server stores no WKT bodies; synthesise one
                        # from the registry so checkout keeps the CRS
                        from kart_tpu_torch.epsg import epsg_wkt

                        wkt = epsg_wkt(srid)
                        if wkt:
                            self._crs_defs[ident] = wkt
                else:
                    if (
                        sql_type in ("NVARCHAR", "VARCHAR", "NCHAR", "CHAR")
                        and char_len
                        and char_len > 0
                    ):
                        sql_type = f"{sql_type}({char_len})"
                    elif sql_type in ("NUMERIC", "DECIMAL") and num_prec:
                        sql_type = (
                            f"NUMERIC({num_prec},{num_scale})"
                            if num_scale
                            else f"NUMERIC({num_prec})"
                        )
                    data_type_v2, extra = SqlServerAdapter.sql_type_to_v2(
                        sql_type
                    )
                cols.append(
                    ColumnSchema(
                        ColumnSchema.deterministic_id(
                            self.table_name, name, data_type_v2
                        ),
                        name,
                        data_type_v2,
                        pk_index,
                        extra,
                    )
                )
            if not cols:
                raise ImportSourceError(
                    f"No such table: {self.db_schema}.{self.table_name}"
                )
            self._schema = Schema(cols)
        finally:
            con.close()

    def _sample_srid(self, con, col_name):
        """SRID of the first non-NULL value in a geometry/geography column,
        or 0/None when the table is empty or the query fails."""
        q = SqlServerAdapter.quote(col_name)
        try:
            cur = con.cursor()
            cur.execute(
                f"SELECT TOP 1 {q}.STSrid FROM "
                f"{SqlServerAdapter.quote_table(self.table_name, self.db_schema)} "
                f"WHERE {q} IS NOT NULL"
            )
            row = cur.fetchone()
        except Exception:
            return None
        return int(row[0]) if row and row[0] else None

    @property
    def schema(self) -> Schema:
        self._load_schema()
        return self._schema

    def crs_definitions(self):
        # SQL Server stores no CRS definitions, only SRIDs on values — the
        # definitions here are registry-synthesised from the sampled SRID
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
                f"{SqlServerAdapter.quote_table(self.table_name, self.db_schema)}"
            )
            return cur.fetchone()[0]
        finally:
            con.close()

    def features(self):
        schema = self.schema
        con = _connect(*self.url_parts)
        try:
            select_cols = ", ".join(
                SqlServerAdapter.select_expression(c) for c in schema.columns
            )
            cur = con.cursor()
            cur.execute(
                f"SELECT {select_cols} FROM "
                f"{SqlServerAdapter.quote_table(self.table_name, self.db_schema)}"
            )
            names = [c.name for c in schema.columns]
            while True:
                rows = cur.fetchmany(BATCH_SIZE)
                if not rows:
                    break
                for row in rows:
                    yield {
                        name: SqlServerAdapter.value_to_v2(value, col)
                        for name, value, col in zip(names, row, schema.columns)
                    }
        finally:
            con.close()
