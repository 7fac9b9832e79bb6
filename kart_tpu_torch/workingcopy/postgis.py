"""PostGIS working copy: one PostgreSQL schema holds the feature tables,
``_kart_state``, ``_kart_track`` and the tracking trigger procedure. The
connection is ``psycopg2``'s, imported only when connecting.

Counterpart of kart_tpu's ``workingcopy/postgis.py``.
"""

from kart_tpu_torch.adapters.postgis import PostgisAdapter
from kart_tpu_torch.core.repo import NotFound
from kart_tpu_torch.crs import get_identifier_str, normalise_wkt
from kart_tpu_torch.workingcopy.db_server import DatabaseServerWorkingCopy


def read_table_columns(con, db_schema, table):
    """information_schema + geometry_columns -> (name, sql_type, pk_index,
    geom_info) per column. Shared by the working copy and the Postgres
    import source (reference: adapter/postgis.py:146-180 table_info_sql)."""
    cur = con.cursor()
    cur.execute(
        """
        SELECT C.column_name, C.data_type, C.udt_name,
               C.character_maximum_length, C.numeric_precision, C.numeric_scale,
               PK.ordinal_position AS pk_ordinal_position
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
        WHERE C.table_schema = %s AND C.table_name = %s
        ORDER BY C.ordinal_position
        """,
        (db_schema, table),
    )
    col_rows = cur.fetchall()
    geom_cols = {}
    cur.execute(
        "SELECT GC.f_geometry_column, GC.type, GC.srid, SRS.srtext "
        "FROM geometry_columns GC "
        "LEFT OUTER JOIN spatial_ref_sys SRS ON GC.srid = SRS.srid "
        "WHERE GC.f_table_schema = %s AND GC.f_table_name = %s",
        (db_schema, table),
    )
    for (col_name, gtype, srid, srtext) in cur.fetchall():
        info = {}
        if gtype and gtype.upper() != "GEOMETRY":
            info["geometryType"] = gtype.upper()
        if srtext:
            info["geometryCRS"] = get_identifier_str(srtext)
        geom_cols[col_name] = info

    for (name, data_type, udt_name, char_len, num_prec, num_scale,
         pk_pos) in col_rows:
        pk_index = pk_pos - 1 if pk_pos is not None else None
        if name in geom_cols:
            yield name, "GEOMETRY", pk_index, geom_cols[name]
            continue
        sql_type = (data_type or "").upper()
        if sql_type not in PostgisAdapter.SQL_TYPE_TO_V2:
            sql_type = (udt_name or "").upper()
        if sql_type in ("CHARACTER VARYING", "VARCHAR") and char_len:
            sql_type = f"VARCHAR({char_len})"
        elif sql_type in ("NUMERIC", "DECIMAL") and num_prec:
            sql_type = (
                f"NUMERIC({num_prec},{num_scale})"
                if num_scale
                else f"NUMERIC({num_prec})"
            )
        yield name, sql_type, pk_index, None


class PostgisWorkingCopy(DatabaseServerWorkingCopy):
    URI_SCHEME = "postgresql"
    URI_PATH_PARTS = 2
    WORKING_COPY_TYPE_NAME = "PostGIS"
    ADAPTER = PostgisAdapter
    PARAMSTYLE = "%s"

    def _connect(self):
        try:
            import psycopg2
        except ImportError:
            raise NotFound(
                "PostGIS working copies require the psycopg2 driver, which is "
                "not installed in this environment. Use a GPKG working copy, "
                "or install psycopg2."
            )
        con = psycopg2.connect(
            host=self.host,
            port=self.port or 5432,
            dbname=self.db_name,
            user=self.username,
            password=self.password,
        )
        # intervals must stringify as ISO-8601 durations — the only form the
        # V2 schema accepts (reference: sqlalchemy/postgis.py:18)
        with con.cursor() as cur:
            cur.execute("SET intervalstyle = 'iso_8601'")
        return con

    def _schema_exists(self, con):
        cur = self._execute(
            con,
            "SELECT 1 FROM information_schema.schemata WHERE schema_name = %s",
            (self.db_schema,),
        )
        return cur.fetchone() is not None

    def _has_feature_tables(self, con):
        cur = self._execute(
            con,
            "SELECT count(*) FROM information_schema.tables "
            "WHERE table_schema = %s AND table_name NOT LIKE '\\_kart\\_%%'",
            (self.db_schema,),
        )
        return cur.fetchone()[0] > 0

    def _drop_container_sql(self):
        return f"DROP SCHEMA IF EXISTS {self.ADAPTER.quote(self.db_schema)} CASCADE"

    def _table_exists(self, con, table):
        cur = self._execute(
            con,
            "SELECT 1 FROM information_schema.tables "
            "WHERE table_schema = %s AND table_name = %s",
            (self.db_schema, table),
        )
        return cur.fetchone() is not None

    def _table_columns(self, con, table):
        return read_table_columns(con, self.db_schema, table)

    def _extra_meta_items(self, con, table):
        out = {}
        cur = self._execute(
            con,
            "SELECT SRS.srtext FROM geometry_columns GC "
            "INNER JOIN spatial_ref_sys SRS ON GC.srid = SRS.srid "
            "WHERE GC.f_table_schema = %s AND GC.f_table_name = %s",
            (self.db_schema, table),
        )
        for (srtext,) in cur.fetchall():
            if srtext:
                out[f"crs/{get_identifier_str(srtext)}.wkt"] = normalise_wkt(srtext)
        return out

    def _post_write_dataset(self, con, ds, table, crs_id):
        schema = ds.schema
        geom_col = schema.first_geometry_column
        if geom_col is not None:
            # GiST spatial index (reference: postgis.py write_meta)
            self._execute(
                con,
                f'CREATE INDEX IF NOT EXISTS "{table}_idx_geom" ON '
                f"{self._table_identifier(table)} USING GIST "
                f"({self.ADAPTER.quote(geom_col.name)})",
            )
        pk_cols = schema.pk_columns
        if len(pk_cols) == 1 and pk_cols[0].data_type == "integer":
            # align the SERIAL sequence past existing pks
            q_pk = self.ADAPTER.quote(pk_cols[0].name)
            tbl = self._table_identifier(table)
            self._execute(
                con,
                f"SELECT setval(pg_get_serial_sequence(%s, %s), "
                f"(SELECT COALESCE(MAX({q_pk}), 0) + 1 FROM {tbl}), false)",
                (tbl, pk_cols[0].name),
            )
