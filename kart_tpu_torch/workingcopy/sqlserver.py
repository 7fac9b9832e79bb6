"""SQL Server working copy: one schema
(``mssql://HOST[:PORT]/DBNAME/DBSCHEMA``) holds the feature tables,
``_kart_state`` and ``_kart_track``. The connection is ``pyodbc``'s over the
Microsoft ODBC driver, imported only when connecting.

Counterpart of kart_tpu's ``workingcopy/sqlserver.py``.
"""

import logging

from kart_tpu_torch.adapters.sqlserver import SqlServerAdapter
from kart_tpu_torch.core.repo import NotFound
from kart_tpu_torch.workingcopy.db_server import DatabaseServerWorkingCopy


class SqlServerWorkingCopy(DatabaseServerWorkingCopy):
    URI_SCHEME = "mssql"
    URI_PATH_PARTS = 2
    WORKING_COPY_TYPE_NAME = "SQL Server"
    ADAPTER = SqlServerAdapter
    PARAMSTYLE = "?"

    def _connect(self):
        try:
            import pyodbc
        except ImportError:
            raise NotFound(
                "SQL Server working copies require the pyodbc driver and the "
                "Microsoft ODBC driver for SQL Server, which are not installed "
                "in this environment. Use a GPKG working copy, or install them."
            )
        server = self.host or "localhost"
        if self.port:
            server = f"{server},{self.port}"
        parts = [
            "DRIVER={ODBC Driver 17 for SQL Server}",
            f"SERVER={server}",
            f"DATABASE={self.db_name}",
        ]
        if self.username:
            parts.append(f"UID={self.username}")
            parts.append(f"PWD={self.password or ''}")
        else:
            parts.append("Trusted_Connection=yes")
        return pyodbc.connect(";".join(parts))

    def _schema_exists(self, con):
        cur = self._execute(
            con,
            "SELECT 1 FROM sys.schemas WHERE name = ?",
            (self.db_schema,),
        )
        return cur.fetchone() is not None

    def _has_feature_tables(self, con):
        cur = self._execute(
            con,
            "SELECT count(*) FROM information_schema.tables "
            "WHERE table_schema = ? AND table_name NOT LIKE '[_]kart[_]%'",
            (self.db_schema,),
        )
        return cur.fetchone()[0] > 0

    def _drop_container_sql(self):
        # SQL Server has no DROP SCHEMA CASCADE; tables must go first. This
        # statement drops all tables in the schema then the schema itself.
        return f"""
            DECLARE @sql NVARCHAR(max) = '';
            SELECT @sql = @sql + 'DROP TABLE ' + QUOTENAME(table_schema)
                + '.' + QUOTENAME(table_name) + ';'
            FROM information_schema.tables
            WHERE table_schema = {self.ADAPTER.string_literal(self.db_schema)};
            EXEC sp_executesql @sql;
            DROP SCHEMA IF EXISTS {self.ADAPTER.quote(self.db_schema)};
        """

    def _table_exists(self, con, table):
        cur = self._execute(
            con,
            "SELECT 1 FROM information_schema.tables "
            "WHERE table_schema = ? AND table_name = ?",
            (self.db_schema, table),
        )
        return cur.fetchone() is not None

    def _table_columns(self, con, table):
        """(reference: adapter/sqlserver.py all_v2_meta_items table query).
        Geometry columns show up with data_type GEOMETRY; their SRID lives on
        the values, sampled from the first row."""
        cur = self._execute(
            con,
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
            (self.db_schema, table),
        )
        for (name, data_type, char_len, num_prec, num_scale,
             pk_pos) in cur.fetchall():
            pk_index = pk_pos - 1 if pk_pos is not None else None
            sql_type = (data_type or "").upper()
            if sql_type in ("GEOMETRY", "GEOGRAPHY"):
                yield name, "GEOMETRY", pk_index, {}
                continue
            if sql_type in ("NVARCHAR", "VARCHAR", "NCHAR", "CHAR") and char_len and char_len > 0:
                sql_type = f"{sql_type}({char_len})"
            elif sql_type == "VARBINARY" and char_len and char_len > 0:
                sql_type = f"VARBINARY({char_len})"
            elif sql_type in ("NUMERIC", "DECIMAL") and num_prec:
                sql_type = (
                    f"NUMERIC({num_prec},{num_scale})"
                    if num_scale
                    else f"NUMERIC({num_prec})"
                )
            yield name, sql_type, pk_index, None

    # SQL Server stores no CRS definitions at all — only SRIDs on values —
    # so geometryCRS and crs/*.wkt can't roundtrip (reference:
    # adapter/sqlserver.py "geometryType is not roundtripped" note).
    UNSUPPORTED_META_ITEMS = (
        "title", "description", "metadata.xml",
    )

    def _diff_meta(self, con, dataset, table):
        out = super()._diff_meta(con, dataset, table)
        # geometry extra info (type/CRS) doesn't roundtrip: suppress
        # schema-only deltas whose every change is on geometry extras
        if "schema.json" in out:
            delta = out["schema.json"]
            if delta.old is not None and delta.new is not None:
                old_cols = delta.old_value
                new_cols = delta.new_value
                if self._same_modulo_geometry_extras(old_cols, new_cols):
                    del out["schema.json"]
        return out

    @staticmethod
    def _same_modulo_geometry_extras(old_cols, new_cols):
        if len(old_cols) != len(new_cols):
            return False
        strip = ("geometryType", "geometryCRS")
        for o, n in zip(old_cols, new_cols):
            if o.get("dataType") == "geometry" and n.get("dataType") == "geometry":
                o = {k: v for k, v in o.items() if k not in strip}
                n = {k: v for k, v in n.items() if k not in strip}
            if o != n:
                return False
        return True

    def _post_write_dataset(self, con, ds, table, crs_id):
        schema = ds.schema
        geom_col = schema.first_geometry_column
        if geom_col is not None and schema.pk_columns:
            # spatial index needs an explicit bounding box; use the dataset
            # extent when available, else the whole world in the dataset CRS
            try:
                self._execute(
                    con,
                    f'CREATE SPATIAL INDEX "{table}_idx_geom" ON '
                    f"{self._table_identifier(table)} "
                    f"({self.ADAPTER.quote(geom_col.name)}) "
                    f"WITH (BOUNDING_BOX = (-180, -90, 180, 90))",
                )
            except Exception as e:
                # the index is an optimisation; the data is already correct
                # (common cause: restricted CREATE INDEX permissions)
                logging.getLogger(__name__).debug(
                    "spatial index on %s not created: %s", table, e
                )
