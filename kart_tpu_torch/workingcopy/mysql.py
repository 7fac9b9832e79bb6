"""MySQL working copy: one database (``mysql://HOST[:PORT]/DBNAME``; a
MySQL schema is a database) holds the feature tables, ``_kart_state`` and
``_kart_track``. The connection is ``pymysql``'s (else ``MySQLdb``'s),
imported only when connecting.

Counterpart of kart_tpu's ``workingcopy/mysql.py``.
"""

from kart_tpu_torch.adapters.mysql import MySqlAdapter
from kart_tpu_torch.core.repo import NotFound
from kart_tpu_torch.crs import get_identifier_str, normalise_wkt
from kart_tpu_torch.workingcopy.db_server import DatabaseServerWorkingCopy


class MySqlWorkingCopy(DatabaseServerWorkingCopy):
    URI_SCHEME = "mysql"
    URI_PATH_PARTS = 1
    WORKING_COPY_TYPE_NAME = "MySQL"
    ADAPTER = MySqlAdapter
    PARAMSTYLE = "%s"

    def _connect(self):
        driver = None
        try:
            import pymysql as driver
        except ImportError:
            try:
                import MySQLdb as driver
            except ImportError:
                pass
        if driver is None:
            raise NotFound(
                "MySQL working copies require the pymysql (or mysqlclient) "
                "driver, which is not installed in this environment. Use a "
                "GPKG working copy, or install pymysql."
            )
        return driver.connect(
            host=self.host,
            port=self.port or 3306,
            user=self.username,
            password=self.password or "",
        )

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
        return f"DROP DATABASE IF EXISTS {self.ADAPTER.quote(self.db_schema)}"

    def _table_exists(self, con, table):
        cur = self._execute(
            con,
            "SELECT 1 FROM information_schema.tables "
            "WHERE table_schema = %s AND table_name = %s",
            (self.db_schema, table),
        )
        return cur.fetchone() is not None

    def _table_columns(self, con, table):
        """(reference: adapter/mysql.py all_v2_meta_items table query)."""
        cur = self._execute(
            con,
            """
            SELECT C.column_name, C.data_type, C.column_type,
                   C.character_maximum_length, C.numeric_precision,
                   C.numeric_scale, C.column_key, C.srs_id
            FROM information_schema.columns C
            WHERE C.table_schema = %s AND C.table_name = %s
            ORDER BY C.ordinal_position
            """,
            (self.db_schema, table),
        )
        pk_counter = 0
        for (name, data_type, column_type, char_len, num_prec, num_scale,
             column_key, srs_id) in cur.fetchall():
            if isinstance(data_type, bytes):
                data_type = data_type.decode()
            sql_type = (data_type or "").upper()
            pk_index = None
            if column_key == "PRI":
                pk_index = pk_counter
                pk_counter += 1
            if sql_type in self.ADAPTER.GEOMETRY_TYPES:
                info = {}
                if sql_type != "GEOMETRY":
                    info["geometryType"] = sql_type
                if srs_id:
                    crs = self._crs_name_for_srs_id(con, srs_id)
                    if crs:
                        info["geometryCRS"] = crs
                yield name, "GEOMETRY", pk_index, info
                continue
            if sql_type in ("VARCHAR", "CHAR") and char_len:
                sql_type = f"VARCHAR({char_len})"
            elif sql_type == "VARBINARY" and char_len:
                sql_type = f"VARBINARY({char_len})"
            elif sql_type in ("NUMERIC", "DECIMAL") and num_prec:
                sql_type = (
                    f"NUMERIC({num_prec},{num_scale})"
                    if num_scale
                    else f"NUMERIC({num_prec})"
                )
            yield name, sql_type, pk_index, None

    def _crs_name_for_srs_id(self, con, srs_id):
        cur = self._execute(
            con,
            "SELECT organization, organization_coordsys_id "
            "FROM information_schema.st_spatial_reference_systems "
            "WHERE srs_id = %s",
            (srs_id,),
        )
        row = cur.fetchone()
        if row and row[0]:
            return f"{row[0]}:{row[1]}"
        return f"CUSTOM:{srs_id}"

    def _extra_meta_items(self, con, table):
        out = {}
        cur = self._execute(
            con,
            "SELECT SRS.definition FROM information_schema.columns C "
            "INNER JOIN information_schema.st_spatial_reference_systems SRS "
            "ON C.srs_id = SRS.srs_id "
            "WHERE C.table_schema = %s AND C.table_name = %s",
            (self.db_schema, table),
        )
        for (definition,) in cur.fetchall():
            if definition:
                out[f"crs/{get_identifier_str(definition)}.wkt"] = normalise_wkt(
                    definition
                )
        return out

    def _post_write_dataset(self, con, ds, table, crs_id):
        # No spatial index: MySQL requires the geometry column to be made
        # generic GEOMETRY NOT NULL for one, which discards the typed column
        # (geometryType would never roundtrip — a fresh checkout would show a
        # spurious schema edit) and forbids NULL geometries in later edits.
        # The reference skips it for exactly this reason
        # (kart/working_copy/mysql.py:126-133).
        pass
