"""MySQL adapter. Geometry goes as WKB through ``ST_GeomFromWKB(?, srid,
'axis-order=long-lat')`` and comes back through ``ST_AsBinary(col,
'axis-order=long-lat')``; ``interval`` is stored as TEXT; text and blob get
VARCHAR/VARBINARY(length) where the length fits, else LONGTEXT/LONGBLOB.

Counterpart of kart_tpu's ``adapters/mysql.py``.
"""

from kart_tpu_torch.adapters.base import KART_STATE, KART_TRACK, BaseAdapter
from kart_tpu_torch.geometry import Geometry
from kart_tpu_torch.models.schema import ColumnSchema

# Max length usable in VARCHAR/VARBINARY given MySQL's 65535-byte row limit
# (reference: adapter/mysql.py _MAX_SPECIFIABLE_LENGTH).
MAX_SPECIFIABLE_LENGTH = 0xFFFF

_TEXT_AND_BLOB_PREFIXES = ("TINY", "MEDIUM", "LONG")


class MySqlAdapter(BaseAdapter):
    QUOTE_CHAR = "`"

    V2_TYPE_TO_SQL = {
        "boolean": "BIT",
        "blob": "LONGBLOB",
        "date": "DATE",
        "float": {0: "FLOAT", 32: "FLOAT", 64: "DOUBLE PRECISION"},
        "geometry": "GEOMETRY",
        "integer": {0: "INT", 8: "TINYINT", 16: "SMALLINT", 32: "INT", 64: "BIGINT"},
        "interval": "TEXT",
        "numeric": "NUMERIC",
        "text": "LONGTEXT",
        "time": "TIME",
        "timestamp": {"UTC": "TIMESTAMP", None: "DATETIME"},
    }

    SQL_TYPE_TO_V2 = {
        "BIT": "boolean",
        "TINYINT": ("integer", 8),
        "SMALLINT": ("integer", 16),
        "INT": ("integer", 32),
        "INTEGER": ("integer", 32),
        "BIGINT": ("integer", 64),
        "FLOAT": ("float", 32),
        "DOUBLE": ("float", 64),
        "DOUBLE PRECISION": ("float", 64),
        "BINARY": "blob",
        "BLOB": "blob",
        "CHAR": "text",
        "DATE": "date",
        "DATETIME": ("timestamp", None),
        "DECIMAL": "numeric",
        "GEOMETRY": "geometry",
        "NUMERIC": "numeric",
        "TEXT": "text",
        "TIME": "time",
        "TIMESTAMP": ("timestamp", "UTC"),
        "VARCHAR": "text",
        "VARBINARY": "blob",
        **{f"{p}TEXT": "text" for p in _TEXT_AND_BLOB_PREFIXES},
        **{f"{p}BLOB": "blob" for p in _TEXT_AND_BLOB_PREFIXES},
    }

    APPROXIMATED_TYPES = {"interval": "text"}
    APPROXIMATED_TYPES_EXTRA_TYPE_INFO = ("length",)

    GEOMETRY_TYPES = {
        "GEOMETRY", "POINT", "LINESTRING", "POLYGON",
        "MULTIPOINT", "MULTILINESTRING", "MULTIPOLYGON", "GEOMETRYCOLLECTION",
    }

    @classmethod
    def v2_type_to_sql_type(cls, col: ColumnSchema, crs_id=None):
        extra = col.extra_type_info
        if col.data_type == "geometry":
            gtype = (extra.get("geometryType") or "GEOMETRY").split(" ")[0].upper()
            result = gtype if gtype in cls.GEOMETRY_TYPES else "GEOMETRY"
            if crs_id is not None:
                result += f" SRID {crs_id}"
            return result
        if col.data_type in ("text", "blob"):
            length = extra.get("length")
            if length and 0 < length <= MAX_SPECIFIABLE_LENGTH:
                return (
                    f"VARCHAR({length})"
                    if col.data_type == "text"
                    else f"VARBINARY({length})"
                )
            return super().v2_type_to_sql_type(col, crs_id=crs_id)
        if col.data_type == "numeric":
            precision, scale = extra.get("precision"), extra.get("scale")
            if precision is not None and scale is not None:
                return f"NUMERIC({precision},{scale})"
            if precision is not None:
                return f"NUMERIC({precision})"
            return "NUMERIC"
        return super().v2_type_to_sql_type(col, crs_id=crs_id)

    @classmethod
    def v2_column_schema_to_sql_spec(cls, col, *, has_int_pk=False, crs_id=None):
        spec = f"{cls.quote(col.name)} {cls.v2_type_to_sql_type(col, crs_id=crs_id)}"
        if has_int_pk and col.pk_index is not None:
            spec += " AUTO_INCREMENT"
        return spec

    @classmethod
    def sql_type_to_v2(cls, sql_type):
        upper = (sql_type or "").strip().upper()
        base = upper.split("(")[0].strip()
        if base in cls.GEOMETRY_TYPES:
            extra = {} if base == "GEOMETRY" else {"geometryType": base}
            return "geometry", extra
        return super().sql_type_to_v2(sql_type)

    # -- value conversion ----------------------------------------------------

    @classmethod
    def value_from_v2(cls, value, col, *, crs_id=0):
        if value is None:
            return None
        if col.data_type == "geometry":
            return Geometry.of(value).to_wkb()
        if col.data_type == "boolean":
            return int(value)
        if col.data_type == "blob":
            return bytes(value)
        return value

    @classmethod
    def value_to_v2(cls, value, col):
        if value is None:
            return None
        t = col.data_type
        if t == "geometry":
            if isinstance(value, memoryview):
                value = bytes(value)
            return Geometry.from_wkb(value).normalised()
        if t == "boolean":
            if isinstance(value, (bytes, bytearray)):  # BIT(1) comes back as b'\x00'/b'\x01'
                return bool(value[0]) if value else False
            return bool(value)
        if t == "blob":
            return bytes(value) if isinstance(value, memoryview) else value
        if t == "timestamp":
            from kart_tpu_torch.adapters.base import timestamp_to_v2

            return timestamp_to_v2(value, col)
        if t in ("date", "time"):
            return str(value)
        if t == "numeric":
            return str(value)
        return value

    @classmethod
    def insert_placeholder(cls, col, crs_id=0):
        if col.data_type == "geometry":
            return f"ST_GeomFromWKB(%s, {int(crs_id)}, 'axis-order=long-lat')"
        return "%s"

    @classmethod
    def select_expression(cls, col):
        if col.data_type == "geometry":
            q = cls.quote(col.name)
            return f"ST_AsBinary({q}, 'axis-order=long-lat') AS {q}"
        return cls.quote(col.name)

    # -- working-copy infrastructure SQL -------------------------------------
    # MySQL has no cross-database triggers and a "schema" IS a database; the
    # working copy is one database holding feature tables + kart tables
    # (reference: working_copy/mysql.py — db_schema is the database).

    @classmethod
    def base_ddl(cls, db_schema):
        state = cls.quote_table(KART_STATE, db_schema)
        track = cls.quote_table(KART_TRACK, db_schema)
        return [
            f"CREATE DATABASE IF NOT EXISTS {cls.quote(db_schema)}",
            f"""CREATE TABLE IF NOT EXISTS {state} (
                table_name VARCHAR(255) NOT NULL, `key` VARCHAR(255) NOT NULL,
                value TEXT, PRIMARY KEY (table_name, `key`))""",
            f"""CREATE TABLE IF NOT EXISTS {track} (
                table_name VARCHAR(255) NOT NULL, pk VARCHAR(400),
                PRIMARY KEY (table_name, pk))""",
        ]

    @classmethod
    def create_trigger_sql(cls, db_schema, table_name, pk_name):
        """Three triggers, one per operation (reference:
        working_copy/mysql.py:163-202). Returned as a list."""
        track = cls.quote_table(KART_TRACK, db_schema)
        tbl = cls.quote_table(table_name, db_schema)
        pk = cls.quote(pk_name)
        name_lit = cls.string_literal(table_name)

        def trig(suffix):
            return cls.quote_table(f"_kart_track_{table_name}_{suffix}", db_schema)

        return [
            f"CREATE TRIGGER {trig('ins')} AFTER INSERT ON {tbl} FOR EACH ROW "
            f"REPLACE INTO {track} (table_name, pk) VALUES ({name_lit}, NEW.{pk})",
            f"CREATE TRIGGER {trig('upd')} AFTER UPDATE ON {tbl} FOR EACH ROW "
            f"REPLACE INTO {track} (table_name, pk) "
            f"VALUES ({name_lit}, OLD.{pk}), ({name_lit}, NEW.{pk})",
            f"CREATE TRIGGER {trig('del')} AFTER DELETE ON {tbl} FOR EACH ROW "
            f"REPLACE INTO {track} (table_name, pk) VALUES ({name_lit}, OLD.{pk})",
        ]

    @classmethod
    def drop_trigger_sql(cls, db_schema, table_name):
        return [
            f"DROP TRIGGER IF EXISTS "
            f"{cls.quote_table(f'_kart_track_{table_name}_{suffix}', db_schema)}"
            for suffix in ("ins", "upd", "del")
        ]

    # MySQL can't disable triggers: suspend == drop, resume == recreate.
    suspend_trigger_sql = drop_trigger_sql

    @classmethod
    def resume_trigger_sql(cls, db_schema, table_name, pk_name):
        return cls.create_trigger_sql(db_schema, table_name, pk_name)

    @classmethod
    def register_crs_sql(cls, crs_id, auth_name, auth_code, wkt):
        """MySQL 8 ships EPSG definitions; only custom SRSes need CREATE
        SPATIAL REFERENCE SYSTEM (WKT must be WKT2/ESRI-style — handled by the
        working copy which may skip unsupported defs)."""
        return (
            f"CREATE SPATIAL REFERENCE SYSTEM IF NOT EXISTS {int(crs_id)} "
            f"NAME %s DEFINITION %s",
            (f"{auth_name}:{auth_code}", wkt),
        )

    @classmethod
    def upsert_sql(cls, db_schema, table_name, col_names, pk_names, *, crs_id=0,
                   schema=None):
        tbl = cls.quote_table(table_name, db_schema)
        cols = ", ".join(cls.quote(c) for c in col_names)
        by_name = {c.name: c for c in schema.columns} if schema is not None else {}
        values = ", ".join(
            cls.insert_placeholder(by_name[c], crs_id) if c in by_name else "%s"
            for c in col_names
        )
        return f"REPLACE INTO {tbl} ({cols}) VALUES ({values})"
