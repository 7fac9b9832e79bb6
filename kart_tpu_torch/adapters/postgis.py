"""PostGIS adapter. Geometry goes to the server as hex EWKB (the SRID
embedded, cast to ``geometry``) and comes back through ``ST_AsEWKB``. int8
is stored as SMALLINT (PostgreSQL has no 1-byte integer), which the
roundtrip policy restores.

Counterpart of kart_tpu's ``adapters/postgis.py``.
"""

from kart_tpu_torch.adapters.base import KART_STATE, KART_TRACK, BaseAdapter
from kart_tpu_torch.geometry import Geometry
from kart_tpu_torch.models.schema import ColumnSchema


class PostgisAdapter(BaseAdapter):
    V2_TYPE_TO_SQL = {
        "boolean": "BOOLEAN",
        "blob": "BYTEA",
        "date": "DATE",
        "float": {0: "REAL", 32: "REAL", 64: "DOUBLE PRECISION"},
        "geometry": "GEOMETRY",
        "integer": {0: "INTEGER", 8: "SMALLINT", 16: "SMALLINT", 32: "INTEGER", 64: "BIGINT"},
        "interval": "INTERVAL",
        "numeric": "NUMERIC",
        "text": "TEXT",
        "time": "TIME",
        "timestamp": {"UTC": "TIMESTAMPTZ", None: "TIMESTAMP"},
    }

    SQL_TYPE_TO_V2 = {
        "BOOLEAN": "boolean",
        "SMALLINT": ("integer", 16),
        "INTEGER": ("integer", 32),
        "BIGINT": ("integer", 64),
        "REAL": ("float", 32),
        "DOUBLE PRECISION": ("float", 64),
        "BYTEA": "blob",
        "CHARACTER VARYING": "text",
        "DATE": "date",
        "GEOMETRY": "geometry",
        "INTERVAL": "interval",
        "NUMERIC": "numeric",
        "TEXT": "text",
        "TIME": "time",
        "TIMETZ": "time",
        "TIMESTAMP": ("timestamp", None),
        "TIMESTAMPTZ": ("timestamp", "UTC"),
        "VARCHAR": "text",
    }

    APPROXIMATED_TYPES = {("integer", 8): ("integer", 16)}
    APPROXIMATED_TYPES_EXTRA_TYPE_INFO = ("size",)

    @classmethod
    def v2_type_to_sql_type(cls, col: ColumnSchema, crs_id=None):
        extra = col.extra_type_info
        if col.data_type == "geometry":
            gtype = (extra.get("geometryType") or "GEOMETRY").replace(" ", "")
            if gtype == "GEOMETRY" and crs_id is None:
                return "GEOMETRY"
            if crs_id is None:
                return f"GEOMETRY({gtype})"
            return f"GEOMETRY({gtype},{crs_id})"
        if col.data_type == "text":
            length = extra.get("length")
            return f"VARCHAR({length})" if length else "TEXT"
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
        sql_type = cls.v2_type_to_sql_type(col, crs_id=crs_id)
        if has_int_pk and col.pk_index is not None:
            # SMALLINT/INTEGER/BIGINT -> SMALLSERIAL/SERIAL/BIGSERIAL
            # (reference: adapter/postgis.py:80-87)
            import re

            sql_type = re.sub("INT(EGER)?", "SERIAL", sql_type)
        return f"{cls.quote(col.name)} {sql_type}"

    # -- value conversion ----------------------------------------------------

    @classmethod
    def value_from_v2(cls, value, col, *, crs_id=0):
        if value is None:
            return None
        if col.data_type == "geometry":
            return Geometry.of(value).with_crs_id(crs_id).to_hex_ewkb()
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
            if isinstance(value, str):
                return Geometry.from_hex_ewkb(value).normalised()
            if isinstance(value, (bytes, bytearray)):
                # ST_AsEWKB comes back as raw EWKB bytes, not GPKG
                return Geometry.from_ewkb(bytes(value)).normalised()
            return Geometry.of(value).normalised()
        if t == "blob":
            return bytes(value) if isinstance(value, memoryview) else value
        if t == "timestamp":
            from kart_tpu_torch.adapters.base import timestamp_to_v2

            return timestamp_to_v2(value, col)
        if t == "interval":
            from kart_tpu_torch.adapters.base import interval_to_v2

            return interval_to_v2(value)
        if t in ("date", "time"):
            return str(value)
        if t == "numeric":
            return str(value)
        return value

    # -- placeholders --------------------------------------------------------

    @classmethod
    def insert_placeholder(cls, col, crs_id=0):
        """SQL expression wrapping one bind param for INSERT."""
        if col.data_type == "geometry":
            return "%s::geometry"
        return "%s"

    @classmethod
    def select_expression(cls, col):
        if col.data_type == "geometry":
            return f"ST_AsEWKB({cls.quote(col.name)}) AS {cls.quote(col.name)}"
        return cls.quote(col.name)

    # -- working-copy infrastructure SQL -------------------------------------

    @classmethod
    def base_ddl(cls, db_schema):
        """kart_state + kart_track + the shared tracking trigger procedure
        (reference: working_copy/postgis.py:49-90)."""
        state = cls.quote_table(KART_STATE, db_schema)
        track = cls.quote_table(KART_TRACK, db_schema)
        proc = cls.quote_table("_kart_track_proc", db_schema)
        return [
            f"CREATE SCHEMA IF NOT EXISTS {cls.quote(db_schema)}",
            f"""CREATE TABLE IF NOT EXISTS {state} (
                table_name TEXT NOT NULL, key TEXT NOT NULL, value TEXT,
                PRIMARY KEY (table_name, key))""",
            f"""CREATE TABLE IF NOT EXISTS {track} (
                table_name TEXT NOT NULL, pk TEXT,
                PRIMARY KEY (table_name, pk))""",
            f"""CREATE OR REPLACE FUNCTION {proc}() RETURNS TRIGGER AS $body$
            DECLARE
                pk_field text := quote_ident(TG_ARGV[0]);
                pk_old text; pk_new text;
            BEGIN
                IF (TG_OP = 'INSERT' OR TG_OP = 'UPDATE') THEN
                    EXECUTE 'SELECT $1.' || pk_field USING NEW INTO pk_new;
                    INSERT INTO {track} (table_name, pk)
                    VALUES (TG_TABLE_NAME::TEXT, pk_new) ON CONFLICT DO NOTHING;
                END IF;
                IF (TG_OP = 'UPDATE' OR TG_OP = 'DELETE') THEN
                    EXECUTE 'SELECT $1.' || pk_field USING OLD INTO pk_old;
                    INSERT INTO {track} (table_name, pk)
                    VALUES (TG_TABLE_NAME::TEXT, pk_old) ON CONFLICT DO NOTHING;
                    IF (TG_OP = 'DELETE') THEN RETURN OLD; END IF;
                END IF;
                RETURN NEW;
            END; $body$ LANGUAGE plpgsql SECURITY DEFINER""",
        ]

    @classmethod
    def create_trigger_sql(cls, db_schema, table_name, pk_name):
        proc = cls.quote_table("_kart_track_proc", db_schema)
        tbl = cls.quote_table(table_name, db_schema)
        return (
            f'CREATE TRIGGER "_kart_track_trigger" '
            f"AFTER INSERT OR UPDATE OR DELETE ON {tbl} "
            f"FOR EACH ROW EXECUTE PROCEDURE {proc}({cls.string_literal(pk_name)})"
        )

    @classmethod
    def drop_trigger_sql(cls, db_schema, table_name):
        tbl = cls.quote_table(table_name, db_schema)
        return f'DROP TRIGGER IF EXISTS "_kart_track_trigger" ON {tbl}'

    @classmethod
    def suspend_trigger_sql(cls, db_schema, table_name):
        tbl = cls.quote_table(table_name, db_schema)
        return f'ALTER TABLE {tbl} DISABLE TRIGGER "_kart_track_trigger"'

    @classmethod
    def resume_trigger_sql(cls, db_schema, table_name, pk_name=None):
        tbl = cls.quote_table(table_name, db_schema)
        return f'ALTER TABLE {tbl} ENABLE TRIGGER "_kart_track_trigger"'

    @classmethod
    def register_crs_sql(cls, crs_id, auth_name, auth_code, wkt):
        """spatial_ref_sys upsert. proj4text stays empty — PostGIS only needs
        srtext for our purposes."""
        return (
            "INSERT INTO public.spatial_ref_sys (srid, auth_name, auth_srid, srtext) "
            "VALUES (%s, %s, %s, %s) ON CONFLICT (srid) DO NOTHING",
            (crs_id, auth_name, auth_code, wkt),
        )

    @classmethod
    def upsert_sql(cls, db_schema, table_name, col_names, pk_names, *, crs_id=0,
                   schema=None):
        """INSERT ... ON CONFLICT (pk) DO UPDATE for one row."""
        tbl = cls.quote_table(table_name, db_schema)
        cols = ", ".join(cls.quote(c) for c in col_names)
        by_name = {c.name: c for c in schema.columns} if schema is not None else {}
        values = ", ".join(
            cls.insert_placeholder(by_name.get(c), crs_id) if c in by_name else "%s"
            for c in col_names
        )
        pks = ", ".join(cls.quote(c) for c in pk_names)
        updates = ", ".join(
            f"{cls.quote(c)} = EXCLUDED.{cls.quote(c)}"
            for c in col_names
            if c not in pk_names
        )
        conflict = f"DO UPDATE SET {updates}" if updates else "DO NOTHING"
        return (
            f"INSERT INTO {tbl} ({cols}) VALUES ({values}) "
            f"ON CONFLICT ({pks}) {conflict}"
        )
