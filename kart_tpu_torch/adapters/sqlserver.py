"""SQL Server adapter. A geometry column's type and SRID are CHECK
constraints (the type with all its subtypes); geometry goes as WKB through
``geometry::STGeomFromWKB(?, srid)`` and comes back through
``.STAsBinary()``; ``interval`` is stored as text.

Counterpart of kart_tpu's ``adapters/sqlserver.py``.
"""

from kart_tpu_torch.adapters.base import KART_STATE, KART_TRACK, BaseAdapter
from kart_tpu_torch.geometry import Geometry
from kart_tpu_torch.models.schema import ColumnSchema


def _build_transitive_subtypes(direct, root, acc=None):
    acc = {} if acc is None else acc
    subtypes = set()
    for child in direct.get(root, ()):
        subtypes.add(child)
        subtypes |= _build_transitive_subtypes(direct, child, acc)[child]
    acc[root] = subtypes
    return acc


# geometry type -> its transitive subtypes (reference: adapter/sqlserver.py
# _MS_GEOMETRY_DIRECT_SUBTYPES).
_DIRECT_SUBTYPES = {
    "Geometry": {"Point", "Curve", "Surface", "GeometryCollection"},
    "Curve": {"LineString", "CircularString", "CompoundCurve"},
    "Surface": {"Polygon", "CurvePolygon"},
    "GeometryCollection": {"MultiPoint", "MultiCurve", "MultiSurface"},
    "MultiCurve": {"MultiLineString"},
    "MultiSurface": {"MultiPolygon"},
}
MS_GEOMETRY_SUBTYPES = _build_transitive_subtypes(_DIRECT_SUBTYPES, "Geometry")


class SqlServerAdapter(BaseAdapter):
    QUOTE_CHAR = '"'  # QUOTED_IDENTIFIER ON style; [brackets] equivalent

    V2_TYPE_TO_SQL = {
        "boolean": "BIT",
        "blob": "VARBINARY",
        "date": "DATE",
        "float": {0: "REAL", 32: "REAL", 64: "FLOAT"},
        "geometry": "GEOMETRY",
        "integer": {0: "INT", 8: "TINYINT", 16: "SMALLINT", 32: "INT", 64: "BIGINT"},
        "interval": "TEXT",
        "numeric": "NUMERIC",
        "text": "NVARCHAR",
        "time": "TIME",
        "timestamp": {"UTC": "DATETIMEOFFSET", None: "DATETIME2"},
    }

    SQL_TYPE_TO_V2 = {
        "BIT": "boolean",
        "TINYINT": ("integer", 8),
        "SMALLINT": ("integer", 16),
        "INT": ("integer", 32),
        "BIGINT": ("integer", 64),
        "REAL": ("float", 32),
        "FLOAT": ("float", 64),
        "BINARY": "blob",
        "CHAR": "text",
        "DATE": "date",
        "SMALLDATETIME": ("timestamp", None),
        "DATETIME": ("timestamp", None),
        "DATETIME2": ("timestamp", None),
        "DATETIMEOFFSET": ("timestamp", "UTC"),
        "DECIMAL": "numeric",
        "GEOGRAPHY": "geometry",
        "GEOMETRY": "geometry",
        "NCHAR": "text",
        "NUMERIC": "numeric",
        "NVARCHAR": "text",
        "NTEXT": "text",
        "TEXT": "text",
        "TIME": "time",
        "VARCHAR": "text",
        "VARBINARY": "blob",
    }

    APPROXIMATED_TYPES = {"interval": "text"}
    APPROXIMATED_TYPES_EXTRA_TYPE_INFO = ("length",)

    @classmethod
    def v2_type_to_sql_type(cls, col: ColumnSchema, crs_id=None):
        extra = col.extra_type_info
        if col.data_type == "geometry":
            return "GEOMETRY"
        if col.data_type == "text":
            length = extra.get("length")
            return f"NVARCHAR({length})" if length else "NVARCHAR(max)"
        if col.data_type == "blob":
            length = extra.get("length")
            return f"VARBINARY({length})" if length else "VARBINARY(max)"
        if col.data_type == "numeric":
            precision, scale = extra.get("precision"), extra.get("scale")
            if precision is not None and scale is not None:
                return f"NUMERIC({precision},{scale})"
            if precision is not None:
                return f"NUMERIC({precision})"
            return "NUMERIC"
        return super().v2_type_to_sql_type(col, crs_id=crs_id)

    @classmethod
    def geometry_type_constraint(cls, col_name, geometry_type):
        """CHECK constraint listing the type and all subtypes
        (reference: adapter/sqlserver.py:109-123,_geometry_type_constraint)."""
        gtype = geometry_type.split(" ")[0].capitalize()
        for canonical in MS_GEOMETRY_SUBTYPES:
            if canonical.upper() == gtype.upper():
                gtype = canonical
                break
        allowed = sorted({gtype} | MS_GEOMETRY_SUBTYPES.get(gtype, set()))
        type_list = ", ".join(f"'{t.upper()}'" for t in allowed)
        q = cls.quote(col_name)
        return f"CHECK ({q}.STGeometryType() IN ({type_list}))"

    @classmethod
    def geometry_crs_constraint(cls, col_name, crs_id):
        q = cls.quote(col_name)
        return f"CHECK ({q}.STSrid = {int(crs_id)})"

    @classmethod
    def v2_column_schema_to_sql_spec(cls, col, *, has_int_pk=False, crs_id=None):
        # No IDENTITY on int pks: kart writes explicit pk values on checkout,
        # which SQL Server forbids for identity columns (the reference's MSSQL
        # adapter likewise creates plain int pks — adapter/sqlserver.py:126).
        spec = f"{cls.quote(col.name)} {cls.v2_type_to_sql_type(col, crs_id=crs_id)}"
        if col.data_type == "geometry":
            gtype = col.extra_type_info.get("geometryType")
            if gtype and gtype.split(" ")[0].upper() != "GEOMETRY":
                spec += " " + cls.geometry_type_constraint(col.name, gtype)
            if crs_id is not None:
                spec += " " + cls.geometry_crs_constraint(col.name, crs_id)
        return spec

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
            return f"geometry::STGeomFromWKB(?, {int(crs_id)})"
        return "?"

    @classmethod
    def select_expression(cls, col):
        if col.data_type == "geometry":
            q = cls.quote(col.name)
            return f"{q}.STAsBinary() AS {q}"
        return cls.quote(col.name)

    # -- working-copy infrastructure SQL -------------------------------------

    @classmethod
    def base_ddl(cls, db_schema):
        state = cls.quote_table(KART_STATE, db_schema)
        track = cls.quote_table(KART_TRACK, db_schema)
        schema_lit = cls.string_literal(db_schema)
        state_lit = cls.string_literal(f"{db_schema}.{KART_STATE}")
        track_lit = cls.string_literal(f"{db_schema}.{KART_TRACK}")
        # EXEC('…') needs the already-quoted identifier re-escaped for the
        # inner literal
        create_schema = cls.string_literal(f"CREATE SCHEMA {cls.quote(db_schema)}")
        return [
            f"IF SCHEMA_ID({schema_lit}) IS NULL "
            f"EXEC({create_schema})",
            f"IF OBJECT_ID({state_lit}) IS NULL "
            f"CREATE TABLE {state} ("
            f"table_name NVARCHAR(400) NOT NULL, [key] NVARCHAR(400) NOT NULL, "
            f"value NVARCHAR(max), PRIMARY KEY (table_name, [key]))",
            f"IF OBJECT_ID({track_lit}) IS NULL "
            f"CREATE TABLE {track} ("
            f"table_name NVARCHAR(400) NOT NULL, pk NVARCHAR(400), "
            f"PRIMARY KEY (table_name, pk))",
        ]

    @classmethod
    def create_trigger_sql(cls, db_schema, table_name, pk_name):
        """Single AFTER trigger MERGE-ing both INSERTED and DELETED pks
        (reference: working_copy/sqlserver.py:206-227)."""
        track = cls.quote_table(KART_TRACK, db_schema)
        tbl = cls.quote_table(table_name, db_schema)
        trig = cls.quote_table(f"_kart_track_{table_name}_trigger", db_schema)
        pk = cls.quote(pk_name)
        name_lit = cls.string_literal(table_name)
        return (
            f"CREATE TRIGGER {trig} ON {tbl} AFTER INSERT, UPDATE, DELETE AS "
            f"BEGIN "
            f"MERGE {track} TRA USING "
            f"(SELECT {name_lit}, {pk} FROM inserted "
            f"UNION SELECT {name_lit}, {pk} FROM deleted) "
            f"AS SRC (table_name, pk) "
            f"ON SRC.table_name = TRA.table_name AND SRC.pk = TRA.pk "
            f"WHEN NOT MATCHED THEN INSERT (table_name, pk) "
            f"VALUES (SRC.table_name, SRC.pk); "
            f"END"
        )

    @classmethod
    def drop_trigger_sql(cls, db_schema, table_name):
        trig = cls.quote_table(f"_kart_track_{table_name}_trigger", db_schema)
        return f"DROP TRIGGER IF EXISTS {trig}"

    @classmethod
    def suspend_trigger_sql(cls, db_schema, table_name):
        trig = cls.quote(f"_kart_track_{table_name}_trigger")
        tbl = cls.quote_table(table_name, db_schema)
        return f"DISABLE TRIGGER {trig} ON {tbl}"

    @classmethod
    def resume_trigger_sql(cls, db_schema, table_name, pk_name=None):
        trig = cls.quote(f"_kart_track_{table_name}_trigger")
        tbl = cls.quote_table(table_name, db_schema)
        return f"ENABLE TRIGGER {trig} ON {tbl}"

    @classmethod
    def register_crs_sql(cls, crs_id, auth_name, auth_code, wkt):
        # SQL Server has no writable spatial_ref_sys; SRIDs live on values.
        return None

    @classmethod
    def upsert_sql(cls, db_schema, table_name, col_names, pk_names, *, crs_id=0,
                   schema=None):
        tbl = cls.quote_table(table_name, db_schema)
        by_name = {c.name: c for c in schema.columns} if schema is not None else {}
        placeholders = {
            c: (cls.insert_placeholder(by_name[c], crs_id) if c in by_name else "?")
            for c in col_names
        }
        src_cols = ", ".join(placeholders[c] for c in col_names)
        col_list = ", ".join(cls.quote(c) for c in col_names)
        on = " AND ".join(
            f"SRC.{cls.quote(c)} = TGT.{cls.quote(c)}" for c in pk_names
        )
        updates = ", ".join(
            f"TGT.{cls.quote(c)} = SRC.{cls.quote(c)}"
            for c in col_names
            if c not in pk_names
        )
        update_clause = f"WHEN MATCHED THEN UPDATE SET {updates} " if updates else ""
        src_names = ", ".join(cls.quote(c) for c in col_names)
        return (
            f"MERGE {tbl} TGT USING (SELECT {src_cols}) AS SRC ({src_names}) "
            f"ON {on} {update_clause}"
            f"WHEN NOT MATCHED THEN INSERT ({col_list}) "
            f"VALUES ({', '.join('SRC.' + cls.quote(c) for c in col_names)});"
        )
