"""GeoPackage <-> Datasets V2: type mapping both ways, cell values both
ways, and the schema alignment after a round trip through GPKG types.

GPKG is sqlite with registered metadata tables, and its types are a subset
of Kart's: ``numeric``, ``interval``, ``time`` and a timestamp without a
time zone are stored as TEXT and restored by :class:`GpkgRoundtripContext`
when the working copy's schema is read back. Stdlib ``sqlite3`` only.

Counterpart of kart_tpu's ``adapters/gpkg.py``, with the quoting helpers
of its ``adapters/base.py`` (whose ``BaseAdapter`` serves the server
databases' adapters, not ported).
"""

import re

from kart_tpu_torch.geometry import Geometry
from kart_tpu_torch.models.schema import ColumnSchema, Schema

V2_TYPE_TO_SQL = {
    "boolean": "BOOLEAN",
    "integer": {0: "INTEGER", 8: "TINYINT", 16: "SMALLINT", 32: "MEDIUMINT", 64: "INTEGER"},
    "float": {0: "REAL", 32: "FLOAT", 64: "REAL"},
    "text": "TEXT",
    "blob": "BLOB",
    "date": "DATE",
    "timestamp": {"UTC": "DATETIME", None: "TEXT"},
    "time": "TEXT",
    "numeric": "TEXT",
    "interval": "TEXT",
    "geometry": "GEOMETRY",
}

SQL_TYPE_TO_V2 = {
    "BOOLEAN": ("boolean", None),
    "TINYINT": ("integer", 8),
    "SMALLINT": ("integer", 16),
    "MEDIUMINT": ("integer", 32),
    "INT": ("integer", 64),
    "INTEGER": ("integer", 64),
    "FLOAT": ("float", 32),
    "DOUBLE": ("float", 64),
    "REAL": ("float", 64),
    "TEXT": ("text", None),
    "BLOB": ("blob", None),
    "DATE": ("date", None),
    "DATETIME": ("timestamp", "UTC"),
    "GEOMETRY": ("geometry", None),
}

#: Kart types GPKG cannot hold exactly, and the GPKG type they become
APPROXIMATED_TYPES = {
    "interval": "text",
    "time": "text",
    "numeric": "text",
    ("timestamp", None): "text",
}

GPKG_GEOMETRY_TYPES = {
    "GEOMETRY", "POINT", "LINESTRING", "POLYGON", "MULTIPOINT", "MULTILINESTRING",
    "MULTIPOLYGON", "GEOMETRYCOLLECTION",
}


def quote(identifier):
    """An SQL identifier, its quote characters doubled."""
    return '"' + identifier.replace('"', '""') + '"'


def string_literal(value):
    """An SQL '...' literal with embedded quotes doubled, for names inlined
    into trigger bodies (sqlite binds no parameters in DDL): a dataset path
    holding a quote stays data."""
    return "'" + str(value).replace("'", "''") + "'"


def v2_type_to_sql_type(col: ColumnSchema):
    mapped = V2_TYPE_TO_SQL[col.data_type]
    extra = col.extra_type_info
    if col.data_type in ("integer", "float"):
        return mapped[extra.get("size", 0) or 0]
    if col.data_type == "timestamp":
        return mapped.get(extra.get("timezone"), "TEXT")
    if col.data_type == "geometry":
        return extra.get("geometryType", "GEOMETRY").split(" ")[0]
    if col.data_type in ("text", "blob"):
        length = extra.get("length")
        return f"{mapped}({length})" if length else mapped
    return mapped


def v2_schema_to_sql_spec(schema: Schema):
    """-> the column specs of CREATE TABLE. GPKG wants an integer pk: any
    other pk becomes UNIQUE NOT NULL behind an ``auto_int_pk``."""
    has_int_pk = len(schema.pk_columns) == 1 and schema.pk_columns[0].data_type == "integer"
    cols = []
    if not has_int_pk:
        cols.append("auto_int_pk INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL")
    for col in schema.columns:
        name = quote(col.name)
        if col.pk_index is not None and has_int_pk:
            cols.append(f"{name} INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL")
        elif col.pk_index is not None:
            cols.append(f"{name} {v2_type_to_sql_type(col)} UNIQUE NOT NULL CHECK({name}<>'')")
        else:
            cols.append(f"{name} {v2_type_to_sql_type(col)}")
    return ", ".join(cols)


_TYPE_WITH_LENGTH = re.compile(r"([A-Z]+)\s*\(\s*(\d+)\s*\)")


def sqlite_type_to_v2(sql_type, *, geom_info=None):
    """'MEDIUMINT', 'TEXT(40)' or a geometry type name -> (data_type,
    extra_type_info)."""
    sql_type = (sql_type or "").strip().upper()
    m = _TYPE_WITH_LENGTH.fullmatch(sql_type)
    length = None
    if m:
        sql_type, length = m.group(1), int(m.group(2))
    if sql_type in GPKG_GEOMETRY_TYPES or geom_info is not None:
        extra = {}
        gname = sql_type if sql_type in GPKG_GEOMETRY_TYPES else "GEOMETRY"
        if geom_info:
            gname = geom_info.get("geometry_type_name", gname)
            z = geom_info.get("z", 0)
            m_flag = geom_info.get("m", 0)
            if z:
                gname += " Z"
            if m_flag:
                gname += " M" if not z else "M"
            gname = gname.replace(" Z M", " ZM")
            extra["geometryType"] = gname
            if geom_info.get("crs_identifier"):
                extra["geometryCRS"] = geom_info["crs_identifier"]
        else:
            extra["geometryType"] = gname
        return "geometry", extra
    v2 = SQL_TYPE_TO_V2.get(sql_type)
    if v2 is None:
        # sqlite is dynamically typed: an unknown declaration acts as TEXT
        return "text", ({"length": length} if length else {})
    data_type, size = v2
    extra = {}
    if size is not None:
        extra["size" if data_type in ("integer", "float") else "timezone"] = size
    if length is not None and data_type in ("text", "blob"):
        extra["length"] = length
    return data_type, extra


def value_to_v2(value, col: ColumnSchema):
    """A GPKG cell -> the stored value."""
    if value is None:
        return None
    t = col.data_type
    if t == "geometry":
        if isinstance(value, Geometry):
            return value.normalised()
        return Geometry.of(bytes(value)).normalised()
    if t == "boolean":
        return bool(value)
    if t == "float":
        return float(value)
    if t == "timestamp" and isinstance(value, str):
        return value.replace(" ", "T")
    return value


def value_from_v2(value, col: ColumnSchema, *, crs_id=0):
    """A stored value -> the GPKG cell (a geometry with its srs id)."""
    if value is None:
        return None
    t = col.data_type
    if t == "geometry":
        return bytes(Geometry.of(value).with_crs_id(crs_id))
    if t == "boolean":
        return int(value)
    return value


class GpkgRoundtripContext:
    """Which schema changes after a round trip through GPKG are the types'
    approximation rather than the user's edit."""

    @classmethod
    def try_align_schema_col(cls, old_col_dict, new_col_dict):
        old_type = old_col_dict["dataType"]
        new_type = new_col_dict["dataType"]
        if old_type == new_type:
            if old_type == "timestamp" and new_col_dict.get("timezone") is None:
                new_col_dict["timezone"] = old_col_dict.get("timezone")
            return True
        key = ("timestamp", old_col_dict.get("timezone")) if old_type == "timestamp" else old_type
        if APPROXIMATED_TYPES.get(key) == new_type:
            new_col_dict["dataType"] = old_type
            for attr in ("length", "precision", "scale", "timezone"):
                if attr in old_col_dict:
                    new_col_dict[attr] = old_col_dict[attr]
                else:
                    new_col_dict.pop(attr, None)
            return True
        return old_type == "integer" and new_type == "integer"
