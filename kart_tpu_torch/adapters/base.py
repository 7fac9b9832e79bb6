"""What the server-database adapters share: V2 type to SQL type and back,
the CREATE TABLE body, and the roundtrip policy that tells a real schema
edit from a type the dialect only approximates. Plain SQL text over DBAPI,
so every dialect is tested without a server.

Counterpart of kart_tpu's ``adapters/base.py``.
"""

import re

from kart_tpu_torch.models.schema import ColumnSchema, Schema


# tracking-table names shared by every server-database working copy
KART_STATE = "_kart_state"
KART_TRACK = "_kart_track"


class BaseAdapter:
    """One subclass per SQL dialect. Subclasses fill in the class attrs and
    override the hooks whose behaviour is dialect-specific."""

    KART_STATE = KART_STATE
    KART_TRACK = KART_TRACK

    # V2 data type -> SQL type. Values are either a string or a dict keyed by
    # the relevant extra_type_info discriminator (integer/float: "size",
    # timestamp: "timezone").
    V2_TYPE_TO_SQL = {}
    # SQL type name (upper, no length suffix) -> V2 type: either "name" or
    # ("name", size-or-timezone).
    SQL_TYPE_TO_V2 = {}
    # V2 types this dialect can't store exactly -> what they roundtrip as.
    # Keys/values are data_type strings or (data_type, discriminator) tuples.
    APPROXIMATED_TYPES = {}
    # extra_type_info keys that may be dropped by an approximated roundtrip.
    APPROXIMATED_TYPES_EXTRA_TYPE_INFO = ("length",)

    QUOTE_CHAR = '"'

    @classmethod
    def quote(cls, identifier):
        q = cls.QUOTE_CHAR
        return q + identifier.replace(q, q + q) + q

    @classmethod
    def quote_table(cls, table_name, db_schema=None):
        if db_schema:
            return f"{cls.quote(db_schema)}.{cls.quote(table_name)}"
        return cls.quote(table_name)

    @staticmethod
    def string_literal(value):
        """A SQL '…' literal: names (table/pk/schema) embedded in trigger DDL
        string literals must not break out of the literal, so a dataset path
        containing a quote stays data rather than SQL."""
        return "'" + str(value).replace("'", "''") + "'"

    # -- V2 -> SQL -----------------------------------------------------------

    @classmethod
    def v2_type_to_sql_type(cls, col: ColumnSchema, crs_id=None):
        mapped = cls.V2_TYPE_TO_SQL[col.data_type]
        extra = col.extra_type_info
        if isinstance(mapped, dict):
            if col.data_type in ("integer", "float"):
                return mapped[extra.get("size", 0) or 0]
            if col.data_type == "timestamp":
                return mapped[extra.get("timezone")]
            raise KeyError(col.data_type)
        return mapped

    @classmethod
    def v2_column_schema_to_sql_spec(cls, col: ColumnSchema, *, has_int_pk=False,
                                     crs_id=None):
        return f"{cls.quote(col.name)} {cls.v2_type_to_sql_type(col, crs_id=crs_id)}"

    @classmethod
    def v2_schema_to_sql_spec(cls, schema: Schema, *, crs_id=None):
        """-> the column-spec body of CREATE TABLE, including the PK clause."""
        has_int_pk = (
            len(schema.pk_columns) == 1
            and schema.pk_columns[0].data_type == "integer"
        )
        specs = [
            cls.v2_column_schema_to_sql_spec(col, has_int_pk=has_int_pk, crs_id=crs_id)
            for col in schema.columns
        ]
        if schema.pk_columns:
            pk_names = ", ".join(cls.quote(c.name) for c in schema.pk_columns)
            specs.append(f"PRIMARY KEY ({pk_names})")
        return ", ".join(specs)

    # -- SQL -> V2 -----------------------------------------------------------

    _TYPE_WITH_ARGS = re.compile(r"([A-Z ]+?)\s*\(\s*(\d+)(?:\s*,\s*(\d+))?\s*\)")

    @classmethod
    def sql_type_to_v2(cls, sql_type):
        """'VARCHAR(40)' / 'NUMERIC(10,2)' / 'BIGINT' ->
        (data_type, extra_type_info)."""
        sql_type = (sql_type or "").strip().upper()
        length = precision = scale = None
        if sql_type.endswith("(MAX)"):  # SQL Server NVARCHAR(max)/VARBINARY(max)
            sql_type = sql_type[: -len("(MAX)")].strip()
        m = cls._TYPE_WITH_ARGS.fullmatch(sql_type)
        if m:
            sql_type = m.group(1).strip()
            if m.group(3) is not None:
                precision, scale = int(m.group(2)), int(m.group(3))
            else:
                length = int(m.group(2))
        v2 = cls.SQL_TYPE_TO_V2.get(sql_type)
        if v2 is None:
            return cls.unknown_sql_type_to_v2(sql_type)
        if isinstance(v2, tuple):
            data_type, disc = v2
        else:
            data_type, disc = v2, None
        extra = {}
        if disc is not None:
            extra["size" if data_type in ("integer", "float") else "timezone"] = disc
        if length is not None and data_type in ("text", "blob"):
            extra["length"] = length
        if data_type == "numeric":
            if precision is not None:
                extra["precision"] = precision
                if scale is not None:
                    extra["scale"] = scale
            elif length is not None:
                extra["precision"] = length
        return data_type, extra

    @classmethod
    def unknown_sql_type_to_v2(cls, sql_type):
        return "text", {}

    # -- roundtrip alignment policy ------------------------------------------

    @classmethod
    def try_align_schema_col(cls, old_col_dict, new_col_dict):
        """After a WC roundtrip, decide whether new_col is "the same column"
        as old_col modulo type approximation; if so, patch new_col_dict back
        to the original type info and return True."""
        old_type = old_col_dict["dataType"]
        new_type = new_col_dict["dataType"]
        for key in (old_type, (old_type, cls._roundtrip_disc(old_col_dict, old_type))):
            approx = cls.APPROXIMATED_TYPES.get(key)
            if approx is None:
                continue
            if isinstance(approx, tuple):
                if (new_type, new_col_dict.get("size")) == approx:
                    new_col_dict["dataType"] = old_type
                    new_col_dict["size"] = old_col_dict.get("size")
                    return True
            elif approx == new_type:
                new_col_dict["dataType"] = old_type
                for attr in cls.APPROXIMATED_TYPES_EXTRA_TYPE_INFO:
                    if attr in old_col_dict:
                        new_col_dict[attr] = old_col_dict[attr]
                    else:
                        new_col_dict.pop(attr, None)
                return True
        return old_type == new_type

    @staticmethod
    def _roundtrip_disc(col_dict, data_type):
        if data_type == "timestamp":
            return col_dict.get("timezone")
        if data_type in ("integer", "float"):
            return col_dict.get("size")
        return None


def timestamp_to_v2(value, col):
    """DB timestamp (datetime or string) -> canonical V2 text:
    ``YYYY-MM-DDThh:mm:ss[.ffffff]`` with tz offsets normalised to ``Z``.
    UTC-typed columns (extra ``timezone: "UTC"``) always carry the ``Z``
    (Schema._check_timestamp rejects ``+00:00``-style offsets)."""
    import datetime as dt
    import re

    is_utc_col = col.extra_type_info.get("timezone") == "UTC"
    if isinstance(value, dt.datetime):
        if value.tzinfo is not None:
            value = value.astimezone(dt.timezone.utc).replace(tzinfo=None)
            return value.isoformat() + "Z"
        return value.isoformat() + ("Z" if is_utc_col else "")
    s = str(value).replace(" ", "T")
    m = re.search(r"([+-]\d{2}:?\d{2})$", s)
    if m:
        if m.group(1) in ("+00:00", "+0000", "-00:00", "-0000"):
            s = s[: m.start()] + "Z"
        else:
            # non-UTC offset: convert through datetime
            try:
                parsed = dt.datetime.fromisoformat(s)
                s = (
                    parsed.astimezone(dt.timezone.utc)
                    .replace(tzinfo=None)
                    .isoformat()
                    + "Z"
                )
            except ValueError:
                pass
    elif is_utc_col and not s.endswith("Z"):
        s += "Z"
    return s


def interval_to_v2(value):
    """DB interval (timedelta or string) -> ISO-8601 duration ``PnDTnHnMnS``
    (the only form Schema._check_interval accepts)."""
    import datetime as dt

    if not isinstance(value, dt.timedelta):
        return str(value)
    days = value.days
    seconds = value.seconds
    micros = value.microseconds
    hours, seconds = divmod(seconds, 3600)
    minutes, seconds = divmod(seconds, 60)
    out = "P"
    if days:
        out += f"{days}D"
    if hours or minutes or seconds or micros or out == "P":
        out += "T"
        if hours:
            out += f"{hours}H"
        if minutes:
            out += f"{minutes}M"
        if micros:
            out += f"{seconds + micros / 1_000_000:g}S"
        elif seconds or (not hours and not minutes):
            out += f"{seconds}S"
    return out
