"""Table schemas, columns and legends.

``meta/schema.json`` holds an ordered list of column dicts (``{id, name,
dataType, primaryKeyIndex?, ...extra}``). A legend is the header that
decodes a stored row: the pk column ids and the non-pk column ids; each
feature blob names its legend by truncated sha256.

Counterpart of kart_tpu's ``models/schema.py``: ``Legend``,
``ColumnSchema`` (with ``new_id`` and ``deterministic_id``), ``Schema``
with ``encode_feature_blob``, ``encode_feature``, ``hash_feature`` and the row
conversions, ``sanitise_pks``, the schema comparisons the write path uses
(``is_pk_compatible``, ``diff_types``, ``diff_type_counts``,
``align_to_self`` with ``DefaultRoundtripContext``) and the value
validation of a commit (``validate_feature``, ``find_column_violation``
and one ``_check_<type>`` a constrained type), with kart_tpu's messages.
"""

import hashlib
import re
import uuid
from dataclasses import dataclass, field

from kart_tpu_torch.core.serialise import _sha256_of, hexhash, json_pack, msg_pack, msg_unpack
from kart_tpu_torch.geometry import Geometry

# Python types a stored (msgpack) value may have, per data type
_STORED_PY_TYPES = {
    "boolean": (bool,),
    "blob": (bytes,),
    "date": (str,),
    "float": (float, int),
    "geometry": (Geometry,),
    "integer": (int,),
    "interval": (str,),
    "numeric": (str,),
    "text": (str,),
    "time": (str,),
    "timestamp": (str,),
}


class Legend:
    """(pk column ids, non-pk column ids), serialised as msgpack of the two
    tuples and identified by its truncated sha256."""

    __slots__ = ("pk_columns", "non_pk_columns")

    def __init__(self, pk_columns, non_pk_columns):
        self.pk_columns = tuple(pk_columns)
        self.non_pk_columns = tuple(non_pk_columns)

    @classmethod
    def loads(cls, data):
        pk_cols, non_pk_cols = msg_unpack(data)
        return cls(pk_cols, non_pk_cols)

    def dumps(self):
        return msg_pack((self.pk_columns, self.non_pk_columns))

    def hexhash(self):
        return hexhash(self.dumps())

    def to_raw_dict(self, pk_values, non_pk_values):
        out = dict(zip(self.pk_columns, pk_values))
        out.update(zip(self.non_pk_columns, non_pk_values))
        return out


@dataclass(frozen=True)
class ColumnSchema:
    id: str
    name: str
    data_type: str
    pk_index: object = None
    extra_type_info: dict = field(default_factory=dict)

    @staticmethod
    def new_id():
        return str(uuid.uuid4())

    @staticmethod
    def deterministic_id(*parts):
        """A column id that the same parts (a source path, a table, a
        column name) always give."""
        return str(uuid.UUID(bytes=_sha256_of(*parts).digest()[:16]))

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        return cls(
            id=d.pop("id"),
            name=d.pop("name"),
            data_type=d.pop("dataType"),
            pk_index=d.pop("primaryKeyIndex", None),
            extra_type_info={k: v for k, v in d.items() if v is not None},
        )

    def to_dict(self):
        out = {"id": self.id, "name": self.name, "dataType": self.data_type}
        if self.pk_index is not None:
            out["primaryKeyIndex"] = self.pk_index
        out.update((k, v) for k, v in self.extra_type_info.items() if v is not None)
        return out


def _pk_ordering(col):
    return col.pk_index if col.pk_index is not None else float("inf")


class Schema:
    """Immutable ordered list of ColumnSchemas."""

    def __init__(self, columns):
        self.columns = tuple(columns)
        pk_ids, non_pk_ids = [], []
        for i, col in enumerate(sorted(self.columns, key=_pk_ordering)):
            if col.pk_index is not None:
                if i != col.pk_index:
                    raise ValueError(
                        f"Expected contiguous primaryKeyIndex {i} but found {col.pk_index}"
                    )
                pk_ids.append(col.id)
            else:
                non_pk_ids.append(col.id)
        self.legend = Legend(pk_ids, non_pk_ids)
        self.legend_hash = self.legend.hexhash()
        self.pk_columns = tuple(c for c in sorted(self.columns, key=_pk_ordering)
                                if c.pk_index is not None)

    def __iter__(self):
        return iter(self.columns)

    @property
    def first_geometry_column(self):
        return next((c for c in self.columns if c.data_type == "geometry"), None)

    def __eq__(self, other):
        return isinstance(other, Schema) and self.columns == other.columns

    def __hash__(self):
        return hash(self.columns)

    @classmethod
    def from_column_dicts(cls, column_dicts):
        return cls([ColumnSchema.from_dict(d) for d in column_dicts])

    def to_column_dicts(self):
        return [c.to_dict() for c in self.columns]

    def dumps(self):
        return json_pack(self.to_column_dicts())

    def feature_from_raw_dict(self, raw_dict):
        """column-id-keyed dict -> column-name-keyed dict (schema order)."""
        return {c.name: raw_dict.get(c.id) for c in self.columns}

    def encode_feature_blob(self, feature):
        """name-keyed feature -> (pk values, blob bytes
        ``msgpack([legend hash, non-pk values])``)."""
        raw = {c.id: feature[c.name] for c in self.columns}
        pk_values = tuple(raw[c] for c in self.legend.pk_columns)
        non_pk_values = tuple(raw[c] for c in self.legend.non_pk_columns)
        return pk_values, msg_pack([self.legend_hash, non_pk_values])

    def encode_feature(self, feature, without_pk=False):
        """A feature's self-contained binary form, for hashing its content."""
        raw = {c.id: feature[c.name] for c in self.columns}
        pk_values = tuple(raw[c] for c in self.legend.pk_columns)
        non_pk_values = tuple(raw[c] for c in self.legend.non_pk_columns)
        data = ([self.legend_hash, non_pk_values] if without_pk
                else [self.legend_hash, pk_values, non_pk_values])
        return msg_pack(data)

    def hash_feature(self, feature, without_pk=False):
        """The git blob hash of :meth:`encode_feature`'s bytes."""
        data = self.encode_feature(feature, without_pk=without_pk)
        h = hashlib.sha1(b"blob %d\x00" % len(data))
        h.update(data)
        return h.hexdigest()

    def __getitem__(self, col_id):
        for c in self.columns:
            if c.id == col_id:
                return c
        raise KeyError(f"No such column: {col_id}")

    def sanitise_pks(self, pk_values):
        """User-supplied pk values -> a tuple, text coerced to the int or
        float of its pk column."""
        if not isinstance(pk_values, (list, tuple)):
            pk_values = [pk_values]
        pk_values = list(pk_values)
        for i, (value, col) in enumerate(zip(pk_values, self.pk_columns)):
            if isinstance(value, str):
                if col.data_type == "integer":
                    pk_values[i] = int(value)
                elif col.data_type == "float":
                    pk_values[i] = float(value)
        return tuple(pk_values)

    # -- comparison and alignment -------------------------------------------

    def is_pk_compatible(self, other):
        """False when a schema change moves every feature to a new path."""
        return self.legend.pk_columns == other.legend.pk_columns

    def diff_types(self, new_schema):
        """Column ids by kind of change from this schema to ``new_schema``:
        inserts, deletes, position, name, type and pk updates."""
        old_ids_list = [c.id for c in self]
        old_ids, new_ids = set(old_ids_list), {c.id for c in new_schema}
        result = {
            "inserts": new_ids - old_ids,
            "deletes": old_ids - new_ids,
            "position_updates": set(),
            "name_updates": set(),
            "type_updates": set(),
            "pk_updates": set(),
        }
        for new_index, new_col in enumerate(new_schema):
            if new_col.id not in old_ids:
                continue
            old_col = self[new_col.id]
            if old_ids_list.index(new_col.id) != new_index:
                result["position_updates"].add(new_col.id)
            if old_col.name != new_col.name:
                result["name_updates"].add(new_col.id)
            if (old_col.data_type != new_col.data_type
                    or old_col.extra_type_info != new_col.extra_type_info):
                result["type_updates"].add(new_col.id)
            if old_col.pk_index != new_col.pk_index:
                result["pk_updates"].add(new_col.id)
        return result

    def diff_type_counts(self, new_schema):
        return {k: len(v) for k, v in self.diff_types(new_schema).items()}

    def align_to_self(self, new_schema, roundtrip_ctx=None):
        """``new_schema`` with this schema's column ids copied onto its
        matching columns (a schema read back from a database keeps no ids):
        first by name, then by position, each only with the same pk index
        and a type the context accepts."""
        ctx = roundtrip_ctx or DefaultRoundtripContext
        old_cols = self.to_column_dicts()
        new_cols = new_schema.to_column_dicts()
        aligned_old, aligned_new = set(), set()

        def try_align(oi, ni):
            if oi is None or ni is None or oi in aligned_old or ni in aligned_new:
                return
            old_d, new_d = old_cols[oi], new_cols[ni]
            if old_d.get("primaryKeyIndex") != new_d.get("primaryKeyIndex"):
                return
            if ctx.try_align_schema_col(old_d, new_d):
                new_d["id"] = old_d["id"]
                aligned_old.add(oi)
                aligned_new.add(ni)

        by_name = {d["name"]: i for i, d in enumerate(old_cols)}
        for ni, new_d in enumerate(new_cols):
            try_align(by_name.get(new_d["name"]), ni)
        for i in range(min(len(old_cols), len(new_cols))):
            try_align(i, i)
        return Schema.from_column_dicts(new_cols)

    # -- value validation ---------------------------------------------------

    def validate_feature(self, feature, col_violations=None):
        """True when every value fits its column's type. With a dict
        ``col_violations``, record there one violation per column name."""
        if col_violations is None:
            return all(self.find_column_violation(c, feature.get(c.name)) is None
                       for c in self.columns)
        ok = not col_violations
        for col in self.columns:
            if col.name in col_violations:
                ok = False
                continue
            violation = self.find_column_violation(col, feature.get(col.name))
            if violation is not None:
                col_violations[col.name] = violation
                ok = False
        return ok

    def find_column_violation(self, col, value):
        """The message of ``value``'s violation of column ``col``, or None."""
        if value is None:
            return None
        if type(value) not in _STORED_PY_TYPES[col.data_type]:
            return (f"In column '{col.name}' value {value!r} doesn't match schema type "
                    f"{col.data_type}")
        checker = getattr(self, f"_check_{col.data_type}", None)
        return checker(col, value) if checker else None

    @staticmethod
    def _check_integer(col, value):
        size = col.extra_type_info.get("size")
        if not size:
            return None
        bits = (value + 1).bit_length() + 1 if value < 0 else value.bit_length() + 1
        if bits > size:
            bound = 2 ** (size - 1)
            return (f"In column '{col.name}' value {value!r} does not fit into an "
                    f"int{size}: {-bound} to {bound - 1}")

    @staticmethod
    def _check_text(col, value):
        length = col.extra_type_info.get("length")
        if length and len(value) > length:
            shown = value if len(value) <= 100 else value[:40] + "....." + value[-40:]
            return (f"In column '{col.name}' value {shown!r} exceeds limit of "
                    f"{length} characters")

    @staticmethod
    def _check_blob(col, value):
        length = col.extra_type_info.get("length")
        if length and len(value) > length:
            shown = value if len(value) <= 100 else value[:40] + b"....." + value[-40:]
            return (f"In column '{col.name}' value {shown!r} exceeds limit of "
                    f"{length} bytes")

    @staticmethod
    def _check_date(col, value):
        if not re.fullmatch(r"\d{4}-\d{2}-\d{2}", value):
            return (f"In column '{col.name}' value {value!r} is not an ISO 8601 date "
                    f"ie YYYY-MM-DD")

    @staticmethod
    def _check_time(col, value):
        if not re.fullmatch(r"\d{2}:\d{2}:\d{2}(\.\d+)?Z?", value):
            return (f"In column '{col.name}' value {value!r} is not an ISO 8601 time "
                    f"ie hh:mm:ss.ssss")

    @staticmethod
    def _check_timestamp(col, value):
        if not re.fullmatch(r"\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}(\.\d+)?Z?", value):
            return (f"In column '{col.name}' value {value!r} is not an ISO 8601 UTC "
                    f"datetime ie YYYY-MM-DDThh:mm:ss.ssss")

    _INTERVAL_RE = re.compile(r"P(\d+Y)?(\d+M)?(\d+W)?(\d+D)?(T(\d+H)?(\d+M)?(\d+(\.\d+)?S)?)?")

    @classmethod
    def _check_interval(cls, col, value):
        if not cls._INTERVAL_RE.fullmatch(value):
            return (f"In column '{col.name}' value {value!r} is not an ISO 8601 "
                    f"duration ie PxYxMxDTxHxMxS")


class DefaultRoundtripContext:
    """Column alignment with no lossy storage round trip: two columns are
    the same only with the same data type."""

    @classmethod
    def try_align_schema_col(cls, old_col_dict, new_col_dict):
        return new_col_dict["dataType"] == old_col_dict["dataType"]
