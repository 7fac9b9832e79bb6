"""Table schemas, columns and legends.

``meta/schema.json`` holds an ordered list of column dicts (``{id, name,
dataType, primaryKeyIndex?, ...extra}``). A legend is the header that
decodes a stored row: the pk column ids and the non-pk column ids; each
feature blob names its legend by truncated sha256.

Counterpart of kart_tpu's ``models/schema.py``: ``Legend``,
``ColumnSchema``, ``Schema``, ``encode_feature_blob`` and the row
conversions the feature decode uses. Schema diffs, alignment and value
validation are not ported.
"""

from dataclasses import dataclass, field

from kart_tpu_torch.core.serialise import hexhash, json_pack, msg_pack, msg_unpack


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
