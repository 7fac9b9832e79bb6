"""The port's ``models/schema.py`` against kart_tpu's on the same inputs:
value validation (``find_column_violation`` and ``validate_feature``, one
case a data type and bound, messages included), ``sanitise_pks``,
``is_pk_compatible``, ``diff_types``/``diff_type_counts`` and
``align_to_self`` (column ids copied by name, then by position, only for
an equal pk index and data type); a hypothesis property holds random
values of every type to the same verdicts."""

import struct

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from kart_tpu.geometry import Geometry as JGeometry
from kart_tpu.models.schema import Schema as JSchema
from kart_tpu_torch.geometry import Geometry as TGeometry
from kart_tpu_torch.models.schema import Schema as TSchema

COLUMNS = [
    {"id": "c0", "name": "fid", "dataType": "integer", "primaryKeyIndex": 0, "size": 64},
    {"id": "c1", "name": "i8", "dataType": "integer", "size": 8},
    {"id": "c2", "name": "i16", "dataType": "integer", "size": 16},
    {"id": "c3", "name": "i32", "dataType": "integer", "size": 32},
    {"id": "c4", "name": "iany", "dataType": "integer"},
    {"id": "c5", "name": "t5", "dataType": "text", "length": 5},
    {"id": "c6", "name": "tany", "dataType": "text"},
    {"id": "c7", "name": "b3", "dataType": "blob", "length": 3},
    {"id": "c8", "name": "day", "dataType": "date"},
    {"id": "c9", "name": "clock", "dataType": "time"},
    {"id": "c10", "name": "stamp", "dataType": "timestamp"},
    {"id": "c11", "name": "span", "dataType": "interval"},
    {"id": "c12", "name": "flag", "dataType": "boolean"},
    {"id": "c13", "name": "ratio", "dataType": "float", "size": 32},
    {"id": "c14", "name": "amount", "dataType": "numeric", "precision": 5, "scale": 2},
    {"id": "c15", "name": "shape", "dataType": "geometry", "geometryType": "POINT"},
]

POINT_WKB = struct.pack("<BIdd", 1, 1, 1.0, 2.0)
GEOM = object()  # stands for each package's own Geometry of POINT_WKB

VALUES = {
    "i8": [127, 128, -128, -129, 0, True, 1.0, "1"],
    "i16": [32767, 32768, -32768, -32769],
    "i32": [2**31 - 1, 2**31, -(2**31), -(2**31) - 1],
    "fid": [2**63 - 1, 2**63, -(2**63), -(2**63) - 1],
    "iany": [2**80, -(2**80)],
    "t5": ["abcde", "abcdef", "", "é" * 5, "x" * 101, b"abc", 5],
    "tany": ["x" * 1000],
    "b3": [b"abc", b"abcd", bytes(150), bytearray(b"a"), "abc"],
    "day": ["2024-01-02", "2024-1-02", "20240102", "2024-01-02T00:00:00", ""],
    "clock": ["10:11:12", "10:11:12.123456Z", "10:11", "1:11:12", "10:11:12Z+"],
    "stamp": ["2024-01-02T03:04:05", "2024-01-02T03:04:05.5Z", "2024-01-02 03:04:05",
              "2024-01-02"],
    "span": ["P1D", "PT1H2M3.5S", "P1Y2M3W4DT5H6M7S", "P", "1D", "PT"],
    "flag": [True, False, 1, 0, "true"],
    "ratio": [1.5, 2, True, "1.5", float("nan")],
    "amount": ["1.50", 1.5, 1],
    "shape": [GEOM, POINT_WKB, "POINT(1 2)"],
}

CASES = [(name, v) for name, vals in VALUES.items() for v in vals]


def _value(v, geometry_cls):
    return geometry_cls.from_wkb(POINT_WKB) if v is GEOM else v


@pytest.mark.parametrize("name,value", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_find_column_violation(name, value):
    out = []
    for schema_cls, geom in ((JSchema, JGeometry), (TSchema, TGeometry)):
        schema = schema_cls.from_column_dicts(COLUMNS)
        col = next(c for c in schema.columns if c.name == name)
        out.append(schema.find_column_violation(col, _value(value, geom)))
    assert out[0] == out[1]


def _feature(overrides, geometry_cls):
    row = {c["name"]: None for c in COLUMNS}
    row.update({k: _value(v, geometry_cls) for k, v in overrides.items()})
    return row


@pytest.mark.parametrize("overrides,seed", [
    ({}, None),
    ({"i8": 500}, None),
    ({"i8": 500, "t5": "toolong", "day": "x"}, None),
    ({"i8": 500, "t5": "toolong"}, {"i8": "already found"}),
    ({"flag": True, "shape": GEOM}, {"t5": "earlier"}),
    ({"flag": True, "shape": GEOM}, {}),
])
def test_validate_feature(overrides, seed):
    """With and without a violations dict (pre-filled or not)."""
    out = []
    for schema_cls, geom in ((JSchema, JGeometry), (TSchema, TGeometry)):
        schema = schema_cls.from_column_dicts(COLUMNS)
        feature = _feature(overrides, geom)
        violations = None if seed is None else dict(seed)
        out.append((schema.validate_feature(feature), schema.validate_feature(feature, violations),
                    violations))
    assert out[0] == out[1]


PK_COLUMNS = [
    {"id": "a", "name": "code", "dataType": "text", "primaryKeyIndex": 1},
    {"id": "b", "name": "num", "dataType": "integer", "primaryKeyIndex": 0},
    {"id": "c", "name": "ratio", "dataType": "float"},
]


@pytest.mark.parametrize("columns,pks", [
    (COLUMNS, "12"), (COLUMNS, ["12"]), (COLUMNS, (12,)), (COLUMNS, "-5"),
    ([{"id": "f", "name": "f", "dataType": "float", "primaryKeyIndex": 0}], "1.25"),
    (PK_COLUMNS, ["7", "abc"]), (PK_COLUMNS, ("7", 8)), (PK_COLUMNS, ["1"]),
])
def test_sanitise_pks(columns, pks):
    assert (JSchema.from_column_dicts(columns).sanitise_pks(pks)
            == TSchema.from_column_dicts(columns).sanitise_pks(pks))


def _variants():
    base = [dict(c) for c in COLUMNS[:6]]
    renamed = [dict(c) for c in base]
    renamed[2]["name"] = "renamed"
    reordered = [base[0], base[3], base[1], base[2], base[4], base[5]]
    retyped = [dict(c) for c in base]
    retyped[3] = {**retyped[3], "dataType": "float"}
    resized = [dict(c) for c in base]
    resized[1] = {**resized[1], "size": 16}
    repk = [{k: v for k, v in c.items() if k != "primaryKeyIndex"} for c in base]
    repk[1]["primaryKeyIndex"] = 0
    added = base + [{"id": "new", "name": "new", "dataType": "text"}]
    dropped = base[:3] + base[4:]
    return {"same": base, "renamed": renamed, "reordered": reordered, "retyped": retyped,
            "resized": resized, "repk": repk, "added": added, "dropped": dropped,
            "everything": [repk[0], *reordered[2:], added[-1]]}


VARIANTS = _variants()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_schema_comparisons(variant):
    """``diff_types`` (sets of column ids), ``diff_type_counts`` and
    ``is_pk_compatible`` from the base columns to each variant."""
    out = []
    for schema_cls in (JSchema, TSchema):
        old = schema_cls.from_column_dicts(VARIANTS["same"])
        new = schema_cls.from_column_dicts(VARIANTS[variant])
        out.append((old.diff_types(new), old.diff_type_counts(new), old.is_pk_compatible(new),
                    new.is_pk_compatible(old)))
    assert out[0] == out[1]


def _db_roundtrip(columns):
    """Columns as a database would give them back: fresh ids."""
    return [{**c, "id": f"db-{i}"} for i, c in enumerate(columns)]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_align_to_self(variant):
    """Ids copied back onto a schema read from a database: by name, then
    by position, only with the same pk index and data type."""
    out = []
    for schema_cls in (JSchema, TSchema):
        old = schema_cls.from_column_dicts(VARIANTS["same"])
        new = schema_cls.from_column_dicts(_db_roundtrip(VARIANTS[variant]))
        out.append(old.align_to_self(new).to_column_dicts())
    assert out[0] == out[1]


VALUE = st.one_of(
    st.none(), st.booleans(), st.integers(-(2**70), 2**70), st.floats(allow_nan=False),
    st.text(max_size=12), st.binary(max_size=6),
    st.from_regex(r"\d{4}-\d{2}-\d{2}(T\d{2}:\d{2}:\d{2}(\.\d+)?Z?)?", fullmatch=True),
    st.from_regex(r"\d{1,2}:\d{2}(:\d{2})?", fullmatch=True),
    st.from_regex(r"P(\d+D)?(T\d+H)?", fullmatch=True),
)


@settings(max_examples=200, deadline=None)
@given(row=st.fixed_dictionaries({c["name"]: VALUE for c in COLUMNS if c["name"] != "shape"}))
def test_random_values_have_the_same_verdicts(row):
    out = []
    for schema_cls in (JSchema, TSchema):
        schema = schema_cls.from_column_dicts(COLUMNS)
        violations = {}
        out.append((schema.validate_feature({**row, "shape": None}, violations), violations))
    assert out[0] == out[1]
