"""The port's msgpack codec against msgpack itself and kart_tpu's
serialise: byte-identical packing (``use_bin_type=True,
strict_types=True``), and decoding of whatever ``unpackb(raw=False)``
decodes, geometry ext included."""

import math

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from kart_tpu.core import serialise as jser
from kart_tpu.geometry import Geometry as JGeometry
from kart_tpu_torch.core import msgpack as tmp
from kart_tpu_torch.core import serialise as tser
from kart_tpu_torch.geometry import Geometry as TGeometry


def _ref_pack(value):
    return msgpack.packb(value, use_bin_type=True, strict_types=True)


def _same_value(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same_value(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(_same_value(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


scalars = (
    st.none() | st.booleans()
    | st.integers(min_value=-(2**63), max_value=2**64 - 1)
    | st.floats(allow_nan=True, allow_infinity=True)
    | st.text(max_size=300) | st.binary(max_size=300)
)
values = st.recursive(
    scalars,
    lambda children: st.lists(children, max_size=20)
    | st.dictionaries(st.text(max_size=10) | st.binary(max_size=10), children, max_size=20),
    max_leaves=60,
)


@settings(max_examples=300, deadline=None)
@given(values)
def test_pack_and_unpack_match_msgpack(value):
    raw = _ref_pack(value)
    assert tmp.packb(value) == raw
    assert _same_value(tmp.unpackb(raw), msgpack.unpackb(raw, raw=False))


INT_EDGES = sorted({
    s * (b + d)
    for b in (0, 2**7, 2**8, 2**15, 2**16, 2**31, 2**32, 2**63)
    for d in (-1, 0, 1)
    for s in (1, -1)
    if -(2**63) <= s * (b + d) < 2**64
} | {-32, -33, 2**64 - 1, -(2**63)})

STR_LENGTHS = [0, 1, 30, 31, 32, 254, 255, 256, 65534, 65535, 65536, 70000]


@pytest.mark.parametrize("v", INT_EDGES)
def test_int_edges(v):
    raw = _ref_pack(v)
    assert tmp.packb(v) == raw
    assert tmp.unpackb(raw) == v


@pytest.mark.parametrize("n", STR_LENGTHS)
def test_str_and_bin_thresholds(n):
    for v in ("x" * n, b"\x01" * n, ["y"] * min(n, 70000), {str(i): i for i in range(min(n, 300))}):
        raw = _ref_pack(v)
        assert tmp.packb(v) == raw
        assert tmp.unpackb(raw) == msgpack.unpackb(raw, raw=False)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 8, 15, 16, 17, 255, 256, 65536])
def test_ext_fixext_and_ext_lengths(n):
    data = bytes(range(256)) * (n // 256) + bytes(range(n % 256))
    raw = msgpack.packb(msgpack.ExtType(5, data))
    assert tmp.packb(tmp.ExtType(5, data)) == raw
    assert tmp.unpackb(raw) == tmp.ExtType(5, data)


def test_floats_always_float64_and_float32_decodes():
    for v in (0.0, -0.0, 1.5, 1e300, float("inf"), float("-inf")):
        assert tmp.packb(v) == _ref_pack(v) and tmp.packb(v)[0] == 0xCB
    raw = msgpack.packb(1.5, use_single_float=True)
    assert raw[0] == 0xCA and tmp.unpackb(raw) == 1.5


def test_strict_types_and_errors():
    class MyInt(int):
        pass

    for bad in (MyInt(3), object()):
        with pytest.raises(TypeError):
            msgpack.packb(bad, use_bin_type=True, strict_types=True)
        with pytest.raises(TypeError):
            tmp.packb(bad)
    with pytest.raises(OverflowError):
        tmp.packb(2**64)
    for bad in (b"\x92\x01", b"\xc1", b"\x01\x02", b"\x81\x01\x02", b"\xa3ab"):
        with pytest.raises(ValueError):
            msgpack.unpackb(bad, raw=False)
        with pytest.raises(ValueError):
            tmp.unpackb(bad)


GEOMS = [
    bytes.fromhex("47500001000000000101000000000000000000f03f0000000000000040"),  # point
    bytes.fromhex("4750000300000000000000000000f03f000000000000004000000000000008400000"
                  "000000001040010200000002000000000000000000f03f00000000000008400000"
                  "0000000000400000000000001040"),  # linestring with XY envelope
    b"GP\x00\x11\x00\x00\x00\x00\x01\x01\x00\x00\x00" + b"\x00\x00\x00\x00\x00\x00\xf8\x7f" * 2,
]


@pytest.mark.parametrize("i", range(len(GEOMS)))
def test_feature_values_against_kart_tpu_serialise(i):
    geom = GEOMS[i]
    for value in (
        ["0123456789abcdef0123456789abcdef01234567", [JGeometry(geom), "name", 1.5, None, True]],
        [("a", "b"), ("c",)],
        {"geom": JGeometry(geom), "n": -40},
    ):
        port_value = _to_port(value)
        raw = jser.msg_pack(value)
        assert tser.msg_pack(port_value) == raw
        decoded = tser.msg_unpack(raw)
        assert _same_value(_from_port(decoded), jser.msg_unpack(raw))
        assert _from_port(tser.msg_unpack_ext_raw(raw)) == jser.msg_unpack_ext_raw(raw)
    decoded = tser.msg_unpack(jser.msg_pack([JGeometry(geom)]))[0]
    assert type(decoded) is TGeometry and bytes(decoded) == geom
    assert decoded.to_hex_wkb() == JGeometry(geom).to_hex_wkb()


def _to_port(v):
    if isinstance(v, JGeometry):
        return TGeometry(bytes(v))
    if isinstance(v, (list, tuple)):
        return type(v)(_to_port(x) for x in v)
    if isinstance(v, dict):
        return {k: _to_port(x) for k, x in v.items()}
    return v


def _from_port(v):
    if isinstance(v, TGeometry):
        return JGeometry(bytes(v))
    if isinstance(v, list):
        return [_from_port(x) for x in v]
    if isinstance(v, dict):
        return {k: _from_port(x) for k, x in v.items()}
    return v
