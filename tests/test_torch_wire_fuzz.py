"""The prefix fuzz of kart_tpu's wire decoders, on the port's decoders:
for each decoder kart_tpu's ``registry.TAINT_SOURCES`` declares
``fuzz=True`` and the port has (all but the events log, whose feed is not
ported), every 1-byte-truncated prefix and every single-bit flip of a
golden payload; the only exception that may escape is the one kart_tpu
declares, as the port's class of that name."""

import io
import json
import struct

import numpy as np
import pytest

from kart_tpu.analysis import registry

#: kart_tpu's fuzz-declared decoders the port does not have
NOT_PORTED = {"kart_tpu/events/log.py::_parse_lines"}


def _tile_fixture():
    keys = (1 << 24) + np.arange(7, dtype=np.int64) * 3
    boxes = np.asarray(
        [[i, i + 1, i + 40, i + 41] for i in range(7)], dtype=np.int32
    )
    return keys, boxes


def _golden_payload():
    from types import SimpleNamespace

    from kart_tpu_torch.tiles import encode

    keys, boxes = _tile_fixture()
    source = SimpleNamespace(commit_oid="ab" * 20, ds_path="fuzz/ds")
    built = {"bin": encode.encode_bin_layer(keys, boxes)}
    return encode.assemble_payload(
        source, 3, 1, 2, ["bin"], built, len(keys)
    )


def _adapters():
    """{registry key: (golden bytes, decoder callable)} — built lazily so
    collecting this module never imports the wire stack."""
    from kart_tpu_torch import geom
    from kart_tpu_torch.query import scan
    from kart_tpu_torch.tiles import encode, streams
    from kart_tpu_torch.transport import http, pack

    keys, boxes = _tile_fixture()

    vcol = geom.VertexColumn(
        np.asarray([geom.KIND_POLY, geom.KIND_NONE, geom.KIND_LINE], np.uint8),
        np.asarray([0, 1, 1, 2], np.int64),
        np.asarray([0, 4, 6], np.int64),
        np.asarray([0, 500, 500, 0, -200, 300], np.int32),
        np.asarray([0, 0, 500, 500, -100, 250], np.int32),
    )
    vcol_golden = geom.encode_vertex_column(vcol)

    codes = np.arange(20, dtype=np.uint64) * 7 + 3
    varint_golden = streams.varint_encode(codes)

    stream_values = np.repeat(
        np.asarray([5, -3, 12], np.int64), [7, 5, 9]
    )
    stream_golden = streams.encode_stream(stream_values)

    items = [b"a", b"bb", b"", b"abc" * 5, b"bb"]
    bytes_golden = streams.encode_bytes_stream(items)

    pack_buf = io.BytesIO()
    pack.write_pack(
        pack_buf, [("blob", b"hello"), ("tree", b""), ("commit", b"c\n")]
    )
    pack_golden = pack_buf.getvalue()

    framed_header = json.dumps({"v": 1, "oids": ["ab" * 20]}).encode()
    framed_golden = (
        struct.pack(">Q", len(framed_header)) + framed_header + b"PACK"
    )

    return {
        "kart_tpu/tiles/streams.py::varint_decode": (
            varint_golden,
            lambda data: streams.varint_decode(data, len(codes)),
        ),
        "kart_tpu/tiles/streams.py::decode_stream": (
            stream_golden,
            lambda data: streams.decode_stream(data, len(stream_values)),
        ),
        "kart_tpu/tiles/streams.py::decode_bytes_stream": (
            bytes_golden,
            lambda data: streams.decode_bytes_stream(data, len(items)),
        ),
        "kart_tpu/tiles/encode.py::decode_bin_layer": (
            encode.encode_bin_layer(keys, boxes),
            encode.decode_bin_layer,
        ),
        "kart_tpu/tiles/encode.py::decode_ktb2_layer": (
            encode.encode_ktb2_layer(keys, boxes),
            # a tight cap, as a serving caller would pass: flipped count
            # fields otherwise allocate up to MAX_DECODE_ROWS per case
            lambda data: encode.decode_ktb2_layer(data, max_count=1 << 12),
        ),
        "kart_tpu/tiles/encode.py::decode_props_layer": (
            encode.encode_props_layer([b"x=1", b"", b"name=a b"]),
            encode.decode_props_layer,
        ),
        "kart_tpu/tiles/encode.py::decode_mvt_layer": (
            encode.encode_mvt_layer("fuzz", keys, boxes),
            encode.decode_mvt_layer,
        ),
        "kart_tpu/tiles/encode.py::parse_payload": (
            _golden_payload(),
            encode.parse_payload,
        ),
        "kart_tpu/geom.py::decode_vertex_column": (
            vcol_golden,
            lambda data: geom.decode_vertex_column(data, 3),
        ),
        "kart_tpu/transport/pack.py::read_pack": (
            pack_golden,
            lambda data: list(pack.read_pack(io.BytesIO(data))),
        ),
        "kart_tpu/transport/http.py::read_framed": (
            framed_golden,
            lambda data: http.read_framed(io.BytesIO(data)),
        ),
        "kart_tpu/query/scan.py::parse_bbox": (
            b"1.5,-2,3.5,4",
            lambda data: scan.parse_bbox(
                data.decode("utf-8", "replace")
            ),
        ),
    }


def _declared_error(entry):
    """Resolve the registry's error name to the exception class."""
    name = entry.get("error")
    if name is None:
        return None
    from kart_tpu_torch.query import QueryError
    from kart_tpu_torch.tiles.streams import TileEncodeError
    from kart_tpu_torch.transport.http import HttpTransportError
    from kart_tpu_torch.transport.pack import PackFormatError
    from kart_tpu_torch.transport.stdio import StdioTransportError

    return {
        "TileEncodeError": TileEncodeError,
        "PackFormatError": PackFormatError,
        "HttpTransportError": HttpTransportError,
        "StdioTransportError": StdioTransportError,
        "QueryError": QueryError,
    }[name]


def _fuzz_cases(golden):
    """Every strict prefix, then every single-bit flip of every byte."""
    for end in range(len(golden)):
        yield f"prefix[:{end}]", golden[:end]
    for i in range(len(golden)):
        for bit in range(8):
            flipped = bytearray(golden)
            flipped[i] ^= 1 << bit
            yield f"flip[{i}]^{1 << bit:#04x}", bytes(flipped)


FUZZ_KEYS = sorted(
    k for k, v in registry.TAINT_SOURCES.items() if v.get("fuzz") and k not in NOT_PORTED
)


def test_every_ported_fuzz_declared_decoder_has_an_adapter():
    missing = [k for k in FUZZ_KEYS if k not in _adapters()]
    assert not missing, f"fuzz-declared decoders without an adapter here: {missing}"


@pytest.mark.parametrize("key", FUZZ_KEYS)
def test_only_the_declared_error_escapes(key):
    golden, decode = _adapters()[key]
    assert len(golden) > 8, f"golden payload for {key} is implausibly small"
    error = _declared_error(registry.TAINT_SOURCES[key])
    decode(golden)  # the golden payload itself must decode
    for label, case in _fuzz_cases(golden):
        try:
            decode(case)
        except Exception as e:
            if error is None or not isinstance(e, error):
                pytest.fail(
                    f"{key}: {label} escaped with "
                    f"{type(e).__name__}: {e} (declared escape: "
                    f"{registry.TAINT_SOURCES[key].get('error')})"
                )
