"""Feature-blob and meta serialisation, byte-compatible with Kart's
Datasets V3 format: msgpack with geometry values as ext type ``G``
(``0x47``) wrapping GeoPackage binary, and truncated-sha256 hex hashes.

Counterpart of kart_tpu's ``core/serialise.py`` (``msg_pack``,
``msg_unpack``, ``msg_unpack_ext_raw``, ``json_pack``, ``hexhash``,
``b64hash``, ``uint32hash``) over
the port's own msgpack codec (:mod:`kart_tpu_torch.core.msgpack`).
"""

import base64
import hashlib
import json
import struct

from kart_tpu_torch.core.msgpack import ExtType, packb, unpackb

GEOMETRY_EXT_CODE = 0x47  # ord("G")


def _pack_hook(obj):
    from kart_tpu_torch.geometry import Geometry

    if isinstance(obj, Geometry):
        return ExtType(GEOMETRY_EXT_CODE, bytes(obj))
    if isinstance(obj, tuple):
        return list(obj)
    return obj


def _unpack_ext_hook(code, data):
    if code == GEOMETRY_EXT_CODE:
        from kart_tpu_torch.geometry import Geometry

        return Geometry.of(data)
    return ExtType(code, data)


def _unpack_ext_raw_hook(code, data):
    if code == GEOMETRY_EXT_CODE:
        return data
    return ExtType(code, data)


def msg_pack(value) -> bytes:
    """Any value -> canonical msgpack bytes."""
    return packb(value, default=_pack_hook)


def msg_unpack(data):
    """msgpack bytes / buffer -> value, geometries as Geometry."""
    return unpackb(data, ext_hook=_unpack_ext_hook)


def msg_unpack_ext_raw(data):
    """Like :func:`msg_unpack`, with geometry payloads left as raw GPKG
    bytes (the fused blob->JSON path hexes them directly)."""
    return unpackb(data, ext_hook=_unpack_ext_raw_hook)


def json_pack(value) -> bytes:
    return json.dumps(value).encode("utf8")


def json_unpack(data):
    return json.loads(data)


def ensure_bytes(data) -> bytes:
    return data.encode("utf8") if isinstance(data, str) else data


def ensure_text(data) -> str:
    return data.decode("utf8") if isinstance(data, bytes) else data


def _sha256_of(*parts):
    h = hashlib.sha256()
    for p in parts:
        h.update(ensure_bytes(p))
    return h


def hexhash(*parts) -> str:
    """Truncated (160-bit) hex sha256, e.g. legend ids."""
    return _sha256_of(*parts).hexdigest()[:40]


def b64hash(*parts) -> str:
    """Truncated (160-bit) urlsafe-base64 sha256: the tree names of
    hash-keyed feature paths."""
    return base64.urlsafe_b64encode(_sha256_of(*parts).digest()[:20]).decode("ascii")


def uint32hash(*parts) -> int:
    """The first four bytes of the sha256, big-endian (custom CRS ids)."""
    return struct.unpack(">I", _sha256_of(*parts).digest()[:4])[0]


def b64encode_str(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).decode("ascii")


def b64decode_str(text: str) -> bytes:
    return base64.urlsafe_b64decode(text)
