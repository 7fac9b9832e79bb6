"""kartpack v1, the stream objects travel in between repositories:

    MAGIC ("KARTPACK1\\0")
    repeated: 1-byte type code | uint32 raw-len | uint32 deflate-len | deflate
    end record (type code 0) | 32-byte sha256 trailer over everything before it

There is no delta compression, so the stream is written and read in one
pass each.

Counterpart of kart_tpu's ``transport/pack.py``, byte for byte:
``write_pack``, ``read_pack`` and ``PackFormatError``. The fault-injection
points and the mid-stream resume of a torn transfer serve the network lanes,
which are not ported.
"""

import hashlib
import struct
import zlib

MAGIC = b"KARTPACK1\x00"

_TYPE_TO_CODE = {"commit": 1, "tree": 2, "blob": 3, "tag": 4}
_CODE_TO_TYPE = {v: k for k, v in _TYPE_TO_CODE.items()}
_END = 0


class PackFormatError(ValueError):
    pass


def write_pack(fileobj, objects):
    """Stream ``(type_str, content_bytes)`` pairs into ``fileobj``.
    -> the number of objects written."""
    digest = hashlib.sha256()

    def emit(data):
        digest.update(data)
        fileobj.write(data)

    emit(MAGIC)
    count = 0
    for obj_type, content in objects:
        code = _TYPE_TO_CODE.get(obj_type)
        if code is None:
            raise PackFormatError(f"Unknown object type: {obj_type!r}")
        deflated = zlib.compress(content, 1)
        emit(struct.pack(">BII", code, len(content), len(deflated)))
        emit(deflated)
        count += 1
    emit(struct.pack(">BII", _END, 0, 0))
    fileobj.write(digest.digest())
    return count


def read_pack(fileobj):
    """Yield ``(type_str, content_bytes)`` from a packstream; the checksum
    trailer is verified after the last object."""
    digest = hashlib.sha256()

    def pull(n):
        data = fileobj.read(n)
        if len(data) != n:
            raise PackFormatError("Truncated packstream")
        digest.update(data)
        return data

    if pull(len(MAGIC)) != MAGIC:
        raise PackFormatError("Bad packstream magic")
    while True:
        code, raw_len, deflate_len = struct.unpack(">BII", pull(9))
        if code == _END:
            break
        obj_type = _CODE_TO_TYPE.get(code)
        if obj_type is None:
            raise PackFormatError(f"Bad object type code: {code}")
        try:
            content = zlib.decompress(pull(deflate_len))
        except zlib.error:
            raise PackFormatError("Corrupt deflate stream in packstream") from None
        if len(content) != raw_len:
            raise PackFormatError("Object length mismatch in packstream")
        yield obj_type, content
    if fileobj.read(32) != digest.digest():
        raise PackFormatError("Packstream checksum mismatch")
