"""kartpack v1 — the wire format for object exchange.

A packstream is a self-delimiting sequence of git-format objects:

    MAGIC ("KARTPACK1\\0")
    repeated: 1-byte type code | uint32 raw-len | uint32 deflate-len | deflate
    end record (type code 0) | 32-byte sha256 trailer over everything prior

Unlike git's packfiles there is no delta compression — objects here are
already small msgpack blobs and zlib handles redundancy well enough; in
exchange the stream is single-pass writable AND single-pass readable, which
is what the promisor fetch path wants (reference: `git fetch --stdin`
pipelining, kart/promisor_utils.py:75-124).
"""

import hashlib
import struct
import zlib

from kart_tpu_torch import faults

MAGIC = b"KARTPACK1\x00"

_TYPE_TO_CODE = {"commit": 1, "tree": 2, "blob": 3, "tag": 4}
_CODE_TO_TYPE = {v: k for k, v in _TYPE_TO_CODE.items()}
_END = 0


class PackFormatError(ValueError):
    pass


def write_pack(fileobj, objects):
    """Stream ``(type_str, content_bytes)`` pairs into fileobj. Returns the
    number of objects written."""
    digest = hashlib.sha256()

    def emit(data):
        digest.update(data)
        fileobj.write(data)

    fault = faults.hook("transport.write.frame")
    emit(MAGIC)
    count = 0
    for obj_type, content in objects:
        if fault is not None:
            fault()
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


def read_pack(fileobj, *, mid_stream=False, consumed=None):
    """Yield ``(type_str, content_bytes)`` from a packstream, verifying the
    checksum trailer.

    ``mid_stream=True`` consumes a stream that begins at a *record
    boundary* rather than at the magic (a byte-range resume of a torn
    transfer, docs/SERVING.md §3): the magic check is skipped and the
    trailer is read but not verified — its digest covers bytes the earlier,
    torn attempt consumed. Integrity holds regardless: every record is
    individually zlib- and length-verified, and receivers recompute oids
    from content.

    ``consumed``: an optional one-element list updated (before each yield)
    with the exact stream bytes consumed through that record — the resume
    offset a ``Range: bytes=N-`` retry needs, tracked here so callers can
    put a read-ahead buffer *under* this reader without miscounting."""
    digest = hashlib.sha256()

    def pull(n):
        data = fileobj.read(n)
        if len(data) != n:
            raise PackFormatError("Truncated packstream")
        digest.update(data)
        return data

    if consumed is not None:
        consumed[0] = 0
    if not mid_stream:
        if pull(len(MAGIC)) != MAGIC:
            raise PackFormatError("Bad packstream magic")
        if consumed is not None:
            consumed[0] = len(MAGIC)
    fault = faults.hook("transport.read.frame")
    while True:
        if fault is not None:
            fault()
        code, raw_len, deflate_len = struct.unpack(">BII", pull(9))
        if code == _END:
            break
        obj_type = _CODE_TO_TYPE.get(code)
        if obj_type is None:
            raise PackFormatError(f"Bad object type code: {code}")
        deflated = pull(deflate_len)
        try:
            content = zlib.decompress(deflated)
        except zlib.error:
            # the declared escape for crafted bytes is PackFormatError;
            # zlib.error leaking here broke the wire-fuzz contract
            raise PackFormatError(
                "Corrupt deflate stream in packstream"
            ) from None
        if len(content) != raw_len:
            raise PackFormatError("Object length mismatch in packstream")
        if consumed is not None:
            consumed[0] += 9 + deflate_len
        yield obj_type, content
    expected = digest.digest()
    trailer = fileobj.read(32)
    if len(trailer) != 32:
        raise PackFormatError("Packstream checksum mismatch")
    if not mid_stream and trailer != expected:
        raise PackFormatError("Packstream checksum mismatch")
