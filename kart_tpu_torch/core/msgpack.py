"""The msgpack subset Kart writes, in pure Python.

Packing is byte-identical to ``msgpack.packb(value, use_bin_type=True,
strict_types=True)`` with Kart's default hook: the smallest encoding for
each int (unsigned types for non-negative values, signed types below -32),
float always as float64 (``0xcb``), str8/str16/str32 above 31/255/65535
bytes, bin8 from length 0, fixext for payloads of exactly 1, 2, 4, 8 or 16
bytes and ext8/16/32 otherwise. As under ``strict_types``, only the exact
types ``None``, ``bool``, ``int``, ``float``, ``str``, ``bytes``,
``bytearray``, ``memoryview``, ``list``, ``dict`` and :class:`ExtType` pack
directly; anything else goes once through ``default`` and must come back
as one of those (Kart's hook turns tuples into lists and geometries into
ext ``0x47``), else ``TypeError``.

Unpacking decodes what ``msgpack.unpackb(raw=False)`` decodes: str as
text, bin as bytes, arrays as lists, maps as dicts whose keys must be str
or bytes, ext through ``ext_hook`` (default: :class:`ExtType`). Ext code -1
(msgpack's timestamp) is not special-cased: Kart never writes it.
"""

import struct
from collections import namedtuple

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_f = struct.Struct(">f")
_d = struct.Struct(">d")


class ExtType(namedtuple("ExtType", "code data")):
    """An extension value: ``code`` in -128..127 and its ``bytes`` payload."""

    def __new__(cls, code, data):
        if not isinstance(code, int) or not -128 <= code <= 127:
            raise ValueError("ExtType code must be an int in -128..127")
        if not isinstance(data, bytes):
            raise TypeError("ExtType data must be bytes")
        return super().__new__(cls, code, data)


class UnpackError(ValueError):
    """Malformed, truncated or trailing-data msgpack input."""


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_int(v, out):
    if v >= 0:
        if v < 0x80:
            out.append(_B.pack(v))
        elif v < 0x100:
            out.append(b"\xcc" + _B.pack(v))
        elif v < 0x10000:
            out.append(b"\xcd" + _H.pack(v))
        elif v < 0x100000000:
            out.append(b"\xce" + _I.pack(v))
        elif v < 0x10000000000000000:
            out.append(b"\xcf" + _Q.pack(v))
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out.append(_b.pack(v))
    elif v >= -0x80:
        out.append(b"\xd0" + _b.pack(v))
    elif v >= -0x8000:
        out.append(b"\xd1" + _h.pack(v))
    elif v >= -0x80000000:
        out.append(b"\xd2" + _i.pack(v))
    elif v >= -0x8000000000000000:
        out.append(b"\xd3" + _q.pack(v))
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n, small_base, small_max, codes, out, what):
    """Header of a container/str with the given length classes."""
    if small_base is not None and n <= small_max:
        out.append(_B.pack(small_base | n))
    elif codes[0] is not None and n < 0x100:
        out.append(_B.pack(codes[0]) + _B.pack(n))
    elif n < 0x10000:
        out.append(_B.pack(codes[1]) + _H.pack(n))
    elif n < 0x100000000:
        out.append(_B.pack(codes[2]) + _I.pack(n))
    else:
        raise ValueError(f"{what} is too large")


def _pack_ext(code, data, out):
    n = len(data)
    head = _FIXEXT.get(n)
    if head is not None:
        out.append(_B.pack(head) + _b.pack(code))
    elif n < 0x100:
        out.append(b"\xc7" + _B.pack(n) + _b.pack(code))
    elif n < 0x10000:
        out.append(b"\xc8" + _H.pack(n) + _b.pack(code))
    elif n < 0x100000000:
        out.append(b"\xc9" + _I.pack(n) + _b.pack(code))
    else:
        raise ValueError("EXT data is too large")
    out.append(data)


def _pack(o, out, default, depth, default_used=False):
    if depth < 0:
        raise ValueError("recursion limit exceeded")
    t = o.__class__
    if o is None:
        out.append(b"\xc0")
    elif o is True:
        out.append(b"\xc3")
    elif o is False:
        out.append(b"\xc2")
    elif t is int:
        _pack_int(o, out)
    elif t is float:
        out.append(b"\xcb" + _d.pack(o))
    elif t is str:
        data = o.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out, "String")
        out.append(data)
    elif t is bytes or t is bytearray or t is memoryview:
        data = bytes(o)
        _pack_len(len(data), None, 0, (0xC4, 0xC5, 0xC6), out, "Bytes")
        out.append(data)
    elif t is list:
        _pack_len(len(o), 0x90, 15, (None, 0xDC, 0xDD), out, "list")
        for v in o:
            _pack(v, out, default, depth - 1)
    elif t is dict:
        _pack_len(len(o), 0x80, 15, (None, 0xDE, 0xDF), out, "dict")
        for k, v in o.items():
            _pack(k, out, default, depth - 1)
            _pack(v, out, default, depth - 1)
    elif t is ExtType:
        _pack_ext(o.code, o.data, out)
    elif default is not None and not default_used:
        _pack(default(o), out, default, depth, True)
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def packb(value, default=None):
    """value -> msgpack bytes (``use_bin_type=True, strict_types=True``)."""
    out = []
    _pack(value, out, default, 512)
    return b"".join(out)


def _need(data, end):
    if end > len(data):
        raise UnpackError("Unpack failed: incomplete input")


def _unpack(data, pos, ext_hook, depth):
    if depth < 0:
        raise UnpackError("recursion limit exceeded")
    _need(data, pos + 1)
    c = data[pos]
    pos += 1
    if c <= 0x7F:
        return c, pos
    if c >= 0xE0:
        return c - 0x100, pos
    if 0xA0 <= c <= 0xBF:
        return _str(data, pos, c & 0x1F)
    if 0x90 <= c <= 0x9F:
        return _array(data, pos, c & 0x0F, ext_hook, depth)
    if 0x80 <= c <= 0x8F:
        return _map(data, pos, c & 0x0F, ext_hook, depth)
    if c == 0xC0:
        return None, pos
    if c == 0xC2:
        return False, pos
    if c == 0xC3:
        return True, pos
    fixed = _FIXED.get(c)
    if fixed is not None:
        st = fixed
        _need(data, pos + st.size)
        return st.unpack_from(data, pos)[0], pos + st.size
    if 0xD4 <= c <= 0xD8:
        return _ext(data, pos, 1 << (c - 0xD4), ext_hook)
    kind_len = _SIZED.get(c)
    if kind_len is None:
        raise UnpackError(f"Unpack failed: bad type byte 0x{c:02x}")
    kind, st = kind_len
    _need(data, pos + st.size)
    n = st.unpack_from(data, pos)[0]
    pos += st.size
    if kind == "str":
        return _str(data, pos, n)
    if kind == "bin":
        _need(data, pos + n)
        return bytes(data[pos : pos + n]), pos + n
    if kind == "ext":
        return _ext(data, pos, n, ext_hook)
    if kind == "array":
        return _array(data, pos, n, ext_hook, depth)
    return _map(data, pos, n, ext_hook, depth)


_FIXED = {
    0xCA: _f, 0xCB: _d,
    0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q,
    0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q,
}
_SIZED = {
    0xC4: ("bin", _B), 0xC5: ("bin", _H), 0xC6: ("bin", _I),
    0xC7: ("ext", _B), 0xC8: ("ext", _H), 0xC9: ("ext", _I),
    0xD9: ("str", _B), 0xDA: ("str", _H), 0xDB: ("str", _I),
    0xDC: ("array", _H), 0xDD: ("array", _I),
    0xDE: ("map", _H), 0xDF: ("map", _I),
}


def _str(data, pos, n):
    _need(data, pos + n)
    return bytes(data[pos : pos + n]).decode("utf-8"), pos + n


def _ext(data, pos, n, ext_hook):
    _need(data, pos + 1 + n)
    code = _b.unpack_from(data, pos)[0]
    payload = bytes(data[pos + 1 : pos + 1 + n])
    return ext_hook(code, payload), pos + 1 + n


def _array(data, pos, n, ext_hook, depth):
    _need(data, pos + n)  # every element takes at least one byte
    out = []
    for _ in range(n):
        v, pos = _unpack(data, pos, ext_hook, depth - 1)
        out.append(v)
    return out, pos


def _map(data, pos, n, ext_hook, depth):
    _need(data, pos + 2 * n)
    out = {}
    for _ in range(n):
        k, pos = _unpack(data, pos, ext_hook, depth - 1)
        if k.__class__ not in (str, bytes):
            raise UnpackError(f"{k.__class__.__name__} is not allowed for map key")
        v, pos = _unpack(data, pos, ext_hook, depth - 1)
        out[k] = v
    return out, pos


def unpackb(data, ext_hook=ExtType):
    """msgpack bytes (or a buffer) holding exactly one value -> value.
    Raises :class:`UnpackError` on truncated, malformed or trailing data."""
    if not isinstance(data, bytes):
        data = bytes(data)
    value, pos = _unpack(data, 0, ext_hook, 512)
    if pos != len(data):
        raise UnpackError("Unpack failed: extra data")
    return value
