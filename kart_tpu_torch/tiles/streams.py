"""KTB2 integer-stream encoding: one int column -> a 5-byte header
(encoding id, payload byte length) and the cheapest of five payloads,
picked by an exact cost probe that builds no bytes.

====  =========  ==========================================================
id    name       payload (little-endian; varints are LEB128, zigzag maps
                 signed to unsigned)
====  =========  ==========================================================
0     raw        ``count`` fixed-width values (the column's wire dtype)
1     rle        varint run count, then per run: varint length,
                 zigzag-varint value
2     for        zigzag-varint base (column min), u8 bit width ``w``,
                 ``ceil(count*w/8)`` bytes of bit-packed ``value - base``
                 (big-endian within each value)
3     dvarint    zigzag-varint first value, then ``count-1`` zigzag
                 varint deltas
4     dfor       zigzag-varint first value, then FOR over the deltas
====  =========  ==========================================================

Counterpart of kart_tpu's ``tiles/streams.py`` for int streams: the
encoder (``zigzag``, ``varint_lengths``, ``varint_encode``, ``bit_width``,
``bitpack``, ``_runs``, ``_probe_sizes``, ``encode_stream``) writes the same
bytes for the same column, and the decoder (``unzigzag``,
``varint_decode``, ``bitunpack``, ``decode_stream``) accepts the same bytes
and raises :class:`TileEncodeError` with the same message on the rest.
Decoding is a taint boundary: every stream is bounds-checked, canonical
(no zero-padded varint, no split RLE run, no nonzero padding bits) and
consumed exactly, so one column has one byte string. The byte-string
dictionary stream of the ``props`` layer (:func:`encode_bytes_stream`,
:func:`decode_bytes_stream`) is kart_tpu's too.
"""

import struct

import numpy as np


class TileEncodeError(ValueError):
    """Malformed, truncated or oversized stream bytes, or an unknown
    encoding asked for."""


#: encoding ids (stream header byte)
RAW, RLE, FOR, DVARINT, DFOR = 0, 1, 2, 3, 4

ENCODING_NAMES = {RAW: "raw", RLE: "rle", FOR: "for", DVARINT: "dvarint", DFOR: "dfor"}

#: ceiling on the rows, rings or vertices one decoded column may claim: a
#: few crafted bytes must not demand a multi-GB allocation
MAX_DECODE_ROWS = 1 << 27

_STREAM_HEADER = struct.Struct("<BI")  # encoding id, payload byte length

_DTYPES = {"i4": np.dtype("<i4"), "i8": np.dtype("<i8")}


def zigzag(values):
    """int64 column -> uint64 zigzag codes (small magnitudes stay small)."""
    v = np.asarray(values, dtype=np.int64)
    return ((v << 1) ^ (v >> 63)).view(np.uint64)


#: 2**7, 2**14, ..., 2**63: a code needs one LEB128 byte more for each
_VARINT_STEPS = np.asarray([1 << (7 * k) for k in range(1, 10)], dtype=np.uint64)


def varint_lengths(codes):
    """Exact LEB128 byte length per uint64 code: one plus the number of
    steps at or below it (one sorted search, not a pass per step)."""
    u = np.asarray(codes, dtype=np.uint64)
    return np.searchsorted(_VARINT_STEPS, u, side="right").astype(np.int64) + 1


def varint_encode(codes):
    """uint64 codes -> LEB128 bytes, vectorized (one pass per byte slot)."""
    u = np.asarray(codes, dtype=np.uint64)
    if not len(u):
        return b""
    lens = varint_lengths(u)
    offsets = np.concatenate(([0], np.cumsum(lens)[:-1]))
    out = np.zeros(int(lens.sum()), dtype=np.uint8)
    for j in range(10):
        mask = lens > j
        if not mask.any():
            break
        chunk = ((u[mask] >> np.uint64(7 * j)) & np.uint64(0x7F)).astype(np.uint8)
        cont = (lens[mask] - 1 > j).astype(np.uint8) << 7
        out[offsets[mask] + j] = chunk | cont
    return out.tobytes()


def bit_width(umax):
    """Bits needed for the largest offset of a FOR frame (0 for a constant
    column)."""
    return int(umax).bit_length()


def bitpack(offsets, width):
    """uint64 offsets (< 2**width) -> packed bytes, big-endian within each
    value (``np.packbits`` order)."""
    if width == 0 or not len(offsets):
        return b""
    u = np.asarray(offsets, dtype=np.uint64)
    shifts = np.arange(width - 1, -1, -1, dtype=np.uint64)
    bits = ((u[:, None] >> shifts[None, :]) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits.reshape(-1)).tobytes()


def _runs(values):
    """-> (run start indices, run values, run lengths) of a column."""
    v = np.asarray(values)
    if not len(v):
        return (np.zeros(0, np.int64),) * 3
    starts = np.concatenate(([0], np.flatnonzero(v[1:] != v[:-1]) + 1))
    lengths = np.diff(np.concatenate((starts, [len(v)])))
    return starts, v[starts], lengths


def _probe_sizes(v, itemsize):
    """Exact payload size of each candidate encoding, no bytes built."""
    n = len(v)
    sizes = {RAW: n * itemsize}
    if n == 0:
        return sizes
    _starts, run_vals, run_lens = _runs(v)
    sizes[RLE] = int(
        varint_lengths(np.asarray([len(run_vals)], np.uint64))[0]
        + varint_lengths(run_lens.astype(np.uint64)).sum()
        + varint_lengths(zigzag(run_vals)).sum()
    )
    lo, hi = int(v.min()), int(v.max())
    w = bit_width(np.uint64(hi - lo))
    sizes[FOR] = int(varint_lengths(zigzag(np.asarray([lo], np.int64)))[0] + 1 + (n * w + 7) // 8)
    first_len = int(varint_lengths(zigzag(v[:1]))[0])
    if n > 1:
        deltas = v[1:] - v[:-1]
        sizes[DVARINT] = first_len + int(varint_lengths(zigzag(deltas)).sum())
        dlo, dhi = int(deltas.min()), int(deltas.max())
        dw = bit_width(np.uint64(dhi - dlo))
        sizes[DFOR] = (
            first_len
            + int(varint_lengths(zigzag(np.asarray([dlo], np.int64)))[0])
            + 1
            + ((n - 1) * dw + 7) // 8
        )
    else:
        sizes[DVARINT] = first_len
    return sizes


def encode_stream(values, dtype="i8", force=None):
    """One int column -> stream bytes (header + cheapest payload).
    ``dtype`` ("i4" | "i8") is the column's raw wire dtype; ``force`` pins
    an encoding id."""
    wire = _DTYPES[dtype]
    v = np.ascontiguousarray(values, dtype=np.int64)
    sizes = _probe_sizes(v, wire.itemsize)
    enc = force if force is not None else min(sizes, key=lambda k: (sizes[k], k))

    if enc == RAW:
        payload = np.ascontiguousarray(v, dtype=wire).tobytes()
    elif enc == RLE:
        _starts, run_vals, run_lens = _runs(v)
        payload = (
            varint_encode(np.asarray([len(run_vals)], np.uint64))
            + varint_encode(run_lens.astype(np.uint64))
            + varint_encode(zigzag(run_vals))
        )
    elif enc == FOR:
        lo = int(v.min()) if len(v) else 0
        w = bit_width(np.uint64(int(v.max()) - lo)) if len(v) else 0
        payload = (
            varint_encode(zigzag(np.asarray([lo], np.int64)))
            + struct.pack("<B", w)
            + bitpack((v - lo).astype(np.uint64), w)
        )
    elif enc == DVARINT:
        codes = zigzag(np.concatenate((v[:1], v[1:] - v[:-1]))) if len(v) else np.zeros(0, np.uint64)
        payload = varint_encode(codes)
    elif enc == DFOR:
        if len(v) < 2:
            # a delta frame needs two values: the dvarint shape
            return encode_stream(v, dtype, force=DVARINT)
        deltas = v[1:] - v[:-1]
        dlo = int(deltas.min())
        dw = bit_width(np.uint64(int(deltas.max()) - dlo))
        payload = (
            varint_encode(zigzag(v[:1]))
            + varint_encode(zigzag(np.asarray([dlo], np.int64)))
            + struct.pack("<B", dw)
            + bitpack((deltas - dlo).astype(np.uint64), dw)
        )
    else:
        raise TileEncodeError(f"Unknown stream encoding id {enc}")
    return _STREAM_HEADER.pack(enc, len(payload)) + payload


def unzigzag(codes):
    """uint64 zigzag codes -> int64 column."""
    u = np.asarray(codes, dtype=np.uint64)
    return ((u >> 1).astype(np.int64)) ^ -(u & 1).astype(np.int64)


def varint_decode(data, count, pos=0):
    """-> (uint64 codes (count,), next pos). Raises unless ``data[pos:]``
    holds ``count`` complete, canonical varints of at most 64 bits."""
    buf = np.frombuffer(data, dtype=np.uint8)
    if count == 0:
        return np.zeros(0, dtype=np.uint64), pos
    ends = np.flatnonzero(buf[pos:] < 0x80)
    if len(ends) < count:
        raise TileEncodeError(
            f"Truncated varint stream: {len(ends)} complete values of {count} expected")
    ends = ends[:count] + pos  # inclusive terminator positions
    starts = np.concatenate(([pos], ends[:-1] + 1))
    if np.any(ends - starts >= 10):
        raise TileEncodeError("Varint value longer than 10 bytes")
    # a 10-byte varint's last byte carries bits 63..69: above 1 it would
    # wrap in the shift below
    tenth = buf[ends[ends - starts == 9]]
    if len(tenth) and int(tenth.max()) > 1:
        raise TileEncodeError("Varint value exceeds uint64")
    # a multi-byte varint ending in 0x00 has a shorter encoding
    if np.any((ends > starts) & (buf[ends] == 0)):
        raise TileEncodeError("Non-canonical zero-padded varint")
    idx_in_group = np.arange(pos, ends[-1] + 1) - np.repeat(starts, ends - starts + 1)
    window = (buf[pos : ends[-1] + 1] & 0x7F).astype(np.uint64) << (
        np.uint64(7) * idx_in_group.astype(np.uint64))
    codes = np.add.reduceat(window, starts - pos)
    return codes, int(ends[-1]) + 1


def bitunpack(data, count, width, pos=0):
    """packed bytes -> uint64 offsets (count,); bounds-checked, and the
    last byte's unused low bits must be zero."""
    if width == 0 or count == 0:
        return np.zeros(count, dtype=np.uint64)
    nbytes = (count * width + 7) // 8
    if pos + nbytes > len(data):
        raise TileEncodeError(
            f"Truncated bit-packed stream: {len(data) - pos} bytes of {nbytes} expected")
    buf = np.frombuffer(data, dtype=np.uint8, count=nbytes, offset=pos)
    pad = nbytes * 8 - count * width
    if pad and buf[-1] & ((1 << pad) - 1):
        raise TileEncodeError("Nonzero padding bits in bit-packed stream")
    bits = np.unpackbits(buf, count=count * width).reshape(count, width)
    weights = np.uint64(1) << np.arange(width - 1, -1, -1, dtype=np.uint64)
    return (bits.astype(np.uint64) * weights[None, :]).sum(axis=1, dtype=np.uint64)


def decode_stream(data, count, dtype="i8", pos=0):
    """Stream bytes at ``pos`` -> (values (count,) of ``dtype``, next pos).
    One dispatch on the recorded encoding, whole-array numpy below it.
    Raises :class:`TileEncodeError` unless the payload decodes to exactly
    ``count`` values and consumes exactly its declared length."""
    wire = _DTYPES[dtype]
    if pos + _STREAM_HEADER.size > len(data):
        raise TileEncodeError("Truncated stream header")
    enc, nbytes = _STREAM_HEADER.unpack_from(data, pos)
    pos += _STREAM_HEADER.size
    end = pos + nbytes
    if end > len(data):
        raise TileEncodeError(
            f"Truncated stream payload: {len(data) - pos} bytes of {nbytes} declared")
    body = data[pos:end]

    if enc == RAW:
        if nbytes != count * wire.itemsize:
            raise TileEncodeError(
                f"Raw stream holds {nbytes} bytes for {count} {wire.itemsize}-byte values")
        out = np.frombuffer(body, dtype=wire, count=count).astype(np.int64)
        consumed = nbytes
    elif enc == RLE:
        head, p = varint_decode(body, 1)
        n_runs = int(head[0])
        run_lens, p = varint_decode(body, n_runs, p)
        run_vals, p = varint_decode(body, n_runs, p)
        lens = run_lens.astype(np.int64)
        # each run capped before the sum, which could wrap in int64
        if n_runs and (int(lens.min()) <= 0 or int(lens.max()) > count):
            raise TileEncodeError(f"RLE run length outside [1, {count}]")
        total = sum(int(x) for x in lens)
        if total != count:
            raise TileEncodeError(f"RLE runs sum to {total}, column holds {count}")
        vals = unzigzag(run_vals)
        if n_runs > 1 and np.any(vals[1:] == vals[:-1]):
            raise TileEncodeError("Non-canonical RLE: adjacent runs share a value")
        out = np.repeat(vals, lens)
        consumed = p
    elif enc == FOR:
        base, p = varint_decode(body, 1)
        if p + 1 > len(body):
            raise TileEncodeError("Truncated FOR stream width byte")
        w = body[p]
        p += 1
        if w > 64:
            raise TileEncodeError(f"FOR bit width {w} > 64")
        offs = bitunpack(body, count, w, p)
        out = unzigzag(base)[0] + offs.astype(np.int64)
        consumed = p + (count * w + 7) // 8
    elif enc in (DVARINT, DFOR):
        if count == 0:
            out = np.zeros(0, np.int64)
            consumed = 0
        elif enc == DVARINT:
            codes, p = varint_decode(body, count)
            out = np.cumsum(unzigzag(codes))
            consumed = p
        else:
            first, p = varint_decode(body, 1)
            dbase, p = varint_decode(body, 1, p)
            if p + 1 > len(body):
                raise TileEncodeError("Truncated DFOR stream width byte")
            w = body[p]
            p += 1
            if w > 64:
                raise TileEncodeError(f"DFOR bit width {w} > 64")
            offs = bitunpack(body, count - 1, w, p)
            deltas = unzigzag(dbase)[0] + offs.astype(np.int64)
            out = np.cumsum(np.concatenate((unzigzag(first), deltas)))
            consumed = p + ((count - 1) * w + 7) // 8
    else:
        raise TileEncodeError(f"Unknown stream encoding id {enc}")
    if consumed != nbytes:
        raise TileEncodeError(
            f"Stream payload declares {nbytes} bytes but its "
            f"{ENCODING_NAMES[enc]} encoding consumed {consumed}")
    if len(out) != count:
        raise TileEncodeError(f"Stream decoded {len(out)} values, column holds {count}")
    if dtype == "i4":
        lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
        if len(out) and (int(out.min()) < lo or int(out.max()) > hi):
            raise TileEncodeError("int32 stream value out of range")
    return out.astype(wire), end


# --- the dictionary-coded byte-string stream (the props layer) -------------------

def encode_bytes_stream(items):
    """List of byte strings -> dictionary-coded stream: each distinct string
    stored once, in first-occurrence order, and the column as an index
    stream into them.

    Layout: varint n_unique, an int stream of the unique byte lengths, the
    concatenated unique bytes, an int stream of row indices."""
    index = {}
    idx_col = np.empty(len(items), dtype=np.int64)
    uniques = []
    for i, item in enumerate(items):
        j = index.get(item)
        if j is None:
            j = index[item] = len(uniques)
            uniques.append(item)
        idx_col[i] = j
    lens = np.asarray([len(u) for u in uniques], dtype=np.int64)
    return b"".join((
        varint_encode(np.asarray([len(uniques)], np.uint64)),
        encode_stream(lens, "i8"),
        b"".join(uniques),
        encode_stream(idx_col, "i8"),
    ))


def decode_bytes_stream(data, count, pos=0):
    """-> (list of ``count`` byte strings, next pos); bounds-checked."""
    head, pos = varint_decode(data, 1, pos)
    n_unique = int(head[0])
    if n_unique > max(count, 0):
        raise TileEncodeError(f"Dictionary holds {n_unique} uniques for {count} rows")
    lens, pos = decode_stream(data, n_unique, "i8", pos)
    if len(lens) and int(lens.min()) < 0:
        raise TileEncodeError("Negative dictionary string length")
    # summed in Python ints: crafted lengths must not wrap past the check
    total = sum(int(x) for x in lens)
    if pos + total > len(data):
        raise TileEncodeError(f"Truncated dictionary blob: {len(data) - pos} bytes of {total}")
    uniques = []
    for n in lens:
        uniques.append(bytes(data[pos : pos + int(n)]))
        pos += int(n)
    idx, pos = decode_stream(data, count, "i8", pos)
    if len(idx) and (int(idx.min()) < 0 or int(idx.max()) >= n_unique):
        raise TileEncodeError("Dictionary index out of range")
    return [uniques[int(i)] for i in idx], pos
