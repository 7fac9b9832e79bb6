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

Counterpart of the encode half of kart_tpu's ``tiles/streams.py``
(``zigzag``, ``varint_lengths``, ``varint_encode``, ``bit_width``,
``bitpack``, ``_runs``, ``_probe_sizes``, ``encode_stream``): the same
bytes for the same column. The decoders are not ported: nothing in the
port reads a stream yet.
"""

import struct

import numpy as np


class TileEncodeError(ValueError):
    """An unknown stream encoding was asked for."""


#: encoding ids (stream header byte)
RAW, RLE, FOR, DVARINT, DFOR = 0, 1, 2, 3, 4

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
