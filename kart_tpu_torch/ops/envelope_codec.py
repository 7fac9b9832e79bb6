"""Bit-packed envelope codec, vectorized: a copy of kart_tpu's
ops/envelope_codec.py
(reference: kart/spatial_filter/index.py:485-548 EnvelopeEncoder and its C++
mirror vendor/spatial-filter/spatial_filter.cpp:30-152).

An envelope (w, s, e, n) in EPSG:4326 packs to 4 x 20-bit fixed-point values
(floor for w/s, ceil for e/n — the stored envelope always *contains* the real
one) concatenated big-endian into 10 bytes. Byte-compatible with the
reference's feature_envelopes.db so either implementation can read the other's
index. Scalar API matches the reference class; the batch API runs the whole
table as numpy uint64 lane math.
"""

import math

import numpy as np

DEFAULT_BITS_PER_VALUE = 20


class EnvelopeCodec:
    def __init__(self, bits_per_value=DEFAULT_BITS_PER_VALUE):
        assert bits_per_value % 2 == 0
        self.bits = bits_per_value
        self.value_max = 2**bits_per_value - 1
        self.nbytes = bits_per_value // 2  # 4 values * bits / 8

    # -- scalar (reference-identical) ---------------------------------------

    def encode(self, envelope):
        w, s, e, n = envelope
        integer = self._encode_value(w, -180, 180, math.floor)
        integer = (integer << self.bits) | self._encode_value(s, -90, 90, math.floor)
        integer = (integer << self.bits) | self._encode_value(e, -180, 180, math.ceil)
        integer = (integer << self.bits) | self._encode_value(n, -90, 90, math.ceil)
        return integer.to_bytes(self.nbytes, "big")

    def _encode_value(self, value, lo, hi, round_fn):
        assert lo <= value <= hi, (value, lo, hi)
        return round_fn((value - lo) / (hi - lo) * self.value_max)

    def decode(self, data):
        integer = int.from_bytes(data, "big")
        n = self._decode_value(integer & self.value_max, -90, 90)
        integer >>= self.bits
        e = self._decode_value(integer & self.value_max, -180, 180)
        integer >>= self.bits
        s = self._decode_value(integer & self.value_max, -90, 90)
        integer >>= self.bits
        w = self._decode_value(integer & self.value_max, -180, 180)
        return w, s, e, n

    def _decode_value(self, encoded, lo, hi):
        return encoded / self.value_max * (hi - lo) + lo

    # -- batch (numpy) -------------------------------------------------------

    def encode_batch(self, envelopes):
        """(N,4) float64 w,s,e,n -> (N, nbytes) uint8, identical bytes to the
        scalar path. Raises on out-of-range / NaN values (the scalar path
        asserts; silent uint64 wraparound would corrupt the shared index)."""
        env = np.asarray(envelopes, dtype=np.float64)
        lo = np.array([-180.0, -90.0, -180.0, -90.0])
        hi = np.array([180.0, 90.0, 180.0, 90.0])
        bad = ~((env >= lo) & (env <= hi))  # NaN compares False on both
        if bad.any():
            rows = np.nonzero(bad.any(axis=1))[0][:5]
            raise ValueError(
                f"Envelope values out of range at rows {rows.tolist()}: "
                f"{env[rows].tolist()}"
            )
        vmax = np.float64(self.value_max)
        w = np.floor((env[:, 0] + 180.0) / 360.0 * vmax).astype(np.uint64)
        s = np.floor((env[:, 1] + 90.0) / 180.0 * vmax).astype(np.uint64)
        e = np.ceil((env[:, 2] + 180.0) / 360.0 * vmax).astype(np.uint64)
        n = np.ceil((env[:, 3] + 90.0) / 180.0 * vmax).astype(np.uint64)
        bits = np.uint64(self.bits)
        hi = (w << bits) | s  # 2*bits wide
        lo = (e << bits) | n
        half_bytes = self.nbytes // 2
        out = np.empty((env.shape[0], self.nbytes), dtype=np.uint8)
        for i in range(half_bytes):
            shift = np.uint64(8 * (half_bytes - 1 - i))
            out[:, i] = ((hi >> shift) & np.uint64(0xFF)).astype(np.uint8)
            out[:, half_bytes + i] = ((lo >> shift) & np.uint64(0xFF)).astype(np.uint8)
        return out

    def decode_batch(self, data):
        """(N, nbytes) uint8 -> (N,4) float64 w,s,e,n."""
        data = np.asarray(data, dtype=np.uint8)
        half_bytes = self.nbytes // 2
        hi = np.zeros(data.shape[0], dtype=np.uint64)
        lo = np.zeros(data.shape[0], dtype=np.uint64)
        for i in range(half_bytes):
            hi = (hi << np.uint64(8)) | data[:, i].astype(np.uint64)
            lo = (lo << np.uint64(8)) | data[:, half_bytes + i].astype(np.uint64)
        bits = np.uint64(self.bits)
        mask = np.uint64(self.value_max)
        vmax = np.float64(self.value_max)
        w = ((hi >> bits) & mask).astype(np.float64) / vmax * 360.0 - 180.0
        s = (hi & mask).astype(np.float64) / vmax * 180.0 - 90.0
        e = ((lo >> bits) & mask).astype(np.float64) / vmax * 360.0 - 180.0
        n = (lo & mask).astype(np.float64) / vmax * 180.0 - 90.0
        return np.stack([w, s, e, n], axis=1)
