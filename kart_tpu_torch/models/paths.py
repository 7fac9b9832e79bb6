"""Feature paths: primary key <-> blob path in a dataset's feature tree.

Datasets V3 spreads features over a fixed-fanout tree; the int scheme
(4 levels x 64 branches) puts pk ``p`` in the tree ``(p // 64) % 64**4``,
one urlsafe-base64 character per level, under the filename
``urlsafe_b64(msgpack([p]))``.

Counterpart of kart_tpu's ``models/paths.py``: ``PathEncoder``,
``IntPathEncoder`` (encode, decode and the vectorized msgpack/base64
helpers the tree builder uses) and ``encoder_for_schema``. Hash-keyed
datasets (the ``msgpack/hash`` scheme) raise :class:`NotYetImplemented`.
"""

import math

import numpy as np

from kart_tpu_torch.core.repo import NotYetImplemented
from kart_tpu_torch.core.serialise import b64decode_str, b64encode_str, msg_pack, msg_unpack

HEX_ALPHABET = "0123456789abcdef"
B64_ALPHABET = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789-_"


class PathEncoderError(ValueError):
    pass


class PathEncoder:
    """Base path encoder. Construct via :meth:`get`."""

    @staticmethod
    def get(*, scheme, **kwargs):
        if scheme == "int":
            return IntPathEncoder(scheme=scheme, **kwargs)
        if scheme == "msgpack/hash":
            raise NotYetImplemented(
                "hash-keyed datasets (path scheme 'msgpack/hash') are not ported yet"
            )
        raise PathEncoderError(f"Unsupported feature path scheme: {scheme!r}")

    def __init__(self, *, scheme, levels, branches, encoding):
        self.scheme = scheme
        self.levels = levels
        self.branches = branches
        self.encoding = encoding
        if encoding == "hex":
            self.alphabet = HEX_ALPHABET
        elif encoding == "base64":
            self.alphabet = B64_ALPHABET
        else:
            raise PathEncoderError(f"Unsupported path encoding: {encoding!r}")
        base = len(self.alphabet)
        self.group_length = round(math.log(branches, base))
        if base ** self.group_length != branches:
            raise PathEncoderError(f"{encoding} encoding and {branches} branches are incompatible")
        self.max_trees = branches ** levels

    def to_dict(self):
        return {"scheme": self.scheme, "branches": self.branches, "levels": self.levels,
                "encoding": self.encoding}

    def __eq__(self, other):
        return isinstance(other, PathEncoder) and self.to_dict() == other.to_dict()

    def __hash__(self):
        return hash(tuple(sorted(self.to_dict().items())))

    @staticmethod
    def encode_filename(pk_values):
        return b64encode_str(msg_pack(pk_values))

    @staticmethod
    def decode_filename(filename):
        """filename -> tuple of pk values."""
        return tuple(msg_unpack(b64decode_str(filename)))

    def _encode_tree_digit(self, value):
        chars = []
        for _ in range(self.group_length):
            value, rem = divmod(value, len(self.alphabet))
            chars.append(self.alphabet[rem])
        return "".join(reversed(chars))


class IntPathEncoder(PathEncoder):
    """Modulus-based encoder for single integer pks."""

    def encode_pks_to_path(self, pk_values):
        if len(pk_values) != 1:
            raise PathEncoderError(f"int path scheme needs one pk, got {pk_values!r}")
        tree_idx = (int(pk_values[0]) // self.branches) % self.max_trees
        parts = [
            self._encode_tree_digit((tree_idx // self.branches ** (self.levels - 1 - level))
                                    % self.branches)
            for level in range(self.levels)
        ]
        parts.append(self.encode_filename(pk_values))
        return "/".join(parts)

    def decode_path_to_pks(self, path):
        return self.decode_filename(path.rsplit("/", 1)[-1])


_MAX_MSGPACK_INT_LEN = 11  # 0x91 + 0xcf + 8 bytes


def msgpack_single_int_batch(pks):
    """int64 array -> (uint8 matrix (N, 11), lengths (N,)) of msgpack([pk])."""
    n = pks.shape[0]
    out = np.zeros((n, _MAX_MSGPACK_INT_LEN), dtype=np.uint8)
    length = np.zeros(n, dtype=np.int64)
    out[:, 0] = 0x91  # fixarray(1)
    u = pks.astype(np.uint64)

    def be_bytes(vals, nbytes):
        shifts = np.arange(nbytes - 1, -1, -1, dtype=np.uint64) * np.uint64(8)
        return ((vals[:, None] >> shifts[None, :]) & np.uint64(0xFF)).astype(np.uint8)

    m = (pks >= 0) & (pks <= 0x7F)
    out[m, 1] = pks[m].astype(np.uint8)
    length[m] = 2
    m = (pks < 0) & (pks >= -32)
    out[m, 1] = (0x100 + pks[m]).astype(np.uint8)
    length[m] = 2
    m = (pks > 0x7F) & (pks <= 0xFF)
    out[m, 1] = 0xCC
    out[m, 2] = pks[m].astype(np.uint8)
    length[m] = 3
    m = (pks < -32) & (pks >= -0x80)
    out[m, 1] = 0xD0
    out[m, 2] = (0x100 + pks[m]).astype(np.uint8)
    length[m] = 3
    for lo_ok, marker, nbytes in (
        ((pks > 0xFF) & (pks <= 0xFFFF), 0xCD, 2),
        ((pks > 0xFFFF) & (pks <= 0xFFFFFFFF), 0xCE, 4),
        (pks > 0xFFFFFFFF, 0xCF, 8),
        ((pks < -0x80) & (pks >= -0x8000), 0xD1, 2),
        ((pks < -0x8000) & (pks >= -0x80000000), 0xD2, 4),
        (pks < -0x80000000, 0xD3, 8),
    ):
        out[lo_ok, 1] = marker
        out[lo_ok, 2 : 2 + nbytes] = be_bytes(u[lo_ok], nbytes)
        length[lo_ok] = 2 + nbytes
    return out, length


_B64_CHARS = np.frombuffer(B64_ALPHABET.encode("ascii"), dtype=np.uint8)


def b64_batch(data, lengths):
    """Row-wise urlsafe base64 (with '=' padding) of a padded uint8 matrix
    (row i valid up to ``lengths[i]``) -> (chars (N, ceil(W/3)*4), lengths);
    cells past a row's length hold '\\n'."""
    n, w = data.shape
    groups = (w + 2) // 3
    padded = np.zeros((n, groups * 3), dtype=np.uint8)
    padded[:, :w] = data
    g = padded.reshape(n, groups, 3).astype(np.uint32)
    triple = (g[..., 0] << 16) | (g[..., 1] << 8) | g[..., 2]
    chars = np.empty((n, groups * 4), dtype=np.uint8)
    chars[:, 0::4] = _B64_CHARS[(triple >> 18) & 0x3F]
    chars[:, 1::4] = _B64_CHARS[(triple >> 12) & 0x3F]
    chars[:, 2::4] = _B64_CHARS[(triple >> 6) & 0x3F]
    chars[:, 3::4] = _B64_CHARS[triple & 0x3F]
    out_len = ((lengths + 2) // 3) * 4
    col = np.arange(groups * 4)[None, :]
    n_equals = (3 - lengths % 3) % 3
    chars[(col >= (out_len - n_equals)[:, None]) & (col < out_len[:, None])] = ord("=")
    chars[col >= out_len[:, None]] = ord("\n")
    return chars, out_len


PathEncoder.INT_PK_ENCODER = PathEncoder.get(scheme="int", branches=64, levels=4,
                                             encoding="base64")


def encoder_for_schema(schema):
    """The encoder a new dataset with ``schema`` gets: the int scheme for a
    single integer pk (the only scheme ported)."""
    pk_cols = schema.pk_columns
    if len(pk_cols) == 1 and pk_cols[0].data_type == "integer":
        return PathEncoder.INT_PK_ENCODER
    raise NotYetImplemented("hash-keyed datasets are not ported yet")
