"""Feature paths: primary key <-> blob path in a dataset's feature tree.

Datasets V3 spreads features over a fixed-fanout tree, under the
filename ``urlsafe_b64(msgpack(pk values))``:

    int scheme    single integer pk ``p``: the tree ``(p // 64) % 64**4``,
                  one urlsafe-base64 character per level (4 levels)
    msgpack/hash  any other pk: the first 4 characters of
                  ``b64hash(msgpack(pk values))``, one per level
    legacy        a dataset with no ``path-structure.json``: the first two
                  hex pairs of ``hexhash(msgpack(pk values))``

Counterpart of kart_tpu's ``models/paths.py``: ``PathEncoder``,
``IntPathEncoder`` (encode, decode, the vectorized batch encoders and
decoder, and the msgpack/base64 helpers the tree builder uses),
``MsgpackHashPathEncoder``, the canonical encoders and
``encoder_for_schema``.
"""

import math

import numpy as np

from kart_tpu_torch.core.serialise import (
    b64decode_str,
    b64encode_str,
    b64hash,
    hexhash,
    msg_pack,
    msg_unpack,
)

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
            return MsgpackHashPathEncoder(scheme=scheme, **kwargs)
        raise PathEncoderError(f"Unsupported feature path scheme: {scheme!r}")

    def __init__(self, *, scheme, levels, branches, encoding):
        self.scheme = scheme
        self.levels = levels
        self.branches = branches
        self.encoding = encoding
        if encoding == "hex":
            self.alphabet = HEX_ALPHABET
            self._hash = hexhash
        elif encoding == "base64":
            self.alphabet = B64_ALPHABET
            self._hash = b64hash
        else:
            raise PathEncoderError(f"Unsupported path encoding: {encoding!r}")
        base = len(self.alphabet)
        self.group_length = round(math.log(branches, base))
        if base ** self.group_length != branches:
            raise PathEncoderError(f"{encoding} encoding and {branches} branches are incompatible")
        self.max_trees = branches ** levels
        self._alpha_u8 = np.frombuffer(self.alphabet.encode("ascii"), dtype=np.uint8)

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

    _PATH_HOLE = 0xFF  # never a path byte; stripped after tobytes

    def _path_matrix(self, pks, plen=0):
        """The (N, plen + tree names + filename + 1) uint8 matrix of every
        path, cells past a row's content set to ``_PATH_HOLE``. -> (matrix,
        end column (N,)): the caller writes its separator there."""
        n = pks.shape[0]
        base = len(self.alphabet)
        tree_idx = (pks // self.branches) % self.max_trees
        fn_bytes, fn_len = msgpack_single_int_batch(pks)
        b64_mat, b64_len = b64_batch(fn_bytes, fn_len)
        b64w = b64_mat.shape[1]
        width = plen + self.levels * (self.group_length + 1) + b64w + 1
        out = np.full((n, width), self._PATH_HOLE, dtype=np.uint8)
        col = plen
        for level in range(self.levels):
            digit = (tree_idx // self.branches ** (self.levels - 1 - level)) % self.branches
            for g in range(self.group_length):
                out[:, col] = self._alpha_u8[(digit // base ** (self.group_length - 1 - g)) % base]
                col += 1
            out[:, col] = ord("/")
            col += 1
        region = out[:, col : col + b64w]
        region[:] = b64_mat
        region[np.arange(b64w)[None, :] >= b64_len[:, None]] = self._PATH_HOLE
        return out, col + b64_len

    def encode_paths_batch(self, pks):
        """int64 array (N,) -> list of N path strings, vectorized."""
        pks = np.asarray(pks, dtype=np.int64)
        n = pks.shape[0]
        if n == 0:
            return []
        out, end = self._path_matrix(pks)
        out[np.arange(n), end] = ord("\n")
        return out.tobytes().replace(b"\xff", b"").decode("ascii").split("\n")[:-1]

    def decode_paths_batch(self, filenames):
        """Filenames (or full paths) -> int64 array of pks."""
        if not isinstance(filenames, (list, tuple)):
            filenames = list(filenames)
        return decode_single_int_filenames([f.rsplit("/", 1)[-1] for f in filenames])


class MsgpackHashPathEncoder(PathEncoder):
    """Hash-distributed encoder for every pk but a single integer: the tree
    names are the leading characters of the hash of the packed pk values,
    so features spread uniformly over the fanout."""

    def encode_pks_to_path(self, pk_values):
        packed = msg_pack(pk_values)
        digest = self._hash(packed)
        parts = [digest[i * self.group_length : (i + 1) * self.group_length]
                 for i in range(self.levels)]
        parts.append(b64encode_str(packed))
        return "/".join(parts)

    def decode_path_to_pks(self, path):
        return self.decode_filename(path.rsplit("/", 1)[-1])

    def expected_blobs_for_tree_samples(self, num_samples, branch_factor):
        """Inverse birthday-problem correction: distinct children observed
        -> the expected feature count of a uniformly hashed tree."""
        return math.log(1 - num_samples / branch_factor) / math.log(1 - 1 / branch_factor)


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


_B64_INV = np.full(256, -1, dtype=np.int16)
_B64_INV[_B64_CHARS] = np.arange(64, dtype=np.int16)
_B64_INV[ord("=")] = 0


def decode_filenames(names):
    """Filenames -> their pk value tuples, as :meth:`PathEncoder
    .decode_filename` gives them one at a time: the names of one width are
    base64-decoded as one matrix, and a single text pk (msgpack ``[fixstr]``)
    is read straight from its bytes; any other value goes through the
    msgpack decoder, and a name the matrix cannot hold through
    :meth:`PathEncoder.decode_filename`."""
    out = [None] * len(names)
    by_width = {}
    for i, name in enumerate(names):
        by_width.setdefault(len(name), []).append(i)
    for width, idx in by_width.items():
        try:
            mat = np.frombuffer("".join([names[i] for i in idx]).encode("ascii"),
                                dtype=np.uint8).reshape(len(idx), width)
        except UnicodeEncodeError:
            mat = None
        vals = _B64_INV[mat] if mat is not None and width and width % 4 == 0 else None
        if vals is None or (vals < 0).any() or (mat[:, : width - 2] == ord("=")).any() or (
                (mat[:, -2] == ord("=")) & (mat[:, -1] != ord("="))).any():
            for i in idx:
                out[i] = PathEncoder.decode_filename(names[i])
            continue
        q = vals.reshape(len(idx), width // 4, 4).astype(np.uint32)
        triple = (q[..., 0] << 18) | (q[..., 1] << 12) | (q[..., 2] << 6) | q[..., 3]
        raw = np.stack([(triple >> 16) & 0xFF, (triple >> 8) & 0xFF, triple & 0xFF],
                       axis=-1).astype(np.uint8).tobytes()
        row_w = 3 * width // 4
        lengths = (row_w - (mat[:, -1] == ord("=")) - (mat[:, -2] == ord("="))).tolist()
        for j, (i, n) in enumerate(zip(idx, lengths)):
            row = raw[j * row_w : j * row_w + n]
            if n >= 2 and row[0] == 0x91 and 0xA0 <= row[1] <= 0xBF and n == 2 + (row[1] & 0x1F):
                out[i] = (row[2:].decode("utf8"),)
            else:
                out[i] = tuple(msg_unpack(row))
    return out


def decode_single_int_filenames(names):
    """b64(msgpack([int])) filenames -> int64 array, vectorized: one join,
    one frombuffer, table-driven base64 and msgpack decode."""
    n = len(names)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    widths = np.fromiter((len(s) for s in names), count=n, dtype=np.int64)
    w = int(widths.max())
    if (widths == w).all():  # one width: the names are the rows of one matrix
        mat = np.frombuffer("".join(names).encode("ascii"), dtype=np.uint8).reshape(n, w)
    else:
        flat = np.frombuffer("\n".join(names).encode("ascii"), dtype=np.uint8)
        mat = np.full((n, w), ord("="), dtype=np.uint8)
        starts = np.zeros(n, dtype=np.int64)
        np.cumsum(widths[:-1] + 1, out=starts[1:])
        for col in range(w):
            take = col < widths
            mat[take, col] = flat[starts[take] + col]
    vals = _B64_INV[mat]
    vals[vals < 0] = 0
    groups = w // 4
    q = vals[:, : groups * 4].reshape(n, groups, 4).astype(np.uint32)
    triple = (q[..., 0] << 18) | (q[..., 1] << 12) | (q[..., 2] << 6) | q[..., 3]
    raw = np.stack([(triple >> 16) & 0xFF, (triple >> 8) & 0xFF, triple & 0xFF],
                   axis=-1).reshape(n, groups * 3)
    if not np.all(raw[:, 0] == 0x91):
        raise PathEncoderError("not a single-pk filename batch")
    marker = raw[:, 1]
    out = np.zeros(n, dtype=np.int64)

    def be_read(rows, nbytes):
        acc = np.zeros(int(rows.sum()), dtype=np.uint64)
        for b in range(nbytes if len(acc) else 0):
            acc = (acc << np.uint64(8)) | raw[rows, 2 + b].astype(np.uint64)
        return acc

    m = marker <= 0x7F
    out[m] = marker[m]
    m = marker >= 0xE0  # negative fixint
    out[m] = marker[m].astype(np.int64) - 0x100
    m = marker == 0xCC
    if m.any():
        out[m] = raw[m, 2]
    m = marker == 0xD0
    if m.any():
        out[m] = raw[m, 2].astype(np.int8)
    out[marker == 0xCD] = be_read(marker == 0xCD, 2).astype(np.int64)
    out[marker == 0xCE] = be_read(marker == 0xCE, 4).astype(np.int64)
    out[marker == 0xCF] = be_read(marker == 0xCF, 8).astype(np.int64)
    out[marker == 0xD1] = be_read(marker == 0xD1, 2).astype(np.uint16).astype(np.int16)
    out[marker == 0xD2] = be_read(marker == 0xD2, 4).astype(np.uint32).astype(np.int32)
    m = marker == 0xD3
    if m.any():
        out[m] = be_read(m, 8).view(np.int64)
    return out


#: the canonical encoders: a dataset with no ``path-structure.json`` (the
#: legacy layout), a single integer pk, and every other pk
PathEncoder.LEGACY_ENCODER = PathEncoder.get(scheme="msgpack/hash", branches=256, levels=2,
                                             encoding="hex")
PathEncoder.INT_PK_ENCODER = PathEncoder.get(scheme="int", branches=64, levels=4,
                                             encoding="base64")
PathEncoder.GENERAL_ENCODER = PathEncoder.get(scheme="msgpack/hash", branches=64, levels=4,
                                              encoding="base64")


def encoder_for_schema(schema):
    """The encoder a new dataset with ``schema`` gets: the int scheme for a
    single integer pk, the hashed one for every other pk."""
    pk_cols = schema.pk_columns
    if len(pk_cols) == 1 and pk_cols[0].data_type == "integer":
        return PathEncoder.INT_PK_ENCODER
    return PathEncoder.GENERAL_ENCODER
