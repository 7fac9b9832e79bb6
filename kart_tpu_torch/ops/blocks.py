"""Columnar feature blocks and their upload to the device.

A FeatureBlock is one dataset version's feature identity as sorted arrays:

    keys : int64 (N,)   -- the int primary key, or for a hash-keyed dataset
                           the top 63 bits of the sha256 of the blob
                           filename (:func:`hash_keys_for_paths`)
    oids : uint32 (N,5) -- the feature blob's 20-byte content id, packed
    paths: the blob paths under ``feature/`` (a list of N str, or a lazy
           view of a hash-keyed sidecar's paths section), or None for an
           int-pk sidecar block, whose paths follow from its keys

Only the first ``count`` rows are real; rows beyond it (bucket padding, or
the tail of a compacted prefilter subset) carry ``PAD_KEY``. Blocks stay
numpy on the host (they are mmap views of the sidecar); :func:`to_device`
and :func:`block_tensors` make the count-sliced tensors the kernels take.
A sidecar's vertex column is decoded on first use
(:meth:`FeatureBlock.vertex_column`), and kept by content in a small
process-wide memo, so repeated queries over one file decode it once.
"""

import hashlib
import threading
from collections import OrderedDict

import numpy as np
import torch

from kart_tpu_torch.geom import decode_vertex_column

PAD_KEY = np.int64(2**63 - 1)

#: decoded vertex columns by (sha1 of the section bytes, row count); the
#: sidecar is content-addressed, so a key never goes stale
_VERTEX_MEMO = OrderedDict()
_vertex_memo_lock = threading.Lock()
_VERTEX_MEMO_ENTRIES = 8


def bucket_size(n, minimum=1024):
    """Next 1/8-step pseudo-power-of-two >= n (>= minimum): sizes of the form
    (8..15) * 2^k, capping padding waste at 12.5%."""
    if n <= minimum:
        return minimum
    k = max((n - 1).bit_length() - 4, 0)
    step = 1 << k
    return ((n + step - 1) // step) * step


def pack_oid_hex(oids_hex):
    """list of 40-hex oids -> (N, 5) uint32 array."""
    if not len(oids_hex):
        return np.zeros((0, 5), dtype=np.uint32)
    raw = np.frombuffer(bytes.fromhex("".join(oids_hex)), dtype=np.uint8)
    return raw.reshape(-1, 5, 4).view(np.uint32).reshape(-1, 5).copy()


def unpack_oid_hex(oid_rows):
    """(N, 5) uint32 -> list of 40-hex oids."""
    if not len(oid_rows):
        return []
    h = np.ascontiguousarray(oid_rows).astype("<u4").view(np.uint8).tobytes().hex()
    return [h[i : i + 40] for i in range(0, len(h), 40)]


def unpack_oid_bytes(oid_rows):
    """(N, 5) uint32 -> list of 20-byte shas."""
    if not len(oid_rows):
        return []
    b = np.ascontiguousarray(oid_rows).astype("<u4").view(np.uint8).tobytes()
    return [b[i : i + 20] for i in range(0, len(b), 20)]


def hash_keys_for_paths(paths):
    """Feature paths of a hash-keyed dataset -> int64 identity keys: the
    first 8 bytes (big-endian) of the sha256 of the blob filename, shifted
    right by one, so uniform over [0, 2^63). Two filenames can share a key:
    callers check :meth:`FeatureBlock.has_key_collisions`."""
    if not len(paths):
        return np.zeros(0, dtype=np.int64)
    sha = hashlib.sha256
    heads = b"".join([sha(p.rsplit("/", 1)[-1].encode()).digest()[:8] for p in paths])
    return (np.frombuffer(heads, dtype=">u8") >> np.uint64(1)).astype(np.int64)


class FeatureBlock:
    """One dataset version as key-sorted (key, oid) arrays, with the blob
    paths (``paths``: see the module docstring), the optional (count, 4)
    f32 wsen envelope column and its block aggregates ``(agg (nb,4) f32,
    flags (nb,) u8, block_rows)`` from the sidecar, and the sidecar's
    encoded vertex column ``geom_raw``."""

    __slots__ = ("keys", "oids", "count", "envelopes", "env_blocks", "paths", "geom_raw",
                 "_vertices")

    def __init__(self, keys, oids, count, envelopes=None, env_blocks=None, paths=None,
                 geom_raw=None):
        self.keys = keys
        self.oids = oids
        self.count = count
        self.envelopes = envelopes
        self.env_blocks = env_blocks
        self.paths = paths
        self.geom_raw = geom_raw
        self._vertices = None

    def vertex_column(self):
        """The :class:`~kart_tpu_torch.geom.VertexColumn` of the block's
        ``count`` rows, decoded on first call, or None when the sidecar has
        no geometry section. A corrupt section gives None once (the refine
        stage then keeps envelope verdicts)."""
        if self._vertices is None and self.geom_raw is not None:
            raw, self.geom_raw = self.geom_raw, None
            data = bytes(raw)
            memo_key = (hashlib.sha1(data).digest(), self.count)
            with _vertex_memo_lock:
                hit = _VERTEX_MEMO.get(memo_key)
                if hit is not None:
                    _VERTEX_MEMO.move_to_end(memo_key)
            if hit is not None:
                self._vertices = hit
                return hit
            try:
                self._vertices, _ = decode_vertex_column(data, self.count)
            except Exception:
                self._vertices = None
            if self._vertices is not None:
                with _vertex_memo_lock:
                    _VERTEX_MEMO[memo_key] = self._vertices
                    _VERTEX_MEMO.move_to_end(memo_key)
                    while len(_VERTEX_MEMO) > _VERTEX_MEMO_ENTRIES:
                        _VERTEX_MEMO.popitem(last=False)
        return self._vertices

    @classmethod
    def from_dataset(cls, dataset, pad=True):
        """One walk of ``dataset``'s feature tree -> its block, with paths;
        a hash-keyed dataset's keys are its filenames' hashes."""
        paths, pks, oid_u8 = dataset.feature_index()
        oid_rows = oid_u8.reshape(-1, 5, 4).view(np.uint32).reshape(-1, 5)
        keys = pks if pks is not None else hash_keys_for_paths(paths)
        return cls.from_arrays(keys, oid_rows, paths, pad=pad)

    @classmethod
    def from_arrays(cls, keys, oid_rows, paths=None, pad=True):
        n = len(keys)
        order = np.argsort(keys, kind="stable")
        keys = np.asarray(keys, dtype=np.int64)[order]
        oid_rows = np.asarray(oid_rows, dtype=np.uint32)[order]
        if paths is not None:
            paths = [paths[i] for i in order.tolist()]
        if pad:
            size = bucket_size(max(n, 1))
            if size > n:
                keys = np.concatenate([keys, np.full(size - n, PAD_KEY, dtype=np.int64)])
                oid_rows = np.concatenate(
                    [oid_rows, np.zeros((size - n, 5), dtype=np.uint32)]
                )
        return cls(keys, oid_rows, n, paths=paths)

    def has_key_collisions(self):
        """True when two real rows share a key (hash keys only can)."""
        real = self.keys[: self.count]
        return bool(np.any(real[1:] == real[:-1])) if self.count > 1 else False

    def path_for_index(self, i):
        return self.paths[i]

    def __len__(self):
        return self.count

    def __repr__(self):
        return f"FeatureBlock(count={self.count}, padded={len(self.keys)})"


def to_device(array, device, dtype=None):
    """numpy array (possibly a read-only, unaligned mmap view) -> a
    contiguous tensor on ``device``. For CUDA the bytes go through a pinned
    staging buffer, so the host-to-device copy is one DMA on the current
    stream; ``dtype`` reinterprets the bytes (same item size)."""
    arr = np.asarray(array)
    if dtype is not None:
        arr = arr.view(dtype)
    if device.type == "cpu":
        return torch.from_numpy(np.array(arr, copy=True, order="C"))
    if arr.size == 0:
        return torch.empty(arr.shape, dtype=_torch_dtype(arr.dtype), device=device)
    host = torch.empty(arr.shape, dtype=_torch_dtype(arr.dtype), pin_memory=True)
    host.numpy()[...] = arr
    return host.to(device, non_blocking=True)


def _torch_dtype(np_dtype):
    return torch.from_numpy(np.zeros(0, dtype=np_dtype)).dtype


def block_tensors(block, device):
    """-> (keys int64 (count,), oids int32 (count, 5)) on ``device``. The oid
    words are reinterpreted as int32: the kernels only test equality,
    which is bit-exact whatever the sign."""
    n = block.count
    keys = to_device(np.asarray(block.keys[:n], dtype=np.int64), device)
    oids = to_device(np.asarray(block.oids[:n]).reshape(n, 5), device, dtype=np.int32)
    return keys, oids
