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
and :func:`block_tensors` make the count-sliced tensors the kernels take;
:class:`StreamStager` is the card's upload of a classify chunk by chunk,
and :func:`streams` decides when a classify cuts its sides into chunks.
A sidecar's vertex column is decoded on first use
(:meth:`FeatureBlock.vertex_column`), and kept by content in a small
process-wide memo, so repeated queries over one file decode it once.
"""

import contextlib
import hashlib
import logging
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

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


#: arrays of at least this many bytes are staged by several threads
STAGE_SPLIT_BYTES = 1 << 24
STAGE_THREADS = min(8, os.cpu_count() or 1)
_stage_pool = None
_stage_pool_lock = threading.Lock()


def _pool():
    """The staging threads, started on the first large copy and kept for
    the process."""
    global _stage_pool
    with _stage_pool_lock:
        if _stage_pool is None:
            _stage_pool = ThreadPoolExecutor(STAGE_THREADS, thread_name_prefix="kart-stage")
        return _stage_pool


def stage_rows(dst, src):
    """Copy ``src`` into the numpy array ``dst`` of its shape (a pinned
    buffer's view, or the host array a download lands in). Contiguous
    arrays of one dtype are copied as bytes, which keeps an unaligned mmap
    view (a sidecar's columns) at memcpy speed, and large ones in ranges on
    :data:`STAGE_THREADS` threads (numpy's copy releases the GIL)."""
    if not (src.dtype == dst.dtype and src.shape == dst.shape
            and src.flags.c_contiguous and dst.flags.c_contiguous):
        dst[...] = src
        return
    d, s = dst.reshape(-1).view(np.uint8), src.reshape(-1).view(np.uint8)
    parts = STAGE_THREADS if d.nbytes >= STAGE_SPLIT_BYTES else 1
    if parts == 1:
        d[...] = s
        return
    cuts = np.linspace(0, len(d), parts + 1).astype(np.int64)
    list(_pool().map(lambda i: np.copyto(d[cuts[i]:cuts[i + 1]], s[cuts[i]:cuts[i + 1]]),
                     range(parts)))


def to_device(array, device, dtype=None):
    """numpy array (possibly a read-only, unaligned mmap view) -> a
    contiguous tensor on ``device``. For CUDA the bytes go through a pinned
    staging buffer (:func:`stage_rows`), so the host-to-device copy is one
    DMA on the current stream; ``dtype`` reinterprets the bytes (same item
    size)."""
    arr = np.asarray(array)
    if dtype is not None:
        arr = arr.view(dtype)
    if device.type == "cpu":
        return torch.from_numpy(np.array(arr, copy=True, order="C"))
    if arr.size == 0:
        return torch.empty(arr.shape, dtype=_torch_dtype(arr.dtype), device=device)
    host = torch.empty(arr.shape, dtype=_torch_dtype(arr.dtype), pin_memory=True)
    stage_rows(host.numpy(), arr)
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


# --- the classify's upload: chunks through two pinned staging pieces -----------------------

#: bytes a row of a side moves to the card: an int64 key and five oid words
ROW_BYTES = 28
#: the chunking's defaults, measured from sidecar mmaps on an H100
#: (``chip_smoke.py --stream-only``, phase S4; PERF.md §6): with the staging
#: in pieces, one chunk and chunks of 8M rows tie within run-to-run noise
#: from 10M to 100M rows a side, so rows alone do not cut chunks below a
#: billion a side, past anything the memory rule of :func:`streams` lets
#: one card hold in one chunk; ``KART_TORCH_STREAM_MIN_ROWS`` and
#: ``KART_TORCH_STREAM_CHUNK_ROWS`` override them at call time
DEFAULT_STREAM_MIN_ROWS = 1_000_000_000
DEFAULT_STREAM_CHUNK_ROWS = 8_000_000

_log = logging.getLogger("kart_tpu_torch.ops")


def _env_int(name, default):
    """A tolerant knob, read when called: a malformed value is ignored
    with a warning."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        _log.warning("ignoring malformed %s=%r", name, raw)
        return default


def stream_min_rows():
    return _env_int("KART_TORCH_STREAM_MIN_ROWS", DEFAULT_STREAM_MIN_ROWS)


def stream_chunk_rows():
    return max(1, _env_int("KART_TORCH_STREAM_CHUNK_ROWS", DEFAULT_STREAM_CHUNK_ROWS))


def streams(device, side_rows):
    """Whether blocks of ``side_rows`` rows are cut into chunks of
    :func:`stream_chunk_rows` on ``device``: only on the card, when the
    largest side has at least :func:`stream_min_rows` rows or all sides'
    bytes are more than half of the card's free memory. A routing choice,
    never a fallback."""
    if device.type != "cuda" or not any(side_rows):
        return False
    if max(side_rows) >= stream_min_rows():
        return True
    free, _ = torch.cuda.mem_get_info(device)
    return sum(side_rows) * ROW_BYTES > free // 2


#: bytes of one pinned staging piece: a chunk's columns go up through two
STAGE_PIECE_BYTES = 1 << 26


class StreamStager:
    """The card's upload of a classify's sides chunk by chunk: device
    buffers of ``cap`` rows a side (keys int64, oids int32 (cap, 5)) in
    ``slots`` slots (two, or one when a call has a single chunk), two
    pinned staging pieces of at most :data:`STAGE_PIECE_BYTES` shared by
    every column, all allocated once, and a copy stream beside the caller's
    compute stream. :meth:`upload` moves a chunk's rows from the host
    arrays (mmap views included) into a slot piece by piece: one piece is
    staged while the other is copied up, a piece is reused only once its
    last copy ended, and a slot's device buffers only once the launch that
    read them (:meth:`launched`) ended. So the pinned memory a call
    allocates does not grow with its rows. ``timings`` (a dict), when
    given, collects the host seconds of the pinned allocation and of the
    staging, and the copies' device milliseconds."""

    def __init__(self, device, caps, timings=None, slots=2):
        self.timings = timings
        self.marks = []
        self.slots = slots
        self.compute = torch.cuda.current_stream(device)
        self.copy = torch.cuda.Stream(device)
        piece = min(STAGE_PIECE_BYTES, max(max(caps) * 20, 1))
        with self.clock("pinned_alloc_s"):
            self.pieces = [torch.empty(piece, dtype=torch.uint8, pin_memory=True)
                           for _ in range(2)]
        self.piece_free = [torch.cuda.Event(), torch.cuda.Event()]
        self.turn = 0
        self.dev = [[(torch.empty(c, dtype=torch.int64, device=device),
                      torch.empty((c, 5), dtype=torch.int32, device=device))
                     for c in caps] for _ in range(slots)]
        self.uploaded = [torch.cuda.Event() for _ in range(slots)]
        self.released = [torch.cuda.Event() for _ in range(slots)]

    def add(self, name, value):
        """Add ``value`` to ``timings[name]`` when timings are collected."""
        if self.timings is not None:
            self.timings[name] = self.timings.get(name, 0.0) + value

    @contextlib.contextmanager
    def clock(self, name):
        """Add the block's host seconds to ``timings[name]``."""
        t = time.perf_counter()
        yield
        self.add(name, time.perf_counter() - t)

    def pinned(self, n, dtype):
        """A pinned host tensor of ``n`` rows, its allocation timed."""
        with self.clock("pinned_alloc_s"):
            return torch.empty(n, dtype=dtype, pin_memory=True)

    def upload(self, slot, sides):
        """``sides``: (keys, oids, lo, hi) a side, host arrays. -> the
        slot's device (keys, oids) views of ``hi - lo`` rows a side, ready
        on the compute stream."""
        self.copy.wait_event(self.released[slot])
        out = []
        for (keys, oids, lo, hi), (dk, do) in zip(sides, self.dev[slot]):
            n = hi - lo
            self._pieces(keys[lo:hi], dk[:n].view(torch.uint8))
            self._pieces(oids[lo:hi], do[:n].reshape(-1).view(torch.uint8))
            out += [dk[:n], do[:n]]
        self.uploaded[slot].record(self.copy)
        self.compute.wait_event(self.uploaded[slot])
        return out

    def _pieces(self, src, dst):
        """Copy the host array ``src`` into the device bytes ``dst`` (of
        its size) through the two staging pieces in turn."""
        src = np.ascontiguousarray(src).reshape(-1).view(np.uint8)
        step = len(self.pieces[0])
        for p in range(0, len(src), step):
            q = min(p + step, len(src))
            turn, self.turn = self.turn, 1 - self.turn
            self.piece_free[turn].synchronize()  # this piece's last copy has left it
            with self.clock("staging_s"):
                stage_rows(self.pieces[turn].numpy()[: q - p], src[p:q])
            with torch.cuda.stream(self.copy), self.timed("h2d_ms", self.copy):
                dst[p:q].copy_(self.pieces[turn][: q - p], non_blocking=True)
            self.piece_free[turn].record(self.copy)

    def launched(self, slot):
        """The compute stream's work on ``slot``'s device buffers is
        enqueued: they are free once it ends."""
        self.released[slot].record(self.compute)

    def download(self, pairs, after):
        """Copy each (device source, pinned host destination) pair down on
        the copy stream once the event ``after`` (the launch that wrote the
        sources) has passed. -> an event that passes when they landed."""
        landed = torch.cuda.Event()
        with torch.cuda.stream(self.copy):
            self.copy.wait_event(after)
            with self.timed("d2h_ms", self.copy):
                for src, dst in pairs:
                    dst.copy_(src, non_blocking=True)
                    src.record_stream(self.copy)
            landed.record(self.copy)
        return landed

    @contextlib.contextmanager
    def timed(self, name, stream):
        """Time the work the block enqueues on ``stream`` under ``name``
        (device milliseconds, added up by :meth:`finish`) when timings are
        collected."""
        if self.timings is None:
            yield
            return
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        yield
        end.record(stream)
        self.marks.append((name, start, end))

    def finish(self):
        """Wait for both streams and add up the timed spans."""
        self.copy.synchronize()
        self.compute.synchronize()
        for name, start, end in self.marks:
            self.add(name, start.elapsed_time(end))
