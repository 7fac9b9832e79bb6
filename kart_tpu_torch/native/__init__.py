"""ctypes binding of the port's host IO core (``hostsrc/kart_io.cpp``):
batch SHA-1 + deflate + pack-record framing, the batch pack inflate, the
two-tree raw diff, the fused GPKG read and feature-blob encode, and the
leaf-tree payload build.

The library is built with ``g++`` at first use
(:mod:`~kart_tpu_torch.ops.host_build`, ``-lz``; ``libsqlite3`` and
``libcrypto`` are dlopen'd by the source itself). A missing compiler or a
library that does not build or load raises :class:`HostBuildError`, and a
native call that fails raises :class:`NativeIOError`: no route is chosen
by whether the library loaded. Where a function returns ``None`` it is
the data that asks for another route (a malformed tree or pack record,
pks outside the leaf kernel's contract), as in kart_tpu.

Counterpart of kart_tpu's ``native/__init__.py`` IO half:
``pack_records_batch``, ``pack_records_base``, ``pack_objects_batch``,
``inflate_pack_batch``, ``tree_diff_raw``, ``leaf_payloads``,
``GpkgReaderFallback``, ``GpkgNativeReader`` and ``open_gpkg_reader``,
with the same outputs on the same inputs.
"""

import ctypes
import os
import threading

import numpy as np

from kart_tpu_torch.ops import host_build
from kart_tpu_torch.ops.host_build import HostBuildError

SOURCE = "kart_io.cpp"
LIB_NAME = "libhost_io.so"
LINK_FLAGS = ("-lz",)
ABI_VERSION = 7

_lib = None
_lock = threading.Lock()


class NativeIOError(OSError):
    """A native IO call failed (an output buffer too small, a zlib or
    sqlite error)."""


def library_path():
    """Build the IO core unless the cache holds it. -> its path."""
    return host_build.build_library(host_build.HOSTSRC_DIR, SOURCE, LIB_NAME, LINK_FLAGS)


def load_io():
    """-> the configured ctypes.CDLL of the IO core (built on first use).
    Raises :class:`HostBuildError` when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise HostBuildError(f"cannot load {path}: {e}") from e
        lib.io_abi_version.restype = ctypes.c_int
        if lib.io_abi_version() != ABI_VERSION:
            raise HostBuildError(f"{path} has ABI {lib.io_abi_version()}, expected {ABI_VERSION}")
        c_void_p, c_int64, c_int, c_char_p = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                                              ctypes.c_char_p)
        lib.io_pack_ptrs.restype = c_int64
        lib.io_pack_ptrs.argtypes = [ctypes.POINTER(c_char_p), c_void_p, c_int64, c_char_p,
                                     c_int, c_int64, c_void_p, c_void_p, c_int64, c_void_p]
        lib.io_pack_records.restype = c_int64
        lib.io_pack_records.argtypes = [c_char_p, c_void_p, c_int64, c_char_p, c_int, c_int,
                                        c_int64, c_void_p, c_void_p, c_void_p, c_int64, c_void_p]
        lib.io_tree_diff.restype = c_int64
        lib.io_tree_diff.argtypes = [c_char_p, c_int64, c_char_p, c_int64, c_void_p, c_int64]
        lib.io_inflate_batch.restype = c_int64
        lib.io_inflate_batch.argtypes = [c_void_p, c_int64, c_void_p, c_int64, c_void_p,
                                         c_int64, c_void_p, c_void_p]
        lib.io_gpkg_open.restype = c_void_p
        lib.io_gpkg_open.argtypes = [c_char_p, c_char_p, c_int, c_void_p, c_void_p, c_int,
                                     c_void_p, c_int64, c_int]
        lib.io_gpkg_next.restype = c_int64
        lib.io_gpkg_next.argtypes = [c_void_p, c_int64, c_void_p, c_void_p, c_int64, c_void_p]
        lib.io_gpkg_close.restype = None
        lib.io_gpkg_close.argtypes = [c_void_p]
        lib.io_leaf_payloads.restype = c_int64
        lib.io_leaf_payloads.argtypes = [c_void_p, c_void_p, c_int64, c_int64, c_int64,
                                         c_void_p, c_int64, c_void_p, c_void_p, c_void_p]
        _lib = lib
    return _lib


def _store_max():
    """Payloads of at most this many bytes are written as stored zlib
    streams (``KART_PACK_STORE_MAX``, default 256; 0 always deflates):
    feature blobs of ~100-150 bytes barely shrink under deflate, and a
    stored stream is a copy."""
    try:
        return int(os.environ.get("KART_PACK_STORE_MAX", 256))
    except ValueError:
        return 256


def tree_diff_raw(a_content, b_content):
    """Two raw git tree payloads -> the differing entries ``(name, oid_a
    hex | None, oid_b hex | None, a_is_tree, b_is_tree)`` in tree order,
    or None when a payload is malformed (the caller parses both trees)."""
    lib = load_io()
    # each output record is (43 + name) bytes against (27 + name) of input
    cap = 2 * (len(a_content) + len(b_content)) + 64
    out = np.empty(cap, dtype=np.uint8)
    total = lib.io_tree_diff(a_content, len(a_content), b_content, len(b_content),
                             out.ctypes.data, cap)
    if total == -2:
        return None
    if total < 0:
        raise NativeIOError(f"io_tree_diff failed ({total})")
    result = []
    buf = out[:total].tobytes()
    i = 0
    while i < total:
        flags = buf[i]
        name_len = buf[i + 1] | (buf[i + 2] << 8)
        j = i + 3
        name = buf[j : j + name_len].decode("utf8")
        j += name_len
        oid_a = buf[j : j + 20].hex() if flags & 1 else None
        oid_b = buf[j + 20 : j + 40].hex() if flags & 2 else None
        result.append((name, oid_a, oid_b, bool(flags & 4), bool(flags & 8)))
        i = j + 40
    return result


def _pack_records(lib, obj_type, type_code, base, offsets, n, level):
    payload_total = int(offsets[n])
    oids = np.empty((n, 20), dtype=np.uint8)
    crcs = np.empty(n, dtype=np.uint32)
    # zlib's worst case, stored streams' overhead and the 10-byte heads
    cap = payload_total + payload_total // 512 + 80 * n + 1024
    out = np.empty(cap, dtype=np.uint8)
    out_offsets = np.empty(n + 1, dtype=np.int64)
    total = lib.io_pack_records(base, offsets.ctypes.data, n, obj_type.encode(), int(type_code),
                                int(level), _store_max(), oids.ctypes.data, crcs.ctypes.data,
                                out.ctypes.data, cap, out_offsets.ctypes.data)
    if total < 0:
        raise NativeIOError(f"io_pack_records failed ({total})")
    return oids, crcs, out[:total], out_offsets


def pack_records_batch(obj_type, type_code, contents, level=1):
    """Hash, deflate and frame a batch of one object type: ``contents``
    list[bytes] -> (oids (n, 20) uint8, crcs (n,) uint32, records uint8,
    offsets (n+1,) int64), record i ``records[offsets[i]:offsets[i+1]]``
    with its varint head, ready to append to a pack."""
    n = len(contents)
    if not n:
        raise ValueError("pack_records_batch of no objects")
    joined = b"".join(contents)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, contents), dtype=np.int64, count=n), out=offsets[1:])
    return _pack_records(load_io(), obj_type, type_code, joined, offsets, n, level)


def pack_records_base(obj_type, type_code, base_u8, offsets, level=1):
    """:func:`pack_records_batch` over payloads already in one buffer:
    payload i is ``base_u8[offsets[i]:offsets[i+1]]`` (the GPKG reader's
    output, a leaf-payload batch)."""
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    if n <= 0:
        raise ValueError("pack_records_base of no objects")
    base_u8 = np.ascontiguousarray(base_u8, dtype=np.uint8)
    return _pack_records(load_io(), obj_type, type_code,
                         base_u8.ctypes.data_as(ctypes.c_char_p), offsets, n, level)


def pack_objects_batch(obj_type, contents, level=1):
    """Hash and deflate without framing: ``contents`` list[bytes] ->
    (oids (n, 20) uint8, [zlib stream bytes]). The writer frames through
    :func:`pack_records_batch`; this is the unframed twin."""
    lib = load_io()
    n = len(contents)
    if not n:
        raise ValueError("pack_objects_batch of no objects")
    ptrs = (ctypes.c_char_p * n)(*contents)
    lens = np.fromiter(map(len, contents), dtype=np.int64, count=n)
    payload_total = int(lens.sum())
    oids = np.empty((n, 20), dtype=np.uint8)
    cap = payload_total + payload_total // 512 + 64 * n + 1024
    out = np.empty(cap, dtype=np.uint8)
    out_offsets = np.empty(n + 1, dtype=np.int64)
    total = lib.io_pack_ptrs(ptrs, lens.ctypes.data, n, obj_type.encode(), int(level),
                             _store_max(), oids.ctypes.data, out.ctypes.data, cap,
                             out_offsets.ctypes.data)
    if total < 0:
        raise NativeIOError(f"io_pack_ptrs failed ({total})")
    return oids, [out[out_offsets[i] : out_offsets[i + 1]].tobytes() for i in range(n)]


def leaf_payloads(pks, oids_u8, branches, pk_limit):
    """Leaf-tree payloads of strictly ascending non-negative int64 ``pks``
    below ``pk_limit`` (``branches ** (levels + 1)``) and their (n, 20)
    blob oids -> (buf uint8, offsets int64 (n_leaves+1,), leaf_ids int64),
    leaf k's tree payload ``buf[offsets[k]:offsets[k+1]]``; None when the
    pks are outside that contract (the caller builds the plan)."""
    lib = load_io()
    pks = np.ascontiguousarray(pks, dtype=np.int64)
    n = len(pks)
    if n == 0:
        return None
    oids_u8 = np.ascontiguousarray(oids_u8, dtype=np.uint8)
    cap = n * 44 + 64  # an entry: 7 + a name of <= 16 + NUL + 20
    out = np.empty(cap, dtype=np.uint8)
    offsets = np.empty(n + 1, dtype=np.int64)
    leaf_ids = np.empty(n, dtype=np.int64)
    n_leaves = ctypes.c_int64(0)
    total = lib.io_leaf_payloads(pks.ctypes.data, oids_u8.ctypes.data, n, int(branches),
                                 int(pk_limit), out.ctypes.data, cap, offsets.ctypes.data,
                                 leaf_ids.ctypes.data, ctypes.byref(n_leaves))
    if total == -2:
        return None
    if total < 0:
        raise NativeIOError(f"io_leaf_payloads failed ({total})")
    k = n_leaves.value
    return out[:total], offsets[: k + 1], leaf_ids[:k]


class GpkgReaderFallback(Exception):
    """The native GPKG encoder met a row it cannot encode bit for bit as
    the Python encoder does (a geometry that needs the full re-encode, an
    unexpected storage class): the caller re-streams through Python."""


class GpkgNativeReader:
    """The fused read + encode over a GPKG table (``io_gpkg_*``): each
    :meth:`next_batch` steps the prepared SELECT and returns ``(pks int64
    (n,), buf uint8, offsets int64 (n+1,))``, blob i
    ``buf[offsets[i]:offsets[i+1]]``. The ctypes call runs without the GIL.
    Raises :class:`GpkgReaderFallback` on a row the encoder cannot take."""

    def __init__(self, handle, lib, est_row_bytes):
        self._h = handle
        self._lib = lib
        self._row_bytes = max(64, int(est_row_bytes))  # doubled when a row outgrows it

    def next_batch(self, max_rows):
        """-> (pks, buf, offsets), or None at the end of the table."""
        if self._h is None:
            return None
        while True:
            pks = np.empty(max_rows, dtype=np.int64)
            cap = max_rows * self._row_bytes + 4096
            buf = np.empty(cap, dtype=np.uint8)
            offsets = np.empty(max_rows + 1, dtype=np.int64)
            n = self._lib.io_gpkg_next(self._h, max_rows, pks.ctypes.data, buf.ctypes.data, cap,
                                       offsets.ctypes.data)
            if n == -5:  # one row outgrew the buffer: it waits in the handle
                self._row_bytes *= 2
                continue
            if n == -6:
                self.close()
                raise GpkgReaderFallback()
            if n < 0:
                self.close()
                raise NativeIOError(f"native GPKG reader failed (rc={n})")
            if n == 0:
                self.close()
                return None
            return pks[:n], buf, offsets[: n + 1]

    def close(self):
        if self._h is not None:
            self._lib.io_gpkg_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def open_gpkg_reader(db_path, sql, val_cols, kinds, pk_col, prefix, geom_ext_code,
                     est_row_bytes=256):
    """-> a :class:`GpkgNativeReader` over ``sql`` on ``db_path``.
    ``val_cols``/``kinds``: for each blob value (the legend's non-pk order)
    its SELECT column and encode kind (0 plain, 1 geometry, 2 bool, 3
    float, 4 timestamp); ``prefix``: the msgpack head every feature blob
    starts with. Raises :class:`NativeIOError` when the reader cannot
    open: no ``libsqlite3`` to dlopen, or a database or statement sqlite
    refuses."""
    lib = load_io()
    val_cols = np.ascontiguousarray(val_cols, dtype=np.int32)
    kinds_u8 = np.ascontiguousarray(kinds, dtype=np.uint8)
    prefix = bytes(prefix)
    handle = lib.io_gpkg_open(os.fsencode(db_path), sql.encode(), len(kinds_u8),
                              val_cols.ctypes.data, kinds_u8.ctypes.data, int(pk_col), prefix,
                              len(prefix), int(geom_ext_code))
    if not handle:
        raise NativeIOError(f"native GPKG reader cannot open {db_path!r} (libsqlite3.so.0 "
                            "missing, or sqlite refused the database or the statement)")
    return GpkgNativeReader(handle, lib, est_row_bytes)


def inflate_pack_batch(pack_buf, offsets, max_total=None):
    """A whole pack's bytes (an mmap) and record offsets -> (n_consumed,
    types uint8, payload uint8, payload_offsets int64 (n_consumed+1,)), or
    None when a record is malformed (the caller reads one at a time). A
    delta record comes back as type 0 with an empty slot. ``max_total``
    bounds the payload buffer: only the longest prefix of records whose
    payloads fit (at least one) is consumed, and the caller loops."""
    lib = load_io()
    buf = np.frombuffer(pack_buf, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(offsets)
    types = np.zeros(n, dtype=np.uint8)
    cum = np.zeros(n + 1, dtype=np.int64)
    total = lib.io_inflate_batch(buf.ctypes.data, len(buf), offsets.ctypes.data, n, None, 0,
                                 cum.ctypes.data, types.ctypes.data)
    if total < 0:
        return None
    take = n
    if max_total is not None and total > max_total:
        take = max(1, int(np.searchsorted(cum, max_total, side="right")) - 1)
        total = int(cum[take])
        offsets = offsets[:take]
        types = types[:take]
    out_offsets = np.zeros(take + 1, dtype=np.int64)
    if total == 0 and not types.any():
        return take, types, np.empty(0, dtype=np.uint8), out_offsets
    out = np.empty(int(total), dtype=np.uint8)
    rc = lib.io_inflate_batch(buf.ctypes.data, len(buf), offsets.ctypes.data, take,
                              out.ctypes.data, int(total), out_offsets.ctypes.data,
                              types.ctypes.data)
    if rc < 0:
        return None
    return take, types, out, out_offsets
