"""The host floor of the diff's classify: what ``--device cpu`` runs.

kart_tpu never runs its device code on a CPU: it classifies with its
native C++ merge-join (``classify_blocks_host`` over ``native/kart_io.cpp``
``io_classify_sorted``), sequential scans of the two key-sorted sides. The
port keeps its own copy of that source (``hostsrc/classify_sorted.cpp``),
builds it with ``g++`` into ``_build/host-<hash>/``
(:mod:`~kart_tpu_torch.ops.host_build`: a hash of the source and the
flags, under a file lock, written to a temporary name and renamed) and
calls it through ctypes on the blocks' own arrays, mmap views
included, with no copy. A missing compiler or a failed build raises
:class:`HostBuildError`; nothing falls back to a slower route. K1's plain
version (``diff_kernel.classify_plain``) stays what the card's kernel is
held against.
"""

import ctypes
import threading

import numpy as np
import torch

from kart_tpu_torch.ops import _build, host_build
from kart_tpu_torch.ops.host_build import HostBuildError  # noqa: F401 (raised by the build)

HOSTSRC_DIR = host_build.HOSTSRC_DIR
SOURCE = "classify_sorted.cpp"
LIB_NAME = "libclassify_sorted.so"


def find_cxx():
    return host_build.find_cxx(SOURCE)


def build_dir():
    return host_build.build_dir(HOSTSRC_DIR, SOURCE, build_root=_build.BUILD_ROOT)


def build_library():
    """Compile the floor unless the cache holds it. -> the library's path."""
    return host_build.build_library(HOSTSRC_DIR, SOURCE, LIB_NAME, build_root=_build.BUILD_ROOT)


_lib = None
_lock = threading.Lock()


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            lib.io_classify_sorted.restype = ctypes.c_int64
            lib.io_classify_sorted.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            _lib = lib
    return _lib


def classify_sorted(old_keys, old_oids_u8, new_keys, new_oids_u8):
    """The merge-join over count-sliced key-sorted sides: keys int64 (n,),
    oids uint8 (n, 20). -> (old_class int8 (n_old,), new_class int8
    (n_new,), counts int64 [inserts, updates, deletes]), numpy."""
    lib = _library()
    n_old, n_new = len(old_keys), len(new_keys)
    old_keys = np.ascontiguousarray(old_keys, dtype=np.int64)
    new_keys = np.ascontiguousarray(new_keys, dtype=np.int64)
    old_oids_u8 = np.ascontiguousarray(old_oids_u8, dtype=np.uint8).reshape(n_old, 20)
    new_oids_u8 = np.ascontiguousarray(new_oids_u8, dtype=np.uint8).reshape(n_new, 20)
    old_class = np.zeros(n_old, dtype=np.int8)
    new_class = np.zeros(n_new, dtype=np.int8)
    counts = np.zeros(3, dtype=np.int64)
    lib.io_classify_sorted(
        old_keys.ctypes.data, old_oids_u8.ctypes.data, n_old,
        new_keys.ctypes.data, new_oids_u8.ctypes.data, n_new,
        old_class.ctypes.data, new_class.ctypes.data, counts.ctypes.data,
    )
    return old_class, new_class, counts


def classify_blocks_host(old_block, new_block):
    """FeatureBlock x2 -> (old_class int8, new_class int8, counts int64
    (3,)) CPU tensors, what ``classify_blocks`` returns on the CPU."""
    n_old, n_new = old_block.count, new_block.count
    old_class, new_class, counts = classify_sorted(
        old_block.keys[:n_old], _oid_bytes(old_block.oids, n_old),
        new_block.keys[:n_new], _oid_bytes(new_block.oids, n_new),
    )
    return torch.from_numpy(old_class), torch.from_numpy(new_class), torch.from_numpy(counts)


def _oid_bytes(oids, n):
    return np.asarray(oids[:n]).reshape(n, 5).view(np.uint8).reshape(n, 20)
