"""Build of the port's host C++ sources (``hostsrc/*.cpp``) into shared
libraries loaded with ctypes.

``g++`` compiles a source at its first use into ``_build/host-<hash>/``,
the hash taken over the source and the flags, so an edited source
rebuilds and an unchanged one never does. Builders are serialised by a
file lock, and each library is written to a temporary name and renamed,
so a reader never maps half a file. A missing compiler or a failed
compile raises :class:`HostBuildError`: nothing falls back to another
route. Imports nothing of torch, so a spawned import worker can load the
IO core without it.
"""

import fcntl
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOSTSRC_DIR = os.path.join(PKG_DIR, "hostsrc")
BUILD_ROOT = os.path.join(PKG_DIR, "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC")


class HostBuildError(RuntimeError):
    """A host source could not be compiled or loaded (no g++, g++ failed,
    or the library does not load)."""


def find_cxx(source):
    cxx = shutil.which("g++")
    if cxx is None:
        raise HostBuildError(f"g++ not found on PATH; it builds {os.path.join('hostsrc', source)}")
    return cxx


def build_dir(src_dir, source, link_flags=(), build_root=None):
    """The cache directory of ``source`` built with ``link_flags``."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(link_flags)).encode())
    with open(os.path.join(src_dir, source), "rb") as fh:
        h.update(fh.read())
    return os.path.join(build_root or BUILD_ROOT, "host-" + h.hexdigest()[:16])


def build_library(src_dir, source, lib_name, link_flags=(), build_root=None):
    """Compile ``src_dir/source`` unless the cache holds it. -> the
    library's path."""
    build_root = build_root or BUILD_ROOT
    d = build_dir(src_dir, source, link_flags, build_root)
    path = os.path.join(d, lib_name)
    if os.path.exists(path):
        return path
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(build_root, ".host-lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path
        tmp = f"{path}.tmp{os.getpid()}"
        cmd = [find_cxx(source), *CXX_FLAGS, "-o", tmp, os.path.join(src_dir, source),
               *link_flags]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise HostBuildError(f"g++ failed for {source} (exit {r.returncode}):\n"
                                 f"{r.stdout}{r.stderr}")
        os.replace(tmp, path)
    return path
