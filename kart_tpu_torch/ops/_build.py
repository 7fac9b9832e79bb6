"""Kernel build: ``csrc/*.cu`` -> one shared library per source, loaded
with ctypes.

Each source is compiled by its own ``nvcc`` process (all started together)
for sm_90a into a cache directory keyed by a hash of every file under
``csrc/`` and the flags, so an edited source rebuilds and an unchanged one
never does. A file lock serialises builders (pytest-xdist workers,
concurrent callers). Launchers are ``extern "C"``: they take raw device
pointers, lengths and the caller's CUDA stream, and return
``cudaGetLastError()``; :func:`check` turns a non-zero code into
:class:`KernelLaunchError`. A failed build raises; nothing falls back to
the plain versions.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from kart_tpu_torch.runtime import check_capability

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(PKG_DIR, "_build")
DEFAULT_CUDA_HOME = "/usr/local/cuda"

NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class BuildError(RuntimeError):
    """A kernel source failed to compile."""


class NvccNotFound(BuildError):
    """No CUDA compiler on this machine."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def find_nvcc():
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise NvccNotFound(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{DEFAULT_CUDA_HOME}/bin); the CUDA toolkit is needed to build "
        "the kernels"
    )


def kernel_names():
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def build_dir():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC_DIR)):
        h.update(f.encode())
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build_all():
    """Compile every kernel source not yet in the cache. -> (build dir,
    {name: compiler log}). The log holds ptxas's register and shared
    memory report."""
    d = build_dir()
    os.makedirs(d, exist_ok=True)
    names = kernel_names()
    with open(os.path.join(BUILD_ROOT, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [n for n in names if not os.path.exists(_lib_path(d, n))]
        if todo:
            _compile(d, todo)
    logs = {}
    for n in names:
        with open(os.path.join(d, f"lib{n}.log")) as fh:
            logs[n] = fh.read()
    return d, logs


def _lib_path(d, name):
    return os.path.join(d, f"lib{name}.so")


def _compile(d, names):
    nvcc = find_nvcc()
    procs = []
    for n in names:
        tmp = _lib_path(d, n) + f".tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
               os.path.join(CSRC_DIR, n + ".cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for n, tmp, p in procs:
        out, _ = p.communicate()
        with open(os.path.join(d, f"lib{n}.log"), "w") as fh:
            fh.write(out)
        if p.returncode != 0:
            failed.append(f"{n}.cu (exit {p.returncode}):\n{out}")
        else:
            os.replace(tmp, _lib_path(d, n))
    if failed:
        raise BuildError("nvcc failed for " + "\n".join(failed))


_LIBS = {}
_CHECKED = set()
_lock = threading.Lock()


def load_library(name, device, signatures):
    """The ctypes library of ``csrc/<name>.cu``, built on first use.
    ``signatures`` maps each launcher to its argtypes (restype is int,
    the CUDA error code). Raises unless ``device`` is an sm_90 card."""
    with _lock:
        if device.index not in _CHECKED:
            check_capability(device)
            _CHECKED.add(device.index)
        lib = _LIBS.get(name)
        if lib is None:
            d, _ = build_all()
            lib = ctypes.CDLL(_lib_path(d, name))
            lib.kart_error_string.argtypes = [ctypes.c_int]
            lib.kart_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def check(lib, rc, what):
    if rc != 0:
        msg = lib.kart_error_string(rc).decode()
        raise KernelLaunchError(f"{what} launch failed: CUDA error {rc} ({msg})")


def stream_ptr(device):
    return torch.cuda.current_stream(device).cuda_stream


def sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def grid_blocks(device, n, threads=256, per_sm=8):
    """Blocks for a grid-stride launch over ``n`` items: enough to fill
    every SM ``per_sm`` times over, never more than the items need."""
    return max(1, min(-(-n // threads), sm_count(device) * per_sm))


P = ctypes.c_void_p
I64 = ctypes.c_int64
I32 = ctypes.c_int
F32 = ctypes.c_float
F64 = ctypes.c_double
