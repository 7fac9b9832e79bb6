"""The batch mercator projection: kernel K7 (``csrc/merc.cu``), the port of
kart_tpu's ``diff/backend.py:_make_sharded_merc._merc``, with its plain
PyTorch version.

(M, 4) f64 ``(w, s, e, n)`` degree rows -> a (4, M) f64 tensor of the
normalized mercator columns ``mx0, my0`` (the north-west corner, from w and
n) and ``mx1, my1`` (the south-east corner, from e and s), each computed as
:func:`kart_tpu_torch.tiles.grid.merc_xy_cols` computes it on the host.

The projection is not bit-identical to numpy's: CUDA's ``sin`` and ``log``
differ from numpy's by ulps. The tile quantizer
(:func:`kart_tpu_torch.tiles.clip.quantize_from_merc`) re-projects on the
host every row that lands near a rounding boundary, so the exported
integers are the host's whichever projection ran. K7 and its plain version
on the card use the same libdevice functions and round every operation
alike, so they agree bit for bit.
"""

import math

import torch

from kart_tpu_torch import runtime
from kart_tpu_torch.ops import _build
from kart_tpu_torch.tiles.grid import MERC_MAX_LAT

_SIGNATURES = {"kart_merc": [_build.P, _build.I64, _build.P, _build.I32, _build.I32, _build.P]}

_THREADS = 256

#: rows a CPU call of the plain version takes at once: PyTorch's CPU
#: ``sin`` and ``log`` split a tensor of more than 2,048 elements among its
#: intra-op threads (the other ops here only above 32,768), so at this size
#: every op runs on the calling thread. Threaded calls of the MKL build of
#: PyTorch for the CPU have been seen to return some rows at about float
#: precision (7e-9 relative; 1.2e-7 absolute on rows at the mercator
#: clamp), an error the tile quantizer's margin does not cover; one thread a
#: call never has. (The export's CPU route projects with numpy: this path
#: serves a CPU tensor handed to :func:`merc`.)
CPU_SLICE_ROWS = 2048


def _check(env):
    if (env.dtype != torch.float64 or env.dim() != 2 or env.shape[1] != 4
            or not env.is_contiguous()):
        raise ValueError("merc: envelopes must be contiguous f64 (m, 4)")


def merc(env):
    """(m, 4) f64 wsen degree rows -> (4, m) f64 mercator columns (mx0, my0,
    mx1, my1), on the rows' device. CUDA tensors run K7; CPU tensors run
    :func:`merc_plain`."""
    _check(env)
    device = env.device
    if device.type == "cpu":
        return merc_plain(env)
    if device.type != "cuda":
        raise runtime.DeviceUnavailable(f"merc: unsupported device {device}")
    m = env.shape[0]
    out = torch.empty((4, m), dtype=torch.float64, device=device)
    if m == 0:
        return out
    if env.data_ptr() % 16:
        raise ValueError("merc: envelope rows must be 16-byte aligned")
    lib = _build.load_library("merc", device, _SIGNATURES)
    rc = lib.kart_merc(env.data_ptr(), m, out.data_ptr(),
                       _build.grid_blocks(device, m, threads=_THREADS), device.index,
                       _build.stream_ptr(device))
    _build.check(lib, rc, "merc")
    runtime.count("merc_launches")
    return out


def _merc_cols(lon, lat, c360, c4pi):
    lat = torch.clamp(lat, -MERC_MAX_LAT, MERC_MAX_LAT)
    x = (lon + 180.0) / c360
    s = torch.sin(lat * (math.pi / 180.0))
    y = 0.5 - torch.log((1.0 + s) / (1.0 - s)) / c4pi
    return x, y


def merc_plain(env):
    """Plain PyTorch version of K7 (any device): numpy's order of
    operations. The divisors are 0-dim tensors on the rows' device, since
    PyTorch's CUDA division by a Python number multiplies by its
    reciprocal, which rounds differently from numpy's true division. On the
    CPU it takes :data:`CPU_SLICE_ROWS` rows at a time."""
    _check(env)
    if env.device.type == "cpu" and env.shape[0] > CPU_SLICE_ROWS:
        return torch.cat([merc_plain(env[i : i + CPU_SLICE_ROWS])
                          for i in range(0, env.shape[0], CPU_SLICE_ROWS)], dim=1)
    c360 = torch.tensor(360.0, dtype=torch.float64, device=env.device)
    c4pi = torch.tensor(4.0 * math.pi, dtype=torch.float64, device=env.device)
    w, s, e, n = env.unbind(dim=1)
    mx0, my0 = _merc_cols(w, n, c360, c4pi)
    mx1, my1 = _merc_cols(e, s, c360, c4pi)
    return torch.stack([mx0, my0, mx1, my1])
