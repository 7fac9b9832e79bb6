"""The spatial join's envelope-overlap test: kernel K5
(``csrc/envelope_join.cu``), the port of kart_tpu's
``diff/backend.py:_make_sharded_join._step``, with its plain PyTorch
version.

A build tile of (T, 4) f32 wsen envelopes against a probe batch of (B, 4):
per probe row the number of build rows its envelope overlaps (cyclic
longitude, comparisons only: a NaN row never matches), the pair total, and
on request the overlapping pairs themselves in row-major order, which the
exact refine takes instead of rebuilding the matrix on the host.
"""

from typing import NamedTuple

import torch

from kart_tpu_torch import runtime
from kart_tpu_torch.ops import _build

_SIGNATURES = {
    "kart_envelope_join": [
        _build.P, _build.I32, _build.I32, _build.I32, _build.P, _build.I32, _build.P, _build.P,
        _build.P, _build.P, _build.P, _build.P, _build.I32, _build.P,
    ]
}

#: probe rows a block of K5 (128 threads x 4 rows) and its largest slice of
#: build rows (``csrc/envelope_join.cu``)
BLOCK_ROWS = 512
MAX_SLICE = 1024
#: blocks a launch aims at for each SM
BLOCKS_PER_SM = 16

#: probe rows a chunk of the plain version (bounds its (chunk, T) matrices)
PLAIN_CHUNK_ROWS = 8192


def _check(env, what):
    if env.dtype != torch.float32 or env.dim() != 2 or env.shape[1] != 4 or not env.is_contiguous():
        raise ValueError(f"envelope_join: {what} must be contiguous f32 (n, 4)")


def envelope_join(build_env, probe_env, pairs=False):
    """(T, 4) build x (B, 4) probe f32 envelopes on one device -> (counts
    int32 (B,), total int, (probe row int32 (P,), build row int32 (P,)) in
    row-major order when ``pairs``, else None). CUDA tensors run K5 (a
    counts pass, then a pairs pass when pairs are asked for and found,
    each counted as a launch); CPU tensors run :func:`envelope_join_plain`."""
    _check(build_env, "build envelopes")
    _check(probe_env, "probe envelopes")
    device = probe_env.device
    if build_env.device != device:
        raise ValueError("envelope_join: both sides must be on one device")
    if device.type == "cpu":
        return envelope_join_plain(build_env, probe_env, pairs)
    if device.type != "cuda":
        raise runtime.DeviceUnavailable(f"envelope_join: unsupported device {device}")
    launch = envelope_join_launch(build_env, probe_env, pairs)
    return envelope_join_finish(launch, int(launch.total.item()))


class JoinLaunch(NamedTuple):
    """K5's counts pass, enqueued and not yet read back."""

    build_env: torch.Tensor
    probe_env: torch.Tensor
    counts: torch.Tensor  # int32 (B,)
    total: torch.Tensor  # int64 (1,): the pair total, on the device
    cells: torch.Tensor  # int32 (B * slices,) when pairs were asked for
    slice_rows: int
    n_slices: int
    pairs: bool


def envelope_join_launch(build_env, probe_env, pairs=False):
    """K5's counts pass on CUDA tensors (checked as :func:`envelope_join`
    checks them), with no host sync: -> a :class:`JoinLaunch`, whose pair
    total :func:`envelope_join_finish` takes once it has been read. A mesh
    enqueues every device's pass before it reads any total."""
    _check(build_env, "build envelopes")
    _check(probe_env, "probe envelopes")
    device = probe_env.device
    if build_env.device != device:
        raise ValueError("envelope_join: both sides must be on one device")
    if device.type != "cuda":
        raise runtime.DeviceUnavailable(f"envelope_join: K5 needs a CUDA device, not {device}")
    t, b = build_env.shape[0], probe_env.shape[0]
    if t >= 2**31 or b >= 2**31:
        raise ValueError("envelope_join: a side holds 2^31 rows or more")
    for env in (build_env, probe_env):
        if env.numel() and env.data_ptr() % 16:
            raise ValueError("envelope_join: envelope rows must be 16-byte aligned")
    slice_rows, n_slices = tile_slices(t, b, _build.sm_count(device))
    counts = torch.empty(b, dtype=torch.int32, device=device)
    total = torch.empty(1, dtype=torch.int64, device=device)
    cells = torch.empty(b * n_slices if pairs else 0, dtype=torch.int32, device=device)
    lib = _build.load_library("envelope_join", device, _SIGNATURES)
    rc = lib.kart_envelope_join(build_env.data_ptr(), t, slice_rows, n_slices,
                                probe_env.data_ptr(), b, counts.data_ptr(), total.data_ptr(),
                                cells.data_ptr() if pairs else None, None, None, None,
                                device.index, _build.stream_ptr(device))
    _build.check(lib, rc, "envelope_join")
    runtime.count("envelope_join_launches")
    return JoinLaunch(build_env, probe_env, counts, total, cells, slice_rows, n_slices, pairs)


def envelope_join_finish(launch, n_pairs):
    """A :class:`JoinLaunch` and its pair total, read back -> what
    :func:`envelope_join` returns: the pairs pass runs when pairs were
    asked for and found."""
    if not launch.pairs:
        return launch.counts, n_pairs, None
    device = launch.probe_env.device
    pair_probe = torch.empty(n_pairs, dtype=torch.int32, device=device)
    pair_build = torch.empty(n_pairs, dtype=torch.int32, device=device)
    if n_pairs:
        lib = _build.load_library("envelope_join", device, _SIGNATURES)
        offs = slice_offsets(launch.cells)
        rc = lib.kart_envelope_join(launch.build_env.data_ptr(), launch.build_env.shape[0],
                                    launch.slice_rows, launch.n_slices,
                                    launch.probe_env.data_ptr(), launch.probe_env.shape[0],
                                    None, None, launch.cells.data_ptr(), offs.data_ptr(),
                                    pair_probe.data_ptr(), pair_build.data_ptr(),
                                    device.index, _build.stream_ptr(device))
        _build.check(lib, rc, "envelope_join (pairs)")
        runtime.count("envelope_join_launches")
    return launch.counts, n_pairs, (pair_probe, pair_build)


def tile_slices(t, b, sms):
    """K5's cut of a ``t``-row build tile for a ``b``-row probe batch ->
    (slice rows, slices): enough slices that the blocks (512 probe rows x
    one slice) fill every SM ``BLOCKS_PER_SM`` times over, each slice a
    multiple of 32 rows and at most ``MAX_SLICE``."""
    if t == 0:
        return 32, 0
    ceil = lambda x, y: -(-x // y)  # noqa: E731
    want = ceil(BLOCKS_PER_SM * sms, max(ceil(b, BLOCK_ROWS), 1))
    slice_rows = min(MAX_SLICE, ceil(ceil(t, want), 32) * 32)
    return slice_rows, ceil(t, slice_rows)


def slice_offsets(cells):
    """The pairs pass's layout: int32 (B * slices,) per-(probe row, slice)
    counts, row-major -> int64 their exclusive scan, where each (row,
    slice) writes its pairs, so that they come out in row-major order."""
    wide = cells.to(torch.int64)
    return torch.cumsum(wide, 0) - wide


def overlap_matrix(probe, build):
    """(B, 4) x (T, 4) f32 -> bool (B, T): kart_tpu's ``_join_overlap_np``
    term for term."""
    pw, ps, pe, pn = (c[:, None] for c in probe.unbind(1))
    bw, bs, be, bn = (c[None, :] for c in build.unbind(1))
    lat = (bs <= pn) & (ps <= bn)
    a = bw <= pe
    b = pw <= be
    bwrap = be < bw
    pwrap = pe < pw
    both = bwrap & pwrap
    one = bwrap ^ pwrap
    return lat & ((a & b) | both | (one & (a | b)))


def envelope_join_plain(build_env, probe_env, pairs=False):
    """Plain PyTorch version of K5 (any device): the overlap matrix a chunk
    of probe rows at a time."""
    b = probe_env.shape[0]
    device = probe_env.device
    counts = torch.zeros(b, dtype=torch.int32, device=device)
    found = []
    if build_env.shape[0] and b:
        for lo in range(0, b, PLAIN_CHUNK_ROWS):
            hit = overlap_matrix(probe_env[lo : lo + PLAIN_CHUNK_ROWS], build_env)
            counts[lo : lo + hit.shape[0]] = hit.sum(dim=1, dtype=torch.int32)
            if pairs:
                rows, cols = torch.nonzero(hit, as_tuple=True)
                found.append((rows + lo, cols))
    total = int(counts.sum(dtype=torch.int64).item())
    if not pairs:
        return counts, total, None
    if not found:
        empty = torch.zeros(0, dtype=torch.int32, device=device)
        return counts, total, (empty, empty.clone())
    return counts, total, (torch.cat([r for r, _ in found]).to(torch.int32),
                           torch.cat([c for _, c in found]).to(torch.int32))

