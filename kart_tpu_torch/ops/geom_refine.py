"""The query's exact refine: kernel K6 (``csrc/geom_refine.cu``), the port
of kart_tpu's ``diff/backend.py:_make_sharded_refine._step``, with its
plain PyTorch version (kart_tpu's ``geom.refine_pairs_host``).

Candidate pairs (feature ``ia[p]`` of column A, ``ib[p]`` of column B) ->
one exact verdict each: some segment of one touches some segment of the
other, or a vertex of one lies inside the other where that one is a
polygon (even-odd rule). Both sides come as their vertex column's flat
segment table (:func:`resident_segments`), which stays on the device
between calls, so a call moves only the pair indices.
"""

import torch

from kart_tpu_torch import runtime
from kart_tpu_torch.geom import KIND_POLY, ray_crossings, seg_pairs_intersect
from kart_tpu_torch.ops import _build
from kart_tpu_torch.ops.blocks import to_device

_SIGNATURES = {
    "kart_geom_refine": [_build.P] * 14 + [_build.I64, _build.P, _build.I32, _build.I32, _build.P]
}

#: the plain version's largest (pairs, SA, SB) slab, in elements
PLAIN_SLAB_ELEMENTS = 1 << 24

_THREADS = 256


def resident_segments(col, device):
    """A VertexColumn's segment table on ``device``: (x0, y0, x1, y1 int32
    (S,), offs int64 (N+1,), kinds uint8 (N,)), uploaded on the first call
    for that device and kept on the column."""
    key = str(device)
    segs = col._resident.get(key)
    if segs is None:
        x0, y0, x1, y1, offs = col.segment_table()
        segs = tuple(to_device(a, device) for a in (x0, y0, x1, y1, offs, col.kinds))
        col._resident[key] = segs
    return segs


def _check(segs, idx, device, what):
    if len(segs) != 6 or any(t.device != device or not t.is_contiguous() for t in segs):
        raise ValueError(f"geom_refine: {what} segments must be contiguous tensors on {device}")
    if ([t.dtype for t in segs]
            != [torch.int32] * 4 + [torch.int64, torch.uint8]):
        raise ValueError(f"geom_refine: {what} segments must be int32 x4, int64 offs, uint8 kinds")
    if idx.dtype != torch.int64 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"geom_refine: {what} pair indices must be contiguous int64 (P,)")


def geom_refine(seg_a, ia, seg_b, ib):
    """Segment tables of columns A and B (:func:`resident_segments`) + int64
    (P,) feature indices -> bool (P,) exact verdicts, on the indices'
    device. CUDA tensors run K6; CPU tensors run :func:`geom_refine_plain`."""
    device = ia.device
    _check(seg_a, ia, device, "A")
    _check(seg_b, ib, device, "B")
    if ia.shape != ib.shape:
        raise ValueError("geom_refine: ia and ib differ in length")
    if device.type == "cpu":
        return geom_refine_plain(seg_a, ia, seg_b, ib)
    if device.type != "cuda":
        raise runtime.DeviceUnavailable(f"geom_refine: unsupported device {device}")
    n = ia.numel()
    out = torch.empty(n, dtype=torch.uint8, device=device)
    if n == 0:
        return out.view(torch.bool)
    lib = _build.load_library("geom_refine", device, _SIGNATURES)
    rc = lib.kart_geom_refine(
        *(t.data_ptr() for t in seg_a), *(t.data_ptr() for t in seg_b),
        ia.data_ptr(), ib.data_ptr(), n, out.data_ptr(),
        _build.grid_blocks(device, n * 32, threads=_THREADS), device.index,
        _build.stream_ptr(device),
    )
    _build.check(lib, rc, "geom_refine")
    runtime.count("geom_refine_launches")
    return out.view(torch.bool)


def _slabs(segs, idx):
    """Per pair, its feature's segments zero-padded to the longest:
    -> ([x0, y0, x1, y1] int64 (P, cap), counts int64 (P,), is polygon
    bool (P,))."""
    x0, y0, x1, y1, offs, kinds = segs
    lo = offs[idx]
    counts = offs[idx + 1] - lo
    cap = max(int(counts.max()), 1) if counts.numel() else 1
    slot = torch.arange(cap, device=idx.device)
    valid = slot[None, :] < counts[:, None]
    src = torch.where(valid, lo[:, None] + slot[None, :], 0)
    if x0.numel():
        cols = [torch.where(valid, c[src].to(torch.int64), 0) for c in (x0, y0, x1, y1)]
    else:
        cols = [torch.zeros(src.shape, dtype=torch.int64, device=idx.device)] * 4
    return cols, counts, kinds[idx] == KIND_POLY


def geom_refine_plain(seg_a, ia, seg_b, ib):
    """Plain PyTorch version of K6 (any device): kart_tpu's
    ``refine_pairs_host`` over padded (pairs, SA, SB) slabs, in rounds of
    pairs cut to keep a slab under ``PLAIN_SLAB_ELEMENTS``."""
    total = ia.numel()
    out = torch.zeros(total, dtype=torch.bool, device=ia.device)
    if total == 0:
        return out
    longest = lambda segs, idx: int((segs[4][idx + 1] - segs[4][idx]).max())  # noqa: E731
    cells = max(longest(seg_a, ia), 1) * max(longest(seg_b, ib), 1)
    rows = max(PLAIN_SLAB_ELEMENTS // cells, 1)
    for lo in range(0, total, rows):
        hi = min(lo + rows, total)
        a, a_n, a_poly = _slabs(seg_a, ia[lo:hi])
        b, b_n, b_poly = _slabs(seg_b, ib[lo:hi])
        am = torch.arange(a[0].shape[1], device=ia.device)[None, :] < a_n[:, None]
        bm = torch.arange(b[0].shape[1], device=ia.device)[None, :] < b_n[:, None]
        pm = am[:, :, None] & bm[:, None, :]
        down = [v[:, :, None] for v in a]  # A segments down the matrix
        across = [v[:, None, :] for v in b]  # B segments across
        seg_any = (seg_pairs_intersect(*down, *across) & pm).flatten(1).any(dim=1)
        cnt_ab = (ray_crossings(down[0], down[1], *across) & pm).sum(dim=2)
        a_in_b = (((cnt_ab & 1) == 1) & am).any(dim=1)
        cnt_ba = (ray_crossings(across[0], across[1], *down) & pm).sum(dim=1)
        b_in_a = (((cnt_ba & 1) == 1) & bm).any(dim=1)
        out[lo:hi] = seg_any | (b_poly & a_in_b) | (a_poly & b_in_a)
    return out
