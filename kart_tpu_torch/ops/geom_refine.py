"""The query's exact refine: kernel K6 (``csrc/geom_refine.cu``), the port
of kart_tpu's ``diff/backend.py:_make_sharded_refine._step``, with its
plain PyTorch version (kart_tpu's ``geom.refine_pairs_host``).

Candidate pairs (feature ``ia[p]`` of column A, ``ib[p]`` of column B) ->
one exact verdict each: some segment of one touches some segment of the
other, or a vertex of one lies inside the other where that one is a
polygon (even-odd rule). Both sides come as their vertex column's flat
segment table (:func:`resident_segments`), which stays on the device
between calls with each feature's box beside it, so a call moves only the
pair indices.
"""

from typing import NamedTuple

import numpy as np
import torch

from kart_tpu_torch import runtime
from kart_tpu_torch.geom import KIND_POLY, ray_crossings, seg_pairs_intersect
from kart_tpu_torch.ops import _build
from kart_tpu_torch.ops.blocks import to_device

_SIGNATURES = {
    "kart_geom_refine": [_build.P] * 16
    + [_build.I64, _build.P, _build.P, _build.I32, _build.I32, _build.P]
}

#: the longest side of a short pair, which K6 gives 8 lanes (kGroup in
#: ``csrc/geom_refine.cu``); a longer one goes to the long kernel
SHORT_SEGMENTS = 8

#: the plain version's largest (pairs, SA, SB) slab, in elements
PLAIN_SLAB_ELEMENTS = 1 << 24


class SegmentTable(NamedTuple):
    """A vertex column's flat segment table on one device, as K6 reads it."""

    x0: torch.Tensor  # int32 (S,) segment endpoints, feature by feature
    y0: torch.Tensor
    x1: torch.Tensor
    y1: torch.Tensor
    offs: torch.Tensor  # int64 (N+1,): feature i's segments are [offs[i], offs[i+1])
    kinds: torch.Tensor  # uint8 (N,)
    #: int32 (N, 4), each feature's segments' box (low x, high x, low y, high
    #: y), (INT32_MAX, INT32_MIN, INT32_MAX, INT32_MIN) for a feature without
    #: segments: what K6's exact culls read
    boxes: torch.Tensor
    longest: int  # the most segments a feature holds


def feature_boxes(x0, y0, x1, y1, offs):
    """Host segment table -> int32 (N, 4) feature boxes (:class:`SegmentTable`)."""
    n = len(offs) - 1
    info = np.iinfo(np.int32)
    boxes = np.tile(np.asarray([info.max, info.min, info.max, info.min], np.int32), (n, 1))
    some = offs[1:] > offs[:-1]
    lo = offs[:-1][some]
    if len(lo):
        boxes[some, 0] = np.minimum.reduceat(np.minimum(x0, x1), lo)
        boxes[some, 1] = np.maximum.reduceat(np.maximum(x0, x1), lo)
        boxes[some, 2] = np.minimum.reduceat(np.minimum(y0, y1), lo)
        boxes[some, 3] = np.maximum.reduceat(np.maximum(y0, y1), lo)
    return boxes


def segment_table(x0, y0, x1, y1, offs, kinds, device):
    """Host segment columns (x0, y0, x1, y1 int32 (S,), offs int64 (N+1,),
    kinds uint8 (N,)) -> a :class:`SegmentTable` on ``device``, with its
    feature boxes and longest feature."""
    cols = (to_device(np.ascontiguousarray(a), device) for a in (x0, y0, x1, y1, offs, kinds))
    return SegmentTable(*cols, to_device(feature_boxes(x0, y0, x1, y1, offs), device),
                        int(np.diff(offs).max()) if len(offs) > 1 else 0)


def resident_segments(col, device):
    """A VertexColumn's :func:`segment_table` on ``device``, built on the
    first call for that device and kept on the column."""
    key = str(device)
    segs = col._resident.get(key)
    if segs is None:
        segs = segment_table(*col.segment_table(), col.kinds, device)
        col._resident[key] = segs
    return segs


def _check(segs, idx, device, what):
    if not isinstance(segs, SegmentTable):
        raise ValueError(f"geom_refine: {what} segments must be a SegmentTable "
                         "(segment_table, resident_segments)")
    tensors = segs[:-1]  # all but ``longest``, in K6's argument order
    if any(t.device != device or not t.is_contiguous() for t in tensors):
        raise ValueError(f"geom_refine: {what} segments must be contiguous tensors on {device}")
    if ([t.dtype for t in tensors]
            != [torch.int32] * 4 + [torch.int64, torch.uint8, torch.int32]):
        raise ValueError(f"geom_refine: {what} segments must be int32 x4, int64 offs, uint8 "
                         "kinds, int32 boxes")
    if segs.boxes.shape != (segs.offs.numel() - 1, 4):
        raise ValueError(f"geom_refine: {what} segments need one box a feature")
    if idx.dtype != torch.int64 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"geom_refine: {what} pair indices must be contiguous int64 (P,)")


def geom_refine(seg_a, ia, seg_b, ib):
    """Segment tables of columns A and B (:func:`resident_segments`) + int64
    (P,) feature indices -> bool (P,) exact verdicts, on the indices'
    device. CUDA tensors run K6 (its two kernels, counted as one launch);
    CPU tensors run :func:`geom_refine_plain`."""
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
    if n >= 2**31:
        raise ValueError("geom_refine: 2^31 pairs or more in one call")
    out = torch.empty(n, dtype=torch.uint8, device=device)
    if n == 0:
        return out.view(torch.bool)
    may_long = max(seg_a.longest, seg_b.longest) > SHORT_SEGMENTS
    # the long pairs' list and two counters
    scratch = torch.empty(n + 2, dtype=torch.int32, device=device)
    lib = _build.load_library("geom_refine", device, _SIGNATURES)
    rc = lib.kart_geom_refine(
        *(t.data_ptr() for t in seg_a[:-1]),
        *(t.data_ptr() for t in seg_b[:-1]),
        ia.data_ptr(), ib.data_ptr(), n, out.data_ptr(), scratch.data_ptr(), int(may_long),
        device.index,
        _build.stream_ptr(device),
    )
    _build.check(lib, rc, "geom_refine")
    runtime.count("geom_refine_launches")
    return out.view(torch.bool)


def _slabs(segs, idx):
    """Per pair, its feature's segments zero-padded to the longest:
    -> ([x0, y0, x1, y1] int64 (P, cap), counts int64 (P,), is polygon
    bool (P,))."""
    x0, y0, x1, y1, offs, kinds = segs[:6]
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
