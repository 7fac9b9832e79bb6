"""Cyclic-longitude bbox intersection: kernel K3 (``csrc/bbox.cu``), the
port of kart_tpu's Pallas kernel ``ops/bbox.py:_bbox_kernel``, with its
plain PyTorch version.

Envelopes are (w, s, e, n) with longitudes cyclic over the anti-meridian:
``e < w`` wraps. Two cyclic ranges overlap iff
``(w2 - w1) mod 360 <= len1`` or ``(w1 - w2) mod 360 <= len2``. Everything
is f32, as on the TPU; unlike kart_tpu, small inputs are not routed to a
host f64 scan, so callers pad the query (the pre-pass pads by 1e-4).

Also the host classification of sidecar blocks against a query
(:func:`classify_env_blocks_np`, kart_tpu's numpy twin of the native
``classify_block``), which the query's scans and joins and the tile row
selection prune by, and kart_tpu's f64 numpy test
(:func:`bbox_intersects_np`), which the tile row selection scans with.
"""

import threading

import numpy as np
import torch

from kart_tpu_torch import runtime
from kart_tpu_torch.ops import _build

_SIGNATURES = {
    "kart_bbox": [
        _build.P, _build.P, _build.P, _build.P, _build.I64, _build.I64,
        _build.F32, _build.F32, _build.F32, _build.F32,
        _build.P, _build.I32, _build.I32, _build.P,
    ]
}


def _range_len_np(w, e):
    return np.where(e >= w, e - w, np.mod(e - w, 360.0))


def _cyclic_overlap_np(w1, e1, w2, e2):
    len1 = _range_len_np(w1, e1)
    len2 = _range_len_np(w2, e2)
    return (np.mod(w2 - w1, 360.0) <= len1) | (np.mod(w1 - w2, 360.0) <= len2)


def bbox_intersects_np(envelopes, query):
    """(N, 4) wsen envelopes + query (4,) -> bool (N,), in f64 numpy: the
    host test of the tile row selection and its exact refine."""
    envelopes = np.asarray(envelopes, dtype=np.float64)
    w, s, e, n = (envelopes[:, i] for i in range(4))
    qw, qs, qe, qn = (float(query[i]) for i in range(4))
    lat_ok = (s <= qn) & (qs <= n)
    lon_ok = _cyclic_overlap_np(w, e, np.float64(qw), np.float64(qe))
    return lat_ok & lon_ok


#: block classes of the pruned scan
BLOCK_ALL_OUT, BLOCK_ALL_IN, BLOCK_BOUNDARY = 0, 1, 2


def classify_env_blocks_np(agg, flags, query):
    """Sidecar block aggregates (nb,4) f32 union bboxes + (nb,) flag bytes +
    query (4,) -> int8 (nb,) BLOCK_* classes: all-out when the union misses
    the query, all-in when it lies inside it and is tight (flag 0),
    boundary otherwise. A non-finite union is boundary unless its latitudes
    rule it out."""
    agg = np.asarray(agg, dtype=np.float64)
    w, s, e, n = (agg[:, i] for i in range(4))
    qw, qs, qe, qn = (float(query[i]) for i in range(4))
    lon_finite = np.isfinite(w) & np.isfinite(e)
    with np.errstate(invalid="ignore"):
        lon_out = ~_cyclic_overlap_np(w, e, np.float64(qw), np.float64(qe))
        if qe >= qw:
            lon_in = (w >= qw) & (e <= qe)
        else:  # a wrapping query: inside [qw, 180] or [-180, qe]
            lon_in = (w >= qw) | (e <= qe)
    out = (n < qs) | (s > qn) | (lon_finite & lon_out)
    all_in = (
        ~out
        & (np.asarray(flags) == 0)
        & lon_finite
        & np.isfinite(s)
        & np.isfinite(n)
        & (s >= qs)
        & (n <= qn)
        & lon_in
    )
    cls = np.full(len(agg), BLOCK_BOUNDARY, dtype=np.int8)
    cls[out] = BLOCK_ALL_OUT
    cls[all_in] = BLOCK_ALL_IN
    return cls


def pad_envelopes(envelopes, multiple=None):
    """(N,4) -> (w, s, e, n) float32 columns padded to a multiple (1024
    items for small inputs, 65536 for large); padded rows get an empty
    range at latitude 91 (matches nothing). -> (w, s, e, n, N)."""
    n = envelopes.shape[0]
    if multiple is None:
        multiple = 65536 if n > 65536 else 1024
    padded_n = ((n + multiple - 1) // multiple) * multiple if n else multiple
    cols = np.full((4, padded_n), 91.0, dtype=np.float32)
    if n:
        cols[:, :n] = np.asarray(envelopes, dtype=np.float32).T
    return cols[0], cols[1], cols[2], cols[3], n


def bbox_cyclic(w, s, e, n, query, count=None):
    """f32 columns (N,) + query (4,) -> bool (N,) on the columns' device;
    rows at or past ``count`` (default N) are False. CUDA tensors run K3;
    CPU tensors run :func:`bbox_cyclic_plain`."""
    n_items = w.shape[0]
    count = n_items if count is None else int(count)
    for c in (w, s, e, n):
        if (c.dtype != torch.float32 or c.shape != (n_items,)
                or not c.is_contiguous() or c.device != w.device):
            raise ValueError("bbox_cyclic: columns must be contiguous f32 (N,) on one device")
    if not 0 <= count <= n_items:
        raise ValueError(f"bbox_cyclic: count {count} out of range")
    q = np.asarray(query, dtype=np.float32)
    device = w.device
    if device.type == "cpu":
        hit = bbox_cyclic_plain(w, s, e, n, q)
        hit[count:] = False
        return hit
    if device.type != "cuda":
        raise runtime.DeviceUnavailable(f"bbox_cyclic: unsupported device {device}")
    out = torch.empty(n_items, dtype=torch.bool, device=device)
    if n_items == 0:
        return out
    lib = _build.load_library("bbox", device, _SIGNATURES)
    rc = lib.kart_bbox(
        w.data_ptr(), s.data_ptr(), e.data_ptr(), n.data_ptr(), count, n_items,
        *(float(v) for v in q), out.data_ptr(),
        _build.grid_blocks(device, n_items), device.index, _build.stream_ptr(device),
    )
    _build.check(lib, rc, "bbox")
    runtime.count("bbox_launches")
    return out


def bbox_cyclic_plain(w, s, e, n, query):
    """Plain PyTorch version of K3 (any device): the expression of
    ``_bbox_intersects_jnp_core``. ``torch.remainder`` is floor-mod, like
    ``jnp.mod``."""
    qw, qs, qe, qn = torch.tensor(
        np.asarray(query, dtype=np.float32), device=w.device
    ).unbind()
    lat_ok = (s <= qn) & (qs <= n)
    len1 = torch.where(e >= w, e - w, torch.remainder(e - w, 360.0))
    len2 = torch.where(qe >= qw, qe - qw, torch.remainder(qe - qw, 360.0))
    return lat_ok & (
        (torch.remainder(qw - w, 360.0) <= len1)
        | (torch.remainder(w - qw, 360.0) <= len2)
    )


_RESIDENT_CACHE = {}  # (cache_key, device) -> (w, s, e, n tensors, count)
_RESIDENT_CACHE_MAX = 4
_RESIDENT_LOCK = threading.Lock()  # servers filter concurrently


def _resident_columns(cache_key, envelopes, device):
    """Device-resident padded envelope columns for ``cache_key``, uploaded
    on first use (counted in ``STATS["bbox_uploads"]``), so repeat queries
    over one envelope set skip the transfer."""
    key = (cache_key, str(device))
    with _RESIDENT_LOCK:
        entry = _RESIDENT_CACHE.get(key)
        if entry is not None and entry[4] == len(envelopes):
            return entry
    entry = _upload_columns(envelopes, device)
    with _RESIDENT_LOCK:
        while len(_RESIDENT_CACHE) >= _RESIDENT_CACHE_MAX and key not in _RESIDENT_CACHE:
            _RESIDENT_CACHE.pop(next(iter(_RESIDENT_CACHE)), None)
        _RESIDENT_CACHE[key] = entry
    return entry


def _upload_columns(envelopes, device):
    w, s, e, n, count = pad_envelopes(np.asarray(envelopes))
    cols = torch.from_numpy(np.stack([w, s, e, n]))
    if device.type == "cuda":
        cols = cols.pin_memory().to(device, non_blocking=True)
    runtime.count("bbox_uploads")
    return (*cols.unbind(), count)


def bbox_intersects(envelopes, query, *, cache_key=None, device=None):
    """envelopes (N,4) wsen + query (4,) -> bool tensor (N,) on the device.
    ``cache_key``: stable identity of the envelope set (e.g. the envelope
    index's path and mtime); keeps its columns resident on the device."""
    dev = runtime.resolve_device(device)
    if len(envelopes) == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    if cache_key is not None:
        w, s, e, n, count = _resident_columns(cache_key, envelopes, dev)
    else:
        w, s, e, n, count = _upload_columns(envelopes, dev)
    return bbox_cyclic(w, s, e, n, query, count)[:count]
