"""Diff classification: kernel K1 (``csrc/classify.cu``) and its plain
PyTorch version.

Given two key-sorted blocks (unique keys per side), every row of both
sides gets a class:

    0 = unchanged, 1 = insert, 2 = update, 3 = delete

plus the device-reduced counts ``[inserts, updates, deletes]``. K1 replaces
kart_tpu's TPU sort join (``ops/diff_kernel.py:_classify_mergesort_core``
with ``_fold_oids``): the sidecar already delivers both sides sorted, so
the card needs no sort, only a merge-path co-rank join that compares full
160-bit oids. The merged order is cut into tiles of :data:`TILE_ROWS`
rows; :func:`tile_coranks` is the partition alone, held against
:func:`tile_coranks_plain`. The plain classify is the ``searchsorted``
join in the shape of ``_classify_binsearch_core``/``classify_blocks_reference``.
"""

import numpy as np
import torch

from kart_tpu_torch import runtime
from kart_tpu_torch.ops import _build
from kart_tpu_torch.ops.blocks import block_tensors, unpack_oid_hex

UNCHANGED = 0
INSERT = 1
UPDATE = 2
DELETE = 3

#: merged rows per K1 tile: ``kTile`` in ``csrc/classify.cu`` (checked
#: against the built library when it is loaded)
TILE_ROWS = 1024

_SIGNATURES = {
    "kart_classify": [
        _build.P, _build.P, _build.I64, _build.P, _build.P, _build.I64,
        _build.P, _build.P, _build.P, _build.P, _build.I32, _build.P,
    ],
    "kart_classify_coranks": [
        _build.P, _build.I64, _build.P, _build.I64, _build.P, _build.I32, _build.P,
    ],
    "kart_classify_tile_rows": [],
}


def classify(old_keys, old_oids, new_keys, new_oids, old_count=None,
             new_count=None, *, counts_only=False):
    """Join two key-sorted sides. ``*_keys`` int64 (n,), ``*_oids`` int32
    (n, 5), all on one device; only the first ``*_count`` rows (default:
    all) are real. -> (old_class int8 (old_count,) or None, new_class int8
    (new_count,) or None, counts int64 (3,)), on that device. CUDA tensors
    run K1; CPU tensors run :func:`classify_plain`."""
    old_count = len(old_keys) if old_count is None else int(old_count)
    new_count = len(new_keys) if new_count is None else int(new_count)
    _check_side(old_keys, old_oids, old_count, "old")
    _check_side(new_keys, new_oids, new_count, "new")
    device = old_keys.device
    for t in (old_oids, new_keys, new_oids):
        if t.device != device:
            raise ValueError(f"classify: tensors on {device} and {t.device}")
    if device.type == "cpu":
        old_class, new_class, counts = classify_plain(
            old_keys[:old_count], old_oids[:old_count],
            new_keys[:new_count], new_oids[:new_count],
        )
        if counts_only:
            return None, None, counts
        return old_class, new_class, counts
    if device.type != "cuda":
        raise runtime.DeviceUnavailable(f"classify: unsupported device {device}")
    return _classify_cuda(old_keys, old_oids, old_count, new_keys, new_oids,
                          new_count, counts_only)


def _check_keys(keys, count, side, what="classify"):
    if keys.dtype != torch.int64 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError(f"{what}: {side} keys must be contiguous int64 (n,)")
    if not 0 <= count <= len(keys):
        raise ValueError(f"{what}: {side} count {count} out of range")


def _check_side(keys, oids, count, side):
    _check_keys(keys, count, side)
    if (oids.dtype != torch.int32 or oids.dim() != 2 or oids.shape[1] != 5
            or not oids.is_contiguous()):
        raise ValueError(f"classify: {side} oids must be contiguous int32 (n, 5)")
    if count > len(oids):
        raise ValueError(f"classify: {side} count {count} out of range")


def _library(device):
    lib = _build.load_library("classify", device, _SIGNATURES)
    if lib.kart_classify_tile_rows() != TILE_ROWS:
        raise _build.BuildError(
            f"classify.cu tiles {lib.kart_classify_tile_rows()} rows, "
            f"TILE_ROWS is {TILE_ROWS}"
        )
    return lib


def _n_tiles(total):
    return -(-total // TILE_ROWS)


def _classify_cuda(old_keys, old_oids, n_old, new_keys, new_oids, n_new,
                   counts_only):
    device = old_keys.device
    counts = torch.zeros(3, dtype=torch.int64, device=device)
    old_class = new_class = None
    if not counts_only:
        old_class = torch.empty(n_old, dtype=torch.int8, device=device)
        new_class = torch.empty(n_new, dtype=torch.int8, device=device)
    total = n_old + n_new
    if total == 0:
        return old_class, new_class, counts
    lib = _library(device)
    coranks = torch.empty(_n_tiles(total) + 1, dtype=torch.int64, device=device)
    rc = lib.kart_classify(
        old_keys.data_ptr(), old_oids.data_ptr(), n_old,
        new_keys.data_ptr(), new_oids.data_ptr(), n_new,
        coranks.data_ptr(),
        old_class.data_ptr() if old_class is not None else None,
        new_class.data_ptr() if new_class is not None else None,
        counts.data_ptr(), device.index, _build.stream_ptr(device),
    )
    _build.check(lib, rc, "classify")
    runtime.count("classify_launches")
    if counts_only:
        runtime.count("classify_counts_only_launches")
    return old_class, new_class, counts


def tile_coranks(old_keys, new_keys, old_count=None, new_count=None):
    """K1's partition alone, for checks: the co-rank of every tile boundary
    over the first ``*_count`` keys (default: all). CUDA tensors run K1's
    partition kernel; CPU tensors run :func:`tile_coranks_plain`. The main
    path never calls this: :func:`classify` launches the partition itself."""
    old_count = len(old_keys) if old_count is None else int(old_count)
    new_count = len(new_keys) if new_count is None else int(new_count)
    _check_keys(old_keys, old_count, "old", "tile_coranks")
    _check_keys(new_keys, new_count, "new", "tile_coranks")
    device = old_keys.device
    if new_keys.device != device:
        raise ValueError(f"tile_coranks: tensors on {device} and {new_keys.device}")
    if device.type == "cpu":
        return tile_coranks_plain(old_keys[:old_count], new_keys[:new_count])
    if device.type != "cuda":
        raise runtime.DeviceUnavailable(f"tile_coranks: unsupported device {device}")
    total = old_count + new_count
    out = torch.zeros(_n_tiles(total) + 1, dtype=torch.int64, device=device)
    if total:
        lib = _library(device)
        rc = lib.kart_classify_coranks(
            old_keys.data_ptr(), old_count, new_keys.data_ptr(), new_count,
            out.data_ptr(), device.index, _build.stream_ptr(device),
        )
        _build.check(lib, rc, "classify co-ranks")
    return out


def tile_coranks_plain(old_keys, new_keys, tile=TILE_ROWS):
    """Plain PyTorch partition over count-sliced sorted keys: for each tile
    boundary ``d = t * tile`` (t = 0 .. ceil(total / tile), clamped to the
    total), the number of old rows among the first ``d`` rows of the merged
    order (by key, old before new on equal keys). -> int64 (tiles + 1,)."""
    n_old, total = len(old_keys), len(old_keys) + len(new_keys)
    device = old_keys.device
    d = (torch.arange(-(-total // tile) + 1, device=device) * tile).clamp(max=total)
    # an old row's merged position: its index plus the new rows below its key
    pos = torch.arange(n_old, device=device) + torch.searchsorted(new_keys, old_keys)
    return torch.searchsorted(pos, d)


def classify_plain(old_keys, old_oids, new_keys, new_oids):
    """Plain PyTorch classify over count-sliced sides (any device): two
    ``searchsorted`` joins with full-oid compares. -> (old_class int8,
    new_class int8, counts int64 (3,))."""
    old_class = _join_side(old_keys, old_oids, new_keys, new_oids, DELETE)
    new_class = _join_side(new_keys, new_oids, old_keys, old_oids, INSERT)
    counts = torch.stack([
        (new_class == INSERT).sum(),
        (old_class == UPDATE).sum(),
        (old_class == DELETE).sum(),
    ]).to(torch.int64)
    return old_class, new_class, counts


def _join_side(keys, oids, other_keys, other_oids, missing):
    n_other = len(other_keys)
    if n_other == 0:
        return torch.full((len(keys),), missing, dtype=torch.int8, device=keys.device)
    idx = torch.searchsorted(other_keys, keys)
    idxc = idx.clamp(max=n_other - 1)
    found = (other_keys[idxc] == keys) & (idx < n_other)
    same = (oids == other_oids[idxc]).all(dim=1)
    cls = torch.where(
        found,
        torch.where(same, UNCHANGED, UPDATE),
        torch.full_like(idx, missing),
    )
    return cls.to(torch.int8)


def classify_blocks(old_block, new_block, device, *, counts_only=False):
    """FeatureBlock x2 -> (old_class, new_class, counts) on ``device``
    (a resolved torch.device), uploading the count-sliced columns."""
    ok, oo = block_tensors(old_block, device)
    nk, no = block_tensors(new_block, device)
    return classify(ok, oo, nk, no, counts_only=counts_only)


def counts_dict(counts):
    c = counts.tolist()
    return {"inserts": int(c[0]), "updates": int(c[1]), "deletes": int(c[2])}


def changed_indices(old_class, new_class):
    """-> (old_changed_idx, new_changed_idx) int64 numpy: the rows whose
    values need materialising (everything except UNCHANGED)."""
    return (
        torch.nonzero(old_class != UNCHANGED).flatten().cpu().numpy(),
        torch.nonzero(new_class != UNCHANGED).flatten().cpu().numpy(),
    )


def changed_oid_hex(block, idx):
    """Oid hexes of block rows ``idx`` (host side, from the block's own
    arrays)."""
    return unpack_oid_hex(np.asarray(block.oids[idx])) if len(idx) else []
