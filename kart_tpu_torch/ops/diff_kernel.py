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

On the card, blocks go up through one driver,
:func:`classify_blocks_streamed` (kart_tpu's ``classify_blocks_streamed``):
it cuts the key space into chunks (:func:`stream_chunk_splits`) and runs K1
a chunk, the next chunk's staging and upload overlapping the current one's
launch. :func:`classify_blocks` gives it chunks of
``KART_TORCH_STREAM_CHUNK_ROWS`` when the larger side has
``KART_TORCH_STREAM_MIN_ROWS`` rows or more, or when the sides would fill
more than half of the card's free memory (``blocks.streams``), and
otherwise one chunk; both knobs are read at call time. Over several
devices (a mesh, B3 and B8) the same driver deals the chunks out in turn,
at least one a device.
:func:`columnar_equal` is kart_tpu's row equality over attribute columns
with null masks, as a torch op.
"""

import time

import numpy as np
import torch

from kart_tpu_torch import runtime
from kart_tpu_torch.ops import _build
from kart_tpu_torch.ops.blocks import (
    StreamStager,
    block_tensors,
    stream_chunk_rows,
    streams,
    to_device,
    unpack_oid_hex,
)

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


def classify_blocks(old_block, new_block, device, *, counts_only=False, timings=None):
    """FeatureBlock x2 -> (old_class, new_class, counts) on ``device`` (a
    resolved torch.device). On the card every call is
    :func:`classify_blocks_streamed`, in chunks when ``blocks.streams``
    says so and otherwise in one (one K1 launch); its classes and counts
    come back on the host, and ``timings`` collects its split. Elsewhere
    the count-sliced columns go to ``device`` and :func:`classify` runs
    there."""
    rows = (old_block.count, new_block.count)
    if streams(device, rows):
        return classify_blocks_streamed(old_block, new_block, device,
                                        counts_only=counts_only, timings=timings)
    if device.type == "cuda":
        return classify_blocks_streamed(old_block, new_block, device, chunk_rows=max(rows),
                                        counts_only=counts_only, timings=timings)
    ok, oo = block_tensors(old_block, device)
    nk, no = block_tensors(new_block, device)
    return classify(ok, oo, nk, no, counts_only=counts_only)


# --- the card's driver ----------------------------------------------------------------------

def stream_chunk_splits(key_arrays, chunk_rows):
    """Key-space chunking for the streamed routes (a copy of kart_tpu's
    ``stream_chunk_splits``): sorted key arrays (one per side) -> (per-side
    split-point arrays, n_chunks), where chunk c of side s is rows
    ``splits[s][c]:splits[s][c+1]``. A key falls in the same chunk on every
    side, so merge-joins stay chunk-local. Boundaries balance the combined
    population: candidate keys are fine-grained quantiles of each side, and
    each target combined rank picks the nearest candidate."""
    chunk_rows = max(int(chunk_rows), 1)
    n_chunks = max(1, -(-max(len(k) for k in key_arrays) // chunk_rows))
    total = sum(len(k) for k in key_arrays)

    def _quantile_keys(keys, m):
        if not len(keys) or m <= 0:
            return keys[:0]
        return keys[(np.arange(1, m) * len(keys)) // m]

    cand = np.unique(
        np.concatenate([_quantile_keys(k, 4 * n_chunks) for k in key_arrays])
    )
    if len(cand):
        ranks = sum(np.searchsorted(k, cand) for k in key_arrays)
        targets = (np.arange(1, n_chunks) * total) // n_chunks
        picks = np.searchsorted(ranks, targets)
        bounds = np.unique(cand[np.minimum(picks, len(cand) - 1)])
    else:
        bounds = cand
    splits = tuple(
        np.concatenate(([0], np.searchsorted(k, bounds), [len(k)]))
        for k in key_arrays
    )
    return splits, len(bounds) + 1


def block_splits(blocks, chunk_rows=None):
    """-> (the blocks' real keys, their :func:`stream_chunk_splits`) at
    ``chunk_rows`` (default :func:`stream_chunk_rows`)."""
    keys = tuple(np.asarray(b.keys[: b.count]) for b in blocks)
    return keys, stream_chunk_splits(keys, stream_chunk_rows() if chunk_rows is None
                                     else chunk_rows)


def mesh_chunk_rows(side_rows, n_devices):
    """The default chunk of a classify over ``n_devices`` devices:
    :func:`stream_chunk_rows`, cut to a ``1 / n_devices`` share of the
    larger side so that every device gets a chunk (kart_tpu's B8 grows its
    slices until at most one a device remains; B3 deals its batches out the
    same way)."""
    return min(stream_chunk_rows(), max(-(-max(side_rows) // n_devices), 1))


def classify_blocks_streamed(old_block, new_block, device, chunk_rows=None,
                             counts_only=False, timings=None, mesh=None):
    """B1s: the classify of two blocks chunk by chunk of the key space, in
    chunks of ``chunk_rows`` (default ``blocks.stream_chunk_rows``).
    -> (old_class int8 (n_old,) or None, new_class int8 (n_new,) or None,
    counts int64 (3,)), CPU tensors.

    On the card each chunk is one K1 launch: the chunk's rows go up from
    the blocks' arrays through two pinned staging pieces on a copy stream
    (``blocks.StreamStager``; two device slots, or one for a single chunk)
    while the previous chunk's K1 runs; the classes come back into pinned
    host memory on the copy stream, enqueued after the next chunk's
    upload; the counts are summed on the card and read once. On the CPU the same chunks run
    :func:`classify_plain` (for the tests; no command takes it).

    ``mesh`` (a list of devices of ``device``'s type, ``device`` first) is
    several devices (B3 and B8, kart_tpu's ``classify_blocks_batched`` and
    ``sampled_counts_pmapped``): chunk c runs on ``mesh[c % S]``, through
    that entry's own stager and streams, the counts are summed on
    ``device``, and the default chunk is :func:`mesh_chunk_rows`. A failed
    launch or copy on any entry raises (kart_tpu's backend falls back to
    the host there; the port does not)."""
    n_old, n_new = old_block.count, new_block.count
    mesh = [device] if mesh is None else list(mesh)
    if mesh[0] != device or any(d.type != device.type for d in mesh):
        raise ValueError(f"classify: mesh {mesh} does not start at {device}")
    if chunk_rows is None and len(mesh) > 1:
        chunk_rows = mesh_chunk_rows((n_old, n_new), len(mesh))
    (old_keys, new_keys), ((o_split, n_split), n_chunks) = block_splits(
        (old_block, new_block), chunk_rows)
    if device.type not in ("cpu", "cuda"):
        raise runtime.DeviceUnavailable(f"classify: unsupported device {device}")
    if device.type == "cpu":
        if timings is not None:
            timings["chunks"] = n_chunks
        return _classify_streamed_plain(old_block, new_block, o_split, n_split, n_chunks,
                                        counts_only)
    t0 = time.perf_counter()
    n_dev = len(mesh)
    stagers = []
    for s, dev in enumerate(mesh[:n_chunks]):
        caps = [max(int(np.diff(split)[s::n_dev].max()), 1) for split in (o_split, n_split)]
        with torch.cuda.device(dev):
            stagers.append(StreamStager(dev, caps, timings,
                                        slots=min(len(range(s, n_chunks, n_dev)), 2)))
    out = None
    if not counts_only:
        out = (stagers[0].pinned(n_old, torch.int8), stagers[0].pinned(n_new, torch.int8))
    total = torch.zeros(3, dtype=torch.int64, device=device)
    pending = None
    for c in range(n_chunks):
        dev, stager = mesh[c % n_dev], stagers[c % n_dev]
        slot = (c // n_dev) % stager.slots
        with torch.cuda.device(dev):
            ok, oo, nk, no = stager.upload(slot, (
                (old_keys, old_block.oids, int(o_split[c]), int(o_split[c + 1])),
                (new_keys, new_block.oids, int(n_split[c]), int(n_split[c + 1]))))
            with stager.timed("k1_ms", stager.compute):
                oc, nc, counts = classify(ok, oo, nk, no, counts_only=counts_only)
            total += counts.to(device)
            stager.launched(slot)
            if pending is not None:
                pending[0].download(*pending[1:])
                pending = None
            if not counts_only:
                done = torch.cuda.Event()
                done.record(stager.compute)
                pending = (stager, [(cls, dst[int(split[c]):int(split[c + 1])])
                                    for cls, dst, split in zip((oc, nc), out, (o_split, n_split))],
                           done)
    if pending is not None:
        pending[0].download(*pending[1:])
    counts = total.cpu()
    for stager in stagers:
        stager.finish()
    stagers[0].add("chunks", n_chunks)
    stagers[0].add("wall_s", time.perf_counter() - t0)
    if counts_only:
        return None, None, counts
    return out[0], out[1], counts


def _classify_streamed_plain(old_block, new_block, o_split, n_split, n_chunks, counts_only):
    cpu = torch.device("cpu")
    old_class = torch.empty(old_block.count, dtype=torch.int8, device=cpu)
    new_class = torch.empty(new_block.count, dtype=torch.int8, device=cpu)
    total = torch.zeros(3, dtype=torch.int64, device=cpu)
    for c in range(n_chunks):
        sides = []
        for block, split in ((old_block, o_split), (new_block, n_split)):
            sides.append(chunk_tensors(block.keys, block.oids, int(split[c]),
                                       int(split[c + 1]), cpu))
        oc, nc, counts = classify_plain(*sides[0], *sides[1])
        old_class[int(o_split[c]):int(o_split[c + 1])] = oc
        new_class[int(n_split[c]):int(n_split[c + 1])] = nc
        total += counts
    if counts_only:
        return None, None, total
    return old_class, new_class, total


def chunk_tensors(keys, oids, lo, hi, device):
    """-> (keys int64, oids int32 (n, 5)) of a side's rows ``lo:hi`` on
    ``device``."""
    return (to_device(np.asarray(keys[lo:hi], dtype=np.int64), device),
            to_device(np.asarray(oids[lo:hi]).reshape(hi - lo, 5), device, dtype=np.int32))


# --- B12 ---------------------------------------------------------------------------

def columnar_equal(old_cols, new_cols, null_mask_old, null_mask_new):
    """Row equality over aligned (C, N) attribute columns with (C, N) null
    masks, on their device: a row is equal when every column is equal and
    the null pattern is the same (two nulls with different payloads are
    unequal), as kart_tpu's ``columnar_equal``. -> bool (N,)."""
    return ((old_cols == new_cols) & (null_mask_old == null_mask_new)).all(dim=0)


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
