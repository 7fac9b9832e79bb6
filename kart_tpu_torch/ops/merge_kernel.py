"""The 3-way merge classify: kernel K4 (``csrc/merge_classify.cu``) and its
plain PyTorch version.

Kart merges per feature because one feature is one blob at a pk-determined
path. Over the sorted union of the ancestor (a), ours (o) and theirs (t)
keys, each key's (present, oid) in every side decides it by the 3-way rule:

    o == t  -> KEEP_OURS    (same change on both sides, both absent included)
    o == a  -> TAKE_THEIRS  (only theirs changed)
    t == a  -> KEEP_OURS    (only ours changed)
    else    -> CONFLICT

The presence byte has bits a=1, o=2, t=4. K4 replaces kart_tpu's
``ops/merge_kernel.py:_merge_classify_padded_core`` (with ``_join``) and
the host union that feeds it: a key-range tiled merge join of the three
sorted sides that emits the union on the card (:func:`merge_classify_sides`;
:func:`merge_tile_plan` is its slice plan alone, held against
:func:`merge_tile_plan_plain`). :func:`merge_classify_plain` is the torch
twin of the JAX function over a given union, padding semantics included;
:func:`merge_classify_sides_plain` adds ``torch.unique`` of the keys.
Nothing here falls back: a CUDA tensor launches K4 exactly once per call or
raises, and only CPU tensors take the plain versions. On the card
:func:`merge_classify` runs the sides through K4 with one driver,
:func:`merge_classify_streamed` (kart_tpu's ``merge_classify_streamed``):
chunk by chunk of the key space under the diff's knobs (``blocks.streams``)
and otherwise in one chunk, one K4 launch a chunk.
"""

import ctypes
import time

import numpy as np
import torch

from kart_tpu_torch import runtime
from kart_tpu_torch.ops import _build
from kart_tpu_torch.ops.blocks import StreamStager, block_tensors, stage_rows, streams
from kart_tpu_torch.ops.diff_kernel import block_splits, chunk_tensors

KEEP_OURS = 0
TAKE_THEIRS = 1
CONFLICT = 2

#: rows of each side per slice of K4's plan: ``kSliceRows`` in
#: ``csrc/merge_classify.cu`` (checked against the built library when it is
#: loaded); a block takes consecutive slices of at most 1536 rows in all
SLICE_ROWS = 128

_SIGNATURES = {
    "kart_merge_classify": [
        _build.P, _build.P, _build.I64,
        _build.P, _build.P, _build.I64,
        _build.P, _build.P, _build.I64,
        _build.P, _build.P, _build.P, _build.P, _build.P, _build.I32, _build.P,
    ],
    "kart_merge_tile_plan": [
        _build.P, _build.I64, _build.P, _build.I64, _build.P, _build.I64,
        _build.P, _build.P, _build.I32, _build.P,
    ],
    "kart_merge_scratch_words": [_build.I64, _build.I64, _build.I64],
    "kart_merge_slice_rows": [],
}
_SIDE_NAMES = ("ancestor", "ours", "theirs")


def merge_classify(ancestor_block, ours_block, theirs_block, device=None, timings=None):
    """FeatureBlock x3 -> (union (U,) int64, decision (U,) int8, presence
    (U,) int8, {"conflicts", "take_theirs"}), numpy on the host. ``device``:
    None for the card (:func:`merge_classify_streamed`: one K4 launch, or
    one a chunk at north-star scale; ``timings`` collects its split),
    ``"cpu"`` for the plain version. Where the diff's backend for
    ``device`` hands the largest side's rows to the mesh, the mesh's
    ``sharded_merge_classify`` (K4 once a card), as kart_tpu routes it; it
    raises where kart_tpu's falls back to one chip."""
    from kart_tpu_torch.diff.backend import ShardedTorchBackend, select_backend

    blocks = (ancestor_block, ours_block, theirs_block)
    rows = tuple(b.count for b in blocks)
    route = select_backend(device).for_rows(max(rows))
    if isinstance(route, ShardedTorchBackend):
        from kart_tpu_torch.parallel.sharded_merge import sharded_merge_classify

        return sharded_merge_classify(*blocks, mesh=route.mesh)
    device = route.device
    if streams(device, rows):
        return merge_classify_streamed(*blocks, device, timings=timings)
    if device.type == "cuda":
        return merge_classify_streamed(*blocks, device, chunk_rows=max(rows), timings=timings)
    sides = []
    for block in blocks:
        sides.extend(block_tensors(block, device))
        sides.append(block.count)
    union, decision, presence, counts = merge_classify_sides(*sides)
    c = counts.tolist()
    return (union.cpu().numpy(), decision.cpu().numpy(), presence.cpu().numpy(),
            {"conflicts": int(c[0]), "take_theirs": int(c[1])})


def merge_classify_streamed(ancestor_block, ours_block, theirs_block, device,
                            chunk_rows=None, timings=None):
    """B6s: :func:`merge_classify` chunk by chunk of the key space
    (``diff_kernel.stream_chunk_splits`` over the three sides, chunks of
    ``chunk_rows``, default ``blocks.stream_chunk_rows``), with the same
    result: the chunks' unions, decisions and presence bytes concatenated
    in chunk order are the whole merge's, and the counts are summed.

    On the card each chunk is one K4 launch, its rows uploaded through
    pinned staging pieces on a copy stream (``blocks.StreamStager``) while
    the previous chunk's K4 runs. A chunk's counts are read back (the
    launch's one sync: its union size) only after the next chunk's upload
    and launch are enqueued; its rows then come down on the copy stream
    into a pinned landing slot sized to the union, and are copied into the
    result one chunk later still. On the CPU the chunks run
    :func:`merge_classify_sides_plain` (for the tests). ``timings``: see
    ``blocks.StreamStager``."""
    blocks = (ancestor_block, ours_block, theirs_block)
    keys, (splits, n_chunks) = block_splits(blocks, chunk_rows)
    if device.type not in ("cpu", "cuda"):
        raise runtime.DeviceUnavailable(f"merge_classify: unsupported device {device}")
    t0 = time.perf_counter()
    upper = sum(b.count for b in blocks)
    union = np.empty(upper, dtype=np.int64)
    decision = np.empty(upper, dtype=np.int8)
    presence = np.empty(upper, dtype=np.int8)
    totals = [0, 0]
    at = 0

    def land(u, d, p, c):
        """Append a chunk's rows (numpy) and counts to the result."""
        nonlocal at
        n = len(u)
        for dst, src in ((union, u), (decision, d), (presence, p)):
            stage_rows(dst[at:at + n], src)
        totals[0] += int(c[0])
        totals[1] += int(c[1])
        at += n

    def rows(c):
        return [(keys[s], b.oids, int(splits[s][c]), int(splits[s][c + 1]))
                for s, b in enumerate(blocks)]

    if device.type == "cpu":
        for c in range(n_chunks):
            args = []
            for k, o, lo, hi in rows(c):
                args += [*chunk_tensors(k, o, lo, hi, device), hi - lo]
            u, d, p, counts = merge_classify_sides_plain(*args)
            land(u.numpy(), d.numpy(), p.numpy(), counts.tolist())
    else:
        caps = [max(int(np.diff(s).max()), 1) for s in splits]
        stager = StreamStager(device, caps, timings, slots=min(n_chunks, 2))
        landing = [None] * stager.slots
        launched = downloaded = None

        def download(chunk):
            """Read a launched chunk's counts, then enqueue its rows'
            copies into its landing slot (grown to the union size, with an
            eighth to spare, when it is short)."""
            slot, outs, host_counts, done = chunk
            done.synchronize()
            c = host_counts.tolist()
            n = c[2]
            if landing[slot] is None or len(landing[slot][0]) < n:
                size = n + n // 8 + 1
                landing[slot] = (stager.pinned(size, torch.int64), stager.pinned(size, torch.int8),
                                 stager.pinned(size, torch.int8))
            pairs = [(src[:n], dst[:n]) for src, dst in zip(outs[:3], landing[slot])]
            return slot, c, stager.download(pairs, done)

        def land_slot(chunk):
            slot, c, landed = chunk
            landed.synchronize()
            with stager.clock("landing_s"):
                land(*(x[:c[2]].numpy() for x in landing[slot]), c)

        for c in range(n_chunks):
            slot = c % stager.slots
            sides = rows(c)
            dev = stager.upload(slot, sides)
            sizes = [hi - lo for _, _, lo, hi in sides]
            with stager.timed("k4_ms", stager.compute):
                outs = launch_merge_classify(dev[0], dev[1], sizes[0], dev[2], dev[3], sizes[1],
                                             dev[4], dev[5], sizes[2])
            stager.launched(slot)
            host_counts = torch.empty(3, dtype=torch.int64, pin_memory=True)
            host_counts.copy_(outs[3], non_blocking=True)
            done = torch.cuda.Event()
            done.record(stager.compute)
            if launched is not None:
                fetched = download(launched)
                if downloaded is not None:
                    land_slot(downloaded)
                downloaded = fetched
            launched = (slot, outs, host_counts, done)
        fetched = download(launched)
        if downloaded is not None:
            land_slot(downloaded)
        land_slot(fetched)
        stager.finish()
    if timings is not None:
        timings["chunks"] = n_chunks
        timings["wall_s"] = time.perf_counter() - t0
    return (union[:at], decision[:at], presence[:at],
            {"conflicts": totals[0], "take_theirs": totals[1]})


def merge_classify_sides(a_keys, a_oids, a_count, o_keys, o_oids, o_count,
                         t_keys, t_oids, t_count):
    """The 3-way classify of three key-sorted sides, each real for its first
    ``*_count`` rows; keys contiguous int64 (n,), oids contiguous int32 (n,
    5), all on one device. -> (union int64 (U,), decision int8 (U,),
    presence int8 (U,), counts int64 [conflicts, take_theirs]) on that
    device. CUDA tensors launch K4 (its union size read back: one sync);
    CPU tensors run :func:`merge_classify_sides_plain`."""
    device, _, _, _ = _checked_sides(a_keys, a_oids, a_count, o_keys, o_oids, o_count,
                                     t_keys, t_oids, t_count)
    if device.type == "cpu":
        return merge_classify_sides_plain(a_keys, a_oids, a_count, o_keys, o_oids, o_count,
                                          t_keys, t_oids, t_count)
    union, decision, presence, counts = launch_merge_classify(
        a_keys, a_oids, a_count, o_keys, o_oids, o_count, t_keys, t_oids, t_count)
    n = int(counts[2])
    return union[:n], decision[:n], presence[:n], counts[:2]


def launch_merge_classify(a_keys, a_oids, a_count, o_keys, o_oids, o_count,
                          t_keys, t_oids, t_count):
    """K4's launch alone, with no sync: -> (union, decision, presence),
    each ``a_count + o_count + t_count`` rows of which the first U are
    written, and counts int64 [conflicts, take_theirs, U], on the sides'
    CUDA device. :func:`merge_classify_sides` reads U and cuts."""
    device, keys, oids, counts = _checked_sides(a_keys, a_oids, a_count, o_keys, o_oids,
                                                o_count, t_keys, t_oids, t_count)
    if device.type != "cuda":
        raise runtime.DeviceUnavailable(f"merge_classify: K4 needs a CUDA device, not {device}")
    lib = _library(device)
    total = sum(counts)
    union = torch.empty(total, dtype=torch.int64, device=device)
    decision = torch.empty(total, dtype=torch.int8, device=device)
    presence = torch.empty(total, dtype=torch.int8, device=device)
    out_counts = torch.empty(3, dtype=torch.int64, device=device)
    scratch = torch.empty(lib.kart_merge_scratch_words(*counts), dtype=torch.int64,
                          device=device)
    args = []
    for k, o, n in zip(keys, oids, counts):
        args += [k.data_ptr() if n else None, o.data_ptr() if n else None, n]
    rc = lib.kart_merge_classify(
        *args, scratch.data_ptr(),
        union.data_ptr() if total else None, decision.data_ptr() if total else None,
        presence.data_ptr() if total else None, out_counts.data_ptr(),
        device.index, _build.stream_ptr(device),
    )
    _build.check(lib, rc, "merge classify")
    runtime.count("merge_classify_launches")
    return union, decision, presence, out_counts


def _slices(counts):
    """The slices of K4's plan for sides of ``counts`` rows: one a
    splitter, every ``SLICE_ROWS``-th row of each side (as
    ``csrc/merge_classify.cu`` counts them)."""
    return sum(-(-int(n) // SLICE_ROWS) for n in counts)


def merge_classify_sides_plain(a_keys, a_oids, a_count, o_keys, o_oids, o_count,
                               t_keys, t_oids, t_count):
    """Plain version of :func:`merge_classify_sides` on any device: the
    union by ``torch.unique`` of the real keys, then
    :func:`merge_classify_plain`. -> (union, decision, presence, counts)."""
    union = torch.unique(torch.cat([a_keys[: int(a_count)], o_keys[: int(o_count)],
                                    t_keys[: int(t_count)]]))
    decision, presence, counts = merge_classify_plain(
        a_keys, a_oids, a_count, o_keys, o_oids, o_count, t_keys, t_oids, t_count,
        union, len(union))
    return union, decision, presence, counts


def merge_tile_plan(a_keys, a_count, o_keys, o_count, t_keys, t_count):
    """K4's slice plan alone, for checks: int64 (slices + 1, 3), row k the
    first row of each side in slice k and the last row the counts. CUDA
    tensors run K4's plan kernel; CPU tensors run
    :func:`merge_tile_plan_plain`. The main path never calls this:
    :func:`launch_merge_classify` plans inside its launch."""
    keys = (a_keys, o_keys, t_keys)
    counts = [int(c) for c in (a_count, o_count, t_count)]
    for k, n, name in zip(keys, counts, _SIDE_NAMES):
        _check_keys(k, n, name)
    device = a_keys.device
    if any(k.device != device for k in keys):
        raise ValueError("merge_tile_plan: tensors on more than one device")
    if device.type == "cpu":
        return merge_tile_plan_plain(*(k[:n] for k, n in zip(keys, counts)))
    if device.type != "cuda":
        raise runtime.DeviceUnavailable(f"merge_tile_plan: unsupported device {device}")
    lib = _library(device)
    plan = torch.empty((_slices(counts) + 1, 3), dtype=torch.int64, device=device)
    scratch = torch.empty(lib.kart_merge_scratch_words(*counts), dtype=torch.int64,
                          device=device)
    args = []
    for k, n in zip(keys, counts):
        args += [k.data_ptr() if n else None, n]
    rc = lib.kart_merge_tile_plan(*args, scratch.data_ptr(), plan.data_ptr(),
                                  device.index, _build.stream_ptr(device))
    _build.check(lib, rc, "merge tile plan")
    return plan


def merge_tile_plan_plain(a_keys, o_keys, t_keys, tile=SLICE_ROWS):
    """Plain K4 slice plan over count-sliced sorted keys: the splitters are
    every ``tile``-th key of each side, in key order with equal keys ordered
    a, o, t; slice k starts at each side's lower bound of splitter k and
    ends where slice k + 1 starts (the last at the counts), so it holds at
    most ``tile`` rows of each side. -> int64 (slices + 1, 3)."""
    sides = (a_keys, o_keys, t_keys)
    splitters, _ = torch.sort(torch.cat([k[::tile] for k in sides]), stable=True)
    plan = torch.stack([torch.searchsorted(k, splitters) for k in sides], dim=1)
    end = torch.tensor([[len(k) for k in sides]], dtype=torch.int64, device=a_keys.device)
    return torch.cat([plan, end])


def merge_classify_padded(a_keys, a_oids, a_count, o_keys, o_oids, o_count,
                          t_keys, t_oids, t_count, union_keys, union_count):
    """Classify the first ``union_count`` of a given ``union_keys`` against
    three key-sorted sides, each real for its first ``*_count`` rows, on
    the CPU: :func:`merge_classify_plain`, the twin of kart_tpu's
    ``_merge_classify_padded``. -> (decision int8 (U,), presence int8 (U,),
    counts int64 [conflicts, take_theirs]); rows past ``union_count`` get
    decision 0. The card builds its own union: on a CUDA tensor this raises
    (call :func:`merge_classify_sides`)."""
    device, _, _, _ = _checked_sides(a_keys, a_oids, a_count, o_keys, o_oids, o_count,
                                     t_keys, t_oids, t_count)
    union_count = int(union_count)
    if (union_keys.dtype != torch.int64 or union_keys.dim() != 1
            or not union_keys.is_contiguous()):
        raise ValueError("merge_classify: union keys must be contiguous int64 (n,)")
    if not 0 <= union_count <= len(union_keys):
        raise ValueError(f"merge_classify: union count {union_count} out of range")
    if union_keys.device != device:
        raise ValueError(f"merge_classify: tensors on {device} and {union_keys.device}")
    if device.type != "cpu":
        raise runtime.DeviceUnavailable(
            f"merge_classify_padded runs on the CPU only, not {device}: the card's K4 builds "
            "its own union (merge_classify_sides)")
    return merge_classify_plain(a_keys, a_oids, a_count, o_keys, o_oids, o_count,
                                t_keys, t_oids, t_count, union_keys, union_count)


def _check_keys(keys, count, name):
    if keys.dtype != torch.int64 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError(f"merge_classify: {name} keys must be contiguous int64 (n,)")
    if not 0 <= count <= len(keys):
        raise ValueError(f"merge_classify: {name} count {count} out of range")


def _checked_sides(a_keys, a_oids, a_count, o_keys, o_oids, o_count, t_keys, t_oids, t_count):
    """Check three sides. -> (their device, keys, oids, counts as ints)."""
    keys, oids = (a_keys, o_keys, t_keys), (a_oids, o_oids, t_oids)
    counts = tuple(int(c) for c in (a_count, o_count, t_count))
    device = a_keys.device
    for k, o, n, name in zip(keys, oids, counts, _SIDE_NAMES):
        _check_keys(k, n, name)
        if (o.dtype != torch.int32 or o.dim() != 2 or o.shape[1] != 5
                or not o.is_contiguous()):
            raise ValueError(f"merge_classify: {name} oids must be contiguous int32 (n, 5)")
        if n > len(o):
            raise ValueError(f"merge_classify: {name} count {n} out of range")
        if k.device != device or o.device != device:
            raise ValueError(f"merge_classify: tensors on {device} and {k.device}")
    if device.type not in ("cpu", "cuda"):
        raise runtime.DeviceUnavailable(f"merge_classify: unsupported device {device}")
    return device, keys, oids, counts


def _library(device):
    lib = _build.load_library("merge_classify", device, _SIGNATURES)
    lib.kart_merge_scratch_words.restype = ctypes.c_int64
    if lib.kart_merge_slice_rows() != SLICE_ROWS:
        raise _build.BuildError(
            f"merge_classify.cu slices {lib.kart_merge_slice_rows()} rows, "
            f"SLICE_ROWS is {SLICE_ROWS}"
        )
    return lib


def _join(keys, oids, count, union_keys):
    """-> (present bool (U,), oid int32 (U, 5), zero where absent) of each
    union key in the first ``count`` rows of a key-sorted side."""
    n_u = len(union_keys)
    if count == 0:
        return (torch.zeros(n_u, dtype=torch.bool, device=union_keys.device),
                torch.zeros((n_u, 5), dtype=torch.int32, device=union_keys.device))
    keys, oids = keys[:count], oids[:count]
    idx = torch.searchsorted(keys, union_keys)
    idxc = idx.clamp(max=count - 1)
    present = (keys[idxc] == union_keys) & (idx < count)
    return present, torch.where(present[:, None], oids[idxc], 0)


def merge_classify_plain(a_keys, a_oids, a_count, o_keys, o_oids, o_count,
                         t_keys, t_oids, t_count, union_keys, union_count):
    """Plain PyTorch version of K4 on any device: three ``searchsorted``
    joins, the 3-way rule and the presence bits, in the shape of kart_tpu's
    ``_merge_classify_padded_core``. -> (decision int8, presence int8,
    counts int64 [conflicts, take_theirs])."""
    a_pres, a_oid = _join(a_keys, a_oids, int(a_count), union_keys)
    o_pres, o_oid = _join(o_keys, o_oids, int(o_count), union_keys)
    t_pres, t_oid = _join(t_keys, t_oids, int(t_count), union_keys)

    def same(p1, oid1, p2, oid2):
        return (~p1 & ~p2) | (p1 & p2 & (oid1 == oid2).all(dim=1))

    o_eq_t = same(o_pres, o_oid, t_pres, t_oid)
    o_eq_a = same(o_pres, o_oid, a_pres, a_oid)
    t_eq_a = same(t_pres, t_oid, a_pres, a_oid)
    decision = torch.where(
        o_eq_t, KEEP_OURS,
        torch.where(o_eq_a, TAKE_THEIRS, torch.where(t_eq_a, KEEP_OURS, CONFLICT)),
    )
    valid = torch.arange(len(union_keys), device=union_keys.device) < int(union_count)
    decision = torch.where(valid, decision, KEEP_OURS).to(torch.int8)
    presence = (a_pres.to(torch.int8) + 2 * o_pres.to(torch.int8)
                + 4 * t_pres.to(torch.int8))
    counts = torch.stack([(decision == CONFLICT).sum(),
                          (decision == TAKE_THEIRS).sum()]).to(torch.int64)
    return decision, presence, counts
