"""The 3-way merge classify: kernel K4 (``csrc/merge_classify.cu``) and its
plain PyTorch version.

Kart merges per feature because one feature is one blob at a pk-determined
path. Over the sorted union of the ancestor (a), ours (o) and theirs (t)
keys, three searchsorted joins give each key its (present, oid) triple and
the 3-way rule decides it at once:

    o == t  -> KEEP_OURS    (same change on both sides, both absent included)
    o == a  -> TAKE_THEIRS  (only theirs changed)
    t == a  -> KEEP_OURS    (only ours changed)
    else    -> CONFLICT

The presence byte has bits a=1, o=2, t=4. K4 replaces kart_tpu's
``ops/merge_kernel.py:_merge_classify_padded_core`` (with ``_join``):
one thread per union key, three binary searches, the counts reduced on the
card. :func:`merge_classify_plain` is the torch twin of that JAX function,
padding semantics included. The union is built on the host with numpy, as
kart_tpu builds it. Nothing here falls back: a CUDA device launches K4
exactly once per call or raises, and only CPU tensors take the plain
version.
"""

import numpy as np
import torch

from kart_tpu_torch import runtime
from kart_tpu_torch.ops import _build
from kart_tpu_torch.ops.blocks import block_tensors, to_device

KEEP_OURS = 0
TAKE_THEIRS = 1
CONFLICT = 2

_SIGNATURES = {
    "kart_merge_classify": [
        _build.P, _build.P, _build.I64,
        _build.P, _build.P, _build.I64,
        _build.P, _build.P, _build.I64,
        _build.P, _build.I64, _build.I64,
        _build.P, _build.P, _build.P, _build.I32, _build.P,
    ],
}


def merge_classify(ancestor_block, ours_block, theirs_block, device=None):
    """FeatureBlock x3 -> (union (U,) int64, decision (U,) int8, presence
    (U,) int8, {"conflicts", "take_theirs"}), numpy on the host. ``device``:
    None for the card (one K4 launch), ``"cpu"`` for the plain version."""
    device = runtime.resolve_device(device)
    blocks = (ancestor_block, ours_block, theirs_block)
    union = merge_union(*blocks)
    sides = []
    for block in blocks:
        sides.extend(block_tensors(block, device))
        sides.append(block.count)
    union_t = to_device(union, device)
    decision, presence, counts = merge_classify_padded(*sides, union_t, len(union))
    c = counts.tolist()
    return (union, decision.cpu().numpy(), presence.cpu().numpy(),
            {"conflicts": int(c[0]), "take_theirs": int(c[1])})


def merge_union(*blocks):
    """The sorted, deduplicated union of the blocks' real keys (int64)."""
    return np.unique(np.concatenate(
        [np.asarray(b.keys[: b.count], dtype=np.int64) for b in blocks]))


def merge_classify_padded(a_keys, a_oids, a_count, o_keys, o_oids, o_count,
                          t_keys, t_oids, t_count, union_keys, union_count):
    """Classify the first ``union_count`` of ``union_keys`` against three
    key-sorted sides, each real for its first ``*_count`` rows. Keys are
    contiguous int64 (n,), oids contiguous int32 (n, 5), all on one device.
    -> (decision int8 (U,), presence int8 (U,), counts int64 [conflicts,
    take_theirs]) on that device; rows past ``union_count`` get decision 0.
    CUDA tensors launch K4; CPU tensors run :func:`merge_classify_plain`."""
    sides = ((a_keys, a_oids, int(a_count), "ancestor"), (o_keys, o_oids, int(o_count), "ours"),
             (t_keys, t_oids, int(t_count), "theirs"))
    for keys, oids, count, name in sides:
        _check_side(keys, oids, count, name)
    union_count = int(union_count)
    if (union_keys.dtype != torch.int64 or union_keys.dim() != 1
            or not union_keys.is_contiguous()):
        raise ValueError("merge_classify: union keys must be contiguous int64 (n,)")
    if not 0 <= union_count <= len(union_keys):
        raise ValueError(f"merge_classify: union count {union_count} out of range")
    device = union_keys.device
    for keys, oids, _, _ in sides:
        if keys.device != device or oids.device != device:
            raise ValueError(f"merge_classify: tensors on {device} and {keys.device}")
    if device.type == "cpu":
        return merge_classify_plain(a_keys, a_oids, a_count, o_keys, o_oids, o_count,
                                    t_keys, t_oids, t_count, union_keys, union_count)
    if device.type != "cuda":
        raise runtime.DeviceUnavailable(f"merge_classify: unsupported device {device}")
    return _merge_classify_cuda(sides, union_keys, union_count)


def _check_side(keys, oids, count, name):
    if keys.dtype != torch.int64 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError(f"merge_classify: {name} keys must be contiguous int64 (n,)")
    if (oids.dtype != torch.int32 or oids.dim() != 2 or oids.shape[1] != 5
            or not oids.is_contiguous()):
        raise ValueError(f"merge_classify: {name} oids must be contiguous int32 (n, 5)")
    if not 0 <= count <= min(len(keys), len(oids)):
        raise ValueError(f"merge_classify: {name} count {count} out of range")


def _library(device):
    return _build.load_library("merge_classify", device, _SIGNATURES)


def _merge_classify_cuda(sides, union_keys, union_count):
    device = union_keys.device
    n = len(union_keys)
    decision = torch.empty(n, dtype=torch.int8, device=device)
    presence = torch.empty(n, dtype=torch.int8, device=device)
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    args = []
    for keys, oids, count, _ in sides:
        args += [keys.data_ptr() if count else None, oids.data_ptr() if count else None, count]
    lib = _library(device)
    rc = lib.kart_merge_classify(
        *args, union_keys.data_ptr() if n else None, n, union_count,
        decision.data_ptr() if n else None, presence.data_ptr() if n else None,
        counts.data_ptr(), device.index, _build.stream_ptr(device),
    )
    _build.check(lib, rc, "merge classify")
    runtime.count("merge_classify_launches")
    return decision, presence, counts


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
