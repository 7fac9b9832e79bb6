"""Mesh-sharded 3-way merge classify (B7): kart_tpu's
``parallel/sharded_merge.py``.

The same key-modulus partition as the sharded diff
(:func:`~kart_tpu_torch.parallel.sharded_diff.partition_block`): a key
lands on the same shard in all three revisions, so every per-key decision
is local to its shard. K4 runs once a shard on the shard's device and
builds that shard's union itself (kart_tpu computes the shard unions on
the host); the shards' unions, decisions and presence bytes are then
concatenated and put in global union order by one stable argsort, and the
counts are summed. The result is ``merge_classify``'s, bit for bit. A
failed launch or copy on any shard raises; nothing falls back to one card.
"""

import numpy as np

from kart_tpu_torch.ops.merge_kernel import launch_merge_classify, merge_classify_sides_plain
from kart_tpu_torch.parallel.mesh import HostCopies, on
from kart_tpu_torch.parallel.sharded_diff import STATS, _repad, partition_block, shard_tensors


def sharded_merge_classify(ancestor_block, ours_block, theirs_block, mesh):
    """The mesh's drop-in for ``ops.merge_kernel.merge_classify`` over
    ``mesh`` (a list of devices): -> (union (U,) int64, decision (U,) int8,
    presence (U,) int8, {conflicts, take_theirs}), numpy, in global
    sorted-union order. On a card K4 is launched once a shard, every
    shard's launch enqueued before any union size is read; on the CPU each
    shard runs K4's plain version."""
    mesh = list(mesh)
    n_shards = len(mesh)
    parts = [partition_block(b, n_shards) for b in (ancestor_block, ours_block, theirs_block)]
    bucket = max(p[0].shape[1] for p in parts)
    parts = [_repad(p, bucket) for p in parts]

    launched = []
    for s, device in enumerate(mesh):
        with on(device):
            args = []
            for p in parts:
                args += [*shard_tensors(p, s, device), int(p[2][s])]
            if device.type == "cuda":
                launched.append(launch_merge_classify(*args))
            else:
                union, decision, presence, counts = merge_classify_sides_plain(*args)
                launched.append((union, decision, presence,
                                 counts.new_tensor([int(counts[0]), int(counts[1]),
                                                    len(union)])))
    copies = HostCopies()
    for out in launched:
        copies.add(out[3])
    sizes = copies.arrays()
    copies = HostCopies()
    for out, c in zip(launched, sizes):
        for t in out[:3]:
            copies.add(t[: int(c[2])])
    rows = copies.arrays()
    STATS["sharded_merge_calls"] += 1

    union_cat = np.concatenate(rows[0::3]) if rows else np.zeros(0, np.int64)
    order = np.argsort(union_cat, kind="stable")
    decision = np.concatenate(rows[1::3])[order]
    presence = np.concatenate(rows[2::3])[order]
    return (union_cat[order], decision, presence,
            {"conflicts": int(sum(int(c[0]) for c in sizes)),
             "take_theirs": int(sum(int(c[1]) for c in sizes))})
