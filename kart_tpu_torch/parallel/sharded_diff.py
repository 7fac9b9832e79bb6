"""The key-modulus partition and the mesh's routing rule: kart_tpu's
``parallel/sharded_diff.py``.

Blocks are partitioned on the host by ``key % n_shards`` (numpy: torch has
no uint64 remainder, and keys run up to 2^63), so a feature lands on the
same shard in every revision and each shard's join is local to it: the
sharded merge (:mod:`.sharded_merge`) runs K4 once a shard on that shard's
device. The mesh's diff classify deals key-aligned chunks out instead
(``ops.diff_kernel.classify_blocks_streamed`` with a mesh).

Routing: :func:`should_shard` sends work of ``KART_SHARDED_MIN_ROWS`` rows
or more (default 2,000,000, kart_tpu's device row floor, not measured on
H100s) to the mesh, and only with 2 or more visible cards. Unlike
kart_tpu's, nothing here falls back to one card or to the host: a failed
launch or copy on any shard raises.
"""

import numpy as np

from kart_tpu_torch.ops.blocks import PAD_KEY, _env_int, bucket_size, to_device
from kart_tpu_torch.parallel.mesh import best_device_count

#: how many times the mesh paths ran in this process (the tests read it:
#: a one-card route taking over would otherwise be invisible)
STATS = {"sharded_classify_calls": 0, "sharded_merge_calls": 0}

#: the default of ``KART_SHARDED_MIN_ROWS``: kart_tpu's device row floor
DEVICE_MIN_ROWS = 2_000_000


def partition_block(block, n_shards, min_bucket=256):
    """FeatureBlock -> (keys (S, B) int64, oids (S, B, 5) uint32, counts (S,)
    int32, src (S, B) int64): the key-modulus partition, each shard sorted
    and padded to one bucket B; ``src`` maps each shard slot back to its
    block row (-1 for padding)."""
    real_keys = np.asarray(block.keys[: block.count])
    real_oids = np.asarray(block.oids[: block.count])
    shard_of = (real_keys % n_shards).astype(np.int64)
    counts = np.bincount(shard_of, minlength=n_shards).astype(np.int32)
    bucket = bucket_size(max(int(counts.max()) if len(counts) else 1, 1), min_bucket)

    keys = np.full((n_shards, bucket), PAD_KEY, dtype=np.int64)
    oids = np.zeros((n_shards, bucket, 5), dtype=np.uint32)
    src = np.full((n_shards, bucket), -1, dtype=np.int64)
    # the keys are sorted: a stable partition keeps each shard sorted
    order = np.argsort(shard_of, kind="stable")
    offsets = np.zeros(n_shards + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    sorted_keys = real_keys[order]
    sorted_oids = real_oids[order]
    for s in range(n_shards):
        lo, hi = offsets[s], offsets[s + 1]
        keys[s, : hi - lo] = sorted_keys[lo:hi]
        oids[s, : hi - lo] = sorted_oids[lo:hi]
        src[s, : hi - lo] = order[lo:hi]
    return keys, oids, counts, src


def _repad(part, bucket):
    keys, oids, counts, src = part
    cur = keys.shape[1]
    if cur >= bucket:
        return part
    s = keys.shape[0]
    keys2 = np.full((s, bucket), PAD_KEY, dtype=np.int64)
    keys2[:, :cur] = keys
    oids2 = np.zeros((s, bucket, 5), dtype=np.uint32)
    oids2[:, :cur] = oids
    src2 = np.full((s, bucket), -1, dtype=np.int64)
    src2[:, :cur] = src
    return keys2, oids2, counts, src2


def shard_tensors(part, s, device):
    """-> (keys int64, oids int32 (n, 5)) of shard ``s``'s real rows of a
    :func:`partition_block` result, on ``device``."""
    keys, oids, counts, _ = part
    n = int(counts[s])
    return (to_device(keys[s, :n], device),
            to_device(oids[s, :n].reshape(n, 5), device, dtype=np.int32))


def _sharded_min_rows():
    return _env_int("KART_SHARDED_MIN_ROWS", DEVICE_MIN_ROWS)


def should_shard(n_rows):
    """Whether work of ``n_rows`` rows goes over the mesh: from
    :func:`_sharded_min_rows` rows, and only with 2 or more visible cards.
    The row test runs before any CUDA query."""
    return n_rows >= _sharded_min_rows() and best_device_count() >= 2
