"""Sampled estimates of a diff's changed-feature count: ``kart diff
--only-feature-count {veryfast,fast,medium,good,exact}``.

Two samplers, chosen per dataset:

* **Column sampling**, when both revisions of an int-pk dataset have
  sidecars and either holds at least :data:`COLUMNAR_ESTIMATE_MIN_ROWS`
  rows: the keys are mixed by a uint64 multiply-xorshift hash (numpy, on
  the host) into :data:`SAMPLE_PARTITIONS` classes, the rows of the first
  ``samples`` classes are kept on both sides, and one counts-only classify
  (kernel K1 on the card, its plain version on the CPU) counts their
  changes; the total is scaled by ``partitions / samples``.
* **Tree sampling** (host): exact counts of a deterministic sample of the
  differing top-level branches of the feature trees, scaled by the number
  of differing branches; ``exact`` counts every differing blob path.

Counts are memoised in the annotations cache under the tree pair and the
accuracy; only unfiltered runs write it, and a cached answer runs nothing.

Counterpart of kart_tpu's ``diff/estimation.py`` (all of it). Its sampled
count runs as a ``jax.pmap`` reduction over devices
(``diff/backend.py:_make_pmapped_counts``); here it is one counts-only K1
launch on one card, and on several cards (``sharded_torch``) one a
key-aligned slice a card (B8).
"""

import numpy as np

from kart_tpu_torch.annotations import DiffAnnotations
from kart_tpu_torch.core.objects import MODE_TREE, ObjectFormatError, tree_records
from kart_tpu_torch.diff import sidecar
from kart_tpu_torch.diff.backend import select_backend
from kart_tpu_torch.ops.blocks import FeatureBlock

ACCURACY_SUBTREE_SAMPLES = {
    "veryfast": 2,
    "fast": 16,
    "medium": 32,
    "good": 64,
}
ACCURACY_CHOICES = (*ACCURACY_SUBTREE_SAMPLES, "exact")

#: the hash classes of column sampling: the path encoder's top fanout, so a
#: sample is as fine as one sampled tree branch
SAMPLE_PARTITIONS = 64

#: below this many rows a side the tree sampler runs instead (the two
#: samplers can print different numbers, so the gate is kart_tpu's exactly)
COLUMNAR_ESTIMATE_MIN_ROWS = 100_000


def estimate_diff_feature_counts(repo, base_rs, target_rs, *, accuracy="fast",
                                 ds_paths=None, device=None):
    """-> {ds_path: estimated changed-feature count} between two revisions,
    datasets with no change left out; ``ds_paths`` limits it to those
    datasets. ``device`` runs the column sampler's classify."""
    if accuracy not in ACCURACY_CHOICES:
        raise ValueError(f"accuracy must be one of {', '.join(ACCURACY_CHOICES)}")
    annotation_type = f"feature-change-counts-{accuracy}"
    base_tree = base_rs.tree_oid if base_rs else None
    target_tree = target_rs.tree_oid if target_rs else None
    annotations = DiffAnnotations(repo)
    cached = annotations.get(base_tree, target_tree, annotation_type)
    if cached is not None:
        # the cache holds the full counts; a filtered call takes a subset
        if ds_paths is not None:
            return {p: c for p, c in cached.items() if p in ds_paths}
        return cached

    base_paths = set(base_rs.datasets.paths()) if base_rs else set()
    target_paths = set(target_rs.datasets.paths()) if target_rs else set()
    counts = {}
    for ds_path in sorted(base_paths | target_paths):
        if ds_paths is not None and ds_path not in ds_paths:
            continue
        old_ds = base_rs.datasets.get(ds_path) if base_rs else None
        new_ds = target_rs.datasets.get(ds_path) if target_rs else None
        count = None
        if accuracy != "exact":
            count = _estimate_columnar(repo, old_ds, new_ds, accuracy, device)
        if count is None:
            count = _estimate_tree_pair(repo.odb, old_ds.feature_tree if old_ds else None,
                                        new_ds.feature_tree if new_ds else None, accuracy)
        if count:
            counts[ds_path] = count

    # only full runs fill the cache: a subset under the unfiltered key would
    # poison later unfiltered reads
    if ds_paths is None:
        annotations.set(base_tree, target_tree, counts, annotation_type)
    return counts


def _estimate_columnar(repo, old_ds, new_ds, accuracy, device=None):
    """The column-sampled estimate from the sidecars, or None when they are
    missing or too small (the caller takes the tree sampler)."""
    if old_ds is None or new_ds is None or repo is None:
        return None
    old_tree, new_tree = old_ds.feature_tree, new_ds.feature_tree
    if (old_tree.oid if old_tree is not None else None) == (
            new_tree.oid if new_tree is not None else None):
        return 0  # an unchanged dataset: the sidecars are never read
    for ds in (old_ds, new_ds):
        if ds.path_encoder.scheme != "int":
            return None  # hash keys: their residues are not pk classes
    if not (sidecar.has_sidecar(repo, old_ds) and sidecar.has_sidecar(repo, new_ds)):
        return None
    old_block = sidecar.load_block(repo, old_ds)
    new_block = sidecar.load_block(repo, new_ds)
    if old_block is None or new_block is None:
        return None
    if max(old_block.count, new_block.count) < COLUMNAR_ESTIMATE_MIN_ROWS:
        return None
    return estimate_counts_from_blocks(old_block, new_block, accuracy, device)


def partition_class(keys):
    """int64 keys -> their hash class in [0, SAMPLE_PARTITIONS): a
    splitmix-style mixer, the same for both sides of a diff (raw ``pk % 64``
    would alias with strided pks such as all-even fids). numpy: torch's
    uint64 shifts do not run on the CPU."""
    h = np.asarray(keys).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    h ^= h >> np.uint64(29)
    h *= np.uint64(0xBF58476D1CE4E5B9)
    return (h >> np.uint64(58)) % np.uint64(SAMPLE_PARTITIONS)


def sample_block(block, k):
    """The rows of ``block`` whose key falls in the first ``k`` hash
    classes, as an unpadded FeatureBlock (still key-sorted)."""
    keys = np.asarray(block.keys[: block.count])
    mask = partition_class(keys) < k
    sub_keys = keys[mask]
    return FeatureBlock(sub_keys, np.asarray(block.oids[: block.count])[mask], len(sub_keys))


def estimate_counts_from_blocks(old_block, new_block, accuracy, device=None):
    """Sampled changed-feature count of two (pk, oid) blocks: the rows of
    ``samples`` of the 64 hash classes, classified by one counts-only K1
    launch on ``device`` (the card by default; the plain version on the
    CPU), scaled by ``64 / samples`` (exact at ``good``)."""
    k = min(ACCURACY_SUBTREE_SAMPLES[accuracy], SAMPLE_PARTITIONS)
    old_sub, new_sub = sample_block(old_block, k), sample_block(new_block, k)
    total = int(select_backend(device).counts(old_sub, new_sub).sum())
    if k == SAMPLE_PARTITIONS:
        return total
    return round(total * SAMPLE_PARTITIONS / k)


def _estimate_tree_pair(odb, old_tree, new_tree, accuracy):
    old_oid = bytes.fromhex(old_tree.oid) if old_tree is not None else None
    new_oid = bytes.fromhex(new_tree.oid) if new_tree is not None else None
    if old_oid == new_oid:
        return 0
    if accuracy == "exact":
        return _count_tree_diff(odb, old_oid, new_oid)
    samples = ACCURACY_SUBTREE_SAMPLES[accuracy]
    old_entries, new_entries = _entry_map(odb, old_oid), _entry_map(odb, new_oid)
    differing = sorted(name for name in set(old_entries) | set(new_entries)
                       if old_entries.get(name) != new_entries.get(name))
    if len(differing) <= samples:
        # cheaper to be exact: every other branch contributes 0
        return sum(_count_tree_diff(odb, old_entries.get(n), new_entries.get(n))
                   for n in differing)
    # an evenly spaced sample of the differing branches: branch contents are
    # hash-distributed, so spacing is as good as randomness, and repeatable
    step = len(differing) / samples
    sampled = [differing[int(i * step)] for i in range(samples)]
    total = sum(_count_tree_diff(odb, old_entries.get(n), new_entries.get(n)) for n in sampled)
    return round(total / samples * len(differing))


def _entry_map(odb, tree_sha):
    """20-byte tree sha -> {entry name: (20-byte sha, is_tree)}; {} for
    None. Read from the raw tree without hex oids: the exact count reads
    every changed leaf tree."""
    if tree_sha is None:
        return {}
    obj_type, data = odb.read_raw(tree_sha.hex())
    if obj_type != "tree":
        raise ObjectFormatError(f"{tree_sha.hex()} is a {obj_type}, expected tree")
    return {name: (raw[-20:], mode == MODE_TREE) for name, (mode, raw) in tree_records(data).items()}


def _count_tree_diff(odb, old, new):
    """Exact count of the blob paths that differ between two (sub)trees,
    each a 20-byte sha, a (sha, is_tree) entry or None."""
    old_oid, old_is_tree = _normalise(old)
    new_oid, new_is_tree = _normalise(new)
    if old_oid == new_oid and old_is_tree == new_is_tree:
        return 0
    if old_oid is None:
        return _count_blobs(odb, new_oid, new_is_tree)
    if new_oid is None:
        return _count_blobs(odb, old_oid, old_is_tree)
    if not old_is_tree and not new_is_tree:
        return 1  # two blobs at one path: one changed feature
    if old_is_tree != new_is_tree:
        return _count_blobs(odb, old_oid, old_is_tree) + _count_blobs(odb, new_oid, new_is_tree)
    old_entries, new_entries = _entry_map(odb, old_oid), _entry_map(odb, new_oid)
    return sum(_count_tree_diff(odb, old_entries.get(n), new_entries.get(n))
               for n in set(old_entries) | set(new_entries)
               if old_entries.get(n) != new_entries.get(n))


def _normalise(value):
    if value is None:
        return None, False
    if isinstance(value, tuple):
        return value
    return value, True  # a bare sha is a tree


def _count_blobs(odb, sha, is_tree):
    if not is_tree:
        return 1
    return sum(_count_blobs(odb, *entry) for entry in _entry_map(odb, sha).values())
