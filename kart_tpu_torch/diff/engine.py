"""The diff engine: the host tree walk, the columnar classify (kernel K1)
with its changed rows, the envelope prefilter, and the dataset/repo diffs
the writers consume.

Counterpart of kart_tpu's ``diff/engine.py``: ``tree_diff_entries`` (its
pure-Python route), ``get_feature_diff``, ``get_feature_diff_columnar``,
``_feature_diff_routed``, ``get_dataset_feature_count_fast``,
``get_feature_diff_rows``, ``get_meta_diff``, ``get_dataset_diff``,
``get_repo_diff``, ``_envelope_hits``, ``spatial_prefilter_blocks`` and
``_prefilter_rect``. The repo-level entry points take ``device`` (``None``
= the card) and route a dataset to the columnar classify when both of its
revisions have a sidecar, else to the tree walk. Under a spatial filter
spec, an int-pk sidecar pair with envelope columns is prefiltered first
(K2 on each side, the survivors compacted, then K1 on them); any other
pair is classified whole and left to the writers' per-value filter. A
hash-keyed dataset's keys are hashes of its filenames: its pks come from
the changed rows' paths, the fast count and the fused row plan decline it
(its collision guard needs the changed rows), and colliding keys send it
to the tree walk, as in kart_tpu. An int-pk dataset added or deleted whole
(a root commit's diff) is listed from one vectorized walk of its feature
tree, with the tree walk's deltas in the tree walk's order.
"""

from typing import NamedTuple

import numpy as np

from kart_tpu_torch import runtime
from kart_tpu_torch.diff import sidecar
from kart_tpu_torch.diff.backend import select_backend
from kart_tpu_torch.diff.key_filters import RepoKeyFilter
from kart_tpu_torch.diff.structs import DatasetDiff, Delta, DeltaDiff, KeyValue, RepoDiff
from kart_tpu_torch.models.paths import PathEncoder, decode_filenames
from kart_tpu_torch.ops.blocks import PAD_KEY, FeatureBlock, bucket_size
from kart_tpu_torch.ops.diff_kernel import (
    DELETE,
    INSERT,
    UPDATE,
    changed_indices,
    changed_oid_hex,
    counts_dict,
)

#: query-rect pad for the envelope prefilter: sidecar envelopes are f32 and
#: the filter rect f64, so a borderline feature must pass (fail open)
PREFILTER_PAD = 1e-4


def prefilter_rect(wsen):
    """Padded (w, s, e, n) EPSG:4326 rect of a spatial filter's envelope
    (the arithmetic of kart_tpu's ``_prefilter_rect``): anything the
    prefilter drops is outside the filter, and the writers' exact residue
    decides what it lets through."""
    w, s, e, n = (float(v) for v in wsen)
    return (
        w - PREFILTER_PAD,
        max(s - PREFILTER_PAD, -90.0),
        e + PREFILTER_PAD,
        min(n + PREFILTER_PAD, 90.0),
    )


def _prefilter_rect(spatial_filter_spec):
    """The padded prefilter rect of an active spatial filter spec, or None
    (also when its CRS cannot be moved to EPSG:4326: the filter then
    fails open, as in kart_tpu)."""
    if spatial_filter_spec is None or spatial_filter_spec.match_all:
        return None
    try:
        wsen = spatial_filter_spec.envelope_wsen_4326
    except Exception:  # kart_tpu's policy: an unresolvable filter CRS fails open
        return None
    return prefilter_rect(wsen)


def spatial_prefilter_blocks(old_block, new_block, rect_wsen, device=None):
    """Envelope prefilter for a sidecar block pair: a key survives in BOTH
    blocks when EITHER side's envelope intersects the rect, so update
    pairs stay aligned. -> (old_sub, new_sub) bucket-padded FeatureBlocks,
    or None when either side has no envelope column."""
    backend = select_backend(device)
    if old_block.envelopes is None or new_block.envelopes is None:
        return None
    query = np.asarray(rect_wsen, dtype=np.float64)
    o_n, n_n = old_block.count, new_block.count
    o_idx = np.flatnonzero(backend.envelope_hits(old_block, query).cpu().numpy())
    n_idx = np.flatnonzero(backend.envelope_hits(new_block, query).cpu().numpy())
    o_keys = old_block.keys[:o_n]
    n_keys = new_block.keys[:n_n]
    if o_n and n_n:
        n_hit_keys = np.asarray(n_keys[n_idx])
        o_hit_keys = np.asarray(o_keys[o_idx])
        if o_n == n_n and np.array_equal(o_hit_keys, n_hit_keys):
            # same hit keys on both sides: each side's rows matching the
            # other's hits are its own hits (keys unique and sorted)
            o_surv, n_surv = o_idx, n_idx
        else:
            pos = np.searchsorted(o_keys, n_hit_keys)
            pos_c = np.minimum(pos, o_n - 1)
            shared = (np.asarray(o_keys[pos_c]) == n_hit_keys) & (pos < o_n)
            o_surv = np.union1d(o_idx, pos_c[shared])
            pos2 = np.searchsorted(n_keys, o_hit_keys)
            pos2_c = np.minimum(pos2, n_n - 1)
            shared2 = (np.asarray(n_keys[pos2_c]) == o_hit_keys) & (pos2 < n_n)
            n_surv = np.union1d(n_idx, pos2_c[shared2])
    else:
        o_surv, n_surv = o_idx, n_idx
    runtime.count("prefilter_old_survivors", len(o_surv))
    runtime.count("prefilter_new_survivors", len(n_surv))
    return _compact(old_block, o_surv), _compact(new_block, n_surv)


def _compact(block, idx):
    k = np.asarray(block.keys[idx])
    o = np.asarray(block.oids[idx])
    size = bucket_size(max(len(k), 1))
    kp = np.full(size, PAD_KEY, dtype=np.int64)
    kp[: len(k)] = k
    op = np.zeros((size, 5), dtype=np.uint32)
    op[: len(k)] = o
    return FeatureBlock(kp, op, len(k))


class ClassifyResult(NamedTuple):
    old_class: object  # int8 tensor (old count,) on the device
    new_class: object  # int8 tensor (new count,)
    counts: dict       # {"inserts", "updates", "deletes"}
    old_idx: np.ndarray  # int64 rows of old_block that changed
    new_idx: np.ndarray  # int64 rows of new_block that changed
    old_hex: list      # oid hexes of old_block[old_idx]
    new_hex: list      # oid hexes of new_block[new_idx]


def classify_changed(old_block, new_block, device=None):
    """The classify half of the columnar diff: classes of every row of
    both sides, the changed rows and their oid hexes (what
    ``get_feature_diff_columnar`` materialises deltas from)."""
    old_class, new_class, counts = select_backend(device).classify(old_block, new_block)
    old_idx, new_idx = changed_indices(old_class, new_class)
    return ClassifyResult(
        old_class, new_class, counts_dict(counts), old_idx, new_idx,
        changed_oid_hex(old_block, old_idx), changed_oid_hex(new_block, new_idx),
    )


def feature_count(old_block, new_block, rect=None, device=None):
    """Exact changed-feature count of a block pair (``-o feature-count``):
    the optional envelope prefilter (``rect`` is the already padded query,
    see :func:`prefilter_rect`), then a counts-only classify. -> int, or
    None when a rect is given but a side has no envelope column."""
    backend = select_backend(device)
    if rect is not None:
        filtered = spatial_prefilter_blocks(old_block, new_block, rect, backend.device)
        if filtered is None:
            return None
        old_block, new_block = filtered
    return int(backend.counts(old_block, new_block).sum())


# --- the repository diff -----------------------------------------------------

def tree_diff_entries(odb, tree_oid_a, tree_oid_b, prefix=""):
    """Yield (path, old_oid, new_oid) for each blob that differs between two
    trees (either side may be None); subtrees with equal oids are skipped
    wholesale."""
    if tree_oid_a == tree_oid_b:
        return
    entries_a = {e.name: e for e in odb.read_tree_entries(tree_oid_a)} if tree_oid_a else {}
    entries_b = {e.name: e for e in odb.read_tree_entries(tree_oid_b)} if tree_oid_b else {}
    for name in sorted(entries_a.keys() | entries_b.keys()):
        ea, eb = entries_a.get(name), entries_b.get(name)
        oid_a = ea.oid if ea else None
        oid_b = eb.oid if eb else None
        if oid_a == oid_b:
            continue
        a_is_tree = ea.is_tree if ea else False
        b_is_tree = eb.is_tree if eb else False
        path = f"{prefix}{name}"
        if a_is_tree or b_is_tree:
            yield from tree_diff_entries(
                odb, oid_a if a_is_tree else None, oid_b if b_is_tree else None, path + "/"
            )
            # a blob replaced by a tree (or the reverse) also yields the blob
            if ea and not a_is_tree:
                yield path, oid_a, None
            if eb and not b_is_tree:
                yield path, None, oid_b
        else:
            yield path, oid_a, oid_b


def _tree_oid(ds):
    tree = ds.feature_tree if ds is not None else None
    return tree.oid if tree is not None else None


def get_feature_diff(base_ds, target_ds, ds_filter=None):
    """DeltaDiff of features between two versions of a dataset by the tree
    walk, with lazy values resolved by the walked oids."""
    feature_filter = ds_filter["feature"] if ds_filter is not None else None
    result = DeltaDiff()
    base_oid, target_oid = _tree_oid(base_ds), _tree_oid(target_ds)
    if base_oid == target_oid:
        return result
    whole = target_ds if base_oid is None else base_ds if target_oid is None else None
    if whole is not None and not _hash_keyed(whole):
        return _whole_dataset_diff(whole, target_oid is None, feature_filter)
    odb = (base_ds or target_ds).feature_tree.odb
    for path, old_oid, new_oid in tree_diff_entries(odb, base_oid, target_oid):
        ds = base_ds if old_oid is not None else target_ds
        pks = ds.decode_path_to_pks(path)
        key = pks[0] if len(pks) == 1 else pks
        if feature_filter is not None and key not in feature_filter:
            continue
        old = (KeyValue((key, base_ds.get_feature_promise_from_oid(pks, old_oid)))
               if old_oid is not None else None)
        new = (KeyValue((key, target_ds.get_feature_promise_from_oid(pks, new_oid)))
               if new_oid is not None else None)
        result.add_delta(Delta(old, new))
    return result


def _whole_dataset_diff(ds, deleted, feature_filter=None):
    """Every feature of an int-pk dataset that was added (or, ``deleted``,
    removed) whole, in the tree walk's order, from one vectorized walk of
    its feature tree (:meth:`~kart_tpu_torch.models.dataset.Dataset3
    .feature_index`) rather than a per-path decode."""
    _, pks, oids_u8 = ds.feature_index()
    hexes = oids_u8.tobytes().hex()
    promise = ds.get_feature_promise_from_oid
    result = DeltaDiff()
    for i, pk in enumerate(pks.tolist()):
        if feature_filter is not None and pk not in feature_filter:
            continue
        kv = KeyValue((pk, promise((pk,), hexes[40 * i : 40 * i + 40])))
        result.add_delta(Delta(kv, None) if deleted else Delta(None, kv))
    return result


def _pks_for_rows(block, idx, keys):
    """The pk tuples of ``block``'s rows ``idx`` (``keys`` their keys as a
    list): the key itself in an int-pk block (no paths: they follow from
    the pks), else the decoded filename of each row's path."""
    if block.paths is None:
        return [(k,) for k in keys]
    return decode_filenames(_filenames(block, idx))


def _filenames(block, idx):
    """The filenames of ``block``'s rows ``idx``, read in one batch from a
    sidecar's paths section (an int-pk block's from its keys)."""
    if block.paths is None:
        return [PathEncoder.encode_filename([k]) for k in np.asarray(block.keys[idx]).tolist()]
    take = getattr(block.paths, "take", None)
    paths = take(idx) if take is not None else [block.path_for_index(i) for i in idx.tolist()]
    return [p.rsplit("/", 1)[-1] for p in paths]


def _hash_keyed(ds):
    return ds.path_encoder.scheme != "int"


def get_feature_diff_columnar(base_ds, target_ds, ds_filter=None, *, blocks, device=None):
    """The columnar variant of :func:`get_feature_diff` for a block pair:
    one K1 classify (:func:`classify_changed`), then lazy deltas for the
    changed rows only, their values resolved by oid straight from the
    sidecar columns. Hash-keyed blocks take kart_tpu's tree walk when two
    rows of one side share a key (before the classify), and when an
    updated key names another filename on each side (a deleted and an
    inserted pk whose hashes collide); each counts
    ``hash_collision_fallbacks``."""
    feature_filter = ds_filter["feature"] if ds_filter is not None else None
    old_block, new_block = blocks
    if old_block.has_key_collisions() or new_block.has_key_collisions():
        runtime.count("hash_collision_fallbacks")
        return get_feature_diff(base_ds, target_ds, ds_filter)
    res = classify_changed(old_block, new_block, device)
    old_cls = res.old_class.cpu().numpy()[res.old_idx].tolist()
    new_cls = res.new_class.cpu().numpy()[res.new_idx].tolist()
    if _hash_keyed(base_ds):
        new_names = set(_filenames(new_block, res.new_idx))
        updated = res.old_idx[np.asarray(old_cls, dtype=np.int64) == UPDATE]
        if any(name not in new_names for name in _filenames(old_block, updated)):
            runtime.count("hash_collision_fallbacks")
            return get_feature_diff(base_ds, target_ds, ds_filter)
    old_keys = np.asarray(old_block.keys[res.old_idx]).tolist()
    new_keys = np.asarray(new_block.keys[res.new_idx]).tolist()
    old_pks = _pks_for_rows(old_block, res.old_idx, old_keys)
    new_hex_by_key = dict(zip(new_keys, res.new_hex))
    result = DeltaDiff()
    for k, pks, cls, oid in zip(old_keys, old_pks, old_cls, res.old_hex):
        key = pks[0] if len(pks) == 1 else pks
        if feature_filter is not None and key not in feature_filter:
            continue
        old_kv = KeyValue((key, base_ds.get_feature_promise_from_oid(pks, oid)))
        if cls == DELETE:
            result.add_delta(Delta.delete(old_kv))
        elif cls == UPDATE:
            new_kv = KeyValue((key, target_ds.get_feature_promise_from_oid(
                pks, new_hex_by_key[k])))
            result.add_delta(Delta.update(old_kv, new_kv))
    inserted = np.asarray(new_cls, dtype=np.int64) == INSERT
    ins_idx = res.new_idx[inserted]
    ins_keys = [k for k, ins in zip(new_keys, inserted.tolist()) if ins]
    ins_hex = [h for h, ins in zip(res.new_hex, inserted.tolist()) if ins]
    for pks, oid in zip(_pks_for_rows(new_block, ins_idx, ins_keys), ins_hex):
        key = pks[0] if len(pks) == 1 else pks
        if feature_filter is not None and key not in feature_filter:
            continue
        result.add_delta(Delta.insert(
            KeyValue((key, target_ds.get_feature_promise_from_oid(pks, oid)))))
    return result


def _sidecar_blocks(base_ds, target_ds):
    """Both revisions' sidecar blocks (count-sliced mmap views, never a
    padded copy), or None when either is missing: the columnar route's
    precondition."""
    repo = base_ds.repo or target_ds.repo
    if repo is None or not (sidecar.has_sidecar(repo, base_ds)
                            and sidecar.has_sidecar(repo, target_ds)):
        return None
    old_block = sidecar.load_block(repo, base_ds, pad=False)
    new_block = sidecar.load_block(repo, target_ds, pad=False)
    if old_block is None or new_block is None:
        return None
    return old_block, new_block


def _feature_diff_routed(base_ds, target_ds, ds_filter=None, device=None,
                         spatial_filter_spec=None):
    """Engine selection: the columnar classify when both revisions have a
    sidecar (prefiltered by envelope under a spatial filter, when both
    carry envelopes), else the tree walk."""
    if _tree_oid(base_ds) == _tree_oid(target_ds):
        return DeltaDiff()
    if base_ds is not None and target_ds is not None:
        blocks = _sidecar_blocks(base_ds, target_ds)
        if blocks is not None:
            rect = _prefilter_rect(spatial_filter_spec)
            if rect is not None and not _hash_keyed(base_ds):
                blocks = spatial_prefilter_blocks(*blocks, rect, device) or blocks
            return get_feature_diff_columnar(base_ds, target_ds, ds_filter, blocks=blocks,
                                             device=device)
    return get_feature_diff(base_ds, target_ds, ds_filter)


def _both_revisions(base_rs, target_rs, ds_path):
    base_ds = base_rs.datasets.get(ds_path) if base_rs is not None else None
    target_ds = target_rs.datasets.get(ds_path) if target_rs is not None else None
    if base_ds is None or target_ds is None:
        return None  # whole-dataset add/delete: the delta path handles it
    return base_ds, target_ds


def get_dataset_feature_count_fast(base_rs, target_rs, ds_path, device=None,
                                   spatial_filter_spec=None):
    """Changed-feature count of one dataset from a counts-only K1 launch,
    with no delta objects (``-o feature-count``). Under a spatial filter
    spec it counts the envelope prefilter's survivors: a changed feature
    whose padded envelope meets the filter's rectangle counts, whatever its
    exact geometry (kart_tpu's deliberate fail-open upper bound). -> int,
    or None when the columnar route cannot serve it (dataset added or
    removed, a hash-keyed version, whose collision guard needs the changed
    rows, missing sidecars, or a filter with no envelope columns)."""
    pair = _both_revisions(base_rs, target_rs, ds_path)
    if pair is None:
        return None
    if _tree_oid(pair[0]) == _tree_oid(pair[1]):
        return 0
    if _hash_keyed(pair[0]) or _hash_keyed(pair[1]):
        return None
    blocks = _sidecar_blocks(*pair)
    if blocks is None:
        return None
    rect = _prefilter_rect(spatial_filter_spec)
    if rect is not None:
        blocks = spatial_prefilter_blocks(*blocks, rect, device)
        if blocks is None:
            return None  # no envelope columns: the writer filters the deltas
    return int(select_backend(device).counts(*blocks).sum())


def get_feature_diff_rows(base_rs, target_rs, ds_path, device=None):
    """Columnar row plan of one dataset's full diff: K1's changed set as
    (pk, old row, new row) index arrays over the sidecar blocks, sorted by
    pk like the delta route's ``sorted_items``. -> {"count": m, "pks",
    "old_rows"/"new_rows" (-1 for an absent side), "old_block"/
    "new_block", "base_ds"/"target_ds"}, or None when the columnar route
    cannot serve it (as for the fast count)."""
    pair = _both_revisions(base_rs, target_rs, ds_path)
    if pair is None:
        return None
    base_ds, target_ds = pair
    if _tree_oid(base_ds) == _tree_oid(target_ds):
        return {"count": 0}
    if _hash_keyed(base_ds) or _hash_keyed(target_ds):
        return None
    blocks = _sidecar_blocks(base_ds, target_ds)
    if blocks is None:
        return None
    old_block, new_block = blocks
    old_class, new_class, _ = select_backend(device).classify(old_block, new_block)
    old_idx, new_idx = changed_indices(old_class, new_class)
    okeys = np.asarray(old_block.keys[old_idx])
    nkeys = np.asarray(new_block.keys[new_idx])
    pks = np.union1d(okeys, nkeys)
    m = len(pks)

    def side_rows(side_keys, side_idx):
        rows = np.full(m, -1, dtype=np.int64)
        if len(side_keys):
            pos = np.searchsorted(side_keys, pks)
            posc = np.minimum(pos, len(side_keys) - 1)
            has = (pos < len(side_keys)) & (side_keys[posc] == pks)
            rows[has] = side_idx[posc[has]]
        return rows

    return {
        "count": m, "pks": pks,
        "old_rows": side_rows(okeys, old_idx), "new_rows": side_rows(nkeys, new_idx),
        "old_block": old_block, "new_block": new_block,
        "base_ds": base_ds, "target_ds": target_ds,
    }


def get_meta_diff(base_ds, target_ds, ds_filter=None):
    """DeltaDiff of the meta items between two versions of a dataset."""
    meta_filter = ds_filter["meta"] if ds_filter is not None else None
    old_items = base_ds.meta_items() if base_ds else {}
    new_items = target_ds.meta_items() if target_ds else {}
    result = DeltaDiff()
    for name in sorted(old_items.keys() | new_items.keys()):
        if meta_filter is not None and name not in meta_filter:
            continue
        old_value, new_value = old_items.get(name), new_items.get(name)
        if old_value == new_value:
            continue
        old = KeyValue((name, old_value)) if old_value is not None else None
        new = KeyValue((name, new_value)) if new_value is not None else None
        result.add_delta(Delta(old, new))
    return result


def get_dataset_diff(base_rs, target_rs, ds_path, *, ds_filter=None, device=None,
                     spatial_filter_spec=None):
    """DatasetDiff for one dataset between two revisions; under a spatial
    filter spec, the envelope prefilter's survivors only (the writers apply
    the exact residue)."""
    base_ds = base_rs.datasets.get(ds_path) if base_rs is not None else None
    target_ds = target_rs.datasets.get(ds_path) if target_rs is not None else None
    diff = DatasetDiff()
    if base_ds is None and target_ds is None:
        return diff
    diff["meta"] = get_meta_diff(base_ds, target_ds, ds_filter)
    diff["feature"] = _feature_diff_routed(base_ds, target_ds, ds_filter, device,
                                           spatial_filter_spec)
    diff.prune()
    return diff


def get_repo_diff(base_rs, target_rs, *, repo_key_filter=None, device=None,
                  spatial_filter_spec=None):
    """RepoDiff between two revisions."""
    repo_key_filter = repo_key_filter or RepoKeyFilter.MATCH_ALL_FILTER()
    base_paths = set(base_rs.datasets.paths()) if base_rs is not None else set()
    target_paths = set(target_rs.datasets.paths()) if target_rs is not None else set()
    repo_diff = RepoDiff()
    for ds_path in sorted(base_paths | target_paths):
        if ds_path not in repo_key_filter:
            continue
        ds_diff = get_dataset_diff(base_rs, target_rs, ds_path,
                                   ds_filter=repo_key_filter[ds_path], device=device,
                                   spatial_filter_spec=spatial_filter_spec)
        if ds_diff:
            repo_diff[ds_path] = ds_diff
    repo_diff.prune(recurse=False)
    return repo_diff
