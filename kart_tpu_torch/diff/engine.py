"""The columnar diff engine's device half: the envelope prefilter, the
classify with its changed rows, and the changed-feature count behind
``kart diff -o feature-count``.

Counterpart of kart_tpu's ``diff/engine.py`` (``_envelope_hits``,
``spatial_prefilter_blocks``, ``_prefilter_rect``, the classify half of
``get_feature_diff_columnar`` and the tail of
``get_dataset_feature_count_fast``), on FeatureBlocks read from sidecar
files. Materialising values from the changed rows needs the repo layer,
which this package does not have yet.
"""

from typing import NamedTuple

import numpy as np

from kart_tpu_torch.diff.backend import select_backend
from kart_tpu_torch.ops.blocks import PAD_KEY, FeatureBlock, bucket_size
from kart_tpu_torch.ops.diff_kernel import changed_indices, changed_oid_hex, counts_dict

#: query-rect pad for the envelope prefilter: sidecar envelopes are f32 and
#: the filter rect f64, so a borderline feature must pass (fail open)
PREFILTER_PAD = 1e-4


def prefilter_rect(wsen):
    """Padded (w, s, e, n) EPSG:4326 rect of a spatial filter's envelope:
    the arithmetic of kart_tpu's ``_prefilter_rect``."""
    w, s, e, n = (float(v) for v in wsen)
    return (
        w - PREFILTER_PAD,
        max(s - PREFILTER_PAD, -90.0),
        e + PREFILTER_PAD,
        min(n + PREFILTER_PAD, 90.0),
    )


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
