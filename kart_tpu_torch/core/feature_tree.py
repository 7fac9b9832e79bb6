"""Vectorized Merkle feature-tree construction: the Datasets V3 feature
tree built from (leaf tree, filename, blob-oid) columns with numpy matrix
operations, bit-identical to building it path by path. An int-pk dataset's
columns follow from its pks (:func:`plan_int_feature_tree`); a hash-keyed
one's from its filenames and their hashed tree indices
(:func:`plan_feature_tree`).

Counterpart of kart_tpu's ``core/feature_tree.py`` (``TreePlan``,
``plan_int_feature_tree``, ``emit_feature_tree``, ``emit_leaf_trees``,
``build_upper_levels`` and the import
pipeline's ``StreamingLeafEmitter``, whose leaf payloads come from the
native IO core's ``io_leaf_payloads`` for the pks inside its contract and
from the plan otherwise); tree objects are written in batches through the
object database or its bulk pack writer.
"""

import numpy as np

from kart_tpu_torch.models.paths import PathEncoder, b64_batch, msgpack_single_int_batch


class TreePlan:
    """A feature set's tree layout, independent of its blob oids: the
    sorted order, the entry matrix with the names filled in, the oid cell
    positions and the leaf grouping. :func:`emit_feature_tree` stamps an
    oid column into it and writes the trees."""

    __slots__ = ("encoder", "n", "order", "entry_matrix", "oid_cols", "hole_mask",
                 "fixed_width", "leaf_ids", "uniq_leaves", "first_idx", "counts",
                 "byte_offsets", "row_of_leaf")


def plan_int_feature_tree(pks, encoder=None):
    """Sorted, name-resolved tree layout of unique int64 pks (any order)."""
    encoder = encoder or PathEncoder.INT_PK_ENCODER
    pks = np.asarray(pks, dtype=np.int64)
    if pks.size > 1 and (pks[1:] > pks[:-1]).all():
        srt = np.arange(pks.size)
    else:
        srt = np.argsort(pks, kind="stable")
    pks = np.ascontiguousarray(pks[srt])
    fn_bytes, fn_len = msgpack_single_int_batch(pks)
    b64_mat, b64_len = b64_batch(fn_bytes, fn_len)
    plan = plan_feature_tree((pks // encoder.branches) % encoder.max_trees, b64_mat, b64_len,
                             encoder)
    plan.order = srt[plan.order]
    return plan


def plan_feature_tree(leaf_ids, b64_mat, b64_len, encoder):
    """Sorted, name-resolved tree layout of rows given by their leaf tree
    index (``leaf_ids`` (N,) in ``[0, branches**levels)``, its base-
    ``branches`` digits the tree names from the root down) and their
    filenames (``b64_mat`` (N, W) uint8, row i valid up to ``b64_len[i]``);
    the filenames unique."""
    HOLE = 0xFF
    if encoder.group_length != 1:
        raise ValueError("the feature tree builder needs 1-character tree names")
    plan = TreePlan()
    plan.encoder = encoder
    n = plan.n = len(leaf_ids)
    b64w = b64_mat.shape[1]
    leaf_ids = np.asarray(leaf_ids, dtype=np.int64)

    # sort by (leaf, name bytes), git's tree order: zero-padding the key
    # puts a name before every longer name it prefixes
    name_key = b64_mat.copy()
    name_key[np.arange(b64w)[None, :] >= b64_len[:, None]] = 0
    pad_to = (-b64w) % 8
    if pad_to:
        name_key = np.concatenate([name_key, np.zeros((n, pad_to), dtype=np.uint8)], axis=1)
    words = np.ascontiguousarray(name_key).view(">u8")
    order = np.lexsort(tuple(words[:, i] for i in range(words.shape[1] - 1, -1, -1))
                       + (leaf_ids,))
    plan.order = order  # sorted row -> original row
    b64_mat = b64_mat[order]
    b64_len = b64_len[order]
    plan.leaf_ids = leaf_ids = leaf_ids[order]

    uniform = bool((b64_len == b64_len[0]).all()) if n else True
    rows = np.arange(n)
    if uniform:  # names of one width (dense int pks, text pks of one length): no holes
        L = int(b64_len[0]) if n else 0
        width = 7 + L + 1 + 20
        out = np.zeros((n, width), dtype=np.uint8)
        out[:, :7] = np.frombuffer(b"100644 ", np.uint8)
        out[:, 7 : 7 + L] = b64_mat[:, :L]
        plan.oid_cols = (7 + L + 1) + np.arange(20)[None, :]
        plan.hole_mask = None
        entry_lens = np.full(n, width, dtype=np.int64)
    else:
        width = 7 + b64w + 1 + 20
        out = np.full((n, width), HOLE, dtype=np.uint8)
        out[:, :7] = np.frombuffer(b"100644 ", np.uint8)
        region = out[:, 7 : 7 + b64w]
        region[:] = b64_mat
        region[np.arange(b64w)[None, :] >= b64_len[:, None]] = HOLE
        out[rows, 7 + b64_len] = 0  # the NUL after the name
        plan.oid_cols = (7 + b64_len + 1)[:, None] + np.arange(20)[None, :]
        hole_mask = out == HOLE
        hole_mask[rows[:, None], plan.oid_cols] = False
        plan.hole_mask = hole_mask
        entry_lens = (7 + b64_len + 1 + 20).astype(np.int64)
    plan.entry_matrix = out
    plan.fixed_width = uniform
    plan.uniq_leaves, plan.first_idx, plan.counts = np.unique(
        leaf_ids, return_index=True, return_counts=True)
    plan.byte_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(entry_lens, out=plan.byte_offsets[1:])
    plan.row_of_leaf = np.searchsorted(plan.first_idx, rows, side="right") - 1
    return plan


def _stamp_oids(plan, oids_u8):
    oids_sorted = np.asarray(oids_u8, dtype=np.uint8)[plan.order]
    if plan.fixed_width:
        plan.entry_matrix[:, plan.oid_cols[0]] = oids_sorted
    else:
        plan.entry_matrix[np.arange(plan.n)[:, None], plan.oid_cols] = oids_sorted


def _leaf_payloads(plan, touched):
    full = (plan.entry_matrix if plan.fixed_width else plan.entry_matrix[~plan.hole_mask]).tobytes()
    starts = plan.byte_offsets[plan.first_idx[touched]].tolist()
    ends = plan.byte_offsets[plan.first_idx[touched] + plan.counts[touched]].tolist()
    return [full[a:b] for a, b in zip(starts, ends)]


def emit_feature_tree(odb, plan, oids_u8, *, prev=None):
    """Stamp the blob-oid column into ``plan`` and write the tree objects;
    -> (feature tree hex oid, leaf oids (leaves, 20) uint8). ``prev`` =
    (leaf oids, changed original rows) of an earlier emit over the same
    plan: only the leaves holding a changed row are rewritten."""
    n = plan.n
    if n == 0:
        return odb.write_raw("tree", b""), np.zeros((0, 20), dtype=np.uint8)
    _stamp_oids(plan, oids_u8)
    if prev is not None:
        prev_leaf_oids, changed_rows = prev
        sorted_pos = np.empty(n, dtype=np.int64)
        sorted_pos[plan.order] = np.arange(n)
        touched = np.unique(plan.row_of_leaf[sorted_pos[changed_rows]])
        leaf_oids = prev_leaf_oids.copy()
    else:
        touched = np.arange(len(plan.uniq_leaves))
        leaf_oids = np.zeros((len(plan.uniq_leaves), 20), dtype=np.uint8)
    leaf_oids[touched] = odb.write_raw_many("tree", _leaf_payloads(plan, touched))
    return build_upper_levels(odb, plan.uniq_leaves, leaf_oids, plan.encoder), leaf_oids


def build_upper_levels(odb, child_ids, child_oids, encoder):
    """Write the spine of upper-level trees over written leaf trees;
    -> feature-tree root hex oid. ``child_ids``: ascending leaf slots
    (``pk // branches``); ``child_oids``: their (n, 20) uint8 oids. Each
    level is one matrix of fixed-width entries (``40000 <name>\\0<sha>``)
    sorted by (parent, name bytes)."""
    alpha = np.frombuffer(encoder.alphabet.encode("ascii"), dtype=np.uint8)
    child_ids = np.asarray(child_ids, dtype=np.int64)
    child_oids = np.asarray(child_oids, dtype=np.uint8).reshape(-1, 20)
    for _level in range(encoder.levels - 1, -1, -1):
        parents = child_ids // encoder.branches
        names = alpha[child_ids % encoder.branches]
        order = np.lexsort((names, parents))
        parents, names = parents[order], names[order]
        entries = np.empty((len(order), 28), dtype=np.uint8)
        entries[:, :6] = np.frombuffer(b"40000 ", dtype=np.uint8)
        entries[:, 6] = names
        entries[:, 7] = 0
        entries[:, 8:] = child_oids[order]
        child_ids, first = np.unique(parents, return_index=True)
        full = entries.tobytes()
        bounds = (np.append(first, len(order)) * 28).tolist()
        child_oids = odb.write_raw_many("tree", [full[a:b] for a, b in zip(bounds, bounds[1:])])
    if len(child_oids) != 1:
        raise ValueError("feature tree spine did not reduce to one root")
    return bytes(child_oids[0]).hex()


def emit_leaf_trees(writer, plan, oids_u8, pks):
    """Stamp the blob oids into ``plan`` and write only its leaf trees into
    ``writer`` (a PackWriter); -> [(leaf tree path relative to the feature
    root, hex oid)]. An import worker's half of the tree build: the parent
    stitches the leaves into the spine."""
    if plan.n == 0:
        return []
    _stamp_oids(plan, oids_u8)
    touched = np.arange(len(plan.uniq_leaves))
    oids = writer.add_batch("tree", _leaf_payloads(plan, touched))
    pks_sorted = np.asarray(pks, dtype=np.int64)[plan.order]
    enc = plan.encoder
    paths = [enc.encode_pks_to_path((int(pks_sorted[fi]),)).rpartition("/")[0]
             for fi in plan.first_idx.tolist()]
    return list(zip(paths, oids))


class StreamingLeafEmitter:
    """The leaf trees of the import pipeline's sorted (pk, blob oid)
    stream, built while it runs: :meth:`feed` keeps the trailing partial
    leaf and returns the payloads of the leaves a batch completed, so their
    hashing and packing overlap the stream. A leaf's payload depends on its
    own rows only, so the result is the end-of-stream build's, byte for
    byte.

    Valid for strictly increasing non-negative pks below ``branches **
    (levels + 1)``; the first batch outside that flips :attr:`ok` to False
    and the caller builds the tree at the end of the stream (leaves already
    written stay in the pack unreferenced)."""

    def __init__(self, encoder=None):
        self.encoder = encoder or PathEncoder.INT_PK_ENCODER
        self.ok = self.encoder.scheme == "int"
        self._pk_limit = self.encoder.branches ** (self.encoder.levels + 1)
        self._last_pk = None
        self._carry_pks = np.empty(0, dtype=np.int64)
        self._carry_oids = np.empty((0, 20), dtype=np.uint8)
        #: the ascending leaf slots emitted so far, an int64 array a batch
        self.leaf_id_chunks = []

    def _check(self, pks):
        if pks[0] < 0 or pks[-1] >= self._pk_limit:
            return False
        if self._last_pk is not None and pks[0] <= self._last_pk:
            return False
        return bool((pks[1:] > pks[:-1]).all())

    def _payloads(self, pks, oids_u8):
        """Complete-leaf payloads of sorted ``pks`` -> (buf uint8, offsets
        int64 (n_leaves+1,), leaf_ids int64), from the native core where
        the pks fit its contract (what :meth:`_check` guarantees), else
        from the plan: the leaves' payloads concatenated are the plan's
        hole-compacted entry matrix."""
        from kart_tpu_torch import native

        out = native.leaf_payloads(pks, oids_u8, self.encoder.branches, self._pk_limit)
        if out is not None:
            self.leaf_id_chunks.append(out[2])
            return out
        plan = plan_int_feature_tree(pks, self.encoder)
        _stamp_oids(plan, oids_u8)
        n_leaves = len(plan.uniq_leaves)
        offsets = np.empty(n_leaves + 1, dtype=np.int64)
        if plan.fixed_width:
            buf = plan.entry_matrix.reshape(-1)
            offsets[0] = 0
            np.cumsum(plan.counts * plan.entry_matrix.shape[1], out=offsets[1:])
        else:
            buf = plan.entry_matrix[~plan.hole_mask]
            offsets[:-1] = plan.byte_offsets[plan.first_idx]
            offsets[-1] = plan.byte_offsets[plan.n]
        self.leaf_id_chunks.append(plan.uniq_leaves)
        return buf, offsets, plan.uniq_leaves

    def feed(self, pks, oids_u8):
        """One sorted stream batch; -> (payload buf, offsets, leaf_ids) of
        the leaves it completed, or None (none completed yet, or the stream
        is not streamable: see :attr:`ok`)."""
        if not self.ok:
            return None
        pks = np.asarray(pks, dtype=np.int64)
        if pks.size == 0:
            return None
        if not self._check(pks):
            self.ok = False
            return None
        self._last_pk = int(pks[-1])
        oids_u8 = np.asarray(oids_u8, dtype=np.uint8).reshape(-1, 20)
        if self._carry_pks.size:
            pks = np.concatenate([self._carry_pks, pks])
            oids_u8 = np.concatenate([self._carry_oids, oids_u8])
        leaf = pks // self.encoder.branches
        cut = int(np.searchsorted(leaf, leaf[-1]))  # the last leaf may still grow
        self._carry_pks = pks[cut:]
        self._carry_oids = oids_u8[cut:]
        if cut == 0:
            return None
        return self._payloads(pks[:cut], oids_u8[:cut])

    def finish(self):
        """The final partial leaf's payload, as :meth:`feed`, or None."""
        if not self.ok or not self._carry_pks.size:
            return None
        out = self._payloads(self._carry_pks, self._carry_oids)
        self._carry_pks = np.empty(0, dtype=np.int64)
        self._carry_oids = np.empty((0, 20), dtype=np.uint8)
        return out

    def build_root(self, odb, leaf_oids_u8_chunks):
        """The upper spine over the streamed leaves, given their (n, 20)
        uint8 oids a batch in emission order; -> the feature root's hex
        oid."""
        child_ids = np.concatenate(self.leaf_id_chunks)
        child_oids = np.concatenate(leaf_oids_u8_chunks)
        if len(child_oids) != len(child_ids):
            raise ValueError("streamed leaves and their oids differ in number")
        return build_upper_levels(odb, child_ids, child_oids, self.encoder)
