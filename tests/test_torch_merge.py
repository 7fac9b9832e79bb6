"""The port's merge layer against kart_tpu's, on inputs made from a seed
with numpy: K4's plain version against kart_tpu's jitted
``_merge_classify_padded`` (XLA on the CPU), ``_merge_classify_np`` and
``merge_classify_reference`` with zero tolerance; ``MergeIndex`` files byte
for byte in both encodings, each package reading the other's; the tree
builder's removals; feature blocks read from a dataset's tree; and a merge
of 15,000 conflicts run by both packages."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from kart_tpu.core.feature_tree import emit_feature_tree as j_emit
from kart_tpu.core.feature_tree import plan_int_feature_tree as j_plan
from kart_tpu.core.objects import MODE_TREE as J_MODE_TREE
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.core.tree_builder import TreeBuilder as JTreeBuilder
from kart_tpu.merge import do_merge as j_do_merge
from kart_tpu.merge import index as jindex
from kart_tpu.models.paths import PathEncoder as JPathEncoder
from kart_tpu.ops.blocks import FeatureBlock as JBlock
from kart_tpu.ops.merge_kernel import (
    _merge_classify_np,
    _merge_classify_padded,
    merge_classify_reference,
)
from kart_tpu.ops.merge_kernel import merge_classify as j_merge_classify
from kart_tpu.synth import synth_repo as j_synth_repo
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.core.tree_builder import TreeBuilder as TTreeBuilder
from kart_tpu_torch.merge import do_merge as t_do_merge
from kart_tpu_torch.merge import index as tindex
from kart_tpu_torch.models.paths import PathEncoder as TPathEncoder
from kart_tpu_torch.ops.blocks import PAD_KEY, FeatureBlock, bucket_size
from kart_tpu_torch.ops.merge_kernel import (
    CONFLICT,
    KEEP_OURS,
    TAKE_THEIRS,
    SLICE_ROWS,
    merge_classify,
    merge_classify_padded,
    merge_classify_plain,
    merge_classify_sides,
    merge_tile_plan,
    merge_tile_plan_plain,
)

DATE = "1700000000 +0000"


# --- K4's plain version --------------------------------------------------------

def _blocks(items, pad=True):
    """{key: oid word} -> (kart_tpu block, port block) of the same rows."""
    keys = np.asarray(sorted(items), dtype=np.int64)
    oids = np.zeros((len(keys), 5), dtype=np.uint32)
    for i, k in enumerate(keys.tolist()):
        oids[i, :] = items[k]
    paths = [f"p{k}" for k in keys.tolist()]
    return (JBlock.from_arrays(keys, oids, paths, pad=pad),
            FeatureBlock.from_arrays(keys, oids, paths, pad=pad))


def _random_triple(seed, n, universe, p_edit=0.3, p_del=0.1, p_ins=0.1):
    """Ancestor, ours and theirs dicts from a seed: each side edits and
    deletes some ancestor keys and inserts keys of its own, with overlap."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(universe, min(n, len(universe)), replace=False)
    words = rng.integers(1, 2**32, size=len(keys), dtype=np.uint64)
    base = dict(zip(keys.tolist(), (int(w) for w in words)))
    rest = np.setdiff1d(universe, keys)
    sides = []
    for side_seed in (1, 2):
        r = np.random.default_rng(seed * 7 + side_seed)
        side = dict(base)
        for k in list(side):
            u = r.random()
            if u < p_del:
                del side[k]
            elif u < p_del + p_edit:
                # a shared rewrite (both sides pick the same new oid) or a private one
                side[k] = base[k] ^ (1 if r.random() < 0.3 else int(r.integers(2, 2**31)))
        n_ins = int(len(keys) * p_ins)
        for k in r.choice(rest, min(n_ins, len(rest)), replace=False).tolist():
            side[k] = int(r.integers(1, 4))  # few values: add/add sames and conflicts
        sides.append(side)
    return base, sides[0], sides[1]


UNIVERSE = np.arange(-(2**40), -(2**40) + 20_000, 3, dtype=np.int64)
EXTREMES = np.concatenate([
    np.array([-(2**63), -(2**63) + 1, 2**63 - 3, 2**63 - 2], dtype=np.int64),
    np.arange(-500, 500, 7, dtype=np.int64),
])


def _case(name):
    if name.startswith("random"):
        seed = int(name[len("random"):])
        return _random_triple(seed, [0, 1, 40, 1500, 5000][seed % 5], UNIVERSE)
    if name == "extremes":
        return _random_triple(11, 80, EXTREMES)
    if name == "classic":
        #  1 unchanged, 2 theirs edit, 3 ours edit, 4 same edit, 5 conflict edit,
        #  6 theirs delete, 7 ours insert, 8 theirs insert, 9 same insert,
        #  10 add/add conflict
        return ({1: 1, 2: 2, 3: 3, 4: 4, 5: 5, 6: 6},
                {1: 1, 2: 2, 3: 33, 4: 44, 5: 55, 6: 6, 7: 7, 9: 9, 10: 100},
                {1: 1, 2: 22, 3: 3, 4: 44, 5: 555, 8: 8, 9: 9, 10: 101})
    if name == "add_add":
        return {}, {1: 5, 2: 6, 3: 7}, {1: 5, 2: 9, 4: 1}
    if name == "delete_delete":
        return {1: 1, 2: 2, 3: 3}, {3: 3}, {3: 3}
    if name == "edit_delete":
        return {1: 1, 2: 2, 3: 3, 4: 4}, {1: 10, 2: 2, 4: 40}, {2: 20, 3: 30, 4: 40}
    if name == "extremes_all":
        # every side holds -2**63 and 2**63 - 2, beside PAD_KEY
        lo, hi = -(2**63), 2**63 - 2
        return ({lo: 1, 0: 3, hi: 2}, {lo: 1, hi: 5, 9: 4}, {lo: 7, 5: 9, hi: 2})
    if name == "range_one_side":
        # the ancestor holds every key of a range, ours and theirs a few
        a = {k: k + 1 for k in range(3000)}
        o = {k: (k + 1 if k % 1000 else k + 2) for k in range(0, 3000, 250)}
        t = {k: (k + 1 if k % 1400 else k + 3) for k in range(70, 3000, 700)}
        t.update({k: 1 for k in range(3000, 3010)})
        return a, o, t
    if name == "seam":
        # equal keys on all sides at every multiple of the tile sizes, each
        # side one row off the others so their splitters interleave
        rng = np.random.default_rng(17)
        keys = list(range(0, 2 * (3 * SLICE_ROWS + 1), 2))
        base = {k: int(w) for k, w in zip(keys, rng.integers(1, 2**32, len(keys)))}
        o = {k: (w ^ 1 if k % 6 == 0 else w) for k, w in base.items() if k != 0}
        t = {k: (w ^ (1 if k % 10 == 0 else 2) if k % 4 == 0 else w)
             for k, w in base.items() if k not in (0, 2)}
        return base, o, t
    empties = {"empty_all": (0, 0, 0), "empty_a": (0, 1, 1), "empty_o": (1, 0, 1),
               "empty_t": (1, 1, 0), "only_a": (1, 0, 0), "only_o": (0, 1, 0),
               "only_t": (0, 0, 1)}
    base, ours, theirs = _random_triple(5, 300, UNIVERSE)
    keep = empties[name]
    return tuple(d if k else {} for d, k in zip((base, ours, theirs), keep))


CASES = ([f"random{i}" for i in range(10)]
         + ["extremes", "classic", "add_add", "delete_delete", "edit_delete", "empty_all",
            "empty_a", "empty_o", "empty_t", "only_a", "only_o", "only_t", "extremes_all",
            "range_one_side", "seam"])


def _tensors(block, size=None):
    """The block's padded key and oid columns as CPU tensors (``size``:
    cut or pad to that many rows)."""
    keys = np.asarray(block.keys)
    oids = np.asarray(block.oids).view(np.int32)
    if size is not None and size != len(keys):
        k = np.full(size, PAD_KEY, dtype=np.int64)
        o = np.zeros((size, 5), dtype=np.int32)
        n = min(size, len(keys))
        k[:n], o[:n] = keys[:n], oids[:n]
        keys, oids = k, o
    return torch.from_numpy(np.ascontiguousarray(keys)), torch.from_numpy(np.ascontiguousarray(oids))


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_numpy_and_reference(name):
    """merge_classify on the CPU against kart_tpu's numpy path and its
    dict reference: union, decision, presence and counts exactly."""
    a, o, t = _case(name)
    (ja, ta), (jo, to), (jt, tt) = _blocks(a), _blocks(o), _blocks(t)
    union, decision, presence, stats = merge_classify(ta, to, tt, "cpu")
    j_union = np.union1d(np.union1d(ja.keys[: ja.count], jo.keys[: jo.count]),
                         jt.keys[: jt.count]).astype(np.int64)
    j_decision, j_presence = _merge_classify_np(ja, jo, jt, j_union)
    assert union.dtype == np.int64 and decision.dtype == np.int8 and presence.dtype == np.int8
    assert np.array_equal(union, j_union)
    assert np.array_equal(decision, j_decision) and np.array_equal(presence, j_presence)
    assert stats == {"conflicts": int(np.sum(j_decision == CONFLICT)),
                     "take_theirs": int(np.sum(j_decision == TAKE_THEIRS))}
    r_union, r_decision = merge_classify_reference(ja, jo, jt)
    assert np.array_equal(union, r_union) and np.array_equal(decision, r_decision)
    if name == "classic":
        assert dict(zip(union.tolist(), decision.tolist())) == {
            1: KEEP_OURS, 2: TAKE_THEIRS, 3: KEEP_OURS, 4: KEEP_OURS, 5: CONFLICT,
            6: TAKE_THEIRS, 7: KEEP_OURS, 8: TAKE_THEIRS, 9: KEEP_OURS, 10: CONFLICT}
    if name == "edit_delete":
        assert decision.tolist() == [CONFLICT, TAKE_THEIRS, CONFLICT, KEEP_OURS]
        assert presence.tolist() == [3, 7, 5, 7]


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("union_pad", [0, 1, 517])
def test_plain_matches_jitted_padded(name, union_pad):
    """merge_classify_plain on bucket-padded sides and a union padded past
    ``union_count`` against kart_tpu's jitted ``_merge_classify_padded`` on
    XLA-CPU, padded rows included."""
    a, o, t = _case(name)
    (ja, ta), (jo, to), (jt, tt) = _blocks(a), _blocks(o), _blocks(t)
    real = np.unique(np.concatenate([b.keys[: b.count] for b in (ja, jo, jt)]))
    u = len(real)
    size = max(bucket_size(max(u, 1)), u + union_pad) if union_pad else max(u, 1)
    union = np.full(size, PAD_KEY, dtype=np.int64)
    union[:u] = real
    j = _merge_classify_padded(ja.keys, ja.oids, ja.count, jo.keys, jo.oids, jo.count,
                               jt.keys, jt.oids, jt.count, union, u)
    args = []
    for b in (ta, to, tt):
        args += [*_tensors(b), b.count]
    decision, presence, counts = merge_classify_plain(*args, torch.from_numpy(union), u)
    assert np.array_equal(decision.numpy(), np.asarray(j[0]))
    assert np.array_equal(presence.numpy(), np.asarray(j[1]))
    assert counts.tolist() == [int(j[2]), int(j[3])]
    # the dispatching wrapper takes the plain version for CPU tensors
    got = merge_classify_padded(*args, torch.from_numpy(union), u)
    assert all(torch.equal(x, y) for x, y in zip(got, (decision, presence, counts)))
    assert (decision.numpy()[u:] == KEEP_OURS).all()


def test_unpadded_sides_and_short_counts():
    """Sides passed unpadded, or with ``count`` below their length (the
    rows past it are never found), give the padded sides' answer."""
    a, o, t = _case("random3")
    (_, ta), (_, to), (_, tt) = _blocks(a), _blocks(o), _blocks(t)
    want = merge_classify(ta, to, tt, "cpu")
    (_, ua), (_, uo), (_, ut) = _blocks(a, False), _blocks(o, False), _blocks(t, False)
    got = merge_classify(ua, uo, ut, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(got[:3], want[:3])) and got[3] == want[3]
    # theirs cut to its first half: the cut rows read as absent
    union = torch.from_numpy(want[0])
    args = []
    for b, count in ((ta, ta.count), (to, to.count), (tt, tt.count // 2)):
        args += [*_tensors(b), count]
    _, presence, _ = merge_classify_plain(*args, union, len(union))
    cut = set(np.asarray(tt.keys[tt.count // 2: tt.count]).tolist())
    has_t = (presence.numpy() & 4) != 0
    assert not any(has_t[i] for i, k in enumerate(want[0].tolist()) if k in cut)


def test_input_checks():
    a, o, t = _case("classic")
    (_, ta), (_, to), (_, tt) = _blocks(a), _blocks(o), _blocks(t)
    args = []
    for b in (ta, to, tt):
        args += [*_tensors(b), b.count]
    union = torch.arange(1, 11, dtype=torch.int64)
    with pytest.raises(ValueError, match="union count"):
        merge_classify_padded(*args, union, 11)
    with pytest.raises(ValueError, match="union keys"):
        merge_classify_padded(*args, union.to(torch.int32), 10)
    bad = list(args)
    bad[1] = bad[1].to(torch.int64)
    with pytest.raises(ValueError, match="ancestor oids"):
        merge_classify_padded(*bad, union, 10)
    bad = list(args)
    bad[8] = len(bad[6]) + 1
    with pytest.raises(ValueError, match="theirs count"):
        merge_classify_padded(*bad, union, 10)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("padded", [False, True])
def test_sides_match_kart_tpu(name, padded):
    """merge_classify_sides on CPU tensors (bucket-padded sides with count
    below their length, or count-sliced ones) against kart_tpu's
    merge_classify and its jitted _merge_classify_padded on XLA-CPU:
    union, decision, presence and counts exactly."""
    a, o, t = _case(name)
    (ja, ta), (jo, to), (jt, tt) = _blocks(a), _blocks(o), _blocks(t)
    j_union, j_decision, j_presence, j_stats = j_merge_classify(ja, jo, jt)
    u = len(j_union)
    union_pad = np.full(bucket_size(max(u, 1)), PAD_KEY, dtype=np.int64)
    union_pad[:u] = j_union
    jit = _merge_classify_padded(ja.keys, ja.oids, ja.count, jo.keys, jo.oids, jo.count,
                                 jt.keys, jt.oids, jt.count, union_pad, u)
    args = []
    for b in (ta, to, tt):
        keys, oids = _tensors(b)
        if not padded:
            keys, oids = keys[: b.count].contiguous(), oids[: b.count].contiguous()
        args += [keys, oids, b.count]
    union, decision, presence, counts = merge_classify_sides(*args)
    assert union.dtype == torch.int64 and decision.dtype == torch.int8
    assert presence.dtype == torch.int8 and counts.dtype == torch.int64
    assert np.array_equal(union.numpy(), j_union)
    assert np.array_equal(decision.numpy(), j_decision)
    assert np.array_equal(decision.numpy(), np.asarray(jit[0])[:u])
    assert np.array_equal(presence.numpy(), j_presence)
    assert np.array_equal(presence.numpy(), np.asarray(jit[1])[:u])
    assert counts.tolist() == [j_stats["conflicts"], j_stats["take_theirs"]]
    assert counts.tolist() == [int(jit[2]), int(jit[3])]


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("tile", [1, 4, 16, SLICE_ROWS])
def test_tile_plan_invariants(name, tile):
    """K4's slice plan (its plain twin, which the card's plan is held to):
    slices start at row 0 and end at the counts, hold at most ``tile`` rows
    of each side, one slice a splitter, and are key ranges: every real row
    is covered once, in key order, and a key in several sides falls in one
    slice. merge_tile_plan on the CPU is the plain plan."""
    a, o, t = _case(name)
    keys = [torch.from_numpy(np.asarray(sorted(d), dtype=np.int64)) for d in (a, o, t)]
    counts = [len(k) for k in keys]
    plan = merge_tile_plan_plain(*keys, tile=tile)
    if tile == SLICE_ROWS:
        assert torch.equal(plan, merge_tile_plan(keys[0], counts[0], keys[1], counts[1],
                                                 keys[2], counts[2]))
    n_tiles = sum(-(-n // tile) for n in counts)
    assert plan.shape == (n_tiles + 1, 3) and plan.dtype == torch.int64
    assert plan[0].tolist() == [0, 0, 0] and plan[-1].tolist() == counts
    step = plan[1:] - plan[:-1]
    assert (step >= 0).all() and (step <= tile).all()
    last = None
    for k in range(n_tiles):
        rows = [keys[s][plan[k, s]: plan[k + 1, s]] for s in range(3)]
        tile_keys = torch.cat(rows)
        if len(tile_keys):
            if last is not None:
                assert tile_keys.min() > last
            last = tile_keys.max()


def test_sides_input_checks():
    a, o, t = _case("classic")
    args = []
    for b in (_blocks(a)[1], _blocks(o)[1], _blocks(t)[1]):
        args += [*_tensors(b), b.count]
    bad = list(args)
    bad[3] = bad[3].to(torch.int32)
    with pytest.raises(ValueError, match="ours keys"):
        merge_classify_sides(*bad)
    bad = list(args)
    bad[2] = len(bad[0]) + 1
    with pytest.raises(ValueError, match="ancestor count"):
        merge_classify_sides(*bad)
    with pytest.raises(ValueError, match="theirs count"):
        merge_tile_plan(args[0], args[2], args[3], args[5], args[6], len(args[6]) + 1)


# --- MergeIndex files ---------------------------------------------------------

def _conflict_sets(n, seed=0, with_meta=True):
    """The same ``n`` conflicts built with each package's classes: one
    int-pk dataset's columnar conflicts (an absent ancestor or theirs on
    some rows, a lazy pk-derived path column shared by two versions) and,
    ``with_meta``, one meta conflict."""
    rng = np.random.default_rng(seed)
    n -= int(with_meta)
    keys = np.sort(rng.choice(2**40, n, replace=False)).astype(np.int64) - 2**39
    oids = [rng.integers(0, 256, size=(n, 20), dtype=np.uint8) for _ in range(3)]
    present = [rng.random(n) < 0.9, np.ones(n, bool), rng.random(n) < 0.8]
    prefix = "layer/.table-dataset/feature/"
    out = []
    for ix, enc_cls in ((jindex, JPathEncoder), (tindex, TPathEncoder)):
        enc = enc_cls.INT_PK_ENCODER
        shared = ix.EncodedPkPaths(prefix, enc, keys)
        versions = [(present[0], oids[0] * present[0][:, None], ix.EncodedPkPaths(prefix, enc, keys)),
                    (present[1], oids[1], shared), (present[2], oids[2] * present[2][:, None], shared)]
        meta = {"layer:meta:title": ix.AncestorOursTheirs(
            ix.ConflictEntry("layer/.table-dataset/meta/title", "a" * 40),
            ix.ConflictEntry("layer/.table-dataset/meta/title", "b" * 40),
            ix.ConflictEntry("layer/.table-dataset/meta/title", "c" * 40))}
        conflicts = ix.CombinedConflicts([ix.ColumnarConflicts(ix.PkLabels("layer", keys), versions)])
        if with_meta:
            conflicts.add(meta)
        out.append(conflicts)
    return keys, out


def _repos(tmp_path):
    j = JRepo.init_repository(str(tmp_path / "j"))
    t = TRepo(str(JRepo.init_repository(str(tmp_path / "t")).workdir))
    return j, t


def _read(repo):
    with open(repo.gitdir_file("MERGE_INDEX"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("n,with_meta", [(9_999, True), (10_000, True), (9_999, False),
                                         (10_000, False), (10_001, False)])
def test_merge_index_bytes_match(tmp_path, n, with_meta):
    """JSON under 10,000 conflicts, KMIX2 at 10,000 and over: the port writes
    kart_tpu's bytes, and each package reads and rewrites the other's file
    to the same bytes, resolves included."""
    _, (jc, tc) = _conflict_sets(n, seed=n, with_meta=with_meta)
    jrepo, trepo = _repos(tmp_path)
    labels = list(jc)  # materialises the label columns, as resolving does
    assert list(tc) == labels
    resolves = {labels[3]: [], labels[-1]: []}
    j_mi = jindex.MergeIndex("d" * 40, jc, {k: list(v) for k, v in resolves.items()})
    t_mi = tindex.MergeIndex("d" * 40, tc, {k: list(v) for k, v in resolves.items()})
    j_mi.resolves[labels[5]] = [jindex.ConflictEntry("layer/x", "e" * 40)]
    t_mi.resolves[labels[5]] = [tindex.ConflictEntry("layer/x", "e" * 40)]
    j_mi.write_to_repo(jrepo)
    t_mi.write_to_repo(trepo)
    raw = _read(jrepo)
    assert _read(trepo) == raw
    assert raw.startswith(b"KMIX2\n") == (n >= 10_000)
    # each reads the other's file and writes it back unchanged
    t_back = tindex.MergeIndex.read_from_repo(jrepo)
    j_back = jindex.MergeIndex.read_from_repo(trepo)
    assert list(t_back.conflicts) == list(j_back.conflicts) == labels
    assert t_back.unresolved_labels == j_back.unresolved_labels
    for label in (labels[0], labels[7], labels[-1]):
        a, b = t_back.conflicts[label], j_back.conflicts[label]
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                assert (x.path, x.oid) == (y.path, y.oid)
    t_back.write_to_repo(trepo)
    j_back.write_to_repo(jrepo)
    assert _read(trepo) == _read(jrepo) == raw


def test_reads_kmix1(tmp_path):
    """A KMIX1 file (plain label and path blocks, the older magic) reads in
    the port as it does in kart_tpu."""
    jrepo, trepo = _repos(tmp_path)
    n = 12_000
    _, (jc, _) = _conflict_sets(n, seed=4)
    labels, cols = jindex._conflicts_as_columns(jc)
    plain = jindex.ColumnarConflicts(
        list(jindex._materialise_col(labels)),
        [(p, o, list(jindex._materialise_col(c))) for p, o, c in cols])
    raw = b"".join(jindex.MergeIndex("f" * 40, plain)._binary_chunks())
    assert raw.startswith(b"KMIX2\n") and b"\xff" * 7 not in raw[:200]
    kmix1 = b"KMIX1\n" + raw[len(b"KMIX2\n"):]
    for repo in (jrepo, trepo):
        with open(repo.gitdir_file("MERGE_INDEX"), "wb") as f:
            f.write(kmix1)
    t_mi, j_mi = tindex.MergeIndex.read_from_repo(trepo), jindex.MergeIndex.read_from_repo(jrepo)
    assert t_mi.merged_tree == j_mi.merged_tree == "f" * 40
    assert list(t_mi.conflicts) == list(j_mi.conflicts) and len(t_mi.conflicts) == n
    for label in list(j_mi.conflicts)[::997]:
        for x, y in zip(t_mi.conflicts[label], j_mi.conflicts[label]):
            assert (x is None) == (y is None) and (x is None or (x.path, x.oid) == (y.path, y.oid))
    t_mi.write_to_repo(trepo)
    j_mi.write_to_repo(jrepo)
    assert _read(trepo) == _read(jrepo)


def test_summary_counts_match():
    _, (jc, tc) = _conflict_sets(502, seed=2)
    assert tc.summary_counts() == jc.summary_counts() == {("layer", "feature"): 501,
                                                          ("layer", "meta"): 1}


# --- the tree builder ---------------------------------------------------------

def _blob_oids(odb, n, tag):
    return [odb.write_blob(f"{tag}-{i}".encode()) for i in range(n)]


@pytest.mark.parametrize("seed", range(6))
def test_tree_builder_removals_match(tmp_path, seed):
    """Random inserts, removals and subtree removals, flushed in rounds:
    the port writes kart_tpu's tree oids, and an all-deleted tree flushes to
    the empty tree in both."""
    jrepo, trepo = _repos(tmp_path)
    rng = np.random.default_rng(seed)
    paths = [f"d{rng.integers(3)}/s{rng.integers(4)}/f{i}" for i in range(60)]
    jb, tb = JTreeBuilder(jrepo.odb), TTreeBuilder(trepo.odb)
    for rnd in range(4):
        oids = _blob_oids(jrepo.odb, len(paths), f"{seed}-{rnd}")
        assert _blob_oids(trepo.odb, len(paths), f"{seed}-{rnd}") == oids
        for p, oid in zip(paths, oids):
            u = rng.random()
            if u < 0.5:
                jb.insert(p, oid)
                tb.insert(p, oid)
            elif u < 0.8:
                jb.remove(p)
                tb.remove(p)
            elif u < 0.85:
                sub = p.rsplit("/", 1)[0]
                jb.remove_tree(sub)
                tb.remove_tree(sub)
        if rnd == 1:
            jb.insert_many(paths[:5], oids[:5])
            tb.insert_many(paths[:5], oids[:5])
        assert bool(jb) == bool(tb) and jb.change_count == tb.change_count
        assert tb.flush() == jb.flush()
        assert not tb and tb.change_count == 0
    for p in {p.split("/")[0] for p in paths}:
        jb.remove_tree(p)
        tb.remove_tree(p)
    empty = jb.flush()
    assert tb.flush() == empty == "4b825dc642cb6eb9a060e54bf8d69288fbee4904"


# --- blocks from a dataset, and a 15,000-conflict merge ----------------------

def _theirs_branch(repo, n, seed):
    """Branch ``theirs`` off the base commit of a ``synth_repo(n,
    edit_frac=0.5, blobs="promised")``: a different rewrite of 99% of
    ours' edited rows and deletes of the other 1% (the conflicts), a
    rewrite of 40% of the rows ours left alone, deletes of 1% more, and 1%
    inserts past the max pk (the take-theirs rows)."""
    base_oid = repo.refs.get("refs/heads/main")
    base_commit = repo.odb.read_commit(base_oid).parents[0]
    pks = np.arange(1 << 24, (1 << 24) + n, dtype=np.int64)
    rng = np.random.default_rng(seed + 1)
    ours_rows = rng.choice(n, size=n // 2, replace=False)  # synth_repo's edit rows
    rng = np.random.default_rng(seed)
    oids = rng.integers(0, 256, size=(n, 20), dtype=np.uint8)
    r = np.random.default_rng(seed + 99)
    edited = r.permutation(ours_rows)
    cut = len(edited) * 99 // 100
    untouched = r.permutation(np.setdiff1d(np.arange(n), ours_rows))
    rewrite = np.concatenate([edited[:cut], untouched[: n * 2 // 5]])
    oids[rewrite] = r.integers(0, 256, size=(len(rewrite), 20), dtype=np.uint8)
    gone = np.concatenate([edited[cut:], untouched[n * 2 // 5 : n * 2 // 5 + n // 100]])
    keep = np.ones(n, bool)
    keep[gone] = False
    ins = pks[-1] + 1 + np.arange(n // 100, dtype=np.int64)
    t_pks = np.concatenate([pks[keep], ins])
    t_oids = np.concatenate([oids[keep], r.integers(0, 256, size=(len(ins), 20), dtype=np.uint8)])
    ftree, _ = j_emit(repo.odb, j_plan(t_pks), t_oids)
    tb = JTreeBuilder(repo.odb, repo.odb.read_commit(base_commit).tree)
    tb.insert("synth/.table-dataset/feature", ftree, mode=J_MODE_TREE)
    repo.create_commit("refs/heads/theirs", tb.flush(), "theirs edits", [base_commit])
    return {"conflicts": len(edited), "take_theirs": n * 2 // 5 + n // 100 + n // 100}


@pytest.fixture(scope="module")
def merge_repo(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("merge") / "repo")
    old = {k: os.environ.get(k) for k in ("GIT_AUTHOR_DATE", "GIT_COMMITTER_DATE")}
    os.environ.update(GIT_AUTHOR_DATE=DATE, GIT_COMMITTER_DATE=DATE)
    try:
        repo, _ = j_synth_repo(path, 30_000, edit_frac=0.5, seed=9, blobs="promised")
        want = _theirs_branch(repo, 30_000, 9)
    finally:
        for k, v in old.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    return path, want


def test_blocks_from_dataset_match(merge_repo):
    path, _ = merge_repo
    jrepo, trepo = JRepo(path), TRepo(path)
    for rev in ("main", "theirs", "main^"):
        j = JBlock.from_dataset(jrepo.structure(rev).datasets["synth"])
        t = FeatureBlock.from_dataset(trepo.structure(rev).datasets["synth"])
        assert t.count == j.count and t.paths == j.paths
        assert np.array_equal(t.keys, j.keys) and np.array_equal(t.oids, j.oids)
        assert not t.has_key_collisions()
    ds = trepo.structure("main").datasets["synth"]
    assert ds.inner_path == jrepo.structure("main").datasets["synth"].inner_path
    for p in ("synth/.table-dataset/feature/A/A/A/A/x", "synth/.table-dataset/meta/title",
              "synth/metadata.xml", "other/.sno-dataset/feature/y", "top.txt"):
        assert trepo.structure("main").decode_path(p) == jrepo.structure("main").decode_path(p)


def test_merge_of_15000_conflicts_matches(merge_repo, tmp_path, monkeypatch):
    """do_merge in both packages on copies of one repo: the same counts,
    merged tree and MERGE_* files (KMIX2), dry run and not."""
    path, want = merge_repo
    monkeypatch.setenv("GIT_AUTHOR_DATE", DATE)
    monkeypatch.setenv("GIT_COMMITTER_DATE", DATE)
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(path, jpath)
    shutil.copytree(path, tpath)
    jrepo, trepo = JRepo(jpath), TRepo(tpath)
    for dry in (True, False):
        jr = j_do_merge(jrepo, "theirs", dry_run=dry)
        tr = t_do_merge(trepo, "theirs", dry_run=dry, device="cpu")
        assert tr.stats == jr.stats == want
        assert tr.merged_tree == jr.merged_tree and tr.has_conflicts
        assert len(tr.merge_index.conflicts) == want["conflicts"]
    for name in ("MERGE_HEAD", "MERGE_MSG", "MERGE_BRANCH", "MERGE_INDEX"):
        with open(os.path.join(jpath, ".kart", name), "rb") as a, \
                open(os.path.join(tpath, ".kart", name), "rb") as b:
            assert a.read() == b.read(), name
    assert _read(trepo).startswith(b"KMIX2\n")
    assert json.loads(_read(trepo)[10:10 + int.from_bytes(_read(trepo)[6:10], "little")])["n"] \
        == want["conflicts"]


def test_blob_columns_match_walk(tmp_path):
    """The feature walk's columns (fixed-width leaves read as one matrix,
    anything else entry by entry) equal the entry-by-entry walk: uniform
    int-pk leaves, names of several lengths, a subtree among blobs,
    multi-byte names, mixed modes, an empty tree."""
    _, trepo = _repos(tmp_path)
    odb = trepo.odb
    tb = TTreeBuilder(odb)
    oids = _blob_oids(odb, 40, "walk")
    names = ([f"int/A/{i:04d}" for i in range(8)] + [f"mixed/{'x' * (i % 3 + 1)}{i}" for i in range(8)]
             + [f"nest/f{i}" for i in range(4)] + [f"nest/sub/g{i}" for i in range(4)]
             + ["uni/é1", "uni/é2", "uni/ab"] + [f"modes/m{i}" for i in range(3)])
    for name, oid in zip(names, oids):
        tb.insert(name, oid)
    tb.insert("modes/x1", oids[-1], mode=0o100755)
    tb.insert("empty", odb.write_raw("tree", b""), mode=0o040000)
    view = trepo.odb.tree(tb.flush())
    paths, cols = view.blob_columns()
    walked = list(view.walk_blobs())
    assert paths == [p for p, _ in walked] and len(paths) == len(names) + 1
    assert cols.tobytes().hex() == "".join(e.oid for _, e in walked)
    int_leaf = trepo.odb.tree(view.get("int").oid)
    assert int_leaf.blob_columns()[0] == [p for p, _ in int_leaf.walk_blobs()]
