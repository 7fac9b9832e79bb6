"""The port's classify (K1's plain version, device="cpu") against kart_tpu's
TPU sort join on XLA-CPU and its numpy reference: zero tolerance. K1's
partition (the tile co-ranks) against the merged order of the reference's
stable sort."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kart_tpu.ops.blocks import FeatureBlock as RefBlock
from kart_tpu.ops.blocks import pack_oid_hex as ref_pack_oid_hex
from kart_tpu.ops.diff_kernel import (
    _classify_padded,
    _classify_padded_binsearch,
    _padded_arrays,
    classify_blocks_reference,
)
from kart_tpu.ops.diff_kernel import columnar_equal as ref_columnar_equal
from kart_tpu_torch.diff.engine import classify_changed
from kart_tpu_torch.ops.blocks import FeatureBlock, PAD_KEY, pack_oid_hex, unpack_oid_hex
from kart_tpu_torch.ops.diff_kernel import (
    TILE_ROWS,
    UNCHANGED,
    changed_indices,
    classify,
    classify_plain,
    columnar_equal,
    tile_coranks,
    tile_coranks_plain,
)

I64 = np.iinfo(np.int64)


def _oids(rng, n):
    return rng.integers(0, 2**32, size=(n, 5), dtype=np.uint64).astype(np.uint32)


def _edit(rng, keys, oids, n_upd, n_del, n_ins, word=None):
    """Second version of (keys, oids): updates flip one oid word (``word``,
    or rotating), deletes drop rows, inserts add unused keys."""
    oids2 = oids.copy()
    n = len(keys)
    rows = rng.permutation(n)
    upd, dele = rows[:n_upd], rows[n_upd : n_upd + n_del]
    for k, r in enumerate(upd):
        oids2[r, (k % 5) if word is None else word] ^= np.uint32(1 + k)
    keep = np.ones(n, dtype=bool)
    keep[dele] = False
    ins = np.setdiff1d(rng.integers(-(2**40), 2**40, size=4 * n_ins + 8), keys)[:n_ins]
    keys2 = np.concatenate([keys[keep], ins])
    oids2 = np.concatenate([oids2[keep], _oids(rng, len(ins))])
    order = np.argsort(keys2)
    return keys2[order], oids2[order]


def _case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    base = np.unique(rng.integers(-(2**40), 2**40, size=700))
    oids = _oids(rng, len(base))
    empty_k, empty_o = np.zeros(0, np.int64), np.zeros((0, 5), np.uint32)
    if name == "both_empty":
        return empty_k, empty_o, empty_k, empty_o
    if name == "all_insert":
        return empty_k, empty_o, base, oids
    if name == "all_delete":
        return base, oids, empty_k, empty_o
    if name == "identical":
        return base, oids, base.copy(), oids.copy()
    if name.startswith("word"):
        k2, o2 = _edit(rng, base, oids, 40, 0, 0, word=int(name[4:]))
        return base, oids, k2, o2
    if name == "disjoint":
        return base, oids, base + 2**41, oids
    if name == "extreme_keys":
        keys = np.array(
            [I64.min, I64.min + 1, -(2**62), -1, 0, 1, 2**62, int(PAD_KEY) - 1],
            dtype=np.int64,
        )
        o = _oids(rng, len(keys))
        o2 = o.copy()
        o2[[1, 4, 6]] ^= np.uint32(7)
        keep = np.array([1, 1, 0, 1, 1, 0, 1, 1], dtype=bool)
        return keys, o, keys[keep], o2[keep]
    if name.startswith("mixed"):
        k2, o2 = _edit(rng, base, oids, 30, 12, 15)
        return base, oids, k2, o2
    raise KeyError(name)


CASES = [
    "both_empty", "all_insert", "all_delete", "identical",
    "word0", "word1", "word2", "word3", "word4",
    "disjoint", "extreme_keys", "mixed0", "mixed1", "mixed2",
]


def _padded_tensors(keys, oids):
    """Bucket-padded tensors (count < length): PAD_KEY rows past count."""
    blk = FeatureBlock.from_arrays(keys, oids)
    return (
        torch.from_numpy(blk.keys.copy()),
        torch.from_numpy(blk.oids.view(np.int32).copy()),
        blk.count,
    )


@pytest.mark.parametrize("name", CASES)
def test_classify_matches_sort_join_and_reference(name):
    ok, oo, nk, no = _case(name)
    n_old, n_new = len(ok), len(nk)
    ref_old = RefBlock.from_arrays(ok, oo, [None] * n_old)
    ref_new = RefBlock.from_arrays(nk, no, [None] * n_new)
    a = _padded_arrays(ref_old)
    b = _padded_arrays(ref_new)
    s_old, s_new, _, s_counts = _classify_padded(a[0], a[1], b[0], b[1], n_old, n_new)
    s_old = np.asarray(s_old)[:n_old]
    s_new = np.asarray(s_new)[:n_new]
    r_old, r_new = classify_blocks_reference(ref_old, ref_new)

    tk, to, tn = _padded_tensors(ok, oo)
    uk, uo, un = _padded_tensors(nk, no)
    assert len(tk) > tn and len(uk) > un  # count < padded length
    old_class, new_class, counts = classify(tk, to, uk, uo, tn, un)
    np.testing.assert_array_equal(old_class.numpy(), s_old)
    np.testing.assert_array_equal(new_class.numpy(), s_new)
    np.testing.assert_array_equal(old_class.numpy(), r_old)
    np.testing.assert_array_equal(new_class.numpy(), r_new)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(s_counts))

    _, _, only = classify(tk, to, uk, uo, tn, un, counts_only=True)
    np.testing.assert_array_equal(only.numpy(), counts.numpy())


@pytest.mark.parametrize("name", CASES)
def test_classify_matches_binsearch_variant(name):
    """B2: kart_tpu's binary-search join (its XLA-CPU variant) over
    bucket-padded sides, padded tails and counts included, against K1's
    plain version over the same padded tensors."""
    ok, oo, nk, no = _case(name)
    n_old, n_new = len(ok), len(nk)
    a = _padded_arrays(RefBlock.from_arrays(ok, oo, [None] * n_old))
    b = _padded_arrays(RefBlock.from_arrays(nk, no, [None] * n_new))
    assert len(a[0]) > n_old and len(b[0]) > n_new
    s_old, s_new, _, s_counts = _classify_padded_binsearch(a[0], a[1], b[0], b[1], n_old, n_new)
    tk, to, tn = _padded_tensors(ok, oo)
    uk, uo, un = _padded_tensors(nk, no)
    np.testing.assert_array_equal(tk.numpy(), a[0])
    np.testing.assert_array_equal(uk.numpy(), b[0])
    old_class, new_class, counts = classify(tk, to, uk, uo, tn, un)
    np.testing.assert_array_equal(old_class.numpy(), np.asarray(s_old)[:n_old])
    np.testing.assert_array_equal(new_class.numpy(), np.asarray(s_new)[:n_new])
    # the padded tails: kart_tpu classes them unchanged, the port leaves them out
    assert not np.asarray(s_old)[n_old:].any() and not np.asarray(s_new)[n_new:].any()
    np.testing.assert_array_equal(counts.numpy(), np.asarray(s_counts))
    p_old, p_new, p_counts = classify_plain(tk[:tn], to[:tn], uk[:un], uo[:un])
    assert torch.equal(p_old, old_class) and torch.equal(p_new, new_class)
    assert torch.equal(p_counts, counts)


@pytest.mark.parametrize("seed", range(4))
def test_columnar_equal_matches_kart_tpu(seed):
    """B12: row equality over (C, N) columns with null masks: every column
    equal and the same null pattern (two nulls with different payloads are
    unequal, a null against a value with the same payload too)."""
    rng = np.random.default_rng(seed)
    c, n = 1 + seed, 500
    old = rng.integers(-3, 3, size=(c, n)).astype([np.int32, np.float32, np.int32, np.float32][seed])
    new = old.copy()
    flip = rng.random((c, n)) < 0.05
    new[flip] = new[flip] + 1
    if old.dtype == np.float32:
        old[:, 7] = np.nan
        new[:, 7] = np.nan
    m_old = rng.random((c, n)) < 0.1
    m_new = m_old.copy()
    m_new[:, :10] = ~m_new[:, :10]
    m_old[:, 20:25] = m_new[:, 20:25] = True
    new[:, 20:25] = old[:, 20:25] + 1  # both null, payloads differ
    want = np.asarray(ref_columnar_equal(old, new, m_old, m_new))
    got = columnar_equal(*(torch.from_numpy(x) for x in (old, new, m_old, m_new)))
    assert got.dtype == torch.bool and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[20:25].any() and not got[:10].any() and 0 < int(got.sum()) < n


@pytest.mark.parametrize("name", ["mixed0", "extreme_keys", "all_insert"])
def test_classify_changed_rows_and_hexes(name):
    ok, oo, nk, no = _case(name)
    old_block = FeatureBlock.from_arrays(ok, oo)
    new_block = FeatureBlock.from_arrays(nk, no)
    res = classify_changed(old_block, new_block, device="cpu")
    r_old, r_new = classify_blocks_reference(
        RefBlock.from_arrays(ok, oo, [None] * len(ok)),
        RefBlock.from_arrays(nk, no, [None] * len(nk)),
    )
    np.testing.assert_array_equal(res.old_idx, np.nonzero(r_old != UNCHANGED)[0])
    np.testing.assert_array_equal(res.new_idx, np.nonzero(r_new != UNCHANGED)[0])
    assert res.old_hex == [o.astype("<u4").tobytes().hex() for o in oo[res.old_idx]]
    assert res.new_hex == unpack_oid_hex(no[res.new_idx])
    assert res.counts == {
        "inserts": int((r_new == 1).sum()),
        "updates": int((r_old == 2).sum()),
        "deletes": int((r_old == 3).sum()),
    }


def test_changed_indices_and_plain_empty_sides():
    e = torch.zeros(0, dtype=torch.int64)
    eo = torch.zeros((0, 5), dtype=torch.int32)
    oc, nc, counts = classify_plain(e, eo, e, eo)
    assert oc.shape == (0,) and nc.shape == (0,) and counts.tolist() == [0, 0, 0]
    oi, ni = changed_indices(torch.tensor([0, 2, 3], dtype=torch.int8),
                             torch.tensor([1, 0], dtype=torch.int8))
    assert oi.tolist() == [1, 2] and ni.tolist() == [0]


@pytest.mark.parametrize("n", [0, 1, 57])
def test_oid_hex_packing_matches_reference(n):
    rng = np.random.default_rng(n)
    hexes = [bytes(rng.integers(0, 256, 20, dtype=np.uint8)).hex() for _ in range(n)]
    packed = pack_oid_hex(hexes)
    np.testing.assert_array_equal(packed, ref_pack_oid_hex(hexes))
    assert packed.shape == (n, 5) and packed.dtype == np.uint32
    assert unpack_oid_hex(packed) == hexes


def test_classify_rejects_bad_inputs():
    k = torch.zeros(3, dtype=torch.int64)
    o = torch.zeros((3, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        classify(k, o.to(torch.int64), k, o)
    with pytest.raises(ValueError):
        classify(k, o, k, o, old_count=4)
    with pytest.raises(ValueError):
        tile_coranks(k, k.to(torch.int32))
    with pytest.raises(ValueError):
        tile_coranks(k, k, new_count=4)


def _corank_case(name):
    """Sorted unique (old, new) int64 keys from a seed."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    base = np.unique(rng.integers(-(2**40), 2**40, size=3000))
    empty = np.zeros(0, np.int64)
    if name == "both_empty":
        return empty, empty
    if name == "old_empty":
        return empty, base
    if name == "new_empty":
        return base, empty
    if name == "equal":
        return base, base.copy()
    if name == "lead_insert":
        return base[1:], base
    if name == "disjoint_below":
        return base, base + 2**41
    if name == "disjoint_above":
        return base + 2**41, base
    if name == "interleaved":
        return base[::2].copy(), base[1::2].copy()
    if name == "extremes":
        ext = np.array([I64.min, I64.min + 1, -1, 0, 2**62, I64.max - 1], np.int64)
        return np.union1d(ext, base[::3]), np.union1d(ext[[0, 2, 5]], base[1::3])
    if name == "mixed":
        pick = rng.random((2, len(base))) < 0.8
        return base[pick[0]], base[pick[1]]
    raise KeyError(name)


CORANK_CASES = [
    "both_empty", "old_empty", "new_empty", "equal", "lead_insert",
    "disjoint_below", "disjoint_above", "interleaved", "extremes", "mixed",
]


@pytest.mark.parametrize("tile", [1, 2, 7, 64, TILE_ROWS])
@pytest.mark.parametrize("name", CORANK_CASES)
def test_tile_coranks_match_reference_sort_and_hold_halos(name, tile):
    old, new = _corank_case(name)
    n_old, n_new = len(old), len(new)
    total = n_old + n_new
    # the reference's merge order: lax.sort by (key, concat position)
    keys = jnp.asarray(np.concatenate([old, new]))
    _, order = jax.lax.sort((keys, jnp.arange(total, dtype=jnp.int32)), num_keys=2)
    old_before = np.concatenate([[0], np.cumsum(np.asarray(order) < n_old)])
    d = np.minimum(np.arange(-(-total // tile) + 1) * tile, total)

    got = tile_coranks_plain(torch.from_numpy(old), torch.from_numpy(new), tile)
    np.testing.assert_array_equal(got.numpy(), old_before[d])
    if tile == TILE_ROWS:
        np.testing.assert_array_equal(
            tile_coranks(torch.from_numpy(old), torch.from_numpy(new)).numpy(), got.numpy()
        )

    # halo rule: every partner of a tile's rows lies in the rows it loads
    i = got.numpy()
    j = d - i
    lb = np.searchsorted(new, old, side="left")
    match_in_old = np.searchsorted(old, new, side="right") - 1
    for t in range(len(d) - 1):
        assert i[t] <= i[t + 1] and j[t] <= j[t + 1]
        assert np.all((j[t] <= lb[i[t] : i[t + 1]]) & (lb[i[t] : i[t + 1]] <= j[t + 1]))
        m = match_in_old[j[t] : j[t + 1]]
        assert np.all((i[t] - 1 <= m) & (m <= i[t + 1] - 1))


def test_tile_coranks_count_slice_padding():
    """Rows past count (PAD_KEY padding) never move a co-rank."""
    old, new = _corank_case("extremes")
    tk, _, tn = _padded_tensors(old, np.zeros((len(old), 5), np.uint32))
    uk, _, un = _padded_tensors(new, np.zeros((len(new), 5), np.uint32))
    assert len(tk) > tn and len(uk) > un
    np.testing.assert_array_equal(
        tile_coranks(tk, uk, tn, un).numpy(),
        tile_coranks_plain(torch.from_numpy(old), torch.from_numpy(new)).numpy(),
    )
