"""The port's kernels against their plain versions on the card, at small
shapes and edge cases (empty sides, count < length, NaN/inf rows,
wrapping queries), and K1 and K4 fenced by sentinel bytes and repeated for
writes outside its outputs and races. Needs an sm_90 card and nvcc;
skipped elsewhere. On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from kart_tpu_torch import runtime
from kart_tpu_torch.diff.backend import envelope_scan, envelope_scan_plain
from kart_tpu_torch.diff.engine import feature_count, prefilter_rect, spatial_prefilter_blocks
from kart_tpu_torch.ops import _build, diff_kernel, merge_kernel
from kart_tpu_torch.ops.blocks import FeatureBlock
from kart_tpu_torch.ops.bbox import bbox_cyclic, bbox_cyclic_plain, pad_envelopes
from kart_tpu_torch.ops.merge_kernel import (
    SLICE_ROWS,
    merge_classify_sides,
    merge_classify_sides_plain,
    merge_tile_plan,
    merge_tile_plan_plain,
)
from kart_tpu_torch.ops.diff_kernel import (
    TILE_ROWS,
    classify,
    classify_blocks,
    classify_plain,
    tile_coranks,
    tile_coranks_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest -m cuda tests/test_torch_cuda.py")
    return torch.device("cuda", 0)


D = TILE_ROWS


def _keys(kind, rng, n_old, n_new):
    """Sorted unique (old, new) keys of one shape."""
    universe = np.unique(rng.integers(-(2**62), 2**62, size=2 * (n_old + n_new) + 16))
    if kind == "lead_insert":
        # identical key sets but one leading insert: pairs straddle the seams
        return universe[1:n_new], universe[:n_new]
    if kind == "below":
        # old entirely below new: tiles of deletes only, then inserts only
        return universe[:n_old], universe[n_old : n_old + n_new]
    if kind == "insert_run":
        # a run of n_new - n_old inserts, longer than a tile, inside old's range
        half, run = n_old // 2, n_new - n_old
        return np.concatenate([universe[:half], universe[half + run : n_old + run]]), universe[: n_old + run]
    if kind == "extremes":
        old, new = _keys("random", rng, n_old - 2, n_new - 2)
        lo, hi = np.int64(-(2**63)), np.int64(2**63 - 2)
        return np.concatenate([[lo], old, [hi]]), np.concatenate([[lo], new, [hi]])
    old = np.sort(rng.choice(universe, n_old, replace=False))
    shared = old[rng.random(n_old) < 0.8][:n_new]
    rest = np.setdiff1d(universe, old)
    new = np.sort(np.concatenate([shared, rng.choice(rest, n_new - len(shared), replace=False)]))
    return old, new


def _sides(kind, n_old, n_new):
    rng = np.random.default_rng(n_old + n_new)
    old, new = _keys(kind, rng, n_old, n_new)
    oo = rng.integers(0, 2**32, size=(len(old), 5), dtype=np.uint32)
    no = rng.integers(0, 2**32, size=(len(new), 5), dtype=np.uint32)
    pos = np.searchsorted(old, new)
    hit = (pos < len(old)) & (old[np.minimum(pos, len(old) - 1)] == new) if len(old) else np.zeros(len(new), bool)
    no[hit] = oo[pos[hit]]
    flip = np.flatnonzero(hit)[::7]
    no[flip, np.arange(len(flip)) % 5] ^= np.uint32(1)
    return old, oo, new, no


def _edited_sides(n):
    """Sides of chip_smoke.py phase [3]'s shape: ``n`` int pks with gaps,
    then 1% updates, 0.1% deletes and 0.1% inserts."""
    rng = np.random.default_rng(n)
    old = np.cumsum(rng.integers(1, 4, n)).astype(np.int64) + 1000
    oo = rng.integers(0, 2**32, size=(n, 5), dtype=np.uint32)
    rows = rng.permutation(n)
    upd, dele = rows[: n // 100], rows[n // 100 : n // 100 + n // 1000]
    no = oo.copy()
    no[upd, np.arange(len(upd)) % 5] ^= np.uint32(1)
    keep = np.ones(n, dtype=bool)
    keep[dele] = False
    free = np.flatnonzero(np.diff(old) > 1)
    ins = old[rng.choice(free, n // 1000, replace=False)] + 1
    new = np.concatenate([old[keep], ins])
    no = np.concatenate([no[keep], rng.integers(0, 2**32, size=(len(ins), 5), dtype=np.uint32)])
    order = np.argsort(new)
    return old, oo, new[order], no[order]


SHAPES = [
    ("random", 0, 0), ("random", 0, 300), ("random", 300, 0), ("random", 1, 1),
    ("random", 5000, 4800), ("random", 70_000, 71_000),
    # merged sizes k*D - 1, k*D, k*D + 1
    ("random", 1600, 3 * D - 1601), ("random", 1600, 3 * D - 1600), ("random", 1600, 3 * D - 1599),
    ("lead_insert", 5000, 5001), ("below", 3000, 2500), ("insert_run", 4000, 4000 + 3 * D),
    ("extremes", 2000, 2100),
]


@pytest.mark.parametrize("kind,n_old,n_new", SHAPES)
@pytest.mark.parametrize("pad", [0, 37])
def test_classify_kernel_matches_plain(cuda, kind, n_old, n_new, pad):
    ok, oo, nk, no = _sides(kind, n_old, n_new)
    n_old, n_new = len(ok), len(nk)

    def tensors(k, o):
        kt = torch.full((len(k) + pad,), 2**63 - 1, dtype=torch.int64)
        kt[: len(k)] = torch.from_numpy(k)
        ot = torch.zeros((len(k) + pad, 5), dtype=torch.int32)
        ot[: len(k)] = torch.from_numpy(o.view(np.int32))
        return kt.to(cuda), ot.to(cuda)

    a, b = tensors(ok, oo), tensors(nk, no)
    runtime.reset_stats()
    oc, nc, counts = classify(a[0], a[1], b[0], b[1], n_old, n_new)
    _, _, only = classify(a[0], a[1], b[0], b[1], n_old, n_new, counts_only=True)
    torch.cuda.synchronize()
    launched = runtime.stats_snapshot()["classify_launches"]
    assert launched == (0 if n_old + n_new == 0 else 2)
    po, pn, pc = classify_plain(a[0][:n_old], a[1][:n_old], b[0][:n_new], b[1][:n_new])
    assert torch.equal(oc, po) and torch.equal(nc, pn)
    assert torch.equal(counts, pc) and torch.equal(only, pc)
    assert torch.equal(tile_coranks(a[0], b[0], n_old, n_new),
                       tile_coranks_plain(a[0][:n_old], b[0][:n_new]))


GUARD = 4096  # sentinel bytes on each side of every buffer handed to K1
SENTINEL = 0xA5


class _Guarded:
    """A device buffer inside GUARD sentinel bytes a side."""

    def __init__(self, cuda, data):
        self.data = np.ascontiguousarray(data).view(np.uint8).ravel()
        whole = np.full(2 * GUARD + len(self.data), SENTINEL, dtype=np.uint8)
        whole[GUARD : GUARD + len(self.data)] = self.data
        self.whole = torch.from_numpy(whole).to(cuda)
        self.ptr = self.whole.data_ptr() + GUARD

    def body(self, dtype):
        return self.whole[GUARD : GUARD + len(self.data)].view(dtype)

    def guards_intact(self):
        w = self.whole.cpu().numpy()
        return bool((w[:GUARD] == SENTINEL).all() and (w[GUARD + len(self.data) :] == SENTINEL).all())


@pytest.mark.parametrize("kind,n_old,n_new", SHAPES[1:] + [("edited", 10_000_000, None)])
@pytest.mark.parametrize("counts_only", [False, True])
def test_classify_writes_only_its_outputs(cuda, kind, n_old, n_new, counts_only):
    """K1 launched straight from its library on buffers fenced by sentinel
    bytes, up to chip_smoke.py phase [3]'s 10M rows a side: no byte outside
    the outputs changes (inputs, co-rank scratch, classes and counts, each
    with its fences), and the outputs equal the plain version's."""
    ok, oo, nk, no = _edited_sides(n_old) if kind == "edited" else _sides(kind, n_old, n_new)
    n_old, n_new = len(ok), len(nk)
    inputs = [_Guarded(cuda, a) for a in (ok, oo, nk, no)]
    coranks = _Guarded(cuda, np.full(diff_kernel._n_tiles(n_old + n_new) + 1, -1, np.int64))
    counts = _Guarded(cuda, np.zeros(3, np.int64))
    classes = [_Guarded(cuda, np.full(n, 9, np.int8)) for n in (n_old, n_new)]
    lib = diff_kernel._library(cuda)
    rc = lib.kart_classify(
        inputs[0].ptr, inputs[1].ptr, n_old, inputs[2].ptr, inputs[3].ptr, n_new,
        coranks.ptr, None if counts_only else classes[0].ptr,
        None if counts_only else classes[1].ptr, counts.ptr, cuda.index,
        _build.stream_ptr(cuda),
    )
    _build.check(lib, rc, "classify")
    torch.cuda.synchronize()
    for g in (*inputs, coranks, counts, *classes):
        assert g.guards_intact()
    for g, a in zip(inputs, (ok, oo, nk, no)):
        assert np.array_equal(g.body(torch.uint8).cpu().numpy(), g.data)
    t = [torch.from_numpy(a).to(cuda) for a in (ok, oo.view(np.int32), nk, no.view(np.int32))]
    po, pn, pc = classify_plain(*t)
    assert torch.equal(counts.body(torch.int64), pc)
    assert torch.equal(coranks.body(torch.int64), tile_coranks_plain(t[0], t[2]))
    if counts_only:
        assert all((c.body(torch.int8) == 9).all() for c in classes)
    else:
        assert torch.equal(classes[0].body(torch.int8), po)
        assert torch.equal(classes[1].body(torch.int8), pn)


@pytest.mark.parametrize("kind,n_old,n_new", [("random", 70_000, 71_000), ("edited", 1_000_000, None)])
def test_classify_repeats_bit_for_bit(cuda, kind, n_old, n_new):
    """Twenty K1 launches in each mode on one input give one answer: a race
    on the tiles' shared memory would show as a launch that differs."""
    ok, oo, nk, no = _edited_sides(n_old) if kind == "edited" else _sides(kind, n_old, n_new)
    t = [torch.from_numpy(a).to(cuda) for a in (ok, oo.view(np.int32), nk, no.view(np.int32))]
    first = classify(*t)
    first_counts = classify(*t, counts_only=True)[2]
    for _ in range(20):
        oc, nc, counts = classify(*t)
        assert torch.equal(oc, first[0]) and torch.equal(nc, first[1])
        assert torch.equal(counts, first[2])
        assert torch.equal(classify(*t, counts_only=True)[2], first_counts)
    assert torch.equal(first_counts, first[2])


QUERIES = [
    (-73.123456789, -33.3333333333, 151.2222222222, 61.7777777777),
    (0.0, 0.0, 10.0, 10.0),
    (170.0, -60.0, -170.0, 60.0),
    (100.123456789, -10.1, 20.987654321, 45.5),
]


def _envelopes(seed, n):
    rng = np.random.default_rng(seed)
    lon = rng.uniform(-180, 180, n)
    lat = rng.uniform(-90, 90, n)
    env = np.stack([lon, lat, lon + rng.uniform(0, 20, n), lat + rng.uniform(0, 2, n)], 1)
    wrap = rng.random(n) < 0.05
    env[wrap, 0] = rng.uniform(160, 180, wrap.sum())
    env[wrap, 2] = rng.uniform(-180, -160, wrap.sum())
    return env.astype(np.float32)


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("n", [1, 1000, 300_001])
def test_envelope_scan_kernel_matches_plain(cuda, query, n):
    env = _envelopes(n, n)
    if query[2] >= query[0]:  # non-finite rows: non-wrapping queries only
        env[:4] = [[np.nan] * 4, [np.inf, 0, -np.inf, 1], [0, np.nan, 1, 1],
                   [-np.inf, -np.inf, np.inf, np.inf]][: min(4, n)]
    t = torch.from_numpy(env).to(cuda)
    assert torch.equal(envelope_scan(t, query), envelope_scan_plain(t, query))
    assert envelope_scan(t[:0], query).shape == (0,)


@pytest.mark.parametrize("query", QUERIES + [(-180.0, -90.0, 180.0, 90.0)])
@pytest.mark.parametrize("n", [1, 5000, 300_001])
def test_bbox_kernel_matches_plain(cuda, query, n):
    w, s, e, nn, count = pad_envelopes(_envelopes(n + 1, n))
    cols = [torch.from_numpy(c).to(cuda) for c in (w, s, e, nn)]
    got = bbox_cyclic(*cols, query, count)
    want = bbox_cyclic_plain(*cols, query)
    want[count:] = False
    assert torch.equal(got, want)
    # the count mask holds even where padding would match
    assert not bbox_cyclic(*cols, query, 0).any()


def _prefilter_pair(case):
    """Two int-pk blocks with envelopes, and a rect under which ``case``
    holds: no row survives, every row survives, or the two sides' hit-key
    sets differ (moved envelopes, inserts and deletes: the branch that
    propagates hits across sides)."""
    old, oo, new, no = _sides("random", 20_000, 19_000)
    rng = np.random.default_rng(7)
    env_old = _envelopes(3, len(old))
    env_new = _envelopes(4, len(new))
    pos = np.searchsorted(old, new)
    hit = (pos < len(old)) & (old[np.minimum(pos, len(old) - 1)] == new)
    env_new[hit] = env_old[pos[hit]]
    rect = (-60.5, -30.25, 60.75, 30.125)
    if case == "unequal":
        moved = np.flatnonzero(hit)[::11]
        env_new[moved] = _envelopes(5, len(moved))
    else:
        lo, hi = (200.0, 200.5) if case == "empty" else (-10.0, 10.0)
        for env in (env_old, env_new):
            env[:] = rng.uniform(lo, hi, size=(len(env), 1)).astype(np.float32)
            env[:, 2:] += np.float32(0.25)
        rect = (-170.0, -80.0, 170.0, 80.0)
    return (FeatureBlock(old, oo, len(old), envelopes=env_old),
            FeatureBlock(new, no, len(new), envelopes=env_new), prefilter_rect(rect))


@pytest.mark.parametrize("case", ["empty", "all", "unequal"])
def test_prefilter_and_classify_on_card_match_cpu(cuda, case):
    """spatial_prefilter_blocks and K1 on its compacted survivors, on the
    card against device="cpu": equal survivors, classes and counts, two K2
    launches and one K1 launch for the pair."""
    old, new, rect = _prefilter_pair(case)
    runtime.reset_stats()
    got = spatial_prefilter_blocks(old, new, rect, cuda)
    oc, nc, counts = classify_blocks(*got, cuda)
    torch.cuda.synchronize()
    launched = runtime.stats_snapshot()
    want = spatial_prefilter_blocks(old, new, rect, "cpu")
    for g, w in zip(got, want):
        assert g.count == w.count
        assert np.array_equal(g.keys, w.keys) and np.array_equal(g.oids, w.oids)
    survivors = got[0].count + got[1].count
    assert (survivors == 0) == (case == "empty")
    if case == "all":
        assert (got[0].count, got[1].count) == (old.count, new.count)
    wc = classify_blocks(*want, torch.device("cpu"))
    assert torch.equal(oc.cpu(), wc[0]) and torch.equal(nc.cpu(), wc[1])
    assert torch.equal(counts.cpu(), wc[2])
    assert launched["envelope_scan_launches"] == 2
    assert launched["classify_launches"] == (1 if survivors else 0)
    runtime.reset_stats()
    assert feature_count(old, new, rect, cuda) == int(wc[2].sum())
    assert runtime.stats_snapshot()["classify_counts_only_launches"] == (1 if survivors else 0)


# --- K4, the 3-way merge classify ---------------------------------------------

def _merge_sides(n_union, seed, empty=""):
    """Ancestor, ours and theirs (keys, oids) whose key union is exactly
    ``n_union`` keys (``empty``: the sides to leave empty, e.g. "a" or
    "aot"), each key in a random non-empty subset of the sides, with
    edits on ours and theirs (some the same), so every decision occurs."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(-(2**63), 2**63 - 1, size=2 * n_union + 8, dtype=np.int64))
    keys = np.sort(rng.choice(keys, n_union, replace=False)) if n_union else keys[:0]
    if n_union >= 4:
        keys[0], keys[-1] = -(2**63), 2**63 - 2  # beside PAD_KEY
        keys = np.sort(keys)
    live = [s for s in "aot" if s not in empty]
    masks = {s: np.zeros(n_union, bool) for s in "aot"}
    if live:
        pick = rng.integers(1, 2 ** len(live), size=n_union)
        for bit, s in enumerate(live):
            masks[s] = ((pick >> bit) & 1) == 1
    return _edited(rng, keys, [masks[s] for s in "aot"])


def _edited(rng, keys, masks):
    """(keys, oids) of each side for the rows ``masks`` keep of ``keys``:
    random ancestor oids, ours and theirs edit 30% of the rows (theirs a
    third of its edits as ours did)."""
    n = len(keys)
    base = rng.integers(0, 2**32, size=(n, 5), dtype=np.uint32)
    ours, theirs = base.copy(), base.copy()
    ours[rng.random(n) < 0.3, rng.integers(0, 5)] ^= np.uint32(1)
    edit_t = rng.random(n) < 0.3
    theirs[edit_t] = np.where(rng.random((edit_t.sum(), 1)) < 0.3, ours[edit_t], base[edit_t] ^ 2)
    return [(keys[m], o[m]) for m, o in zip(masks, (base, ours, theirs))]


def _merge_case(kind, n, seed):
    """Sides of one K4 shape. "random<empty>": :func:`_merge_sides` with a
    union of ``n`` keys; "rows": ``n`` rows a side, ours holding the
    ancestor's keys and theirs one key on (its first deleted, one inserted
    past the last), so equal keys on all sides straddle every tile seam;
    "range": the ancestor holds every key of a range of ``n``, ours every
    7th, theirs every 97th and 10 keys past it."""
    rng = np.random.default_rng(seed)
    if kind.startswith("random"):
        return _merge_sides(n, seed, kind[len("random"):])
    if kind == "rows":
        keys = np.cumsum(rng.integers(1, 3, n + 1)).astype(np.int64) - 2**40
        first, last = np.arange(n + 1) < n, np.arange(n + 1) > 0
        return _edited(rng, keys, [first, first, last])
    keys = np.arange(n + 10, dtype=np.int64) * 3 + 2**50
    idx = np.arange(n + 10)
    return _edited(rng, keys, [idx < n, (idx < n) & (idx % 7 == 0), (idx % 97 == 5) | (idx >= n)])


def _merge_tensors(cuda, sides, pad=0):
    """Each side's keys and oids on the card, ``pad`` PAD_KEY rows past its
    count. -> K4's nine side arguments."""
    args = []
    for k, o in sides:
        kt = torch.full((len(k) + pad,), 2**63 - 1, dtype=torch.int64)
        kt[: len(k)] = torch.from_numpy(k)
        ot = torch.zeros((len(k) + pad, 5), dtype=torch.int32)
        ot[: len(k)] = torch.from_numpy(np.ascontiguousarray(o).view(np.int32))
        args += [kt.to(cuda), ot.to(cuda), len(k)]
    return args


MERGE_SHAPES = [
    (1, ""), (0, "aot"), (255, ""), (256, ""), (257, ""), (511, ""), (512, ""), (513, ""),
    (1000, "a"), (1000, "o"), (1000, "t"), (1000, "ao"), (1000, "at"), (1000, "ot"),
    (70_001, ""), (2_440_000, ""),
]
#: K4's shapes: MERGE_SHAPES' unions, then S - 1, S, S + 1, 3S - 1, 3S, 3S + 1
#: and 4S rows a side (a slice holds at most S = SLICE_ROWS rows of a side),
#: one side holding every key of a range, and equal keys on every slice seam
#: at 2M rows a side (many tiles)
MERGE_CASES = (
    [(f"random{e}", n) for n, e in MERGE_SHAPES]
    + [("rows", n) for n in (SLICE_ROWS - 1, SLICE_ROWS, SLICE_ROWS + 1, 3 * SLICE_ROWS - 1,
                             3 * SLICE_ROWS, 3 * SLICE_ROWS + 1, 4 * SLICE_ROWS)]
    + [("range", 5000), ("range", 100_000), ("rows", 2_000_000)]
)


@pytest.mark.parametrize("kind,n", MERGE_CASES)
@pytest.mark.parametrize("pad", [0, 37])
def test_merge_classify_kernel_matches_plain(cuda, kind, n, pad):
    """K4 against its plain version on the card: union (also against
    np.unique), decision, presence and counts bit for bit, one launch a
    call; its tile plan against the plain plan."""
    sides = _merge_case(kind, n, n + 7 * pad)
    args = _merge_tensors(cuda, sides, pad)
    runtime.reset_stats()
    got = merge_classify_sides(*args)
    torch.cuda.synchronize()
    assert runtime.stats_snapshot()["merge_classify_launches"] == 1
    want = merge_classify_sides_plain(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert np.array_equal(got[0].cpu().numpy(), np.unique(np.concatenate([k for k, _ in sides])))
    keys = [(args[i], args[i + 2]) for i in (0, 3, 6)]
    plan = merge_tile_plan(*(x for kc in keys for x in kc))
    assert torch.equal(plan, merge_tile_plan_plain(*(k[:c] for k, c in keys)))


@pytest.mark.parametrize("kind,n", [("random", 1), ("random", 257), ("randoma", 1000),
                                    ("randomaot", 0), ("rows", SLICE_ROWS), ("range", 5000),
                                    ("random", 70_001), ("random", 2_440_000)])
def test_merge_classify_writes_only_its_outputs(cuda, kind, n):
    """K4 launched straight from its library on buffers fenced by sentinel
    bytes: no byte outside the first U rows of union, decision and
    presence, the counts and its scratch changes (the rows past U keep
    their sentinels), and the outputs equal the plain version's."""
    sides = _merge_case(kind, n, 3 * n + 1)
    total = sum(len(k) for k, _ in sides)
    inputs = [[_Guarded(cuda, k), _Guarded(cuda, np.ascontiguousarray(o)), len(k)]
              for k, o in sides]
    lib = merge_kernel._library(cuda)
    words = lib.kart_merge_scratch_words(*(len(k) for k, _ in sides))
    scratch = _Guarded(cuda, np.full(words, -1, np.int64))
    uni = _Guarded(cuda, np.full(total, 9, np.int64))
    decision = _Guarded(cuda, np.full(total, 9, np.int8))
    presence = _Guarded(cuda, np.full(total, 9, np.int8))
    counts = _Guarded(cuda, np.zeros(3, np.int64))
    args = []
    for k, o, c in inputs:
        args += [k.ptr if c else None, o.ptr if c else None, c]
    rc = lib.kart_merge_classify(*args, scratch.ptr, uni.ptr if total else None,
                                 decision.ptr if total else None, presence.ptr if total else None,
                                 counts.ptr, cuda.index, _build.stream_ptr(cuda))
    _build.check(lib, rc, "merge classify")
    torch.cuda.synchronize()
    for g in [*(x for k, o, _ in inputs for x in (k, o)), scratch, uni, decision, presence, counts]:
        assert g.guards_intact()
    want = merge_classify_sides_plain(*_merge_tensors(cuda, sides))
    u = len(want[0])
    c = counts.body(torch.int64)
    assert c[2].item() == u and torch.equal(c[:2], want[3])
    for g, w, dtype in ((uni, want[0], torch.int64), (decision, want[1], torch.int8),
                        (presence, want[2], torch.int8)):
        body = g.body(dtype)
        assert torch.equal(body[:u], w)
        assert (body[u:] == 9).all()


def test_merge_classify_repeats_bit_for_bit(cuda):
    """Twenty K4 launches on one input give one answer: the look-back's
    offsets and the atomics' counts do not depend on the order the tiles
    run in."""
    args = _merge_tensors(cuda, _merge_sides(1_000_003, 5))
    first = merge_classify_sides(*args)
    for _ in range(20):
        got = merge_classify_sides(*args)
        assert all(torch.equal(g, f) for g, f in zip(got, first))


def _hash_keys(rng, n):
    """``n`` sorted unique keys uniform over [0, 2^63), the way hash-keyed
    datasets key their rows, with 0 and 2^63 - 1 (the pad key's value)
    among them from 2 rows on."""
    keys = np.unique(rng.integers(0, 2**63 - 1, size=n + 8, dtype=np.int64))[:n]
    if n >= 2:
        keys[0], keys[-1] = 0, 2**63 - 1
        keys = np.unique(keys)
        while len(keys) < n:
            keys = np.unique(np.concatenate([keys, rng.integers(1, 2**63 - 1, size=n - len(keys),
                                                                dtype=np.int64)]))
    return keys


def _hash_sides(kind, n, seed):
    """Old and new (keys, oids) on hash keys: "edited" (1% of the rows
    updated, deleted and inserted), "empty_old" / "empty_new", "superset"
    (new holds every old key and as many more) and "disjoint"."""
    rng = np.random.default_rng(seed)
    keys = _hash_keys(rng, 2 * n)
    old = np.sort(rng.choice(keys, n, replace=False)) if n else keys[:0]
    if kind == "superset":
        new = keys
    elif kind == "disjoint":
        new = np.setdiff1d(keys, old)
    else:
        drop = rng.random(n) < 0.01
        new = np.union1d(old[~drop], rng.choice(np.setdiff1d(keys, old), n // 100, replace=False))
    if kind == "empty_old":
        old = old[:0]
    elif kind == "empty_new":
        new = new[:0]
    oo = rng.integers(0, 2**32, size=(len(old), 5), dtype=np.uint32)
    no = rng.integers(0, 2**32, size=(len(new), 5), dtype=np.uint32)
    pos = np.searchsorted(old, new)
    hit = (pos < len(old)) & (old[np.minimum(pos, max(len(old) - 1, 0))] == new) if len(old) \
        else np.zeros(len(new), bool)
    no[hit] = oo[pos[hit]]
    flip = np.flatnonzero(hit)[::100]
    no[flip, 0] ^= np.uint32(1)
    return old, oo, new, no


@pytest.mark.parametrize("kind,n", [("edited", 1), ("edited", 5000), ("edited", 1_000_000),
                                    ("empty_old", 3000), ("empty_new", 3000),
                                    ("superset", 70_000), ("disjoint", 70_000)])
def test_classify_on_hash_keys_repeats_bit_for_bit(cuda, kind, n):
    """K1 on keys uniform over [0, 2^63), 0 and 2^63 - 1 included: twenty
    launches in each mode, each bit-identical to the plain version."""
    ok, oo, nk, no = _hash_sides(kind, n, n + 1)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
         for a in (ok, oo.view(np.int32), nk, no.view(np.int32))]
    po, pn, pc = classify_plain(*t)
    for _ in range(20):
        oc, nc, counts = classify(*t)
        assert torch.equal(oc, po) and torch.equal(nc, pn) and torch.equal(counts, pc)
        assert torch.equal(classify(*t, counts_only=True)[2], pc)


def _hash_merge_sides(kind, n, seed):
    """Ancestor, ours and theirs on hash keys: "random<empty>" as
    :func:`_merge_sides` over uniform 63-bit keys (0 and 2^63 - 1 among
    them), or "full": ours holding every key, the ancestor and theirs a
    tenth of them each."""
    rng = np.random.default_rng(seed)
    keys = _hash_keys(rng, n)
    if kind == "full":
        masks = [rng.random(n) < 0.1, np.ones(n, bool), rng.random(n) < 0.1]
        return _edited(rng, keys, masks)
    live = [s for s in "aot" if s not in kind[len("random"):]]
    masks = {s: np.zeros(n, bool) for s in "aot"}
    if live:
        pick = rng.integers(1, 2 ** len(live), size=n)
        for bit, s in enumerate(live):
            masks[s] = ((pick >> bit) & 1) == 1
    return _edited(rng, keys, [masks[s] for s in "aot"])


@pytest.mark.parametrize("kind,n", [("random", 2), ("random", 5000), ("random", 2_440_000),
                                    ("randoma", 3000), ("randomot", 3000), ("randomaot", 0),
                                    ("full", 100_000)])
def test_merge_classify_on_hash_keys_repeats_bit_for_bit(cuda, kind, n):
    """K4 on keys uniform over [0, 2^63), 0 and 2^63 - 1 included, empty
    sides and one side holding every key: twenty launches, each
    bit-identical to the plain version, its union equal to np.unique."""
    sides = _hash_merge_sides(kind, n, n + 3)
    args = _merge_tensors(cuda, sides)
    want = merge_classify_sides_plain(*args)
    assert np.array_equal(want[0].cpu().numpy(), np.unique(np.concatenate([k for k, _ in sides])))
    for _ in range(20):
        got = merge_classify_sides(*args)
        assert all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))


# --- K5, the spatial join's envelope overlap, and K6, the exact refine -------

def _join_envelopes(seed, n, edge_cases=True):
    """Envelopes in a 20-degree square (points, boxes, 2% wrapping the
    anti-meridian), with NaN, -0.0, subnormal, infinite and edge-sharing
    rows."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(-10, 10, n)
    s = rng.uniform(-10, 10, n)
    env = np.stack([w, s, w + rng.uniform(0, 3, n) * (rng.random(n) < 0.7),
                    s + rng.uniform(0, 3, n) * (rng.random(n) < 0.7)], axis=1)
    wrap = rng.random(n) < 0.02
    env[wrap, 0] = rng.uniform(170, 180, wrap.sum())
    env[wrap, 2] = rng.uniform(-180, -170, wrap.sum())
    env = env.astype(np.float32)
    if edge_cases and n >= 16:
        env[0] = np.nan
        env[1] = (-0.0, -0.0, 0.0, 0.0)
        env[2] = (0.0, 0.0, 1e-45, 1e-45)
        env[3] = (-np.inf, -1.0, np.inf, 1.0)
        env[4] = (1.0, 1.0, 2.0, 2.0)
        env[5] = (2.0, 2.0, 3.0, 3.0)  # shares a corner with row 4
        env[6, 1] = np.nan
    return env


JOIN_SHAPES = [(1, 1), (16, 16), (1023, 129), (1024, 128), (1025, 5000), (4096, 65536),
               (4096, 12_288), (0, 100), (100, 0)]


@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("t,b", JOIN_SHAPES)
def test_envelope_join_kernel_matches_plain(cuda, t, b, pairs):
    from kart_tpu_torch.ops.envelope_join import envelope_join, envelope_join_plain

    build = torch.from_numpy(_join_envelopes(t + 1, t)).to(cuda)
    probe = torch.from_numpy(_join_envelopes(b + 2, b)).to(cuda)
    runtime.reset_stats()
    counts, total, got = envelope_join(build, probe, pairs=pairs)
    torch.cuda.synchronize()
    assert runtime.stats_snapshot()["envelope_join_launches"] == 1 + (pairs and total > 0)
    p_counts, p_total, want = envelope_join_plain(build, probe, pairs=pairs)
    assert counts.dtype == torch.int32 and torch.equal(counts, p_counts)
    assert total == p_total == int(p_counts.sum())
    if pairs:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert got is None


def test_envelope_join_repeats_and_refuses_misaligned_rows(cuda):
    from kart_tpu_torch.ops.envelope_join import envelope_join

    build = torch.from_numpy(_join_envelopes(3, 4096)).to(cuda)
    probe = torch.from_numpy(_join_envelopes(4, 65536)).to(cuda)
    first = envelope_join(build, probe, pairs=True)
    for _ in range(5):
        again = envelope_join(build, probe, pairs=True)
        assert torch.equal(again[0], first[0]) and again[1] == first[1]
        assert torch.equal(again[2][0], first[2][0]) and torch.equal(again[2][1], first[2][1])
    flat = torch.from_numpy(_join_envelopes(5, 101)).to(cuda).reshape(-1)
    with pytest.raises(ValueError, match="aligned"):
        envelope_join(build, flat[1:401].reshape(100, 4))


def _refine_case(kind, n_pairs, seed):
    from kart_tpu_torch.geom import boxes_vertex_column
    from kart_tpu_torch.synth import synth_shapes

    rng = np.random.default_rng(seed)
    if kind == "boxes":
        env = _join_envelopes(seed, 64, edge_cases=False).astype(np.float64)
        col_a = col_b = boxes_vertex_column(env)
    elif kind == "edge":
        col_a = col_b = synth_shapes(200, seed=seed, span=2.0, max_segments=8)
    else:
        col_a = synth_shapes(300, seed=seed)
        col_b = synth_shapes(300, seed=seed + 1)
    ia = rng.integers(0, len(col_a), n_pairs)
    ib = rng.integers(0, len(col_b), n_pairs)
    usable = col_a.usable()[ia] & col_b.usable()[ib]
    return col_a, ia[usable], col_b, ib[usable]


@pytest.mark.parametrize("kind,n_pairs", [("boxes", 5000), ("edge", 20_000), ("stars", 1),
                                          ("stars", 3000), ("stars", 0)])
def test_geom_refine_kernel_matches_plain(cuda, kind, n_pairs):
    from kart_tpu_torch.ops.geom_refine import geom_refine, geom_refine_plain, resident_segments

    col_a, ia, col_b, ib = _refine_case(kind, n_pairs, 7)
    seg_a, seg_b = resident_segments(col_a, cuda), resident_segments(col_b, cuda)
    ia_t, ib_t = torch.from_numpy(ia).to(cuda), torch.from_numpy(ib).to(cuda)
    runtime.reset_stats()
    got = geom_refine(seg_a, ia_t, seg_b, ib_t)
    torch.cuda.synchronize()
    assert runtime.stats_snapshot()["geom_refine_launches"] == (1 if len(ia) else 0)
    want = geom_refine_plain(seg_a, ia_t, seg_b, ib_t)
    assert got.dtype == torch.bool and torch.equal(got, want)
    if len(ia) > 100:
        assert bool(want.any()) and not bool(want.all())
    for _ in range(3):
        assert torch.equal(geom_refine(seg_a, ia_t, seg_b, ib_t), want)


#: K5 at slicings the join's batches reach: t not a multiple of the slice,
#: one probe row, a 12,288-row batch, a pair total of 0 and pairs in
#: row-major order across slice boundaries
SLICE_CASES = [("random", 4095, 12_288), ("random", 4097, 65_536), ("random", 1000, 1),
               ("random", 4096, 1), ("random", 33, 70_001), ("disjoint", 4096, 12_288),
               ("all", 4096, 3000), ("all", 1025, 513)]


@pytest.mark.parametrize("kind,t,b", SLICE_CASES)
def test_envelope_join_kernel_across_slices(cuda, kind, t, b):
    from kart_tpu_torch.ops._build import sm_count
    from kart_tpu_torch.ops.envelope_join import envelope_join, envelope_join_plain, tile_slices

    build = _join_envelopes(t + 3, t)
    probe = _join_envelopes(b + 4, b)
    if kind == "disjoint":  # the probe side 100 degrees north-east of the build side
        probe[:, :4] = np.abs(probe[:, :4]) + np.float32(100)
    elif kind == "all":  # every row meets every row: pairs cross every slice
        build[:] = (-1.0, -1.0, 1.0, 1.0)
        build[::7] = (170.0, -1.0, -170.0, 1.0)  # wrapping rows meet them too
        probe[:] = (-180.0, -1.0, 180.0, 1.0)
    build_t, probe_t = torch.from_numpy(build).to(cuda), torch.from_numpy(probe).to(cuda)
    slice_rows, n_slices = tile_slices(t, b, sm_count(cuda))
    assert (n_slices - 1) * slice_rows < t <= n_slices * slice_rows
    counts, total, got = envelope_join(build_t, probe_t, pairs=True)
    p_counts, p_total, want = envelope_join_plain(build_t, probe_t, pairs=True)
    assert torch.equal(counts, p_counts) and total == p_total
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if kind == "disjoint":
        assert total == 0 and len(got[0]) == 0
    if kind == "all":
        assert total == t * b and n_slices > 1


def _concat_columns(c1, c2):
    from kart_tpu_torch.geom import VertexColumn

    return VertexColumn(np.concatenate([c1.kinds, c2.kinds]),
                        np.concatenate([c1.feat_offsets, c2.feat_offsets[1:] + c1.feat_offsets[-1]]),
                        np.concatenate([c1.ring_offsets, c2.ring_offsets[1:] + c1.ring_offsets[-1]]),
                        np.concatenate([c1.x, c2.x]), np.concatenate([c1.y, c2.y]))


def _ring(n, r, closed, cx=0.0, cy=0.0):
    from kart_tpu_torch.geom import KIND_LINE, KIND_POLY, VertexColumn

    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    x = np.rint((cx + r * np.cos(ang)) * 1e5).astype(np.int32)
    y = np.rint((cy + r * np.sin(ang)) * 1e5).astype(np.int32)
    if not closed:  # a polyline of n + 1 vertices: n segments
        x, y = np.append(x, x[0] + 7), np.append(y, y[0])
    return VertexColumn(np.asarray([KIND_POLY if closed else KIND_LINE], np.uint8),
                        np.asarray([0, 1]), np.asarray([0, len(x)]), x, y)


def _refine_regime(kind, seed):
    """K6's regimes: 3,600 box x box pairs whose envelopes overlap (the
    join's batch) and 400 drawn at random, one 256 x 256-segment false pair both ways round, and a
    draw mixing box pairs and star pairs in one call."""
    from kart_tpu_torch.geom import boxes_vertex_column
    from kart_tpu_torch.synth import synth_shapes

    rng = np.random.default_rng(seed)
    if kind == "box_batch":
        env = _join_envelopes(seed, 3000, edge_cases=False).astype(np.float64)
        col = boxes_vertex_column(env)
        w, s, e, n = (env[:, k] for k in range(4))
        hit = ((w[:, None] <= e[None, :]) & (w[None, :] <= e[:, None])
               & (s[:, None] <= n[None, :]) & (s[None, :] <= n[:, None]))
        ia, ib = np.nonzero(hit & col.usable()[:, None] & col.usable()[None, :])
        pick = rng.choice(len(ia), min(3600, len(ia)), replace=False)
        # and 400 pairs whose envelopes mostly miss, for false verdicts
        ok = np.flatnonzero(col.usable())
        ia = np.concatenate([ia[pick], rng.choice(ok, 400)])
        ib = np.concatenate([ib[pick], rng.choice(ok, 400)])
        return col, ia, col, ib
    if kind == "long_false":
        # a polygon of 256 segments inside a polyline of 256 around it
        col = _concat_columns(_ring(256, 1.0, True), _ring(256, 1.5, False))
        return col, np.asarray([0, 1]), col, np.asarray([1, 0])
    boxes = boxes_vertex_column(_join_envelopes(seed, 500, edge_cases=False).astype(np.float64))
    col = _concat_columns(boxes, synth_shapes(500, seed=seed, span=20.0))
    ia, ib = rng.integers(0, len(col), 20_000), rng.integers(0, len(col), 20_000)
    usable = col.usable()[ia] & col.usable()[ib]
    return col, ia[usable], col, ib[usable]


@pytest.mark.parametrize("kind", ["box_batch", "long_false", "mixed"])
def test_geom_refine_kernel_regimes(cuda, kind):
    from kart_tpu_torch.ops.geom_refine import geom_refine, geom_refine_plain, resident_segments

    col_a, ia, col_b, ib = _refine_regime(kind, 11)
    seg_a, seg_b = resident_segments(col_a, cuda), resident_segments(col_b, cuda)
    ia_t, ib_t = torch.from_numpy(ia).to(cuda), torch.from_numpy(ib).to(cuda)
    runtime.reset_stats()
    got = geom_refine(seg_a, ia_t, seg_b, ib_t)
    torch.cuda.synchronize()
    assert runtime.stats_snapshot()["geom_refine_launches"] == 1
    want = geom_refine_plain(seg_a, ia_t, seg_b, ib_t)
    assert torch.equal(got, want)
    if kind == "long_false":
        assert not bool(want.any())
        sizes = np.diff(col_a.segment_table()[4])
        assert sizes.tolist() == [256, 256]
    else:
        assert bool(want.any()) and not bool(want.all())
    if kind == "mixed":
        cells = np.diff(col_a.segment_table()[4])
        assert (cells[ia] <= 8).any() and (cells[ia] > 8).any()


def test_geom_refine_kernel_on_cull_boundaries(cuda):
    """The cases' pinned verdicts through both kernels: the short pairs and,
    with a side of more than SHORT_SEGMENTS segments, the long kernel."""
    from torch_refine_cases import EXPECTED, LONG, all_pairs, cases_column, open_chain_tables

    from kart_tpu_torch.ops.geom_refine import (
        SHORT_SEGMENTS,
        geom_refine,
        geom_refine_plain,
        resident_segments,
    )

    col, names = cases_column()
    sizes = np.diff(col.segment_table()[4])
    long_names = set(LONG.values())
    assert all(sizes[names.index(n)] > SHORT_SEGMENTS for n in long_names)
    assert sum(bool({a, b} & long_names) for a, b in EXPECTED) * 2 > len(EXPECTED)
    ia, ib = (torch.from_numpy(v).to(cuda) for v in all_pairs(len(col)))
    seg = resident_segments(col, cuda)
    got = geom_refine(seg, ia, seg, ib)
    assert torch.equal(got, geom_refine_plain(seg, ia, seg, ib))
    at = {name: i for i, name in enumerate(names)}
    verdicts = got.cpu().numpy()
    for (a, b), verdict in EXPECTED.items():
        assert bool(verdicts[at[a] * len(col) + at[b]]) is verdict, (a, b)
    seg_a, seg_b = open_chain_tables(cuda)
    idx = torch.zeros(1, dtype=torch.int64, device=cuda)
    assert geom_refine(seg_a, idx, seg_b, idx).tolist() == [True]
    assert geom_refine_plain(seg_a, idx, seg_b, idx).tolist() == [True]


def test_query_join_on_card_matches_cpu(cuda, tmp_path):
    """A time-travel join and a --bbox scan through the CLI on the card and
    with --device cpu: the same bytes, and K2, K5 and K6 launched."""
    import contextlib
    import io

    from kart_tpu_torch.cli import main as port_main
    from kart_tpu_torch.synth import synth_repo

    repo, _ = synth_repo(str(tmp_path / "r"), 20_000, spatial=True, seed=3)
    for argv in (["query", "HEAD", "synth", "--intersects", "HEAD^:synth"],
                 ["query", "HEAD", "synth", "--bbox", "-60,-30,60,30"]):
        outs = []
        for pre in ([], ["--device", "cpu"]):
            runtime.reset_stats()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert port_main([*pre, "-C", repo.workdir, *argv]) == 0
            outs.append(buf.getvalue())
            stats = runtime.stats_snapshot()
            if not pre:
                assert stats["geom_refine_launches"] > 0
                key = "envelope_join_launches" if "--intersects" in argv else "envelope_scan_launches"
                assert stats[key] > 0
        assert outs[0] == outs[1]


def test_projected_filtered_diff_on_card_matches_cpu(cuda, tmp_path):
    """An NZTM (EPSG:2193) point layer under an NZTM filter through the CLI
    on the card and with --device cpu: the same bytes (which
    tests/test_torch_spatial_index.py holds to kart_tpu's on this layer),
    two K2 launches (one a side) and one K1 launch a command."""
    import contextlib
    import io

    from kart_tpu_torch.cli import main as port_main
    from kart_tpu_torch.core.repo import KartRepo
    from kart_tpu_torch.spatial_filter import ResolvedSpatialFilterSpec
    from kart_tpu_torch.synth import synth_repo

    repo, _ = synth_repo(str(tmp_path / "r"), 20_000, spatial=True, seed=3, crs="EPSG:2193")
    KartRepo(repo.workdir).config.set_many(ResolvedSpatialFilterSpec.from_spec_string(
        "EPSG:2193;POLYGON((1090000 4740000,2100000 4740000,2100000 6200000,1090000 6200000,"
        "1090000 4740000))").config_items())
    for argv in (["diff", "-o", "json-lines", "HEAD^...HEAD"],
                 ["diff", "-o", "feature-count", "HEAD^...HEAD"],
                 ["diff", "-o", "geojson", "--crs", "EPSG:3857", "HEAD^...HEAD"]):
        outs = []
        for pre in ([], ["--device", "cpu"]):
            runtime.reset_stats()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert port_main([*pre, "-C", repo.workdir, *argv]) == 0
            outs.append(buf.getvalue())
            stats = runtime.stats_snapshot()
            want = (2, 1) if not pre else (0, 0)
            assert (stats["envelope_scan_launches"], stats["classify_launches"]) == want
        assert outs[0] == outs[1]
    assert '"type":"feature"' in outs[0] or "Feature" in outs[0]


def _merc_rows(rng, n):
    """(n, 4) f64 wsen rows over the world, then the projection's edges: the
    poles, the mercator clamp exactly, -0.0, subnormals, NaN, infinities."""
    from kart_tpu_torch.tiles.grid import MERC_MAX_LAT as m

    world = np.stack([rng.uniform(-180, 180, n), rng.uniform(-90, 90, n),
                      rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)], axis=1)
    edge = np.array([(-180.0, -90.0, 180.0, 90.0), (0.0, m, 0.0, -m), (-0.0, -0.0, 0.0, 0.0),
                     (5e-324, -5e-324, 1e-310, -1e-310), (np.nan, np.nan, np.nan, np.nan),
                     (np.inf, np.inf, -np.inf, -np.inf), (-np.inf, -m, np.inf, m)])
    return np.ascontiguousarray(np.concatenate([world, edge]))


@pytest.mark.parametrize("n", [0, 1, 255, 257, 100_000, 2_000_003])
def test_merc_kernel_matches_plain(cuda, n):
    """K7 against its plain version on the card, bit for bit, one launch a
    call (none for an empty batch)."""
    from kart_tpu_torch.ops.merc import merc, merc_plain

    rows = _merc_rows(np.random.default_rng(n), n) if n else np.zeros((0, 4))
    env = torch.from_numpy(rows).to(cuda)
    runtime.reset_stats()
    got = merc(env)
    torch.cuda.synchronize()
    assert runtime.stats_snapshot()["merc_launches"] == (1 if len(rows) else 0)
    want = merc_plain(env)
    assert got.shape == (4, len(rows)) and got.dtype == torch.float64
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    for _ in range(2):
        assert torch.equal(merc(env).view(torch.int64), want.view(torch.int64))


def test_merc_refuses_misaligned_rows_and_projects_through_the_seam(cuda):
    from kart_tpu_torch.diff.backend import project_envelopes
    from kart_tpu_torch.ops.merc import merc, merc_plain
    from kart_tpu_torch.tiles.clip import _host_merc, quantize_from_merc

    rows = _merc_rows(np.random.default_rng(1), 1000)
    buf = torch.zeros(rows.size + 1, dtype=torch.float64, device=cuda)
    env = buf[1:].view(-1, 4)
    env.copy_(torch.from_numpy(rows))
    with pytest.raises(ValueError):
        merc(env)
    runtime.reset_stats()
    cols = project_envelopes(rows)
    assert runtime.stats_snapshot()["merc_launches"] == 1
    want = merc_plain(torch.from_numpy(rows).to(cuda)).cpu().numpy()
    assert all(np.array_equal(c.view(np.int64), w.view(np.int64)) for c, w in zip(cols, want))
    ok = np.isfinite(rows).all(axis=1)
    for z in (0, 9, 21, 30):
        sel = rows[ok]
        x = y = (1 << z) // 2
        assert np.array_equal(
            quantize_from_merc(sel, tuple(c[ok] for c in cols), z, x, y),
            quantize_from_merc(sel, _host_merc(sel), z, x, y))


def test_export_on_card_matches_cpu(cuda, tmp_path):
    """kart export tiles through the CLI on the card (--workers 1: K7 once a
    batch with a tile) and with --device cpu: the same files and output."""
    import contextlib
    import io

    from kart_tpu_torch.cli import main as port_main
    from kart_tpu_torch.synth import synth_repo
    from kart_tpu_torch.tiles.pyramid import tree_digest

    repo, _ = synth_repo(str(tmp_path / "r"), 20_000, spatial=True, seed=3)
    outs = []
    for pre in ([], ["--device", "cpu"]):
        runtime.reset_stats()
        out_dir = str(tmp_path / f"t{len(outs)}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert port_main([*pre, "-C", repo.workdir, "export", "tiles", "--zoom", "0-4",
                              "--layers", "bin,ktb2,mvt,geom", "--workers", "1",
                              "-o", out_dir]) == 0
        launches = runtime.stats_snapshot()["merc_launches"]
        assert launches > 0 if not pre else launches == 0
        outs.append((tree_digest(out_dir), buf.getvalue().replace(out_dir, "<out>")))
    assert outs[0] == outs[1]


def test_export_default_on_card_launches_k7(cuda, tmp_path, monkeypatch):
    """kart export tiles on the card without --workers encodes in this
    process: one K7 launch a batch with a tile to write, one worker in the
    stdout line, and the files of --device cpu's default pool."""
    import contextlib
    import io
    import os
    import re

    from kart_tpu_torch.cli import main as port_main
    from kart_tpu_torch.synth import synth_repo
    from kart_tpu_torch.tiles.pyramid import batched, tile_cover, tree_digest
    from kart_tpu_torch.tiles.source import source_for

    monkeypatch.delenv("KART_EXPORT_WORKERS", raising=False)
    repo, _ = synth_repo(str(tmp_path / "r"), 20_000, spatial=True, seed=4)
    outs = []
    for pre in ([], ["--device", "cpu"]):
        runtime.reset_stats()
        out_dir = str(tmp_path / f"t{len(outs)}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert port_main([*pre, "-C", repo.workdir, "export", "tiles", "--zoom", "0-4",
                              "--layers", "bin,mvt", "-o", out_dir]) == 0
        outs.append((tree_digest(out_dir), buf.getvalue().replace(out_dir, "<out>"),
                     runtime.stats_snapshot()["merc_launches"]))
    written = {tuple(int(p) for p in os.path.relpath(os.path.join(d, n)[: -len(".ktile")],
                                                      tmp_path / "t0").split(os.sep))
               for d, _, names in os.walk(tmp_path / "t0") for n in names}
    source = source_for(repo, repo.resolve_refish("HEAD")[0], "synth")
    want = sum(any(a in written for a in b) for b in batched(tile_cover(source, range(5)), 64))
    assert outs[0][2] == want > 0 and outs[1][2] == 0
    assert outs[0][0] == outs[1][0]
    assert outs[0][1].endswith("; 1 workers]\n")
    strip = re.compile(r"; \d+ workers\]")
    assert strip.sub("", outs[0][1]) == strip.sub("", outs[1][1])


# --- the streamed routes (B1s, B6s) --------------------------------------------------------

STREAM_CASES = [("edited", 200_000, 1000), ("edited", 1_000_000, 250_000),
                ("edited", 1_000_000, 10**9), ("below", 3000, 700), ("random", 70_000, 9_000)]


def _stream_blocks(kind, n):
    old, oo, new, no = _edited_sides(n) if kind == "edited" else _sides(kind, n, n)
    return (FeatureBlock.from_arrays(old, oo, pad=False),
            FeatureBlock.from_arrays(new, no, pad=False))


@pytest.mark.parametrize("kind,n,chunk", STREAM_CASES)
@pytest.mark.parametrize("counts_only", [False, True])
def test_classify_streamed_matches_monolithic(cuda, monkeypatch, kind, n, chunk, counts_only):
    """B1s on the card: one K1 launch a chunk, classes (on the host) and
    counts equal to one monolithic launch and to the CPU's streamed route;
    the timings split is filled."""
    old, new = _stream_blocks(kind, n)
    _, (_, n_chunks) = diff_kernel.block_splits((old, new), chunk)
    timings = {}
    runtime.reset_stats()
    got = diff_kernel.classify_blocks_streamed(old, new, cuda, chunk_rows=chunk,
                                               counts_only=counts_only, timings=timings)
    assert runtime.stats_snapshot()["classify_launches"] == n_chunks == timings["chunks"]
    monkeypatch.setenv("KART_TORCH_STREAM_MIN_ROWS", str(10**12))
    want = classify_blocks(old, new, cuda, counts_only=counts_only)
    cpu = diff_kernel.classify_blocks_streamed(old, new, torch.device("cpu"), chunk_rows=chunk,
                                               counts_only=counts_only)
    for g, w, c in zip(got, want, cpu):
        if w is None:
            assert g is None and c is None
            continue
        assert g.device.type == "cpu" and torch.equal(g, w.cpu()) and torch.equal(g, c)
    assert {"pinned_alloc_s", "staging_s", "h2d_ms", "k1_ms", "wall_s"} <= set(timings)
    assert ("d2h_ms" in timings) != counts_only


def test_classify_routes_through_the_stream_on_the_card(cuda, monkeypatch):
    old, new = _stream_blocks("edited", 300_000)
    monkeypatch.setenv("KART_TORCH_STREAM_MIN_ROWS", "1")
    monkeypatch.setenv("KART_TORCH_STREAM_CHUNK_ROWS", "70000")
    _, (_, n_chunks) = diff_kernel.block_splits((old, new))
    assert n_chunks >= 4
    runtime.reset_stats()
    got = feature_count(old, new, device="cuda")
    assert runtime.stats_snapshot()["classify_launches"] == n_chunks
    assert got == feature_count(old, new, device="cpu")


def test_classify_streamed_repeats_bit_for_bit(cuda):
    old, new = _stream_blocks("edited", 1_000_000)
    first = diff_kernel.classify_blocks_streamed(old, new, cuda, chunk_rows=100_000)
    for _ in range(3):
        again = diff_kernel.classify_blocks_streamed(old, new, cuda, chunk_rows=100_000)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind,n,chunk", [("random", 70_001, 5000), ("rows", 2_000_000, 300_000),
                                          ("rows", 2_000_000, 10**9), ("randomao", 1000, 100),
                                          ("range", 100_000, 7_000)])
def test_merge_streamed_matches_monolithic(cuda, monkeypatch, kind, n, chunk):
    """B6s on the card: one K4 launch a chunk; union, decision, presence and
    counts equal to one monolithic launch, to ``np.unique`` and to the CPU's
    streamed route."""
    sides = _merge_case(kind, n, n)
    blocks = [FeatureBlock.from_arrays(k, o, pad=False) for k, o in sides]
    _, (_, n_chunks) = diff_kernel.block_splits(blocks, chunk)
    runtime.reset_stats()
    got = merge_kernel.merge_classify_streamed(*blocks, cuda, chunk_rows=chunk, timings={})
    assert runtime.stats_snapshot()["merge_classify_launches"] == n_chunks
    monkeypatch.setenv("KART_TORCH_STREAM_MIN_ROWS", str(10**12))
    want = merge_kernel.merge_classify(*blocks, "cuda")
    cpu = merge_kernel.merge_classify_streamed(*blocks, torch.device("cpu"), chunk_rows=chunk)
    for g, w, c in zip(got[:3], want[:3], cpu[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w) and np.array_equal(g, c)
    assert got[3] == want[3] == cpu[3]
    assert np.array_equal(got[0], np.unique(np.concatenate([k for k, _ in sides])))
    monkeypatch.setenv("KART_TORCH_STREAM_MIN_ROWS", "1")
    monkeypatch.setenv("KART_TORCH_STREAM_CHUNK_ROWS", str(chunk))
    runtime.reset_stats()
    routed = merge_kernel.merge_classify(*blocks, "cuda")
    assert runtime.stats_snapshot()["merge_classify_launches"] == n_chunks
    for g, r in zip(got[:3], routed[:3]):
        assert np.array_equal(g, r)


@pytest.mark.parametrize("dtype", [torch.int64, torch.float32])
def test_columnar_equal_on_card_matches_cpu(cuda, dtype):
    rng = np.random.default_rng(3)
    old = torch.from_numpy(rng.integers(-2, 2, size=(8, 100_003))).to(dtype)
    new = old.clone()
    new[rng.random((8, 100_003)) < 0.01] += 1
    masks = [torch.from_numpy(rng.random((8, 100_003)) < 0.02) for _ in range(2)]
    want = diff_kernel.columnar_equal(old, new, *masks)
    got = diff_kernel.columnar_equal(*(t.to(cuda) for t in (old, new, *masks)))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n", [0, 5000, 1_000_000])
def test_one_chunk_route_below_the_row_knob(cuda, monkeypatch, n):
    """Below the row knob the card's classify and merge run their driver in
    one chunk: one launch, one staging slot, results on the host equal to
    the CPU's, and the split filled on the real route."""
    from kart_tpu_torch.ops import blocks

    monkeypatch.setenv("KART_TORCH_STREAM_MIN_ROWS", str(10**12))
    old, new = _stream_blocks("edited", n) if n else (
        FeatureBlock.from_arrays(np.zeros(0, np.int64), np.zeros((0, 5), np.uint32), pad=False),) * 2
    slots = []
    real = blocks.StreamStager.__init__

    def spy(self, *a, **k):
        real(self, *a, **k)
        slots.append(self.slots)

    monkeypatch.setattr(blocks.StreamStager, "__init__", spy)
    timings = {}
    runtime.reset_stats()
    got = classify_blocks(old, new, cuda, timings=timings)
    assert runtime.stats_snapshot()["classify_launches"] == (1 if n else 0) and slots == [1]
    want = classify_blocks(old, new, torch.device("cpu"))
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and torch.equal(g, w)
    assert timings["chunks"] == 1 and "pinned_alloc_s" in timings
    assert ({"staging_s", "h2d_ms"} <= set(timings)) == bool(n)
    m_timings = {}
    runtime.reset_stats()
    merged = merge_kernel.merge_classify(old, new, new, "cuda", timings=m_timings)
    assert runtime.stats_snapshot()["merge_classify_launches"] == 1 and slots == [1, 1]
    plain = merge_kernel.merge_classify(old, new, new, "cpu")
    for g, w in zip(merged[:3], plain[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert merged[3] == plain[3]
    assert m_timings["chunks"] == 1 and {"landing_s", "d2h_ms", "k4_ms"} <= set(m_timings)


def _point_history_on(path, n=20_000, commits=3, seed=5):
    """The port's point layer and ``commits`` commits of
    ``commit_point_edits`` (no sidecars). -> (repo, tips from the layer's
    edit commit on)."""
    from kart_tpu_torch.synth import commit_point_edits, synth_repo

    repo, info = synth_repo(path, n, seed=seed, blobs="changed", spatial=True)
    rng = np.random.default_rng(seed)
    live = np.arange(1 << 24, (1 << 24) + n, dtype=np.int64)
    tips = [info["edit_commit"]]
    for c in range(commits):
        pick = rng.choice(len(live), 30, replace=False)
        moved, gone = live[pick[:25]], live[pick[25:]]
        new = live[-1] + 1 + np.arange(5, dtype=np.int64)
        lat = rng.uniform(-85, 85, 25)
        lat[::4] = 90.0 if c % 2 else -90.0
        tips.append(commit_point_edits(
            repo, moves=(moved, rng.choice([-180.0, 179.99999, 12.5], 25), lat),
            inserts=(new, rng.uniform(-180, 180, 5), rng.uniform(-85, 85, 5)),
            deletes=gone, message=f"history {c}"))
        live = np.sort(np.concatenate([np.setdiff1d(live, gone), new]))
    return repo, tips


def test_dirty_tiles_on_card_matches_cpu(cuda, tmp_path):
    """Each event of a pushed history on the card (one K1 launch, the new
    tip's sidecar derived) and again with device="cpu" after the derived
    files are deleted: the same summaries and the same derived bytes."""
    import json
    import os

    from kart_tpu_torch.diff import sidecar
    from kart_tpu_torch.events.cdc import dirty_tiles
    from kart_tpu_torch.tiles.source import drop_sources

    repo, tips = _point_history_on(str(tmp_path / "r"))
    files = [sidecar.sidecar_file(repo, repo.structure(t).datasets["synth"].feature_tree.oid)
             for t in tips[1:]]
    outs = []
    for device in (None, "cpu"):
        for f in files:
            if os.path.exists(f):
                os.remove(f)
        drop_sources()
        got = []
        for old, new, f in zip(tips, tips[1:], files):
            runtime.reset_stats()
            summary = dirty_tiles(repo, old, new, device=device)
            assert runtime.stats_snapshot()["classify_launches"] == (device is None)
            assert summary["synth"]["changed"] == {"inserts": 5, "updates": 25, "deletes": 5}
            with open(f, "rb") as fh:
                got.append((json.dumps(summary), fh.read()))
        outs.append(got)
    assert outs[0] == outs[1]


def test_log_and_build_annotations_on_card_match_cpu(cuda, tmp_path):
    """``log -o json --with-dataset-changes`` and ``build-annotations`` on
    the card (one K1 launch a commit whose sides both have sidecars, none
    for the root) and with --device cpu: the same bytes and rows."""
    import contextlib
    import io
    import os
    import sqlite3

    from kart_tpu_torch.cli import main as port_main
    from kart_tpu_torch.events.cdc import dirty_tiles

    repo, tips = _point_history_on(str(tmp_path / "r"))
    for old, new in zip(tips, tips[1:]):
        dirty_tiles(repo, old, new, device="cpu")  # derives every tip's sidecar
    db = os.path.join(repo.gitdir, "annotations.db")
    for argv, want in ((["log", "-o", "json", "--with-dataset-changes"], len(tips)),
                       (["build-annotations"], len(tips))):
        outs = []
        for pre in ([], ["--device", "cpu"]):
            if os.path.exists(db):
                os.remove(db)
            runtime.reset_stats()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert port_main([*pre, "-C", repo.workdir, *argv]) == 0
            if not pre:
                assert runtime.stats_snapshot()["classify_launches"] == want
            rows = []
            if os.path.exists(db):
                with contextlib.closing(sqlite3.connect(db)) as con:
                    rows = con.execute("SELECT * FROM kart_annotations ORDER BY id").fetchall()
            outs.append((buf.getvalue(), rows))
        assert outs[0] == outs[1]
