"""The port's kernels against their plain versions on the card, at small
shapes and edge cases (empty sides, count < length, NaN/inf rows,
wrapping queries). Needs an sm_90 card and nvcc; skipped elsewhere. On the
card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from kart_tpu_torch import runtime
from kart_tpu_torch.diff.backend import envelope_scan, envelope_scan_plain
from kart_tpu_torch.ops.bbox import bbox_cyclic, bbox_cyclic_plain, pad_envelopes
from kart_tpu_torch.ops.diff_kernel import (
    TILE_ROWS,
    classify,
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


@pytest.mark.parametrize(
    "kind,n_old,n_new",
    [("random", 0, 0), ("random", 0, 300), ("random", 300, 0), ("random", 1, 1),
     ("random", 5000, 4800), ("random", 70_000, 71_000),
     # merged sizes k*D - 1, k*D, k*D + 1
     ("random", 1600, 3 * D - 1601), ("random", 1600, 3 * D - 1600), ("random", 1600, 3 * D - 1599),
     ("lead_insert", 5000, 5001), ("below", 3000, 2500), ("insert_run", 4000, 4000 + 3 * D),
     ("extremes", 2000, 2100)],
)
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
