"""The exact refine on the port against kart_tpu, bit for bit, on the CPU:
the vertex column's extraction from GPKG blobs and its segment table, the
two predicates, and K6's plain version against kart_tpu's
``refine_pairs_host`` on ``tests/test_geom_refine.py``'s edge matrix (each
side built through each package's own extraction), on seeded stars with
holes, points and polylines, and through the CPU backend's ``refine_pairs``."""

import numpy as np
import pytest
import torch

from kart_tpu import geom as jgeom
from kart_tpu.diff import backend as jbackend
from kart_tpu.geometry import Geometry
from kart_tpu_torch import geom as tgeom
from kart_tpu_torch.diff import backend as tbackend
from kart_tpu_torch.ops.geom_refine import geom_refine, geom_refine_plain, resident_segments
from kart_tpu_torch.synth import synth_shapes
from test_geom_refine import EDGE_WKTS_A, EDGE_WKTS_B

CPU = torch.device("cpu")
FIELDS = ("kinds", "feat_offsets", "ring_offsets", "x", "y")

#: shapes the extraction turns into kind-0 rows, or clips, beside the matrix
ODD_WKTS = [
    "GEOMETRYCOLLECTION (POINT (1 1), LINESTRING (0 0, 1 1))",
    "POINT EMPTY",
    "MULTIPOINT EMPTY",
    "POLYGON ((0 0, 200 0, 200 10, 0 0))",  # outside the world
    "POINT (180 90)",
    "POINT (-180 -90)",
    "LINESTRING (0.000004 0.000006, 1.999995 2.0000049)",  # rounding at 1e-5
    "MULTILINESTRING ((0 0, 1 1), (2 2, 3 3))",
    "MULTIPOLYGON (((0 0, 1 0, 0 1, 0 0)), ((5 5, 6 5, 5 6, 5 5), (5.1 5.1, 5.2 5.1, 5.1 5.2, 5.1 5.1)))",
    "POINT Z (1 2 3)",
    "LINESTRING M (0 0 5, 1 1 6)",
]


def _blobs(wkts):
    return [bytes(Geometry.from_wkt(w)) if w is not None else None for w in wkts]


def _both(wkts):
    blobs = _blobs(wkts) + [b"not a geometry", b""]
    return jgeom.vertex_column_from_blobs(blobs), tgeom.vertex_column_from_blobs(blobs)


def _as_kart_tpu(col):
    return jgeom.VertexColumn(*(getattr(col, f) for f in FIELDS))


def _verdicts(col_a, ia, col_b, ib, fn=geom_refine):
    return fn(resident_segments(col_a, CPU), torch.from_numpy(np.asarray(ia, np.int64)),
              resident_segments(col_b, CPU), torch.from_numpy(np.asarray(ib, np.int64))).numpy()


def _all_pairs(na, nb):
    ia, ib = np.meshgrid(np.arange(na), np.arange(nb), indexing="ij")
    return ia.ravel(), ib.ravel()


@pytest.mark.parametrize("wkts", [EDGE_WKTS_A, EDGE_WKTS_B, ODD_WKTS],
                         ids=["edge_a", "edge_b", "odd"])
def test_extraction_and_segment_table_match_kart_tpu(wkts):
    want, got = _both(wkts)
    for f in FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    for a, b in zip(got.segment_table(), want.segment_table()):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    assert np.array_equal(got.usable(), want.usable())
    for i in range(len(got)):
        for a, b in zip(got.segments(i), want.segments(i)):
            assert np.array_equal(a, b)
    assert tgeom.encode_vertex_column(got) == jgeom.encode_vertex_column(want)


def test_bbox_vertex_column_matches_kart_tpu():
    for q in ((0.0, 8.0, 2.0, 10.0), (-180.0, -90.0, 180.0, 90.0), (-200.0, 0.0, 5.0, 95.0),
              (1.000004, 2.0, 1.000006, 2.0)):
        got, want = tgeom.bbox_vertex_column(q), jgeom.bbox_vertex_column(q)
        assert all(np.array_equal(getattr(got, f), getattr(want, f)) for f in FIELDS)
    assert tgeom.bbox_vertex_column((170.0, 0.0, -170.0, 10.0)) is None


def test_predicates_match_kart_tpu():
    rng = np.random.default_rng(5)
    # small coordinates make collinear and endpoint touches common
    a = [rng.integers(-4, 5, 4000).astype(np.int64) for _ in range(8)]
    a += [rng.integers(-tgeom.WORLD_X, tgeom.WORLD_X + 1, 4000).astype(np.int64)
          for _ in range(8)]
    for coords in (a[:8], a[8:]):
        want = jgeom.seg_pairs_intersect(*coords)
        assert np.array_equal(tgeom.seg_pairs_intersect(*coords), want)
        got = tgeom.seg_pairs_intersect(*(torch.from_numpy(c) for c in coords)).numpy()
        assert np.array_equal(got, want)
        want = jgeom.ray_crossings(*coords[:6])
        assert np.array_equal(tgeom.ray_crossings(*(torch.from_numpy(c) for c in coords[:6]))
                              .numpy(), want)
    assert 0 < int(jgeom.seg_pairs_intersect(*a[:8]).sum()) < 4000


def test_refine_plain_matches_kart_tpu_on_edge_matrix():
    ja, ta = _both(EDGE_WKTS_A)
    jb, tb = _both(EDGE_WKTS_B)
    ia, ib = _all_pairs(len(ta), len(tb))
    want = jgeom.refine_pairs_host(ja, ia, jb, ib)
    got = _verdicts(ta, ia, tb, ib)
    assert np.array_equal(got, want)
    verdict = {(int(i), int(j)): bool(v) for i, j, v in zip(ia, ib, got)}
    assert verdict[(0, 0)] and not verdict[(1, 1)] and verdict[(1, 2)]
    assert verdict[(0, 3)] and verdict[(2, 4)] and not verdict[(9, 0)]


@pytest.mark.parametrize("seed,n,span,max_segments", [(1, 16, 10.0, 256), (2, 60, 3.0, 12),
                                                      (3, 30, 40.0, 64)])
def test_refine_plain_matches_kart_tpu_on_seeded_shapes(seed, n, span, max_segments):
    col_a = synth_shapes(n, seed=seed, span=span, max_segments=max_segments)
    col_b = synth_shapes(n - 3, seed=seed + 100, span=span, max_segments=max_segments)
    ia, ib = _all_pairs(len(col_a), len(col_b))
    want = jgeom.refine_pairs_host(_as_kart_tpu(col_a), ia, _as_kart_tpu(col_b), ib)
    got = _verdicts(col_a, ia, col_b, ib)
    assert np.array_equal(got, want)
    assert want.any() and not want.all()


def test_refine_plain_rounds_do_not_change_verdicts(monkeypatch):
    """The slab budget cuts the rounds, not the verdicts."""
    from kart_tpu_torch.ops import geom_refine as mod

    col_a = synth_shapes(15, seed=8, max_segments=40)
    col_b = synth_shapes(15, seed=9, max_segments=40)
    ia, ib = _all_pairs(15, 15)
    want = _verdicts(col_a, ia, col_b, ib)
    for budget in (2000, 1):
        monkeypatch.setattr(mod, "PLAIN_SLAB_ELEMENTS", budget)
        assert np.array_equal(_verdicts(col_a, ia, col_b, ib, geom_refine_plain), want)


def test_refine_seam_matches_kart_tpu():
    ja, ta = _both(EDGE_WKTS_A + ODD_WKTS)
    jb, tb = _both(EDGE_WKTS_B)
    ia, ib = _all_pairs(len(ta), len(tb))
    ok = ta.usable()[ia] & tb.usable()[ib]
    backend = tbackend.select_backend("cpu")
    got = backend.refine_pairs(ta, ia[ok], tb, ib[ok]).numpy()
    want = jbackend.refine_intersects(ja, ia[ok], jb, ib[ok], allow_device=False)
    assert got.dtype == bool and np.array_equal(got, want)
    assert len(backend.refine_pairs(ta, ia[:0], tb, ib[:0])) == 0


def test_resident_segments_are_kept_on_the_column():
    col = synth_shapes(10, seed=1)
    first = resident_segments(col, CPU)
    assert resident_segments(col, CPU) is first
    assert first._fields[-2:] == ("boxes", "longest")
    assert ([t.dtype for t in first[:7]]
            == [torch.int32] * 4 + [torch.int64, torch.uint8, torch.int32])
    assert first.longest == int(np.diff(col.segment_table()[4]).max())


def test_refine_refuses_bad_input():
    col = synth_shapes(4, seed=1)
    segs = resident_segments(col, CPU)
    with pytest.raises(ValueError, match="int64"):
        geom_refine(segs, torch.zeros(2, dtype=torch.int32), segs, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="differ"):
        geom_refine(segs, torch.zeros(2, dtype=torch.int64), segs, torch.zeros(3, dtype=torch.int64))


def test_refine_plain_matches_kart_tpu_on_cull_boundaries():
    """K6's culls are exact at their edges: boxes sharing an edge or a
    corner, collinear and zero-length segments, starts at another side's
    smallest and largest y and largest x, starts left of a polygon whose
    ring does not repeat its first vertex, both ways round every pair;
    each pinned verdict again with a side long enough for the long kernel."""
    from torch_refine_cases import EXPECTED, LONG, all_pairs, cases_column

    from kart_tpu_torch.ops.geom_refine import SHORT_SEGMENTS

    col, names = cases_column()
    ia, ib = all_pairs(len(col))
    want = jgeom.refine_pairs_host(_as_kart_tpu(col), ia, _as_kart_tpu(col), ib)
    got = _verdicts(col, ia, col, ib)
    assert np.array_equal(got, want)
    at = {name: i for i, name in enumerate(names)}
    for (a, b), verdict in EXPECTED.items():
        assert bool(got[at[a] * len(col) + at[b]]) is verdict, (a, b)
    sizes = np.diff(col.segment_table()[4])
    long_names = set(LONG.values())
    short = [(a, b) for a, b in EXPECTED if not {a, b} & long_names]
    for a, b in short:
        twins = [(LONG.get(a), b), (a, LONG.get(b))]
        assert any(t in EXPECTED and max(sizes[at[t[0]]], sizes[at[t[1]]]) > SHORT_SEGMENTS
                   for t in twins), (a, b)


def test_refine_plain_counts_an_unclosed_ring_as_kart_tpu_does():
    """A start left of a polygon whose segments do not close crosses an odd
    number of them: the plain version counts the crossings as kart_tpu's
    predicates do, and finds it inside (no cull of starts left of a side)."""
    from torch_refine_cases import open_chain_tables

    seg_a, seg_b = open_chain_tables(CPU)
    idx = torch.zeros(1, dtype=torch.int64)
    got = geom_refine_plain(seg_a, idx, seg_b, idx)
    px, py = (np.asarray([int(seg_a[k][0])], np.int64) for k in (0, 1))
    ring = [seg_b[k].numpy().astype(np.int64) for k in range(4)]
    crossings = int(jgeom.ray_crossings(px[:, None], py[:, None], *(c[None, :] for c in ring))
                    .sum())
    touch = bool(jgeom.seg_pairs_intersect(px, py, px, py, *ring).any())
    assert crossings == 1 and not touch
    assert got.tolist() == [True]


@pytest.mark.parametrize("wkts", [EDGE_WKTS_A, ODD_WKTS], ids=["edge_a", "odd"])
def test_resident_feature_boxes_hold_every_segment(wkts):
    """The boxes K6's culls read: each feature's segments' low and high x
    and y, the empty box for a feature without segments, and the longest
    feature's segment count."""
    _, col = _both(wkts)
    segs = resident_segments(col, CPU)
    info = np.iinfo(np.int32)
    assert segs.boxes.dtype == torch.int32 and segs.boxes.shape == (len(col), 4)
    for i in range(len(col)):
        x0, y0, x1, y1 = col.segments(i)
        want = ([min(x0.min(), x1.min()), max(x0.max(), x1.max()), min(y0.min(), y1.min()),
                 max(y0.max(), y1.max())] if len(x0) else
                [info.max, info.min, info.max, info.min])
        assert segs.boxes[i].tolist() == [int(v) for v in want], i
    assert segs.longest == max(len(col.segments(i)[0]) for i in range(len(col)))
