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
    assert [t.dtype for t in first] == [torch.int32] * 4 + [torch.int64, torch.uint8]


def test_refine_refuses_bad_input():
    col = synth_shapes(4, seed=1)
    segs = resident_segments(col, CPU)
    with pytest.raises(ValueError, match="int64"):
        geom_refine(segs, torch.zeros(2, dtype=torch.int32), segs, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="differ"):
        geom_refine(segs, torch.zeros(2, dtype=torch.int64), segs, torch.zeros(3, dtype=torch.int64))
