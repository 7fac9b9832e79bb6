"""K6's cull-boundary cases, built with the port's ``VertexColumn`` alone
(no JAX), so that the CPU tests can hold the plain version to kart_tpu on
them and the card's tests the kernel to the plain version.

Coordinates are quantized units (1e-5 degree). Each case is a feature
(kind, rings); the cases meet each other at the boundaries of K6's exact
culls: segment boxes that share only an edge or a corner, collinear
segments, points, starts exactly at another side's smallest and largest y
and its largest x, starts left of a polygon whose vertex ring does not
repeat its first vertex, a ring with a hole, a one-vertex polygon, and
boxes that touch only at a corner or miss by one unit. Each case that holds
a boundary also has a long version, of more segments than K6's short
kernel takes (``SHORT_SEGMENTS``), with the same verdicts: its sides cut
into collinear pieces, a line drawn on collinearly away from what it meets,
a point repeated. So every pinned verdict is checked through the long
kernel's culls as well.
"""

import math

import numpy as np

from kart_tpu_torch.geom import KIND_LINE, KIND_POINT, KIND_POLY, VertexColumn
from kart_tpu_torch.ops.geom_refine import segment_table

_DIAMOND = [(5, 0), (10, 5), (5, 10), (0, 5), (5, 0)]
_SQUARE_OPEN = [(0, 0), (10, 0), (10, 10), (0, 10)]  # no closing vertex
_BIG = 100_000


def _box(x0, y0, x1, y1):
    return [(x0, y0), (x1, y0), (x1, y1), (x0, y1), (x0, y0)]


#: name -> (kind, rings)
CASES = {
    "line_diag": (KIND_LINE, [[(0, 0), (2, 2)]]),
    "line_box_edge_only": (KIND_LINE, [[(2, 0), (4, 2)]]),  # box shares x=2, no touch
    "line_corner_touch": (KIND_LINE, [[(2, 2), (4, 0)]]),
    "line_collinear_touch": (KIND_LINE, [[(2, 2), (4, 4)]]),
    "line_collinear_apart": (KIND_LINE, [[(3, 3), (5, 5)]]),
    "line_same_box_cross": (KIND_LINE, [[(0, 2), (2, 0)]]),  # crosses line_diag at (1, 1)
    "line_box_corner_only": (KIND_LINE, [[(2, 4), (4, 2)]]),  # boxes share (2, 2) only
    "flat_a": (KIND_LINE, [[(0, 0), (4, 0)]]),
    "flat_overlap": (KIND_LINE, [[(2, 0), (6, 0)]]),
    "flat_apart": (KIND_LINE, [[(5, 0), (6, 0)]]),
    "flat_end_to_end": (KIND_LINE, [[(4, 0), (4, 0), (9, 0)]]),  # a repeated vertex
    "point_on_diag": (KIND_POINT, [[(1, 1)]]),
    "point_off_diag": (KIND_POINT, [[(1, 2)]]),
    "point_same": (KIND_POINT, [[(1, 1)]]),
    "diamond": (KIND_POLY, [_DIAMOND]),
    "start_at_min_y": (KIND_POINT, [[(1, 0)]]),
    "start_at_max_y": (KIND_POINT, [[(4, 10)]]),
    "start_at_max_x": (KIND_POINT, [[(10, 2)]]),
    "start_at_vertex": (KIND_POINT, [[(10, 5)]]),
    "start_inside": (KIND_POINT, [[(5, 5)]]),
    "square_open_ring": (KIND_POLY, [_SQUARE_OPEN]),
    "start_left": (KIND_POINT, [[(-5, 5)]]),
    "starts_left_line": (KIND_LINE, [[(-5, 2), (-3, 8), (-4, 10), (-1, 0)]]),
    "start_left_at_min_y": (KIND_POINT, [[(-5, 0)]]),
    "holed": (KIND_POLY, [_box(20, 20, 40, 40), _box(25, 25, 35, 35)]),
    "start_in_hole": (KIND_POINT, [[(30, 30)]]),
    "start_in_ring": (KIND_POINT, [[(22, 22)]]),
    "one_vertex_polygon": (KIND_POLY, [[(3, 3)]]),
    "two_vertex_polygon": (KIND_POLY, [[(0, 3), (6, 3)]]),
    "box_a": (KIND_POLY, [_box(0, 0, _BIG, _BIG)]),
    "box_corner": (KIND_POLY, [_box(_BIG, _BIG, 2 * _BIG, 2 * _BIG)]),
    "box_one_unit_off": (KIND_POLY, [_box(_BIG + 1, _BIG + 1, 2 * _BIG, 2 * _BIG)]),
    "box_edge": (KIND_POLY, [_box(_BIG, 10, 2 * _BIG, 20)]),
    "box_inside": (KIND_POLY, [_box(10, 10, 20, 20)]),
    "box_around": (KIND_POLY, [_box(-5, -5, _BIG + 5, _BIG + 5)]),
}


def cases_column():
    """-> (the cases as one VertexColumn, their names in row order)."""
    kinds, ring_counts, xs, ys = [], [], [], []
    for kind, rings in CASES.values():
        kinds.append(kind)
        ring_counts.append(len(rings))
        for ring in rings:
            xs.append(np.asarray([p[0] for p in ring], dtype=np.int32))
            ys.append(np.asarray([p[1] for p in ring], dtype=np.int32))
    verts = np.asarray([len(x) for x in xs], dtype=np.int64)
    col = VertexColumn(np.asarray(kinds, np.uint8),
                       np.concatenate(([0], np.cumsum(ring_counts))).astype(np.int64),
                       np.concatenate(([0], np.cumsum(verts))).astype(np.int64),
                       np.concatenate(xs), np.concatenate(ys))
    return col, list(CASES)


def _split(ring, pieces=10):
    """The ring with each side cut into collinear pieces at lattice points:
    the most of at most ``pieces`` that divide the side evenly (a side of
    no length stays whole)."""
    out = [ring[0]]
    for (x0, y0), (x1, y1) in zip(ring, ring[1:]):
        g = math.gcd(abs(x1 - x0), abs(y1 - y0))
        n = max(d for d in range(1, pieces + 1) if g % d == 0) if g else 1
        out += [(x0 + (x1 - x0) * i // n, y0 + (y1 - y0) * i // n) for i in range(1, n + 1)]
    return out


#: case -> its long version's name
LONG = {name: f"{name}_long" for name in (
    "line_diag", "line_collinear_touch", "flat_a", "point_same", "diamond", "square_open_ring",
    "holed", "box_a", "box_corner", "box_one_unit_off", "box_edge", "box_inside", "box_around")}
CASES.update({
    # drawn on down y = x to (-9, -9), away from every case it meets
    LONG["line_diag"]: (KIND_LINE, [[(i, i) for i in range(-9, 3)]]),
    # drawn on up y = x to (13, 13)
    LONG["line_collinear_touch"]: (KIND_LINE, [[(i, i) for i in range(2, 14)]]),
    # drawn on left to (-6, 0)
    LONG["flat_a"]: (KIND_LINE, [[(x, 0) for x in range(-6, 5)]]),
    LONG["point_same"]: (KIND_POINT, [[(1, 1)]] * 10),
    **{LONG[name]: (KIND_POLY, [_split(ring) for ring in CASES[name][1]])
       for name in ("diamond", "square_open_ring", "holed", "box_a", "box_corner",
                    "box_one_unit_off", "box_edge", "box_inside", "box_around")},
})


#: verdicts the cases pin down, whatever the route: (a, b) -> verdict
EXPECTED = {
    ("line_diag", "line_box_edge_only"): False,
    ("line_diag", "line_corner_touch"): True,
    ("line_diag", "line_collinear_touch"): True,
    ("line_diag", "line_collinear_apart"): False,
    ("line_diag", "line_same_box_cross"): True,
    ("line_diag", "line_box_corner_only"): False,
    ("flat_a", "flat_overlap"): True,
    ("flat_a", "flat_apart"): False,
    ("flat_a", "flat_end_to_end"): True,
    ("point_on_diag", "line_diag"): True,
    ("point_off_diag", "line_diag"): False,
    ("point_on_diag", "point_same"): True,
    ("point_off_diag", "point_same"): False,
    ("start_at_min_y", "diamond"): False,
    ("start_at_max_y", "diamond"): False,
    ("start_at_max_x", "diamond"): False,
    ("start_at_vertex", "diamond"): True,
    ("start_inside", "diamond"): True,
    ("diamond", "start_inside"): True,
    ("start_left", "square_open_ring"): False,
    ("starts_left_line", "square_open_ring"): False,
    ("start_left_at_min_y", "square_open_ring"): False,
    ("start_in_hole", "holed"): False,
    ("start_in_ring", "holed"): True,
    ("one_vertex_polygon", "line_diag"): False,
    ("one_vertex_polygon", "line_collinear_touch"): True,
    ("box_a", "box_corner"): True,
    ("box_a", "box_one_unit_off"): False,
    ("box_a", "box_edge"): True,
    ("box_a", "box_inside"): True,
    ("box_inside", "box_a"): True,
    ("box_a", "box_around"): True,
}
#: ... and the same verdicts with either side long, where it has a long version
EXPECTED.update({pair: verdict for (a, b), verdict in list(EXPECTED.items())
                 for pair in ((LONG.get(a), b), (a, LONG.get(b))) if None not in pair})


def all_pairs(n):
    ia, ib = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return ia.ravel().astype(np.int64), ib.ravel().astype(np.int64)


def open_chain_tables(device):
    """Two raw segment tables that no VertexColumn gives: side A one point
    left of side B, side B a polygon whose three segments do not close
    (the chain (0,0)-(10,0)-(10,10)-(0,10)). The ray from A's point crosses
    one of them, an odd count: B's polygon holds it, which a cull of starts
    left of B would have missed. -> (seg_a, seg_b) as geom_refine takes
    them (:func:`segment_table`); feature 0 on each side."""
    def table(x0, y0, x1, y1, kind):
        cols = [np.asarray(v, dtype=np.int32) for v in (x0, y0, x1, y1)]
        return segment_table(*cols, np.asarray([0, len(x0)], dtype=np.int64),
                             np.asarray([kind], dtype=np.uint8), device)

    seg_a = table([-5], [5], [-5], [5], KIND_POINT)
    seg_b = table([0, 10, 10], [0, 0, 10], [10, 10, 0], [0, 10, 10], KIND_POLY)
    return seg_a, seg_b
