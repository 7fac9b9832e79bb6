"""``kart query`` on the port against kart_tpu, bit for bit (bytes,
integers, booleans: no tolerance), at small sizes on the CPU:

* the decode half of the KTB2 streams and of the sidecar's vertex column:
  the same values, or the same TileEncodeError text, on every forced
  encoding, every truncation, every single-bit flip;
* K5's plain version (the join's envelope overlap) against kart_tpu's host
  join counts and the pairs of its overlap matrix, on envelopes with NaN,
  wrapping, touching, -0.0 and subnormal rows;
* ``python -m kart_tpu_torch --device cpu query ...`` against kart_tpu's
  ``kart query``: stdout bytes, stderr and exit codes, on the 9000-row
  spatial synth (3 sidecar blocks), a 300-row repo with every blob, and an
  imported two-layer repo of real polygons and lines without sidecars
  (the envelope and vertex columns read from the blobs; the exact refine
  drops pairs there).
"""

import contextlib
import io
import os
import shutil
import sqlite3

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from helpers import edit_commit
from kart_tpu import geom as jgeom
from kart_tpu.cli import cli as kart_cli
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.crs import WGS84_WKT
from kart_tpu.diff import backend as jbackend
from kart_tpu.geometry import Geometry
from kart_tpu.synth import synth_repo as jsynth_repo
from kart_tpu.tiles import streams as jstreams
from kart_tpu_torch import geom as tgeom
from kart_tpu_torch.cli import main as port_main
from kart_tpu_torch.diff import backend as tbackend
from kart_tpu_torch.ops.envelope_join import envelope_join, envelope_join_plain
from kart_tpu_torch.tiles import streams as tstreams

PK0 = 1 << 24  # the synth's first pk
RECT = "-60,-30,60,30"
WRAP = "170,-30,-170,30"

# --- the decode half of the streams ------------------------------------------

_RNG = np.random.RandomState(20251017)
COLUMNS = {
    "empty": np.array([], np.int64),
    "single": np.array([-42], np.int64),
    "constant": np.full(300, 7, np.int64),
    "sorted_dense": (1 << 24) + np.cumsum(_RNG.randint(1, 4, 500)).astype(np.int64),
    "runs": np.repeat(_RNG.randint(-64, 4160, 20), 25).astype(np.int64),
    "random_small": _RNG.randint(-200, 200, 400).astype(np.int64),
    "random_wide": _RNG.randint(-(1 << 62), 1 << 62, 100).astype(np.int64),
    "int64_extremes": np.array([np.iinfo(np.int64).min, -1, 0, 1, np.iinfo(np.int64).max],
                               np.int64),
}
FORCES = [None, tstreams.RAW, tstreams.RLE, tstreams.FOR, tstreams.DVARINT, tstreams.DFOR]


def _outcome(fn, *args):
    """-> ("ok", result) or (exception type name, message)."""
    try:
        return "ok", fn(*args)
    except Exception as e:  # the boundary's contract: compared, type and text
        return type(e).__name__, str(e)


def _same(a, b):
    if a[0] != b[0]:
        return False
    if a[0] != "ok":
        return a[1] == b[1]
    (va, pa), (vb, pb) = a[1], b[1]
    if isinstance(va, np.ndarray):
        return pa == pb and va.dtype == vb.dtype and np.array_equal(va, vb)
    return pa == pb and all(np.array_equal(getattr(va, f), getattr(vb, f)) for f in
                            ("kinds", "feat_offsets", "ring_offsets", "x", "y"))


@pytest.mark.parametrize("force", FORCES)
@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_decode_stream_matches_kart_tpu(name, force):
    v = COLUMNS[name]
    for dtype in ("i8", "i4"):
        col = v if dtype == "i8" else np.clip(v, -(1 << 31), (1 << 31) - 1)
        data = jstreams.encode_stream(col, dtype, force=force)
        assert tstreams.encode_stream(col, dtype, force=force) == data
        got = _outcome(tstreams.decode_stream, b"pad" + data, len(col), dtype, 3)
        assert got[0] == "ok" and np.array_equal(got[1][0], col)
        assert _same(got, _outcome(jstreams.decode_stream, b"pad" + data, len(col), dtype, 3))


@pytest.mark.parametrize("force", FORCES[1:])
def test_stream_truncations_and_counts_raise_alike(force):
    """Every strict prefix, and a count one too many or too few: the same
    TileEncodeError text."""
    v = COLUMNS["runs"]
    data = jstreams.encode_stream(v, "i8", force=force)
    cases = [(data[:cut], len(v)) for cut in range(len(data))]
    cases += [(data, len(v) + 1), (data, len(v) - 1)]
    for case, count in cases:
        got = _outcome(tstreams.decode_stream, case, count, "i8")
        assert got[0] == "TileEncodeError"
        assert _same(got, _outcome(jstreams.decode_stream, case, count, "i8"))


@pytest.mark.parametrize("force", FORCES[1:])
def test_stream_bit_flips_decode_or_raise_alike(force):
    v = COLUMNS["random_small"][:40]
    data = jstreams.encode_stream(v, "i8", force=force)
    for i in range(len(data)):
        for bit in range(8):
            case = bytearray(data)
            case[i] ^= 1 << bit
            case = bytes(case)
            for dtype in ("i8", "i4"):
                assert _same(_outcome(tstreams.decode_stream, case, len(v), dtype),
                             _outcome(jstreams.decode_stream, case, len(v), dtype)), (i, bit)


def test_malformed_streams_raise_alike():
    H = jstreams._STREAM_HEADER
    cases = [
        (b"", 1, "i8"),
        (H.pack(99, 0), 0, "i8"),  # unknown encoding id
        (H.pack(jstreams.RAW, 100), 1, "i8"),  # payload past the buffer
        (jstreams.encode_stream(np.array([1 << 40], np.int64), "i8"), 1, "i4"),
        (H.pack(jstreams.DVARINT, 10) + b"\xff" * 9 + b"\x7f", 1, "i8"),  # over uint64
        (H.pack(jstreams.DVARINT, 2) + b"\x81\x00", 1, "i8"),  # zero-padded varint
        (H.pack(jstreams.RLE, 5) + b"\x02\x01\x01\x02\x02", 2, "i8"),  # split run
        (H.pack(jstreams.FOR, 3) + b"\x00\x41\x00", 1, "i8"),  # width 65
        (H.pack(jstreams.FOR, 3) + b"\x00\x01\x01", 1, "i8"),  # nonzero padding bits
        (H.pack(jstreams.RAW, 9) + b"\x00" * 9, 1, "i8"),  # raw length
    ]
    for data, count, dtype in cases:
        got = _outcome(tstreams.decode_stream, data, count, dtype)
        assert got[0] == "TileEncodeError", data
        assert _same(got, _outcome(jstreams.decode_stream, data, count, dtype))
    assert _same(_outcome(tstreams.varint_decode, b"\xff" * 9 + b"\x7f", 1),
                 _outcome(jstreams.varint_decode, b"\xff" * 9 + b"\x7f", 1))
    top = np.array([(1 << 64) - 1, 1 << 63, 0, 1], np.uint64)
    codes, pos = tstreams.varint_decode(jstreams.varint_encode(top), 4)
    assert np.array_equal(codes, top) and pos == len(jstreams.varint_encode(top))
    assert np.array_equal(tstreams.unzigzag(tstreams.zigzag(COLUMNS["int64_extremes"])),
                          COLUMNS["int64_extremes"])


# --- the decode half of the vertex column --------------------------------------

def _golden_vertex_column():
    """tests/test_wire_fuzz.py's vertex column: a polygon, a kind-0 row, a
    line."""
    return jgeom.VertexColumn(
        np.asarray([jgeom.KIND_POLY, jgeom.KIND_NONE, jgeom.KIND_LINE], np.uint8),
        np.asarray([0, 1, 1, 2], np.int64),
        np.asarray([0, 4, 6], np.int64),
        np.asarray([0, 500, 500, 0, -200, 300], np.int32),
        np.asarray([0, 0, 500, 500, -100, 250], np.int32),
    )


def _vertex_outcome(mod, data, count, pos=0):
    return _outcome(mod.decode_vertex_column, data, count, pos)


@pytest.mark.parametrize("part", ["prefixes", "flips"])
def test_vertex_column_fuzz_decodes_or_raises_alike(part):
    golden = jgeom.encode_vertex_column(_golden_vertex_column())
    assert tgeom.encode_vertex_column(tgeom.VertexColumn(
        *(getattr(_golden_vertex_column(), f) for f in
          ("kinds", "feat_offsets", "ring_offsets", "x", "y")))) == golden
    if part == "prefixes":
        cases = [golden[:end] for end in range(len(golden) + 1)]
    else:
        cases = []
        for i in range(len(golden)):
            for bit in range(8):
                flipped = bytearray(golden)
                flipped[i] ^= 1 << bit
                cases.append(bytes(flipped))
    ok = 0
    for case in cases:
        got = _vertex_outcome(tgeom, case, 3)
        assert got[0] in ("ok", "TileEncodeError")
        assert _same(got, _vertex_outcome(jgeom, case, 3))
        ok += got[0] == "ok"
    assert ok >= 1


def test_vertex_column_ceilings_raise_alike():
    golden = jgeom.encode_vertex_column(_golden_vertex_column())
    # a count one too many can still decode (a bit-packed stream's spare bits)
    assert _same(_vertex_outcome(tgeom, golden, 4), _vertex_outcome(jgeom, golden, 4))
    for data, count in ((golden, -1), (golden, (1 << 27) + 1), (golden, 2),
                        (b"\x02" + golden[1:], 3), (b"", 3)):
        got = _vertex_outcome(tgeom, data, count)
        assert got[0] == "TileEncodeError"
        assert _same(got, _vertex_outcome(jgeom, data, count))
    # a coordinate past the world's edge, a ring of no vertex
    far = jgeom.VertexColumn(np.asarray([1], np.uint8), np.asarray([0, 1]), np.asarray([0, 1]),
                             np.asarray([jgeom.WORLD_X + 1], np.int32), np.asarray([0], np.int32))
    empty_ring = jgeom.VertexColumn(np.asarray([2], np.uint8), np.asarray([0, 1]),
                                    np.asarray([0, 0]), np.zeros(0, np.int32),
                                    np.zeros(0, np.int32))
    for col in (far, empty_ring):
        data = jgeom.encode_vertex_column(col)
        got = _vertex_outcome(tgeom, data, 1)
        assert got[0] == "TileEncodeError"
        assert _same(got, _vertex_outcome(jgeom, data, 1))


def test_vertex_column_round_trips_like_kart_tpu():
    from kart_tpu_torch.synth import synth_shapes

    col = synth_shapes(300, seed=4)
    data = tgeom.encode_vertex_column(col)
    got = _vertex_outcome(tgeom, b"xy" + data, 300, 2)
    assert got[0] == "ok" and got[1][1] == len(data) + 2
    assert _same(got, _vertex_outcome(jgeom, b"xy" + data, 300, 2))
    assert np.array_equal(got[1][0].x, col.x) and np.array_equal(got[1][0].kinds, col.kinds)


# --- K5's plain version -----------------------------------------------------------

def _join_envelopes(seed, n):
    """Envelopes in a 20-degree square: points and boxes, 3% wrapping the
    anti-meridian, and rows of NaN, -0.0, subnormals, infinities and
    shared edges."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-10, 10, n).astype(np.float64)  # integer corners: many shared edges
    s = rng.integers(-10, 10, n).astype(np.float64)
    env = np.stack([w, s, w + rng.integers(0, 4, n), s + rng.integers(0, 4, n)], axis=1)
    wrap = rng.random(n) < 0.03
    env[wrap, 0] = rng.uniform(170, 180, wrap.sum())
    env[wrap, 2] = rng.uniform(-180, -170, wrap.sum())
    env = env.astype(np.float32)
    special = np.asarray([
        (np.nan,) * 4,
        (-0.0, -0.0, 0.0, 0.0),
        (0.0, 0.0, 1e-45, 1e-45),
        (-1e-45, -1e-45, -0.0, -0.0),
        (-np.inf, -1.0, np.inf, 1.0),
        (1.0, np.nan, 2.0, 2.0),
        (179.0, -5.0, -179.0, 5.0),
        (0.0, 0.0, 0.0, 0.0),
    ], dtype=np.float32)
    k = min(len(special), n)
    env[:k] = special[:k]
    return env


JOIN_SHAPES = [(0, 5), (5, 0), (1, 1), (8, 8), (64, 300), (700, 9000), (300, 20_000)]


@pytest.mark.parametrize("t,b", JOIN_SHAPES)
def test_envelope_join_plain_matches_kart_tpu(t, b):
    build, probe = _join_envelopes(t, t), _join_envelopes(b + 1, b)
    counts, total, (pi, ti) = envelope_join(torch.from_numpy(build), torch.from_numpy(probe),
                                            pairs=True)
    want, want_total = jbackend._host_join_counts(build, probe)
    assert counts.dtype == torch.int32 and np.array_equal(counts.numpy(), want)
    assert total == want_total
    ov = jbackend._join_overlap_np(
        probe[:, 0:1], probe[:, 1:2], probe[:, 2:3], probe[:, 3:4],
        build[:, 0], build[:, 1], build[:, 2], build[:, 3])
    wp, wt = np.nonzero(ov)
    assert np.array_equal(pi.numpy(), wp) and np.array_equal(ti.numpy(), wt)
    plain = envelope_join_plain(torch.from_numpy(build), torch.from_numpy(probe))
    assert torch.equal(plain[0], counts) and plain[1] == total and plain[2] is None


def test_envelope_join_edge_rows():
    """NaN never matches; two wrapping rows always do; -0.0 meets 0.0."""
    env = _join_envelopes(0, 8)
    counts, _, (pi, ti) = envelope_join(torch.from_numpy(env), torch.from_numpy(env), pairs=True)
    pairs = set(zip(pi.tolist(), ti.tolist()))
    assert counts[0] == 0 and counts[5] == 0
    assert (6, 6) in pairs and (1, 7) in pairs and (2, 1) in pairs


def test_join_seam_matches_kart_tpu():
    build, probe = _join_envelopes(3, 500), _join_envelopes(4, 3000)
    counts, total, _ = tbackend.select_backend("cpu").join_counts(
        torch.from_numpy(build), torch.from_numpy(probe))
    want = jbackend.join_bbox_counts(build, probe, allow_device=False)
    assert np.array_equal(counts.numpy(), want[0]) and total == want[1]
    assert counts.dtype == torch.int32


def test_envelope_join_refuses_bad_input():
    env = torch.zeros((4, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="f32"):
        envelope_join(env, env)


# --- kart query end to end ---------------------------------------------------------

def _port(path, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_main(["--device", "cpu", "-C", path, *argv])
    return rc, out.getvalue(), err.getvalue()


def _ref(path, argv):
    ref = CliRunner().invoke(kart_cli, ["-C", path, *argv], prog_name="kart")
    assert ref.exception is None or isinstance(ref.exception, SystemExit), ref.exception
    return ref.exit_code, ref.stdout, ref.stderr


def _compare(port_path, ref_path, argv):
    got, want = _port(port_path, argv), _ref(ref_path, argv)
    assert got == want
    return got


@pytest.fixture(scope="module")
def spatial(tmp_path_factory):
    """kart_tpu's 9000-row spatial synth (3 sidecar blocks): envelope and
    vertex columns, blobs for the 90 edited rows only."""
    repo, info = jsynth_repo(str(tmp_path_factory.mktemp("query") / "spatial"), 9000,
                             spatial=True, blobs="changed")
    path = str(repo.workdir)
    repo = JRepo(path)
    from kart_tpu.diff import sidecar

    old = sidecar.load_block(repo, repo.datasets(info["base_commit"])["synth"], pad=False)
    new = sidecar.load_block(repo, repo.datasets(info["edit_commit"])["synth"], pad=False)
    edited = np.flatnonzero((np.asarray(old.oids) != np.asarray(new.oids)).any(axis=1))
    return path, np.asarray(new.keys)[edited]


def _in_list(pks):
    return "fid IN (" + ", ".join(str(int(k)) for k in pks) + ")"


SPATIAL_CASES = {
    "count": [],
    "bbox-no-bbox": ["-o", "bbox"],
    "rect": ["--bbox", RECT],
    "rect-approx": ["--bbox", RECT, "--approx"],
    "rect-union": ["--bbox", RECT, "-o", "bbox"],
    "wrap": ["--bbox", WRAP],
    "wrap-union": ["--bbox", WRAP, "-o", "bbox"],
    "rect-where": ["--bbox", RECT, "--where", f"fid < {PK0 + 4000}"],
    "count-by-pk": ["--where", f"fid >= {PK0 + 10} AND fid <= {PK0 + 30}", "--count-by", "fid"],
    "is-null": ["--where", "fid IS NULL"],
    "not-null": ["--where", f"fid IS NOT NULL AND fid <> {PK0}"],
    "blob-predicate-missing": ["--where", "rating > 5"],
    "json-missing": ["--bbox", RECT, "-o", "json"],
    "float-for-int": ["--where", "fid = 1.5"],
    "geometry-column": ["--where", "geom = 1"],
    "unknown-column": ["--where", "nosuch = 1"],
    "grammar": ["--where", "fid < 3 OR fid > 4"],
    "dangling-and": ["--where", "fid < 3 AND"],
    "bad-bbox": ["--bbox", "1,2,3"],
    "bbox-s-over-n": ["--bbox", "0,10,0,-10"],
    "bbox-nan": ["--bbox", "0,0,nan,1"],
    "join": ["--intersects", "HEAD^:synth"],
    "join-json": ["--intersects", "HEAD^:synth", "-o", "json", "--page", "1", "--page-size", "7"],
    "join-slash": ["--intersects", "HEAD^/synth", "--bbox", RECT],
    "join-approx": ["--intersects", "HEAD^:synth", "--approx"],
    "join-wrap": ["--intersects", "HEAD^:synth", "--bbox", WRAP],
    "join-host": ["--host", "--intersects", "HEAD^:synth", "--bbox", "0,-90,40,90"],
    "join-where": ["--intersects", "HEAD^:synth", "--where", f"fid < {PK0 + 3}"],
    "join-bbox-output": ["--intersects", "HEAD^:synth", "-o", "bbox"],
    "join-no-colon": ["--intersects", "HEAD^synth"],
    "join-empty-refish": ["--intersects", ":synth"],
    "join-no-dataset": ["--intersects", "HEAD^:nosuch"],
    "join-no-revision": ["--intersects", "nosuch:synth"],
}


@pytest.mark.parametrize("case", sorted(SPATIAL_CASES))
def test_query_on_spatial_synth_like_kart_tpu(spatial, case):
    path, _ = spatial
    _compare(path, path, ["query", "HEAD", "synth", *SPATIAL_CASES[case]])


@pytest.mark.parametrize("page", [0, 2, 40])
def test_query_json_pages_of_edited_features(spatial, page):
    path, edited = spatial
    argv = ["query", "HEAD", "synth", "--where", _in_list(edited), "-o", "json",
            "--page", str(page), "--page-size", "25"]
    rc, out, _ = _compare(path, path, argv)
    assert rc == 0 and ('"geom": "' in out) == (page < 4)


@pytest.mark.parametrize("argv", [["query", "HEAD", "nosuch"], ["query", "nosuch", "synth"],
                                  ["query", "HEAD~5", "synth"], ["query", "HEAD^", "synth"]],
                         ids=" ".join)
def test_query_revisions_and_datasets_like_kart_tpu(spatial, argv):
    _compare(spatial[0], spatial[0], argv)


@pytest.mark.parametrize("env", [{"KART_GEOM_REFINE": "0"}, {"KART_QUERY_BATCH_ROWS": "1000"},
                                 {"KART_BLOCK_PRUNE": "0"}, {"KART_QUERY_PAGE_SIZE": "3"},
                                 {"KART_GEOM_BATCH_ROWS": "7"}],
                         ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items()))
@pytest.mark.parametrize("argv", [["--bbox", RECT], ["--intersects", "HEAD^:synth"],
                                  ["--intersects", "HEAD^:synth", "-o", "json"]],
                         ids=" ".join)
def test_query_knobs_like_kart_tpu(spatial, monkeypatch, env, argv):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _compare(spatial[0], spatial[0], ["query", "HEAD", "synth", *argv])


@pytest.fixture(scope="module")
def attr(tmp_path_factory):
    """kart_tpu's 300-row synth with every blob: the blob-backed predicates."""
    repo, _ = jsynth_repo(str(tmp_path_factory.mktemp("query") / "attr"), 300, blobs="real")
    return str(repo.workdir)


ATTR_CASES = {
    "rating-gt": ["--where", "rating > 50"],
    "rating-range-json": ["--where", "rating >= 10 AND rating < 20", "-o", "json"],
    "rating-in": ["--where", "rating IN (1.0, 2.5, 3, 8388610.5)"],
    "rating-null": ["--where", "rating IS NULL"],
    "rating-not-null-pk": ["--where", f"rating IS NOT NULL AND fid < {PK0 + 40}", "-o", "json",
                           "--page-size", "4", "--page", "2"],
    "count-by-rating": ["--where", f"fid < {PK0 + 30}", "--count-by", "rating"],
    "count-by-pk": ["--count-by", "fid", "--where", "rating < 8388700"],
    "pk-in-json": ["--where", f"fid IN ({PK0 + 3}, {PK0 + 1}, {PK0 + 299})", "-o", "json"],
    "rating-string": ["--where", "rating = 'x'"],
    "rating-bool": ["--where", "rating = true"],
    "count-by-nosuch": ["--count-by", "nosuch"],
    "bbox-no-envelopes": ["--bbox", "0,0,1,1"],
    "union-no-envelopes": ["-o", "bbox"],
    "join-no-envelopes": ["--intersects", "HEAD^:synth"],
    "json-page-clamp": ["-o", "json", "--page", "-3", "--page-size", "0"],
}


@pytest.mark.parametrize("case", sorted(ATTR_CASES))
def test_query_on_blob_repo_like_kart_tpu(attr, case):
    _compare(attr, attr, ["query", "HEAD", "synth", *ATTR_CASES[case]])


# --- an imported repo of real shapes, without sidecars ------------------------------

def _shapes():
    """(polys, lines): WKT per fid. Triangles whose envelopes overlap their
    neighbours' though the shapes do not, a square with a hole, a point in
    the hole, NULL geometry, diagonal lines."""
    polys = {}
    for i in range(1, 31):
        x, y = (i % 6) * 2.0, (i // 6) * 2.0
        polys[i] = (f"POLYGON (({x} {y}, {x + 3} {y}, {x} {y + 3}, {x} {y}))" if i % 2
                    else f"POLYGON (({x + 3} {y + 3}, {x + 3} {y + 0.5}, {x + 0.5} {y + 3}, "
                         f"{x + 3} {y + 3}))")
    polys[31] = "POLYGON ((20 20, 30 20, 30 30, 20 30, 20 20), (22 22, 28 22, 28 28, 22 28, 22 22))"
    polys[32] = None
    polys[33] = "MULTIPOLYGON (((40 40, 41 40, 41 41, 40 40)), ((43 43, 44 43, 44 44, 43 43)))"
    lines = {i: f"LINESTRING ({i * 0.7} 0, {i * 0.7 + 4} 8)" for i in range(1, 16)}
    lines[16] = "POINT (25 25)"  # inside the hole of polygon 31
    lines[17] = "MULTIPOINT ((41.5 40.2), (21 21))"
    lines[18] = "LINESTRING (179.5 -5, 179.9 5)"
    return polys, lines


def _shapes_gpkg(path):
    con = sqlite3.connect(path)
    con.executescript("""
        CREATE TABLE gpkg_contents (
            table_name TEXT NOT NULL PRIMARY KEY, data_type TEXT NOT NULL,
            identifier TEXT UNIQUE, description TEXT DEFAULT '',
            last_change DATETIME, min_x DOUBLE, min_y DOUBLE,
            max_x DOUBLE, max_y DOUBLE, srs_id INTEGER);
        CREATE TABLE gpkg_geometry_columns (
            table_name TEXT NOT NULL, column_name TEXT NOT NULL,
            geometry_type_name TEXT NOT NULL, srs_id INTEGER NOT NULL,
            z TINYINT NOT NULL, m TINYINT NOT NULL,
            CONSTRAINT pk_geom_cols PRIMARY KEY (table_name, column_name));
        CREATE TABLE gpkg_spatial_ref_sys (
            srs_name TEXT NOT NULL, srs_id INTEGER NOT NULL PRIMARY KEY,
            organization TEXT NOT NULL, organization_coordsys_id INTEGER NOT NULL,
            definition TEXT NOT NULL, description TEXT);
    """)
    con.execute("INSERT INTO gpkg_spatial_ref_sys VALUES ('WGS 84', 4326, 'EPSG', 4326, ?, NULL)",
                (WGS84_WKT,))
    for table, shapes in zip(("polys", "lines"), _shapes()):
        con.execute("INSERT INTO gpkg_contents (table_name, data_type, identifier, srs_id) "
                    "VALUES (?, 'features', ?, 4326)", (table, table))
        con.execute("INSERT INTO gpkg_geometry_columns VALUES (?, 'geom', 'GEOMETRY', 4326, 0, 0)",
                    (table,))
        con.execute(f"CREATE TABLE {table} (fid INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL, "
                    "geom GEOMETRY, name TEXT, rating REAL)")
        for fid, wkt in shapes.items():
            blob = bytes(Geometry.from_wkt(wkt, crs_id=4326)) if wkt else None
            con.execute(f"INSERT INTO {table} VALUES (?, ?, ?, ?)", (fid, blob, f"n{fid}", fid / 4))
    con.commit()
    con.close()
    return path


@pytest.fixture(scope="module")
def shapes(tmp_path_factory):
    """An imported two-layer repo (no sidecars) and an edit commit moving
    some polygons; one copy for each package, so each builds its own
    sidecars and reads envelopes and vertices from the blobs."""
    from kart_tpu.importer import ImportSource
    from kart_tpu.importer.importer import import_sources

    base = tmp_path_factory.mktemp("shapes")
    repo = JRepo.init_repository(base / "repo")
    repo.config.set_many({"user.name": "Tester", "user.email": "t@example.com"})
    import_sources(repo, ImportSource.open(_shapes_gpkg(str(base / "shapes.gpkg"))))
    updates = [{"fid": i, "geom": Geometry.from_wkt(
        f"POLYGON (({i} 1, {i + 1.5} 1, {i} 2.5, {i} 1))", crs_id=4326),
        "name": f"moved{i}", "rating": 0.5} for i in (2, 3, 5, 8)]
    with repo.odb.bulk_pack(level=0):  # kart_tpu's query reads packed blobs only
        edit_commit(repo, "polys", updates=updates, deletes=[13])
    path = str(repo.workdir)
    port, ref = str(base / "port"), str(base / "ref")
    shutil.copytree(path, port)
    shutil.copytree(path, ref)
    return port, ref


SHAPES_CASES = {
    "scan": ["query", "HEAD", "polys"],
    "rect": ["query", "HEAD", "polys", "--bbox", "1,1,5,5"],
    "rect-approx": ["query", "HEAD", "polys", "--bbox", "1,1,5,5", "--approx"],
    "rect-json": ["query", "HEAD", "polys", "--bbox", "2.6,2.6,3.2,3.2", "-o", "json"],
    "rect-union": ["query", "HEAD", "polys", "--bbox", "1,1,5,5", "-o", "bbox"],
    "hole": ["query", "HEAD", "polys", "--bbox", "24,24,26,26"],
    "lines-rect": ["query", "HEAD", "lines", "--bbox", "0,5,3,6", "-o", "json"],
    "lines-wrap": ["query", "HEAD", "lines", "--bbox", "179,-10,-179,10"],
    "blob-where": ["query", "HEAD", "polys", "--where", "rating > 3 AND name <> 'n20'",
                   "-o", "json", "--page-size", "4"],
    "count-by-name": ["query", "HEAD", "polys", "--count-by", "name", "--bbox", "0,0,6,6"],
    "time-travel": ["query", "HEAD", "polys", "--intersects", "HEAD^:polys"],
    "time-travel-json": ["query", "HEAD", "polys", "--intersects", "HEAD^:polys", "-o", "json"],
    "time-travel-approx": ["query", "HEAD", "polys", "--intersects", "HEAD^:polys", "--approx"],
    "cross-dataset": ["query", "HEAD", "polys", "--intersects", "HEAD:lines", "-o", "json"],
    "cross-dataset-back": ["query", "HEAD", "lines", "--intersects", "HEAD^:polys", "-o", "json"],
    "cross-dataset-bbox": ["query", "HEAD", "lines", "--intersects", "HEAD:polys", "--bbox",
                           "0,0,6,8"],
    "cross-dataset-approx": ["query", "HEAD", "lines", "--intersects", "HEAD:polys",
                             "--approx"],
}


@pytest.mark.parametrize("case", list(SHAPES_CASES))
def test_query_on_imported_shapes_like_kart_tpu(shapes, case):
    port, ref = shapes
    _compare(port, ref, SHAPES_CASES[case])


def test_refine_drops_pairs_on_shapes(shapes):
    """The exact refine drops envelope-only matches, and only those."""
    import json

    port, ref = shapes
    exact = json.loads(_compare(port, ref, SHAPES_CASES["time-travel"])[1])["kart.query/v2"]
    approx = json.loads(_compare(port, ref, SHAPES_CASES["time-travel-approx"])[1])
    approx = approx["kart.query/v2"]
    assert exact["exact"] and not approx["exact"]
    assert exact["stats"]["refine_dropped"] > 0
    assert exact["pairs"] == approx["pairs"] - exact["stats"]["refine_dropped"]
    rect = json.loads(_compare(port, ref, SHAPES_CASES["rect"])[1])["kart.query/v2"]
    assert rect["stats"]["refine_dropped"] > 0
    # a rectangle inside the hole of polygon 31: only the NULL-geometry row
    # (the whole world, never refined) is left
    hole = json.loads(_compare(port, ref, SHAPES_CASES["hole"])[1])["kart.query/v2"]
    assert hole["count"] == 1 and hole["stats"]["refine_dropped"] == 1


@pytest.fixture(scope="module")
def text_pk(tmp_path_factory):
    """A hash-keyed layer (G-NAF-shaped text pks, every blob real) written by
    the port's synth: the rows come in filename-hash order and their pks
    from their paths."""
    from kart_tpu_torch.synth import synth_repo

    repo, _ = synth_repo(str(tmp_path_factory.mktemp("query") / "text"), 200, pk="text",
                         blobs="real")
    return str(repo.workdir)


TEXT_PK_CASES = {
    "count": [],
    "json-page": ["-o", "json", "--page", "1", "--page-size", "7"],
    "where-pk": ["--where", "code >= 'GAQLD' AND code < 'GAVIC'", "-o", "json"],
    "count-by-pk": ["--count-by", "code", "--where", "rating > 5"],
    "pk-int-literal": ["--where", "code = 3"],
}


@pytest.mark.parametrize("case", sorted(TEXT_PK_CASES))
def test_query_on_text_pks_like_kart_tpu(text_pk, case):
    _compare(text_pk, text_pk, ["query", "HEAD", "synth", *TEXT_PK_CASES[case]])


@pytest.mark.parametrize("t,b", [(4096, 65_536), (4096, 12_288), (4096, 1), (4095, 700),
                                 (1, 1), (33, 70_001), (4096, 10_000_000), (0, 5)])
def test_envelope_join_slices_cover_the_tile(t, b):
    """K5's cut of a build tile: slices of a multiple of 32 rows, at most
    1024, that cover the tile exactly and, where the tile allows, give
    every one of 132 SMs four blocks of 512 probe rows."""
    from kart_tpu_torch.ops.envelope_join import BLOCK_ROWS, MAX_SLICE, tile_slices

    rows, n = tile_slices(t, b, 132)
    assert rows % 32 == 0 and 32 <= rows <= MAX_SLICE
    if t == 0:
        assert n == 0
        return
    assert (n - 1) * rows < t <= n * rows
    blocks = -(-b // BLOCK_ROWS) * n
    assert blocks >= min(4 * 132, -(-b // BLOCK_ROWS) * -(-t // 32)) or rows == MAX_SLICE


@pytest.mark.parametrize("t,b", [(700, 9000), (1025, 300), (64, 1)])
def test_envelope_join_slice_offsets_give_row_major_pairs(t, b):
    """The pairs pass's layout, on the host: each (probe row, slice) count,
    the wrapper's exclusive scan of them (``slice_offsets``) on its slicing
    (``tile_slices``), and each (row, slice) writing its pairs in build-row
    order from its offset, give kart_tpu's np.nonzero order. The kernel's
    own writes are held to the plain version by the ``cuda`` slice cases."""
    from kart_tpu_torch.ops.envelope_join import slice_offsets, tile_slices

    build, probe = _join_envelopes(t + 7, t), _join_envelopes(b + 8, b)
    hit = jbackend._join_overlap_np(
        probe[:, 0:1], probe[:, 1:2], probe[:, 2:3], probe[:, 3:4],
        build[:, 0], build[:, 1], build[:, 2], build[:, 3])
    rows, n = tile_slices(t, b, 132)
    cells = np.stack([hit[:, s * rows:(s + 1) * rows].sum(axis=1) for s in range(n)], axis=1)
    offs = slice_offsets(torch.from_numpy(cells.reshape(-1).astype(np.int32)))
    assert offs.dtype == torch.int64
    offs = offs.numpy().reshape(b, n)
    total = int(cells.sum())
    pair_probe, pair_build = np.full(total, -1), np.full(total, -1)
    for row in range(b):
        for s in range(n):
            cols = np.flatnonzero(hit[row, s * rows:(s + 1) * rows]) + s * rows
            at = offs[row, s]
            pair_probe[at:at + len(cols)] = row
            pair_build[at:at + len(cols)] = cols
    want_probe, want_build = np.nonzero(hit)
    assert np.array_equal(pair_probe, want_probe) and np.array_equal(pair_build, want_build)


def test_envelope_join_wrap_branches_equal_kart_tpus_predicate():
    """An algebra check, of the forms K5 and its bound take (it runs no port
    code: the kernel's branches are CUDA, held to the plain version by the
    ``cuda`` cases). K5 branches on the build row's wrap bit: a wrapping
    build row meets a probe row when lat & (a | b | pwrap), a plain one when
    lat & ((a & b) | (pwrap & (a | b))), and with no wrap on either side
    lat & a & b: the same verdicts as kart_tpu's predicate on rows that
    reach every branch. Its bound counts four compares a test, two where
    both rows wrap: with each row's wrap bit known, one wrapping side gives
    lat & (a | b), both lat alone."""
    env = _join_envelopes(21, 3000)
    rng = np.random.default_rng(22)
    wrap = rng.random(3000) < 0.2
    env[wrap, 0] = rng.uniform(150, 180, wrap.sum())
    env[wrap, 2] = rng.uniform(-180, -150, wrap.sum())
    p, q = env[:, None, :], env[None, :, :]
    lat = (q[..., 1] <= p[..., 3]) & (p[..., 1] <= q[..., 3])
    a, b = q[..., 0] <= p[..., 2], p[..., 0] <= q[..., 2]
    pwrap, bwrap = p[..., 2] < p[..., 0], q[..., 2] < q[..., 0]
    got = np.where(bwrap, lat & (a | b | pwrap), lat & ((a & b) | (pwrap & (a | b))))
    plain = lat & a & b
    want = jbackend._join_overlap_np(
        env[:, 0:1], env[:, 1:2], env[:, 2:3], env[:, 3:4], env[:, 0], env[:, 1], env[:, 2],
        env[:, 3])
    assert np.array_equal(got, want)
    neither = ~pwrap & ~bwrap
    assert np.array_equal(plain[neither], want[neither])
    one = pwrap ^ bwrap
    assert np.array_equal((lat & (a | b))[one], want[one])
    both = pwrap & bwrap
    assert np.array_equal(lat[both], want[both])
    assert (bwrap & pwrap & want).any() and ((bwrap ^ pwrap) & want).any()
