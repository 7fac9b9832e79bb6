"""``kart export tiles`` on the port against kart_tpu, at small sizes on the
CPU:

* the tile grid, float for float (``float.hex``) over addresses, bboxes and
  zoom specs, and the same errors;
* K7's plain version (the batch mercator projection) against kart_tpu's
  ``sharded_merc_envelopes`` on the 8-device virtual CPU mesh and against
  numpy: within 2**-47 (a few ulps of 0.5; more ulps near the poles, where
  (1 + s) / (1 - s) amplifies ``sin``'s last bit), the x columns bit for
  bit against numpy's, and the quantized boxes equal at every zoom 0-30,
  rows placed on rounding boundaries so that the quantizer re-projects
  them on the host;
* every layer's bytes (bin, ktb2, mvt, geom, props, geojson) equal for the
  same rows, the geom layer also over seeded random vertex columns at four
  tolerances, and the decoders' results and errors alike;
* ``export_pyramid``'s tree digest and stats equal to kart_tpu's for each
  layer at zooms 0-4, with workers 1 and 2;
* ``python -m kart_tpu_torch --device cpu export tiles`` against kart_tpu's
  CLI: the files, stdout line, stderr and exit codes.

The repositories: kart_tpu's 9000-row spatial synth (sidecars with
envelope and vertex columns, blobs for the 90 edited rows only) and an
imported repo of real points, multipoints, lines and polygons (holes,
anti-meridian and polar rows, NULL geometry; every blob, no sidecar, so
the envelope and vertex columns are read from the blobs).
"""

import ast
import contextlib
import io
import os
import shutil
import sqlite3
import subprocess
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from helpers import edit_commit
from kart_tpu import geom as jgeom
from kart_tpu import tiles as jtiles
from kart_tpu.cli import cli as kart_cli
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.crs import WGS84_WKT
from kart_tpu.diff import backend as jbackend
from kart_tpu.geometry import Geometry
from kart_tpu.synth import synth_repo as jsynth_repo
from kart_tpu.tiles import clip as jclip
from kart_tpu.tiles import encode as jencode
from kart_tpu.tiles import grid as jgrid
from kart_tpu.tiles import pyramid as jpyramid
from kart_tpu.tiles import streams as jstreams
from kart_tpu_torch import geom as tgeom
from kart_tpu_torch import runtime
from kart_tpu_torch import tiles as ttiles
from kart_tpu_torch.cli import main as port_main
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.diff import backend as tbackend
from kart_tpu_torch.ops import merc as tmerc
from kart_tpu_torch.tiles import clip as tclip
from kart_tpu_torch.tiles import encode as tencode
from kart_tpu_torch.tiles import grid as tgrid
from kart_tpu_torch.tiles import pyramid as tpyramid
from kart_tpu_torch.tiles import streams as tstreams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KNOBS = ("KART_TILE_MAX_FEATURES", "KART_TILE_ENCODING", "KART_GEOM_SIMPLIFY",
         "KART_EXPORT_WORKERS", "KART_EXPORT_BATCH_TILES")

#: the largest difference allowed between two projections of a value (the
#: x columns of K7's plain version are numpy's exactly)
TOLERANCE = 2.0 ** -47


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


def _outcome(fn, *args, **kwargs):
    """-> ("ok", result) or (exception type name, message)."""
    try:
        return "ok", fn(*args, **kwargs)
    except Exception as e:  # compared: type and text
        return type(e).__name__, str(e)


def _hex(values):
    return [float(v).hex() for v in values]


# --- the grid ------------------------------------------------------------------------

ADDRESSES = [(0, 0, 0), (1, 0, 1), (1, 1, 0), (3, 7, 3), (5, 0, 31), (11, 1023, 2047),
             (18, 131071, 0), (24, (1 << 24) - 1, (1 << 24) - 1), (30, 0, (1 << 30) - 1),
             (30, 1 << 29, 1 << 29)]
BAD_ADDRESSES = [(31, 0, 0), (-1, 0, 0), (2, 4, 0), (2, 0, -1), ("a", 0, 0), (None, 0, 0)]


@pytest.mark.parametrize("z,x,y", ADDRESSES)
def test_tile_bounds_match_kart_tpu(z, x, y):
    assert tgrid.validate_tile(z, x, y) == jgrid.validate_tile(z, x, y)
    for fn in ("tile_bounds_wsen", "tile_cover_wsen", "tile_query_wsen"):
        assert _hex(getattr(tgrid, fn)(z, x, y)) == _hex(getattr(jgrid, fn)(z, x, y)), fn


@pytest.mark.parametrize("z,x,y", BAD_ADDRESSES)
def test_bad_addresses_raise_alike(z, x, y):
    got = _outcome(tgrid.validate_tile, z, x, y)
    assert got[0] == "TileAddressError" and got == _outcome(jgrid.validate_tile, z, x, y)
    assert tgrid.validate_tile(1.5, "0", 0.9) == jgrid.validate_tile(1.5, "0", 0.9) == (1, 0, 0)


BBOXES = [(-180.0, -90.0, 180.0, 90.0), (10.1, 20.2, 10.3, 20.4), (170.0, -10.0, -170.0, 10.0),
          (float("nan"), 0.0, 1.0, 1.0), (-float("inf"), -1.0, 1.0, 1.0), (-5.0, -95.0, 5.0, 95.0),
          (0.0, 0.0, 0.0, 0.0), (-180.0, -85.1, 180.0, 85.1), (179.9999, 89.99, 180.0, 90.0)]


@pytest.mark.parametrize("z", [0, 1, 4, 13, 30])
@pytest.mark.parametrize("bbox", BBOXES, ids=str)
def test_tile_range_for_bbox_matches_kart_tpu(z, bbox):
    assert tgrid.tile_range_for_bbox(z, bbox) == jgrid.tile_range_for_bbox(z, bbox)


@pytest.mark.parametrize("spec", ["0", "4", "0-5", "5-0", " 3-4 ", "x", "1-", "-1", "0-31",
                                  "31", "", "2-2"])
def test_parse_zoom_spec_matches_kart_tpu(spec):
    assert _outcome(tgrid.parse_zoom_spec, spec) == _outcome(jgrid.parse_zoom_spec, spec)


# --- K7's plain version, the seam and the quantizer -----------------------------------

def _boundary_rows(z, x, y, n, rng):
    """(n, 4) wsen rows whose corners project onto a rounding boundary of
    tile z/x/y (a quantized float k + 0.5), so that the quantizer must
    re-project them on the host."""
    scale = float(1 << z) * 4096
    kx = rng.integers(-60, 4150, (n, 2)) + 0.5
    ky = rng.integers(-60, 4150, (n, 2)) + 0.5
    mx = (kx + x * 4096) / scale
    my = (ky + y * 4096) / scale
    lon = mx * 360.0 - 180.0
    lat = np.degrees(np.arctan(np.sinh(np.pi * (1.0 - 2.0 * my))))
    return np.stack([lon[:, 0], lat[:, 1], lon[:, 1], lat[:, 0]], axis=1)


def _edge_rows():
    m = jgrid.MERC_MAX_LAT
    return np.array([
        (-180.0, -90.0, 180.0, 90.0), (180.0, 90.0, -180.0, -90.0), (-180.0, -m, 180.0, m),
        (0.0, m, 0.0, -m), (-0.0, -0.0, 0.0, 0.0), (5e-324, -5e-324, 1e-310, -1e-310),
        (np.nan, 1.0, 2.0, np.nan), (np.inf, np.inf, -np.inf, -np.inf),
        (-np.inf, -m, np.inf, m), (179.99999, m - 1e-12, -179.99999, -m + 1e-12),
    ], dtype=np.float64)


def _merc_inputs(seed=5):
    rng = np.random.default_rng(seed)
    world = np.stack([rng.uniform(-180, 180, 5000), rng.uniform(-89, 89, 5000),
                      rng.uniform(-180, 180, 5000), rng.uniform(-89, 89, 5000)], axis=1)
    near = rng.uniform(-1, 1, (500, 4)) * [180, 90, 180, 90]
    return np.concatenate([world, near, _edge_rows()])


def _port_plain(env):
    return tuple(tmerc.merc_plain(torch.from_numpy(np.ascontiguousarray(env))).numpy())


def test_merc_plain_matches_sharded_merc_and_numpy():
    env = _merc_inputs()
    host = jbackend.BACKENDS["host_native"].merc_envelopes(env)
    sharded = jbackend.sharded_merc_envelopes(env)
    port = _port_plain(env)
    for i, (p, h, s) in enumerate(zip(port, host, sharded)):
        for other in (h, np.asarray(s)):
            fin = np.isfinite(other)
            assert np.array_equal(np.isfinite(p), fin)
            assert np.array_equal(p[~fin], other[~fin], equal_nan=True)
            assert np.abs(p[fin] - other[fin]).max() <= TOLERANCE
        if i % 2 == 0:
            # numpy's true division; XLA multiplies by the reciprocal of 360
            assert np.array_equal(p, h, equal_nan=True), "x columns are numpy's"


@pytest.mark.parametrize("z", range(31))
def test_quantized_boxes_equal_at_every_zoom(z):
    """K7's plain version and kart_tpu's sharded projection quantize to the
    host's integers, rows on rounding boundaries re-projected."""
    rng = np.random.default_rng(100 + z)
    x, y = (1 << z) // 3, (1 << z) // 2
    env = np.concatenate([_boundary_rows(z, x, y, 400, rng), _merc_inputs(z)[:800]])
    env = env[np.isfinite(env).all(axis=1)]
    want = jclip.quantize_from_merc(env, jbackend.BACKENDS["host_native"].merc_envelopes(env),
                                    z, x, y)
    sharded = tuple(np.asarray(c) for c in jbackend.sharded_merc_envelopes(env))
    assert np.array_equal(jclip.quantize_from_merc(env, sharded, z, x, y), want)
    port = _port_plain(env)
    assert np.array_equal(tclip.quantize_from_merc(env, port, z, x, y), want)
    boxes, patched = tclip.quantize_boxes(env, port, z, x, y)
    assert np.array_equal(boxes, want) and patched >= 400


def test_project_envelopes_routes():
    env = _merc_inputs()[:2000]
    host = jbackend.BACKENDS["host_native"].merc_envelopes(env)
    got = tbackend.project_envelopes(env, allow_device=False)
    assert all(np.array_equal(a, b, equal_nan=True) for a, b in zip(got, host))
    runtime.reset_stats()
    cpu = tbackend.project_envelopes(env, device="cpu")
    assert all(np.array_equal(a, b, equal_nan=True) for a, b in zip(cpu, host))
    empty = tbackend.project_envelopes(np.zeros((0, 4)), device="cpu")
    assert len(empty) == 4 and all(len(c) == 0 for c in empty)
    assert runtime.stats_snapshot()["merc_launches"] == 0


def test_merc_plain_first_call_of_a_process_is_accurate():
    """The plain version on the CPU as the first projection of fresh
    processes, at a main-path batch's size: within the tolerance of numpy
    (a threaded first ``sin`` of PyTorch's CPU build has returned a slice of
    rows at float precision)."""
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "from kart_tpu_torch.ops.merc import merc_plain\n"
        "from kart_tpu_torch.tiles.clip import _host_merc\n"
        "rng = np.random.default_rng(int(sys.argv[1]))\n"
        "n = 531617\n"
        "env = np.stack([rng.uniform(-180, 180, n), rng.uniform(-85, 85, n),\n"
        "                rng.uniform(-180, 180, n), rng.uniform(-85, 85, n)], axis=1)\n"
        "got = merc_plain(torch.from_numpy(env)).numpy()\n"
        "print(float(np.abs(got - np.stack(_host_merc(env))).max()))\n"
    )
    for seed in range(4):
        r = subprocess.run([sys.executable, "-c", code, str(seed)], cwd=ROOT,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        assert float(r.stdout) <= TOLERANCE, seed


def test_merc_plain_starts_no_intra_op_thread():
    """The plain version on the CPU computes every slice on the calling
    thread: a fresh process projecting a main-path batch starts none of
    PyTorch's intra-op threads, while one ``sin`` over a slice and a row
    more starts them."""
    code = (
        "import os\n"
        "import numpy as np, torch\n"
        "from kart_tpu_torch.ops.merc import CPU_SLICE_ROWS, merc_plain\n"
        "def threads():\n"
        "    return len(os.listdir('/proc/self/task'))\n"
        "env = torch.from_numpy(np.random.default_rng(0).uniform(-85, 85, (531617, 4)))\n"
        "before = threads()\n"
        "merc_plain(env)\n"
        "after = threads()\n"
        "torch.sin(torch.zeros(CPU_SLICE_ROWS + 1, dtype=torch.float64))\n"
        "print(before, after, threads())\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    before, after, threaded = map(int, r.stdout.split())
    assert after == before
    if torch.get_num_threads() > 1:
        assert threaded > before


def test_merc_wrapper_checks_its_input():
    env = torch.from_numpy(_merc_inputs()[:100])
    assert torch.equal(tmerc.merc(env), tmerc.merc_plain(env))
    for bad in (env.float(), env[:, :3].contiguous(), env.t()):
        with pytest.raises(ValueError):
            tmerc.merc(bad)
    with pytest.raises(runtime.DeviceUnavailable):
        tmerc.merc(torch.zeros((2, 4), dtype=torch.float64, device="meta"))


# --- the layers ------------------------------------------------------------------------

def _shapes():
    """WKT per fid: polygons (one with a hole, a multipolygon, one across
    the anti-meridian's edge, polar ones), points and a multipoint, lines
    (one near the anti-meridian, one polar), a NULL geometry."""
    shapes = {}
    for i in range(1, 25):
        x, y = -30.0 + (i % 6) * 9.0, -20.0 + (i // 6) * 9.0
        shapes[i] = (f"POLYGON (({x} {y}, {x + 6} {y}, {x} {y + 6}, {x} {y}))" if i % 2
                     else f"POLYGON (({x + 6} {y + 6}, {x + 6} {y + 0.5}, {x + 0.5} {y + 6}, "
                          f"{x + 6} {y + 6}))")
    shapes[25] = ("POLYGON ((20 20, 40 20, 40 40, 20 40, 20 20), "
                  "(24 24, 36 24, 36 36, 24 36, 24 24))")
    shapes[26] = None
    shapes[27] = "MULTIPOLYGON (((40 -40, 45 -40, 45 -35, 40 -40)), ((50 -50, 55 -50, 55 -45, 50 -50)))"
    shapes[28] = "POLYGON ((175 -5, 179.999 -5, 179.999 5, 175 5, 175 -5))"
    shapes[29] = "POLYGON ((-10 86, 10 86, 10 89.9, -10 89.9, -10 86))"
    shapes[30] = "POLYGON ((100 -89.5, 110 -89.5, 110 -86, 100 -86, 100 -89.5))"
    for i in range(31, 41):
        shapes[i] = f"POINT ({-170 + i * 8.5} {-60 + i * 2.9})"
    shapes[41] = "MULTIPOINT ((41.5 40.2), (21 21), (-179.9 0))"
    for i in range(42, 52):
        shapes[i] = f"LINESTRING ({i * 0.7 - 40} 0, {i * 0.7 - 36} 8, {i * 0.7 - 30} 2, {i * 0.7 - 38} -4)"
    shapes[52] = "LINESTRING (179.5 -5, 179.9 5)"
    shapes[53] = "LINESTRING (-120 84, -60 88, 0 85)"
    shapes[54] = "MULTILINESTRING ((0 0, 1 1), (2 2, 3 1, 4 4))"
    shapes[55] = "POINT (180 -90)"
    return shapes


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
    for table in ("shapes", "other"):
        con.execute("INSERT INTO gpkg_contents (table_name, data_type, identifier, srs_id) "
                    "VALUES (?, 'features', ?, 4326)", (table, table))
        con.execute("INSERT INTO gpkg_geometry_columns VALUES (?, 'geom', 'GEOMETRY', 4326, 0, 0)",
                    (table,))
        con.execute(f"CREATE TABLE {table} (fid INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL, "
                    "geom GEOMETRY, name TEXT, rating REAL)")
    for fid, wkt in _shapes().items():
        blob = bytes(Geometry.from_wkt(wkt, crs_id=4326)) if wkt else None
        con.execute("INSERT INTO shapes VALUES (?, ?, ?, ?)", (fid, blob, f"n{fid}", fid / 4))
    con.execute("INSERT INTO other VALUES (1, ?, 'o', 1.0)",
                (bytes(Geometry.from_wkt("POINT (1 1)", crs_id=4326)),))
    con.commit()
    con.close()
    return path


@pytest.fixture(scope="module")
def shapes(tmp_path_factory):
    """The imported two-layer repo and an edit moving some shapes: one copy
    for each package, so each reads its envelopes and vertices from the
    blobs."""
    from kart_tpu.importer import ImportSource
    from kart_tpu.importer.importer import import_sources

    base = tmp_path_factory.mktemp("tiles-shapes")
    repo = JRepo.init_repository(base / "repo")
    repo.config.set_many({"user.name": "Tester", "user.email": "t@example.com"})
    import_sources(repo, ImportSource.open(_shapes_gpkg(str(base / "shapes.gpkg"))))
    updates = [{"fid": i, "geom": Geometry.from_wkt(
        f"POLYGON (({i} 1, {i + 1.5} 1, {i} 2.5, {i} 1))", crs_id=4326),
        "name": f"moved{i}", "rating": 0.5} for i in (2, 3, 5, 8)]
    with repo.odb.bulk_pack(level=0):
        edit_commit(repo, "shapes", updates=updates, deletes=[13])
    path = str(repo.workdir)
    port, ref = str(base / "port"), str(base / "ref")
    shutil.copytree(path, port)
    shutil.copytree(path, ref)
    return port, ref


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """kart_tpu's 9000-row spatial synth: sidecars with envelope and vertex
    columns, blobs for the 90 edited rows only."""
    repo, _ = jsynth_repo(str(tmp_path_factory.mktemp("tiles-synth") / "synth"), 9000,
                          spatial=True, blobs="changed")
    return str(repo.workdir)


def _sources(port_path, ref_path, ds_path, ref="HEAD"):
    jrepo, trepo = JRepo(ref_path), TRepo(port_path)
    oid = jtiles.resolve_tile_commit(jrepo, ref)
    assert ttiles.resolve_tile_commit(trepo, ref) == oid
    return ttiles.source_for(trepo, oid, ds_path), jtiles.source_for(jrepo, oid, ds_path)


SHAPE_TILES = [(0, 0, 0), (1, 1, 0), (2, 2, 1), (3, 3, 3), (3, 0, 3), (3, 7, 3), (2, 1, 0),
               (2, 1, 3), (5, 15, 15), (6, 35, 24), (9, 300, 250), (4, 9, 7)]


@pytest.mark.parametrize("layer", jencode.KNOWN_LAYERS)
def test_layers_match_kart_tpu_on_shapes(shapes, layer):
    tsrc, jsrc = _sources(*shapes, "shapes")
    nonempty = 0
    for z, x, y in SHAPE_TILES:
        got = _outcome(tencode.encode_tile, tsrc, z, x, y, layers=(layer,), max_features=0,
                       device="cpu")
        want = _outcome(jencode.encode_tile, jsrc, z, x, y, layers=(layer,), max_features=0)
        assert got == want, (z, x, y)
        header, layers = ttiles.parse_payload(got[1][0])
        assert (header, layers) == jtiles.parse_payload(got[1][0])
        nonempty += header["count"] > 0
        decoder = {"bin": "decode_bin_layer", "ktb2": "decode_ktb2_layer",
                   "mvt": "decode_mvt_layer", "geom": "decode_mvt_layer",
                   "props": "decode_props_layer"}.get(layer)
        if decoder:
            a = getattr(tencode, decoder)(layers[layer])
            b = getattr(jencode, decoder)(layers[layer])
            assert str(a) == str(b)
    assert nonempty >= 8


@pytest.mark.parametrize("tol", ["0", "0.3", "1", "6"])
def test_geom_layer_knob_matches_kart_tpu(shapes, monkeypatch, tol):
    monkeypatch.setenv("KART_GEOM_SIMPLIFY", tol)
    tsrc, jsrc = _sources(*shapes, "shapes")
    for z, x, y in SHAPE_TILES:
        assert (tencode.encode_tile(tsrc, z, x, y, layers="geom,mvt", max_features=0,
                                    device="cpu")
                == jencode.encode_tile(jsrc, z, x, y, layers="geom,mvt", max_features=0))


def _random_column(rng, n):
    """A vertex column of n rows: kinds 0-3, 1-3 rings, duplicate, closed,
    collapsed and one-vertex rings, spans from 1e-4 to 10 degrees."""
    kinds, rings, verts, xs, ys = [], [], [], [], []
    for _ in range(n):
        k = int(rng.integers(0, 4))
        kinds.append(k)
        if k == 0:
            rings.append(0)
            continue
        nr = int(rng.integers(1, 4))
        rings.append(nr)
        cx, cy, span = rng.uniform(-170, 170), rng.uniform(-80, 80), 10 ** rng.uniform(-4, 1)
        for _ in range(nr):
            nv = int(rng.integers(1, 9 if k == 1 else 30))
            px, py = cx + rng.normal(0, span, nv), cy + rng.normal(0, span, nv)
            if nv > 1 and rng.random() < 0.3:
                j = int(rng.integers(1, nv))
                px[j], py[j] = px[j - 1], py[j - 1]
            if k == 3 and nv > 1 and rng.random() < 0.7:
                px[-1], py[-1] = px[0], py[0]
            qx = np.rint(np.clip(px, -180, 180) * 1e5).astype(np.int32)
            qy = np.rint(np.clip(py, -90, 90) * 1e5).astype(np.int32)
            if rng.random() < 0.1:
                qx[:], qy[:] = qx[0], qy[0]
            xs.append(qx)
            ys.append(qy)
            verts.append(nv)
    cols = (np.array(kinds, np.uint8), np.concatenate(([0], np.cumsum(rings))),
            np.concatenate(([0], np.cumsum(verts))),
            np.concatenate(xs) if xs else np.zeros(0, np.int32),
            np.concatenate(ys) if ys else np.zeros(0, np.int32))
    return tgeom.VertexColumn(*cols), jgeom.VertexColumn(*cols)


@pytest.mark.parametrize("seed", range(24))
def test_geom_layer_matches_kart_tpu_on_random_columns(monkeypatch, seed):
    """The vectorized geom layer against kart_tpu's per-feature one: rings
    cleaned, simplified and encoded alike, envelope boxes for the rest."""
    monkeypatch.setenv("KART_GEOM_SIMPLIFY", ["0", "1", "0.3", "5"][seed % 4])
    rng = np.random.default_rng(seed)
    for _ in range(15):
        n = int(rng.integers(0, 60))
        tcol, jcol = _random_column(rng, n)
        rows = np.sort(rng.choice(n, int(rng.integers(0, n + 1)), replace=False)) if n else \
            np.zeros(0, np.int64)
        boxes = rng.integers(-64, 4160, (len(rows), 4)).astype(np.int32)
        boxes[::3, 2] = boxes[::3, 0]
        boxes[::4, 3] = boxes[::4, 1]
        keys = rng.integers(-(2 ** 63), 2 ** 63 - 1, len(rows), dtype=np.int64)
        z = int(rng.integers(0, 31))
        x = y = 0
        if len(jcol.x):
            mx, my = jgrid.merc_xy_cols(jcol.x[0] / 1e5, jcol.y[0] / 1e5)
            x = min(int(mx * (1 << z)), (1 << z) - 1)
            y = min(max(int(my * (1 << z)), 0), (1 << z) - 1)
        assert (tencode.encode_geom_layer("ds", keys, tcol, rows, boxes, z, x, y)
                == jencode.encode_geom_layer("ds", keys, jcol, rows, boxes, z, x, y))
        assert (tencode.encode_mvt_layer("ds", keys, boxes)
                == jencode.encode_mvt_layer("ds", keys, boxes))


@pytest.mark.parametrize("z", [2, 4])
def test_encoder_bench_copies_match(synth, z):
    """The encoder bench's copies of kart_tpu's per-feature loops give the
    port's bytes (the bench compares like with like)."""
    from kart_tpu_torch.tiles import encoder_bench

    tsrc, _ = _sources(synth, synth, "synth")
    result = encoder_bench.compare(tsrc, z, 10**9)
    assert set(result) == {"mvt", "geom"}
    assert all(r["tiles"] > 0 and r["rows"] > 0 for r in result.values())


def test_batch_encoder_matches_serving_encoder(synth):
    """The batch encoder through K7's plain version and through numpy writes
    the serving encoder's payloads, which are kart_tpu's."""
    tsrc, jsrc = _sources(synth, synth, "synth")
    addresses = [(z, x, y) for z in (0, 2, 3) for x in range(1 << z) for y in range(1 << z)][:40]
    layers = "bin,ktb2,mvt,geom"
    serial = [tencode.encode_tile(tsrc, *a, layers=layers, device="cpu")[0] for a in addresses]
    assert serial == [jencode.encode_tile(jsrc, *a, layers=layers)[0] for a in addresses]
    for kwargs in ({"device": "cpu"}, {"allow_device": False}):
        batch = tencode.encode_tile_batch(tsrc, addresses, layers=layers, **kwargs)
        for (status, payload, count), want in zip(batch, serial):
            if status == "ok":
                assert payload == want
            else:
                assert status == "empty" and ttiles.parse_payload(want)[0]["count"] == count == 0
        assert batch == jencode.encode_tile_batch(jsrc, addresses, layers=layers,
                                                  allow_device=False)


def test_decoders_raise_alike(synth):
    tsrc, _ = _sources(synth, synth, "synth")
    payload, _ = tencode.encode_tile(tsrc, 2, 1, 1, layers="bin,ktb2,mvt,geom", device="cpu")
    for cut in list(range(0, 40)) + list(range(len(payload) - 60, len(payload) + 1)):
        case = payload[:cut] + (b"\x00" if cut == len(payload) else b"")
        assert _outcome(ttiles.parse_payload, case) == _outcome(jtiles.parse_payload, case)
    _, layers = ttiles.parse_payload(payload)
    for name, fn in (("bin", "decode_bin_layer"), ("ktb2", "decode_ktb2_layer"),
                     ("mvt", "decode_mvt_layer"), ("geom", "decode_mvt_layer")):
        data = layers[name]
        for cut in range(0, len(data), max(1, len(data) // 97)):
            got = _outcome(getattr(tencode, fn), data[:cut])
            assert got[0] != "ok" or cut == 0 or name in ("mvt", "geom")
            assert str(got) == str(_outcome(getattr(jencode, fn), data[:cut])), (name, cut)


def test_bytes_stream_matches_kart_tpu():
    items = [b"a", b"", b"\x00\xff", b"a", b"longer string", b"", b"a"] * 7
    data = jstreams.encode_bytes_stream(items)
    assert tstreams.encode_bytes_stream(items) == data
    assert tstreams.decode_bytes_stream(b"xy" + data, len(items), 2) == \
        jstreams.decode_bytes_stream(b"xy" + data, len(items), 2)
    for cut in range(len(data)):
        assert (_outcome(tstreams.decode_bytes_stream, data[:cut], len(items))
                == _outcome(jstreams.decode_bytes_stream, data[:cut], len(items)))
    for count in (0, len(items) - 1, len(items) + 1):
        assert (_outcome(tstreams.decode_bytes_stream, data, count)
                == _outcome(jstreams.decode_bytes_stream, data, count))


# --- the pyramid -------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("layer", jencode.KNOWN_LAYERS)
@pytest.mark.parametrize("repo", ["synth", "shapes"])
def test_export_pyramid_matches_kart_tpu(request, tmp_path, repo, layer, workers):
    paths = (request.getfixturevalue("synth"),) * 2 if repo == "synth" else \
        request.getfixturevalue("shapes")
    tsrc, jsrc = _sources(*paths, "synth" if repo == "synth" else "shapes")
    zooms = [0, 1, 2, 3, 4]
    kwargs = {"layers": (layer,), "workers": workers, "batch_tiles": 16}
    got = _outcome(tpyramid.export_pyramid, tsrc, zooms, str(tmp_path / "t"), device="cpu",
                   max_features=2000, **kwargs)
    want = _outcome(jpyramid.export_pyramid, jsrc, zooms, str(tmp_path / "j"),
                    max_features=2000, **kwargs)
    assert got == want
    if got[0] == "ok":
        assert tpyramid.tree_digest(str(tmp_path / "t")) == jpyramid.tree_digest(
            str(tmp_path / "j"))
        assert got[1]["tiles_written"] > 0
        if repo == "synth":
            assert got[1]["export_workers"] == workers and got[1]["tiles_too_large"] > 0
    else:
        assert repo == "synth" and layer in ("geojson", "props") and \
            got[0] == "TileDataUnavailable"


def test_pool_export_leaves_no_process(tmp_path, synth):
    """A pooled export stops the fork server and the resource tracker its
    pool started: nothing of its process group outlives the command."""
    out = tmp_path / "stdout"
    with open(out, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kart_tpu_torch", "--device", "cpu", "-C", synth, "export",
             "tiles", "--zoom", "0-3", "--layers", "bin", "--workers", "2",
             "-o", str(tmp_path / "tiles")],
            cwd=ROOT, stdout=f, stderr=subprocess.STDOUT, start_new_session=True)
        assert proc.wait(timeout=300) == 0, out.read_text()
    with pytest.raises(ProcessLookupError):
        os.killpg(proc.pid, 0)
    assert "; 2 workers]" in out.read_text()


# --- the command line ---------------------------------------------------------------------

def _port_cli(path, argv, cwd):
    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = port_main(["--device", "cpu", "-C", path, *argv])
    finally:
        os.chdir(old)
    return rc, out.getvalue(), err.getvalue()


def _ref_cli(path, argv, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        ref = CliRunner().invoke(kart_cli, ["-C", path, *argv], prog_name="kart")
    finally:
        os.chdir(old)
    assert ref.exception is None or isinstance(ref.exception, SystemExit), ref.exception
    return ref.exit_code, ref.stdout, ref.stderr


def _compare_cli(tmp_path, port_path, ref_path, argv):
    """The same export through both CLIs, each in its own working directory
    (the default output lands there): equal exit codes, output and files."""
    tdir, jdir = tmp_path / "port", tmp_path / "ref"
    tdir.mkdir()
    jdir.mkdir()
    got = _port_cli(port_path, argv, tdir)
    want = _ref_cli(ref_path, argv, jdir)
    assert got == want
    assert tpyramid.tree_digest(str(tdir)) == jpyramid.tree_digest(str(jdir))
    return got


SYNTH_CLI = {
    "default-layers": ["--zoom", "0-3"],
    "columnar": ["--zoom", "0-4", "--layers", "bin,ktb2,mvt,geom", "--workers", "1"],
    "pool": ["--zoom", "0-4", "--layers", "ktb2,geom", "--workers", "2"],
    "ceiling": ["--zoom", "0-3", "--layers", "bin", "--max-features", "900"],
    "strict": ["--zoom", "0-3", "--layers", "mvt", "--max-features", "900", "--strict"],
    "strict-many": ["--zoom", "0-5", "--layers", "bin", "--max-features", "10", "--strict"],
    "unlimited": ["--zoom", "0", "--layers", "bin", "--max-features", "0"],
    "parent": ["HEAD^", "--zoom", "3", "--layers", "mvt", "-o", "out"],
    "no-dataset": ["--dataset", "nope", "--layers", "bin"],
    "bad-zoom": ["--zoom", "9-40"],
}


@pytest.mark.parametrize("case", list(SYNTH_CLI))
def test_export_cli_on_synth_like_kart_tpu(synth, tmp_path, case):
    _compare_cli(tmp_path, synth, synth, ["export", "tiles", *SYNTH_CLI[case]])


SHAPES_CLI = {
    "two-datasets": ["--zoom", "0"],
    "all-layers": ["--dataset", "shapes", "--zoom", "0-6",
                   "--layers", "bin,geojson,geom,ktb2,mvt,props"],
    "props-pool": ["--dataset", "shapes", "--zoom", "0-4", "--layers", "props", "--workers", "3"],
    "other": ["--dataset", "other", "--zoom", "2-3", "-o", "o"],
    "full-oid": ["--dataset", "shapes", "--zoom", "1", "--layers", "geom"],
    "no-ref": ["nosuchref", "--dataset", "shapes"],
}


@pytest.mark.parametrize("case", list(SHAPES_CLI))
def test_export_cli_on_shapes_like_kart_tpu(shapes, tmp_path, case):
    argv = SHAPES_CLI[case]
    if case == "full-oid":
        argv = [JRepo(shapes[1]).resolve_refish("HEAD")[0], *argv]
    _compare_cli(tmp_path, *shapes, ["export", "tiles", *argv])


@pytest.mark.parametrize("env", [
    {"KART_TILE_ENCODING": "ktb2,mvt"},
    {"KART_TILE_MAX_FEATURES": "500"}, {"KART_EXPORT_WORKERS": "2", "KART_EXPORT_BATCH_TILES": "7"},
    {"KART_GEOM_SIMPLIFY": "3", "KART_TILE_ENCODING": "geom"},
], ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items()))
def test_export_cli_knobs_like_kart_tpu(synth, tmp_path, monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _compare_cli(tmp_path, synth, synth, ["export", "tiles", "--zoom", "0-3"])


@pytest.mark.parametrize("spec", ["nosuch", "bin,,mvt", "", " , ", "geom"])
def test_default_layers_knob_like_kart_tpu(monkeypatch, spec):
    """A malformed ``KART_TILE_ENCODING`` falls back to bin,geojson (both
    packages log a warning; kart_tpu's carries a time and a request id, so
    the CLI's stderr is not compared for it)."""
    monkeypatch.setenv("KART_TILE_ENCODING", spec)
    assert tencode.default_layers() == jencode.default_layers()
    assert tencode.normalise_layers(None) == jencode.normalise_layers(None)


def test_export_refuses_a_dataset_without_geometry(tmp_path):
    repo, _ = jsynth_repo(str(tmp_path / "attr"), 50, blobs="real")
    _compare_cli(tmp_path, str(repo.workdir), str(repo.workdir), ["export", "tiles"])


def test_export_runs_on_the_card_unless_asked(synth, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["-C", synth, "export", "tiles", "--zoom", "3", "--layers", "bin", "--workers", "1",
            "-o", str(tmp_path / "o")]
    with pytest.raises(runtime.DeviceUnavailable):
        port_main(argv)
    with pytest.raises(runtime.DeviceUnavailable):
        port_main([*argv[:-4], *argv[-2:]])
    tsrc, _ = _sources(synth, synth, "synth")
    for workers in (1, None):
        with pytest.raises(runtime.DeviceUnavailable):
            tpyramid.export_pyramid(tsrc, [3], str(tmp_path / "p"), layers="bin",
                                    workers=workers)


class _CountingCard(tbackend.CpuTorchBackend):
    """A stand-in for the card's backend: counts the batches projected
    through the seam."""

    calls = []

    def merc_envelopes(self, env):
        self.calls.append(len(env))
        return super().merc_envelopes(env)


@pytest.mark.parametrize("knob", [None, "1", "3"])
def test_export_default_on_the_card_projects_in_process(synth, tmp_path, monkeypatch, knob):
    """Without ``workers`` the card's export encodes in this process, one
    projection through the seam a batch with a tile to write, and writes
    kart_tpu's files; ``KART_EXPORT_WORKERS`` still asks for the pool."""
    if knob is None:
        monkeypatch.delenv("KART_EXPORT_WORKERS", raising=False)
    else:
        monkeypatch.setenv("KART_EXPORT_WORKERS", knob)
    card = torch.device("cuda", 0)
    monkeypatch.setattr(tpyramid.runtime, "resolve_device", lambda device=None: card)
    monkeypatch.setattr(tbackend, "select_backend",
                        lambda device=None: _CountingCard(torch.device("cpu")))
    _CountingCard.calls = []
    tsrc, jsrc = _sources(synth, synth, "synth")
    zooms = [0, 1, 2, 3, 4]
    kwargs = {"layers": ("bin", "mvt"), "max_features": 2000, "batch_tiles": 16}
    got = tpyramid.export_pyramid(tsrc, zooms, str(tmp_path / "t"), **kwargs)
    want = jpyramid.export_pyramid(jsrc, zooms, str(tmp_path / "j"), workers=1, **kwargs)
    assert got["export_workers"] == int(knob or 1)
    assert {k: v for k, v in got.items() if k != "export_workers"} == \
        {k: v for k, v in want.items() if k != "export_workers"}
    assert tpyramid.tree_digest(str(tmp_path / "t")) == jpyramid.tree_digest(str(tmp_path / "j"))
    written = {tuple(int(p) for p in os.path.relpath(os.path.join(d, n)[: -len(".ktile")],
                                                      tmp_path / "t").split(os.sep))
               for d, _, names in os.walk(tmp_path / "t") for n in names}
    batches = [b for b in tpyramid.batched(tpyramid.tile_cover(tsrc, zooms), 16)
               if any(a in written for a in b)]
    if knob in (None, "1"):
        assert len(_CountingCard.calls) == len(batches) > 1
    else:
        assert _CountingCard.calls == []


@pytest.mark.parametrize("route", ["card", "cpu"])
def test_export_stdout_differs_from_kart_tpu_only_in_the_card_worker_count(
        synth, tmp_path, monkeypatch, route):
    """C4, a documented divergence: with no ``--workers`` and no
    ``KART_EXPORT_WORKERS``, the card's export encodes in its own process
    and its stdout line says ``1 workers`` where kart_tpu's says its pool's
    count; every other byte of the line, stderr, the exit code and the files
    are kart_tpu's. With ``--device cpu`` the port pools as kart_tpu does and
    prints kart_tpu's count."""
    monkeypatch.delenv("KART_EXPORT_WORKERS", raising=False)
    argv = ["export", "tiles", "--zoom", "0-3", "--layers", "bin"]  # 85 tiles: two batches
    tdir, jdir = tmp_path / "port", tmp_path / "ref"
    tdir.mkdir()
    jdir.mkdir()
    want = _ref_cli(synth, argv, jdir)
    if route == "card":
        card = torch.device("cuda", 0)
        monkeypatch.setattr(tpyramid.runtime, "resolve_device", lambda device=None: card)
        monkeypatch.setattr(tbackend, "select_backend",
                            lambda device=None: tbackend.CpuTorchBackend(torch.device("cpu")))
        out, err = io.StringIO(), io.StringIO()
        monkeypatch.chdir(tdir)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            got = (port_main(["-C", synth, *argv]), out.getvalue(), err.getvalue())
    else:
        got = _port_cli(synth, argv, tdir)
    assert got[0] == want[0] == 0 and got[2] == want[2]
    (t_line,), (j_line,) = got[1].splitlines(), want[1].splitlines()
    t_head, t_workers = t_line.rsplit("; ", 1)
    j_head, j_workers = j_line.rsplit("; ", 1)
    assert t_head == j_head
    assert j_workers == f"{jpyramid.export_workers()} workers]"
    assert t_workers == ("1 workers]" if route == "card" else j_workers)
    assert tpyramid.tree_digest(str(tdir)) == jpyramid.tree_digest(str(jdir))


# --- purity of the new modules ------------------------------------------------------------

NEW_MODULES = ["kart_tpu_torch.tiles", "kart_tpu_torch.tiles.grid", "kart_tpu_torch.tiles.clip",
               "kart_tpu_torch.tiles.source", "kart_tpu_torch.tiles.encode",
               "kart_tpu_torch.tiles.pyramid", "kart_tpu_torch.ops.merc",
               "kart_tpu_torch.cli.tile_cmds", "kart_tpu_torch.tiles.encoder_bench"]
FORBIDDEN = ("jax", "jaxlib", "kart_tpu", "msgpack", "click")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_import_neither_jax_nor_kart_tpu(module):
    rel = module.replace(".", os.sep)
    path = os.path.join(ROOT, rel, "__init__.py")
    if not os.path.exists(path):
        path = os.path.join(ROOT, rel + ".py")
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    bad = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names
           if a.name.split(".")[0] in FORBIDDEN]
    bad += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module
            and n.level == 0 and n.module.split(".")[0] in FORBIDDEN]
    assert not bad


def test_new_modules_load_with_jax_and_kart_tpu_blocked():
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {NEW_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import kart_tpu_torch.tiles as t\n"
        "assert t.normalise_layers('mvt,bin') == ('bin', 'mvt')\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
