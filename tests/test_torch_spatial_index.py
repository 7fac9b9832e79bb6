"""The feature envelope index and the server half of the spatial filter,
held to kart_tpu: ``kart spatial-filter index`` (``--clear``,
``--dry-run``, incremental runs, the legacy ``blobs`` table) writes the
same rows and prints the same line as kart_tpu's, and each package reads
the index the other wrote; ``kart spatial-filter resolve`` prints the same
text and JSON and fails the same way; ``blob_filter_for_spec`` gives the
same verdicts with and without an index, for wrapping and non-wrapping
rects. The datasets are imported by kart_tpu's importer: NZTM polygons and
points, UTM 60S lines and points across the anti-meridian, EPSG:4326
points; and the port's spatial synth layer with every blob real."""

import contextlib
import inspect
import io
import os
import shutil
import sqlite3
from unittest import mock

import numpy as np
import pytest
from click.testing import CliRunner

from helpers import edit_commit
from kart_tpu import crs as jcrs
from kart_tpu.cli import cli as kart_cli
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.geometry import Geometry as JGeometry
from kart_tpu.spatial_filter import blob_filter_for_spec as j_blob_filter
from kart_tpu.spatial_filter.index import EnvelopeIndexReader as JReader
from kart_tpu_torch import synth as tsynth
from kart_tpu_torch.cli import main as port_main
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.spatial_filter import blob_filter_for_spec as t_blob_filter
from kart_tpu_torch.spatial_filter.index import DB_NAME
from kart_tpu_torch.spatial_filter.index import EnvelopeIndexReader as TReader

UTM60S_WKT = jcrs.make_crs("EPSG:32760").wkt


def _utm60s(lon, lat):
    t = jcrs.Transform("EPSG:4326", "EPSG:32760")
    x, y = t.transform(np.asarray(lon, np.float64), np.asarray(lat, np.float64))
    return [(float(a), float(b)) for a, b in zip(x, y)]


def _nztm(lon, lat):
    t = jcrs.Transform("EPSG:4326", "EPSG:2193")
    x, y = t.transform(np.asarray(lon, np.float64), np.asarray(lat, np.float64))
    return [(float(a), float(b)) for a, b in zip(x, y)]


def _pts(coords):
    return ", ".join(f"{float(x)!r} {float(y)!r}" for x, y in coords)


def _layers():
    """table -> (srs_id, WKT, [geometry WKT or None])."""
    rng = np.random.default_rng(4)
    nz_lon, nz_lat = rng.uniform(166.5, 178.5, 60), rng.uniform(-47, -34.5, 60)
    nztm = []
    for i, (x, y) in enumerate(_nztm(nz_lon, nz_lat)):
        if i % 3 == 0:
            d = 500.0 + 200.0 * i
            nztm.append(f"POLYGON (({_pts([(x, y), (x + d, y), (x + d, y + d), (x, y + d), (x, y)])}))")
        else:
            nztm.append(f"POINT ({x!r} {y!r})")
    nztm += [None, "POINT EMPTY"]
    am_lon = np.concatenate([rng.uniform(178.5, 181.5, 40), [179.9, 180.0, 180.1, 186.0]])
    am_lat = np.concatenate([rng.uniform(-40, -10, 40), [-20.0, -20.0, -20.0, -15.0]])
    am = _utm60s(am_lon, am_lat)
    utm = [f"POINT ({x!r} {y!r})" for x, y in am[:30]]
    utm += [f"LINESTRING ({_pts([am[i], am[i + 1]])})" for i in range(30, len(am) - 1, 2)]
    # a line from 179.5 to 180.5 east: its 4326 envelope wraps
    utm.append(f"LINESTRING ({_pts(_utm60s([179.5, 180.5], [-30.0, -29.5]))})")
    wgs = [f"POINT ({_pts([(lon, lat)])})" for lon, lat in zip(rng.uniform(-180, 180, 30),
                                                               rng.uniform(-85, 85, 30))]
    return {
        "nztm": (2193, jcrs.NZTM_WKT, nztm),
        "utm60s": (32760, UTM60S_WKT, utm),
        "wgs": (4326, jcrs.WGS84_WKT, wgs),
    }


def _write_gpkg(path, layers):
    con = sqlite3.connect(path)
    con.executescript(
        """
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
        """
    )
    for table, (srs_id, wkt, geoms) in layers.items():
        con.execute("INSERT INTO gpkg_spatial_ref_sys VALUES (?, ?, 'EPSG', ?, ?, NULL)",
                    (table, srs_id, srs_id, wkt))
        con.execute("INSERT INTO gpkg_contents (table_name, data_type, identifier, srs_id) "
                    "VALUES (?, 'features', ?, ?)", (table, f"{table} title", srs_id))
        con.execute("INSERT INTO gpkg_geometry_columns VALUES (?, 'geom', 'GEOMETRY', ?, 0, 0)",
                    (table, srs_id))
        con.execute(f"CREATE TABLE {table} (fid INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL, "
                    "geom GEOMETRY, name TEXT)")
        for i, g in enumerate(geoms, start=1):
            blob = None if g is None else bytes(JGeometry.from_wkt(g, crs_id=srs_id))
            con.execute(f"INSERT INTO {table} (fid, geom, name) VALUES (?, ?, ?)",
                        (i, blob, f"{table}-{i}"))
    con.commit()
    con.close()
    return path


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """Three layers imported by kart_tpu, then an edit commit: a moved, a
    new and a deleted feature a layer."""
    from kart_tpu.importer import ImportSource
    from kart_tpu.importer.importer import import_sources

    base = tmp_path_factory.mktemp("projected")
    gpkg = _write_gpkg(str(base / "layers.gpkg"), _layers())
    repo = JRepo.init_repository(base / "repo")
    repo.config.set_many({"user.name": "Tester", "user.email": "t@example.com"})
    import_sources(repo, ImportSource.open(gpkg))
    for table, (_srs, _wkt, geoms) in _layers().items():
        ds = repo.structure("HEAD").datasets[table]
        moved = {**ds.get_feature([2]), "name": "moved"}
        moved["geom"] = ds.get_feature([3])["geom"]
        edit_commit(repo, table, updates=[moved], deletes=[4],
                    inserts=[{"fid": 1000, "geom": ds.get_feature([5])["geom"], "name": "new"}],
                    message=f"edit {table}")
    return str(repo.workdir)


@pytest.fixture(scope="module")
def synth_real(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("synthreal") / "r")
    tsynth.synth_repo(path, 6000, blobs="real", spatial=True, seed=2)
    return path


def _copy(src, dest):
    shutil.copytree(src, dest)
    return str(dest)


def _gitdir(path):
    return os.path.join(path, ".kart")


def _rows(path):
    """Both tables of the index, sorted; None when there is no index."""
    db = os.path.join(_gitdir(path), DB_NAME)
    if not os.path.exists(db):
        return None
    con = sqlite3.connect(db)
    try:
        tables = {r[0] for r in con.execute("SELECT name FROM sqlite_master WHERE type='table'")}
        env = "feature_envelopes" if "feature_envelopes" in tables else "blobs"
        return (sorted(con.execute(f"SELECT blob_id, envelope FROM {env}").fetchall()),
                sorted(con.execute("SELECT commit_id FROM commits").fetchall()), sorted(tables))
    finally:
        con.close()


def _port(path, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_main(["--device", "cpu", "-C", path, *argv])
    return rc, out.getvalue(), err.getvalue()


def _ref(path, argv):
    ref = CliRunner().invoke(kart_cli, ["-C", path, *argv], prog_name="kart")
    assert ref.exception is None or isinstance(ref.exception, SystemExit), ref.exception
    return ref.exit_code, ref.stdout, ref.stderr


def _both(src, tmp_path, steps):
    """Run each step (argv, or a callable on the path) on a kart_tpu copy
    and a port copy; after each, equal stdout, exit code and index rows."""
    kpath, ppath = _copy(src, tmp_path / "k"), _copy(src, tmp_path / "p")
    outs = []
    for step in steps:
        if callable(step):
            step(kpath)
            step(ppath)
            continue
        want, got = _ref(kpath, step), _port(ppath, step)
        assert got == want, step
        assert _rows(ppath) == _rows(kpath), step
        outs.append(got[1])
    return kpath, ppath, outs


INDEX = ["spatial-filter", "index"]


def _edit(path):
    """Two edit commits, dated alike in every copy so that the copies
    index the same commit oids (otherwise a second that turns between two
    copies' commits makes their oids differ)."""
    repo = JRepo(path)
    dates = {"GIT_AUTHOR_DATE": "2000000000 +0000", "GIT_COMMITTER_DATE": "2000000000 +0000"}
    with mock.patch.dict(os.environ, dates):
        for table in ("nztm", "utm60s"):
            ds = repo.structure("HEAD").datasets[table]
            edit_commit(repo, table, updates=[{**ds.get_feature([6]), "geom":
                                               ds.get_feature([7])["geom"]}], message="more")


@pytest.mark.parametrize("repo_kind", ["imported", "synth_real"])
def test_index_rows_equal_kart_tpu(request, tmp_path, repo_kind):
    src = request.getfixturevalue(repo_kind)
    _, ppath, outs = _both(src, tmp_path, [INDEX, INDEX])
    assert outs[1] == "Indexed 0 feature envelopes over 0 new commits\n"
    words = outs[0].split()
    envs, commits, _tables = _rows(ppath)
    assert int(words[5]) == len(commits) == (4 if repo_kind == "imported" else 2)
    assert 0 < len(envs) <= int(words[1])


def test_index_incremental_clear_and_dry_run(imported, tmp_path):
    _both(imported, tmp_path, [
        INDEX + ["--dry-run"], INDEX, _edit, INDEX + ["--dry-run"], INDEX, INDEX,
        INDEX + ["--clear", "--dry-run"], INDEX + ["--clear"], INDEX,
    ])


def test_index_anti_meridian_rows_wrap(imported, tmp_path):
    """The UTM 60S layer's envelopes past 180 come out cyclic (w > e) in
    both packages' indexes."""
    _, ppath, _ = _both(imported, tmp_path, [INDEX])
    with TReader.open(_gitdir(ppath)) as reader:
        _oids, env = reader.all_envelopes()
    assert (env[:, 0] > env[:, 2]).any()
    assert (env[:, 0] < -170).any() and (env[:, 2] > 170).any()


def test_each_package_reads_the_other_s_index(imported, tmp_path):
    kpath, ppath, _ = _both(imported, tmp_path, [INDEX])
    j_reader, t_reader = JReader.open(JRepo(ppath)), TReader.open(_gitdir(kpath))
    try:
        j_oids, j_env = j_reader.all_envelopes()
        t_oids, t_env = t_reader.all_envelopes()
    finally:
        j_reader.close()
        t_reader.close()
    assert j_oids == t_oids and len(t_oids)
    assert j_env.tobytes() == t_env.tobytes()


def _legacy(path):
    con = sqlite3.connect(os.path.join(_gitdir(path), DB_NAME))
    con.execute("ALTER TABLE feature_envelopes RENAME TO blobs")
    con.commit()
    con.close()


def test_legacy_blobs_table(imported, tmp_path):
    """An index whose table is still named ``blobs``: the port's reader
    reads it where it is; the writer renames it, then finds every commit
    indexed, as kart_tpu's does."""
    kpath, ppath, _ = _both(imported, tmp_path, [INDEX, _legacy])
    with TReader.open(_gitdir(ppath)) as reader:
        assert reader.table == "blobs"
        legacy = reader.all_envelopes()
    _both(ppath, tmp_path / "again", [INDEX, _edit, INDEX])
    assert _rows(ppath)[2] == ["blobs", "commits"]
    _port(ppath, INDEX)
    assert _rows(ppath)[2] == ["commits", "feature_envelopes"]
    with TReader.open(_gitdir(ppath)) as reader:
        assert reader.all_envelopes()[0] == legacy[0]


# -- resolve -------------------------------------------------------------------

RESOLVE_SPECS = [
    "EPSG:4326;POLYGON((-60 -30,60 -30,60 30,-60 30,-60 -30))",
    "EPSG:2193;POLYGON((1100000 4700000,2100000 4700000,2100000 6200000,1100000 6200000,"
    "1100000 4700000))",
    "EPSG:3857;POLYGON((-1000000 4000000,3000000 4000000,3000000 8000000,-1000000 8000000,"
    "-1000000 4000000))",
    "EPSG:32760;POLYGON((600000 6000000,900000 6000000,900000 7500000,600000 7500000,"
    "600000 6000000))",
    "EPSG:4167;MULTIPOLYGON(((165 -48,179 -48,179 -34,165 -34,165 -48)))",
    "none",
    "nonsense",
    "@/no/such/file",
    "EPSG:4326;LINESTRING(0 0,1 1)",
    "EPSG:999999;POLYGON((0 0,1 0,1 1,0 0))",
]


@pytest.mark.parametrize("fmt", [[], ["-o", "json"], ["-o", "text"]], ids=["default", "json", "text"])
@pytest.mark.parametrize("spec", range(len(RESOLVE_SPECS)))
def test_resolve_matches_kart_tpu(imported, fmt, spec):
    argv = ["spatial-filter", "resolve", *fmt, RESOLVE_SPECS[spec]]
    ref = CliRunner().invoke(kart_cli, ["-C", imported, *argv], prog_name="kart")
    if ref.exception is not None and not isinstance(ref.exception, SystemExit):
        # kart_tpu lets the error out: so does the port, with its message
        with pytest.raises(Exception) as got:
            _port(imported, argv)
        assert (type(got.value).__name__, str(got.value)) == (
            type(ref.exception).__name__, str(ref.exception))
        return
    rc, out, err = _port(imported, argv)
    assert (rc, out) == (ref.exit_code, ref.stdout)
    assert err.splitlines()[-1:] == ref.stderr.splitlines()[-1:]


@pytest.mark.parametrize("spec", [0, 1, 3])
def test_resolve_the_repo_s_filter(imported, tmp_path, spec):
    """No spec: the filter in the repo's config (and none before it is set)."""
    from kart_tpu.spatial_filter import ResolvedSpatialFilterSpec

    path = _copy(imported, tmp_path / "r")
    for fmt in ([], ["-o", "json"]):
        assert _port(path, ["spatial-filter", "resolve", *fmt]) == _ref(
            path, ["spatial-filter", "resolve", *fmt])
    JRepo(path).config.set_many(
        ResolvedSpatialFilterSpec.from_spec_string(RESOLVE_SPECS[spec]).config_items())
    for fmt in ([], ["-o", "json"]):
        got = _port(path, ["spatial-filter", "resolve", *fmt])
        assert got == _ref(path, ["spatial-filter", "resolve", *fmt]) and got[0] == 0


# -- blob_filter_for_spec --------------------------------------------------------

#: w,s,e,n in EPSG:4326: New Zealand, a rect wrapping the anti-meridian, the
#: whole world, a rect near nothing, and a band of the synth globe
BLOB_RECTS = ["166,-48,179,-34", "179,-35,-179,-15", (-180.0, -90.0, 180.0, 90.0),
              "10,10,11,11", (-60.0, -30.0, 60.0, 30.0), "170.5,-41.5,175.25,-36"]


def _all_blobs(path):
    """(path, oid) of every blob of HEAD and HEAD^."""
    repo = JRepo(path)
    out = set()
    for rev in ("HEAD", "HEAD^"):
        out.update((p, e.oid) for p, e in repo.structure(rev).tree.walk_blobs())
    return sorted(out)


@pytest.fixture
def f32_reference(monkeypatch):
    """kart_tpu's pre-pass on its f32 device route (XLA-CPU here), the
    route K3 ports."""
    import kart_tpu.ops.bbox as ref_bbox

    monkeypatch.setattr(ref_bbox, "DEVICE_MIN_ENVELOPES", 0)
    monkeypatch.setattr(ref_bbox, "RESIDENT_MIN_ENVELOPES", 0)


@pytest.mark.parametrize("with_index", [True, False], ids=["index", "decode"])
@pytest.mark.parametrize("repo_kind", ["imported", "synth_real"])
def test_blob_filter_verdicts_equal_kart_tpu(request, tmp_path, f32_reference, repo_kind,
                                             with_index):
    path = _copy(request.getfixturevalue(repo_kind), tmp_path / "r")
    if with_index:
        _port(path, INDEX)
    blobs = _all_blobs(path)
    jrepo, trepo = JRepo(path), TRepo(path)
    seen = set()
    for rect in BLOB_RECTS:
        jf, tf = j_blob_filter(jrepo, rect), t_blob_filter(trepo, rect, device="cpu")
        got = [tf(p, o) for p, o in blobs]
        assert got == [jf(p, o) for p, o in blobs], rect
        closure = inspect.getclosurevars(tf).nonlocals
        assert (closure["matched_oids"] is None) != with_index
        seen.add(sum(got))
    assert len(seen) > 2  # the rects keep different sets of blobs


def test_blob_filter_blobs_the_index_lacks(imported, tmp_path, f32_reference):
    """An index of the first commit only: the second commit's new blobs are
    decoded on the fly, in both packages alike."""
    path = _copy(imported, tmp_path / "r")
    repo = JRepo(path)
    head = repo.refs.head_resolved()
    branch = repo.refs.head_branch()
    repo.refs.set(branch, repo.odb.read_commit(head).parents[0])
    for _ in range(2):
        repo.refs.set(branch, repo.odb.read_commit(repo.refs.head_resolved()).parents[0])
    _port(path, INDEX)
    repo.refs.set(branch, head)
    blobs = _all_blobs(path)
    trepo = TRepo(path)
    for rect in BLOB_RECTS:
        tf = t_blob_filter(trepo, rect, device="cpu")
        assert [tf(p, o) for p, o in blobs] == [j_blob_filter(repo, rect)(p, o)
                                                for p, o in blobs], rect


def test_blob_filter_on_the_card_launches_k3_or_raises(imported, tmp_path):
    """Asked for the card (the default) where there is none, the blob
    filter raises, with or without an index: nothing falls back to the
    CPU."""
    import torch

    from kart_tpu_torch.runtime import DeviceUnavailable

    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py covers it")
    path = _copy(imported, tmp_path / "r")
    trepo = TRepo(path)
    for _ in range(2):
        with pytest.raises(DeviceUnavailable):
            t_blob_filter(trepo, "0,0,1,1")
        _port(path, INDEX)


# -- projected datasets in the filtered diff ---------------------------------------

ROBINSON_WKT = (
    'PROJCS["World_Robinson",GEOGCS["WGS 84",DATUM["WGS_1984",'
    'SPHEROID["WGS 84",6378137,298.257223563]],PRIMEM["Greenwich",0],'
    'UNIT["degree",0.0174532925199433]],PROJECTION["Robinson"],'
    'PARAMETER["central_meridian",0],PARAMETER["false_easting",0],'
    'PARAMETER["false_northing",0],UNIT["metre",1]]'
)

DIFF_FILTERS = {
    "nz_4326": "EPSG:4326;POLYGON((166 -48,179 -48,179 -34,166 -34,166 -48))",
    "nztm": "EPSG:2193;POLYGON((1100000 4800000,2000000 4800000,2000000 6000000,"
            "1100000 6000000,1100000 4800000))",
    "webmerc": "EPSG:3857;POLYGON((19800000 -4500000,20037000 -4500000,20037000 -1100000,"
               "19800000 -1100000,19800000 -4500000))",
    "utm60s": "EPSG:32760;POLYGON((700000 6500000,900000 6500000,900000 8900000,"
              "700000 8900000,700000 6500000))",
    "robinson": f"{ROBINSON_WKT};POLYGON((0 0,1000000 0,1000000 1000000,0 1000000,0 0))",
}

DIFF_FORMATS = [
    ("-o", "json-lines"), ("-o", "json"), ("-o", "text"), ("-o", "geojson"),
    ("-o", "feature-count"), ("-o", "geojson", "--crs", "EPSG:2193"),
    ("-o", "json-lines", "--crs", "EPSG:3857"), ("-o", "quiet", "--exit-code"),
]


def _sidecars(path, envelopes):
    """Sidecars of every dataset at HEAD~3 and HEAD, written by kart_tpu:
    plain, or with the envelope column (EPSG:4326, moved there as the
    envelope index moves them, anti-meridian wrapped)."""
    from kart_tpu.diff import sidecar as jsidecar
    from kart_tpu.diff.sidecar import _feature_envelope_wsen
    from kart_tpu.spatial_filter.index import wrap_lon

    def wsen_4326(ds, pk, t):
        w, s, e, n = _feature_envelope_wsen(ds.get_feature([int(pk)]), "geom")
        if t is None or (w, s, e, n) == (-180.0, -90.0, 180.0, 90.0):
            return (w, s, e, n)
        x0, x1, y0, y1 = t.transform_envelope((w, e, s, n))
        return (float(wrap_lon(x0)), y0, float(wrap_lon(x1)), y1)

    repo = JRepo(path)
    for rev in ("HEAD~3", "HEAD"):
        for ds in repo.structure(rev).datasets:
            if not envelopes:
                jsidecar.build_sidecar(repo, ds)
                continue
            crs = jcrs.CRS(ds.get_crs_definition())
            t = None if crs.is_geographic else jcrs.Transform(crs, "EPSG:4326")
            _paths, pks, oids = ds.feature_index()
            envs = np.asarray([wsen_4326(ds, pk, t) for pk in pks], dtype=np.float64)
            jsidecar.save_sidecar(repo, ds.feature_tree.oid, pks.astype(np.int64), oids,
                                  envelopes=envs)


@pytest.fixture(scope="module")
def diff_routes(imported, tmp_path_factory):
    base = tmp_path_factory.mktemp("routes")
    out = {"tree": _copy(imported, base / "tree")}
    for route in ("plain", "envelopes"):
        out[route] = _copy(imported, base / route)
        _sidecars(out[route], route == "envelopes")
    return out


@pytest.mark.parametrize("flt", sorted(DIFF_FILTERS))
@pytest.mark.parametrize("route", ["tree", "plain", "envelopes"])
def test_projected_datasets_filtered_diff_matches_kart_tpu(diff_routes, tmp_path, route, flt):
    """NZTM, UTM 60S and EPSG:4326 datasets under geographic, projected and
    unsupported (fail-open) filters: the port's stdout and exit code equal
    kart_tpu's in every format, on the tree walk and both sidecar routes."""
    from kart_tpu.spatial_filter import ResolvedSpatialFilterSpec

    path = _copy(diff_routes[route], tmp_path / "r")
    JRepo(path).config.set_many(
        ResolvedSpatialFilterSpec.from_spec_string(DIFF_FILTERS[flt]).config_items())
    counts = {}
    for fmt in DIFF_FORMATS:
        argv = ["diff", *fmt, "HEAD~3...HEAD"]
        want = _ref(path, argv)
        got = _port(path, argv)
        assert got[:2] == want[:2], fmt
        counts[fmt] = got[1].count('"type":"feature"')
    # each filter keeps some of the 9 feature edits (the NULL and empty
    # geometries match every filter); the unsupported one keeps all
    assert 0 < counts[("-o", "json-lines")] <= (18 if flt == "robinson" else 17)


@pytest.fixture(scope="module")
def nztm_synth(tmp_path_factory):
    """The port's spatial synth with its points in NZTM (EPSG:2193) and its
    sidecars' EPSG:4326 envelope columns."""
    path = str(tmp_path_factory.mktemp("nztmsynth") / "r")
    tsynth.synth_repo(path, 20_000, blobs="changed", spatial=True, seed=3, crs="EPSG:2193")
    return path


#: an NZTM polygon over New Zealand, and an EPSG:4326 rectangle over it
NZTM_SYNTH_FILTERS = [
    "EPSG:2193;POLYGON((1090000 4740000,2100000 4740000,2100000 6200000,1090000 6200000,"
    "1090000 4740000))",
    "EPSG:4326;POLYGON((166 -48,179 -48,179 -34,166 -34,166 -48))",
]


@pytest.mark.parametrize("flt", range(len(NZTM_SYNTH_FILTERS)))
def test_nztm_synth_filtered_diff_matches_kart_tpu(nztm_synth, tmp_path, flt):
    """The layer ``tests/test_torch_cuda.py`` diffs on the card: the port
    (--device cpu) prints kart_tpu's bytes for it, filtered through the
    envelope prefilter, so the card's equal bytes are kart_tpu's too."""
    from kart_tpu.spatial_filter import ResolvedSpatialFilterSpec

    path = _copy(nztm_synth, tmp_path / "r")
    ds = TRepo(path).structure("HEAD").datasets["synth"]
    assert ds.get_crs_definition() == jcrs.NZTM_WKT
    JRepo(path).config.set_many(
        ResolvedSpatialFilterSpec.from_spec_string(NZTM_SYNTH_FILTERS[flt]).config_items())
    for fmt in (("-o", "json-lines"), ("-o", "feature-count"), ("-o", "json"),
                ("-o", "geojson", "--crs", "EPSG:4326")):
        argv = ["diff", *fmt, "HEAD^...HEAD"]
        want, got = _ref(path, argv), _port(path, argv)
        assert got[:2] == want[:2], fmt
        if fmt == ("-o", "json-lines"):
            assert 0 < got[1].count('"type":"feature"') < 200
