"""``kart init --import`` and ``kart import`` in the port against
kart_tpu's, on the CPU: the same commit (so the same tree and blob oids),
the same sidecar bytes and the same stdout, stderr (the import's rate line
aside) and exit code, for GeoPackage, GeoJSON, GeoJSONSeq and CSV sources,
``--primary-key``, generated pks, ``--replace-existing`` and
``--replace-ids``; ``--list``; Shapefile, FlatGeobuf and database sources
that are not there (kart_tpu's exit code and message). The Shapefile,
FlatGeobuf and database sources themselves are held by
``test_torch_shapefile.py``, ``test_torch_flatgeobuf.py`` and
``test_torch_db_import.py``. A sidecar is written from 10,000 features
(``SIDECAR_MIN_FEATURES``): the tests lower the threshold in both
packages to see one at a few hundred rows."""

import json
import os
import sqlite3

import pytest

from helpers import create_attributes_gpkg, create_points_gpkg
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.diff import sidecar as port_sidecar
from kart_tpu_torch.models.dataset import Dataset3
from test_torch_workingcopy import USER, Pair, kart, masked, port, wc_tables

DATE = "1700000000 +0000"


@pytest.fixture(autouse=True)
def _pinned_dates(monkeypatch):
    monkeypatch.setenv("GIT_AUTHOR_DATE", DATE)
    monkeypatch.setenv("GIT_COMMITTER_DATE", DATE)


@pytest.fixture(autouse=True)
def _sidecars_at_any_size(monkeypatch):
    import kart_tpu.importer.importer as jimporter

    import kart_tpu_torch.importer.importer as timporter

    monkeypatch.setattr(jimporter, "SIDECAR_MIN_FEATURES", 0)
    monkeypatch.setattr(timporter, "SIDECAR_MIN_FEATURES", 0)


def _geojson(path, n, *, with_id=True):
    feats = []
    for i in range(1, n + 1):
        props = {"name": f"f{i}", "score": i * 1.5, "count": i, "flag": i % 2 == 0}
        if with_id:
            props = {"id": i, **props}
        if i % 7 == 0:
            props["name"] = None
        geom = ({"type": "Point", "coordinates": [170 + i / 100, -40 - i / 100]} if i % 5
                else {"type": "LineString", "coordinates": [[1, 2], [3, 4 + i]]})
        feats.append({"type": "Feature", "properties": props, "geometry": geom})
    return {"type": "FeatureCollection", "features": feats}


def _write_sources(d, n):
    out = {"points": create_points_gpkg(os.path.join(d, "points.gpkg"), n=n),
           "records": create_attributes_gpkg(os.path.join(d, "records.gpkg"), n=n)}
    for name, with_id in (("withid", True), ("noid", False)):
        path = os.path.join(d, f"{name}.geojson")
        with open(path, "w") as f:
            json.dump(_geojson(path, n, with_id=with_id), f)
        out[f"geojson_{name}"] = path
    path = os.path.join(d, "seq.geojsonl")
    with open(path, "w") as f:
        for feat in _geojson(path, n)["features"]:
            f.write(json.dumps(feat) + "\n")
    out["geojsonseq"] = path
    for name, header, row in (
            ("withid", "id,name,value,wkt", lambda i: f"{i},n{i},{i * 0.25},POINT ({i} {-i})"),
            ("noid", "name,value,note", lambda i: f"n{i % 9},{i % 4},{'' if i % 3 else 'x'}")):
        path = os.path.join(d, f"{name}.csv")
        with open(path, "w") as f:
            f.write(header + "\n" + "".join(row(i) + "\n" for i in range(1, n + 1)))
        out[f"csv_{name}"] = path
    return out


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("importsrc")
    return {**_write_sources(str(d), 120), "dir": str(d)}


def _columnar(path):
    d = os.path.join(path, ".kart", "columnar")
    if not os.path.isdir(d):
        return {}
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _same_repos(pair):
    k, p = pair.heads()
    assert k == p and k is not None
    assert _columnar(pair.p) == _columnar(pair.k)


CASES = {
    "gpkg": (["points"], []),
    "gpkg_attributes": (["records"], []),
    "gpkg_two_sources": (["points", "records"], ["-m", "two"]),
    "geojson": (["geojson_withid"], []),
    "geojson_generated_pk": (["geojson_noid"], []),
    "geojsonseq": (["geojsonseq"], ["--dest-path", "seq/layer"]),
    "csv": (["csv_withid"], ["--crs", "EPSG:2193"]),
    "csv_generated_pk": (["csv_noid"], []),
    "primary_key_text": (["points"], ["--primary-key", "name"]),
    "primary_key_int": (["records"], ["--primary-key", "amount", "--table", "records"]),
    "no_checkout": (["points"], ["--no-checkout"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_import(sources, tmp_path, case):
    names, args = CASES[case]
    pair = Pair(tmp_path, [sources[n] for n in names], args)
    _same_repos(pair)
    for argv in (["diff", "HEAD^?...HEAD", "-o", "json"], ["data", "ls"], ["status"]):
        pair.run(argv)


@pytest.mark.parametrize("case", ["points", "geojson_withid", "csv_noid"])
def test_init_import(sources, tmp_path, case):
    """``init --import`` in one step, with an initial branch and message."""
    k, p = str(tmp_path / "k" / "repo"), str(tmp_path / "p" / "repo")
    argv = ["init", "--import", sources[case], "-b", "trunk", "-m", "first",
            "--workingcopy-location", "wc.gpkg"]
    ref = masked(kart([*argv, k]), k)
    got = masked(port([*argv, p]), p)
    assert got == ref and got[0] == 0
    assert JRepo(k).head_commit_oid == TRepo(p).head_commit_oid
    assert _columnar(p) == _columnar(k)
    assert wc_tables(os.path.join(p, "wc.gpkg")) == wc_tables(os.path.join(k, "wc.gpkg"))


@pytest.mark.parametrize("case", ["gpkg", "geojson_generated_pk", "csv_generated_pk"])
def test_replace_existing(sources, tmp_path, case):
    """A second import of the source over the first: generated pks keep
    their values where the content matches."""
    names, _ = CASES[case]
    pair = Pair(tmp_path, [sources[n] for n in names])
    # exists already: both raise, uncaught by either entry point (exit 1)
    errors = []
    for runner, path in ((kart, pair.k), (port, pair.p)):
        with pytest.raises(RuntimeError) as e:
            runner(["-C", path, "import", sources[names[0]]])
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "already exists" in errors[0]
    pair.run(["import", "--replace-existing", sources[names[0]]], code=0)
    _same_repos(pair)


@pytest.mark.parametrize("ids", ["3\n7\n500\n", "", "@file"])
def test_replace_ids(sources, tmp_path, ids):
    """``--replace-ids`` from a second GPKG at the source's path (its column
    ids follow the path): the listed ids re-imported, a listed id the source
    lacks deleted; the new sidecar derived from the old one, byte-equal to
    kart_tpu's and to a walk of the tree."""
    src = str(tmp_path / "src" / "points.gpkg")
    os.makedirs(os.path.dirname(src))
    create_points_gpkg(src, n=120)
    pair = Pair(tmp_path, [src])
    os.remove(src)
    create_points_gpkg(src, n=140)
    con = sqlite3.connect(src)
    con.execute("UPDATE points SET name = 'replaced-' || fid, rating = -rating")
    con.execute("DELETE FROM points WHERE fid IN (1, 7)")
    con.commit()
    con.close()
    if ids == "@file":
        path = str(tmp_path / "ids.txt")
        with open(path, "w") as f:
            f.write("1\n130\n121\n")
        ids = "@" + path
    pair.run(["import", "--replace-ids", ids, src], code=0)
    _same_repos(pair)
    repo = TRepo(pair.p)
    ds = repo.structure().datasets["points"]
    block = port_sidecar.load_block(repo, ds)
    assert block is not None
    _, pks, oids = ds.feature_index()
    order = pks.argsort()
    assert (block.keys[: block.count] == pks[order]).all()
    assert (block.oids[: block.count].view("u1").reshape(-1, 20) == oids[order]).all()
    pair.run(["diff", "HEAD^...HEAD", "-o", "json"])
    pair.run(["status"])


def test_import_sidecar_is_the_walk(sources, tmp_path):
    """The captured sidecar's keys and oids are a walk of the feature tree."""
    pair = Pair(tmp_path, [sources["points"]])
    repo = TRepo(pair.p)
    ds = repo.structure().datasets["points"]
    block = port_sidecar.load_block(repo, ds)
    _, pks, oids = ds.feature_index()
    order = pks.argsort()  # tree order is not pk order
    assert block.count == len(pks) == 120
    assert (block.keys[:120] == pks[order]).all()
    assert (block.oids[:120].view("u1").reshape(-1, 20) == oids[order]).all()
    node = repo.odb.tree(repo.head_tree_oid).get(f"points/{Dataset3.DATASET_DIRNAME}/feature")
    assert port_sidecar.has_sidecar(repo, ds) and node.oid == ds.feature_tree.oid


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_import_list(sources, tmp_path, fmt):
    pair = Pair(tmp_path, [])
    pair.run(["import", "--list", "-o", fmt, sources["points"], sources["records"],
              sources["geojson_withid"]], code=0)


ERRORS = [
    ["import", "nosuch.txt"],
    ["import", "--table", "nosuch", "{points}"],
    ["import", "--list", "--table", "points", "{points}"],
    ["import", "--all-tables", "--table", "points", "{points}"],
    ["import", "--dest-path", "x", "{points}", "{records}"],
    ["import", "--primary-key", "nosuch", "{points}"],
    ["import", "--crs", "EPSG:4326", "{points}"],
    ["import", "--crs", "EPSG:1", "{geojson_withid}"],
    ["import", "--replace-ids", "@/nonexistent/ids", "{points}"],
    ["import"],
    ["import", "--nosuch", "x"],
    ["init", "--nosuch", "{dir}/x"],
]


@pytest.mark.parametrize("argv", ERRORS, ids=lambda a: " ".join(a))
def test_import_errors(sources, tmp_path, argv):
    pair = Pair(tmp_path, [])
    argv = [a.format(**sources) for a in argv]
    rc = pair.run(argv)[0]
    assert rc != 0


def test_import_into_populated_repo_and_empty_repo_status(sources, tmp_path):
    pair = Pair(tmp_path, [])
    pair.run(["status"], code=0)
    pair.run(["status", "-o", "json"], code=0)
    pair.run(["import", sources["points"]], code=0)
    pair.run(["import", sources["records"], "-m", "records too"], code=0)
    _same_repos(pair)
    pair.run(["log", "-o", "json"])


@pytest.mark.parametrize("spec", ["layer.shp", "layer.zip", "layer.fgb",
                                  "postgresql://h/db", "mysql://h/db", "mssql://h/db"])
def test_unported_sources_exit_30(tmp_path, spec):
    """Shapefile, FlatGeobuf and database sources that are not there (no
    such file, no database driver on this machine): ``import`` and ``init
    --import`` exit with kart_tpu's code and message, and write what it
    writes (``import`` nothing, ``init --import`` the new repository)."""
    results = []
    for run, repo_cls, side in ((kart, JRepo, "k"), (port, TRepo, "p")):
        repo = str(tmp_path / side / "repo")
        assert run(["init", repo])[0] == 0
        repo_cls(repo).config.set_many(USER)
        before = _files(repo)
        res = masked(run(["-C", repo, "import", spec]), repo)
        unchanged = _files(repo) == before
        fresh = str(tmp_path / side / "fresh")
        res_init = masked(run(["init", "--import", spec, fresh]), fresh)
        made = sorted(_files(fresh)) if os.path.exists(fresh) else None
        results.append((res, unchanged, res_init, made))
    assert results[1] == results[0]
    assert results[1][0][0] != 0 and results[1][1]


def _files(path):
    """{relative path: bytes} under ``path``, reflogs (the wall clock) aside."""
    out = {}
    for d, dirs, names in os.walk(path):
        dirs[:] = [x for x in dirs if x != "logs"]
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), path)] = f.read()
    return out


def test_rate_line(sources, tmp_path):
    """The import's last stderr line is its rate, as kart_tpu prints it."""
    repo = str(tmp_path / "repo")
    rc, _, err = port(["init", "--import", sources["points"], repo])
    assert rc == 0
    last = err.strip().splitlines()[-1]
    assert last.startswith("Imported 120 features in ") and last.endswith(" features/s)")
