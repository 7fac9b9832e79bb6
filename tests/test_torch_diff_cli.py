"""``python -m kart_tpu_torch --device cpu -C <repo> diff|show|create-patch
...`` against kart_tpu's CLI: identical stdout, files and exit code for
every format (text, json, json-lines, geojson, html, quiet,
feature-count), ``--crs``, commit spec, filter and option case, on the
columnar route (sidecars present) and the tree route (sidecars removed),
on an imported GPKG points repo and a synthetic repo; ``show`` and
``create-patch`` at the root commit and later ones; a two-dataset GeoJSON
``--output DIR``; the port's fused json-lines row route against its
delta route; and hash-keyed datasets (a text pk, a composite pk, the
legacy layout with no path-structure.json, a pk retyped from int to text)
on both routes, with keys at both ends of the key range and forced key
collisions; projected ``--crs`` targets and dataset CRSes (NZTM). What
the port still refuses (a working-copy diff) exits 30 with no output."""

import contextlib
import io
import os
import shutil
import sys

import numpy as np
import pytest
from click.testing import CliRunner

from helpers import edit_commit, make_imported_repo, make_repo_with_edits
from kart_tpu.cli import cli as kart_cli
from kart_tpu.cli import entrypoint as kart_entrypoint
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.core.repo import NotFound as JNotFound
from kart_tpu.diff import sidecar as jsidecar
from kart_tpu.synth import synth_repo as jsynth_repo
from kart_tpu_torch.cli import main as port_main
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.diff import engine, sidecar
from kart_tpu_torch.diff.writers import JsonLinesDiffWriter

SYNTH_N = 5000


def _with_sidecars(path):
    """Build both revisions' sidecars with kart_tpu (the points repo is too
    small for its importer to write them)."""
    repo = JRepo(path)
    for rev in ("HEAD", "HEAD^"):
        for ds in repo.structure(rev).datasets:
            jsidecar.build_sidecar(repo, ds)
    return path


def _without_sidecars(path, dest):
    shutil.copytree(path, dest)
    shutil.rmtree(os.path.join(dest, ".kart", "columnar"), ignore_errors=True)
    return str(dest)


@pytest.fixture(scope="module")
def repos(tmp_path_factory):
    base = tmp_path_factory.mktemp("diffcli")
    (base / "p").mkdir()
    points, _ = make_repo_with_edits(base / "p", n=40)
    _with_sidecars(points)
    jsynth_repo(str(base / "synth"), SYNTH_N, blobs="changed", seed=5)
    edit_rows = np.random.default_rng(6).choice(SYNTH_N, SYNTH_N // 100, replace=False)
    out = {
        ("points", "columnar"): (points, "points", "2"),
        ("points", "tree"): (_without_sidecars(points, base / "p_tree"), "points", "2"),
        ("synth", "columnar"): (str(base / "synth"), "synth", str((1 << 24) + int(edit_rows[0]))),
    }
    out[("synth", "tree")] = (_without_sidecars(out[("synth", "columnar")][0], base / "s_tree"),
                              "synth", out[("synth", "columnar")][2])
    for (name, route), (path, ds_path, _pk) in out.items():
        trepo = TRepo(path)
        for rev in ("HEAD", "HEAD^"):
            ds = trepo.structure(rev).datasets[ds_path]
            assert sidecar.has_sidecar(trepo, ds) == (route == "columnar"), (name, route, rev)
    return out


VARIANTS = [
    ("-o", "json"),
    ("-o", "json", "--json-style", "compact"),
    ("-o", "json-lines"),
    ("-o", "feature-count"),
    ("-o", "quiet"),
    ("-o", "json-lines", "--exit-code"),
    ("-o", "text"),
    ("-o", "text", "--exit-code"),
    ("-o", "geojson"),
]
#: --crs EPSG:4277 (OSGB 1936, a 7-parameter datum shift from WGS 84), on
#: the points repo only: the synth has no geometry
CRS_VARIANTS = [
    ("-o", "json", "--crs", "EPSG:4277"),
    ("-o", "json-lines", "--crs", "EPSG:4277"),
    ("-o", "text", "--crs", "EPSG:4277"),
    ("-o", "geojson", "--crs", "EPSG:4277"),
]
SPECS = ["HEAD^...HEAD", "HEAD^..HEAD", "HEAD...HEAD"]
FILTERS = ["none", "ds", "ds:pk"]
CASES = [
    (repo, route, v, spec, flt)
    for repo in ("points", "synth") for route in ("columnar", "tree")
    for v in range(len(VARIANTS)) for spec in SPECS for flt in FILTERS
]


def _case_id(case):
    repo, route, v, spec, flt = case
    return f"{repo}-{route}-{'_'.join(VARIANTS[v][1:])}-{spec}-{flt}"


def _run_port(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_main(argv)
    return rc, out.getvalue()


def _compare(path, opts):
    ref = CliRunner().invoke(kart_cli, ["-C", path, *opts])
    assert ref.exception is None or isinstance(ref.exception, SystemExit), ref.exception
    rc, out = _run_port(["--device", "cpu", "-C", path, *opts])
    assert rc == ref.exit_code
    assert out == ref.stdout
    return out


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_diff_matches_kart_tpu(repos, case):
    repo, route, v, spec, flt = case
    path, ds_path, pk = repos[(repo, route)]
    filters = {"none": [], "ds": [ds_path], "ds:pk": [f"{ds_path}:{pk}"]}[flt]
    opts = [*VARIANTS[v], spec, *filters]
    out = _compare(path, ["diff", *opts])
    if spec != "HEAD...HEAD" and "quiet" not in opts:
        assert out.strip()  # a non-trivial comparison


@pytest.mark.parametrize("flt", FILTERS)
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("route", ["columnar", "tree"])
@pytest.mark.parametrize("v", range(len(CRS_VARIANTS)), ids=lambda v: CRS_VARIANTS[v][1])
def test_diff_crs_matches_kart_tpu(repos, v, route, spec, flt):
    path, ds_path, pk = repos[("points", route)]
    filters = {"none": [], "ds": [ds_path], "ds:pk": [f"{ds_path}:{pk}"]}[flt]
    out = _compare(path, ["diff", *CRS_VARIANTS[v], spec, *filters])
    if spec != "HEAD...HEAD":
        assert out.strip()


def _history_repo(tmp_path):
    """Four commits: the points import (the root), a second dataset
    ``others`` imported beside it, an edit of each. -> its path."""
    from kart_tpu.importer import ImportSource
    from kart_tpu.importer.importer import import_sources

    from helpers import create_points_gpkg

    repo, ds_path = make_imported_repo(tmp_path, n=12)
    import_sources(repo, ImportSource.open(
        create_points_gpkg(str(tmp_path / "others.gpkg"), n=6, table="others")))
    ds = repo.datasets()[ds_path]
    edit_commit(repo, ds_path, updates=[{**ds.get_feature([3]), "rating": 7.25}], deletes=[4],
                inserts=[{"fid": 50, "geom": None, "name": "fifty", "rating": None}])
    others = repo.datasets()["others"]
    edit_commit(repo, "others", updates=[{**others.get_feature([2]), "name": "two"}],
                deletes=[5], message="edit others\n\nwith a body line")
    return str(repo.workdir)


@pytest.fixture(scope="module")
def history(tmp_path_factory):
    return _history_repo(tmp_path_factory.mktemp("history"))


REVS = ["HEAD", "HEAD^", "HEAD~3"]
SHOW_VARIANTS = [(), ("-o", "json"), ("-o", "json-lines"), ("-o", "geojson"),
                 ("-o", "json", "--json-style", "extracompact"), ("--crs", "EPSG:4277"),
                 ("-o", "json", "--crs", "EPSG:4277")]


@pytest.mark.parametrize("rev", REVS)
@pytest.mark.parametrize("v", range(len(SHOW_VARIANTS)), ids=lambda v: "_".join(SHOW_VARIANTS[v]))
def test_show_matches_kart_tpu(history, v, rev):
    assert _compare(history, ["show", *SHOW_VARIANTS[v], rev]).strip()


@pytest.mark.parametrize("rev", REVS)
@pytest.mark.parametrize("patch_type", ["full", "minimal"])
def test_create_patch_matches_kart_tpu(history, tmp_path, patch_type, rev):
    out = _compare(history, ["create-patch", "--patch-type", patch_type, rev])
    assert '"kart.patch/v1"' in out
    ref_file, port_file = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    ref = CliRunner().invoke(kart_cli, ["-C", history, "create-patch", "--patch-type",
                                        patch_type, "--output", ref_file, rev])
    rc, out = _run_port(["--device", "cpu", "-C", history, "create-patch", "--patch-type",
                         patch_type, "--output", port_file, rev])
    assert (rc, out) == (ref.exit_code, ref.stdout) == (0, "")
    with open(ref_file) as a, open(port_file) as b:
        assert a.read() == b.read()


def _files(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name)) as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("crs", [(), ("--crs", "EPSG:4277")])
def test_two_dataset_geojson_output_dir(history, tmp_path, capsys, crs):
    """A diff of two datasets writes one GeoJSON file each into
    ``--output DIR``; without it, both refuse with the same usage error."""
    spec = "HEAD~2...HEAD"
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref = CliRunner().invoke(kart_cli, ["-C", history, "diff", "-o", "geojson", *crs,
                                        "--output", ref_dir, spec])
    rc, out = _run_port(["--device", "cpu", "-C", history, "diff", "-o", "geojson", *crs,
                         "--output", port_dir, spec])
    assert (rc, out) == (ref.exit_code, ref.stdout) == (0, "")
    assert _files(port_dir) == _files(ref_dir)
    assert sorted(_files(port_dir)) == ["others.geojson", "points.geojson"]
    ref = CliRunner().invoke(kart_cli, ["-C", history, "diff", "-o", "geojson", spec],
                             prog_name="kart")
    capsys.readouterr()
    rc, out = _run_port(["--device", "cpu", "-C", history, "diff", "-o", "geojson", spec])
    err = capsys.readouterr().err
    assert (rc, out, err) == (ref.exit_code, ref.stdout, ref.stderr)
    assert rc == 2 and "Need an --output directory" in err


@pytest.mark.parametrize("argv", [["diff", "-o", "html", "HEAD~2...HEAD"],
                                  ["diff", "-o", "html", "--crs", "EPSG:4277", "HEAD^...HEAD"],
                                  ["show", "-o", "html", "HEAD~3"]])
def test_html_matches_kart_tpu(history, tmp_path, monkeypatch, capsys, argv):
    """The HTML page, to ``--output`` and (without it) to ``diff.html`` in
    the current directory, with ``Wrote <path>`` on stderr."""
    outputs = {}
    for who in ("ref", "port"):
        d = tmp_path / who
        d.mkdir()
        monkeypatch.chdir(d)
        extra = [] if argv[0] == "show" else ["--output", str(d / "page.html")]
        if who == "ref":
            r = CliRunner().invoke(kart_cli, ["-C", history, *argv, *extra])
            got = (r.exit_code, r.stdout, r.stderr)
        else:
            capsys.readouterr()
            rc, out = _run_port(["--device", "cpu", "-C", history, *argv, *extra])
            got = (rc, out, capsys.readouterr().err)
        outputs[who] = (got[0], got[1], got[2].replace(str(d), "<dir>"), _files(d))
    assert outputs["port"] == outputs["ref"]
    html = next(iter(outputs["port"][3].values()))
    assert html.startswith("<!DOCTYPE html>") and '"FeatureCollection"' in html


@pytest.mark.parametrize("spec", ["nosuch...HEAD", "HEAD^^...HEAD", "HEAD..nosuch"])
def test_bad_commit_spec_like_kart_tpu(repos, spec, monkeypatch, capsys):
    path = repos[("points", "columnar")][0]
    monkeypatch.setattr(sys, "argv", ["kart", "-C", path, "diff", "-o", "json", spec])
    with pytest.raises(SystemExit) as e:
        kart_entrypoint()
    ref = capsys.readouterr()
    rc = port_main(["--device", "cpu", "-C", path, "diff", "-o", "json", spec])
    got = capsys.readouterr()
    assert rc == e.value.code == 40
    assert got.err == ref.err and got.out == ref.out == ""


def _jsonl(path, monkeypatch, fused):
    """json-lines through the fused row route, or with it refused so that
    every dataset takes the delta route."""
    with monkeypatch.context() as m:
        if not fused:
            m.setattr(JsonLinesDiffWriter, "_write_ds_fast", lambda self, ds_path: False)
        return _run_port(["--device", "cpu", "-C", path, "diff", "-o", "json-lines",
                          "HEAD^...HEAD"])


def test_fused_rows_match_delta_route_mixed_edits(tmp_path, monkeypatch):
    """Inserts, updates and deletes with geometry, escapes, NaN/Infinity and
    NULLs: the fused row route writes the delta route's bytes (and both
    write kart_tpu's)."""
    from kart_tpu.geometry import Geometry

    repo, ds_path = make_imported_repo(tmp_path, n=30)
    ds = repo.datasets()[ds_path]
    edit_commit(
        repo, ds_path,
        inserts=[
            {"fid": 100, "geom": Geometry.from_wkb(bytes.fromhex(
                "0101000000000000000000f03f0000000000000040")),
             "name": 'quote " backslash \\ newline \n unicode ☃', "rating": 1.25},
            {"fid": 101, "geom": None, "name": None, "rating": None},
        ],
        updates=[
            {**ds.get_feature([3]), "rating": float("inf")},
            {**ds.get_feature([4]), "rating": float("nan")},
            {**ds.get_feature([5]), "name": "\x00\x1f control"},
        ],
        deletes=[7, 8],
        message="mixed edits",
    )
    path = _with_sidecars(str(repo.workdir))
    trepo = TRepo(path)
    rows = engine.get_feature_diff_rows(trepo.structure("HEAD^"), trepo.structure("HEAD"),
                                        ds_path, device="cpu")
    assert rows is not None and rows["count"] == 7  # the fused route is live
    fused, plain = _jsonl(path, monkeypatch, True), _jsonl(path, monkeypatch, False)
    assert fused == plain and fused[0] == 0
    ref = CliRunner().invoke(kart_cli, ["-C", path, "diff", "-o", "json-lines", "HEAD^...HEAD"])
    assert fused[1] == ref.stdout
    assert '"rating":Infinity' in fused[1] and '"rating":NaN' in fused[1]


def test_fused_rows_match_delta_route_synth(repos, monkeypatch):
    path = repos[("synth", "columnar")][0]
    fused, plain = _jsonl(path, monkeypatch, True), _jsonl(path, monkeypatch, False)
    assert fused == plain
    assert fused[1].count('"type":"feature"') == SYNTH_N // 100


@pytest.fixture(scope="module")
def projected_repo(tmp_path_factory):
    """A points dataset in NZTM (EPSG:2193), edited once."""
    from kart_tpu.importer import ImportSource
    from kart_tpu.importer.importer import import_sources

    from helpers import create_points_gpkg

    base = tmp_path_factory.mktemp("nztm")
    repo = JRepo.init_repository(base / "repo")
    repo.config.set_many({"user.name": "Tester", "user.email": "t@example.com"})
    import_sources(repo, ImportSource.open(
        create_points_gpkg(str(base / "nztm.gpkg"), n=6, srs_id=2193)))
    edit_commit(repo, "points", deletes=[2])
    return str(repo.workdir)


@pytest.mark.parametrize("opts", [
    ["diff", "-o", "json", "HEAD"],
    ["diff", "-o", "text", "--crs", "EPSG:2193", "HEAD^...HEAD"],
    ["diff", "-o", "json-lines", "--crs", "EPSG:2193", "HEAD^...HEAD"],
    ["show", "-o", "geojson", "--crs", "EPSG:2193"],
    ["nztm", "diff", "-o", "json", "--crs", "EPSG:4326", "HEAD^...HEAD"],
    ["nztm", "show", "--crs", "EPSG:4326"],
])
def test_not_ported_yet_is_a_named_error(repos, projected_repo, opts, capsys):
    """A working-copy diff of a repository without one, a projected
    ``--crs`` target and a dataset CRS: kart_tpu's bytes and exit code (the
    name is kept from when the port refused them)."""
    path = repos[("points", "columnar")][0]
    if opts[0] == "nztm":
        path, opts = projected_repo, opts[1:]
    rc = port_main(["--device", "cpu", "-C", path, *opts])
    got = capsys.readouterr()
    ref = CliRunner().invoke(kart_cli, ["-C", path, *opts])
    if opts == ["diff", "-o", "json", "HEAD"]:
        # no working copy: kart_tpu's entry point prints the NotFound, exit 40
        assert isinstance(ref.exception, JNotFound)
        assert (rc, got.out, got.err) == (40, ref.stdout, f"Error: {ref.exception}\n")
        return
    assert ref.exception is None or isinstance(ref.exception, SystemExit), ref.exception
    assert (rc, got.out) == (ref.exit_code, ref.stdout)
    assert rc == 0 and got.out.strip()


# --- hash-keyed datasets ------------------------------------------------------


def _col(i, name, data_type, pk=None, **extra):
    from kart_tpu.models.schema import ColumnSchema

    return ColumnSchema(id=f"c0000000-0000-4000-8000-{i:012d}", name=name, data_type=data_type,
                        pk_index=pk, extra_type_info=extra)


def _point(x, y):
    from kart_tpu.geometry import Geometry

    return Geometry.from_wkt(f"POINT ({x} {y})")


def _commit_dataset(repo, ds_path, schema, features, encoder, message, *, crs=None,
                    replace=False):
    """Commit ``ds_path`` written whole by kart_tpu's encoders (``replace``:
    over the dataset of HEAD); ``encoder`` may be the legacy one, which
    writes no path-structure.json. -> the commit oid."""
    from kart_tpu.core.tree_builder import TreeBuilder
    from kart_tpu.models.dataset import Dataset3

    odb = repo.odb
    parent = repo.head_commit_oid
    tb = TreeBuilder(odb, repo.head_tree_oid if parent else None)
    if replace:
        tb.remove_tree(f"{ds_path}/.table-dataset")
    for path, data in Dataset3.new_dataset_meta_blobs(ds_path, schema, title=f"{ds_path} layer",
                                                      crs_defs=crs, path_encoder=encoder):
        tb.insert(path, odb.write_blob(data))
    for f in features:
        pk_values, blob = schema.encode_feature_blob(f)
        tb.insert(f"{ds_path}/.table-dataset/feature/{encoder.encode_pks_to_path(pk_values)}",
                  odb.write_blob(blob))
    return repo.create_commit("HEAD", tb.flush(), message, [parent] if parent else [])


def _commit_edits(repo, ds_path, inserts=(), updates=(), deletes=()):
    """Commit feature edits keyed by the pk value, or the pk tuple of a
    composite pk, through kart_tpu's own diff application."""
    from kart_tpu.diff.structs import DatasetDiff, Delta, DeltaDiff, KeyValue, RepoDiff

    structure = repo.structure("HEAD")
    ds = structure.datasets[ds_path]
    names = [c.name for c in ds.schema.pk_columns]

    def key(f):
        return f[names[0]] if len(names) == 1 else tuple(f[n] for n in names)

    def old(k):
        return ds.get_feature(list(k) if isinstance(k, tuple) else [k])

    fd = DeltaDiff()
    for f in inserts:
        fd.add_delta(Delta.insert(KeyValue((key(f), f))))
    for f in updates:
        fd.add_delta(Delta.update(KeyValue((key(f), old(key(f)))), KeyValue((key(f), f))))
    for k in deletes:
        fd.add_delta(Delta.delete(KeyValue((k, old(k)))))
    ds_diff = DatasetDiff()
    ds_diff["feature"] = fd
    repo_diff = RepoDiff()
    repo_diff[ds_path] = ds_diff
    return structure.commit_diff(repo_diff, "edit features")


#: text pks, G-NAF-shaped (``GA`` + state + digits) and some odd ones
TEXT_PKS = [f"GANSW70410{i:04d}" for i in range(12)] + ["GAVIC420000001", "ünï☃", "", "12"]


def _hash_repo(path, kind):
    """A repository of one hash-keyed dataset, two commits built by
    kart_tpu: ``text`` (a text pk with a point geometry), ``legacy`` (the
    same with no path-structure.json: the legacy hashed layout),
    ``composite`` (an integer and a text pk column) and ``pk_change`` (an
    int-pk dataset whose second commit retypes its pk to text, edits and
    drops features). -> (path, dataset path, a changed pk as a filter
    argument)."""
    from kart_tpu.epsg import epsg_wkt
    from kart_tpu.models.paths import PathEncoder
    from kart_tpu.models.schema import Schema

    repo = JRepo.init_repository(path)
    repo.config.set_many({"user.name": "Tester", "user.email": "t@example.com"})
    crs = {"EPSG:4326": epsg_wkt(4326)}
    geom = _col(2, "geom", "geometry", geometryType="POINT", geometryCRS="EPSG:4326")
    if kind in ("text", "legacy"):
        schema = Schema([_col(1, "code", "text", 0), geom, _col(3, "amount", "integer", size=64)])
        feats = [{"code": c, "geom": _point(i * 1.5, -i), "amount": i}
                 for i, c in enumerate(TEXT_PKS)]
        enc = PathEncoder.GENERAL_ENCODER if kind == "text" else PathEncoder.LEGACY_ENCODER
        _commit_dataset(repo, "addr", schema, feats, enc, "import addresses", crs=crs)
        _commit_edits(repo, "addr",
                      inserts=[{"code": "GAQLD000000123", "geom": _point(5, 5), "amount": 99},
                               {"code": "GAWA_0000000009", "geom": None, "amount": None}],
                      updates=[{**feats[1], "amount": 1001}, {**feats[13], "geom": _point(3, 3)},
                               {**feats[5], "amount": None}],
                      deletes=[TEXT_PKS[3], ""])
        return str(repo.workdir), "addr", TEXT_PKS[1]
    if kind == "composite":
        schema = Schema([_col(1, "zone", "integer", 0, size=64), _col(2, "code", "text", 1),
                         _col(3, "value", "float", size=64)])
        feats = [{"zone": i % 3, "code": f"k{i}", "value": i / 4} for i in range(14)]
        _commit_dataset(repo, "parcels", schema, feats, PathEncoder.GENERAL_ENCODER, "import")
        _commit_edits(repo, "parcels", inserts=[{"zone": -7, "code": "new", "value": 1.5}],
                      updates=[{**feats[2], "value": -1.0}, {**feats[9], "value": 9.5}],
                      deletes=[(0, "k3")])
        # a composite key filters by the text of its tuple, as kart_tpu reads it
        return str(repo.workdir), "parcels", "(2, 'k2')"
    if kind == "pk_change":
        cols = [_col(1, "fid", "integer", 0, size=64), geom, _col(3, "name", "text")]
        feats = [{"fid": i, "geom": _point(i, i), "name": f"n{i}"} for i in range(1, 13)]
        _commit_dataset(repo, "things", Schema(cols), feats, PathEncoder.INT_PK_ENCODER,
                        "import", crs=crs)
        cols[0] = _col(1, "fid", "text", 0)
        retyped = [{**f, "fid": str(f["fid"])} for f in feats if f["fid"] != 4]
        retyped[0]["name"] = "renamed"
        _commit_dataset(repo, "things", Schema(cols), retyped, PathEncoder.GENERAL_ENCODER,
                        "fid becomes text", crs=crs, replace=True)
        return str(repo.workdir), "things", "1"
    raise ValueError(kind)


HASH_KINDS = ["text", "legacy", "composite", "pk_change"]


@pytest.fixture(scope="module")
def hash_repos(tmp_path_factory):
    """Each hash-keyed repository with both revisions' sidecars written by
    kart_tpu (the columnar route), and a copy without (the tree walk)."""
    base = tmp_path_factory.mktemp("hashdiff")
    out = {}
    for kind in HASH_KINDS:
        path, ds_path, pk = _hash_repo(str(base / kind), kind)
        out[(kind, "tree")] = (_without_sidecars(path, base / f"{kind}_tree"), ds_path, pk)
        out[(kind, "columnar")] = (_with_sidecars(path), ds_path, pk)
    for (kind, route), (path, ds_path, _pk) in out.items():
        trepo = TRepo(path)
        pair = [trepo.structure(rev).datasets[ds_path] for rev in ("HEAD^", "HEAD")]
        assert (engine._sidecar_blocks(*pair) is not None) == (route == "columnar"), (kind, route)
        assert pair[1].path_encoder.scheme == "msgpack/hash"
        assert (pair[1].get_meta_item("path-structure.json") is None) == (kind == "legacy")
    return out


HASH_COMMANDS = [
    ("diff", "HEAD^...HEAD"),
    ("diff", "-o", "json", "HEAD^...HEAD"),
    ("diff", "-o", "json", "--json-style", "compact", "HEAD^...HEAD"),
    ("diff", "-o", "json-lines", "HEAD^...HEAD"),
    ("diff", "-o", "geojson", "HEAD^...HEAD"),
    ("diff", "-o", "quiet", "HEAD^...HEAD"),
    ("diff", "-o", "feature-count", "HEAD^...HEAD"),
    ("diff", "-o", "text", "--exit-code", "HEAD^...HEAD"),
    ("diff", "-o", "json-lines", "HEAD^...HEAD", "{ds}:{pk}"),
    ("diff", "-o", "text", "HEAD^...HEAD", "{ds}:feature:{pk}"),
    ("diff", "-o", "feature-count", "HEAD^...HEAD", "{ds}"),
    # backwards: a retyped pk's hash-keyed version is then the base
    ("diff", "-o", "json", "HEAD...HEAD^"),
    ("diff", "-o", "feature-count", "HEAD...HEAD^"),
    ("show", "HEAD"),
    ("show", "-o", "json", "HEAD"),
    ("show", "-o", "json-lines", "HEAD^"),
    ("create-patch", "HEAD"),
    ("create-patch", "--patch-type", "minimal", "HEAD"),
] + [("diff", "--only-feature-count", acc, "HEAD^...HEAD")
     for acc in ("veryfast", "fast", "medium", "good", "exact")] + [
    ("diff", "--only-feature-count", "fast", "-o", "json", "HEAD^...HEAD"),
]


@pytest.mark.parametrize("route", ["columnar", "tree"])
@pytest.mark.parametrize("kind", HASH_KINDS)
@pytest.mark.parametrize("cmd", range(len(HASH_COMMANDS)),
                         ids=lambda c: "_".join(HASH_COMMANDS[c]).replace("HEAD^...HEAD", "")
                         .strip("_"))
def test_hash_keyed_diff_matches_kart_tpu(hash_repos, cmd, kind, route):
    """Every diff format, ``ds:pk`` filters, ``show``, ``create-patch`` and
    each ``--only-feature-count`` accuracy on hash-keyed datasets: kart_tpu's
    bytes and exit codes, on the columnar route (K1's plain version over
    the hash keys) and the tree walk."""
    path, ds_path, pk = hash_repos[(kind, route)]
    argv = [a.format(ds=ds_path, pk=pk) for a in HASH_COMMANDS[cmd]]
    if kind == "pk_change" and "{pk}" in " ".join(HASH_COMMANDS[cmd]):
        argv = argv[:-1] + [argv[-1].replace(f":{pk}", ":2")]  # an int pk of the old version
    out = _compare(path, argv)
    if "quiet" not in argv:
        assert out.strip()


@pytest.mark.parametrize("kind", ["text", "composite"])
def test_hash_keyed_html_matches_kart_tpu(hash_repos, tmp_path, kind):
    path = hash_repos[(kind, "columnar")][0]
    pages = []
    for who in ("ref", "port"):
        page = str(tmp_path / f"{who}.html")
        argv = ["diff", "-o", "html", "--output", page, "HEAD^...HEAD"]
        if who == "ref":
            r = CliRunner().invoke(kart_cli, ["-C", path, *argv])
            got = (r.exit_code, r.stdout)
        else:
            got = _run_port(["--device", "cpu", "-C", path, *argv])
        with open(page) as f:
            pages.append((got, f.read()))
    assert pages[0] == pages[1] and '"U+::' in pages[1][1]


def _patched_keys(monkeypatch, overrides):
    """Both packages' ``hash_keys_for_paths`` with the keys of the
    filenames in ``overrides`` ({filename: key}) replaced: in the blocks'
    tree reads and the sidecar builders. The fixture restores them."""
    from kart_tpu.diff import sidecar as jside
    from kart_tpu.ops import blocks as jblocks
    from kart_tpu_torch.ops import blocks as tblocks

    def patched(real):
        def keys(paths):
            out = real(paths)
            for i, p in enumerate(paths):
                name = p.rsplit("/", 1)[-1]
                if name in overrides:
                    out[i] = overrides[name]
            return out
        return keys

    for mod, real in ((jblocks, jblocks.hash_keys_for_paths), (jside, jside.hash_keys_for_paths),
                      (tblocks, tblocks.hash_keys_for_paths), (sidecar, sidecar.hash_keys_for_paths)):
        monkeypatch.setattr(mod, "hash_keys_for_paths", patched(real))


def _filename(*pk_values):
    from kart_tpu.models.paths import PathEncoder

    return PathEncoder.GENERAL_ENCODER.encode_filename(list(pk_values))


@pytest.fixture(scope="module")
def extreme_key_repo(tmp_path_factory):
    """The text repository with its sidecars written under keys 0 and
    2^63 - 1 (the pad key's value) for an updated, a deleted and an
    unchanged feature: real rows at both ends of the key range."""
    path, ds_path, _ = _hash_repo(str(tmp_path_factory.mktemp("extreme") / "r"), "text")
    with pytest.MonkeyPatch.context() as m:
        _patched_keys(m, {_filename(TEXT_PKS[1]): 0, _filename(TEXT_PKS[3]): 2**63 - 1,
                          _filename(TEXT_PKS[0]): 2**63 - 2})
        _with_sidecars(path)
    trepo = TRepo(path)
    keys = set()
    for rev in ("HEAD^", "HEAD"):
        block = sidecar.load_block(trepo, trepo.structure(rev).datasets[ds_path])
        keys.update(np.asarray(block.keys[: block.count]).tolist())
    assert {0, 2**63 - 1, 2**63 - 2} <= keys
    return path


@pytest.mark.parametrize("cmd", range(len(HASH_COMMANDS)),
                         ids=lambda c: "_".join(HASH_COMMANDS[c]).replace("HEAD^...HEAD", "")
                         .strip("_"))
def test_extreme_hash_keys_diff_matches_kart_tpu(extreme_key_repo, cmd):
    """Real rows whose keys are 0 and 2^63 - 1 (a key the pad value
    shares) are changed rows like any other."""
    argv = [a.format(ds="addr", pk=TEXT_PKS[1]) for a in HASH_COMMANDS[cmd]]
    assert _compare(extreme_key_repo, argv).strip() or "quiet" in argv


DIFF_OUTPUTS = [["diff", "-o", "json", "HEAD^...HEAD"], ["diff", "HEAD^...HEAD"],
                ["diff", "-o", "feature-count", "HEAD^...HEAD"], ["show", "-o", "json-lines"]]


@pytest.mark.parametrize("collision", ["within_block", "across_versions"])
def test_colliding_hash_keys_diff_by_the_tree_walk(tmp_path, monkeypatch, collision):
    """Sidecar keys that collide: two features of one version sharing a
    key, or a deleted and an inserted feature sharing one (which the join
    would read as an update). Both packages then diff by the tree walk:
    the same outputs, and the port counts the collision path."""
    from kart_tpu_torch import runtime

    path, ds_path, _ = _hash_repo(str(tmp_path / "r"), "text")
    deleted, inserted = _filename(TEXT_PKS[3]), _filename("GAQLD000000123")
    if collision == "within_block":
        overrides = {_filename(TEXT_PKS[0]): 42, _filename(TEXT_PKS[2]): 42}
    else:
        overrides = {deleted: 42, inserted: 42}
    _patched_keys(monkeypatch, overrides)
    _with_sidecars(path)
    trepo = TRepo(path)
    blocks = engine._sidecar_blocks(*(trepo.structure(r).datasets[ds_path]
                                      for r in ("HEAD^", "HEAD")))
    assert blocks is not None
    assert any(b.has_key_collisions() for b in blocks) == (collision == "within_block")
    for argv in DIFF_OUTPUTS:
        runtime.reset_stats()
        assert _compare(path, argv).strip()
        assert runtime.stats_snapshot()["hash_collision_fallbacks"] == 1, argv
