"""``python -m kart_tpu_torch --device cpu -C <repo> diff|show|create-patch
...`` against kart_tpu's CLI: identical stdout, files and exit code for
every format (text, json, json-lines, geojson, html, quiet,
feature-count), ``--crs``, commit spec, filter and option case, on the
columnar route (sidecars present) and the tree route (sidecars removed),
on an imported GPKG points repo and a synthetic repo; ``show`` and
``create-patch`` at the root commit and later ones; a two-dataset GeoJSON
``--output DIR``; and the port's fused json-lines row route against its
delta route. What the port still refuses (a working-copy diff, a projected
``--crs`` target or dataset CRS) exits 30 with no output."""

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
    """What the port does not run yet (a working-copy diff, a projected
    ``--crs`` target or dataset CRS) exits 30 with a named error (kart_tpu's
    NOT_YET_IMPLEMENTED code), never a partial output."""
    path = repos[("points", "columnar")][0]
    if opts[0] == "nztm":
        path, opts = projected_repo, opts[1:]
    rc = port_main(["--device", "cpu", "-C", path, *opts])
    got = capsys.readouterr()
    assert rc == 30 and got.out == "" and got.err.startswith("Error: ")
    assert "not ported" in got.err


def test_hash_keyed_paths_not_ported_yet():
    from kart_tpu_torch.core.repo import NotYetImplemented
    from kart_tpu_torch.models.paths import PathEncoder

    with pytest.raises(NotYetImplemented):
        PathEncoder.get(scheme="msgpack/hash", branches=64, levels=4, encoding="base64")
