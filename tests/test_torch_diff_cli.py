"""``python -m kart_tpu_torch --device cpu -C <repo> diff ...`` against
kart_tpu's ``kart diff``: identical stdout and exit code for every
format, commit spec, filter and option case, on the columnar route
(sidecars present) and the tree route (sidecars removed), on an imported
GPKG points repo and a synthetic repo; and the port's fused json-lines
row route against its delta route."""

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


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_diff_matches_kart_tpu(repos, case):
    repo, route, v, spec, flt = case
    path, ds_path, pk = repos[(repo, route)]
    filters = {"none": [], "ds": [ds_path], "ds:pk": [f"{ds_path}:{pk}"]}[flt]
    opts = [*VARIANTS[v], spec, *filters]
    ref = CliRunner().invoke(kart_cli, ["-C", path, "diff", *opts])
    assert ref.exception is None or isinstance(ref.exception, SystemExit), ref.exception
    rc, out = _run_port(["--device", "cpu", "-C", path, "diff", *opts])
    assert rc == ref.exit_code
    assert out == ref.stdout
    if spec != "HEAD...HEAD" and "quiet" not in opts:
        assert out.strip()  # a non-trivial comparison


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


@pytest.mark.parametrize("opts", [["-o", "text", "HEAD^...HEAD"], ["-o", "geojson", "HEAD^...HEAD"],
                                  ["-o", "json", "HEAD"]])
def test_not_ported_yet_is_a_named_error(repos, opts, capsys):
    """Formats and diffs this port does not write yet exit 30 with a named
    error (kart_tpu's NOT_YET_IMPLEMENTED code), never a partial output."""
    path = repos[("points", "columnar")][0]
    rc = port_main(["--device", "cpu", "-C", path, "diff", *opts])
    got = capsys.readouterr()
    assert rc == 30 and got.out == "" and got.err.startswith("Error: ")
    assert "not ported" in got.err


def test_hash_keyed_paths_not_ported_yet():
    from kart_tpu_torch.core.repo import NotYetImplemented
    from kart_tpu_torch.models.paths import PathEncoder

    with pytest.raises(NotYetImplemented):
        PathEncoder.get(scheme="msgpack/hash", branches=64, levels=4, encoding="base64")
