"""V2 repositories (``.sno-dataset`` datasets, the legacy hashed layout):
every command the port runs, on ``tests/test_upgrade.py``'s
``make_v2_repo`` and on the port's own ``synth.v2_repo`` (with and
without a point column), through both packages, each on its own copy of
the repository: stdout, the last stderr line and the exit code are
kart_tpu's. A repository structure version that kart_tpu refuses the
port refuses with the same exit code and message."""

import contextlib
import io
import os
import shutil
import sys

import pytest
from click.testing import CliRunner

from kart_tpu.cli import cli as kart_cli
from kart_tpu.cli import entrypoint as kart_entrypoint
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.tiles import source as jsource
from kart_tpu_torch import synth
from kart_tpu_torch.cli import main as port_main
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.core.repo import RepoError as TRepoError
from kart_tpu_torch.models import dataset as tdataset
from kart_tpu_torch.tiles import source as tsource
from test_upgrade import make_v2_repo

COMMANDS = {
    "diff-json": ["diff", "-o", "json", "HEAD^...HEAD"],
    "diff-json-lines": ["diff", "-o", "json-lines", "HEAD^...HEAD"],
    "diff-text": ["diff", "HEAD^...HEAD"],
    "diff-geojson": ["diff", "-o", "geojson", "HEAD^...HEAD"],
    "diff-html": ["diff", "-o", "html", "--output", "{out}.html", "HEAD^...HEAD"],
    "diff-quiet": ["diff", "-o", "quiet", "HEAD^...HEAD"],
    "diff-feature-count": ["diff", "-o", "feature-count", "HEAD^...HEAD"],
    "diff-count-exact": ["diff", "--only-feature-count", "exact", "HEAD^...HEAD"],
    "diff-count-veryfast": ["diff", "--only-feature-count", "veryfast", "HEAD^...HEAD"],
    "diff-crs": ["diff", "-o", "json-lines", "--crs", "EPSG:4277", "HEAD^...HEAD"],
    "diff-pk-filter": ["diff", "-o", "json", "HEAD~1...HEAD", "mytable:7"],
    "show": ["show"],
    "show-json": ["show", "-o", "json", "HEAD^"],
    "create-patch": ["create-patch", "HEAD"],
    "log-dataset-changes": ["log", "-o", "json", "--with-dataset-changes"],
    "log-feature-count": ["log", "-o", "json", "--with-feature-count", "veryfast"],
    "log-feature-count-exact": ["log", "-o", "json", "--with-feature-count", "exact"],
    "log-path-filter": ["log", "-o", "json", "mytable:feature:7"],
    "query-count": ["query", "HEAD", "mytable"],
    "query-where": ["query", "HEAD", "mytable", "--where", "fid < 4", "-o", "json"],
    "query-bbox": ["query", "HEAD", "mytable", "--bbox", "0,0,3.5,3", "-o", "json"],
    "export-tiles": ["export", "tiles", "--zoom", "0-2", "--layers", "geojson,bin", "-o",
                     "{out}"],
}
#: commands that need a geometry column: on a table without one both refuse
SPATIAL = {"diff-geojson", "query-bbox", "export-tiles"}


@pytest.fixture(scope="module")
def v2_repos(tmp_path_factory):
    base = tmp_path_factory.mktemp("v2")
    repo, _, _ = make_v2_repo(base / "ref")
    port_plain, _, _ = synth.v2_repo(str(base / "port"), n=9)
    port_spatial, _, _ = synth.v2_repo(str(base / "spatial"), n=9, spatial=True)
    return {"make_v2_repo": str(repo.workdir), "v2_repo": str(port_plain.workdir),
            "v2_repo_spatial": str(port_spatial.workdir)}


def _both(src, tmp_path, argv):
    """Run ``argv`` through kart_tpu and the port (``--device cpu``), each
    on its own copy of ``src``. -> ((rc, stdout, stderr), ...) for each."""
    runs = []
    for name in ("ref", "port"):
        path = str(tmp_path / name)
        shutil.copytree(src, path)
        args = [a.replace("{out}", str(tmp_path / f"{name}-tiles")) for a in argv]
        if name == "ref":
            jsource.drop_sources()
            r = CliRunner().invoke(kart_cli, ["-C", path, *args], prog_name="kart")
            assert r.exception is None or isinstance(r.exception, SystemExit), r.exception
            runs.append((r.exit_code, r.stdout, r.stderr))
            continue
        tsource.drop_sources()
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = port_main(["--device", "cpu", "-C", path, *args])
        runs.append((rc, out.getvalue(), err.getvalue()))
    # the two runs write to their own paths: name them alike
    return [(rc, *(t.replace(str(tmp_path / f"{name}-tiles"), "{out}") for t in (out, err)))
            for name, (rc, out, err) in zip(("ref", "port"), runs)]


def _tree_digest(root):
    files = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as fh:
                files[os.path.relpath(os.path.join(d, n), root)] = fh.read()
    return files


@pytest.mark.parametrize("cmd", sorted(COMMANDS))
@pytest.mark.parametrize("kind", ["make_v2_repo", "v2_repo", "v2_repo_spatial"])
def test_v2_command_matches_kart_tpu(v2_repos, tmp_path, kind, cmd):
    ref, port = _both(v2_repos[kind], tmp_path, COMMANDS[cmd])
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2].splitlines()[-1:] == ref[2].splitlines()[-1:]
    if cmd == "export-tiles" and ref[0] == 0:
        assert _tree_digest(tmp_path / "port-tiles") == _tree_digest(tmp_path / "ref-tiles")
    if cmd == "diff-html":
        with open(tmp_path / "ref-tiles.html") as a, open(tmp_path / "port-tiles.html") as b:
            page = a.read()
            assert "mytable" in page and page == b.read()
        return
    spatial_cmd_on_table = cmd in SPATIAL and kind != "v2_repo_spatial"
    if not spatial_cmd_on_table and cmd != "diff-quiet":
        assert ref[0] == 0 and ref[1].strip(), ref  # a real comparison, not two refusals


def test_v2_repo_builds_make_v2_repo_s_trees(v2_repos):
    """``synth.v2_repo`` writes ``make_v2_repo``'s trees byte for byte (the
    commits differ only by their dates)."""
    ref, port = JRepo(v2_repos["make_v2_repo"]), TRepo(v2_repos["v2_repo"])
    ref_trees = [ref.odb.read_commit(c).tree for c in (ref.head_commit_oid,)]
    small, _, _ = synth.v2_repo(os.path.join(os.path.dirname(v2_repos["v2_repo"]), "six"))
    assert [small.odb.read_commit(small.head_commit_oid).tree] == ref_trees
    assert port.version == ref.version == 2
    ds = port.structure("HEAD").datasets["mytable"]
    assert type(ds).__name__ == "Dataset2" and ds.inner_path == "mytable/.sno-dataset"


def _outcome(run):
    """-> ("exit", code) or (exception class name, message) of ``run()``."""
    try:
        rc = run()
    except SystemExit as e:
        return "exit", e.code
    except Exception as e:  # noqa: BLE001 -- the refusal under test
        return type(e).__name__, str(e)
    return "exit", rc


@pytest.mark.parametrize("version", ["1", "4"])
@pytest.mark.parametrize("cmd", ["diff-json", "log-dataset-changes", "query-count", "show"])
def test_unsupported_version_refused_as_kart_tpu_refuses(v2_repos, tmp_path, monkeypatch,
                                                          capsys, version, cmd):
    """kart_tpu's dataset module raises its NotYetImplemented (not a
    RepoError: where no command catches it, the interpreter exits 1 with
    its traceback; ``query`` turns it into exit 2); the port raises its
    own, with the same message, after the same output."""
    src = str(tmp_path / "src")
    shutil.copytree(v2_repos["make_v2_repo"], src)
    JRepo(src).config.set_many({"kart.repostructure.version": version})
    monkeypatch.setattr(sys, "argv", ["kart", "-C", src, *COMMANDS[cmd]])
    ref = _outcome(kart_entrypoint)
    ref_io = capsys.readouterr()
    got = _outcome(lambda: port_main(["--device", "cpu", "-C", src, *COMMANDS[cmd]]))
    got_io = capsys.readouterr()
    assert got == ref
    assert (got_io.out, got_io.err) == (ref_io.out, ref_io.err)
    assert f"Repo structure version {version} is not supported (supported: 2, 3)" in (
        got[1] if got[0] != "exit" else got_io.err)
    assert not issubclass(tdataset.NotYetImplemented, TRepoError)
