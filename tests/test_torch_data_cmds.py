"""``kart data ls|version``, ``kart meta get|set`` and ``kart
commit-files`` in the port against kart_tpu's, each package on its own
copy of a repository with the dates pinned: the same stdout, stderr and
exit code byte for byte (kart_tpu's CLI entry point turns an
``InvalidOperation`` into exit 20 and a ``NotFound`` into 40), and the
same files in the gitdir afterwards (refs, objects, sidecars; not the
reflogs, which hold the wall clock); the ``data`` and ``meta`` groups'
help and usage errors, word for word click's; ``meta get``'s bold item
names on a terminal only; ``commit-files``' path checks, ``@file`` values,
``--remove-empty-files``, ``--allow-empty``, branches and tags, and its
refusal in a merge; and the refusal (exit 30, nothing written) where
kart_tpu would update a working copy."""

import contextlib
import io
import os
import shutil

import pytest
from click.testing import CliRunner

from helpers import create_points_gpkg, make_repo_with_edits
from kart_tpu.cli import cli as kart_cli
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.core.repo import NotFound as JNotFound
from kart_tpu.core.repo import RepoError as JRepoError
from kart_tpu_torch.cli import main as port_main
from kart_tpu_torch.synth import v2_repo

DATE = "1700000000 +0000"


@pytest.fixture(autouse=True)
def _pinned_dates(monkeypatch):
    monkeypatch.setenv("GIT_AUTHOR_DATE", DATE)
    monkeypatch.setenv("GIT_COMMITTER_DATE", DATE)


def _kart(argv, **kw):
    r = CliRunner().invoke(kart_cli, argv, prog_name="kart", **kw)
    exc = r.exception
    if exc is None or isinstance(exc, SystemExit):
        return r.exit_code, r.stdout, r.stderr
    if isinstance(exc, JRepoError):
        return (40 if isinstance(exc, JNotFound) else 20), r.stdout, r.stderr + f"Error: {exc}\n"
    raise exc


class _Tty(io.StringIO):
    def isatty(self):
        return True


def _port(argv, tty=False):
    out, err = (_Tty() if tty else io.StringIO()), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_main(argv)
    return rc, out.getvalue(), err.getvalue()


def _snapshot(path):
    """Every file under the gitdir but the reflogs, with its bytes."""
    gitdir = os.path.join(path, ".kart")
    out = {}
    for d, dirs, names in os.walk(gitdir):
        dirs[:] = [x for x in dirs if not (d == gitdir and x == "logs")]
        for n in names:
            full = os.path.join(d, n)
            with open(full, "rb") as f:
                out[os.path.relpath(full, gitdir)] = f.read()
    return out


@pytest.fixture(scope="module")
def bases(tmp_path_factory):
    """{name: path}: two imported layers with an edit commit, a V2 table,
    and an empty repository."""
    from kart_tpu.importer import ImportSource
    from kart_tpu.importer.importer import import_sources

    base = tmp_path_factory.mktemp("datacmds")
    old = {k: os.environ.get(k) for k in ("GIT_AUTHOR_DATE", "GIT_COMMITTER_DATE")}
    os.environ.update(GIT_AUTHOR_DATE=DATE, GIT_COMMITTER_DATE=DATE)
    try:
        (base / "two").mkdir()
        two, _ = make_repo_with_edits(base / "two", n=20)
        import_sources(JRepo(two), ImportSource.open(
            create_points_gpkg(str(base / "two" / "second.gpkg"), n=3, table="second")))
        v2 = v2_repo(str(base / "v2"), n=4, spatial=True)[0].workdir
        empty = str(base / "empty")
        JRepo.init_repository(empty)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    with open(base / "value.txt", "w") as f:
        f.write("A title\nfrom a file\n")
    with open(base / "blob.bin", "wb") as f:
        f.write(bytes(range(256)))
    return {"two": two, "v2": str(v2), "empty": empty, "dir": str(base)}


def _run_both(src, tmp_path, steps):
    """Each argv of ``steps`` in both packages, on their own copies of
    ``src``: equal outputs and codes, and equal gitdir files after each.
    -> the (code, stdout, stderr) of every step."""
    kpath = shutil.copytree(src, str(tmp_path / "k"))
    ppath = shutil.copytree(src, str(tmp_path / "p"))
    outs = []
    for argv in steps:
        ref = _kart(["-C", kpath, *argv])
        got = _port(["--device", "cpu", "-C", ppath, *argv])
        assert got == ref, (argv, ref, got)
        assert _snapshot(ppath) == _snapshot(kpath), argv
        outs.append(got)
    return outs


READS = [
    ["data", "ls"], ["data", "ls", "-o", "json"], ["data", "ls", "-o", "json",
                                                   "--with-dataset-types"],
    ["data", "ls", "HEAD^"], ["data", "ls", "nosuchref"], ["data", "ls", "-ojson", "HEAD~1"],
    ["data", "version"], ["data", "version", "-o", "json"],
    ["meta", "get", "points"], ["meta", "get", "-o", "json", "points"],
    ["meta", "get", "points", "title", "schema.json"], ["meta", "get", "points", "nope", "x"],
    ["meta", "get", "nosuch"], ["meta", "get", "--ref", "HEAD^", "second"],
    ["meta", "get", "--ref", "nosuchref", "points"], ["meta", "get", "-o", "json", "second",
                                                      "crs/EPSG:4326.wkt"],
]


@pytest.mark.parametrize("repo", ["two", "v2", "empty"])
@pytest.mark.parametrize("argv", READS, ids=lambda a: " ".join(a))
def test_read_commands(bases, tmp_path, repo, argv):
    argv = [a.replace("points", "mytable") if repo == "v2" else a for a in argv]
    _run_both(bases[repo], tmp_path, [argv])


def test_meta_get_is_bold_on_a_terminal_only(bases):
    path = bases["two"]
    ref = CliRunner().invoke(kart_cli, ["-C", path, "meta", "get", "points", "title"],
                             prog_name="kart", color=True)
    rc, out, _ = _port(["--device", "cpu", "-C", path, "meta", "get", "points", "title"],
                       tty=True)
    assert (rc, out) == (ref.exit_code, ref.stdout) and "\x1b[1m" in out
    assert "\x1b[" not in _port(["--device", "cpu", "-C", path, "meta", "get", "points"])[1]


def _meta_sets(d):
    return [
        ["meta", "set", "points", "title=New title"],
        ["meta", "set", "-m", "two items", "points", "title=Again", "description=Said"],
        ["meta", "set", "points", f"description=@{d}/value.txt"],
        ["meta", "set", "points", "metadata.xml=<xml/>"],
        ["meta", "set", "points", "title=Again"],
        ["meta", "set", "points", "no-equals"],
        ["meta", "set", "nosuch", "title=x"],
        ["meta", "set", "--message=m", "second", "title=Nested"],
        ["data", "ls"],
        ["meta", "get", "points"],
    ]


def test_meta_set(bases, tmp_path):
    """Titles, descriptions, an attachment, a value from a file, a change
    to nothing, bad assignments and datasets: each the same commit or
    refusal."""
    outs = _run_both(bases["two"], tmp_path, _meta_sets(bases["dir"]))
    assert [o[0] for o in outs] == [0, 0, 0, 0, 20, 2, 2, 0, 0, 0]


def test_meta_set_schema(bases, tmp_path):
    """A column renamed through ``schema.json``: kart_tpu's commit."""
    from kart_tpu.core.repo import KartRepo

    cols = KartRepo(bases["two"]).structure("HEAD").datasets["points"].get_meta_item("schema.json")
    import json

    renamed = json.dumps([{**c, "name": "label"} if c["name"] == "name" else c for c in cols])
    outs = _run_both(bases["two"], tmp_path, [["meta", "set", "points", f"schema.json={renamed}"],
                                              ["meta", "get", "-o", "json", "points"]])
    assert outs[0][0] == 0 and '"label"' in outs[1][1]


def _commit_files(d):
    return [
        ["commit-files", "-m", "readme", "README.md=hello"],
        ["commit-files", "-m", "nested", "docs/a/b.txt=deep", "docs/c.txt=x"],
        ["commit-files", "-m", "binary", f"docs/blob.bin=@{d}/blob.bin"],
        ["commit-files", "-m", "missing", f"x=@{d}/nosuch"],
        ["commit-files", "-m", "same", "README.md=hello"],
        ["commit-files", "-m", "same", "--allow-empty", "README.md=hello"],
        ["commit-files", "-m", "empty", "empty.txt="],
        ["commit-files", "-m", "rm", "--remove-empty-files", "empty.txt=", "docs/c.txt="],
        ["commit-files", "-m", "rm none", "--remove-empty-files", "never.txt="],
        ["commit-files", "-m", "bad", "no-equals"],
        ["commit-files", "-m", "bad", "=x"],
        ["commit-files", "-m", "bad", "a//b=x"],
        ["commit-files", "-m", "bad", "../up=x"],
        ["commit-files", "-m", "bad", "a/./b=x"],
        ["commit-files", "-m", "bad", "ok=1", "a/=x"],
        ["commit-files", "-m", "side", "--ref", "side", "side.txt=1"],
        ["commit-files", "-m", "side", "--ref", "refs/heads/side", "side.txt=2"],
        ["commit-files", "-m", "tag", "--ref", "v1", "t.txt=1"],
        ["commit-files", "-m", "tag", "--ref", "refs/tags/v1", "t.txt=1"],
        ["commit-files", "-m", "nosuch", "--ref", "nosuch", "t.txt=1"],
        ["commit-files", "-m", "oid", "--ref", "HEAD^", "t.txt=1"],
        ["commit-files", "--message", "main", "--ref", "main", "m.txt=1"],
        ["data", "ls"],
    ]


def test_commit_files(bases, tmp_path):
    """Files written, replaced and removed, from values and files, on HEAD,
    a branch by name and by ref; tags, oids and missing refs refused; bad
    paths refused."""
    src = shutil.copytree(bases["two"], str(tmp_path / "src"))
    repo = JRepo(src)
    repo.refs.set("refs/heads/side", repo.resolve_refish("HEAD^")[0])
    repo.refs.set("refs/tags/v1", repo.resolve_refish("HEAD^")[0])
    outs = _run_both(src, tmp_path, _commit_files(bases["dir"]))
    assert {o[0] for o in outs} == {0, 2, 40}


def test_commit_files_refusals_on_other_repos(bases, tmp_path):
    """An empty repository (no initial commit by commit-files) and one in a
    merge (kart_tpu's state message)."""
    _run_both(bases["empty"], tmp_path / "e", [["commit-files", "-m", "x", "a=1"]])
    src = shutil.copytree(bases["two"], str(tmp_path / "src"))
    with open(os.path.join(src, ".kart", "MERGE_HEAD"), "w") as f:
        f.write(JRepo(src).resolve_refish("HEAD^")[0] + "\n")
    outs = _run_both(src, tmp_path / "m", [["commit-files", "-m", "x", "a=1"],
                                           ["meta", "set", "points", "title=x"]])
    assert outs[0][0] == 2 and "A merge is ongoing" in outs[0][2]


USAGE = [
    ["data"], ["meta"], ["data", "nope"], ["meta", "nope"], ["data", "--help"],
    ["meta", "--help"], ["data", "--bad"], ["data", "ls", "-o", "x"], ["data", "ls", "a", "b"],
    ["data", "ls", "--with-dataset-types=1"], ["data", "version", "x"],
    ["data", "version", "-o"], ["meta", "get"], ["meta", "get", "--ref"],
    ["meta", "get", "-o", "yaml", "points"], ["meta", "set"], ["meta", "set", "points"],
    ["meta", "set", "-m"], ["commit-files"], ["commit-files", "a=1"], ["commit-files", "-m"],
    ["commit-files", "-m", "x"], ["commit-files", "--nope", "a=1"],
    ["commit-files", "--allow-empty=yes", "-m", "x", "a=1"],
]


@pytest.mark.parametrize("argv", USAGE, ids=lambda a: " ".join(a))
def test_usage_and_group_help(bases, argv):
    """Usage errors and the groups' help: click's words, code and stream."""
    path = bases["two"]
    ref = _kart(["-C", path, *argv])
    got = _port(["--device", "cpu", "-C", path, *argv])
    assert got == ref and got[0] in (0, 2)


@pytest.mark.parametrize("argv,code", [
    (["meta", "set", "points", "title=WC"], 0),
    (["commit-files", "-m", "x", "a.txt=1"], 0),
    (["commit-files", "-m", "x", "--ref", "main", "a.txt=1"], 0),
    (["commit-files", "-m", "x", "--ref", "side", "a.txt=1"], 0),
    (["meta", "set", "nosuch", "title=x"], 2),
])
def test_working_copy(bases, tmp_path, argv, code):
    """With a GPKG working copy holding an edit: where the commit moves
    HEAD the working copy moves to it without ``--force``; ``commit-files``
    keeps the edit (kart_tpu's
    ``test_commit_files_preserves_wc_edits_and_validates``), ``meta set``
    writes its dataset again, as kart_tpu does; kart_tpu's outputs, exit
    code and gitdir files, and the same rows in every table of the copy."""
    from test_torch_workingcopy import edit, wc_tables

    src = shutil.copytree(bases["two"], str(tmp_path / "src"))
    repo = JRepo(src)
    repo.refs.set("refs/heads/side", repo.resolve_refish("HEAD^")[0])
    kpath = shutil.copytree(src, str(tmp_path / "k"))
    ppath = shutil.copytree(src, str(tmp_path / "p"))
    for path in (kpath, ppath):  # the working copy is found by the workdir's name
        r = CliRunner().invoke(kart_cli, ["-C", path, "create-workingcopy"])
        assert r.exit_code == 0, r.output
    edit(os.path.join(kpath, "k.gpkg"), "UPDATE points SET name = 'keepme' WHERE fid = 6;",
         port_side=False)
    edit(os.path.join(ppath, "p.gpkg"), "UPDATE points SET name = 'keepme' WHERE fid = 6;",
         port_side=True)
    ref = _kart(["-C", kpath, *argv])
    got = _port(["--device", "cpu", "-C", ppath, *argv])
    assert got == ref and got[0] == code, (ref, got)
    assert _snapshot(ppath) == _snapshot(kpath)
    assert wc_tables(os.path.join(ppath, "p.gpkg")) == wc_tables(os.path.join(kpath, "k.gpkg"))
    ref = _kart(["-C", kpath, "diff"])
    assert _port(["--device", "cpu", "-C", ppath, "diff"]) == ref
    assert ("keepme" in ref[1]) == (argv[:2] != ["meta", "set"] or code != 0)
