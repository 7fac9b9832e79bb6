"""The port's edit loop against kart_tpu's, on the CPU: ``init --import``,
the GeoPackage working copy (``status``, ``diff``, ``commit``,
``checkout``, ``switch``, ``restore``, ``reset``, ``create-workingcopy``,
``branch``) and the commands that update it (``merge``, ``apply``, ``meta
set``, ``commit-files``).

Each package works on its own repository with the dates pinned; the same
SQL edits go into each working copy (through a connection with the GPKG
envelope functions registered, as an editing client's would be). Every
command must give kart_tpu's stdout, stderr and exit code, and every table
of the two working copies must hold the same rows (``last_change``, which
defaults to the time of writing, masked)."""

import contextlib
import io
import json
import os
import re
import shutil
import sqlite3

import pytest
from click.testing import CliRunner

from helpers import create_attributes_gpkg, create_points_gpkg, wc_connect
from kart_tpu.cli import cli as kart_cli
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.core.repo import NotFound as JNotFound
from kart_tpu.core.repo import RepoError as JRepoError
from kart_tpu.importer import ImportSourceError as JImportSourceError
from kart_tpu_torch.cli import main as port_main
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.workingcopy import find_renames
from kart_tpu_torch.workingcopy.gpkg import _register_gpkg_functions

DATE = "1700000000 +0000"
USER = {"user.name": "Tester", "user.email": "t@example.com"}


@pytest.fixture(autouse=True)
def _pinned_dates(monkeypatch):
    monkeypatch.setenv("GIT_AUTHOR_DATE", DATE)
    monkeypatch.setenv("GIT_COMMITTER_DATE", DATE)


def kart(argv):
    """kart_tpu's CLI as its entry point runs it: -> (code, stdout, stderr)."""
    r = CliRunner().invoke(kart_cli, argv, prog_name="kart")
    exc = r.exception
    if exc is None or isinstance(exc, SystemExit):
        return r.exit_code, r.stdout, r.stderr
    if isinstance(exc, JImportSourceError):
        return 48, r.stdout, r.stderr + f"Error: {exc}\n"
    if isinstance(exc, JRepoError):
        return (40 if isinstance(exc, JNotFound) else 20), r.stdout, r.stderr + f"Error: {exc}\n"
    raise exc


def port(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_main(["--device", "cpu", *argv])
    return rc, out.getvalue(), err.getvalue()


def masked(result, *paths):
    """The import's rate line and the given paths masked."""
    rc, out, err = result
    lines = [("Imported <n> features" if line.startswith("Imported ") else line)
             for line in err.split("\n")]
    err = "\n".join(lines)
    for i, p in enumerate(paths):
        out, err = out.replace(p, f"<path{i}>"), err.replace(p, f"<path{i}>")
    return rc, out, err


def wc_tables(path):
    """{table: sorted rows} of every table of a GPKG, and its schema
    objects; ``gpkg_contents.last_change`` masked."""
    con = sqlite3.connect(path)
    try:
        out = {"sqlite_master": sorted(con.execute(
            "SELECT type, name, tbl_name, sql FROM sqlite_master").fetchall(), key=repr)}
        for (name,) in con.execute("SELECT name FROM sqlite_master WHERE type = 'table'"
                                   ).fetchall():
            cur = con.execute(f'SELECT * FROM "{name}"')
            cols = [d[0] for d in cur.description]
            rows = [tuple("<now>" if c == "last_change" else v for c, v in zip(cols, row))
                    for row in cur.fetchall()]
            out[name] = (cols, sorted(rows, key=repr))
        return out
    finally:
        con.close()


def edit(path, sql, *, port_side):
    """Run ``sql`` on a working copy as an editing client would."""
    if port_side:
        con = sqlite3.connect(path)
        _register_gpkg_functions(con)
    else:
        con = wc_connect(path)
    try:
        con.executescript(sql)
        con.commit()
    finally:
        con.close()


class Pair:
    """The same repository made by each package: ``k`` kart_tpu's, ``p``
    the port's (each ``<dir>/repo`` with the working copy ``wc.gpkg``)."""

    def __init__(self, tmp_path, sources, import_args=()):
        self.k = str(tmp_path / "k" / "repo")
        self.p = str(tmp_path / "p" / "repo")
        for path, runner in ((self.k, kart), (self.p, port)):
            assert runner(["init", path, "--workingcopy-location", "wc.gpkg"])[0] == 0
            (JRepo if runner is kart else TRepo)(path).config.set_many(USER)
        if sources:
            self.run(["import", *sources, *import_args])

    def run(self, argv, code=None):
        """``argv`` in both repositories: equal results and working copies.
        -> the port's (code, stdout, stderr)."""
        ref = masked(kart(["-C", self.k, *argv]), self.k)
        got = masked(port(["-C", self.p, *argv]), self.p)
        assert got == ref, (argv, ref, got)
        if code is not None:
            assert got[0] == code, (argv, got)
        self.same_wc()
        return got

    def wc(self, side):
        return os.path.join(self.k if side == "k" else self.p, "wc.gpkg")

    def same_wc(self):
        if os.path.exists(self.wc("k")) or os.path.exists(self.wc("p")):
            assert wc_tables(self.wc("p")) == wc_tables(self.wc("k"))

    def edit(self, sql):
        edit(self.wc("k"), sql, port_side=False)
        edit(self.wc("p"), sql, port_side=True)

    def heads(self):
        return JRepo(self.k).head_commit_oid, TRepo(self.p).head_commit_oid


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("wcsrc")
    return {"points": create_points_gpkg(str(d / "points.gpkg"), n=30),
            "records": create_attributes_gpkg(str(d / "records.gpkg"), n=12),
            "dir": str(d)}


EDITS = """
UPDATE points SET name = 'moved-3', geom = (SELECT geom FROM points WHERE fid = 9)
    WHERE fid = 3;
UPDATE points SET rating = 99.5 WHERE fid = 4;
DELETE FROM points WHERE fid IN (5, 6);
INSERT INTO points (fid, geom, name, rating) VALUES (31, NULL, 'new-31', 1.25);
INSERT INTO points (fid, geom, name, rating)
    SELECT 32, geom, 'new-32', NULL FROM points WHERE fid = 2;
"""

READS = [
    ["status"], ["status", "-o", "json"], ["diff"], ["diff", "-o", "json"],
    ["diff", "-o", "json-lines"], ["diff", "-o", "geojson"], ["diff", "-o", "feature-count"],
    ["diff", "-o", "quiet"], ["diff", "--exit-code"], ["diff", "HEAD"],
    ["diff", "HEAD", "points:feature:4"], ["diff", "--only-feature-count", "exact"],
    ["show", "-o", "json"],
]


@pytest.mark.parametrize("argv", READS, ids=lambda a: " ".join(a))
def test_reads_after_edits(sources, tmp_path, argv):
    """status and the working-copy diff in every format after the same SQL
    edits (tracked rows only, no kernel)."""
    pair = Pair(tmp_path, [sources["points"]])
    pair.run(argv)  # clean
    pair.edit(EDITS)
    pair.run(argv)


@pytest.mark.parametrize("args", [["-m", "edits"], ["-m", "edits", "-o", "json"],
                                  ["-m", "one", "points:feature:4"],
                                  ["-m", "a", "-m", "b", "-o", "json"]],
                         ids=lambda a: " ".join(a))
def test_commit(sources, tmp_path, args):
    pair = Pair(tmp_path, [sources["points"]])
    pair.edit(EDITS)
    pair.run(["commit", *args], code=0)
    k, p = pair.heads()
    assert k == p
    for argv in (["status", "-o", "json"], ["diff"], ["diff", "HEAD^...HEAD", "-o", "json"],
                 ["log", "-o", "json"]):
        pair.run(argv)


def test_commit_refusals(sources, tmp_path):
    pair = Pair(tmp_path, [sources["points"]])
    pair.run(["commit", "-m", "nothing"], code=2)
    pair.run(["commit", "-m", "empty", "--allow-empty", "-o", "json"], code=0)
    pair.edit("UPDATE points SET name = 'x' WHERE fid = 1;")
    pair.run(["commit", "-m", "filtered away", "points:feature:2"], code=2)


def test_meta_edit(sources, tmp_path):
    """The title changed in the working copy: a meta diff, and its commit."""
    pair = Pair(tmp_path, [sources["points"]])
    pair.edit("UPDATE gpkg_contents SET identifier = 'Retitled' WHERE table_name = 'points';")
    pair.run(["diff"])
    pair.run(["diff", "-o", "json"])
    pair.run(["status", "-o", "json"])
    pair.run(["commit", "-m", "title"], code=0)
    assert pair.heads()[0] == pair.heads()[1]


def _fresh_ids(text, known):
    """Column ids the working copy made up (random uuids) masked."""
    return re.sub(r'"id": "([0-9a-f-]{36})"',
                  lambda m: m.group(0) if m.group(1) in known else '"id": "<new>"', text)


def test_schema_edit(sources, tmp_path):
    """A column added in the working copy: the schema diff (the new
    column's random id masked), its commit, and the copy after it."""
    pair = Pair(tmp_path, [sources["points"]])
    known = {c.id for c in TRepo(pair.p).structure().datasets["points"].schema.columns}
    pair.edit("ALTER TABLE points ADD COLUMN extra TEXT; UPDATE points SET extra = 'x' "
              "WHERE fid = 2;")
    for argv in (["diff"], ["diff", "-o", "json"], ["status", "-o", "json"],
                 ["commit", "-m", "schema", "-o", "json"],
                 ["diff", "HEAD^...HEAD", "-o", "json"], ["status"]):
        ref = kart(["-C", pair.k, *argv])
        got = port(["-C", pair.p, *argv])
        if argv[0] == "commit":
            ref = (ref[0], re.sub(r'[0-9a-f]{40}|[0-9a-f]{7}', "<oid>", ref[1]), ref[2])
            got = (got[0], re.sub(r'[0-9a-f]{40}|[0-9a-f]{7}', "<oid>", got[1]), got[2])
        assert (got[0], _fresh_ids(got[1], known), got[2]) == \
            (ref[0], _fresh_ids(ref[1], known), ref[2]), argv


def test_pk_rename_is_found(sources, tmp_path):
    """A row whose pk alone changes reads as one update, not an insert and a
    delete (``find_renames``)."""
    pair = Pair(tmp_path, [sources["points"]])
    pair.edit("UPDATE points SET fid = 100 WHERE fid = 7;")
    _, out, _ = pair.run(["diff", "-o", "json"])
    features = json.loads(out)["kart.diff/v1+hexwkb"]["points"]["feature"]
    assert len(features) == 1 and features[0]["-"]["fid"] == 7 and features[0]["+"]["fid"] == 100
    pair.run(["diff"])
    pair.run(["commit", "-m", "renamed", "-o", "json"], code=0)


def test_find_renames_bound():
    """More candidates than MAX_RENAME_SEARCH: nothing is paired."""
    from kart_tpu_torch.diff.structs import Delta, DeltaDiff, KeyValue
    from kart_tpu_torch.workingcopy import MAX_RENAME_SEARCH

    class _Ds:
        class schema:  # noqa: N801 (a stand-in with the one method used)
            @staticmethod
            def hash_feature(value, without_pk=False):
                raise AssertionError("hashed past the bound")

    diff = DeltaDiff([Delta(None, KeyValue((i, {"fid": i}))) for i in range(MAX_RENAME_SEARCH + 1)])
    find_renames(diff, _Ds())
    assert len(diff) == MAX_RENAME_SEARCH + 1


def test_branch_checkout_switch(sources, tmp_path):
    """kart_tpu's ``test_branch_checkout_switch``: a branch, an edit
    committed on it, ``branch``'s listing, and ``switch`` both ways."""
    pair = Pair(tmp_path, [sources["points"]])
    pair.run(["checkout", "-b", "dev"], code=0)
    pair.edit("UPDATE points SET name = 'dev-edit' WHERE fid = 1;")
    pair.run(["commit", "-m", "dev work"], code=0)
    pair.run(["branch"], code=0)
    pair.run(["branch", "-o", "json"], code=0)
    pair.run(["switch", "main"], code=0)
    pair.run(["switch", "dev"], code=0)
    pair.run(["switch", "-c", "other", "main"], code=0)
    pair.run(["checkout", "main"], code=0)
    pair.run(["checkout", "HEAD~0"], code=0)  # detached
    pair.run(["status"], code=0)
    pair.run(["switch"], code=2)
    pair.run(["checkout", "nosuch"], code=40)


def test_checkout_dirty_refuses(sources, tmp_path):
    """kart_tpu's ``test_checkout_dirty_refuses``: the same message and exit
    code, then ``--force``."""
    pair = Pair(tmp_path, [sources["points"]])
    pair.run(["checkout", "-b", "dev"], code=0)
    pair.run(["switch", "main"], code=0)
    pair.edit("UPDATE points SET name = 'dirty' WHERE fid = 1;")
    pair.run(["checkout", "dev"], code=20)
    pair.run(["switch", "dev"], code=20)
    pair.run(["reset", "HEAD"], code=20)
    pair.run(["checkout", "--force", "dev"], code=0)


def test_checkout_keeps_edits_without_force(sources, tmp_path):
    """``checkout -b`` and a plain ``checkout`` move the copy without
    ``--force``: a diff of the two trees, the user's edits kept."""
    pair = Pair(tmp_path, [sources["points"]])
    pair.edit("UPDATE points SET name = 'kept' WHERE fid = 2;"
              "UPDATE points SET name = 'also' WHERE fid = 20;")
    pair.run(["commit", "-m", "one", "points:feature:20"], code=0)
    pair.run(["checkout", "-b", "back", "HEAD^"], code=0)
    pair.run(["diff"])
    pair.run(["checkout"], code=0)
    pair.run(["checkout", "-f"], code=0)
    pair.run(["status"])


def test_restore(sources, tmp_path):
    """kart_tpu's ``test_restore``, and ``restore -s`` and by filter."""
    pair = Pair(tmp_path, [sources["points"]])
    pair.edit("UPDATE points SET name = 'scratch' WHERE fid = 1;")
    pair.run(["restore"], code=0)
    pair.run(["status"], code=0)
    pair.edit(EDITS)
    pair.run(["restore", "points:feature:4", "points:feature:31"], code=0)
    pair.run(["diff", "-o", "json"])
    pair.run(["commit", "-m", "edits"], code=0)
    pair.run(["restore", "-s", "HEAD^"], code=0)
    pair.run(["diff", "-o", "json"])


def test_reset(sources, tmp_path):
    pair = Pair(tmp_path, [sources["points"]])
    pair.edit(EDITS)
    pair.run(["commit", "-m", "edits"], code=0)
    pair.edit("DELETE FROM points WHERE fid = 1;")
    pair.run(["reset", "HEAD^"], code=20)
    pair.run(["reset", "--discard-changes", "HEAD^"], code=0)
    pair.run(["log", "-o", "json"])
    pair.run(["reset", "--hard", "nosuch"], code=40)


def test_create_workingcopy(sources, tmp_path):
    pair = Pair(tmp_path, [sources["points"]])
    pair.edit(EDITS)
    pair.run(["create-workingcopy", "--delete-existing"], code=0)
    pair.run(["status"], code=0)
    pair.run(["create-workingcopy", "other.gpkg"], code=0)
    assert wc_tables(os.path.join(pair.p, "other.gpkg")) == \
        wc_tables(os.path.join(pair.k, "other.gpkg"))


def test_two_datasets_and_attributes(sources, tmp_path):
    """A features and an attributes table in one copy; an edit of each."""
    pair = Pair(tmp_path, [sources["points"]])
    pair.run(["import", sources["records"]], code=0)
    pair.edit("UPDATE records SET code = 'Z' WHERE id = 3; DELETE FROM records WHERE id = 4;"
              "UPDATE points SET name = 'p' WHERE fid = 5;")
    pair.run(["status"])
    pair.run(["diff", "-o", "json"])
    pair.run(["commit", "-m", "both", "records"], code=0)
    pair.run(["status", "-o", "json"])
    pair.run(["switch", "-c", "b", "HEAD^"], code=0)


def test_bare_repository_has_no_working_copy(tmp_path, sources):
    for runner, path in ((kart, str(tmp_path / "k")), (port, str(tmp_path / "p"))):
        assert runner(["init", "--bare", path])[0] == 0
    pair = Pair.__new__(Pair)
    pair.k, pair.p = str(tmp_path / "k"), str(tmp_path / "p")
    JRepo(pair.k).config.set_many(USER)
    TRepo(pair.p).config.set_many(USER)
    pair.run(["import", sources["points"]], code=0)
    pair.run(["status"], code=0)
    pair.run(["commit", "-m", "x"], code=2)
    pair.run(["diff"], code=40)
    pair.run(["restore"], code=2)


@pytest.mark.parametrize("writer", ["kart_tpu", "port"])
def test_copies_cross_packages(sources, tmp_path, writer):
    """A working copy one package wrote and the user edited, read and
    committed by the other: the same commit as the writer's own."""
    pair = Pair(tmp_path, [sources["points"]])
    pair.edit(EDITS)
    src, dst = (pair.k, pair.p) if writer == "kart_tpu" else (pair.p, pair.k)
    shutil.copy(os.path.join(src, "wc.gpkg"), os.path.join(dst, "wc.gpkg"))
    pair.run(["diff", "-o", "json"])
    pair.run(["commit", "-m", "cross", "-o", "json"], code=0)
    pair.run(["switch", "-c", "x", "HEAD^"], code=0)


# --- the commands that update a working copy ------------------------------------

def _branch_pair(tmp_path, sources):
    """Two branches off the import: ``theirs`` (fid 3 renamed, fid 8
    deleted) and ``main`` (fid 4 renamed, and fid 3 too for ``conflict``)."""
    pair = Pair(tmp_path, [sources["points"]])
    pair.run(["checkout", "-b", "theirs"], code=0)
    pair.edit("UPDATE points SET name = 'theirs-3' WHERE fid = 3; DELETE FROM points "
              "WHERE fid = 8;")
    pair.run(["commit", "-m", "theirs"], code=0)
    pair.run(["switch", "main"], code=0)
    pair.edit("UPDATE points SET name = 'ours-4' WHERE fid = 4;")
    pair.run(["commit", "-m", "ours"], code=0)
    return pair


@pytest.mark.parametrize("args", [[], ["--no-ff", "-o", "json"], ["--dry-run"]],
                         ids=lambda a: " ".join(a) or "plain")
def test_merge_clean(sources, tmp_path, args):
    pair = _branch_pair(tmp_path, sources)
    pair.edit("UPDATE points SET name = 'uncommitted' WHERE fid = 20;")
    pair.run(["merge", "theirs", *args], code=0)
    pair.run(["status"])
    pair.run(["log", "-o", "json"])


def test_merge_fast_forward(sources, tmp_path):
    pair = Pair(tmp_path, [sources["points"]])
    pair.run(["branch", "ahead"], code=0)
    pair.run(["switch", "ahead"], code=0)
    pair.edit("UPDATE points SET name = 'ahead' WHERE fid = 2;")
    pair.run(["commit", "-m", "ahead"], code=0)
    pair.run(["switch", "main"], code=0)
    pair.run(["merge", "ahead"], code=0)
    pair.run(["branch", "-d", "ahead"], code=0)
    pair.run(["branch", "-d", "main"], code=20)
    pair.run(["branch", "-d", "nosuch"], code=2)


def test_merge_conflicts(sources, tmp_path):
    """Conflicts leave the working copy alone; ``--abort`` and
    ``--continue`` write HEAD into it."""
    pair = _branch_pair(tmp_path, sources)
    pair.edit("UPDATE points SET name = 'ours-3' WHERE fid = 3;")
    pair.run(["commit", "-m", "ours 3"], code=0)
    pair.run(["merge", "theirs"], code=0)
    pair.run(["status"])
    pair.run(["status", "-o", "json"])
    pair.run(["merge", "--abort"], code=0)
    pair.run(["merge", "theirs", "-o", "json"], code=0)
    pair.run(["resolve", "points:feature:3", "--with", "theirs"], code=0)
    pair.run(["merge", "--continue", "-m", "merged"], code=0)
    pair.run(["status", "-o", "json"])


def _patch(pair, tmp_path):
    """A patch of a commit made on a side branch, written by kart_tpu."""
    pair.run(["checkout", "-b", "side"], code=0)
    pair.edit("UPDATE points SET name = 'patched' WHERE fid = 10; DELETE FROM points "
              "WHERE fid = 11;")
    pair.run(["commit", "-m", "for the patch"], code=0)
    path = str(tmp_path / "patch.json")
    rc, out, _ = kart(["-C", pair.k, "create-patch", "HEAD"])
    assert rc == 0
    with open(path, "w") as f:
        f.write(out)
    pair.run(["switch", "main"], code=0)
    return path


@pytest.mark.parametrize("args", [[], ["--no-commit"]], ids=lambda a: " ".join(a) or "commit")
def test_apply(sources, tmp_path, args):
    pair = Pair(tmp_path, [sources["points"]])
    patch = _patch(pair, tmp_path)
    pair.edit("UPDATE points SET name = 'keep' WHERE fid = 20;")
    pair.run(["apply", *args, patch], code=0)
    pair.run(["diff", "-o", "json"])
    pair.run(["status", "-o", "json"])


def test_meta_set_and_commit_files_keep_edits(sources, tmp_path):
    """kart_tpu's ``test_commit_files_preserves_wc_edits_and_validates``:
    the edit survives ``commit-files`` and ``meta set``."""
    pair = Pair(tmp_path, [sources["points"]])
    pair.edit("UPDATE points SET name = 'keepme' WHERE fid = 6;")
    pair.run(["commit-files", "-m", "docs", "ABOUT.txt=hi"], code=0)
    _, out, _ = pair.run(["diff"])
    assert "keepme" in out
    pair.run(["meta", "set", "points", "title=A new title"], code=0)
    pair.run(["diff"])
    for bad in ("=x", "a//b=x", "../evil=x", "a/.=x"):
        pair.run(["commit-files", "-m", "bad", bad], code=2)


def _tree_files(path):
    out = {}
    for d, dirs, names in os.walk(path):
        dirs[:] = [x for x in dirs if x != "logs"]  # reflogs hold the wall clock
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), path)] = f.read()
    return out


@pytest.mark.parametrize("argv", [
    ["status"], ["diff"], ["commit", "-m", "x"], ["checkout", "-b", "b"], ["restore"],
    ["reset", "HEAD"], ["create-workingcopy"], ["merge", "theirs"],
    ["meta", "set", "points", "title=x"], ["commit-files", "-m", "x", "a=b"],
    ["import", "--replace-existing", "{points}"],
], ids=lambda a: " ".join(a))
def test_server_working_copy_not_ported(sources, tmp_path, argv):
    """A PostGIS location on a machine without the psycopg2 driver: each
    command exits with kart_tpu's code and message and writes what it
    writes. (The server working copies themselves are held, on recording
    servers, by ``test_torch_server_wc.py``.)"""
    from chip_smoke import drivers

    pair = Pair(tmp_path, [sources["points"]])
    for path, repo_cls in ((pair.k, JRepo), (pair.p, TRepo)):
        repo = repo_cls(path)
        repo.create_commit("refs/heads/theirs", repo.head_tree_oid, "ahead",
                           [repo.head_commit_oid])
        repo.config.set_many({"kart.workingcopy.location": "postgresql://h/db/s"})
    pair.edit("UPDATE points SET name = 'x' WHERE fid = 1;")
    results = []
    for run, path in ((kart, pair.k), (port, pair.p)):
        before = _tree_files(path)
        with drivers(None, "postgis"):
            res = masked(run(["-C", path, *[a.format(**sources) for a in argv]]), path)
        after = _tree_files(path)
        results.append((res, sorted(k for k in set(before) | set(after)
                                    if before.get(k) != after.get(k))))
    assert results[1] == results[0]