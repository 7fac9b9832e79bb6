"""``python -m kart_tpu_torch --device cpu -C <repo> merge|conflicts|resolve``
against kart_tpu's CLI: on copies of one repository, every step of a
scenario gives the same stdout, exit code and first line of stderr, and
leaves the same refs and ``MERGE_*`` files (so the same commit and tree
oids, dates pinned). Repositories come from ``kart_tpu.synth.synth_repo``
with a branch ``theirs`` set at the base commit and edited with
``kart_tpu.synth.commit_feature_edits``, and from an imported GPKG points
layer (a geometry column in EPSG:4326) with diverging edits on both
branches: conflicts as text, json and geojson, reprojected by ``--crs``,
resolved with ``--with`` and ``--with-file`` (a GeoJSON the port's own
``conflicts -o geojson`` wrote); and from an imported table whose pk is
text (a hash-keyed dataset), its MERGE_INDEX in JSON and in KMIX2;
``--crs`` to projected targets too. What the port does not do yet (a
working copy to update) exits 30 and writes nothing."""

import contextlib
import io
import json
import os
import shutil
import sqlite3

import numpy as np
import pytest
from click.testing import CliRunner

from helpers import edit_commit, make_imported_repo
from kart_tpu.cli import cli as kart_cli
from kart_tpu.core.objects import MODE_TREE
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.core.tree_builder import TreeBuilder
from kart_tpu.merge.index import MergeIndex
from kart_tpu.synth import commit_feature_edits, synth_repo
from kart_tpu_torch.cli import main as port_main

DATE = "1700000000 +0000"
N = 120
EDIT_FRAC = 0.1
SEED = 2
BASE_PK = 1 << 24


@pytest.fixture(autouse=True)
def _dates(monkeypatch):
    monkeypatch.setenv("GIT_AUTHOR_DATE", DATE)
    monkeypatch.setenv("GIT_COMMITTER_DATE", DATE)


def _ours_rows():
    """The rows synth_repo's edit commit rewrote on main."""
    n_edits = max(1, int(N * EDIT_FRAC))
    return np.sort(np.random.default_rng(SEED + 1).choice(N, size=n_edits, replace=False))


def _feature(row, rating):
    return {"fid": BASE_PK + int(row), "rating": float(rating)}


@pytest.fixture(scope="module")
def base_repo(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mergecli") / "base")
    old = {k: os.environ.get(k) for k in ("GIT_AUTHOR_DATE", "GIT_COMMITTER_DATE")}
    os.environ.update(GIT_AUTHOR_DATE=DATE, GIT_COMMITTER_DATE=DATE)
    try:
        synth_repo(path, N, edit_frac=EDIT_FRAC, seed=SEED, blobs="real")
    finally:
        for k, v in old.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    return path


def _branch_theirs(repo):
    base = repo.odb.read_commit(repo.head_commit_oid).parents[0]
    repo.refs.set("refs/heads/theirs", base)
    return base


def _untouched():
    return np.setdiff1d(np.arange(N), _ours_rows())


def setup_conflict(repo):
    """Edit/edit, edit/delete, delete/edit and add/add conflicts, with
    clean theirs-changes beside them."""
    _branch_theirs(repo)
    ours, free = _ours_rows(), _untouched()
    commit_feature_edits(repo, "synth", deletes=[BASE_PK + int(free[0])],
                         inserts=[_feature(N + 5, 1.0), _feature(N + 6, 2.0)], message="ours more")
    commit_feature_edits(
        repo, "synth",
        updates=[_feature(r, -1.0 - r) for r in [*ours[:5], free[0], *free[1:4]]],
        deletes=[BASE_PK + int(r) for r in (ours[5], free[4])],
        inserts=[_feature(N + 5, 1.0), _feature(N + 6, 3.0), _feature(N + 7, 4.0)],
        message="theirs edits", ref="refs/heads/theirs")


def setup_clean(repo):
    _branch_theirs(repo)
    free = _untouched()
    commit_feature_edits(repo, "synth", updates=[_feature(r, 7.5) for r in free[:3]],
                         deletes=[BASE_PK + int(free[3])], inserts=[_feature(N + 1, 9.0)],
                         message="theirs clean", ref="refs/heads/theirs")


def setup_ff(repo):
    """main back at the base commit, theirs at the edit commit."""
    head = repo.head_commit_oid
    base = repo.odb.read_commit(head).parents[0]
    repo.refs.set("refs/heads/theirs", head)
    repo.refs.set("refs/heads/main", base)


def _commit_tree_change(repo, ref, change, message):
    parent = repo.refs.get(ref)
    tb = TreeBuilder(repo.odb, repo.odb.read_commit(parent).tree)
    change(tb)
    return repo.create_commit(ref, tb.flush(), message, [parent])


def setup_meta(repo):
    """Both sides retitle the dataset (a meta conflict); theirs also edits
    a feature."""
    _branch_theirs(repo)
    title = "synth/.table-dataset/meta/title"
    _commit_tree_change(repo, "refs/heads/main",
                        lambda tb: tb.insert(title, repo.odb.write_blob(b"ours title")), "t1")
    _commit_tree_change(repo, "refs/heads/theirs",
                        lambda tb: tb.insert(title, repo.odb.write_blob(b"theirs title")), "t2")
    commit_feature_edits(repo, "synth", updates=[_feature(_untouched()[0], 3.25)],
                         message="theirs feature", ref="refs/heads/theirs")


def setup_new_dataset(repo):
    """Theirs adds a second dataset, a copy of the first one's tree."""
    _branch_theirs(repo)
    tree = repo.odb.tree(repo.odb.read_commit(repo.refs.get("refs/heads/theirs")).tree)
    synth_oid = tree.entry("synth").oid
    _commit_tree_change(repo, "refs/heads/theirs",
                        lambda tb: tb.insert("synth2", synth_oid, mode=MODE_TREE), "add synth2")


def _labels(path, index):
    """The ``index``-th unresolved conflict label of kart_tpu's repo."""
    mi = MergeIndex.read_from_repo(JRepo(path))
    return mi.unresolved_labels[index]


def resolve(index, version):
    return lambda kpath: [["resolve", _labels(kpath, index), "--with", version]]


def _resolve_with_file(kpath, index, version):
    """``resolve <label> --with-file F``, F holding the ``version``
    feature of the label as the port's ``conflicts -o geojson`` writes it
    (read from ``kpath``: a read-only command)."""
    label = _labels(kpath, index)
    rc, out, _ = _run_port(["--device", "cpu", "-C", kpath, "conflicts", "-o", "geojson", label])
    assert rc == 0
    doc = json.loads(out)
    doc["features"] = [f for f in doc["features"] if f["id"] == f"{label}:{version}"]
    assert len(doc["features"]) == 1
    path = os.path.join(os.path.dirname(kpath), f"resolve-{index}-{version}.geojson")
    with open(path, "w") as f:
        json.dump(doc, f)
    return ["resolve", label, "--with-file", path]


def resolve_rest(version):
    def steps(kpath):
        n = len(MergeIndex.read_from_repo(JRepo(kpath)).unresolved_labels)
        return [resolve(0, version)(kpath)[0] for _ in range(n)]
    return steps


SCENARIOS = {
    "conflict": (setup_conflict, [
        ["merge", "theirs", "--ff-only"],
        ["merge", "theirs", "--dry-run"],
        ["merge", "theirs", "--dry-run", "-o", "json"],
        ["conflicts", "-ss"],
        ["merge", "theirs"],
        ["merge", "theirs"],
        ["conflicts"],
        ["conflicts", "--flat"],
        ["conflicts", "-o", "geojson"],
        ["conflicts", "-o", "geojson", "--json-style", "compact", "synth:feature"],
        ["conflicts", "--crs", "EPSG:4277"],
        ["conflicts", "-o", "json"],
        ["conflicts", "-o", "json", "--json-style", "compact", "--flat"],
        ["conflicts", "-s"],
        ["conflicts", "-ss"],
        ["conflicts", "-o", "json", "-ss"],
        ["conflicts", "-o", "json", "-s", "--flat"],
        ["conflicts", "-o", "json", "-s", "synth:feature"],
        ["conflicts", "-o", "json", f"synth:feature:{BASE_PK + N + 6}"],
        ["conflicts", "-o", "quiet"],
        ["conflicts", "--exit-code", "-o", "json", "-ss"],
        ["conflicts", "-o", "json", "nosuch"],
        resolve(0, "ours"),
        lambda k: [_resolve_with_file(k, 0, "theirs")],
        # the first conflict again: already resolved
        lambda k: [["resolve", next(iter(MergeIndex.read_from_repo(JRepo(k)).conflicts)),
                    "--with", "theirs"]],
        ["resolve", "nosuch", "--with", "ours"],
        ["resolve", "synth:feature:1"],
        resolve(0, "theirs"),
        resolve(1, "ancestor"),
        resolve(0, "delete"),
        ["merge", "--continue"],
        ["conflicts", "-s"],
        resolve_rest("theirs"),
        ["conflicts", "-o", "quiet"],
        ["conflicts", "-ss", "--exit-code"],
        ["merge", "--continue", "-o", "json"],
        ["merge", "--abort"],
        ["merge", "theirs", "-o", "json"],
    ]),
    "abort": (setup_conflict, [
        ["merge", "theirs", "-o", "json"],
        ["merge", "--abort"],
        ["merge", "--continue"],
        ["merge", "theirs", "-m", "a message of my own"],
        resolve_rest("ours"),
        ["merge", "--continue"],
    ]),
    "clean": (setup_clean, [
        ["merge", "theirs", "--dry-run", "-o", "json"],
        ["merge", "theirs", "--dry-run"],
        ["merge", "theirs"],
        ["merge", "theirs", "-o", "json"],
        ["merge", "theirs"],
    ]),
    "clean_json": (setup_clean, [["merge", "theirs", "-o", "json", "-m", "custom"]]),
    "fast_forward": (setup_ff, [
        ["merge", "theirs", "--dry-run", "-o", "json"],
        ["merge", "theirs", "--dry-run"],
        ["merge", "theirs", "-o", "json"],
        ["merge", "theirs"],
    ]),
    "fast_forward_text": (setup_ff, [["merge", "theirs", "--ff-only"]]),
    "no_ff": (setup_ff, [["merge", "theirs", "--no-ff", "-o", "json"]]),
    "no_ff_text": (setup_ff, [["merge", "theirs", "--no-ff"], ["merge", "theirs"]]),
    "meta": (setup_meta, [
        ["merge", "theirs", "-o", "json"],
        ["conflicts", "-o", "json"],
        ["conflicts", "-ss"],
        ["conflicts", "-s", "synth:meta"],
        resolve(0, "ours"),
        ["merge", "--continue", "-o", "json"],
    ]),
    "new_dataset": (setup_new_dataset, [
        ["merge", "theirs", "--dry-run", "-o", "json"],
        ["merge", "theirs", "-o", "json"],
    ]),
    "arguments": (setup_clean, [
        ["merge"],
        ["merge", "nosuch"],
        ["merge", "--continue"],
        ["resolve", "x", "--with", "ours"],
        ["merge", "HEAD^", "-o", "json"],
        ["merge", "HEAD^"],
    ]),
}


def _state(path):
    """Refs (HEAD, loose and packed) and MERGE_* files, by name."""
    gitdir = os.path.join(path, ".kart")
    out = {}
    for name in ("HEAD", "packed-refs", "MERGE_HEAD", "MERGE_MSG", "MERGE_BRANCH",
                 "MERGE_INDEX"):
        p = os.path.join(gitdir, name)
        if os.path.exists(p):
            with open(p, "rb") as f:
                out[name] = f.read()
    for d, _, names in os.walk(os.path.join(gitdir, "refs")):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), gitdir)] = f.read()
    return out


def _run_port(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_main(argv)
    return rc, out.getvalue(), err.getvalue()


def _copies(base_repo, tmp_path, setup):
    setup_path = str(tmp_path / "setup")
    shutil.copytree(base_repo, setup_path)
    setup(JRepo(setup_path))
    kpath, ppath = str(tmp_path / "k"), str(tmp_path / "p")
    shutil.copytree(setup_path, kpath)
    shutil.copytree(setup_path, ppath)
    return kpath, ppath


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_merge_cli_matches_kart_tpu(base_repo, tmp_path, scenario):
    setup, steps = SCENARIOS[scenario]
    _run_steps(*_copies(base_repo, tmp_path, setup), steps)


def _run_steps(kpath, ppath, steps):
    seen_codes = set()
    for step in steps:
        for args in (step(kpath) if callable(step) else [step]):
            ref = CliRunner().invoke(kart_cli, ["-C", kpath, *args])
            assert ref.exception is None or isinstance(ref.exception, SystemExit), \
                (args, ref.exception)
            rc, out, err = _run_port(["--device", "cpu", "-C", ppath, *args])
            assert (rc, out) == (ref.exit_code, ref.stdout), args
            assert err.splitlines()[:1] == ref.stderr.splitlines()[:1], args
            assert _state(ppath) == _state(kpath), args
            seen_codes.add(rc)
    assert 0 in seen_codes


@pytest.fixture(scope="module")
def points_repo(tmp_path_factory):
    """Imported GPKG points (``fid``, ``geom``, ``name``, ``rating``) with a
    branch ``theirs`` at the import."""
    base = tmp_path_factory.mktemp("mergepoints")
    old = {k: os.environ.get(k) for k in ("GIT_AUTHOR_DATE", "GIT_COMMITTER_DATE")}
    os.environ.update(GIT_AUTHOR_DATE=DATE, GIT_COMMITTER_DATE=DATE)
    try:
        repo, _ = make_imported_repo(base, n=12)
        repo.refs.set("refs/heads/theirs", repo.head_commit_oid)
    finally:
        for k, v in old.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    return str(repo.workdir)


def _point(fid, x, y, name, rating):
    from kart_tpu.geometry import Geometry

    return {"fid": fid, "geom": Geometry.from_wkt(f"POINT ({x} {y})"), "name": name,
            "rating": rating}


def setup_points_conflict(repo):
    """Edit/edit (moved points), edit/delete, delete/edit and add/add
    conflicts on a geometry column, beside clean edits on both sides."""
    edit_commit(repo, "points",
                updates=[_point(2, 170.5, -41.25, "ours-2", 1.0), _point(3, 171, -42, "ours-3", 2.0),
                         _point(8, 100, -40, "clean-ours", 8.0)],
                deletes=[4], inserts=[_point(40, 1.5, 2.5, "ours-40", None)], message="ours")
    edit_commit(repo, "points",
                updates=[_point(2, 172.125, -43.5, "theirs-2", -1.0),
                         _point(4, 99, -39, "theirs-4", 4.0), _point(9, 101, -41, "clean", 9.0)],
                deletes=[3], inserts=[_point(40, -1.5, -2.5, "theirs-40", 3.5)],
                message="theirs", ref="refs/heads/theirs")


POINT_SCENARIOS = {
    "points_conflict": (setup_points_conflict, [
        ["merge", "theirs", "-o", "json"],
        ["conflicts"],
        ["conflicts", "-s"],
        ["conflicts", "-o", "json"],
        ["conflicts", "-o", "geojson"],
        ["conflicts", "--crs", "EPSG:4277"],
        ["conflicts", "--crs", "EPSG:2193"],
        ["conflicts", "-o", "json", "--crs", "EPSG:4277"],
        ["conflicts", "-o", "json", "--flat", "--crs", "EPSG:4277"],
        ["conflicts", "-o", "geojson", "--crs", "EPSG:4277"],
        ["conflicts", "-o", "geojson", "points:feature:2"],
        lambda k: [_resolve_with_file(k, 0, "theirs")],
        lambda k: [_resolve_with_file(k, 0, "ours")],
        ["conflicts"],
        resolve(0, "ancestor"),
        resolve_rest("theirs"),
        ["merge", "--continue", "-o", "json"],
    ]),
    "points_abort": (setup_points_conflict, [
        ["merge", "theirs"],
        lambda k: [_resolve_with_file(k, 1, "ancestor")],
        ["conflicts", "-o", "geojson", "--json-style", "extracompact"],
        ["merge", "--abort"],
    ]),
}


@pytest.mark.parametrize("scenario", list(POINT_SCENARIOS))
def test_points_merge_cli_matches_kart_tpu(points_repo, tmp_path, scenario):
    """A conflicted merge of a layer with geometry: GeoJSON geometries,
    ``--crs`` and ``--with-file`` geometries are compared, and the merge
    commit's oid."""
    setup, steps = POINT_SCENARIOS[scenario]
    _run_steps(*_copies(points_repo, tmp_path, setup), steps)


def test_conflicted_merge_writes_json_index(base_repo, tmp_path):
    """A small conflicted merge writes the JSON MERGE_INDEX (under 10,000
    conflicts) with the conflicts kart_tpu finds."""
    kpath, ppath = _copies(base_repo, tmp_path, setup_conflict)
    CliRunner().invoke(kart_cli, ["-C", kpath, "merge", "theirs"])
    assert _run_port(["--device", "cpu", "-C", ppath, "merge", "theirs"])[0] == 0
    with open(os.path.join(ppath, ".kart", "MERGE_INDEX"), "rb") as f:
        raw = f.read()
    assert raw.startswith(b'{"kart.merge_index/v1"')
    labels = list(MergeIndex.read_from_repo(JRepo(ppath)).conflicts)
    # 5 edit/edit, 1 edit/delete, 1 delete/edit, 1 add/add (the equal add is clean)
    assert len(labels) == 8 and f"synth:feature:{BASE_PK + N + 6}" in labels


def _merge_with_working_copies(kpath, ppath, argv):
    """``argv`` in both copies, each with a working copy kart_tpu wrote:
    equal outputs, refs and MERGE_* files, and the same rows in every
    table of the copies."""
    from test_torch_workingcopy import wc_tables

    ref = CliRunner().invoke(kart_cli, ["-C", kpath, *argv])
    assert ref.exception is None or isinstance(ref.exception, SystemExit), ref.exception
    got = _run_port(["--device", "cpu", "-C", ppath, *argv])
    assert got == (ref.exit_code, ref.stdout, ref.stderr), (argv, got)
    assert _state(ppath) == _state(kpath)
    assert wc_tables(os.path.join(ppath, "p.gpkg")) == wc_tables(os.path.join(kpath, "k.gpkg"))


@pytest.mark.parametrize("setup", [setup_clean, setup_conflict], ids=["clean", "conflict"])
def test_working_copy_not_ported_yet(base_repo, tmp_path, setup):
    """A repository with a GPKG working copy: both merges as kart_tpu makes
    them; a clean one writes the merge commit into the copy, a conflicted
    one leaves it alone until ``--abort`` (the name is kept from when the
    port refused them)."""
    kpath, ppath = _copies(base_repo, tmp_path, setup)
    for path in (kpath, ppath):
        r = CliRunner().invoke(kart_cli, ["-C", path, "create-workingcopy"])
        assert r.exit_code == 0, r.output
    _merge_with_working_copies(kpath, ppath, ["merge", "theirs"])
    if setup is setup_conflict:
        _merge_with_working_copies(kpath, ppath, ["merge", "--abort"])
    else:
        _merge_with_working_copies(kpath, ppath, ["reset", "--discard-changes", "HEAD^"])
    _merge_with_working_copies(kpath, ppath, ["merge", "theirs", "--no-ff", "-o", "json"])
    _merge_with_working_copies(kpath, ppath, ["status"])


def _text_pk_repo(tmp_path, n=20):
    """A hash-keyed dataset: a GPKG attributes table ``codes`` of ``n``
    rows whose pk is text, imported by kart_tpu, with a branch ``theirs``
    at the import and the same commit date everywhere. -> its path."""
    from kart_tpu.importer import ImportSource
    from kart_tpu.importer.importer import import_sources

    gpkg = str(tmp_path / "codes.gpkg")
    con = sqlite3.connect(gpkg)
    con.executescript(
        "CREATE TABLE gpkg_contents (table_name TEXT NOT NULL PRIMARY KEY, data_type TEXT NOT "
        "NULL, identifier TEXT UNIQUE, description TEXT DEFAULT '', last_change DATETIME, "
        "min_x DOUBLE, min_y DOUBLE, max_x DOUBLE, max_y DOUBLE, srs_id INTEGER);"
        "INSERT INTO gpkg_contents (table_name, data_type, identifier) "
        "VALUES ('codes', 'attributes', 'codes');"
        "CREATE TABLE codes (code TEXT PRIMARY KEY NOT NULL, amount INTEGER);")
    con.executemany("INSERT INTO codes VALUES (?, ?)", [(_code(i), i) for i in range(n)])
    con.commit()
    con.close()
    old = {k: os.environ.get(k) for k in ("GIT_AUTHOR_DATE", "GIT_COMMITTER_DATE")}
    os.environ.update(GIT_AUTHOR_DATE=DATE, GIT_COMMITTER_DATE=DATE)
    try:
        repo = JRepo.init_repository(str(tmp_path / "hash"))
        repo.config.set_many({"user.name": "Tester", "user.email": "t@example.com"})
        import_sources(repo, ImportSource.open(gpkg))
        repo.refs.set("refs/heads/theirs", repo.head_commit_oid)
    finally:
        for k, v in old.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    return str(repo.workdir)


def _code(i):
    """G-NAF-shaped text pks, one unicode and one with a space and a slash."""
    return {3: "ünï☃-3", 7: "a b/7"}.get(i, f"GANSW7041{i:05d}")


@pytest.fixture(scope="module")
def text_pk_repo(tmp_path_factory):
    return _text_pk_repo(tmp_path_factory.mktemp("textpk"))


def _code_row(i, amount):
    return {"code": _code(i), "amount": amount}


def setup_text_conflict(repo):
    """Edit/edit, edit/delete, delete/edit and add/add conflicts on text
    pks (the unicode one among them), beside clean edits."""
    commit_feature_edits(repo, "codes", updates=[_code_row(i, 100 + i) for i in (1, 2, 3, 7)]
                         + [_code_row(9, 9)], deletes=[_code(4), _code(12)],
                         inserts=[_code_row(40, 1), _code_row(41, 2)], message="ours")
    commit_feature_edits(repo, "codes", updates=[_code_row(i, 200 + i) for i in (1, 2, 3, 4, 7)]
                         + [_code_row(13, 13)], deletes=[_code(9), _code(14)],
                         inserts=[_code_row(40, 1), _code_row(41, 3), _code_x()],
                         message="theirs", ref="refs/heads/theirs")


def _code_x():
    return {"code": "GAVIC000000001", "amount": None}


def setup_text_clean(repo):
    commit_feature_edits(repo, "codes", updates=[_code_row(5, 55)], message="ours clean")
    commit_feature_edits(repo, "codes", updates=[_code_row(6, 66)], deletes=[_code(8)],
                         inserts=[_code_x()], message="theirs clean", ref="refs/heads/theirs")


HASH_SCENARIOS = {
    "text_conflict": (setup_text_conflict, [
        ["merge", "theirs", "--dry-run"],
        ["merge", "theirs", "--dry-run", "-o", "json"],
        ["merge", "theirs", "-o", "json"],
        ["conflicts"],
        ["conflicts", "-o", "json"],
        ["conflicts", "-o", "json", "--flat"],
        ["conflicts", "-o", "geojson"],
        ["conflicts", "-s"],
        ["conflicts", "-ss", "-o", "json"],
        ["conflicts", "-o", "json", f"codes:feature:{_code(3)}"],
        ["conflicts", "-o", "json", f"codes:feature:{_code(7)}"],
        ["resolve", f"codes:feature:{_code(1)}", "--with", "theirs"],
        ["resolve", f"codes:feature:{_code(7)}", "--with", "ours"],
        ["resolve", f"codes:feature:{_code(7)}", "--with", "ours"],
        ["resolve", "codes:feature:nosuch", "--with", "ours"],
        lambda k: [_resolve_with_file(k, 0, "theirs")],
        resolve(0, "ancestor"),
        ["merge", "--continue"],
        resolve_rest("delete"),
        ["conflicts", "-o", "quiet"],
        ["merge", "--continue", "-o", "json"],
    ]),
    "text_abort": (setup_text_conflict, [
        ["merge", "theirs"],
        ["conflicts", "-ss"],
        ["merge", "--abort"],
        ["merge", "theirs", "-o", "json"],
        resolve_rest("theirs"),
        ["merge", "--continue"],
    ]),
    "text_clean": (setup_text_clean, [
        ["merge", "theirs", "--dry-run", "-o", "json"],
        ["merge", "theirs", "-o", "json"],
        ["merge", "theirs"],
    ]),
}


@pytest.mark.parametrize("scenario", list(HASH_SCENARIOS))
def test_text_pk_merge_cli_matches_kart_tpu(text_pk_repo, tmp_path, scenario):
    """A hash-keyed dataset (text pks) merges, lists and resolves its
    conflicts as kart_tpu does: the same bytes, exit codes, JSON
    MERGE_INDEX and commit oids."""
    setup, steps = HASH_SCENARIOS[scenario]
    _run_steps(*_copies(text_pk_repo, tmp_path, setup), steps)


def _rewrite_all(repo, ref, amount, n, message):
    """Commit on ``ref`` every row of ``codes`` rewritten to ``amount *
    (row + 1)``, its blobs and trees in one pack."""
    parent = repo.refs.get(ref)
    ds = repo.structure(parent).datasets["codes"]
    odb = repo.odb
    with odb.bulk_pack():
        tb = TreeBuilder(odb, odb.read_commit(parent).tree)
        for i in range(n):
            full_path, blob = ds.encode_feature(_code_row(i, amount * (i + 1)))
            tb.insert(full_path, odb.write_blob(blob))
        tree = tb.flush()
    return repo.create_commit(ref, tree, message, [parent])


def test_text_pk_merge_index_kmix2(tmp_path):
    """10,000 text-pk conflicts: the KMIX2 MERGE_INDEX (its label and
    path columns stored as strings) is byte-identical, and so are the
    conflict listings and the resolved merge commit."""
    n = 10_000
    path = _text_pk_repo(tmp_path, n)

    def setup(repo):
        _rewrite_all(repo, "refs/heads/main", -1, n, "ours")
        _rewrite_all(repo, "refs/heads/theirs", -2, n, "theirs")

    kpath, ppath = _copies(path, tmp_path, setup)
    _run_steps(kpath, ppath, [["merge", "theirs", "-o", "json"], ["conflicts", "-ss"],
                              ["resolve", f"codes:feature:{_code(3)}", "--with", "theirs"],
                              ["conflicts", "-s", f"codes:feature:{_code(7)}"]])
    with open(os.path.join(ppath, ".kart", "MERGE_INDEX"), "rb") as f:
        assert f.read(6) == b"KMIX2\n"
    assert len(MergeIndex.read_from_repo(JRepo(ppath)).conflicts) == n


def _retype_pk_to_text(repo, ds_path, message):
    """Commit ``ds_path`` with its integer pk made text: the schema's pk
    column (same id) typed text, every feature re-encoded under the hashed
    path scheme (a pk type change). -> the commit oid."""
    from kart_tpu.models.dataset import Dataset3
    from kart_tpu.models.paths import PathEncoder
    from kart_tpu.models.schema import ColumnSchema, Schema

    ds = repo.structure("HEAD").datasets[ds_path]
    pk_name = ds.schema.pk_columns[0].name
    cols = [ColumnSchema(c.id, c.name, "text", c.pk_index, {}) if c.name == pk_name else c
            for c in ds.schema.columns]
    schema = Schema(cols)
    odb = repo.odb
    parent = repo.head_commit_oid
    with odb.bulk_pack():
        tb = TreeBuilder(odb, odb.read_commit(parent).tree)
        tb.remove_tree(f"{ds_path}/.table-dataset")
        for path, data in Dataset3.new_dataset_meta_blobs(
                ds_path, schema, title=ds.get_meta_item("title"),
                path_encoder=PathEncoder.GENERAL_ENCODER):
            tb.insert(path, odb.write_blob(data))
        enc = PathEncoder.GENERAL_ENCODER
        for f in ds.features():
            pk_values, blob = schema.encode_feature_blob({**f, pk_name: str(f[pk_name])})
            tb.insert(f"{ds_path}/.table-dataset/feature/{enc.encode_pks_to_path(pk_values)}",
                      odb.write_blob(blob))
        tree = tb.flush()
    return repo.create_commit("HEAD", tree, message, [parent])


def setup_pk_change(repo):
    """Ours retypes synth's pk to text; theirs edits, deletes and inserts
    int-pk features: the conflicts' versions carry different encoders."""
    _branch_theirs(repo)
    _retype_pk_to_text(repo, "synth", "fid becomes text")
    free = _untouched()
    commit_feature_edits(repo, "synth", updates=[_feature(r, 0.5) for r in free[:4]],
                         deletes=[BASE_PK + int(free[4])], inserts=[_feature(N + 3, 1.0)],
                         message="theirs int edits", ref="refs/heads/theirs")


def test_pk_type_change_merge_matches_kart_tpu(base_repo, tmp_path):
    """A dataset whose pk type changed on one branch (int to text): the
    conflict labels come from the ancestor's int encoder, the merged tree
    and the resolved commit are kart_tpu's."""
    kpath, ppath = _copies(base_repo, tmp_path, setup_pk_change)
    _run_steps(kpath, ppath, [
        ["merge", "theirs", "--dry-run", "-o", "json"],
        ["merge", "theirs", "-o", "json"],
        ["conflicts", "-o", "json"],
        ["conflicts", "-s"],
        resolve(0, "theirs"),
        resolve_rest("ours"),
        ["merge", "--continue", "-o", "json"],
    ])


def _coarse_keys(monkeypatch):
    """Both packages' hash keys cut to their top 4 bits (``>> 59``): the
    features of a version then share keys. The fixture restores both."""
    from kart_tpu.ops import blocks as jblocks
    from kart_tpu_torch.ops import blocks as tblocks

    for mod, real in ((jblocks, jblocks.hash_keys_for_paths),
                      (tblocks, tblocks.hash_keys_for_paths)):
        monkeypatch.setattr(mod, "hash_keys_for_paths", lambda paths, real=real: real(paths) >> 59)


def test_colliding_hash_keys_merge_on_the_host_path(text_pk_repo, tmp_path, monkeypatch):
    """Hash keys that collide within a version: both packages merge the
    dataset by path (kart_tpu's dict semantics), with the same outputs, and
    the port counts the collision path once a merge."""
    from kart_tpu_torch import runtime

    _coarse_keys(monkeypatch)
    kpath, ppath = _copies(text_pk_repo, tmp_path, setup_text_conflict)
    runtime.reset_stats()
    _run_steps(kpath, ppath, [["merge", "theirs", "--dry-run", "-o", "json"],
                              ["merge", "theirs", "-o", "json"], ["conflicts", "-o", "json"],
                              resolve_rest("theirs"), ["merge", "--continue"]])
    assert runtime.stats_snapshot()["hash_collision_fallbacks"] == 2


@pytest.mark.parametrize("argv", [["conflicts", "-o", "geojson", "-s", "--crs", "EPSG:2193"],
                                  ["conflicts", "-o", "geojson", "--crs", "EPSG:2193"],
                                  ["conflicts", "-o", "json", "--crs", "EPSG:2193"],
                                  ["conflicts", "-o", "json", "--flat", "--crs", "EPSG:3857"]])
def test_not_ported_conflict_outputs(points_repo, tmp_path, argv):
    """A projected ``--crs`` target: the port's conflicts, reprojected,
    print kart_tpu's bytes and exit code and leave the same state (the name
    is kept from when the port refused them)."""
    kpath, ppath = _copies(points_repo, tmp_path, setup_points_conflict)
    _run_steps(kpath, ppath, [["merge", "theirs"], argv])


LABEL_SETS = {
    "one_dataset": [f"synth:feature:{i}" for i in (5, 40, 3, 12)] + ["synth:meta:title"],
    "datasets_and_parts": ["b:feature:x", "a:feature:2", "b:meta:title", "<root>:attachment:z",
                           "a:meta:schema.json", "10:feature:1", "9:feature:1", "a,b:feature:q"],
    "prefixes_sorting_alike": ["12:feature:1", "012:feature:2", "012:meta:title"],
    "colons_in_pks": ["codes:feature:a:b:7", "codes:feature:GANSW1", "codes:feature:9"],
}


@pytest.mark.parametrize("summarise", [2, 3])
@pytest.mark.parametrize("labels", list(LABEL_SETS))
def test_conflict_count_summary_as_kart_tpu(tmp_path, labels, summarise):
    """``conflicts -ss``'s counts nested as kart_tpu's sort of every label
    nests them (several datasets, meta, attachments, numeric and compound
    names, prefixes whose sort keys tie, pks holding ':')."""
    from kart_tpu.cli.merge_cmds import _build_conflicts_output as j_build
    from kart_tpu_torch.cli.merge_cmds import _build_conflicts_output as t_build

    unresolved = dict.fromkeys(LABEL_SETS[labels])
    want = j_build(JRepo.init_repository(str(tmp_path / "r")), unresolved, "json",
                   summarise=summarise)
    got = t_build(None, None, unresolved, "json", summarise=summarise)
    assert json.dumps(got) == json.dumps(want)
