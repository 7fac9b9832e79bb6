"""The annotations cache's counts (``kart_tpu_torch.annotations``
``count_changes`` and ``build_all``, ``kart build-annotations``) against
kart_tpu's: the same counts for every commit of a history against its
parent (the tree walk, and the columnar classify on a layer with
sidecars), the same ``kart_annotations`` rows in the same order, the
100-commit limit without ``--all-reachable``, the same output line, a
cached answer that runs no diff, each package reading the database the
other wrote, and the in-memory store of a read-only gitdir. Each package
works on its own copy of a repository unless a test shares one on
purpose."""

import contextlib
import io
import os
import shutil
import sqlite3

import numpy as np
import pytest
from click.testing import CliRunner

from helpers import edit_commit, make_imported_repo
from kart_tpu.annotations import DiffAnnotations as JAnnotations
from kart_tpu.cli import cli as kart_cli
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.synth import synth_repo as jsynth_repo
from kart_tpu_torch.annotations import DiffAnnotations
from kart_tpu_torch.cli import main as port_main
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.diff import engine

CPU = "cpu"


def _edited(base, n_empty=0):
    """An imported points layer, then an update and a delete, an insert,
    and ``n_empty`` commits that change nothing. -> path."""
    repo, ds_path = make_imported_repo(base, n=12)
    ds = repo.structure("HEAD").datasets[ds_path]
    edit_commit(repo, ds_path, updates=[{**ds.get_feature([3]), "name": "edited"}], deletes=[5])
    edit_commit(repo, ds_path, inserts=[{"fid": 99, "geom": None, "name": "x", "rating": 1.0}])
    tree = repo.odb.read_commit(repo.head_commit_oid).tree
    for i in range(n_empty):
        repo.create_commit("HEAD", tree, f"empty {i}", [repo.head_commit_oid])
    return str(repo.workdir)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    base = tmp_path_factory.mktemp("ann")
    out = {}
    for name, n_empty in (("short", 0), ("long", 104)):
        (base / name).mkdir()
        out[name] = _edited(base / name, n_empty)
    out["synth"] = str(base / "synth")
    jsynth_repo(out["synth"], 3000, blobs="changed", seed=7)
    out["empty"] = str(base / "empty")
    JRepo.init_repository(out["empty"])
    return out


@pytest.fixture
def pair(sources, tmp_path):
    """name -> (kart_tpu's copy, the port's copy) of a source repo."""
    def copies(name):
        return tuple(str(shutil.copytree(sources[name], tmp_path / f"{name}-{who}"))
                     for who in ("j", "t"))
    return copies


def _rows(path):
    con = sqlite3.connect(os.path.join(path, ".kart", "annotations.db"))
    try:
        return con.execute("SELECT id, object_id, annotation_type, data FROM kart_annotations "
                           "ORDER BY id").fetchall()
    finally:
        con.close()


def _history(repo):
    return [(c.parents[0] if c.parents else None, oid)
            for oid, c in repo.walk_commits(repo.head_commit_oid)]


@pytest.mark.parametrize("name", ["short", "synth"])
def test_count_changes_matches_kart_tpu(pair, name):
    j, t = pair(name)
    jrepo, trepo = JRepo(j), TRepo(t)
    jann, tann = JAnnotations(jrepo), DiffAnnotations(trepo)
    history = _history(jrepo)
    assert history == _history(trepo)
    for parent, oid in history:
        want = jann.count_changes(jrepo.structure(parent) if parent else None,
                                  jrepo.structure(oid))
        got = tann.count_changes(trepo.structure(parent) if parent else None,
                                 trepo.structure(oid), device=CPU)
        assert got == want and sum(got.values()) > 0
    assert _rows(t) == _rows(j)


def test_count_changes_short_circuits_on_the_cache(pair, monkeypatch):
    _, t = pair("short")
    repo = TRepo(t)
    base, target = repo.structure("HEAD^"), repo.structure("HEAD")
    ann = DiffAnnotations(repo)
    counts = ann.count_changes(base, target, device=CPU)
    assert counts == {"points": 1}

    def boom(*a, **kw):
        raise AssertionError("count_changes recomputed a cached diff")

    monkeypatch.setattr(engine, "get_repo_diff", boom)
    assert ann.count_changes(base, target) == counts
    assert DiffAnnotations(repo).count_changes(target, base) == counts  # one key both ways


def test_count_changes_identical_revisions(pair):
    _, t = pair("short")
    repo = TRepo(t)
    head = repo.structure("HEAD")
    assert DiffAnnotations(repo).count_changes(head, head, device=CPU) == {}
    assert JAnnotations(JRepo(t)).get(head.tree_oid, head.tree_oid) == {}


@pytest.mark.parametrize("all_reachable", [False, True])
@pytest.mark.parametrize("name", ["short", "long", "synth", "empty"])
def test_build_all_matches_kart_tpu(pair, name, all_reachable):
    """The same count and the same rows; 100 commits at most unless
    ``all_reachable`` (the long history has 107)."""
    j, t = pair(name)
    built = DiffAnnotations(TRepo(t)).build_all(all_reachable=all_reachable, device=CPU)
    assert built == JAnnotations(JRepo(j)).build_all(all_reachable=all_reachable)
    want = {"short": 3, "synth": 2, "empty": 0}.get(name, 107 if all_reachable else 100)
    assert built == want
    assert _rows(t) == _rows(j)


def _port(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [[], ["--all-reachable"]], ids=lambda a: " ".join(a) or "default")
@pytest.mark.parametrize("name", ["short", "long", "empty"])
def test_build_annotations_cli_matches_kart_tpu(pair, name, argv):
    j, t = pair(name)
    for _ in range(2):  # the second run reads the cache
        ref = CliRunner().invoke(kart_cli, ["-C", j, "build-annotations", *argv],
                                 prog_name="kart")
        rc, out, err = _port(["--device", CPU, "-C", t, "build-annotations", *argv])
        assert (rc, out, err) == (ref.exit_code, ref.stdout, ref.stderr)
        assert out.startswith("Built annotations for ")
    assert _rows(t) == _rows(j)


def test_each_package_reads_the_other_s_database(pair, monkeypatch):
    """kart_tpu builds and the port answers from its rows with no diff;
    then the port builds on another copy and kart_tpu answers from its."""
    j, t = pair("short")
    JAnnotations(JRepo(j)).build_all()
    TRepo_j = TRepo(j)
    DiffAnnotations(TRepo(t)).build_all(device=CPU)
    jrepo_t = JRepo(t)

    def boom(*a, **kw):
        raise AssertionError("a cached count was recomputed")

    import kart_tpu.diff.engine as jengine

    monkeypatch.setattr(engine, "get_repo_diff", boom)
    monkeypatch.setattr(jengine, "get_repo_diff", boom)
    for parent, oid in _history(TRepo_j):
        base = TRepo_j.structure(parent) if parent else None
        got = DiffAnnotations(TRepo_j).count_changes(base, TRepo_j.structure(oid))
        jbase = jrepo_t.structure(parent) if parent else None
        assert JAnnotations(jrepo_t).count_changes(jbase, jrepo_t.structure(oid)) == got
    assert DiffAnnotations(TRepo_j).build_all() == 3  # every answer cached: no diff


def test_readonly_gitdir_keeps_counts_in_memory(pair):
    _, t = pair("short")

    class NoDisk(DiffAnnotations):
        def _connect(self):
            raise sqlite3.OperationalError("unable to open database file")

    repo = TRepo(t)
    ann = NoDisk(repo)
    assert ann._readonly
    assert ann.build_all(device=CPU) == 3
    head = repo.structure("HEAD")
    assert ann.get(repo.structure("HEAD^").tree_oid, head.tree_oid) == {"points": 1}
    assert not os.path.exists(os.path.join(t, ".kart", "annotations.db"))


def test_build_all_walks_first_parents_newest_first(pair):
    """Each commit is annotated against its first parent, so the root's
    entry has the empty tree on one side."""
    _, t = pair("synth")
    repo = TRepo(t)
    DiffAnnotations(repo).build_all(device=CPU)
    root = repo.structure("HEAD^")
    counts = DiffAnnotations(repo).get(None, root.tree_oid)
    assert counts == {"synth": 3000}
    rows = _rows(t)
    assert [r[1] for r in rows][-1] == f"...{root.tree_oid}"
    assert np.all(np.diff([r[0] for r in rows]) > 0)


@pytest.mark.parametrize("flt", [None, "some"])
@pytest.mark.parametrize("side", ["added", "deleted"])
@pytest.mark.parametrize("name", ["short", "synth"])
def test_whole_dataset_diff_lists_kart_tpu_s_deltas(sources, name, side, flt):
    """A dataset added or deleted whole (a root commit's diff): the port
    lists it from one vectorized walk, kart_tpu by the tree walk; the same
    keys, in the same order, with the same oids."""
    from kart_tpu.diff.engine import get_feature_diff as jget_feature_diff
    from kart_tpu.diff.key_filters import RepoKeyFilter as JFilter
    from kart_tpu_torch.diff.key_filters import RepoKeyFilter

    path = sources[name]
    jrepo, trepo = JRepo(path), TRepo(path)
    ds_path = "synth" if name == "synth" else "points"
    jds, tds = (r.structure("HEAD").datasets[ds_path] for r in (jrepo, trepo))
    patterns = [f"{ds_path}:{pk}" for pk in (1, 3, 99, (1 << 24) + 7)] if flt else []
    jf = JFilter.build_from_user_patterns(patterns)[ds_path] if flt else None
    tf = RepoKeyFilter.build_from_user_patterns(patterns)[ds_path] if flt else None
    pair = (None, tds) if side == "added" else (tds, None)
    jpair = (None, jds) if side == "added" else (jds, None)
    got = engine.get_feature_diff(*pair, tf)
    want = jget_feature_diff(*jpair, jf)
    assert list(got) == list(want) and len(got) > 0

    def rows(diff):
        return [(d.type, (d.old or d.new)[1].pk_values, (d.old or d.new)[1].oid_hex)
                for d in diff.values()]

    assert rows(got) == rows(want)
