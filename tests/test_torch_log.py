"""``python -m kart_tpu_torch --device cpu -C <repo> log ...`` against
kart_tpu's ``kart log``: the same stdout and exit code, and the same
``Error:`` line where it refuses, for every format (text, ``--oneline``,
``--graph``, json in each style, json-lines) and option (counts, skips,
dates, author, committer and message filters, ``--first-parent``,
``--with-dataset-changes``, ``--with-feature-count``), dataset and feature
filters, a revision as the first argument, a typo'd one, and the empty
repository; on a history of imports, edits, a side branch and a merge
(the tree walk: no sidecars), and on a synthetic layer whose commits have
sidecars (the columnar route). Each package runs on its own copy of a
repository: both read and write ``annotations.db`` and the sidecars. And
``walk_commits`` against kart_tpu's on a history whose commits share one
committer time, where only the tie-break orders them."""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest
from click.testing import CliRunner

from helpers import create_points_gpkg, edit_commit, make_imported_repo
from kart_tpu.cli import cli as kart_cli
from kart_tpu.core.objects import MODE_TREE as J_MODE_TREE
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.core.tree_builder import TreeBuilder as JTreeBuilder
from kart_tpu.synth import synth_repo as jsynth_repo
from kart_tpu_torch.cli import main as port_main
from kart_tpu_torch.core.repo import KartRepo as TRepo

SYNTH_N = 3000


def _history(base):
    """import points -> edit -> import ``second`` -> merge of a side branch
    (off the edit) that edits points -> an edit with a message body.
    -> its path."""
    from kart_tpu.importer import ImportSource
    from kart_tpu.importer.importer import import_sources

    repo, ds_path = make_imported_repo(base, n=10)
    ds = repo.structure("HEAD").datasets[ds_path]
    edit_commit(repo, ds_path, updates=[{**ds.get_feature([1]), "name": "edited-1"}],
                message="edit point 1")
    side_base = repo.head_commit_oid
    import_sources(repo, ImportSource.open(
        create_points_gpkg(str(base / "second.gpkg"), n=3, table="second")))
    repo.refs.set("refs/heads/side", side_base)
    side = edit_commit(repo, ds_path, updates=[{**ds.get_feature([2]), "name": "side-2"}],
                       deletes=[9], message="side edit", ref="refs/heads/side")
    head = repo.head_commit_oid
    side_points = repo.odb.tree(repo.odb.read_commit(side).tree).get(ds_path).oid
    tb = JTreeBuilder(repo.odb, repo.odb.read_commit(head).tree)
    tb.insert(ds_path, side_points, mode=J_MODE_TREE)
    repo.create_commit("HEAD", tb.flush(), "Merge branch 'side'", [head, side])
    ds = repo.structure("HEAD").datasets[ds_path]
    edit_commit(repo, ds_path, updates=[{**ds.get_feature([3]), "rating": 7.5}],
                inserts=[{"fid": 40, "geom": None, "name": "forty", "rating": None}],
                message="top edit\n\nwith a body line")
    return str(repo.workdir)


def _synth(base):
    """kart_tpu's synthetic layer: two commits, both with sidecars.
    -> (path, an edited pk)."""
    path = str(base / "synth")
    jsynth_repo(path, SYNTH_N, blobs="changed", seed=3)
    edit_rows = np.random.default_rng(4).choice(SYNTH_N, SYNTH_N // 100, replace=False)
    return path, (1 << 24) + int(edit_rows[0])


@pytest.fixture(scope="module")
def repos(tmp_path_factory):
    """{name: (kart_tpu's copy, the port's copy)}: each package its own."""
    base = tmp_path_factory.mktemp("log")
    (base / "h").mkdir()
    history = _history(base / "h")
    synth, pk = _synth(base)
    (base / "e").mkdir()
    empty = str(base / "e" / "repo")
    JRepo.init_repository(empty)
    out = {"pk": pk}
    for name, path in (("history", history), ("synth", synth), ("empty", empty)):
        out[name] = (path, shutil.copytree(path, f"{path}-port"))
    return out


def _port(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_main(argv)
    return rc, out.getvalue(), err.getvalue()


def _compare(paths, argv):
    ref = CliRunner().invoke(kart_cli, ["-C", paths[0], "log", *argv], prog_name="kart")
    assert ref.exception is None or isinstance(ref.exception, SystemExit), ref.exception
    rc, out, err = _port(["--device", "cpu", "-C", paths[1], "log", *argv])
    assert (rc, out) == (ref.exit_code, ref.stdout)
    assert err.splitlines()[-1:] == ref.stderr.splitlines()[-1:]
    return rc, out


FORMATS = [
    [], ["--oneline"], ["--graph"], ["-o", "json"], ["-o", "json", "--json-style", "compact"],
    ["-o", "json", "--json-style", "extracompact"], ["-o", "json-lines"],
]

OPTIONS = [
    [], ["-n", "1"], ["-n", "0"], ["--max-count", "3"], ["--skip", "1", "-n", "2"],
    ["--skip", "9"], ["--first-parent"], ["--with-dataset-changes"],
    ["--with-dataset-changes", "--first-parent"], ["--since", "2000-01-01"],
    ["--until", "2000-01-01"], ["--after", "1 day ago"], ["--before", "@0"],
    ["--since", "2000-01-01T00:00:00+05:30"], ["--author", "Tester"], ["--author", "Nobody"],
    ["--author", "Nobody", "--author", "Test"], ["--committer", "t@example"],
    ["--committer", "^Nobody"], ["--grep", "edit"], ["--grep", "side", "--grep", "top"],
    ["--grep", "^Merge"], ["--grep", "body line"], ["--grep", "top|mport", "--skip", "1"],
]

#: dataset and feature filters, and revisions as the first argument
POSITIONAL = [
    ["second"], ["points"], ["points:feature:1"], ["points:feature:9"], ["points:feature:40"],
    ["second", "points:feature:2"], ["HEAD", "second"], ["HEAD^"], ["HEAD^", "points"],
    ["side"], ["side", "points:feature:2"], ["refs/heads/side"], ["HEAD~3"],
]

ERRORS = [
    ["mybrnch"], ["nosuch:feature:1"], ["HEAD~99"], ["--since", "not-a-date"],
    ["--until", "2024-13-45"], ["--since", "soon"],
]


@pytest.mark.parametrize("opts", OPTIONS, ids=" ".join)
@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: " ".join(f) or "text")
def test_log_matches_kart_tpu(repos, fmt, opts):
    _compare(repos["history"], [*fmt, *opts])


@pytest.mark.parametrize("args", POSITIONAL, ids=" ".join)
@pytest.mark.parametrize("fmt", [[], ["--oneline", "--with-dataset-changes"], ["--graph"],
                                 ["-o", "json", "--with-dataset-changes"]],
                         ids=lambda f: " ".join(f) or "text")
def test_log_filters_and_revisions_match_kart_tpu(repos, fmt, args):
    rc, out = _compare(repos["history"], [*fmt, *args])
    assert rc == 0 and out.strip()


@pytest.mark.parametrize("args", ERRORS, ids=" ".join)
def test_log_refusals_match_kart_tpu(repos, args):
    rc, out = _compare(repos["history"], args)
    assert rc == 2 and out == ""


@pytest.mark.parametrize("accuracy", ["veryfast", "fast", "medium", "good", "exact"])
@pytest.mark.parametrize("extra", [[], ["points"], ["-n", "2"], ["--first-parent"]],
                         ids=lambda e: " ".join(e) or "all")
@pytest.mark.parametrize("fmt", ["json", "json-lines"])
def test_log_feature_count_matches_kart_tpu(repos, tmp_path, fmt, extra, accuracy):
    """--with-feature-count on fresh copies (nothing cached), then again on
    the same copies (each answered from its own cache)."""
    j, t = (shutil.copytree(p, tmp_path / name) for p, name in zip(repos["history"], "jt"))
    argv = ["-o", fmt, "--with-feature-count", accuracy, *extra]
    for _ in range(2):
        rc, out = _compare((str(j), str(t)), argv)
        assert rc == 0 and "featureChanges" in out


def test_log_reads_the_cache_kart_tpu_wrote(repos, tmp_path):
    """The port answers from the annotations kart_tpu cached, and the
    reverse: one copy, each package after the other."""
    path = str(shutil.copytree(repos["history"][0], tmp_path / "one"))
    for argv in (["-o", "json", "--with-feature-count", "exact"],
                 ["-o", "json-lines", "--with-feature-count", "fast"]):
        _compare((path, path), argv)
        assert os.path.exists(os.path.join(path, ".kart", "annotations.db"))


SYNTH_CASES = [
    ["-o", "json", "--with-dataset-changes"], ["--oneline", "--with-dataset-changes"],
    ["-o", "json-lines", "--with-feature-count", "veryfast"],
    ["-o", "json", "--with-feature-count", "exact"], ["--oneline", "synth:feature:{pk}"],
    ["--oneline", "synth:feature:{pk}", "-n", "1"], ["--graph", "synth"],
    ["-o", "json", "--with-dataset-changes", "synth:feature:{pk}"],
    ["--oneline", "synth:feature:1"],
]


@pytest.mark.parametrize("argv", SYNTH_CASES, ids=" ".join)
def test_log_columnar_route_matches_kart_tpu(repos, argv):
    """Both commits of the synthetic layer have sidecars: the diffs take
    the columnar classify."""
    rc, out = _compare(repos["synth"], [a.format(pk=repos["pk"]) for a in argv])
    assert rc == 0 and bool(out.strip()) == (argv[-1] != "synth:feature:1")  # pk 1: no such row


@pytest.mark.parametrize("argv", [[], ["-o", "json"], ["-o", "json-lines"], ["--graph"],
                                  ["HEAD"], ["points"], ["main"]], ids=" ".join)
def test_log_empty_repo_matches_kart_tpu(repos, argv):
    _compare(repos["empty"], argv)


@pytest.fixture
def same_second(monkeypatch):
    for role in ("AUTHOR", "COMMITTER"):
        monkeypatch.setenv(f"GIT_{role}_DATE", "1700000000 +0000")


def _tied_history(path):
    """Commits that all share one committer time: a chain, two branches
    off it merged back, one of them merged twice, and an octopus merge.
    -> (kart_tpu repo, tips)."""
    repo = JRepo.init_repository(path)
    repo.config.set_many({"user.name": "Tester", "user.email": "t@example.com"})
    tree = repo.odb.write_raw("tree", b"")
    c = [repo.create_commit("HEAD", tree, "root", [])]
    for i in range(3):
        c.append(repo.create_commit("HEAD", tree, f"main {i}", [c[-1]]))
    a = [repo.create_commit(None, tree, "a0", [c[1]])]
    a.append(repo.create_commit(None, tree, "a1", [a[-1]]))
    b = [repo.create_commit(None, tree, "b0", [c[2]])]
    m1 = repo.create_commit("HEAD", tree, "merge a", [c[-1], a[-1]])
    m2 = repo.create_commit("HEAD", tree, "merge b", [m1, b[0]])
    m3 = repo.create_commit("HEAD", tree, "octopus", [m2, a[0], b[0], c[0]])
    return repo, [m3, m2, b[0], a[-1], c[2]]


def test_walk_commits_matches_kart_tpu_on_equal_times(tmp_path, same_second):
    jrepo, tips = _tied_history(tmp_path / "tied")
    trepo = TRepo(str(tmp_path / "tied"))
    times = {c.committer.time for _, c in jrepo.walk_commits(tips[0])}
    assert times == {1700000000}
    for tip in tips:
        for first_parent in (False, True):
            want = [o for o, _ in jrepo.walk_commits(tip, first_parent=first_parent)]
            got = [o for o, _ in trepo.walk_commits(tip, first_parent=first_parent)]
            assert got == want and len(set(got)) == len(got)
    assert [o for o, _ in trepo.walk_commits(tips[0])] != sorted(
        o for o, _ in trepo.walk_commits(tips[0]))


def test_walk_commits_shallow_boundary_and_missing_tip(tmp_path, same_second):
    from kart_tpu.core.odb import ObjectMissing as JMissing
    from kart_tpu_torch.core.odb import ObjectMissing

    jrepo, tips = _tied_history(tmp_path / "tied")
    commit = jrepo.odb.read_commit(tips[-1])
    loose = jrepo.odb._path(commit.parents[0])
    os.remove(loose)  # the parent is gone: a shallow boundary
    trepo = TRepo(str(tmp_path / "tied"))
    want = [o for o, _ in jrepo.walk_commits(tips[-1])]
    assert [o for o, _ in trepo.walk_commits(tips[-1])] == want == [tips[-1]]
    with pytest.raises(JMissing):
        list(jrepo.walk_commits("0" * 40))
    with pytest.raises(ObjectMissing):
        list(trepo.walk_commits("0" * 40))
    assert TRepo(str(tmp_path / "tied")).head_is_unborn is jrepo.head_is_unborn is False
