"""The store's upkeep in the port's CLI against kart_tpu's: ``fsck`` (a
clean store, a corrupt loose object, one whose content is not its id, a
ref to a missing object, a wrong sidecar, stale leftovers), ``gc``
(``--auto``, ``--grace=N``, ``KART_GC_GRACE``, ``--prune-now``, nothing to
do), the ``git`` passthrough and ``--version``: the same stdout, stderr,
exit code and store afterwards. Each package works on its own repository,
made by its own ``init --import`` with the dates pinned."""

import os
import time
import zlib

import numpy as np
import pytest

import kart_tpu.importer.importer as jimporter
import kart_tpu_torch.importer.importer as timporter
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.diff import sidecar as tsidecar

from helpers import create_points_gpkg
from test_torch_workingcopy import Pair, kart, port

OLD = 7200  # seconds: older than the default grace of an hour


@pytest.fixture
def pair(tmp_path, monkeypatch):
    monkeypatch.setenv("GIT_AUTHOR_DATE", "1700000000 +0000")
    monkeypatch.setenv("GIT_COMMITTER_DATE", "1700000000 +0000")
    monkeypatch.setattr(jimporter, "SIDECAR_MIN_FEATURES", 0)
    monkeypatch.setattr(timporter, "SIDECAR_MIN_FEATURES", 0)
    monkeypatch.delenv("KART_GC_GRACE", raising=False)
    gpkg = create_points_gpkg(str(tmp_path / "pts.gpkg"), n=120)
    return Pair(tmp_path, [gpkg])


def _both(pair, argv):
    got = (kart(["-C", pair.k, *argv]), port(["-C", pair.p, *argv]))
    return got[0], got[1]


def _store(path):
    """The files under the gitdir's objects/ and refs/ (packs by number:
    their names hash their compressed bytes, which may differ between the
    packages, as kart_tpu's own routes' do), and every object id stored."""
    gitdir = os.path.join(path, ".kart")
    files, packs = [], 0
    for root in ("objects", "refs"):
        for dirpath, _, names in os.walk(os.path.join(gitdir, root)):
            for f in names:
                if f.startswith("pack-"):
                    packs += 1
                else:
                    files.append(os.path.relpath(os.path.join(dirpath, f), gitdir))
    return sorted(files), packs, sorted(TRepo(path).odb.iter_oids())


def _leftover(repo_dir, rel, age):
    path = os.path.join(repo_dir, ".kart", rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("debris")
    t = time.time() - age
    os.utime(path, (t, t))


def test_fsck_of_a_clean_store(pair):
    k, p = _both(pair, ["fsck"])
    assert p == k and p[0] == 0 and p[1].endswith("No errors found.\n")
    assert "sidecar OK (120 rows)" in p[1] and "Checking working copy..." in p[1]


@pytest.mark.parametrize("how", ["garbage", "wrong_content"])
def test_fsck_reports_a_bad_loose_object(pair, how):
    for path, repo_cls in ((pair.k, JRepo), (pair.p, TRepo)):
        oid = repo_cls(path).odb.write_raw("blob", b"a loose blob\n")
        loose = os.path.join(path, ".kart", "objects", oid[:2], oid[2:])
        os.chmod(loose, 0o644)
        with open(loose, "wb") as f:
            f.write(b"not zlib at all" if how == "garbage"
                    else zlib.compress(b"blob 5\x00other"))
    k, p = _both(pair, ["fsck"])
    assert p == k and p[0] == 1
    assert ("is corrupt" if how == "garbage" else "does not match its id") in p[2]


def test_fsck_reports_a_ref_to_a_missing_object(pair):
    for path in (pair.k, pair.p):
        with open(os.path.join(path, ".kart", "refs", "heads", "ghost"), "w") as f:
            f.write("1" * 40 + "\n")
    k, p = _both(pair, ["fsck"])
    assert p == k and p[0] == 1
    assert p[2] == f"error: Ref refs/heads/ghost points at missing object {'1' * 40}\n"


def test_fsck_reports_a_wrong_sidecar(pair):
    for path in (pair.k, pair.p):
        repo = TRepo(path)
        (ds,) = list(repo.datasets())
        block = tsidecar.load_block(repo, ds)
        oids = np.asarray(block.oids[: block.count]).view(np.uint8).reshape(-1, 20).copy()
        oids[7, 3] ^= 0xFF
        tsidecar.save_sidecar(repo, ds.feature_tree.oid, np.asarray(block.keys[: block.count]),
                              oids)
    k, p = _both(pair, ["fsck"])
    assert p == k and p[0] == 1
    assert "columnar sidecar does not match the feature tree" in p[2]


def test_fsck_reports_stale_leftovers(pair):
    for path in (pair.k, pair.p):
        for i in range(6):
            _leftover(path, f"objects/pack/.tmp-pack-{i}", OLD)
        _leftover(path, "refs/heads/main.lock123", OLD)
        _leftover(path, "objects/pack/.tmp-pack-young", 5)  # inside the grace period
    k, p = _both(pair, ["fsck"])
    assert p == k and p[0] == 0
    assert "7 stale lock/temp leftover(s)" in p[1] and "... and 2 more" in p[1]


@pytest.mark.parametrize("argv,env,ages", [
    (["gc"], None, {}),  # packs the loose commit
    (["gc", "--auto"], None, {"objects/pack/.tmp-pack-a": OLD}),
    (["gc", "--auto"], None, {}),  # nothing to do
    (["gc", "--grace=1000"], None, {"objects/pack/.tmp-pack-a": 100,
                                    "objects/pack/.tmp-pack-b": 5000}),
    (["gc", "--grace=10"], None, {"objects/pack/.tmp-pack-a": 100}),
    (["gc"], "50", {"objects/pack/.tmp-pack-a": 100, "config.lock77": 10}),
    (["gc", "--prune-now"], None, {"objects/pack/.tmp-pack-a": 1, "refs/heads/x.lock9": 1}),
], ids=["packs", "auto-sweeps", "auto-nothing", "grace-keeps-young", "grace", "env-grace",
        "prune-now"])
def test_gc(pair, monkeypatch, argv, env, ages):
    if env is not None:
        monkeypatch.setenv("KART_GC_GRACE", env)
    for path in (pair.k, pair.p):
        for rel, age in ages.items():
            _leftover(path, rel, age)
    k, p = _both(pair, argv)
    assert p == k and p[0] == 0
    assert _store(pair.p) == _store(pair.k)
    assert os.listdir(os.path.join(pair.p, ".kart")) == os.listdir(os.path.join(pair.k, ".kart"))
    k, p = _both(pair, ["gc", "--auto"])
    assert p == k
    k, p = _both(pair, ["fsck"])
    assert p == k and p[0] == 0


def test_gc_then_gc_has_nothing_to_do(pair):
    _both(pair, ["gc"])
    k, p = _both(pair, ["gc"])
    assert p == k == (0, "Nothing to do.\n", "")


@pytest.mark.parametrize("argv", [["rev-parse", "HEAD"], ["cat-file", "-t", "HEAD"],
                                  ["rev-parse", "--verify", "nosuch"],
                                  ["log", "--format=%s", "-n", "1"]])
def test_git_passthrough(pair, capfd, argv):
    got = []
    for runner, path in ((kart, pair.k), (port, pair.p)):
        capfd.readouterr()
        rc, out, err = runner(["-C", path, "git", *argv])
        fd = capfd.readouterr()
        got.append((rc, out + fd.out, err + fd.err))
    assert got[1] == got[0]


def test_git_passthrough_without_git(pair, monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    k, p = _both(pair, ["git", "status"])
    assert p == k == (2, "", "Error: git is not installed on this system\n")


@pytest.mark.parametrize("argv", [["--version"], ["-C", ".", "--version", "diff"],
                                  ["--version", "nosuch-command"]])
def test_version(argv):
    k, p = kart(argv), port(argv)
    assert p[0] == k[0] == 0 and p[2] == k[2] == ""
    assert p[1] == k[1].replace("(kart_tpu)", "(kart_tpu_torch)")
    assert p[1].startswith("kart (kart_tpu_torch), version ")


@pytest.mark.parametrize("ref", ["refs/heads/main", "refs/heads/main/x", "refs/heads",
                                 "refs/heads/new", "refs/tags/v1", "refs/tags/v1/a/b",
                                 "refs/tags/p", "refs/tags/p/q"])
def test_df_conflict(pair, ref):
    """A ref colliding with an existing one at a directory/file boundary,
    loose or packed."""
    for path in (pair.k, pair.p):
        with open(os.path.join(path, ".kart", "packed-refs"), "w") as f:
            f.write("# pack-refs with: peeled\n" + "1" * 40 + " refs/tags/p\n")
        os.makedirs(os.path.join(path, ".kart", "refs", "tags", "v1"), exist_ok=True)
        with open(os.path.join(path, ".kart", "refs", "tags", "v1", "a"), "w") as f:
            f.write("2" * 40 + "\n")
    assert TRepo(pair.p).refs.df_conflict(ref) == JRepo(pair.k).refs.df_conflict(ref)


def test_alternates_and_iter_oids(pair, tmp_path):
    """Objects borrowed through ``objects/info/alternates`` read as the
    store's own, loose or packed; ``iter_oids`` lists the store's own
    only."""
    got = []
    for path, repo_cls in ((pair.k, JRepo), (pair.p, TRepo)):
        other = repo_cls.init_repository(os.path.join(os.path.dirname(path), "other"))
        loose = other.odb.write_raw("blob", b"borrowed\n")
        with other.odb.bulk_pack():
            packed = other.odb.write_raw("blob", b"borrowed and packed\n")
        repo = repo_cls(path)
        own = sorted(repo.odb.iter_oids())
        assert not repo.odb.contains(loose)
        repo.odb.add_alternate(os.path.join(other.gitdir, "objects"))
        repo = repo_cls(path)
        got.append((repo.odb.alternates == [os.path.join(other.gitdir, "objects")],
                    repo.odb.read_raw(loose), repo.odb.read_raw(packed),
                    repo.odb.contains(packed), sorted(repo.odb.iter_oids()) == own, own))
    assert got[1][:5] == got[0][:5] == (True, ("blob", b"borrowed\n"),
                                        ("blob", b"borrowed and packed\n"), True, True)
    assert set(got[1][5]) == set(got[0][5])
