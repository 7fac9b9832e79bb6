"""The port's synthetic-repo builder against kart_tpu's: the same commits
and byte-identical sidecars from the same seed, and each repository
readable by the other package."""

import os

import pytest

from kart_tpu import synth as jsynth
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu_torch import synth as tsynth
from kart_tpu_torch.core.repo import KartRepo as TRepo

N = 5000
DATE = "1700000000 +0000"


@pytest.mark.parametrize("blobs", ["real", "changed", "promised"])
def test_same_commits_and_sidecars(tmp_path, monkeypatch, blobs):
    monkeypatch.setenv("GIT_AUTHOR_DATE", DATE)
    monkeypatch.setenv("GIT_COMMITTER_DATE", DATE)
    _, tinfo = tsynth.synth_repo(str(tmp_path / "port"), N, seed=3, blobs=blobs)
    _, jinfo = jsynth.synth_repo(str(tmp_path / "ref"), N, seed=3, blobs=blobs)
    assert tinfo == jinfo and tinfo["n_edits"] == N // 100
    tdir, jdir = (str(tmp_path / p / ".kart" / "columnar") for p in ("port", "ref"))
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names and len(names) == 2
    for name in names:
        with open(os.path.join(tdir, name), "rb") as a, open(os.path.join(jdir, name), "rb") as b:
            assert a.read() == b.read(), name
    # each package reads the other's repository: every commit, tree and
    # present blob of the port's repo reads alike through kart_tpu
    jrepo, tport = JRepo(str(tmp_path / "port")), TRepo(str(tmp_path / "port"))
    for oid in jrepo.odb.iter_oids():
        assert jrepo.odb.read_raw(oid) == tport.odb.read_raw(oid)
    trepo = TRepo(str(tmp_path / "ref"))
    assert trepo.resolve_refish("HEAD")[0] == jinfo["edit_commit"]
    assert trepo.resolve_refish("HEAD^")[0] == jinfo["base_commit"]
