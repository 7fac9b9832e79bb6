"""The port's synthetic-repo builder against kart_tpu's: the same commits
and byte-identical sidecars from the same seed, and each repository
readable by the other package; its text-pk layer (which kart_tpu's builder
lacks) against kart_tpu's tree builder, sidecar builder and diff."""

import contextlib
import io
import os

import pytest
from click.testing import CliRunner

from kart_tpu import synth as jsynth
from kart_tpu.cli import cli as kart_cli
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.core.tree_builder import TreeBuilder as JTreeBuilder
from kart_tpu.diff import sidecar as jsidecar
from kart_tpu_torch import synth as tsynth
from kart_tpu_torch.cli import main as port_main
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


def _kart_tpu_tree(jrepo, ds, ids, oids_hex):
    """The feature tree kart_tpu's own tree builder writes for ``ids`` with
    the blob oids ``oids_hex``, path by path."""
    tb = JTreeBuilder(jrepo.odb)
    for code, oid in zip(ids, oids_hex):
        tb.insert(ds.path_encoder.encode_pks_to_path((code,)), oid)
    return tb.flush()


@pytest.mark.parametrize("blobs", ["real", "changed", "promised"])
def test_text_pk_repo_reads_as_kart_tpu_writes(tmp_path, monkeypatch, blobs):
    """``synth_repo(pk="text")``: G-NAF-shaped ids under the hashed path
    encoder; its feature trees are the ones kart_tpu's tree builder writes
    path by path, its sidecars the ones kart_tpu builds from those trees,
    and both packages diff it alike."""
    monkeypatch.setenv("GIT_AUTHOR_DATE", DATE)
    monkeypatch.setenv("GIT_COMMITTER_DATE", DATE)
    path = str(tmp_path / "text")
    _, info = tsynth.synth_repo(path, 3000, seed=4, blobs=blobs, pk="text")
    ids = tsynth.gnaf_ids(range(3000))
    assert {len(c) for c in ids} == {14, 15} and len(set(ids)) == 3000
    jrepo = JRepo(path)
    for rev in ("HEAD^", "HEAD"):
        ds = jrepo.structure(rev).datasets["synth"]
        assert ds.path_encoder.scheme == "msgpack/hash"
        paths, pk_arr, oids = ds.feature_index()
        assert pk_arr is None and len(paths) == 3000
        by_code = {ds.decode_path_to_pks(p)[0]: bytes(o).hex() for p, o in zip(paths, oids)}
        assert _kart_tpu_tree(jrepo, ds, ids, [by_code[c] for c in ids]) == ds.feature_tree.oid
        side = jsidecar.sidecar_file(jrepo, ds.feature_tree.oid)
        with open(side, "rb") as f:
            port_bytes = f.read()
        os.remove(side)
        jsidecar.build_sidecar(jrepo, ds)
        with open(side, "rb") as f:
            assert f.read() == port_bytes
    if blobs != "promised":
        ref = CliRunner().invoke(kart_cli, ["-C", path, "diff", "-o", "json-lines", "HEAD^...HEAD"])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = port_main(["--device", "cpu", "-C", path, "diff", "-o", "json-lines",
                            "HEAD^...HEAD"])
        assert (rc, out.getvalue()) == (ref.exit_code, ref.stdout)
        assert out.getvalue().count('"type":"feature"') == info["n_edits"] == 30

