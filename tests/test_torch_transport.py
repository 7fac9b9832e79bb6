"""The port's local transport against kart_tpu's, on the CPU: the kartpack
stream, the want/have walk, ``clone`` (full, shallow, spatially filtered),
``fetch``, ``push``, ``pull``, ``remote``, the promised-blob backfill of a
filtered clone's diff, ``checkout --spatial-filter``, ``tag``, ``config``
and ``reflog``.

Each case runs in both packages, each on its own directories (``k`` for
kart_tpu's, ``p`` for the port's) with the dates pinned: kart_tpu through
its click CLI or ``kart_tpu.transport``, the port through
``kart_tpu_torch.cli.main --device cpu``. The results must agree: exit
codes, stdout and stderr (each side's directory masked), every ref and
symref, the set of objects, the ``shallow`` file, the config and the
working copy's rows."""

import contextlib
import io
import os
import shutil
import sqlite3

import pytest
from click.testing import CliRunner

from helpers import create_points_gpkg, edit_commit, make_imported_repo, wc_connect
from kart_tpu import transport as jtransport
from kart_tpu.cli import cli as kart_cli
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.core.repo import NotFound as JNotFound
from kart_tpu.core.repo import RepoError as JRepoError
from kart_tpu.spatial_filter import ResolvedSpatialFilterSpec as JSpec
from kart_tpu.spatial_filter import blob_filter_for_spec as jblob_filter
from kart_tpu.spatial_filter.index import update_spatial_filter_index as jindex
from kart_tpu.transport.pack import PackFormatError as JPackFormatError
from kart_tpu.transport.pack import read_pack as jread_pack
from kart_tpu.transport.pack import write_pack as jwrite_pack
from kart_tpu.transport.protocol import ObjectEnumerator as JEnumerator
from kart_tpu_torch import transport as ttransport
from kart_tpu_torch.cli import main as port_main
from kart_tpu_torch.core.odb import ObjectPromised
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.spatial_filter import blob_filter_for_spec as tblob_filter
from kart_tpu_torch.transport.pack import PackFormatError, read_pack, write_pack
from kart_tpu_torch.transport.protocol import ObjectEnumerator
from kart_tpu_torch.workingcopy.gpkg import _register_gpkg_functions

DATE = "1700000000 +0000"
#: the imported points sit at (100 + fid, -40 - fid / 10): fids 1..5 inside
RECT = "EPSG:4326;POLYGON((100 -42, 105.5 -42, 105.5 -39, 100 -39, 100 -42))"
WSEN = "100,-42,105.5,-39"
CLONER = {"user.name": "Cloner", "user.email": "c@example.com"}


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
    if isinstance(exc, JRepoError):
        return (40 if isinstance(exc, JNotFound) else 20), r.stdout, r.stderr + f"Error: {exc}\n"
    raise exc


def port(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_main(["--device", "cpu", *argv])
    return rc, out.getvalue(), err.getvalue()


def objects(path):
    """Every oid in a repository's store, loose and packed (read by
    kart_tpu for both packages' repositories)."""
    return set(JRepo(path).odb.iter_oids())


def state(path, root):
    """What a transfer leaves in a repository: refs (symrefs as their
    target), HEAD, objects, the shallow file and the config (``root``
    masked)."""
    repo = JRepo(path)
    refs = {}
    for dirpath, _, files in os.walk(os.path.join(repo.gitdir, "refs")):
        for fn in files:
            full = os.path.join(dirpath, fn)
            with open(full) as f:
                refs[os.path.relpath(full, repo.gitdir)] = f.read()
    with open(os.path.join(repo.gitdir, "config")) as f:
        config = f.read().replace(str(root), "<root>")
    return {"refs": refs, "head": repo.refs.head_target(), "objects": objects(path),
            "shallow": repo.read_gitdir_file("shallow"), "config": config}


def wc_rows(path):
    """{table: sorted rows} of a GPKG working copy (``last_change`` masked)."""
    con = sqlite3.connect(path)
    try:
        out = {}
        for (name,) in con.execute("SELECT name FROM sqlite_master WHERE type = 'table'"):
            cur = con.execute(f'SELECT * FROM "{name}"')
            cols = [d[0] for d in cur.description]
            out[name] = sorted((tuple("<now>" if c == "last_change" else v
                                      for c, v in zip(cols, row)) for row in cur), key=repr)
        return out
    finally:
        con.close()


class Twin:
    """The same source repository made for each package (kart_tpu's
    ``make_imported_repo`` of ``n`` points and a second commit renaming fid
    1 with a NULL geometry, as kart_tpu's ``tests/test_transport.py`` builds
    it once, copied to ``<tmp>/k/repo`` and ``<tmp>/p/repo``; the column ids
    of an import follow its source's path)."""

    def __init__(self, tmp_path, n=10):
        self.root = {"k": tmp_path / "k", "p": tmp_path / "p"}
        (tmp_path / "src").mkdir()
        repo, _ = make_imported_repo(tmp_path / "src", n=n)
        edit_commit(repo, "points", message="second commit",
                    updates=[{"fid": 1, "geom": None, "name": "renamed", "rating": 9.0}])
        for root in self.root.values():
            shutil.copytree(repo.workdir, root / "repo")

    def path(self, side, name="repo"):
        return str(self.root[side] / name)

    def repo(self, side, name="repo"):
        return JRepo(self.path(side, name))

    def run(self, argv, code=0):
        """``argv(side)`` through each package's CLI: equal code, stdout and
        stderr (the side's root masked). -> the port's result."""
        got = {}
        for side, runner in (("k", kart), ("p", port)):
            rc, out, err = runner(argv(side))
            root = str(self.root[side])
            got[side] = (rc, out.replace(root, "<root>"), err.replace(root, "<root>"))
        assert got["p"] == got["k"], (argv("p"), got)
        if code is not None:
            assert got["p"][0] == code, got["p"]
        return got["p"]

    def same(self, name, wc=None):
        """Equal repository state at ``<root>/<name>`` (and working copy rows)."""
        k, p = (state(self.path(s, name), self.root[s]) for s in ("k", "p"))
        assert p == k
        if wc is not None:
            assert wc_rows(os.path.join(self.path("p", name), wc)) == wc_rows(
                os.path.join(self.path("k", name), wc))
        return p

    def both(self, fn):
        """``fn(side, repo)`` on each side's source repository."""
        return [fn(s, self.repo(s)) for s in ("k", "p")]


@pytest.fixture()
def twin(tmp_path):
    return Twin(tmp_path)


def clone_argv(twin, name, *opts):
    return lambda s: ["clone", *opts, twin.path(s), twin.path(s, name)]


def at(twin, name, *argv):
    return lambda s: ["-C", twin.path(s, name), *argv]


# --- the kartpack stream -------------------------------------------------------

PACK_CASES = {
    "small": [("blob", b"hello"), ("commit", b"tree abc\n\nmsg\n"), ("tree", b""),
              ("tag", b"object x\ntype commit\ntag t\n\nm\n")],
    "empty": [],
    "large": [("blob", bytes(range(256)) * 4096), ("blob", b"\x00" * 100_000)],
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_bytes_equal_and_read_across(case):
    objs = PACK_CASES[case]
    k, p = io.BytesIO(), io.BytesIO()
    assert jwrite_pack(k, iter(objs)) == write_pack(p, iter(objs)) == len(objs)
    assert p.getvalue() == k.getvalue()
    assert list(read_pack(io.BytesIO(k.getvalue()))) == objs
    assert list(jread_pack(io.BytesIO(p.getvalue()))) == objs


def test_pack_of_a_repository_equal(twin):
    """The kartpack bytes of a whole history, enumerated by each package."""
    src = twin.path("k")
    k, p = io.BytesIO(), io.BytesIO()
    wants = [JRepo(src).head_commit_oid]
    jwrite_pack(k, iter(JEnumerator(JRepo(src).odb, wants)))
    write_pack(p, iter(ObjectEnumerator(TRepo(src).odb, wants)))
    assert p.getvalue() == k.getvalue() and len(p.getvalue()) > 1000


@pytest.mark.parametrize("where", ["magic", "middle", "trailer", "truncated"])
def test_pack_corruption_refused_by_both(where):
    buf = io.BytesIO()
    write_pack(buf, [("blob", b"data" * 50), ("commit", b"tree x\n\nm\n")])
    raw = bytearray(buf.getvalue())
    if where == "truncated":
        raw = raw[:-40]
    else:
        raw[{"magic": 0, "middle": len(raw) // 2, "trailer": len(raw) - 1}[where]] ^= 0xFF
    for reader, error in ((read_pack, PackFormatError), (jread_pack, JPackFormatError)):
        with pytest.raises(error):
            list(reader(io.BytesIO(bytes(raw))))
    with pytest.raises(PackFormatError):
        write_pack(io.BytesIO(), [("nonsense", b"")])


# --- the want/have walk -----------------------------------------------------------

def _sequence(enum_cls, odb, wants, **kw):
    """The (type, oid) sequence an enumerator yields, and its counts."""
    from kart_tpu_torch.core.objects import hash_object

    enum = enum_cls(odb, wants, **kw)
    seq = [(t, hash_object(t, c)) for t, c in enum]
    return seq, (enum.object_count, enum.omitted_blob_count, enum.commit_count,
                 sorted(enum.shallow_boundary))


@pytest.mark.parametrize("walk", ["full", "depth1", "filtered", "filtered_indexed", "has_parent",
                                  "tag", "exclude"])
def test_enumerator_sequence_equal(twin, walk):
    src = twin.path("k")
    jrepo, trepo = JRepo(src), TRepo(src)
    tip = jrepo.head_commit_oid
    parent = jrepo.odb.read_commit(tip).parents[0]
    wants, jkw, tkw = [tip], {}, {}
    if walk == "depth1":
        jkw = tkw = {"depth": 1}
    elif walk.startswith("filtered"):
        if walk == "filtered_indexed":
            jindex(jrepo)
        jkw = {"blob_filter": jblob_filter(jrepo, WSEN)}
        tkw = {"blob_filter": tblob_filter(trepo, WSEN, device="cpu")}
    elif walk == "has_parent":
        jkw = tkw = {"has": {parent}.__contains__}
    elif walk == "tag":
        jrepo.create_tag("v1", parent, message="first")
        wants = [jrepo.refs.get("refs/tags/v1"), tip]
    elif walk == "exclude":
        tree = jrepo.odb.read_commit(tip).tree
        jkw = tkw = {"exclude": {tip, tree}}
    got = _sequence(ObjectEnumerator, trepo.odb, wants, **tkw)
    want = _sequence(JEnumerator, jrepo.odb, wants, **jkw)
    assert got == want and got[0]
    if walk.startswith("filtered"):
        assert got[1][1] == 10  # fids 6..10's blobs, vetoed once in each commit


# --- clone, fetch, push: kart_tpu's tests/test_transport.py -------------------------

def test_clone_full(twin):
    out = twin.run(clone_argv(twin, "clone", "--no-checkout"))
    assert out[1] == "Cloned into <root>/clone\n"
    st = twin.same("clone")
    assert st["objects"] == objects(twin.path("p"))
    assert TRepo(twin.path("p", "clone")).config.get("branch.main.remote") == "origin"
    twin.run(at(twin, "clone", "log", "-o", "json"))


def test_clone_with_working_copy(twin):
    twin.run(clone_argv(twin, "clone"))
    twin.same("clone", wc="clone.gpkg")
    twin.run(at(twin, "clone", "status"))


@pytest.mark.parametrize("opts", [("--bare",), ("-b", "topic", "--no-checkout"),
                                  ("--workingcopy-location", "here.gpkg")])
def test_clone_options(twin, opts):
    twin.both(lambda s, r: r.refs.set("refs/heads/topic", r.head_commit_oid))
    twin.run(clone_argv(twin, "clone", *opts))
    twin.same("clone", wc="here.gpkg" if "here.gpkg" in opts else None)


def test_fetch_updates_remote_refs(twin):
    twin.run(clone_argv(twin, "clone", "--no-checkout"))
    twin.run(at(twin, "clone", "fetch"))  # Already up to date.
    twin.both(lambda s, r: edit_commit(r, "points", deletes=[2], message="delete feature 2"))
    out = twin.run(at(twin, "clone", "fetch"))
    assert "refs/remotes/origin/main" in out[1]
    st = twin.same("clone")
    assert st["refs"]["refs/heads/main"] != st["refs"]["refs/remotes/origin/main"]


def test_push_fast_forward(twin):
    twin.run(clone_argv(twin, "clone", "--no-checkout"))
    for s in ("k", "p"):
        clone = twin.repo(s, "clone")
        clone.config.set_many(CLONER)
        edit_commit(clone, "points", deletes=[3], message="delete feature 3")
    twin.run(at(twin, "clone", "push"))
    twin.same("repo")
    twin.same("clone")


def test_push_non_ff_rejected_then_forced(twin):
    twin.run(clone_argv(twin, "clone", "--no-checkout"))
    for s in ("k", "p"):
        edit_commit(twin.repo(s), "points", deletes=[4], message="upstream change")
        clone = twin.repo(s, "clone")
        clone.config.set_many(CLONER)
        edit_commit(clone, "points", deletes=[5], message="local change")
    _, _, err = twin.run(at(twin, "clone", "push"), code=2)
    assert err == ("Error: Push to refs/heads/main rejected (non-fast-forward); fetch first "
                   "or use --force\n")
    twin.run(at(twin, "clone", "push", "--force"))
    twin.same("repo")


@pytest.mark.parametrize("refspec", [":topic", "main:topic", "+main:refs/heads/other", ":gone"])
def test_push_refspecs(twin, refspec):
    twin.both(lambda s, r: r.refs.set("refs/heads/topic", r.head_commit_oid))
    twin.run(clone_argv(twin, "clone", "--no-checkout"))
    twin.run(at(twin, "clone", "push", "-u", "origin", refspec), code=None)
    twin.same("repo")
    twin.same("clone")


def test_shallow_clone_and_deepen(twin):
    twin.run(clone_argv(twin, "clone", "--depth", "1", "--no-checkout"))
    st = twin.same("clone")
    assert st["shallow"] == st["refs"]["refs/heads/main"].strip()
    twin.run(at(twin, "clone", "log"))
    twin.run(at(twin, "clone", "log", "-o", "json"))
    twin.run(at(twin, "clone", "fetch", "--depth", "10"))
    st = twin.same("clone")
    assert st["shallow"] is None
    twin.run(at(twin, "clone", "log"))


def test_push_from_shallow_clone_marks_remote_shallow(twin):
    twin.run(clone_argv(twin, "clone", "--depth", "1", "--no-checkout"))
    for s in ("k", "p"):
        JRepo.init_repository(twin.root[s] / "target", bare=True)
    twin.run(lambda s: ["-C", twin.path(s, "clone"), "remote", "add", "target",
                        twin.path(s, "target")])
    twin.run(at(twin, "clone", "push", "target"))
    st = twin.same("target")
    assert st["shallow"] is not None
    twin.same("clone")


def test_clone_of_a_missing_remote_fails_cleanly(twin):
    twin.run(lambda s: ["clone", twin.path(s, "missing-remote"), twin.path(s, "c2")], code=2)
    for s in ("k", "p"):
        assert not os.path.exists(os.path.join(twin.path(s, "c2"), ".kart"))


def test_clone_into_a_nonempty_directory_refused(twin):
    for s in ("k", "p"):
        os.makedirs(twin.path(s, "c2"))
        open(os.path.join(twin.path(s, "c2"), "x"), "w").close()
    twin.run(clone_argv(twin, "c2"), code=2)
    assert os.listdir(twin.path("p", "c2")) == ["x"]


def test_remote_management(twin):
    for s in ("k", "p"):
        JRepo.init_repository(twin.root[s] / "other")
    twin.run(lambda s: ["-C", twin.path(s, "other"), "remote", "add", "up", twin.path(s)])
    twin.run(at(twin, "other", "remote", "list", "-v"))
    twin.run(at(twin, "other", "remote", "add", "up", "elsewhere"), code=2)
    twin.run(at(twin, "other", "fetch", "up"))
    twin.same("other")
    twin.run(at(twin, "other", "remote", "remove", "up"))
    twin.run(at(twin, "other", "remote", "remove", "up"), code=2)
    twin.run(at(twin, "other", "remote", "list"))
    twin.run(at(twin, "other", "fetch", "nowhere"), code=2)
    twin.run(at(twin, "other", "remote"), code=2)
    twin.same("other")


def test_fetch_skips_invalid_remote_ref_names(twin):
    twin.run(clone_argv(twin, "clone", "--no-checkout"))
    for s in ("k", "p"):
        repo = twin.repo(s)
        for bad in ("evil.lock", ".hidden"):
            with open(os.path.join(repo.gitdir, "refs", "heads", bad), "w") as f:
                f.write(repo.head_commit_oid + "\n")
        edit_commit(repo, "points", deletes=[2], message="advance")
    _, _, err = twin.run(at(twin, "clone", "fetch"))
    assert "invalid remote ref name" in err
    st = twin.same("clone")
    assert not any("evil" in r or "hidden" in r for r in st["refs"])


def test_checkout_guesses_a_remote_branch(twin):
    twin.both(lambda s, r: r.refs.set("refs/heads/feature-x", r.head_commit_oid, "for guess"))
    twin.run(clone_argv(twin, "clone"))
    out = twin.run(at(twin, "clone", "checkout", "feature-x"))
    assert "tracking" in out[1]
    twin.same("clone", wc="clone.gpkg")


# --- the spatially filtered clone ---------------------------------------------------

@pytest.mark.parametrize("indexed", [False, True])
def test_filtered_clone_promises_the_same_blobs(twin, indexed):
    if indexed:
        for s in ("k", "p"):
            jindex(twin.repo(s))
    twin.run(clone_argv(twin, "partial", "--spatial-filter", RECT, "--no-checkout"))
    st = twin.same("partial")
    promised = objects(twin.path("p")) - st["objects"]
    assert len(promised) == 5  # the blobs of fids 6..10
    for key in ("remote.origin.promisor", "remote.origin.partialclonefilter",
                "kart.spatialfilter.crs"):
        assert key.split(".")[-1] in st["config"]
    ds = TRepo(twin.path("p", "partial")).datasets("HEAD")["points"]
    assert ds.get_feature([5])["name"] == "feature-5"
    with pytest.raises(ObjectPromised):
        ds.get_feature([9])


def test_fetch_promised_blobs(twin):
    twin.run(clone_argv(twin, "partial", "--spatial-filter", RECT, "--no-checkout"))
    src_ds = twin.repo("k").datasets("HEAD")["points"]
    blob = src_ds.inner_tree.get(src_ds.encode_1pk_to_path(9, relative=True)).oid
    assert jtransport.fetch_promised_blobs(twin.repo("k", "partial"), [blob]) == 1
    assert ttransport.fetch_promised_blobs(TRepo(twin.path("p", "partial")), [blob]) == 1
    assert ttransport.fetch_promised_blobs(TRepo(twin.path("p", "partial")), [blob]) == 0
    twin.same("partial")
    ds = TRepo(twin.path("p", "partial")).datasets("HEAD")["points"]
    assert ds.get_feature([9])["name"] == "feature-9"


def test_refetch_from_a_promisor_filters_again(twin):
    twin.run(clone_argv(twin, "partial", "--spatial-filter", RECT, "--no-checkout"))
    twin.both(lambda s, r: edit_commit(r, "points", message="both sides", updates=[
        {**r.datasets()["points"].get_feature([3]), "name": "in"},
        {**r.datasets()["points"].get_feature([8]), "name": "out"}]))
    twin.run(at(twin, "partial", "fetch"))
    st = twin.same("partial")
    assert len(objects(twin.path("p")) - st["objects"]) == 6  # 6..10, and fid 8's new blob


# --- the promised-blob backfill (kart_tpu's TestPromisorBackfill) -------------------

@pytest.fixture()
def filtered(twin):
    twin.run(clone_argv(twin, "partial", "--spatial-filter", RECT))
    twin.same("partial", wc="partial.gpkg")
    return twin


def test_checkout_skips_promised_features(filtered):
    con = sqlite3.connect(os.path.join(filtered.path("p", "partial"), "partial.gpkg"))
    assert sorted(r[0] for r in con.execute("SELECT fid FROM points")) == [1, 2, 3, 4, 5]
    con.close()


@pytest.mark.parametrize("fmt", [("-o", "json"), ("-o", "json-lines"), (), ("-o", "geojson"),
                                 ("-o", "feature-count"), ("-o", "quiet")])
def test_diff_backfills_promised_values(filtered, fmt):
    src_ds = filtered.repo("k").datasets("HEAD")["points"]
    blob = src_ds.inner_tree.get(src_ds.encode_1pk_to_path(9, relative=True)).oid
    rc, out, _ = filtered.run(at(filtered, "partial", "diff", *fmt, "[EMPTY]...HEAD"), code=None)
    if fmt[1:] == ("json",):
        assert '"fid":9' not in out.replace(" ", "") and '"fid":5' in out.replace(" ", "")
    fetched = TRepo(filtered.path("p", "partial")).odb.contains(blob)
    assert fetched == filtered.repo("k", "partial").odb.contains(blob)
    assert fetched or fmt[1:] in (("feature-count",), ("quiet",))
    filtered.same("partial")


def test_diff_shows_everything_when_filter_removed(filtered):
    for s in ("k", "p"):
        repo = filtered.repo(s, "partial")
        for key in JSpec.from_repo_config(repo).config_items():
            repo.del_config(key)
    _, out, _ = filtered.run(at(filtered, "partial", "diff", "-o", "json-lines",
                                "[EMPTY]...HEAD"))
    assert out.count('"type":"feature"') == 10
    filtered.same("partial")


def test_diff_of_an_edit_with_promised_sides(filtered):
    filtered.both(lambda s, r: edit_commit(r, "points", message="mixed", updates=[
        {**r.datasets()["points"].get_feature([2]), "name": "in"},
        {**r.datasets()["points"].get_feature([7]), "name": "out"},
        {**r.datasets()["points"].get_feature([9]), "geom": None}], deletes=[10]))
    filtered.run(at(filtered, "partial", "pull"))
    for fmt in (("-o", "json-lines"), ("-o", "json"), ()):
        filtered.run(at(filtered, "partial", "diff", *fmt, "HEAD^...HEAD"))
    filtered.same("partial", wc="partial.gpkg")


def test_reset_handles_promised_targets(filtered):
    filtered.run(at(filtered, "partial", "reset", "--discard-changes", "HEAD^"))
    filtered.same("partial", wc="partial.gpkg")
    filtered.run(at(filtered, "partial", "reset", "--discard-changes", "origin/main"))
    filtered.same("partial", wc="partial.gpkg")


def test_wc_insert_colliding_with_promised_pk_warns(filtered):
    for s, connect in (("k", wc_connect), ("p", None)):
        path = os.path.join(filtered.path(s, "partial"), "partial.gpkg")
        con = wc_connect(path) if connect else sqlite3.connect(path)
        if not connect:
            _register_gpkg_functions(con)
        con.execute("INSERT INTO points (fid, name, rating, geom) VALUES (9, 'collider', 1.0, "
                    "NULL)")
        con.commit()
        con.close()
    _, _, err = filtered.run(at(filtered, "partial", "diff"))
    assert "outside the spatial filter" in err


# --- clone, push and pull through the CLI -------------------------------------------

def test_cli_clone_push_pull_fast_forward(twin):
    twin.run(clone_argv(twin, "cliclone"))
    for s in ("k", "p"):
        clone = twin.repo(s, "cliclone")
        clone.config.set_many({"user.name": "X", "user.email": "x@example.com"})
        edit_commit(clone, "points", deletes=[7], message="cli edit")
    twin.run(at(twin, "cliclone", "reset", "--discard-changes"))
    twin.run(at(twin, "cliclone", "push"))
    twin.same("repo")
    twin.both(lambda s, r: edit_commit(r, "points", deletes=[8], message="upstream edit"))
    twin.run(at(twin, "cliclone", "pull", "--ff-only"))
    st = twin.same("cliclone", wc="cliclone.gpkg")
    assert st["refs"]["refs/heads/main"] == state(twin.path("p"), twin.root["p"])["refs"][
        "refs/heads/main"]
    twin.run(at(twin, "cliclone", "reflog"))
    twin.run(at(twin, "cliclone", "reflog", "origin/main"))


def test_cli_pull_diverged(twin):
    twin.run(clone_argv(twin, "cliclone"))
    for s in ("k", "p"):
        clone = twin.repo(s, "cliclone")
        edit_commit(clone, "points", deletes=[7], message="local edit")
        edit_commit(twin.repo(s), "points", deletes=[8], message="upstream edit")
    twin.run(at(twin, "cliclone", "reset", "--discard-changes"))
    twin.run(at(twin, "cliclone", "pull", "--ff-only"), code=None)
    twin.run(at(twin, "cliclone", "pull"))
    twin.same("cliclone", wc="cliclone.gpkg")
    twin.run(at(twin, "cliclone", "log"))
    twin.run(at(twin, "cliclone", "pull", "origin", "nosuch"), code=2)
    twin.run(at(twin, "cliclone", "push"))
    twin.same("repo")


def test_pull_of_a_merging_repository_refused(twin):
    twin.run(clone_argv(twin, "c"))
    for s in ("k", "p"):
        twin.repo(s, "c").write_gitdir_file("MERGE_HEAD", twin.repo(s).head_commit_oid)
    twin.run(at(twin, "c", "pull"), code=2)


# --- checkout --spatial-filter --------------------------------------------------------

def test_checkout_spatial_filter_rebuilds_wc(twin):
    twin.run(at(twin, "repo", "checkout"))
    wc = "repo.gpkg"
    twin.same("repo", wc=wc)
    twin.run(at(twin, "repo", "checkout", "--spatial-filter", RECT))
    twin.same("repo", wc=wc)
    twin.run(at(twin, "repo", "status", "-o", "json"))
    twin.run(at(twin, "repo", "diff", "-o", "json", "HEAD^...HEAD"))
    twin.run(at(twin, "repo", "checkout", "--spatial-filter", RECT, "HEAD^"))
    twin.same("repo", wc=wc)
    twin.run(at(twin, "repo", "checkout", "--spatial-filter", "none"))
    twin.same("repo", wc=wc)
    twin.run(at(twin, "repo", "checkout", "--spatial-filter", "none"))
    twin.same("repo", wc=wc)


def test_checkout_spatial_filter_refuses_a_dirty_copy(twin):
    twin.run(at(twin, "repo", "checkout"))
    for s in ("k", "p"):
        con = sqlite3.connect(os.path.join(twin.path(s), "repo.gpkg"))
        _register_gpkg_functions(con)
        con.execute("DELETE FROM points WHERE fid = 2")
        con.commit()
        con.close()
    twin.run(at(twin, "repo", "checkout", "--spatial-filter", RECT), code=20)
    twin.same("repo", wc="repo.gpkg")
    twin.run(at(twin, "repo", "checkout", "--force", "--spatial-filter", RECT, "-b", "x"))
    twin.same("repo", wc="repo.gpkg")


# --- tag, config, reflog -------------------------------------------------------------

def test_tag_create_list_delete_and_fetch(twin):
    twin.run(at(twin, "repo", "tag", "v1", "HEAD^"))
    twin.run(at(twin, "repo", "tag", "-m", "release two", "v2"))
    twin.run(at(twin, "repo", "tag", "v2"), code=20)
    twin.run(at(twin, "repo", "tag", "v3", "nosuch"), code=40)
    twin.run(at(twin, "repo", "tag"))
    twin.run(at(twin, "repo", "diff", "-o", "json", "v1...v2"))
    twin.run(clone_argv(twin, "clone", "--no-checkout"))
    twin.run(at(twin, "repo", "tag", "-d", "v1"))
    twin.run(at(twin, "repo", "tag", "-d", "v1"), code=2)
    twin.run(at(twin, "repo", "tag", "-m", "three", "v3"))
    twin.run(at(twin, "clone", "fetch"))
    twin.run(at(twin, "clone", "tag"))
    twin.same("clone")
    twin.run(at(twin, "clone", "log", "v2"))


@pytest.mark.parametrize("argv,code", [
    (("config", "user.name"), 0), (("config", "nosuch.key"), 1),
    (("config", "a.b", "hello world"), 0), (("config", "Remote.x.URL", "y"), 0),
    (("config", "--unset", "user.email"), 0), (("config", "--unset", "no.such"), 0),
    (("config",), 2),
])
def test_config(twin, argv, code):
    twin.run(at(twin, "repo", *argv), code=code)
    twin.run(at(twin, "repo", "config", argv[-1] if len(argv) > 1 else "user.name"),
             code=None)
    twin.same("repo")


@pytest.mark.parametrize("ref", ["HEAD", "main", "refs/heads/main", "nosuch", "origin/main",
                                 "v1"])
def test_reflog(twin, ref):
    twin.run(clone_argv(twin, "clone", "--no-checkout"))
    twin.run(at(twin, "clone", "tag", "v1"))
    twin.run(at(twin, "clone", "reflog", ref))


# --- network remotes: unreachable, nothing written --------------------------------------

@pytest.mark.parametrize("url", ["http://localhost:1/repo", "https://127.0.0.1:1/r",
                                 "ssh://host/path/repo", "user@host:repo"])
def test_network_remotes_exit_30_writing_nothing(twin, url, tmp_path, monkeypatch):
    """An unreachable network remote fails as kart_tpu's does, writing
    nothing: a closed port for http(s), an ssh that exits 255 (a stub
    ``KART_SSH``). clone, and fetch, push and pull of a remote added with
    that URL, give kart_tpu's exit codes and stdout and leave the
    repositories as kart_tpu leaves its own. (Until the network lanes were
    ported these exited 30.)"""
    stub = tmp_path / "ssh-unreachable"
    stub.write_text("#!/bin/sh\nexit 255\n")
    stub.chmod(0o755)
    monkeypatch.setenv("KART_SSH", str(stub))
    monkeypatch.setenv("KART_TRANSPORT_RETRIES", "1")
    got = {}
    for side, runner in (("k", kart), ("p", port)):
        target = twin.path(side, "net")
        rc, out, _err = runner(["clone", url, target])
        left = sorted(os.listdir(target)) if os.path.exists(target) else None
        results = [(rc, out, left)]
        runner(["-C", twin.path(side), "remote", "add", "net", url])
        before = state(twin.path(side), twin.root[side])
        for argv in (["fetch", "net"], ["push", "net"], ["pull", "net"]):
            rc, out, _err = runner(["-C", twin.path(side), *argv])
            results.append((rc, out))
        results.append(state(twin.path(side), twin.root[side]) == before)
        got[side] = results
    assert got["p"] == got["k"]
    assert all(r[0] != 0 for r in got["p"][:4]) and got["p"][-1]


# --- repositories across the packages ---------------------------------------------------

def test_each_package_clones_fetches_and_pushes_the_other_s_repository(tmp_path):
    """The port's ``init --import`` repository cloned by kart_tpu and
    kart_tpu's by the port, then both advanced, fetched and pushed back."""
    gpkg = create_points_gpkg(str(tmp_path / "points.gpkg"), n=12)
    assert port(["init", "--import", gpkg, str(tmp_path / "made_by_port")])[0] == 0
    assert kart(["init", "--import", gpkg, str(tmp_path / "made_by_kart")])[0] == 0
    assert objects(str(tmp_path / "made_by_port")) == objects(str(tmp_path / "made_by_kart"))
    for src, runner, other in (("made_by_port", kart, port), ("made_by_kart", port, kart)):
        dest = str(tmp_path / f"{src}_clone")
        assert runner(["clone", str(tmp_path / src), dest])[0] == 0
        edit_commit(JRepo(str(tmp_path / src)), "points", deletes=[3], message="upstream")
        assert runner(["-C", dest, "pull"])[0] == 0
        edit_commit(JRepo(dest), "points", deletes=[4], message="downstream")
        assert runner(["-C", dest, "reset", "--discard-changes"])[0] == 0
        assert runner(["-C", dest, "push"])[0] == 0
        assert objects(dest) == objects(str(tmp_path / src))
        assert other(["-C", str(tmp_path / src), "log", "-o", "json"])[0] == 0
    a, b = (state(str(tmp_path / f"{s}_clone"), tmp_path) for s in ("made_by_port", "made_by_kart"))
    assert a["objects"] == b["objects"] and a["refs"]["refs/heads/main"] == b["refs"][
        "refs/heads/main"]


def test_clone_of_a_port_clone_by_kart_tpu(twin):
    """kart_tpu clones (filtered) what the port cloned, and the port what
    kart_tpu cloned: the same objects."""
    twin.run(clone_argv(twin, "clone", "--no-checkout"))
    rc, _, _ = kart(["clone", "--spatial-filter", RECT, "--no-checkout", twin.path("p", "clone"),
                     twin.path("p", "second")])
    assert rc == 0
    rc, _, _ = port(["clone", "--spatial-filter", RECT, "--no-checkout", twin.path("k", "clone"),
                     twin.path("k", "second")])
    assert rc == 0
    twin.same("second")


# --- the store's presence checks the transfer and the working copy use ----------------

def test_store_sees_objects_another_instance_wrote(tmp_path):
    """A pack or loose object written through another ObjectDb after this
    one scanned is found by ``contains``, ``read_raw``, ``absent`` and a new
    ``contains_snapshot``, as kart_tpu's store finds it."""
    repo = TRepo.init_repository(tmp_path / "r")
    reader = TRepo(str(tmp_path / "r")).odb
    assert reader.absent(["0" * 40]) == {"0" * 40} and not reader.contains_snapshot()("0" * 40)
    writer = TRepo(str(tmp_path / "r")).odb
    with writer.bulk_pack():
        packed = writer.write_raw("blob", b"packed")
    loose = writer.write_raw("blob", b"loose")
    missing = "f" * 40
    for oid in (packed, loose):
        assert reader.contains(oid) and reader.read_raw(oid)[0] == "blob"
        assert JRepo(str(tmp_path / "r")).odb.contains(oid)
    assert reader.absent([packed, loose, missing]) == {missing}
    has = reader.contains_snapshot()
    assert has(packed) and has(loose) and not has(missing)
    assert repo.odb.loose_oids() == {loose}


@pytest.mark.parametrize("diverged", [False, True])
def test_pull_and_merge_in_a_shallow_clone(twin, diverged):
    """``log`` and ``merge`` (through ``pull``) on a depth-1 clone."""
    twin.run(clone_argv(twin, "shallow", "--depth", "1"))
    for s in ("k", "p"):
        if diverged:
            edit_commit(twin.repo(s, "shallow"), "points", deletes=[6], message="local edit")
        edit_commit(twin.repo(s), "points", deletes=[8], message="upstream edit")
    twin.run(at(twin, "shallow", "reset", "--discard-changes"))
    twin.run(at(twin, "shallow", "pull"), code=None)
    twin.same("shallow", wc="shallow.gpkg")
    twin.run(at(twin, "shallow", "log"))
    twin.run(at(twin, "shallow", "merge", "origin/main", "-o", "json"), code=None)
