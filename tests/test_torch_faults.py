"""kart_tpu's ``KART_FAULTS`` kill matrices, run on the port and on kart_tpu
side by side: for each fault point at kart_tpu's name (the transport's
frames, the object store's writes and pack finalise, the pipelined import's
stages, the server's enumeration cache, shedding, CAS and rebase frames,
the tile encode, cache, streams and export frames, the query's scan, join
and refine frames, the vertex extraction and the CDC), the same operation
is killed in each package and must end the same way: the same exception
class, the same store bytes afterwards (a refused or killed push leaves
the served store byte-identical), nothing published, and a retry that lands
what kart_tpu's lands. In-process, as kart_tpu's matrices run; the server
and the client share the process, as they do there."""

import os
from urllib.error import HTTPError
from urllib.request import urlopen

import pytest

from helpers import create_points_gpkg, edit_commit, make_imported_repo
from kart_tpu import faults as jfaults
from kart_tpu import transport as jtransport
from kart_tpu.core.objects import hash_object
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.transport.http import HttpRemote as JHttpRemote
from kart_tpu.transport.retry import RetryPolicy as JRetryPolicy
from kart_tpu_torch import faults as tfaults
from kart_tpu_torch import transport as ttransport
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.transport.http import HttpRemote as THttpRemote
from kart_tpu_torch.transport.retry import RetryPolicy as TRetryPolicy
from torch_serve_helpers import DATE, ServedPair, gitdir_files, objects, refs, store_snapshot

SIDES = {
    "k": {"faults": jfaults, "transport": jtransport, "repo": JRepo, "http": JHttpRemote,
          "retry": JRetryPolicy, "kw": {}},
    "p": {"faults": tfaults, "transport": ttransport, "repo": TRepo, "http": THttpRemote,
          "retry": TRetryPolicy, "kw": {"device": "cpu"}},
}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("GIT_AUTHOR_DATE", DATE)
    monkeypatch.setenv("GIT_COMMITTER_DATE", DATE)
    monkeypatch.setenv("KART_TRANSPORT_RETRY_BASE", "0")
    monkeypatch.setenv("KART_TRANSPORT_RETRY_CAP", "0")
    monkeypatch.delenv("KART_FAULTS", raising=False)


def arm(monkeypatch, spec):
    """Arm ``spec`` afresh in both packages (their one-shot state resets)."""
    for side in SIDES.values():
        side["faults"]._spec_src = None
    if spec is None:
        monkeypatch.delenv("KART_FAULTS", raising=False)
    else:
        monkeypatch.setenv("KART_FAULTS", spec)


def fsck(path):
    repo = JRepo(path)
    n = 0
    for oid in repo.odb.iter_oids():
        t, c = repo.odb.read_raw(oid)
        assert hash_object(t, c) == oid
        n += 1
    return n


def quarantine(path):
    q = os.path.join(JRepo(path).odb.objects_dir, "quarantine")
    return os.listdir(q) if os.path.isdir(q) else []


def both(fn):
    """``fn(side)`` for kart_tpu then the port; their results must agree."""
    got = {side: fn(side) for side in ("k", "p")}
    assert got["p"] == got["k"]
    return got["p"]


def outcome(call):
    try:
        return ("ok", call())
    except Exception as e:
        return ("raised", type(e).__name__)


@pytest.fixture()
def pair(tmp_path):
    (tmp_path / "src").mkdir()
    repo, ds_path = make_imported_repo(tmp_path / "src", n=6)
    edit_commit(repo, ds_path, message="second commit",
                updates=[{"fid": 1, "geom": None, "name": "renamed", "rating": 9.0}])
    repo.config["receive.denyCurrentBranch"] = "ignore"
    served = ServedPair(repo.workdir, str(tmp_path / "served"))
    yield served
    served.close()


# --- the transport's frames ---------------------------------------------------------------

@pytest.mark.parametrize("frame", [1, 2, 3, 5, 8])
def test_fetch_killed_at_a_frame_resumes_the_remainder(pair, tmp_path, monkeypatch, frame):
    def run(side):
        s = SIDES[side]
        client = s["http"](pair.url[side], retry=s["retry"](attempts=1))
        info = client.ls_refs()
        wants = list(info["heads"].values())
        dst = s["repo"].init_repository(str(tmp_path / side / "dst"))
        arm(monkeypatch, f"transport.read.frame:{frame}")
        first = outcome(lambda: client.fetch_pack(dst, wants))
        arm(monkeypatch, None)
        salvaged = fsck(str(tmp_path / side / "dst"))
        header = client.fetch_pack(dst, wants, exclude=set(JRepo(dst.gitdir).odb.iter_oids()))
        return first[0], salvaged, header["object_count"], fsck(str(tmp_path / side / "dst"))

    got = both(run)
    assert got[0] == "raised" and got[1] == frame - 1


@pytest.mark.parametrize("spec,retries", [("transport.read.frame:5", "3"),
                                          ("transport.read.frame:6", "1")],
                         ids=["retried", "kept_then_fetched"])
def test_clone_through_a_killed_stream(pair, tmp_path, monkeypatch, spec, retries):
    def run(side):
        s = SIDES[side]
        monkeypatch.setenv("KART_TRANSPORT_RETRIES", retries)
        arm(monkeypatch, spec)
        dst = str(tmp_path / side / "clone")
        first = outcome(lambda: s["transport"].clone(pair.url[side], dst, do_checkout=False,
                                                     **s["kw"]) and None)
        arm(monkeypatch, None)
        marker = s["repo"](dst).read_gitdir_file("FETCH_RESUME") is not None
        salvaged = fsck(dst)
        if first[0] == "raised":
            s["transport"].fetch(s["repo"](dst), "origin", **s["kw"])
        return first, marker, salvaged, refs(dst), objects(dst)

    both(run)


@pytest.mark.parametrize("spec", ["transport.read.frame:2", "transport.write.frame:3"])
def test_torn_push_leaves_the_served_store_byte_identical(pair, tmp_path, monkeypatch, spec):
    def run(side):
        s = SIDES[side]
        monkeypatch.setenv("KART_TRANSPORT_RETRIES", "1")
        dst = str(tmp_path / side / "clone")
        s["transport"].clone(pair.url[side], dst, do_checkout=False, **s["kw"])
        new = edit_commit(JRepo(dst), "points", deletes=[2], message="to push")
        before = store_snapshot(pair.path[side]), refs(pair.path[side])
        arm(monkeypatch, spec)
        first = outcome(lambda: s["transport"].push(s["repo"](dst), "origin"))
        arm(monkeypatch, None)
        after = store_snapshot(pair.path[side]), refs(pair.path[side])
        retried = s["transport"].push(s["repo"](dst), "origin")
        return first, after == before, quarantine(pair.path[side]), retried == {
            "refs/heads/main": new}

    got = both(run)
    assert got[0][0] == "raised" and got[1] and got[3]


def _contended(pair, tmp_path, side, *, conflict=False):
    s = SIDES[side]
    dst = str(tmp_path / side / "clone")
    s["transport"].clone(pair.url[side], dst, do_checkout=False, **s["kw"])
    JRepo(dst).config.set_many({"user.name": "C", "user.email": "c@example.com"})
    local = edit_commit(JRepo(dst), "points", message="contender",
                        updates=[{"fid": 4, "geom": None, "name": "loc", "rating": 2.0}]
                        if conflict else (), deletes=() if conflict else [5])
    moved = edit_commit(JRepo(pair.path[side]), "points", message="tip moved",
                        updates=[{"fid": 4, "geom": None, "name": "srv", "rating": 1.0}]
                        if conflict else (), deletes=() if conflict else [4])
    return dst, local, moved


@pytest.mark.parametrize("spec", ["server.rebase:1", "server.rebase:2", "server.rebase:3",
                                  "server.ref_cas:1", "server.ref_cas:2"])
def test_server_frames_killed_leave_the_store_byte_identical(pair, tmp_path, monkeypatch,
                                                             spec):
    """The server-side rebase (1 = ancestry and classifier, 2 = merge commit
    write, 3 = quarantine temp ref) and the CAS (1 = validation, 2 = before
    migrate): a kill discards the quarantine; nothing of the incoming
    commits, no sidecar and no annotation reaches the live repository; the
    re-push lands."""
    def run(side):
        s = SIDES[side]
        monkeypatch.setenv("KART_TRANSPORT_RETRIES", "1")
        dst, local, moved = _contended(pair, tmp_path, side)
        before = (store_snapshot(pair.path[side]), refs(pair.path[side]),
                  gitdir_files(pair.path[side]))
        arm(monkeypatch, spec)
        first = outcome(lambda: s["transport"].push(s["repo"](dst), "origin"))
        arm(monkeypatch, None)
        after = (store_snapshot(pair.path[side]), refs(pair.path[side]),
                 gitdir_files(pair.path[side]))
        landed = s["transport"].push(s["repo"](dst), "origin")
        tip = refs(pair.path[side])["refs/heads/main"]
        return (first, after == before, quarantine(pair.path[side]), landed,
                JRepo(pair.path[side]).odb.read_commit(tip).parents)

    got = both(run)
    assert got[0][0] == "raised" and got[1] and got[2] == [] and len(got[4]) == 2


def test_conflicting_push_refused_store_byte_identical(pair, tmp_path, monkeypatch):
    def run(side):
        s = SIDES[side]
        dst, local, moved = _contended(pair, tmp_path, side, conflict=True)
        before = (store_snapshot(pair.path[side]), gitdir_files(pair.path[side]))
        first = outcome(lambda: s["transport"].push(s["repo"](dst), "origin"))
        after = (store_snapshot(pair.path[side]), gitdir_files(pair.path[side]))
        return first, after == before, JRepo(pair.path[side]).odb.contains(local)

    got = both(run)
    assert got == (("raised", "RemoteError"), True, False)


def test_shed_fault_is_retried(pair, tmp_path, monkeypatch):
    def run(side):
        s = SIDES[side]
        monkeypatch.setenv("KART_TRANSPORT_RETRIES", "3")
        arm(monkeypatch, "server.shed:1")
        info = s["http"](pair.url[side]).ls_refs()
        arm(monkeypatch, None)
        return info

    both(run)


def test_killed_cached_stream_then_fetch_resumes(pair, tmp_path, monkeypatch):
    """server.enum_cache: the publish frame poisons nothing, and a kill
    mid-way through a cached stream is salvaged and resumed."""
    def run(side):
        s = SIDES[side]
        monkeypatch.setenv("KART_TRANSPORT_RETRIES", "1")
        arm(monkeypatch, "server.enum_cache:1")
        first = outcome(lambda: s["transport"].clone(
            pair.url[side], str(tmp_path / side / "a"), do_checkout=False, **s["kw"]) and None)
        arm(monkeypatch, None)
        s["transport"].clone(pair.url[side], str(tmp_path / side / "b"), do_checkout=False,
                             **s["kw"])
        return first, objects(str(tmp_path / side / "b"))

    both(run)


# --- the object store ---------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["odb.write_raw:1", "odb.bulk_pack:1", "pack.finalise:1",
                                  "idx.write:1"])
def test_store_write_killed_leaves_no_readable_debris(tmp_path, monkeypatch, spec):
    def run(side):
        s = SIDES[side]
        path = str(tmp_path / side / "r")
        repo = s["repo"].init_repository(path)

        def write():
            if spec.startswith("odb.write_raw"):
                return repo.odb.write_raw("blob", b"precious")
            with repo.odb.bulk_pack():
                return repo.odb.write_raw("blob", b"doomed")

        arm(monkeypatch, spec)
        first = outcome(write)
        arm(monkeypatch, None)
        pack_dir = os.path.join(JRepo(path).odb.objects_dir, "pack")
        left = sorted(n.split("-")[0] for n in os.listdir(pack_dir)) if os.path.isdir(
            pack_dir) else []
        readable = fsck(path)
        oid = write()
        return first, readable, left, fsck(path), oid

    got = both(run)
    assert got[0] == ("raised", "InjectedFault") and got[1] == 0


@pytest.mark.parametrize("spec", ["import.encode:1", "import.pack_stream:1"])
def test_pipelined_import_killed_is_clean_and_rerunnable(tmp_path, monkeypatch, spec):
    gpkg = create_points_gpkg(str(tmp_path / "pts.gpkg"), n=120)
    monkeypatch.setenv("KART_IMPORT_PIPELINE", "1")
    monkeypatch.setenv("KART_IMPORT_WORKERS", "1")

    def run(side):
        if side == "k":
            from kart_tpu.importer import ImportSource
            from kart_tpu.importer.importer import import_sources
        else:
            from kart_tpu_torch.importer import ImportSource
            from kart_tpu_torch.importer.importer import import_sources
        path = str(tmp_path / side / "r")
        repo = SIDES[side]["repo"].init_repository(path)
        arm(monkeypatch, spec)
        first = outcome(lambda: import_sources(repo, ImportSource.open(gpkg)) and None)
        arm(monkeypatch, None)
        unborn, readable = SIDES[side]["repo"](path).head_is_unborn, fsck(path)
        commit = import_sources(SIDES[side]["repo"](path), ImportSource.open(gpkg))
        return first, unborn, readable, JRepo(path).odb.read_commit(commit).tree

    got = both(run)
    assert got[0] == ("raised", "InjectedFault") and got[1] and got[2] == 0


# --- tiles, queries, geometry and the CDC ---------------------------------------------------

def _get(url, path):
    try:
        with urlopen(url.rstrip("/") + path, timeout=60) as r:
            return r.status, r.read()
    except HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("spec", ["tiles.encode:1", "tiles.encode:2", "tiles.cache:1",
                                  "tiles.streams:1"])
def test_served_tile_killed_publishes_nothing(pair, monkeypatch, spec):
    layers = "?layers=ktb2" if spec.startswith("tiles.streams") else ""
    path = f"/api/v1/tiles/HEAD/points/1/1/1{layers}"

    def run(side):
        arm(monkeypatch, spec)
        status, body = _get(pair.url[side], path)
        arm(monkeypatch, None)
        return status, b"InjectedFault" in body, _get(pair.url[side], path)

    got = both(run)
    assert got[0] == 500 and got[1] and got[2][0] == 200


@pytest.mark.parametrize("frame", [1, 2])
def test_pyramid_export_killed_at_a_batch_boundary(tmp_path, monkeypatch, frame):
    repo, ds_path = make_imported_repo(tmp_path, n=12)

    def run(side):
        if side == "k":
            from kart_tpu import tiles
            from kart_tpu.tiles.pyramid import export_pyramid, tree_digest
            kw = {}
        else:
            from kart_tpu_torch import tiles
            from kart_tpu_torch.tiles.pyramid import export_pyramid, tree_digest
            kw = {"device": "cpu"}
        r = SIDES[side]["repo"](repo.workdir)
        src = tiles.source_for(r, tiles.resolve_tile_commit(r, "HEAD"), ds_path)
        out = str(tmp_path / side / "out")
        arm(monkeypatch, f"tiles.export:{frame}")
        first = outcome(lambda: export_pyramid(src, [0, 1, 2], out, layers=("ktb2",), workers=1,
                                               batch_tiles=1, **kw) and None)
        arm(monkeypatch, None)
        partial = tree_digest(out) if os.path.isdir(out) else None
        export_pyramid(src, [0, 1, 2], out, layers=("ktb2",), workers=1, batch_tiles=1, **kw)
        return first, partial, tree_digest(out)

    got = both(run)
    assert got[0] == ("raised", "InjectedFault")


@pytest.fixture()
def query_pair(tmp_path):
    from kart_tpu.synth import synth_repo

    repo, info = synth_repo(str(tmp_path / "q"), 5000, spatial=True, blobs="changed")
    served = ServedPair(repo.workdir, str(tmp_path / "served"))
    yield served, info
    served.close()


@pytest.fixture()
def scan_pair(tmp_path):
    """Every blob written: the scan's blob-decode batches need them."""
    from kart_tpu.synth import synth_repo

    repo, info = synth_repo(str(tmp_path / "q"), 400, blobs="real")
    served = ServedPair(repo.workdir, str(tmp_path / "served"))
    yield served, info
    served.close()


@pytest.mark.parametrize("spec,kind", [("query.scan:1", "where"), ("query.scan:2", "where"),
                                       ("query.join:1", "join"), ("query.join:2", "join"),
                                       ("query.refine:1", "bbox")])
def test_served_query_killed_publishes_nothing(request, monkeypatch, spec, kind):
    from urllib.parse import quote

    served, info = request.getfixturevalue("scan_pair" if kind == "where" else "query_pair")
    base = info["base_commit"]
    path = {
        "where": f"/api/v1/query?ref={base}&dataset=synth&where={quote('rating >= 42')}"
                 "&output=json",
        "join": f"/api/v1/query?ref={base}&dataset=synth&intersects={base}:synth",
        "bbox": f"/api/v1/query?ref={base}&dataset=synth&bbox=-60,-30,60,30",
    }[kind]

    def run(side):
        arm(monkeypatch, spec)
        status, body = _get(served.url[side], path)
        arm(monkeypatch, None)
        return status, b"InjectedFault" in body, _get(served.url[side], path)

    got = both(run)
    assert got[0] == 500 and got[1] and got[2][0] == 200


def test_vertex_extraction_killed_publishes_nothing(monkeypatch):
    from kart_tpu.geom import vertex_column_from_blobs as jextract
    from kart_tpu_torch.geom import vertex_column_from_blobs as textract

    arm(monkeypatch, "geom.extract:1")
    got = {"k": outcome(lambda: jextract([None])), "p": outcome(lambda: textract([None]))}
    arm(monkeypatch, None)
    assert got["p"] == got["k"] == ("raised", "InjectedFault")


def test_cdc_killed_before_any_work(tmp_path, monkeypatch):
    from kart_tpu.events.cdc import dirty_tiles as jdirty
    from kart_tpu_torch.events.cdc import dirty_tiles as tdirty

    repo, ds_path = make_imported_repo(tmp_path, n=4)
    tip = repo.head_commit_oid
    arm(monkeypatch, "events.emit:1")
    got = {"k": outcome(lambda: jdirty(JRepo(repo.workdir), None, tip)),
           "p": outcome(lambda: tdirty(TRepo(repo.workdir), None, tip, device="cpu"))}
    arm(monkeypatch, None)
    assert got["p"] == got["k"] == ("raised", "InjectedFault")
    assert tdirty(TRepo(repo.workdir), None, tip, device="cpu") == jdirty(
        JRepo(repo.workdir), None, tip)


def test_fault_spec_parsing_equal(monkeypatch):
    for spec in ("a:3", "a", "a:x,b:2", "", " a : 1 ,, b"):
        assert tfaults._parse(spec) == jfaults._parse(spec)
    arm(monkeypatch, "x.y:2")
    hooks = [side["faults"].hook("x.y") for side in SIDES.values()]
    for h in hooks:
        h()
        with pytest.raises(OSError):
            h()
        h()  # disarmed after firing
    assert tfaults.hook("other.point") is None
