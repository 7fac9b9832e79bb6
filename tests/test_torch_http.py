"""The port's HTTP lane against kart_tpu's, on the CPU: each package serves
its own copy of one repository (``make_server(port=0)`` in a thread, the
port with ``device="cpu"``), the same requests go to both, and status, the
headers that matter (ETag, Content-Type, Retry-After, ranges, caching) and
bodies must be equal; clones, fetches and pushes over ``http://`` give the
same refs and objects, in both directions between the packages; the fleet
options and the events feed are refused as documented. Dates are pinned,
so a server-side rebase writes the same merge commit in both."""

import json
import os
import threading

import pytest
from click.testing import CliRunner

from helpers import edit_commit, make_imported_repo
from kart_tpu import transport as jtransport
from kart_tpu.cli import cli as kart_cli
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.transport.http import HttpRemote as JHttpRemote
from kart_tpu.transport.retry import RetryPolicy as JRetryPolicy
from kart_tpu_torch import telemetry as ttm
from kart_tpu_torch import transport as ttransport
from kart_tpu_torch.cli import NOT_YET_IMPLEMENTED
from kart_tpu_torch.cli import main as port_main
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.core.repo import NotYetImplemented
from kart_tpu_torch.transport.http import HttpRemote, make_server, write_framed
from kart_tpu_torch.transport.remote import RemoteError
from kart_tpu_torch.transport.retry import RetryPolicy
from torch_serve_helpers import DATE, ServedPair, http, objects, refs, store_snapshot

WSEN = "100,-42,105.5,-39"


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("GIT_AUTHOR_DATE", DATE)
    monkeypatch.setenv("GIT_COMMITTER_DATE", DATE)
    monkeypatch.setenv("KART_TRANSPORT_RETRIES", "1")
    monkeypatch.setenv("KART_TRANSPORT_RETRY_BASE", "0")
    monkeypatch.delenv("KART_FAULTS", raising=False)


def _served(tmp_path, deny="ignore"):
    """kart_tpu's two-commit points repository (a rename with a NULL
    geometry on top of the import), served by each package."""
    (tmp_path / "src").mkdir()
    repo, ds_path = make_imported_repo(tmp_path / "src", n=12)
    edit_commit(repo, ds_path, message="second commit",
                updates=[{"fid": 1, "geom": None, "name": "renamed", "rating": 9.0}])
    repo.config["receive.denyCurrentBranch"] = deny
    return ServedPair(repo.workdir, str(tmp_path / "served"))


@pytest.fixture()
def pair(tmp_path):
    served = _served(tmp_path)
    yield served
    served.close()


def _same(got, mask_body=None):
    k, p = got["k"], got["p"]
    if mask_body is not None:
        k, p = (k[0], k[1], mask_body(k[2])), (p[0], p[1], mask_body(p[2]))
    assert p == k
    return p


def _wants(pair):
    info = json.loads(http(pair.url["k"], "/api/v1/refs")[2])
    return list(info["heads"].values()) + list(info["tags"].values())


# --- the read endpoints -------------------------------------------------------------

@pytest.mark.parametrize("path", ["/api/v1/refs", "/api/v1/refs/", "/api/v1/nosuch",
                                  "/api/v1/query", "/api/v1/query?ref=HEAD",
                                  "/api/v1/query?ref=nosuch&dataset=points",
                                  "/api/v1/query?ref=HEAD&dataset=points&page=x",
                                  "/api/v1/tiles/HEAD/points/0/0",
                                  "/api/v1/tiles/HEAD/points/0/0/0?format=png",
                                  "/api/v1/tiles/nosuch/points/0/0/0"])
def test_get_answers_equal(pair, path):
    _same(pair.exchange(path))


@pytest.mark.parametrize("body", [
    {},
    "depth1",
    "filtered",
    "have_parent",
    "exclude",
], ids=str)
def test_fetch_pack_bytes_and_etag_equal(pair, body):
    wants = _wants(pair)
    tip = JRepo(pair.path["k"]).head_commit_oid
    parent = JRepo(pair.path["k"]).odb.read_commit(tip).parents[0]
    req = {"wants": wants, "haves": [], "have_shallow": [], "depth": None, "filter": None,
           "exclude": []}
    if body == "depth1":
        req["depth"] = 1
    elif body == "filtered":
        req["filter"] = WSEN
    elif body == "have_parent":
        req["haves"] = [parent]
    elif body == "exclude":
        req["exclude"] = [tip]
    got = _same(pair.exchange("/api/v1/fetch-pack", method="POST", body=req))
    assert got[0] == 200 and got[1]["ETag"] and len(got[2]) > 8


def test_fetch_pack_range_resume_equal(pair):
    req = {"wants": _wants(pair)}
    full = _same(pair.exchange("/api/v1/fetch-pack", method="POST", body=req))
    etag = full[1]["ETag"]
    part = _same(pair.exchange("/api/v1/fetch-pack", method="POST", body=req,
                               headers={"Range": "bytes=100-", "If-Range": etag}))
    assert part[0] == 206 and part[2] == full[2][100:]
    stale = _same(pair.exchange("/api/v1/fetch-pack", method="POST", body=req,
                                headers={"Range": "bytes=100-", "If-Range": '"stale"'}))
    assert stale[0] == 200 and stale[2] == full[2]


@pytest.mark.parametrize("which", ["present", "missing"])
def test_fetch_blobs_equal(pair, which):
    repo = JRepo(pair.path["k"])
    oids = [e.oid for e in repo.odb.read_tree_entries(repo.odb.read_commit(
        repo.head_commit_oid).tree)][:1]
    if which == "missing":
        oids = ["0" * 40]
    _same(pair.exchange("/api/v1/fetch-blobs", method="POST", body={"oids": oids}))


def test_events_feed_is_refused_as_not_ported(pair, monkeypatch):
    status, _, body = http(pair.url["p"], "/api/v1/events")
    assert status == 501 and "not ported" in json.loads(body)["error"]
    monkeypatch.setenv("KART_SERVE_EVENTS", "0")
    _same(pair.exchange("/api/v1/events"))


def test_shed_answers_429_with_retry_after_equal(pair, monkeypatch):
    monkeypatch.setenv("KART_FAULTS", "server.shed:1")  # each package counts its own hits
    got = pair.exchange("/api/v1/refs")
    assert got["p"] == got["k"] and got["p"][0] == 429 and got["p"][1]["Retry-After"] == "1"


# --- clones, fetches and pushes over http:// ----------------------------------------

def _port(argv):
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_main(["--device", "cpu", *argv])
    return rc, out.getvalue(), err.getvalue()


def _kart(argv):
    r = CliRunner().invoke(kart_cli, argv, prog_name="kart")
    return r.exit_code, r.stdout, r.stderr


@pytest.mark.parametrize("opts", [[], ["--depth", "1"], ["--no-checkout"],
                                  ["--spatial-filter",
                                   "EPSG:4326;POLYGON((100 -42, 105.5 -42, 105.5 -39, "
                                   "100 -39, 100 -42))"]],
                         ids=["full", "depth1", "no_checkout", "filtered"])
def test_cli_clone_over_http_equal(pair, tmp_path, opts):
    got = {}
    for side, runner in (("k", _kart), ("p", _port)):
        dst = str(tmp_path / side / "clone")
        rc, out, err = runner(["clone", *opts, pair.url[side], dst])
        got[side] = (rc, out.replace(dst, "<dst>"), err, refs(dst), objects(dst))
    assert got["p"] == got["k"] and got["p"][0] == 0


@pytest.mark.parametrize("direction", ["port_client_kart_server", "kart_client_port_server"])
def test_each_package_clones_and_pushes_to_the_other_s_server(pair, tmp_path, direction):
    server = "k" if direction == "port_client_kart_server" else "p"
    dst = str(tmp_path / "clone")
    if server == "k":
        clone = ttransport.clone(pair.url["k"], dst, do_checkout=False, device="cpu")
    else:
        clone = jtransport.clone(pair.url["p"], dst, do_checkout=False)
    assert objects(dst) == objects(pair.path[server])
    clone.config.set_many({"user.name": "C", "user.email": "c@example.com"})
    new = edit_commit(JRepo(dst), "points", message="pushed", deletes=[3])
    push = ttransport.push if server == "k" else jtransport.push
    landed = push(TRepo(dst) if server == "k" else JRepo(dst), "origin")
    assert landed == {"refs/heads/main": new}
    assert refs(pair.path[server])["refs/heads/main"] == new


def _contend(pair, tmp_path, *, conflict):
    """Each side: a clone commits, the server's tip moves meanwhile; the
    clone pushes. -> {side: (outcome, server refs)}."""
    out = {}
    for side, tp in (("k", jtransport), ("p", ttransport)):
        dst = str(tmp_path / side / "clone")
        kw = {} if side == "k" else {"device": "cpu"}
        clone = tp.clone(pair.url[side], dst, do_checkout=False, **kw)
        clone.config.set_many({"user.name": "C", "user.email": "c@example.com"})
        edit_commit(JRepo(dst), "points", message="local",
                    updates=[{"fid": 4, "geom": None, "name": "loc", "rating": 2.0}])
        edit_commit(JRepo(pair.path[side]), "points", message="upstream",
                    updates=[{"fid": 4 if conflict else 6, "geom": None, "name": "srv",
                              "rating": 1.0}])
        before = store_snapshot(pair.path[side])
        try:
            result = tp.push(JRepo(dst) if side == "k" else TRepo(dst), "origin")
        except Exception as e:
            result = (type(e).__name__, str(e).replace(pair.url[side].rstrip("/"), "<url>"))
        out[side] = (result, refs(pair.path[side]),
                     store_snapshot(pair.path[side]) == before)
    return out


def test_diverged_push_is_rebased_on_the_server_as_kart_tpu_does(pair, tmp_path):
    got = _contend(pair, tmp_path, conflict=False)
    assert got["p"][:2] == got["k"][:2]
    tip = got["p"][1]["refs/heads/main"]
    assert len(JRepo(pair.path["p"]).odb.read_commit(tip).parents) == 2


def test_conflicting_push_refused_with_kart_tpu_s_report(pair, tmp_path):
    got = _contend(pair, tmp_path, conflict=True)
    assert got["p"] == got["k"]
    assert got["p"][0][0] == "RemoteError" and "1 conflicts" in got["p"][0][1]
    assert got["p"][2]  # the served store is byte-identical


def test_conflict_report_equals_local_merge_dry_run(pair, tmp_path):
    """The report a refused push carries is ``kart merge --dry-run -o json``
    of the same two commits, on each package."""
    from kart_tpu_torch.transport.http import HttpTransportError

    dst = str(tmp_path / "clone")
    clone = ttransport.clone(pair.url["p"], dst, do_checkout=False, device="cpu")
    clone.config.set_many({"user.name": "C", "user.email": "c@example.com"})
    edit_commit(JRepo(dst), "points", message="local",
                updates=[{"fid": 4, "geom": None, "name": "loc", "rating": 2.0}])
    srv_tip = edit_commit(JRepo(pair.path["p"]), "points", message="upstream",
                          updates=[{"fid": 4, "geom": None, "name": "srv", "rating": 1.0}])
    from kart_tpu_torch.transport.protocol import ObjectEnumerator

    net = HttpRemote(pair.url["p"], retry=RetryPolicy(attempts=1))
    trepo = TRepo(dst)
    old = trepo.refs.get("refs/remotes/origin/main")
    with pytest.raises(HttpTransportError) as exc:
        net.receive_pack(ObjectEnumerator(trepo.odb, [trepo.head_commit_oid]),
                         [{"ref": "refs/heads/main", "old": old,
                           "new": trepo.head_commit_oid, "force": False}])
    report = exc.value.conflict_report
    ttransport.fetch(trepo, "origin", device="cpu")
    assert trepo.refs.get("refs/remotes/origin/main") == srv_tip
    rc, out, _ = _port(["-C", dst, "merge", "origin/main", "--dry-run", "-o", "json"])
    assert json.loads(out) == report["merge"]
    rc_k, out_k, _ = _kart(["-C", dst, "merge", "origin/main", "--dry-run", "-o", "json"])
    assert json.loads(out_k) == report["merge"]


@pytest.mark.parametrize("ref", ["config", "HEAD", "refs/heads/a..b", "refs/heads/x.lock"])
def test_receive_pack_rejects_bad_ref_names_equal(pair, ref):
    import io

    tip = JRepo(pair.path["k"]).head_commit_oid
    buf = io.BytesIO()
    write_framed(buf, {"updates": [{"ref": ref, "old": None, "new": tip, "force": False}]}, [])
    got = pair.exchange("/api/v1/receive-pack", method="POST", body=buf.getvalue(),
                        headers={"Content-Type": "application/x-kartpack"})
    _same(got)
    assert got["p"][0] >= 400  # refused (kart_tpu answers some names 500)
    assert refs(pair.path["p"]) == refs(pair.path["k"])


def test_push_to_checked_out_branch_refused_equal(tmp_path):
    pair = _served(tmp_path, deny="refuse")
    out = {}
    for side, tp in (("k", jtransport), ("p", ttransport)):
        dst = str(tmp_path / side / "clone")
        kw = {} if side == "k" else {"device": "cpu"}
        clone = tp.clone(pair.url[side], dst, do_checkout=False, **kw)
        clone.config.set_many({"user.name": "C", "user.email": "c@example.com"})
        edit_commit(JRepo(dst), "points", message="x", deletes=[2])
        with pytest.raises(Exception) as exc:
            tp.push(JRepo(dst) if side == "k" else TRepo(dst), "origin")
        out[side] = (type(exc.value).__name__,
                     str(exc.value).replace(pair.url[side].rstrip("/"), "<url>"), refs(pair.path[side]))
    pair.close()
    assert out["p"] == out["k"] and "checked-out branch" in out["p"][1]


def test_pull_over_http_equal(pair, tmp_path):
    got = {}
    for side, runner in (("k", _kart), ("p", _port)):
        dst = str(tmp_path / side / "clone")
        assert runner(["clone", pair.url[side], dst])[0] == 0
        edit_commit(JRepo(pair.path[side]), "points", message="upstream", deletes=[7])
        rc, out, err = runner(["-C", dst, "pull"])
        got[side] = (rc, out, refs(dst))
    assert got["p"] == got["k"] and got["p"][0] == 0


# --- the server itself ----------------------------------------------------------------

def test_concurrent_identical_clones_walk_once(pair, tmp_path):
    """Two concurrent identical fetches through the port's server: one
    enumeration walk, the second a cache hit (kart_tpu's single-flight)."""
    wants = _wants(pair)
    ttm.enable(metrics=True)
    before = {n: v for n, l, v in ttm.snapshot()["counters"]
              if n.startswith("server.enum_cache.")}
    results = [None, None]

    def go(i):
        dst = TRepo.init_repository(str(tmp_path / f"c{i}"))
        results[i] = HttpRemote(pair.url["p"]).fetch_pack(dst, wants)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    after = {n: v for n, l, v in ttm.snapshot()["counters"]
             if n.startswith("server.enum_cache.")}
    assert results[0] == results[1]
    assert after.get("server.enum_cache.misses", 0) - before.get("server.enum_cache.misses", 0) == 1
    assert after.get("server.enum_cache.hits", 0) - before.get("server.enum_cache.hits", 0) == 1


def test_stats_endpoint_counts_requests(pair):
    http(pair.url["p"], "/api/v1/refs")
    text = http(pair.url["p"], "/api/v1/stats")[2].decode()
    assert 'kart_transport_server_requests_total{verb="ls-refs"}' in text
    doc = json.loads(http(pair.url["p"], "/api/v1/stats?format=json")[2])
    k = json.loads(http(pair.url["k"], "/api/v1/stats?format=json")[2])
    assert set(doc) == set(k)


def test_server_without_card_refuses_to_start(tmp_path, monkeypatch):
    from kart_tpu_torch import runtime

    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    repo, _ = make_imported_repo(tmp_path, n=2)
    with pytest.raises(runtime.DeviceUnavailable):
        make_server(TRepo(repo.workdir))


# --- the A20 refusals ---------------------------------------------------------------

@pytest.mark.parametrize("opt", [["--replica-of", "http://127.0.0.1:1/"],
                                 ["--replica-poll", "1"], ["--replica-max-lag", "1"],
                                 ["--peer-cache", "primary"]],
                         ids=lambda o: o[0])
def test_serve_fleet_options_exit_30(tmp_path, opt):
    repo, _ = make_imported_repo(tmp_path, n=2)
    rc, out, err = _port(["-C", repo.workdir, "serve", "--port", "0", *opt])
    assert rc == NOT_YET_IMPLEMENTED and "Serving" not in out and "not ported" in err


@pytest.mark.parametrize("var", ["KART_REPLICA_OF", "KART_PEER_CACHE"])
def test_fleet_variables_refuse_before_binding(tmp_path, monkeypatch, var):
    repo, _ = make_imported_repo(tmp_path, n=2)
    monkeypatch.setenv(var, "http://127.0.0.1:1/")
    with pytest.raises(NotYetImplemented):
        make_server(TRepo(repo.workdir), device="cpu")
    rc, out, err = _port(["-C", repo.workdir, "serve", "--port", "0"])
    assert rc == NOT_YET_IMPLEMENTED and "not ported" in err


def test_http_remote_fetch_resumes_after_a_kill(pair, tmp_path, monkeypatch):
    """A fetch killed mid-stream with retries on resumes by byte range and
    lands the same objects as an unbroken one."""
    monkeypatch.setenv("KART_TRANSPORT_RETRIES", "3")
    monkeypatch.setenv("KART_FAULTS", "transport.read.frame:4")
    dst = ttransport.clone(pair.url["p"], str(tmp_path / "c"), do_checkout=False,
                           device="cpu")
    assert objects(dst.workdir or dst.gitdir) == objects(pair.path["p"])


def test_unreachable_http_remote_raises_remote_error(tmp_path):
    """What is left behind is what kart_tpu leaves."""
    from kart_tpu.transport.remote import RemoteError as JRemoteError

    with pytest.raises(JRemoteError):
        jtransport.clone("http://127.0.0.1:1/repo", str(tmp_path / "k"))
    with pytest.raises(RemoteError):
        ttransport.clone("http://127.0.0.1:1/repo", str(tmp_path / "p"), device="cpu")
    assert os.listdir(tmp_path / "p") == os.listdir(tmp_path / "k")


def test_kart_tpu_http_client_reads_the_port_s_refs(pair):
    info = JHttpRemote(pair.url["p"], retry=JRetryPolicy(attempts=1)).ls_refs()
    assert info == HttpRemote(pair.url["k"], retry=RetryPolicy(attempts=1)).ls_refs()
