"""The port's ssh lane against kart_tpu's, on the CPU: URL parsing, the
stdio server's frames for the same request bytes (in this process), and
clone, fetch and push through a stub ``KART_SSH`` that runs ``kart
serve-stdio`` locally, with ``KART_SSH_KART`` naming a shim of either
package (the port's with ``--device cpu``), in both directions between the
packages."""

import io
import json
import os
import stat
import sys

import pytest

from helpers import edit_commit, make_imported_repo
from kart_tpu import transport as jtransport
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.transport.stdio import parse_ssh_url as jparse
from kart_tpu.transport.stdio import serve_stdio as jserve_stdio
from kart_tpu_torch import transport as ttransport
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.transport.http import write_framed
from kart_tpu_torch.transport.remote import is_ssh_url
from kart_tpu_torch.transport.stdio import parse_ssh_url, serve_stdio
from torch_serve_helpers import DATE, objects, refs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACEPARENT = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("GIT_AUTHOR_DATE", DATE)
    monkeypatch.setenv("GIT_COMMITTER_DATE", DATE)
    monkeypatch.setenv("KART_TRANSPORT_RETRIES", "1")
    monkeypatch.delenv("KART_FAULTS", raising=False)


URLS = ["ssh://alice@host:2222/srv/repo", "ssh://host/srv/repo", "alice@host:repos/x",
        "host:/abs/path", "/local/path", "./rel:path", "http://h/x", "c:/windows/style",
        "ssh://[::1]:22/r", "ssh://[::1/r", "ssh://-oProxyCommand=x/r", "-oProxyCommand=x:r",
        "host:-r", "ssh://host:abc/r", "ssh://host", "file:///x"]


@pytest.mark.parametrize("url", URLS)
def test_url_parsing_equal(url):
    assert parse_ssh_url(url) == jparse(url)
    assert is_ssh_url(url) == (jparse(url) is not None)


def _install(tmp_path, monkeypatch):
    """A stub ssh that drops the host and runs the command here, and one
    shim a package: ``kart-j`` (kart_tpu's CLI) and ``kart-p`` (the
    port's, on the CPU)."""
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    shims = {"j": "kart_tpu.cli", "p": "kart_tpu_torch --device cpu"}
    for name, module in shims.items():
        shim = bindir / f"kart-{name}"
        shim.write_text(f"#!/bin/sh\nPYTHONPATH={ROOT} JAX_PLATFORMS=cpu "
                        f'exec {sys.executable} -m {module} "$@"\n')
        shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    ssh = bindir / "fake-ssh"
    ssh.write_text('#!/bin/sh\nshift\nexec sh -c "$*"\n')
    ssh.chmod(ssh.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("KART_SSH", str(ssh))
    return {name: str(bindir / f"kart-{name}") for name in shims}


@pytest.fixture()
def served(tmp_path, monkeypatch):
    """A two-commit points repository and the shims."""
    shims = _install(tmp_path, monkeypatch)
    (tmp_path / "server").mkdir()
    repo, ds_path = make_imported_repo(tmp_path / "server", n=12)
    edit_commit(repo, ds_path, message="second commit",
                updates=[{"fid": 1, "geom": None, "name": "renamed", "rating": 9.0}])
    repo.config["receive.denyCurrentBranch"] = "ignore"
    return repo.workdir, shims


# --- the stdio server's frames, in this process ---------------------------------------

def _frames(requests):
    buf = io.BytesIO()
    for header in requests:
        write_framed(buf, {**header, "traceparent": TRACEPARENT}, [])
    return buf.getvalue()


def _serve_both(path, requests, monkeypatch):
    out = {}
    for side, fn, kw in (("k", jserve_stdio, {}), ("p", serve_stdio, {"device": "cpu"})):
        repo = (JRepo if side == "k" else TRepo)(path)
        w = io.BytesIO()
        fn(repo, io.BytesIO(_frames(requests)), w, **kw)
        out[side] = w.getvalue()
    return out


@pytest.mark.parametrize("case", ["refs", "fetch", "fetch_filtered", "fetch_shallow",
                                  "blobs", "unknown_op", "bad_ref_push"])
def test_stdio_frames_equal(served, monkeypatch, case):
    path, _ = served
    tip = JRepo(path).head_commit_oid
    requests = {
        "refs": [{"op": "refs"}],
        "fetch": [{"op": "fetch-pack", "wants": [tip]}],
        "fetch_filtered": [{"op": "fetch-pack", "wants": [tip], "filter": "100,-42,105.5,-39"}],
        "fetch_shallow": [{"op": "fetch-pack", "wants": [tip], "depth": 1}],
        "blobs": [{"op": "fetch-blobs", "oids": ["0" * 40, tip]}],
        "unknown_op": [{"op": "nosuch"}, {"op": "refs"}],
        "bad_ref_push": [{"op": "receive-pack", "updates": [
            {"ref": "config", "old": None, "new": tip, "force": False}]}],
    }[case]
    got = _serve_both(path, requests, monkeypatch)
    assert got["p"] == got["k"] and len(got["p"]) > 8


def test_stdio_events_op_is_refused_as_not_ported(served):
    path, _ = served
    w = io.BytesIO()
    serve_stdio(TRepo(path), io.BytesIO(_frames([{"op": "events"}])), w, device="cpu")
    n = int.from_bytes(w.getvalue()[:8], "big")
    assert "not ported" in json.loads(w.getvalue()[8 : 8 + n])["error"]


# --- clone, fetch and push through the stub ssh -------------------------------------------

@pytest.mark.parametrize("client,server", [("p", "p"), ("p", "j"), ("j", "p")],
                         ids=["port_to_port", "port_to_kart", "kart_to_port"])
def test_clone_push_fetch_over_ssh(served, tmp_path, monkeypatch, client, server):
    """A clone over ssh holds the source's objects and a push lands: the
    port's client against each package's server, and kart_tpu's client
    against the port's."""
    path, shims = served
    monkeypatch.setenv("KART_SSH_KART", shims[server])
    url = f"testhost:{path}"
    tp, repo_cls, kw = ((ttransport, TRepo, {"device": "cpu"}) if client == "p"
                        else (jtransport, JRepo, {}))
    a = tp.clone(url, str(tmp_path / "a"), do_checkout=False, **kw)
    assert objects(str(tmp_path / "a")) == objects(path)
    a.config.set_many({"user.name": "C", "user.email": "c@example.com"})
    new = edit_commit(JRepo(str(tmp_path / "a")), "points", message="pushed", deletes=[3])
    assert tp.push(repo_cls(str(tmp_path / "a")), "origin") == {"refs/heads/main": new}
    assert refs(path)["refs/heads/main"] == new


def test_ssh_clone_equals_kart_tpu_s(served, tmp_path, monkeypatch):
    """Filtered, each package against its own server: the same refs and
    objects, the remote a promisor in both."""
    path, shims = served
    spec = "EPSG:4326;POLYGON((100 -42, 105.5 -42, 105.5 -39, 100 -39, 100 -42))"
    from kart_tpu.spatial_filter import ResolvedSpatialFilterSpec as JSpec
    from kart_tpu_torch.spatial_filter import ResolvedSpatialFilterSpec as TSpec

    monkeypatch.setenv("KART_SSH_KART", shims["j"])
    jtransport.clone(f"testhost:{path}", str(tmp_path / "k"), do_checkout=False,
                     spatial_filter_spec=JSpec.from_spec_string(spec))
    monkeypatch.setenv("KART_SSH_KART", shims["p"])
    ttransport.clone(f"testhost:{path}", str(tmp_path / "p"), do_checkout=False,
                     spatial_filter_spec=TSpec.from_spec_string(spec), device="cpu")
    assert refs(str(tmp_path / "p")) == refs(str(tmp_path / "k"))
    assert objects(str(tmp_path / "p")) == objects(str(tmp_path / "k"))
    assert objects(str(tmp_path / "p")) < objects(path)
