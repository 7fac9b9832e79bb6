"""Shared pieces of the serving tests: one source repository served by each
package (kart_tpu's ``make_server`` on ``<root>/k``, the port's with
``device="cpu"`` on ``<root>/p``), raw HTTP exchanges with both, and the
store and ref snapshots the kill matrices compare."""

import hashlib
import json
import os
import shutil
import threading
from urllib.error import HTTPError
from urllib.request import Request, urlopen

from kart_tpu.transport.http import make_server as jmake_server
from kart_tpu_torch import telemetry as ttm
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.transport.http import make_server as tmake_server

DATE = "1700000000 +0000"

#: response headers whose values must agree between the packages
HEADERS = ("Content-Type", "ETag", "Retry-After", "Content-Range", "Accept-Ranges",
           "Cache-Control", "Vary")


class ServedPair:
    """``src`` copied to ``<root>/k`` and ``<root>/p``, each served by its
    package in a thread of this process. Closing puts the port's telemetry
    back off when it was off before."""

    def __init__(self, src, root, *, bare_name="repo"):
        from kart_tpu.core.repo import KartRepo as JRepo

        self.root = {"k": os.path.join(root, "k"), "p": os.path.join(root, "p")}
        self.path = {}
        for side, r in self.root.items():
            os.makedirs(r, exist_ok=True)
            self.path[side] = os.path.join(r, bare_name)
            shutil.copytree(src, self.path[side], symlinks=True)
        self.telemetry_was_on = ttm.metrics_enabled() or ttm.tracing_enabled()
        self.servers = {"k": jmake_server(JRepo(self.path["k"])),
                        "p": tmake_server(TRepo(self.path["p"]), device="cpu")}
        self.url = {}
        for side, server in self.servers.items():
            threading.Thread(target=server.serve_forever, daemon=True).start()
            self.url[side] = f"http://127.0.0.1:{server.server_address[1]}/"

    def close(self):
        for server in self.servers.values():
            server.shutdown()
            server.server_close()
        if not self.telemetry_was_on:  # the port's make_server turned metrics on
            ttm.reset()

    def exchange(self, path, **kw):
        """The same request to both servers -> {side: (status, headers, body)}."""
        return {side: http(self.url[side], path, **kw) for side in ("k", "p")}


def http(base, path, *, method="GET", body=None, headers=None):
    """One request -> (status, {header: value} of :data:`HEADERS`, body)."""
    data = json.dumps(body).encode() if isinstance(body, (dict, list)) else body
    req = Request(base.rstrip("/") + path, data=data, headers=dict(headers or {}),
                  method=method)
    try:
        with urlopen(req, timeout=60) as resp:
            status, hdrs, raw = resp.status, resp.headers, resp.read()
    except HTTPError as e:
        status, hdrs, raw = e.code, e.headers, e.read()
    return status, {h: hdrs.get(h) for h in HEADERS if hdrs.get(h) is not None}, raw


def store_snapshot(path):
    """{relpath: sha256} of every file under a repository's objects dir."""
    from kart_tpu.core.repo import KartRepo as JRepo

    objects_dir = JRepo(path).odb.objects_dir
    snap = {}
    for dirpath, _, names in os.walk(objects_dir):
        for fn in names:
            p = os.path.join(dirpath, fn)
            with open(p, "rb") as f:
                snap[os.path.relpath(p, objects_dir)] = hashlib.sha256(f.read()).hexdigest()
    return snap


def refs(path):
    """{ref: oid} of a repository, read by kart_tpu for either package's."""
    from kart_tpu.core.repo import KartRepo as JRepo

    return dict(JRepo(path).refs.iter_refs("refs/"))


def objects(path):
    from kart_tpu.core.repo import KartRepo as JRepo

    return set(JRepo(path).odb.iter_oids())


def gitdir_files(path):
    """Every file of a repository's gitdir outside ``objects/`` (sidecars,
    annotations, refs, logs) but the push lock: what a refused push must
    not add."""
    from kart_tpu.core.repo import KartRepo as JRepo

    gitdir = JRepo(path).gitdir
    out = set()
    for dirpath, dirs, names in os.walk(gitdir):
        dirs[:] = [d for d in dirs if os.path.join(dirpath, d) != os.path.join(gitdir, "objects")]
        out.update(os.path.relpath(os.path.join(dirpath, n), gitdir) for n in names)
    out.discard(".push-lock")
    return out
