"""The query and tile endpoints of the port's server against kart_tpu's, on
the CPU, with their caches: the same request to each package's server
(each on its own copy of kart_tpu's spatial synth) gives the same status,
ETag, caching headers and bytes; a repeated request is a cache hit that
runs nothing; ``If-None-Match`` is answered 304; concurrent distinct
requests equal the same requests one at a time, and concurrent identical
tile requests fill the cache once."""

import json
import threading

import pytest

from kart_tpu_torch import telemetry as ttm
from torch_serve_helpers import ServedPair, http


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from kart_tpu.synth import synth_repo

    root = tmp_path_factory.mktemp("serving")
    repo, info = synth_repo(str(root / "synth"), 5000, spatial=True, blobs="changed")
    pair = ServedPair(repo.workdir, str(root / "served"))
    yield pair, info
    pair.close()


@pytest.fixture(scope="module")
def served_blobs(tmp_path_factory):
    from kart_tpu.synth import synth_repo

    root = tmp_path_factory.mktemp("serving-blobs")
    repo, info = synth_repo(str(root / "synth"), 300, blobs="real")
    pair = ServedPair(repo.workdir, str(root / "served"))
    yield pair, info
    pair.close()


def _counter(name):
    return sum(v for n, _l, v in ttm.snapshot()["counters"] if n == name)


QUERIES = {
    "count": "",
    "bbox": "&bbox=-60,-30,60,30",
    "bbox_approx": "&bbox=-60,-30,60,30&approx=1",
    "bbox_union": "&output=bbox",
    "bbox_json_page": "&bbox=-10,-10,10,10&output=json&page=1&page_size=5",
    "wrap": "&bbox=170,-20,-170,20",
    "join": "&intersects={base}:synth",
    "join_bbox": "&intersects={base}:synth&bbox=-30,-30,30,30",
    "join_json": "&intersects={base}:synth&output=json&page_size=7",
    "join_part": "&intersects={base}:synth&part=0:2048",
    "bad_part": "&intersects={base}:synth&part=x",
    "scan_part": "&part=0:10",
    "bad_output": "&output=nosuch",
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_endpoint_equal(served, name):
    pair, info = served
    tip = info["edit_commit"]
    path = f"/api/v1/query?ref={tip}&dataset=synth" + QUERIES[name].format(
        base=info["base_commit"])
    got = pair.exchange(path)
    assert got["p"] == got["k"]
    if got["p"][0] == 200:
        doc = json.loads(got["p"][2])
        assert doc["commit"] == tip


@pytest.mark.parametrize("where", ["fid < 16777300", "rating >= 42", "name = 'x'"])
def test_query_where_equal(served_blobs, where):
    from urllib.parse import quote

    pair, info = served_blobs
    path = (f"/api/v1/query?ref=HEAD&dataset=synth&where={quote(where)}&output=json"
            "&page_size=20")
    got = pair.exchange(path)
    assert got["p"] == got["k"]


def test_query_cache_hit_and_304(served):
    pair, info = served
    path = f"/api/v1/query?ref={info['base_commit']}&dataset=synth&bbox=-5,-5,5,5"
    ttm.enable(metrics=True)
    first = http(pair.url["p"], path)
    hits = _counter("query.cache.hits")
    scans = _counter("query.scans")
    second = http(pair.url["p"], path)
    assert second == first
    assert _counter("query.cache.hits") == hits + 1 and _counter("query.scans") == scans
    got = pair.exchange(path, headers={"If-None-Match": first[1]["ETag"]})
    assert got["p"] == got["k"] and got["p"][0] == 304 and got["p"][2] == b""


def test_concurrent_distinct_queries_equal_sequential(served):
    pair, info = served
    paths = [f"/api/v1/query?ref={info['edit_commit']}&dataset=synth&bbox={b}"
             for b in ("-90,-45,0,0", "0,0,90,45", "-40,0,40,45")] + [
        f"/api/v1/query?ref={info['edit_commit']}&dataset=synth"
        f"&intersects={info['base_commit']}:synth&bbox=-20,-20,20,20"]
    out = [None] * len(paths)

    def go(i):
        out[i] = http(pair.url["p"], paths[i] + "&page_size=3")

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(paths))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert out == [http(pair.url["k"], p + "&page_size=3") for p in paths]


TILES = ["0/0/0", "1/0/0", "2/1/1", "3/4/2", "4/8/5", "4/15/15", "5/40/0", "9/0/0"]


@pytest.mark.parametrize("zxy", TILES)
@pytest.mark.parametrize("layers", ["", "?layers=bin,ktb2", "?layers=mvt", "?format=mvt"])
def test_tile_endpoint_equal(served, zxy, layers):
    pair, info = served
    got = pair.exchange(f"/api/v1/tiles/{info['edit_commit']}/synth/{zxy}{layers}")
    assert got["p"] == got["k"]


@pytest.mark.parametrize("case", ["accept_mvt", "accept_mvt_q0", "bad_layer", "not_found_ds",
                                  "branch_ref", "bad_zoom", "too_large"])
def test_tile_negotiation_and_errors_equal(served, case, monkeypatch):
    pair, info = served
    path = f"/api/v1/tiles/{info['edit_commit']}/synth/2/1/1"
    headers = {}
    if case == "accept_mvt":
        headers = {"Accept": "application/vnd.mapbox-vector-tile"}
    elif case == "accept_mvt_q0":
        headers = {"Accept": "application/vnd.mapbox-vector-tile;q=0"}
    elif case == "bad_layer":
        path += "?layers=nosuch"
    elif case == "not_found_ds":
        path = path.replace("/synth/", "/nosuch/")
    elif case == "branch_ref":
        path = "/api/v1/tiles/refs%2Fheads%2Fmain/synth/2/1/1"
    elif case == "bad_zoom":
        path = path.replace("/2/1/1", "/2/9/9")
    elif case == "too_large":
        monkeypatch.setenv("KART_TILE_MAX_FEATURES", "10")
        path = path.replace("/2/1/1", "/0/0/0") + "?layers=bin"
    got = pair.exchange(path, headers=headers)
    assert got["p"] == got["k"]


def test_tile_cache_hit_304_and_single_fill(served):
    pair, info = served
    path = f"/api/v1/tiles/{info['base_commit']}/synth/3/3/3?layers=ktb2"
    ttm.enable(metrics=True)
    misses = _counter("tiles.cache.misses")
    out = [None] * 8

    def go(i):
        out[i] = http(pair.url["p"], path)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(o == out[0] for o in out) and out[0][0] == 200
    assert _counter("tiles.cache.misses") == misses + 1
    assert out[0] == http(pair.url["k"], path)
    got = pair.exchange(path, headers={"If-None-Match": f'W/{out[0][1]["ETag"]}, "x"'})
    assert got["p"] == got["k"] and got["p"][0] == 304


def test_served_tile_equals_the_port_s_export(served, tmp_path):
    """A served tile's bytes are the file ``kart export tiles`` writes for
    the same address (the port's CLI on the CPU)."""
    import contextlib
    import io
    import os

    from kart_tpu_torch.cli import main

    pair, info = served
    out = str(tmp_path / "tiles")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = main(["--device", "cpu", "-C", pair.path["p"], "export", "tiles", "--layers",
                   "bin,ktb2,mvt,geom", "--zoom", "0-2", "--workers", "1", "-o", out,
                   "--dataset", "synth", info["edit_commit"]])
    assert rc == 0
    compared = 0
    for z, x, y in ((0, 0, 0), (1, 1, 0), (1, 0, 1), (2, 1, 1), (2, 2, 1)):
        f = os.path.join(out, str(z), str(x), f"{y}.ktile")
        if not os.path.exists(f):
            continue
        compared += 1
        with open(f, "rb") as fh:
            want = fh.read()
        got = http(pair.url["p"], f"/api/v1/tiles/{info['edit_commit']}/synth/{z}/{x}/{y}"
                                  "?layers=bin,ktb2,mvt,geom")
        assert got[0] == 200 and got[2] == want
    assert compared >= 3
