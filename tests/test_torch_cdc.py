"""The changed-block CDC (``kart_tpu_torch.events.cdc``) and the sidecar
derivation under it against kart_tpu's ``events/cdc.py``: the tile cover
(ranges and tiles, the cap's flag) on seeded envelopes and on the edge
rows (poles, the Web Mercator clamp, the seam, -0.0, wraps, degenerate and
full-width rectangles, NaN, infinities); the tree delta; ``dirty_tiles``
summaries (the same JSON) on random edits, null, polar and anti-meridian
geometries, a dataset's addition and deletion, identical trees,
truncation, a created and a deleted ref, and a point layer's history
without sidecars; the derived sidecar byte for byte kart_tpu's, and its
key and oid columns equal to a full ``build_sidecar`` of the same tree;
and no card without ``device="cpu"``. Each package runs on its own copy of
a repository (both write sidecars), with both packages' tile source caches
dropped."""

import json
import os
import random
import shutil

import numpy as np
import pytest
import torch

from helpers import create_points_gpkg, edit_commit, gpkg_point, make_imported_repo
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.core.tree_builder import TreeBuilder as JTreeBuilder
from kart_tpu.diff import sidecar as jsidecar
from kart_tpu.events import cdc as jcdc
from kart_tpu.geometry import Geometry as JGeometry
from kart_tpu.synth import commit_feature_edits as jcommit_feature_edits
from kart_tpu.synth import synth_repo as jsynth_repo
from kart_tpu.tiles.source import drop_sources as jdrop_sources
from kart_tpu_torch import runtime
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.diff import sidecar
from kart_tpu_torch.events import cdc
from kart_tpu_torch.synth import commit_point_edits, synth_repo
from kart_tpu_torch.tiles.source import drop_sources

CPU = "cpu"
INF, NAN = float("inf"), float("nan")
MERC_CLAMP = 85.0511287798066

#: the rows where the cover math is easiest to get wrong
EDGE_ENVELOPES = [
    (-180.0, -10.0, -170.0, 10.0), (170.0, -10.0, 180.0, 10.0), (0.0, 0.0, 45.0, 45.0),
    (-45.0, -45.0, 0.0, 0.0), (175.0, -5.0, -175.0, 5.0), (10.0, 20.0, 20.0, 10.0),
    (3.0, 86.0, 4.0, 89.0), (-3.0, -89.0, 3.0, -86.0), (7.5, 7.5, 7.5, 7.5),
    (0.0, 90.0, 1.0, 90.0), (0.0, -90.0, 1.0, -90.0), (-10.0, MERC_CLAMP, 10.0, MERC_CLAMP),
    (5.0, -85.06, 6.0, -MERC_CLAMP), (-180.0, -90.0, 180.0, 90.0), (-200.0, 0.0, 200.0, 1.0),
    (-180.0, 0.0, 180.0, 1.0), (-0.0, -0.0, -0.0, -0.0), (0.0, -0.0, -0.0, 0.0),
    (180.0, 1.0, 180.0, 2.0), (-180.0, 1.0, -180.0, 2.0), (180.0, 0.0, -180.0, 1.0),
    (179.9999, 0.0, -179.9999, 1.0), (190.0, 0.0, 200.0, 1.0), (-190.0, 0.0, -185.0, 1.0),
    (350.0, 0.0, 10.0, 1.0), (-540.0, -3.0, -530.0, 3.0), (0.0, 100.0, 1.0, 120.0),
    (0.0, -120.0, 1.0, -100.0), (NAN, 0.0, 1.0, 1.0), (0.0, NAN, 1.0, 1.0),
    (0.0, 0.0, 1.0, NAN), (-INF, 0.0, 1.0, 1.0), (0.0, -INF, 1.0, INF),
    (0.0, 0.0, INF, 1.0), (-INF, -INF, INF, INF), (0.0, -INF, 1.0, -INF),
    (0.0, INF, 1.0, INF), (-1e-300, -1e-300, 1e-300, 1e-300),
]


def _seeded_envelopes(seed, n=400):
    """Random wsen rows, a third snapped to the tile grid of zoom 3 or 6
    (edges that touch), some wrapping, degenerate or past the world."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(-200.0, 200.0, n)
    e = w + rng.uniform(-40.0, 80.0, n)
    s = rng.uniform(-95.0, 95.0, n)
    nl = s + rng.uniform(-5.0, 40.0, n)
    env = np.stack([w, s, e, nl], axis=1)
    snap = rng.random(n) < 0.35
    step = 360.0 / np.where(rng.random(n) < 0.5, 8, 64)
    env[snap, 0] = np.round(env[snap, 0] / step[snap]) * step[snap]
    env[snap, 2] = np.round(env[snap, 2] / step[snap]) * step[snap]
    return env


def _same_ranges(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 4
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)


ENVELOPE_SETS = {
    "edges": np.asarray(EDGE_ENVELOPES, dtype=np.float64),
    **{f"seeded{s}": _seeded_envelopes(s) for s in range(4)},
    "empty": np.zeros((0, 4)),
    "all_nan": np.full((3, 4), NAN),
}


@pytest.mark.parametrize("z", [0, 1, 2, 3, 5, 8, 12])
@pytest.mark.parametrize("name", list(ENVELOPE_SETS))
def test_tile_cover_ranges_match_kart_tpu(name, z):
    env = ENVELOPE_SETS[name]
    _same_ranges(cdc.tile_cover_ranges(z, env), jcdc.tile_cover_ranges(z, env))
    for row in env:  # each row alone, so that one row's error cannot hide
        _same_ranges(cdc.tile_cover_ranges(z, row), jcdc.tile_cover_ranges(z, row))


@pytest.mark.parametrize("cap", [None, 0, 1, 7, 64, 4096])
@pytest.mark.parametrize("z", [0, 2, 4, 8])
@pytest.mark.parametrize("name", list(ENVELOPE_SETS))
def test_tiles_for_envelopes_match_kart_tpu(name, z, cap):
    env = ENVELOPE_SETS[name]
    got, want = cdc.tiles_for_envelopes(z, env, cap), jcdc.tiles_for_envelopes(z, env, cap)
    assert np.array_equal(got[0], want[0]) and got[0].dtype == want[0].dtype
    assert got[1:] == want[1:]


def test_tiles_for_envelopes_cap_flags_incomplete_enumeration():
    """Overlapping envelopes de-duplicate below the cap while a range was
    never reached: capped on both packages."""
    same = np.tile(np.array([[10.0, 10.0, 10.01, 10.01]]), (5000, 1))
    far = np.array([[120.0, -40.0, 120.01, -39.99]])
    env = np.concatenate([same, far])
    got, want = cdc.tiles_for_envelopes(8, env, cap=4096), jcdc.tiles_for_envelopes(
        8, env, cap=4096)
    assert got[2] is want[2] is True and got[1] == want[1] == 1
    assert np.array_equal(got[0], want[0])
    assert cdc.tiles_for_envelopes(8, env)[1] == 2


def _both(path, tmp_path, tag=""):
    """Two copies of a repository: (kart_tpu's, the port's), with no tile
    source cached for either."""
    j = str(shutil.copytree(path, tmp_path / f"j{tag}"))
    t = str(shutil.copytree(path, tmp_path / f"t{tag}"))
    jdrop_sources()
    drop_sources()
    return JRepo(j), TRepo(t)


def _summaries_equal(jrepo, trepo, old, new, **kw):
    want = jcdc.dirty_tiles(jrepo, old, new, **kw)
    got = cdc.dirty_tiles(trepo, old, new, device=CPU, **kw)
    assert json.dumps(got) == json.dumps(want)
    return got


def gpoint(x, y):
    return JGeometry(gpkg_point(x, y))


def _random_edit_history(base, rounds=4):
    """The imported points layer and ``rounds`` random edits (inserts,
    moves, attribute-only updates, deletes). -> (path, commits)."""
    repo, ds_path = make_imported_repo(base, n=40)
    rng = random.Random(1234)
    live, next_fid = list(range(1, 41)), 1000
    commits = [repo.head_commit_oid]
    for i in range(rounds):
        ds = repo.structure("HEAD").datasets[ds_path]
        inserts = []
        for _ in range(rng.randrange(0, 3)):
            inserts.append({"fid": next_fid, "geom": gpoint(rng.uniform(100, 141),
                                                            rng.uniform(-46, -34)),
                            "name": f"new{next_fid}", "rating": rng.random()})
            next_fid += 1
        updates = []
        for fid in rng.sample(live, rng.randrange(1, 4)):
            geom = None if rng.random() < 0.4 else gpoint(rng.uniform(100, 141),
                                                          rng.uniform(-46, -34))
            updates.append({**ds.get_feature([fid]), "geom": geom, "name": f"u{fid}.{i}"})
        deletes = rng.sample([f for f in live if f not in {u["fid"] for u in updates}], 1)
        live = [f for f in live if f not in deletes] + [f["fid"] for f in inserts]
        commits.append(edit_commit(repo, ds_path, inserts=inserts, updates=updates,
                                   deletes=deletes, message=f"random edit {i}"))
    return str(repo.workdir), commits


@pytest.fixture(scope="module")
def random_history(tmp_path_factory):
    base = tmp_path_factory.mktemp("cdc_random")
    return _random_edit_history(base)


@pytest.mark.parametrize("zooms", [tuple(range(0, 6)), cdc.DEFAULT_EVENT_ZOOMS],
                         ids=["z0-5", "default"])
def test_dirty_tiles_random_edits_match_kart_tpu(random_history, tmp_path, zooms):
    path, commits = random_history
    jrepo, trepo = _both(path, tmp_path)
    for old, new in zip(commits, commits[1:]):
        got = _summaries_equal(jrepo, trepo, old, new, zooms=zooms)
        assert got["points"]["tile_count"] or got["points"]["truncated"]
    _summaries_equal(jrepo, trepo, commits[0], commits[-1], zooms=zooms)
    _summaries_equal(jrepo, trepo, commits[-1], commits[0], zooms=zooms)


@pytest.mark.parametrize("max_tiles", [0, 3, 20, 4096, 10**6])
def test_dirty_tiles_truncation_matches_kart_tpu(random_history, tmp_path, max_tiles):
    """The history moves rows to NULL geometries (the whole world: every
    tile of zooms 0-8, 87,381 of them) and back."""
    path, commits = random_history
    jrepo, trepo = _both(path, tmp_path)
    got = _summaries_equal(jrepo, trepo, commits[0], commits[-1], max_tiles=max_tiles)
    assert got["points"]["truncated"] == (max_tiles < 10**6)
    assert got["points"]["bbox"] is not None


def test_dirty_tiles_null_polar_antimeridian_match_kart_tpu(tmp_path):
    (tmp_path / "src").mkdir()
    repo, ds_path = make_imported_repo(tmp_path / "src", n=6)
    commits = [repo.head_commit_oid]
    for i, step in enumerate([
        dict(inserts=[{"fid": 900, "geom": None, "name": "null", "rating": 0.1}]),
        dict(inserts=[{"fid": 901, "geom": gpoint(12.0, 88.5), "name": "polar", "rating": 0.2},
                      {"fid": 902, "geom": gpoint(179.999, -30.0), "name": "am",
                       "rating": 0.3},
                      {"fid": 903, "geom": gpoint(-180.0, -90.0), "name": "corner",
                       "rating": 0.5},
                      {"fid": 904, "geom": gpoint(180.0, 90.0), "name": "corner2",
                       "rating": 0.6}]),
        dict(updates=[{"fid": 900, "geom": None, "name": "null2", "rating": 0.4}]),
        dict(updates=[{"fid": 902, "geom": gpoint(-179.999, -30.0), "name": "across",
                       "rating": 0.3}]),
        dict(deletes=[901]),
    ]):
        commits.append(edit_commit(repo, ds_path, message=f"edge {i}", **step))
    jrepo, trepo = _both(str(repo.workdir), tmp_path)
    for old, new in zip(commits, commits[1:]):
        _summaries_equal(jrepo, trepo, old, new, zooms=tuple(range(0, 4)))
        _summaries_equal(jrepo, trepo, old, new)


def test_dirty_tiles_dataset_add_delete_and_refs_match_kart_tpu(tmp_path):
    from kart_tpu.importer import ImportSource
    from kart_tpu.importer.importer import import_sources

    (tmp_path / "src").mkdir()
    repo, ds_path = make_imported_repo(tmp_path / "src", n=8)
    first = repo.head_commit_oid
    import_sources(repo, ImportSource.open(
        create_points_gpkg(str(tmp_path / "second.gpkg"), n=5, table="second")))
    added = repo.head_commit_oid
    tb = JTreeBuilder(repo.odb, repo.odb.read_commit(added).tree)
    tb.remove("second")
    deleted = repo.create_commit("HEAD", tb.flush(), "drop second", [added])
    jrepo, trepo = _both(str(repo.workdir), tmp_path)
    assert cdc.dirty_tiles(trepo, added, added, device=CPU) == {}
    for old, new in ((first, added), (added, deleted), (first, deleted), (None, added),
                     (added, None), (deleted, added), (None, None), (added, added)):
        _summaries_equal(jrepo, trepo, old, new)
    got = _summaries_equal(jrepo, trepo, first, added)
    assert list(got) == ["second"] and got["second"]["changed"] == {"inserts": 5}


def test_dirty_tiles_without_a_card_raises(random_history, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, commits = random_history
    with pytest.raises(runtime.DeviceUnavailable):
        cdc.dirty_tiles(TRepo(path), commits[0], commits[1])
    with pytest.raises(runtime.DeviceUnavailable):
        cdc.dirty_tiles(TRepo(path), commits[1], commits[1], device="cuda")


@pytest.mark.parametrize("pair", [(0, 1), (0, 4), (3, 1), (2, 2)])
def test_tree_delta_matches_kart_tpu(random_history, pair):
    path, commits = random_history
    jrepo, trepo = JRepo(path), TRepo(path)
    trees = [jrepo.structure(c).datasets["points"].feature_tree.oid for c in commits]
    a, b = trees[pair[0]], trees[pair[1]]
    got = cdc._tree_delta(trepo.odb, a, b)
    assert got == jcdc._tree_delta(jrepo.odb, a, b)
    assert bool(got[0] or got[1]) == (a != b)
    assert cdc._tree_delta(trepo.odb, None, a) == jcdc._tree_delta(jrepo.odb, None, a)
    with pytest.raises(cdc._DeltaUnavailable):
        cdc._tree_delta(trepo.odb, a, "f" * 40)


# --- the derived sidecar on a point layer with envelope columns ---------------------------

SYNTH_N = 5000


def _kart_tpu_pushed_history(path):
    """kart_tpu's spatial synth, then two commits by kart_tpu's own
    writer (which derives each sidecar, envelopes and vertices included):
    moves of rows with blobs, inserts, deletes. -> (commits, the derived
    files' bytes by tree oid)."""
    repo, info = jsynth_repo(path, SYNTH_N, blobs="changed", seed=2, spatial=True)
    ds = repo.structure("HEAD").datasets["synth"]
    edited = (1 << 24) + np.random.default_rng(3).choice(SYNTH_N, SYNTH_N // 100,
                                                          replace=False)
    edited = sorted(int(p) for p in edited)
    commits = [info["base_commit"], info["edit_commit"]]
    for i in range(2):
        moves = [{**ds.get_feature([pk]), "geom": gpoint(-179.5 + 3 * k, 89.9 - 2 * k)}
                 for k, pk in enumerate(edited[10 * i: 10 * i + 6])]
        moves.append({**ds.get_feature([edited[10 * i + 6]]), "geom": None})
        inserts = [{"fid": (1 << 25) + 10 * i + k, "geom": gpoint(179.9, -89.0 + k),
                    "rating": 1.0} for k in range(3)]
        commits.append(jcommit_feature_edits(repo, "synth", updates=moves, inserts=inserts,
                                             deletes=edited[10 * i + 7: 10 * i + 9],
                                             message=f"pushed {i}"))
        ds = repo.structure("HEAD").datasets["synth"]
    files = {}
    for c in commits[2:]:
        tree = repo.structure(c).datasets["synth"].feature_tree.oid
        with open(jsidecar.sidecar_file(repo, tree), "rb") as f:
            files[tree] = f.read()
        os.remove(jsidecar.sidecar_file(repo, tree))  # as a pushed tip arrives
    return commits, files


def _sidecar_bytes(repo, commit):
    tree = repo.structure(commit).datasets["synth"].feature_tree.oid
    with open(sidecar.sidecar_file(repo, tree), "rb") as f:
        return tree, f.read()


def test_derived_sidecar_matches_kart_tpu(tmp_path):
    commits, committed = _kart_tpu_pushed_history(str(tmp_path / "src"))
    jrepo, trepo = _both(str(tmp_path / "src"), tmp_path)
    for old, new in zip(commits[1:], commits[2:]):
        got = _summaries_equal(jrepo, trepo, old, new)
        assert got["synth"]["changed"] == {"inserts": 3, "updates": 7, "deletes": 2}
        tree, data = _sidecar_bytes(trepo, new)
        assert data == _sidecar_bytes(jrepo, new)[1]
        ds = trepo.structure(new).datasets["synth"]
        derived = sidecar.load_block(trepo, ds)
        assert derived.envelopes is not None and derived.vertex_column() is None
        # against the commit's own derivation (which also carried vertices)
        # and a full walk of the tree
        ref = sidecar.load_block_file(_write(tmp_path / f"{tree}.c", committed[tree]))
        assert np.array_equal(derived.envelopes, ref.envelopes)
        os.rename(sidecar.sidecar_file(trepo, tree), str(tmp_path / "derived"))
        built = sidecar.build_sidecar(trepo, ds)
        for col in ("keys", "oids"):
            assert np.array_equal(getattr(derived, col)[: derived.count],
                                  getattr(built, col)[: built.count])
            assert np.array_equal(getattr(ref, col)[: ref.count],
                                  getattr(built, col)[: built.count])
        os.replace(str(tmp_path / "derived"), sidecar.sidecar_file(trepo, tree))
    drop_sources()
    _summaries_equal(jrepo, trepo, commits[1], commits[-1], max_tiles=50)


def _write(path, data):
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


def test_derive_sidecar_writes_kart_tpu_s_bytes(tmp_path):
    """derive_sidecar itself: removed keys, an added key that overrides a
    removal, new keys past the end, envelopes carried over; no vertex
    column."""
    jrepo, _ = jsynth_repo(str(tmp_path / "src"), 3000, blobs="changed", seed=9, spatial=True)
    ds = jrepo.structure("HEAD").datasets["synth"]
    trepo = TRepo(str(tmp_path / "src"))
    base = 1 << 24
    removed = [base + 5, base + 17, base + 2999]
    added = {base + 17: "ab" * 20, base + 4000: "cd" * 20, base + 3500: "ef" * 20}
    envs = {k: (1.5, -2.0, 3.25, 4.0) for k in added}
    jblock = jsidecar.load_block(jrepo, ds, pad=False)
    tblock = sidecar.load_block(trepo, trepo.structure("HEAD").datasets["synth"])
    want = jsidecar.derive_sidecar(jrepo, jblock, "1" * 40, removed, added, envs)
    with open(want, "rb") as f:
        want_bytes = f.read()
    os.remove(want)
    got = sidecar.derive_sidecar(trepo, tblock, "1" * 40, removed, added, envs)
    with open(got, "rb") as f:
        assert f.read() == want_bytes
    assert b'"geom_bytes"' not in want_bytes and b'"envelope_bytes": 0' not in want_bytes


# --- a point layer's history as chip_smoke.py's H0-H1 build it ----------------------------

def _point_history(path, n=20_000, commits=3, seed=5):
    """The port's spatial synth, then ``commits`` commits of
    :func:`commit_point_edits`, each moving 0.1% of the rows, deleting
    0.01% and inserting 0.01% past the max pk, one onto the poles and
    across the anti-meridian. -> (repo, [edit commit, ...], truths)."""
    repo, info = synth_repo(path, n, seed=seed, blobs="changed", spatial=True)
    rng = np.random.default_rng(seed)
    live = np.arange(1 << 24, (1 << 24) + n, dtype=np.int64)
    next_pk = int(live[-1]) + 1
    tips, truths = [info["edit_commit"]], []
    k_move, k_del = max(1, n // 1000), max(1, n // 10000)
    for c in range(commits):
        pick = rng.choice(len(live), k_move + k_del, replace=False)
        moved, gone = live[pick[:k_move]], live[pick[k_move:]]
        lon, lat = rng.uniform(-180, 180, k_move), rng.uniform(-85, 85, k_move)
        if c == 1:
            lon[: k_move // 2] = rng.choice([-180.0, 180.0, 179.99999, -179.99999], k_move // 2)
            lat[::3] = rng.choice([-90.0, 90.0], len(lat[::3]))
        new = np.arange(next_pk, next_pk + k_del, dtype=np.int64)
        next_pk += k_del
        tips.append(commit_point_edits(
            repo, moves=(moved, lon, lat),
            inserts=(new, rng.uniform(-180, 180, k_del), rng.uniform(-85, 85, k_del)),
            deletes=gone, message=f"history {c}"))
        live = np.sort(np.concatenate([np.setdiff1d(live, gone), new]))
        truths.append({"inserts": k_del, "updates": k_move, "deletes": k_del})
    return repo, tips, truths


def test_point_history_cdc_matches_kart_tpu(tmp_path):
    _, tips, truths = _point_history(str(tmp_path / "src"))
    jrepo, trepo = _both(str(tmp_path / "src"), tmp_path)
    for old, new, truth in zip(tips, tips[1:], truths):
        ds = trepo.structure(new).datasets["synth"]
        assert not sidecar.has_sidecar(trepo, ds)
        got = _summaries_equal(jrepo, trepo, old, new)
        assert got["synth"]["changed"] == truth
        tree, data = _sidecar_bytes(trepo, new)
        assert data == _sidecar_bytes(jrepo, new)[1]
        built = sidecar.load_block_file(_write(tmp_path / "walk.kcol", data))
        walked = sidecar.build_sidecar(TRepo(str(shutil.copytree(
            str(tmp_path / "src"), tmp_path / f"w{tree[:6]}"))), ds)
        assert np.array_equal(built.keys[: built.count], walked.keys[: walked.count])
        assert np.array_equal(built.oids[: built.count], walked.oids[: walked.count])
    got = _summaries_equal(jrepo, trepo, tips[0], tips[-1])
    assert not got["synth"]["truncated"]
    got = _summaries_equal(jrepo, trepo, tips[0], tips[-1], max_tiles=200)
    assert got["synth"]["truncated"] and got["synth"]["bbox"][0] == -180.0
    got = _summaries_equal(jrepo, trepo, None, tips[-1])
    assert got["synth"]["truncated"] and got["synth"]["changed"] == {"inserts": 20_000}
    assert _summaries_equal(jrepo, trepo, tips[-1], tips[-1]) == {}


def test_tree_delta_blob_and_tree_swaps_match_kart_tpu(tmp_path):
    """Trees where a path is a blob on one side and a tree on the other,
    an unchanged entry, a deleted subtree and a mode-only change."""
    from kart_tpu.core.objects import MODE_TREE as J_MODE_TREE

    repo = JRepo.init_repository(str(tmp_path / "r"))
    odb = repo.odb
    b = [odb.write_blob(f"blob {i}".encode()) for i in range(6)]
    a = JTreeBuilder(odb, None)
    for path, oid in (("x", b[0]), ("d/y", b[1]), ("d/z", b[2]), ("same", b[3]), ("gone/q", b[4]),
                      ("mode", b[5])):
        a.insert(path, oid)
    old = a.flush()
    n = JTreeBuilder(odb, None)
    for path, oid in (("x/y", b[1]), ("d", b[2]), ("same", b[3]), ("new/deep/w", b[0])):
        n.insert(path, oid)
    n.insert("mode", b[5], mode=0o100755)
    sub = JTreeBuilder(odb, None)
    sub.insert("k", b[4])
    n.insert("t", sub.flush(), mode=J_MODE_TREE)
    new = n.flush()
    trepo = TRepo(str(tmp_path / "r"))
    for pair in ((old, new), (new, old), (None, new), (old, old)):
        got = cdc._tree_delta(trepo.odb, *pair)
        assert got == jcdc._tree_delta(repo.odb, *pair)
    assert "x" in cdc._tree_delta(trepo.odb, old, new)[0]
    with pytest.raises(cdc._DeltaUnavailable):
        cdc._tree_delta(trepo.odb, old, b[0])  # a blob where a tree should be
