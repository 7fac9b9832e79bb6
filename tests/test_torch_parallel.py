"""Several devices on the CPU: the port's mesh routes (``kart_tpu_torch
.parallel``, and ``diff.backend.ShardedTorchBackend``: the classify with
its chunks dealt out over the mesh (B3, B8), the sharded merge (B7) and the
mesh forms of K2, K5, K6 and K7) against kart_tpu's sharded functions on
its virtual CPU mesh, on the same numpy inputs made from a seed, for meshes
of S = 1, 2, 3, 4 and 8 entries (``[torch.device("cpu")] * S``: each shard
runs its kernel's plain version): the key-modulus partition array for
array, and classes, counts, unions, decisions, presence, hits, per-probe
counts, pair totals and verdicts bit for bit. The merc form is held to the
port's one-card projection. Cases: empty sides, one side empty, every key
in one shard, int keys near +-2^62, hash keys near 2^63, and chunk counts
that S does not divide. Then the routing rule (``should_shard``'s row
floor and card count; a routable card backend and ``merge_classify``
choosing the mesh call by call, only for an unnamed card with 2 or more
visible), a failing shard raising instead of falling back, and every
allocation on the mesh routes naming its device. No process is started."""

import inspect
import os

import numpy as np
import pytest
import torch

from kart_tpu.diff import backend as jbackend
from kart_tpu.diff import device_batch as jbatch
from kart_tpu.geom import VertexColumn as JVertexColumn
from kart_tpu.ops.blocks import FeatureBlock as JBlock
from kart_tpu.parallel import sharded_diff as jsharded
from kart_tpu.parallel.mesh import make_mesh as jmake_mesh
from kart_tpu.parallel.sharded_merge import sharded_merge_classify as jsharded_merge
from kart_tpu_torch import runtime
from kart_tpu_torch.diff import backend, engine
from kart_tpu_torch.ops import diff_kernel, merge_kernel
from kart_tpu_torch.ops.blocks import FeatureBlock
from kart_tpu_torch.parallel import mesh as tmesh
from kart_tpu_torch.parallel import sharded_diff, sharded_merge
from kart_tpu_torch.synth import synth_shapes

CPU = torch.device("cpu")
MESH_SIZES = [1, 2, 3, 4, 8]
#: a multiple of every mesh size here: such keys all fall in shard 0
ALL_SHARDS = 840


def _mesh(s):
    return [CPU] * s


def _edited(rng, keys, upd=0.05, dele=0.03, ins=0.04, ins_keys=None):
    """(old keys, old oids, new keys, new oids): ``keys`` with a share of
    their rows updated and deleted, and ``ins_keys`` (or a share of fresh
    keys) inserted."""
    keys = np.unique(np.asarray(keys, dtype=np.int64))
    oids = rng.integers(0, 2**32, size=(len(keys), 5), dtype=np.uint32)
    keep = rng.random(len(keys)) >= dele
    nk, no = keys[keep], oids[keep].copy()
    up = rng.random(len(nk)) < upd
    no[up] = rng.integers(0, 2**32, size=(int(up.sum()), 5), dtype=np.uint32)
    if ins_keys is None:
        ins_keys = keys[-1:] + 1 + np.arange(int(len(keys) * ins)) if len(keys) else keys
    ins_keys = np.setdiff1d(np.asarray(ins_keys, dtype=np.int64), nk)
    nk = np.concatenate([nk, ins_keys])
    no = np.concatenate([no, rng.integers(0, 2**32, size=(len(ins_keys), 5), dtype=np.uint32)])
    order = np.argsort(nk, kind="stable")
    return keys, oids, nk[order], no[order]


def _case(name):
    """-> (old keys, old oids, new keys, new oids) of one named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "random":
        return _edited(rng, rng.choice(50_000, 2400, replace=False))
    if name == "empty":
        z = np.zeros(0, np.int64)
        return z, np.zeros((0, 5), np.uint32), z, np.zeros((0, 5), np.uint32)
    if name == "old_empty":
        _, _, nk, no = _edited(rng, rng.choice(9000, 1500, replace=False))
        return np.zeros(0, np.int64), np.zeros((0, 5), np.uint32), nk, no
    if name == "new_empty":
        k, o, _, _ = _edited(rng, rng.choice(9000, 1500, replace=False))
        return k, o, np.zeros(0, np.int64), np.zeros((0, 5), np.uint32)
    if name == "one_shard":
        base = rng.choice(4000, 1800, replace=False) * ALL_SHARDS
        return _edited(rng, base, ins_keys=(4000 + np.arange(60)) * ALL_SHARDS)
    if name == "int_extremes":
        lo = -(2**62) + rng.choice(10**6, 900, replace=False)
        hi = 2**62 - rng.choice(10**6, 900, replace=False)
        return _edited(rng, np.concatenate([lo, hi, rng.choice(1000, 300, replace=False)]),
                       ins_keys=np.asarray([-(2**62), 2**62], dtype=np.int64))
    if name == "hash_keys":
        top = 2**63 - 2
        keys = top - rng.choice(2**40, 2000, replace=False)
        return _edited(rng, keys, ins_keys=np.asarray([top, top - 2**40 - 7], dtype=np.int64))
    raise KeyError(name)


CASES = ["random", "empty", "old_empty", "new_empty", "one_shard", "int_extremes", "hash_keys"]


def _blocks(name):
    """-> ((port old, port new), (kart_tpu old, kart_tpu new)) FeatureBlocks."""
    ok, oo, nk, no = _case(name)
    port = (FeatureBlock.from_arrays(ok, oo), FeatureBlock.from_arrays(nk, no))
    ref = (JBlock.from_arrays(ok, oo, [str(k) for k in ok]),
           JBlock.from_arrays(nk, no, [str(k) for k in nk]))
    return port, ref


def _counts(t):
    return diff_kernel.counts_dict(t)


# --- host layouts ------------------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("s", MESH_SIZES)
def test_partition_block_matches_kart_tpu(s, name):
    (old, new), (jold, jnew) = _blocks(name)
    for blk, jblk in ((old, jold), (new, jnew)):
        got, want = sharded_diff.partition_block(blk, s), jsharded.partition_block(jblk, s)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        for g, w in zip(sharded_diff._repad(got, 2 * got[0].shape[1]),
                        jsharded._repad(want, 2 * want[0].shape[1])):
            assert np.array_equal(g, w)


# --- the classifies ----------------------------------------------------------------------

def _mesh_classify(old, new, s, **kwargs):
    """The port's B3: the blocks' chunks dealt out over a mesh of S CPU
    entries."""
    return diff_kernel.classify_blocks_streamed(old, new, CPU, mesh=_mesh(s), **kwargs)


@pytest.mark.parametrize("s", MESH_SIZES)
def test_batched_classify_matches_kart_tpu(s):
    mesh, jmesh = _mesh(s), jmake_mesh(s)
    for name in CASES:
        (old, new), (jold, jnew) = _blocks(name)
        want = jbatch.classify_blocks_batched(jold, jnew, mesh=jmesh, batch_rows=256)
        for got in (_mesh_classify(old, new, s, chunk_rows=256),
                    backend.ShardedTorchBackend(mesh).classify(old, new)):
            assert _counts(got[2]) == want[2], name
            assert got[0].dtype == got[1].dtype == torch.int8
            np.testing.assert_array_equal(got[0].numpy(), want[0])
            np.testing.assert_array_equal(got[1].numpy(), want[1])
        want_c = jbatch.classify_blocks_batched(jold, jnew, mesh=jmesh, batch_rows=256,
                                                counts_only=True)
        got_c = _mesh_classify(old, new, s, chunk_rows=256, counts_only=True)
        assert got_c[0] is None and got_c[1] is None
        assert _counts(got_c[2]) == want_c[2] == want[2], name
        assert _counts(backend.ShardedTorchBackend(mesh).counts(old, new)) == want[2]


@pytest.mark.parametrize("chunk_rows", [1, 256, 1000])
@pytest.mark.parametrize("name", CASES)
def test_mesh_classify_chunks_match_kart_tpu(name, chunk_rows):
    """Three entries, so that S divides few chunk counts: every chunk size
    gives kart_tpu's batched classes and counts."""
    (old, new), (jold, jnew) = _blocks(name)
    want = jbatch.classify_blocks_batched(jold, jnew, mesh=jmake_mesh(3), batch_rows=256)
    timings = {}
    got = _mesh_classify(old, new, 3, chunk_rows=chunk_rows, timings=timings)
    assert _counts(got[2]) == want[2]
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    rows = max(old.count, new.count, 1)
    assert timings["chunks"] <= -(-rows // chunk_rows)


@pytest.mark.parametrize("s", MESH_SIZES)
def test_sharded_classify_matches_kart_tpu(s):
    """The mesh's classify against kart_tpu's other mesh classify (B7, the
    key-modulus partition): the same classes and counts whatever the cut."""
    mesh, jmesh = _mesh(s), jmake_mesh(s)
    for name in CASES:
        (old, new), (jold, jnew) = _blocks(name)
        want = jsharded.classify_blocks_sharded(jold, jnew, mesh=jmesh)
        before = sharded_diff.STATS["sharded_classify_calls"]
        got = backend.ShardedTorchBackend(mesh).classify(old, new)
        assert sharded_diff.STATS["sharded_classify_calls"] == before + 1
        assert _counts(got[2]) == want[2], name
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        assert _counts(backend.ShardedTorchBackend(mesh).counts(old, new)) == (
            jsharded.sharded_diff_step(jmesh, jold, jnew))


@pytest.mark.parametrize("s", MESH_SIZES)
def test_sampled_counts_match_kart_tpu(s):
    """B8: the mesh's counts-only classify at its default chunk, at most
    one key-aligned slice a device."""
    for name in CASES:
        (old, new), (jold, jnew) = _blocks(name)
        want = jbackend.sampled_counts_pmapped(jold, jnew)
        timings = {}
        got = _mesh_classify(old, new, s, counts_only=True, timings=timings)[2]
        assert _counts(got) == want, name
        assert 1 <= timings["chunks"] <= s
        assert _counts(backend.ShardedTorchBackend(_mesh(s)).counts(old, new)) == want


def _merge_sides(name):
    """Three sides (ancestor, ours, theirs) as numpy (keys, oids)."""
    ak, ao, ok, oo = _case(name)
    rng = np.random.default_rng(len(name))
    tk, to = ak.copy(), ao.copy()
    if len(tk):
        drop = rng.random(len(tk)) < 0.04
        tk, to = tk[~drop], to[~drop]
        ch = rng.random(len(tk)) < 0.06
        to[ch] = rng.integers(0, 2**32, size=(int(ch.sum()), 5), dtype=np.uint32)
        # the same change on both sides for some of ours' updates
        same = np.intersect1d(tk, ok)[::7]
        to[np.searchsorted(tk, same)] = oo[np.searchsorted(ok, same)]
    return (ak, ao), (ok, oo), (tk, to)


@pytest.mark.parametrize("s", MESH_SIZES)
def test_sharded_merge_matches_kart_tpu(s):
    jmesh = jmake_mesh(s)
    for name in ["random", "empty", "old_empty", "one_shard", "int_extremes", "hash_keys"]:
        sides = _merge_sides(name)
        port = [FeatureBlock.from_arrays(k, o) for k, o in sides]
        ref = [JBlock.from_arrays(k, o, [str(x) for x in k]) for k, o in sides]
        want = jsharded_merge(*ref, mesh=jmesh)
        got = sharded_merge.sharded_merge_classify(*port, _mesh(s))
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype and np.array_equal(g, w), name
        assert got[3] == want[3], name
        one = merge_kernel.merge_classify(*port, device="cpu")
        for g, w in zip(got[:3], one[:3]):
            assert np.array_equal(g, w)
        assert got[3] == one[3]


# --- the mesh forms of K2, K5, K6 and K7 -------------------------------------------------

def _envelopes(n, seed, wrap=0.1, nan=0.02):
    rng = np.random.default_rng(seed)
    w = rng.uniform(-180, 180, n)
    s = rng.uniform(-90, 80, n)
    e = np.where(rng.random(n) < wrap, w - rng.uniform(1, 20, n), w + rng.uniform(0, 30, n))
    e = ((e + 180) % 360) - 180
    env = np.stack([w, s, e, np.minimum(s + rng.uniform(0, 20, n), 90)], axis=1)
    env[rng.random(n) < nan] = np.nan
    return env.astype(np.float32)


@pytest.mark.parametrize("s", MESH_SIZES)
def test_envelope_hits_match_kart_tpu(s, monkeypatch):
    monkeypatch.setattr(backend, "DEVICE_MIN_ENVELOPES", 0)
    env = _envelopes(3001, 5)
    blk = FeatureBlock(np.arange(3001, dtype=np.int64), np.zeros((3001, 5), np.uint32), 3001,
                       envelopes=env)
    sharded = backend.ShardedTorchBackend(_mesh(s))
    for q in ((-60.0, -30.0, 60.0, 30.0), (10.5, -90.0, 10.75, 90.0), (0.0, 0.0, 0.0, 0.0)):
        want = jbackend.sharded_envelope_hits(env, 3001, np.asarray(q))
        got = sharded.envelope_hits(blk, q)
        np.testing.assert_array_equal(got.numpy(), want)
    # a wrapping rectangle goes to the one-card route, as kart_tpu's goes to its base
    got = sharded.envelope_hits(blk, (170.0, -10.0, -170.0, 10.0))
    want = backend.CpuTorchBackend(CPU).envelope_hits(blk, (170.0, -10.0, -170.0, 10.0))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("s", MESH_SIZES)
def test_join_counts_match_kart_tpu(s):
    build, probe = _envelopes(700, 6, wrap=0.2), _envelopes(2049, 7, wrap=0.2)
    want_counts, want_total = jbackend.sharded_join_counts(build, probe)
    sharded = backend.ShardedTorchBackend(_mesh(s))
    b, p = torch.from_numpy(build), torch.from_numpy(probe)
    counts, total, pairs = sharded.join_counts(b, p, pairs=True)
    np.testing.assert_array_equal(counts.numpy().astype(np.int64), want_counts)
    assert total == want_total and counts.dtype == torch.int32
    one = backend.CpuTorchBackend(CPU).join_counts(b, p, pairs=True)
    for g, w in zip(pairs, one[2]):
        assert torch.equal(g, w)
    counts, total, none = sharded.join_counts(b, p[:5])
    assert none is None and total == int(want_counts[:5].sum())
    counts, total, pairs = sharded.join_counts(b[:0], p, pairs=True)
    assert total == 0 and not counts.any() and pairs[0].numel() == 0


@pytest.mark.parametrize("s", MESH_SIZES)
def test_refine_pairs_match_kart_tpu(s):
    col_a = synth_shapes(90, seed=8, max_segments=24)
    col_b = synth_shapes(70, seed=9, max_segments=24, span=6.0)
    ja = JVertexColumn(col_a.kinds, col_a.feat_offsets, col_a.ring_offsets, col_a.x, col_a.y)
    jb = JVertexColumn(col_b.kinds, col_b.feat_offsets, col_b.ring_offsets, col_b.x, col_b.y)
    rng = np.random.default_rng(10)
    ia, ib = rng.integers(0, 90, 1500), rng.integers(0, 70, 1500)
    want = jbackend.sharded_refine_pairs(ja, ia, jb, ib)
    sharded = backend.ShardedTorchBackend(_mesh(s))
    got = sharded.refine_pairs(col_a, ia, col_b, ib)
    np.testing.assert_array_equal(got.numpy(), want)
    got = sharded.refine_pairs(col_a, torch.from_numpy(ia), col_b, torch.from_numpy(ib))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    assert sharded.refine_pairs(col_a, ia[:0], col_b, ib[:0]).numel() == 0


@pytest.mark.parametrize("s", MESH_SIZES)
def test_merc_matches_the_one_card_projection(s, monkeypatch):
    monkeypatch.setattr(backend, "DEVICE_MIN_ENVELOPES", 0)
    env = _envelopes(2500, 11, nan=0.0).astype(np.float64)
    env[:4] = [[-180, -90, 180, 90], [0, 85.06, 1, 89], [179.9, -85.1, -179.9, 85.1], [0, 0, 0, 0]]
    got = backend.ShardedTorchBackend(_mesh(s)).merc_envelopes(env)
    one = backend.DeviceTorchBackend(CPU).merc_envelopes(env)
    for g, w in zip(got, one):
        assert g.dtype == np.float64 and np.array_equal(g, w)
    # the exported integers: the quantizer's, whichever projection ran
    from kart_tpu_torch.tiles.clip import quantize_from_merc

    for z, x, y in ((0, 0, 0), (3, 1, 2), (5, 31, 0)):
        assert np.array_equal(quantize_from_merc(env, got, z, x, y),
                              quantize_from_merc(env, backend.host_merc_envelopes(env), z, x, y))


# --- routing, failures and allocations ---------------------------------------------------

def test_should_shard_knobs(monkeypatch):
    monkeypatch.delenv("KART_SHARDED_MIN_ROWS", raising=False)
    cards = {"n": 2}
    monkeypatch.setattr(sharded_diff, "best_device_count", lambda limit=None: cards["n"])
    assert sharded_diff._sharded_min_rows() == 2_000_000
    assert not sharded_diff.should_shard(1_999_999)
    assert sharded_diff.should_shard(2_000_000)
    monkeypatch.setenv("KART_SHARDED_MIN_ROWS", "10")
    assert sharded_diff.should_shard(10) and not sharded_diff.should_shard(9)
    monkeypatch.setenv("KART_SHARDED_MIN_ROWS", "0")
    assert sharded_diff.should_shard(0)
    cards["n"] = 1
    assert not sharded_diff.should_shard(10**9)  # the mesh needs two cards
    monkeypatch.setenv("KART_SHARDED_MIN_ROWS", "100")
    cards["n"] = 8
    assert sharded_diff.should_shard(100) and not sharded_diff.should_shard(99)
    monkeypatch.setenv("KART_SHARDED_MIN_ROWS", "junk")  # ignored: the default
    assert sharded_diff.should_shard(2_000_000) and not sharded_diff.should_shard(100)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmesh.best_device_count() == 0
    with pytest.raises(runtime.DeviceUnavailable):
        tmesh.make_mesh()
    assert tmesh.make_mesh(devices=["cpu", "cpu"]) == [CPU, CPU]
    assert tmesh.asks_for_mesh(None) and tmesh.asks_for_mesh("cuda")
    assert not tmesh.asks_for_mesh("cuda:0") and not tmesh.asks_for_mesh("cpu")
    assert not tmesh.asks_for_mesh(torch.device("cuda", 1))


@pytest.fixture
def fake_cards(monkeypatch):
    """``n`` visible cards, each request for one resolved to the CPU (as
    if it were the card), and a mesh of that many CPU entries."""
    cards = {"n": 2}
    monkeypatch.setattr(sharded_diff, "best_device_count", lambda limit=None: cards["n"])
    monkeypatch.setattr(backend, "make_mesh", lambda: _mesh(cards["n"]))
    real = runtime.resolve_device

    def resolve(device=None):
        dev = torch.device("cuda" if device is None else device)
        return torch.device("cuda", dev.index or 0) if dev.type == "cuda" else real(device)

    monkeypatch.setattr(runtime, "resolve_device", resolve)
    monkeypatch.setenv("KART_SHARDED_MIN_ROWS", "100")
    return cards


def test_select_backend_picks_the_mesh(fake_cards):
    """An unnamed card's backend hands each piece of work to the mesh from
    the row floor on, and runs smaller ones on its card; a named card and
    the CPU never route."""
    card = backend.select_backend(None)
    assert type(card) is backend.DeviceTorchBackend and card.routable
    got = card.for_rows(100)
    assert isinstance(got, backend.ShardedTorchBackend) and got.mesh == _mesh(2)
    assert isinstance(backend.select_backend("cuda").for_rows(10**6),
                      backend.ShardedTorchBackend)
    small = card.for_rows(99)
    assert type(small) is backend.DeviceTorchBackend and not small.routable
    assert small.for_rows(10**6) is small
    for pinned in ("cuda:0", torch.device("cuda", 0)):
        one = backend.select_backend(pinned)
        assert type(one) is backend.DeviceTorchBackend and not one.routable
        assert one.for_rows(10**6) is one
    cpu = backend.select_backend("cpu")
    assert type(cpu) is backend.CpuTorchBackend and cpu.for_rows(10**6) is cpu
    assert backend.BACKENDS["sharded_torch"] is backend.ShardedTorchBackend
    fake_cards["n"] = 1
    assert type(backend.select_backend(None).for_rows(10**6)) is backend.DeviceTorchBackend


def test_engine_and_merge_route_through_the_mesh(fake_cards, monkeypatch):
    """The diff engine's classify and counts, the estimation's sampled
    counts and the merge's classify take the mesh for an unnamed card: the
    mesh's results are the host floor's and the plain merge's."""
    (old, new), _ = _blocks("random")
    calls = sharded_diff.STATS["sharded_classify_calls"]
    got = engine.classify_changed(old, new, device=None)
    want = engine.classify_changed(old, new, device="cpu")
    assert got.counts == want.counts
    assert np.array_equal(got.old_idx, want.old_idx) and np.array_equal(got.new_idx, want.new_idx)
    assert engine.feature_count(old, new, device=None) == sum(want.counts.values())
    assert sharded_diff.STATS["sharded_classify_calls"] == calls + 2
    from kart_tpu_torch.diff.estimation import estimate_counts_from_blocks

    assert (estimate_counts_from_blocks(old, new, "good", device=None)
            == estimate_counts_from_blocks(old, new, "good", device="cpu"))
    assert sharded_diff.STATS["sharded_classify_calls"] == calls + 3
    sides = [FeatureBlock.from_arrays(k, o) for k, o in _merge_sides("random")]
    merges = sharded_diff.STATS["sharded_merge_calls"]
    got = merge_kernel.merge_classify(*sides)
    want = merge_kernel.merge_classify(*sides, device="cpu")
    assert sharded_diff.STATS["sharded_merge_calls"] == merges + 1
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, w)
    assert got[3] == want[3]


def _raise_on_second(fn):
    calls = []

    def wrapped(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise runtime.DeviceUnavailable("shard 1 lost its card")
        return fn(*args, **kwargs)

    return wrapped


def test_a_failing_shard_raises(fake_cards, monkeypatch):
    """A launch that fails on shard 1 fails the call: nothing falls back to
    the host or to one card."""
    (old, new), _ = _blocks("random")
    host = []
    monkeypatch.setattr(backend, "classify_blocks_host", lambda *a: host.append(a))
    real = diff_kernel.classify_plain
    monkeypatch.setattr(diff_kernel, "classify_plain", _raise_on_second(real))
    with pytest.raises(runtime.DeviceUnavailable, match="shard 1"):
        backend.select_backend(None).classify(old, new)
    monkeypatch.setattr(diff_kernel, "classify_plain", _raise_on_second(real))
    with pytest.raises(runtime.DeviceUnavailable, match="shard 1"):
        backend.ShardedTorchBackend(_mesh(8)).counts(old, new)
    monkeypatch.setattr(sharded_merge, "merge_classify_sides_plain",
                        _raise_on_second(sharded_merge.merge_classify_sides_plain))
    sides = [FeatureBlock.from_arrays(k, o) for k, o in _merge_sides("random")]
    with pytest.raises(runtime.DeviceUnavailable, match="shard 1"):
        merge_kernel.merge_classify(*sides)
    env = _envelopes(50, 1)
    monkeypatch.setattr(backend, "envelope_join_plain", _raise_on_second(
        backend.envelope_join_plain))
    with pytest.raises(runtime.DeviceUnavailable, match="shard 1"):
        backend.ShardedTorchBackend(_mesh(2)).join_counts(torch.from_numpy(env),
                                                          torch.from_numpy(env))
    assert host == []


FACTORIES = ("empty", "zeros", "ones", "full", "arange", "tensor", "empty_like", "zeros_like")
PORT = os.path.dirname(os.path.abspath(backend.__file__)).rsplit(os.sep, 1)[0]


def test_mesh_routes_allocate_on_named_devices(monkeypatch):
    """Every tensor that the mesh routes (and the wrappers they call)
    create names its device, or is host memory by intent (pinned, or a
    ``*_like`` of a tensor on its device): a launcher leaves its card the
    thread's current device, so a bare allocation could land on another
    shard's card. And every result lands on the mesh's first entry."""
    bare = []

    def guard(name, fn):
        def wrapped(*args, **kwargs):
            caller = inspect.stack()[1].filename
            if (caller.startswith(PORT) and "device" not in kwargs
                    and not kwargs.get("pin_memory") and not name.endswith("_like")):
                bare.append(f"torch.{name} at {caller}:{inspect.stack()[1].lineno}")
            return fn(*args, **kwargs)
        return wrapped

    for name in FACTORIES:
        monkeypatch.setattr(torch, name, guard(name, getattr(torch, name)))
    monkeypatch.setattr(backend, "DEVICE_MIN_ENVELOPES", 0)
    mesh = _mesh(3)
    (old, new), _ = _blocks("random")
    sharded = backend.ShardedTorchBackend(mesh)
    outs = [*_mesh_classify(old, new, 3, chunk_rows=256), *sharded.classify(old, new),
            sharded.counts(old, new)]
    sides = [FeatureBlock.from_arrays(k, o) for k, o in _merge_sides("random")]
    sharded_merge.sharded_merge_classify(*sides, mesh)
    env = _envelopes(400, 2)
    blk = FeatureBlock(np.arange(400, dtype=np.int64), np.zeros((400, 5), np.uint32), 400,
                       envelopes=env)
    outs.append(sharded.envelope_hits(blk, (-10.0, -10.0, 10.0, 10.0)))
    counts, _, pairs = sharded.join_counts(torch.from_numpy(env), torch.from_numpy(env), True)
    outs += [counts, *pairs]
    col = synth_shapes(30, seed=1, max_segments=12)
    outs.append(sharded.refine_pairs(col, np.arange(30), col, np.arange(30)[::-1].copy()))
    sharded.merc_envelopes(env.astype(np.float64))
    assert bare == []
    assert all(t.device == mesh[0] for t in outs)
