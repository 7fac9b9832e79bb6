"""The port's host floor (``ops/host_classify.py``, its own copy of kart_tpu's
native merge-join, built with g++ into the port's build directory) against
``kart_tpu.native.classify_sorted`` bit for bit: 200 seeded cases, empty and
one-row sides, keys near +-2^62 and at int64's ends, all-updated and
all-deleted sides, runs of equal keys. ``--device cpu`` classifies on it;
a missing compiler raises a named error."""

import os

import numpy as np
import pytest
import torch

from kart_tpu import native as jnative
from kart_tpu_torch.diff import backend, engine
from kart_tpu_torch.ops import _build, host_classify
from kart_tpu_torch.ops import diff_kernel as tdk
from kart_tpu_torch.ops.blocks import FeatureBlock

I64 = np.iinfo(np.int64)


@pytest.fixture(scope="module")
def ref_io():
    if jnative.load_io() is None:
        pytest.skip("kart_tpu's native IO library is not built on this machine "
                    "(kart_tpu.native.load_io() returned None)")
    return jnative


def _oids(rng, n, values=2**32):
    return rng.integers(0, values, size=(n, 5), dtype=np.uint64).astype(np.uint32)


def _u8(oids):
    return np.ascontiguousarray(oids).view(np.uint8).reshape(len(oids), 20)


def _seeded(seed):
    """Two sorted sides of up to 300 rows with shared keys (some oids
    changed: few distinct oid values, so unchanged pairs are common) and
    keys of each side alone; one case in four has runs of equal keys."""
    rng = np.random.default_rng(seed)
    span = int(rng.choice([50, 1000, 2**40]))
    lo = int(rng.choice([0, -(2**62), 2**62 - span, I64.min, I64.max - span]))
    sides = []
    for _ in range(2):
        n = int(rng.integers(0, 300))
        keys = lo + rng.integers(0, span, size=n, dtype=np.int64)
        if seed % 4:
            keys = np.unique(keys)
        sides.append((np.sort(keys), _oids(rng, len(keys), values=3)))
    return sides


def _edge(name):
    rng = np.random.default_rng(len(name))
    keys = np.array([I64.min, I64.min + 1, -(2**62) - 1, -(2**62), -1, 0, 1,
                     2**62 - 1, 2**62, I64.max - 1, I64.max], dtype=np.int64)
    oids = _oids(rng, len(keys))
    empty = (np.zeros(0, np.int64), np.zeros((0, 5), np.uint32))
    if name == "both_empty":
        return empty, empty
    if name == "old_empty":
        return empty, (keys, oids)
    if name == "new_empty":
        return (keys, oids), empty
    if name == "one_row_each_equal":
        return (keys[:1], oids[:1]), (keys[:1], oids[:1].copy())
    if name == "one_row_each_updated":
        return (keys[-1:], oids[-1:]), (keys[-1:], oids[-1:] ^ np.uint32(1))
    if name == "one_row_disjoint":
        return (keys[:1], oids[:1]), (keys[-1:], oids[-1:])
    if name == "all_updated":
        changed = oids.copy()
        changed[np.arange(len(keys)), np.arange(len(keys)) % 5] ^= np.uint32(0x80000000)
        return (keys, oids), (keys.copy(), changed)
    if name == "all_deleted":
        return (keys, oids), (keys[:0], oids[:0])
    if name == "ends_interleaved":
        return (keys[::2], oids[::2]), (keys[1::2], oids[1::2])
    if name == "equal_key_runs":
        k = np.array([I64.min, 5, 5, 5, 9, I64.max, I64.max], dtype=np.int64)
        o = _oids(rng, len(k), values=2)
        return (k, o), (k[1:].copy(), _oids(rng, len(k) - 1, values=2))
    raise KeyError(name)


EDGES = ["both_empty", "old_empty", "new_empty", "one_row_each_equal",
         "one_row_each_updated", "one_row_disjoint", "all_updated", "all_deleted",
         "ends_interleaved", "equal_key_runs"]


def _check(ref_io, old, new):
    (ok, oo), (nk, no) = old, new
    want = ref_io.classify_sorted(ok, _u8(oo), nk, _u8(no))
    assert want is not None
    got_old, got_new, got_counts = host_classify.classify_sorted(ok, _u8(oo), nk, _u8(no))
    np.testing.assert_array_equal(got_old, want[0])
    np.testing.assert_array_equal(got_new, want[1])
    assert got_old.dtype == np.int8 and got_new.dtype == np.int8
    assert dict(zip(("inserts", "updates", "deletes"), got_counts.tolist())) == want[2]
    return got_old, got_new, got_counts


@pytest.mark.parametrize("seed", range(200))
def test_floor_matches_kart_tpu_native(ref_io, seed):
    _check(ref_io, *_seeded(seed))


@pytest.mark.parametrize("name", EDGES)
def test_floor_matches_kart_tpu_native_on_edges(ref_io, name):
    _check(ref_io, *_edge(name))


@pytest.mark.parametrize("seed", [1, 2, 3, 5, 6, 7])
def test_floor_matches_k1_plain_on_unique_keys(ref_io, seed):
    """On unique keys (what every sidecar holds) the floor and K1's plain
    version give the same classes and counts."""
    old, new = _seeded(seed)
    got = _check(ref_io, old, new)
    plain = tdk.classify_plain(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        old[0], old[1].view(np.int32), new[0], new[1].view(np.int32))))
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p.numpy())


def test_cpu_backend_classifies_on_the_floor(monkeypatch):
    """``--device cpu`` (the CPU backend) runs the floor, on the blocks'
    count-sliced rows of padded blocks, and never K1's plain version."""
    rng = np.random.default_rng(9)
    k1 = np.sort(rng.choice(5000, 900, replace=False)).astype(np.int64)
    k2 = np.sort(rng.choice(5000, 900, replace=False)).astype(np.int64)
    old = FeatureBlock.from_arrays(k1, _oids(rng, 900, 2))
    new = FeatureBlock.from_arrays(k2, _oids(rng, 900, 2))
    assert len(old.keys) > old.count  # padded past the real rows
    want = tdk.classify_blocks(old, new, torch.device("cpu"))
    monkeypatch.setattr(tdk, "classify_plain", lambda *a: pytest.fail("plain version ran"))
    cpu = backend.select_backend("cpu")
    assert cpu.name == "cpu_torch"
    got = cpu.classify(old, new)
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and torch.equal(g, w)
    assert torch.equal(cpu.counts(old, new), want[2])
    res = engine.classify_changed(old, new, device="cpu")
    assert res.counts == tdk.counts_dict(want[2])


def test_floor_builds_into_the_port_build_dir_only():
    path = host_classify.build_library()
    assert os.path.dirname(os.path.dirname(path)) == _build.BUILD_ROOT
    assert os.path.basename(os.path.dirname(path)).startswith("host-")
    assert host_classify.build_dir() != _build.build_dir()
    assert not os.path.relpath(path, _build.PKG_DIR).startswith("..")


def test_floor_build_raises_without_gxx(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(host_classify.HostBuildError):
        host_classify.find_cxx()
    with pytest.raises(host_classify.HostBuildError):
        host_classify.build_library()
    assert not os.listdir(tmp_path / "build" / os.path.basename(host_classify.build_dir()))


def test_floor_build_raises_on_a_failed_compile(monkeypatch, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / host_classify.SOURCE).write_text("this is not C++\n")
    monkeypatch.setattr(host_classify, "HOSTSRC_DIR", str(src))
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(host_classify.HostBuildError, match="g\\+\\+ failed"):
        host_classify.build_library()
