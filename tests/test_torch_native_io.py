"""The port's host IO core (``kart_tpu_torch/hostsrc/kart_io.cpp`` through
``kart_tpu_torch.native``) against kart_tpu's ``native`` library on the
same inputs: the framing and SHA-1, the unframed batch, the batch
inflate, the two-tree raw diff on random and malformed trees, the leaf
payloads inside and outside their contract, and the fused GPKG reader.
Each must give kart_tpu's bytes, or decline (None) where kart_tpu's
declines."""

import hashlib
import os
import sqlite3
import struct
import zlib

import numpy as np
import pytest

from kart_tpu import native as jnative
from kart_tpu_torch import native as tnative
from kart_tpu_torch.core.packs import Packfile, PackWriter
from kart_tpu_torch.ops import host_build


@pytest.fixture(scope="module")
def jlib():
    if jnative.load_io() is None:
        jnative.ensure_built()
    lib = jnative.load_io()
    assert lib is not None, "kart_tpu's native IO library did not build"
    return lib


def _payloads(rng, n, sizes=(0, 1, 100, 255, 256, 257, 4000, 70000)):
    return [rng.bytes(int(sizes[i % len(sizes)] + rng.integers(0, 3))) for i in range(n)]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("level", [0, 1, 6])
@pytest.mark.parametrize("obj_type,code", [("blob", 3), ("tree", 2), ("commit", 1)])
def test_framed_batches_equal_kart_tpu_s(jlib, level, obj_type, code):
    contents = _payloads(np.random.default_rng(level * 10 + code), 40)
    got = tnative.pack_records_batch(obj_type, code, contents, level)
    _same(got, jnative.pack_records_batch(obj_type, code, contents, level))
    oids = got[0]
    for i, c in enumerate(contents):  # git's object ids
        assert bytes(oids[i]) == hashlib.sha1(b"%s %d\x00" % (obj_type.encode(), len(c))
                                              + c).digest()
    base = np.frombuffer(b"".join(contents), dtype=np.uint8)
    offsets = np.concatenate([[0], np.cumsum([len(c) for c in contents])]).astype(np.int64)
    _same(tnative.pack_records_base(obj_type, code, base, offsets, level),
          jnative.pack_records_base(obj_type, code, base, offsets, level))


@pytest.mark.parametrize("store_max", ["0", "256", "100000"])
def test_unframed_batches_and_store_max_equal_kart_tpu_s(jlib, monkeypatch, store_max):
    monkeypatch.setenv("KART_PACK_STORE_MAX", store_max)
    contents = _payloads(np.random.default_rng(3), 30)
    t_oids, t_streams = tnative.pack_objects_batch("blob", contents)
    j_oids, j_streams = jnative.pack_objects_batch("blob", contents)
    np.testing.assert_array_equal(t_oids, j_oids)
    assert t_streams == j_streams
    assert [zlib.decompress(s) for s in t_streams] == contents


def _pack(tmp_path, contents, level=1):
    with PackWriter(str(tmp_path / "pack"), level=level) as w:
        oids = w.add_batch_raw("blob", contents)
        w.add("tree", b"100644 a\x00" + bytes(20))
    return Packfile(w.pack_path, w.idx_path), oids


@pytest.mark.parametrize("max_total", [None, 1, 5000, 10**9])
def test_batch_inflate_equals_kart_tpu_s(jlib, tmp_path, max_total):
    contents = _payloads(np.random.default_rng(5), 50)
    pack, _ = _pack(tmp_path, contents)
    offs = pack.index.all_offsets_sorted()
    got = tnative.inflate_pack_batch(pack._mm, offs, max_total=max_total)
    want = jnative.inflate_pack_batch(pack._mm, offs, max_total=max_total)
    assert got[0] == want[0] >= 1
    _same(got[1:], want[1:])
    if max_total is None:
        payloads = [got[2][got[3][i]:got[3][i + 1]].tobytes() for i in range(got[0])]
        assert sorted(p for p in payloads if len(p) != 29) == sorted(set(contents))  # deduplicated
    pack.close()


def test_batch_inflate_declines_a_malformed_record_like_kart_tpu(jlib, tmp_path):
    pack, _ = _pack(tmp_path, _payloads(np.random.default_rng(6), 10))
    bad = np.array([len(pack._mm) + 5], dtype=np.int64)  # past the end
    assert tnative.inflate_pack_batch(pack._mm, bad) is None
    assert jnative.inflate_pack_batch(pack._mm, bad) is None
    mid = np.array([pack.index.all_offsets_sorted()[0] + 3], dtype=np.int64)  # inside a stream
    assert (tnative.inflate_pack_batch(pack._mm, mid) is None) == (
        jnative.inflate_pack_batch(pack._mm, mid) is None)
    pack.close()


def test_pack_batch_reads_serve_every_object(tmp_path):
    contents = _payloads(np.random.default_rng(8), 25)
    pack, oids = _pack(tmp_path, contents, level=0)
    shas = [bytes(o) for o in oids]
    got = pack.read_batch(shas + [bytes(20)])
    assert [got[s] for s in shas] == [("blob", c) for c in contents]
    out = [None] * len(shas)
    filled = pack.read_blob_data_into(shas[::-1], out, list(range(len(shas))))
    assert filled.all() and out == contents[::-1]


def _tree(entries):
    """[(mode, name, 20-byte sha)] in git's tree order -> payload."""
    def key(e):
        return e[1].encode() + (b"/" if e[0] == "40000" else b"")
    return b"".join(b"%s %s\x00" % (m.encode(), n.encode()) + s
                    for m, n, s in sorted(entries, key=key))


def _random_tree(rng, names):
    return [("40000" if rng.random() < 0.3 else "100644", n, rng.bytes(20)) for n in names]


@pytest.mark.parametrize("seed", range(6))
def test_tree_diff_raw_equals_kart_tpu_s_on_random_trees(jlib, seed):
    rng = np.random.default_rng(seed)
    pool = [f"n{i}" for i in range(40)] + ["a", "a.b", "a-b", "a0", "ab", "é"]
    a = _random_tree(rng, sorted(set(rng.choice(pool, 30).tolist())))
    b = [(m, n, s if rng.random() < 0.6 else rng.bytes(20)) for m, n, s in a
         if rng.random() < 0.8]
    b += _random_tree(rng, sorted(set(rng.choice(pool, 8).tolist()) - {n for _, n, _ in b}))
    ta, tb = _tree(a), _tree(b)
    got = tnative.tree_diff_raw(ta, tb)
    assert got == jnative.tree_diff_raw(ta, tb)
    assert tnative.tree_diff_raw(ta, ta) == [] == jnative.tree_diff_raw(ta, ta)


@pytest.mark.parametrize("bad", [b"100644", b"100644 x", b"100644 x\x00" + bytes(5),
                                 b" x\x00" + bytes(20), b"12345678 x\x00" + bytes(20)])
def test_tree_diff_raw_declines_malformed_trees_like_kart_tpu(jlib, bad):
    good = _tree([("100644", "x", bytes(20))])
    for a, b in ((bad, good), (good, bad)):
        assert tnative.tree_diff_raw(a, b) is None
        assert jnative.tree_diff_raw(a, b) is None


@pytest.mark.parametrize("case", ["dense", "sparse", "one", "big"])
def test_leaf_payloads_inside_the_contract_equal_kart_tpu_s(jlib, case):
    rng = np.random.default_rng(11)
    pks = {"dense": np.arange(1, 5000), "one": np.array([7]),
           "sparse": np.unique(rng.integers(0, 10**6, 3000)),
           "big": np.unique(rng.integers(5 * 10**8, 64**5, 500))}[case].astype(np.int64)
    oids = rng.integers(0, 256, (len(pks), 20), dtype=np.uint8)
    limit = 64 ** 5
    got = tnative.leaf_payloads(pks, oids, 64, limit)
    _same(got, jnative.leaf_payloads(pks, oids, 64, limit))


@pytest.mark.parametrize("pks", [[3, 2], [-1, 5], [1, 2, 2], [5, 64 ** 5]])
def test_leaf_payloads_outside_the_contract_decline_like_kart_tpu(jlib, pks):
    pks = np.array(pks, dtype=np.int64)
    oids = np.zeros((len(pks), 20), dtype=np.uint8)
    assert tnative.leaf_payloads(pks, oids, 64, 64 ** 5) is None
    assert jnative.leaf_payloads(pks, oids, 64, 64 ** 5) is None


def _gpkg_point(x, y, env=False):
    flags = 0x01 | (1 << 1 if env else 0)
    head = b"GP\x00" + bytes([flags]) + struct.pack("<i", 4326)
    if env:
        head += struct.pack("<4d", x, x, y, y)
    return head + struct.pack("<BI2d", 1, 1, x, y)


def _table(path, rows):
    con = sqlite3.connect(path)
    con.execute("CREATE TABLE t (fid INTEGER PRIMARY KEY, geom BLOB, name TEXT, v REAL, "
                "flag BOOLEAN, ts DATETIME, data BLOB, n INTEGER)")
    con.executemany("INSERT INTO t VALUES (?,?,?,?,?,?,?,?)", rows)
    con.commit()
    con.close()
    return path


def _read_all(module, path, batch):
    r = module.open_gpkg_reader(path, "SELECT fid, geom, name, v, flag, ts, data, n FROM t "
                                "ORDER BY fid", [1, 2, 3, 4, 5, 6, 7], [1, 0, 3, 2, 4, 0, 0], 0,
                                b"\x92\xa2lh\x97", 0x47, est_row_bytes=64)
    out = []
    while True:
        b = r.next_batch(batch)
        if b is None:
            return out
        pks, buf, offs = b
        out += [(int(pks[i]), buf[offs[i]:offs[i + 1]].tobytes()) for i in range(len(pks))]


def test_gpkg_reader_equals_kart_tpu_s(jlib, tmp_path):
    rows = [(i, None if i % 7 == 0 else _gpkg_point(i * 0.5, -i), ["plain", "", "unicodé ☃",
             "x" * 300, None][i % 5], [0.0, float("nan"), -1.5, 1e300, None][i % 5] if i % 3
             else i, [1, 0, None][i % 3], ["2020-01-02 03:04:05", None, 5][i % 3],
             [b"", b"\x00\xff" * 200, None][i % 3], [0, -1, 2**62, -(2**63), 127, 128, 65536,
                                                     None][i % 8])
            for i in range(1, 300)]
    path = _table(str(tmp_path / "t.gpkg"), rows)
    got = _read_all(tnative, path, 37)
    assert got == _read_all(jnative, path, 37)
    assert [pk for pk, _ in got] == list(range(1, 300))


def test_gpkg_reader_falls_back_where_kart_tpu_s_does(jlib, tmp_path):
    rows = [(i, _gpkg_point(1.0, 2.0, env=(i == 50)), "a", 1.0, 1, None, None, 1)
            for i in range(1, 100)]
    path = _table(str(tmp_path / "t.gpkg"), rows)
    for module in (tnative, jnative):
        with pytest.raises(module.GpkgReaderFallback):
            _read_all(module, path, 10)


def test_gpkg_reader_raises_on_a_missing_database(tmp_path):
    with pytest.raises(tnative.NativeIOError):
        tnative.open_gpkg_reader(str(tmp_path / "none" / "x.gpkg"), "SELECT 1", [], [], 0, b"",
                                 0x47)


def test_io_core_builds_into_the_port_build_dir_only():
    path = tnative.library_path()
    assert os.path.dirname(os.path.dirname(path)) == host_build.BUILD_ROOT
    assert os.path.basename(os.path.dirname(path)).startswith("host-")
    assert "libkart_io" not in os.path.basename(path)
    assert tnative.load_io()._name == path


def test_io_core_build_raises_without_gxx(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(host_build.HostBuildError):
        host_build.build_library(host_build.HOSTSRC_DIR, tnative.SOURCE, tnative.LIB_NAME,
                                 tnative.LINK_FLAGS, build_root=str(tmp_path / "build"))
