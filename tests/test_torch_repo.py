"""The port's repository layer against kart_tpu on a repo kart_tpu wrote:
revision resolution, every object read, and pack files written by one
and read by the other (delta records included)."""

import hashlib
import os
import struct
import zlib

import pytest

from helpers import make_repo_with_edits
from kart_tpu.core import packs as jpacks
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.core.repo import NotFound as JNotFound
from kart_tpu_torch.core import packs as tpacks
from kart_tpu_torch.core.odb import ObjectMissing
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.core.repo import NotFound as TNotFound


@pytest.fixture(scope="module")
def repos(tmp_path_factory):
    path, _ = make_repo_with_edits(tmp_path_factory.mktemp("repo"), n=40)
    return JRepo(path), TRepo(path)


def _refishes(jrepo):
    head = jrepo.head_commit_oid
    parent = jrepo.odb.read_commit(head).parents[0]
    return ["HEAD", "HEAD^", "HEAD~1", "HEAD^1", "HEAD^^?", "HEAD^?", "main",
            "refs/heads/main", head, parent, head[:7], parent[:12], "[EMPTY]"]


@pytest.mark.parametrize("i", range(13))
def test_resolve_refish_matches(repos, i):
    jrepo, trepo = repos
    refish = _refishes(jrepo)[i]
    assert trepo.resolve_refish(refish) == jrepo.resolve_refish(refish)


@pytest.mark.parametrize("refish", ["nosuch", "HEAD^^", "HEAD~5", "main^2", "0000000"])
def test_unresolvable_refish_raises_alike(repos, refish):
    jrepo, trepo = repos
    with pytest.raises(JNotFound) as je:
        jrepo.resolve_refish(refish)
    with pytest.raises(TNotFound) as te:
        trepo.resolve_refish(refish)
    assert str(te.value) == str(je.value)


def test_every_object_reads_alike(repos):
    jrepo, trepo = repos
    oids = list(jrepo.odb.iter_oids())
    assert len(oids) > 50
    kinds = set()
    for oid in oids:
        got = trepo.odb.read_raw(oid)
        assert got == jrepo.odb.read_raw(oid)
        kinds.add(got[0])
        if got[0] == "commit":
            assert trepo.odb.read_commit(oid).serialise() == got[1]
        elif got[0] == "tree":
            assert [(e.name, e.mode, e.oid) for e in trepo.odb.read_tree_entries(oid)] == [
                (e.name, e.mode, e.oid) for e in jrepo.odb.read_tree_entries(oid)]
    assert kinds == {"commit", "tree", "blob"}
    shas = [bytes.fromhex(o) for o in oids if jrepo.odb.read_raw(o)[0] == "blob"]
    assert trepo.odb.read_blobs_data_ordered(shas) == [
        jrepo.odb.read_blob(s.hex()) for s in shas]


def test_merge_base_and_structure(repos):
    jrepo, trepo = repos
    head, parent = trepo.resolve_refish("HEAD")[0], trepo.resolve_refish("HEAD^")[0]
    for a, b in ((parent, head), (head, parent), (head, head)):
        assert trepo.merge_base(a, b) == jrepo.merge_base(a, b)
    for rev in ("HEAD", "HEAD^"):
        jrs, trs = jrepo.structure(rev), trepo.structure(rev)
        assert trs.tree_oid == jrs.tree_oid
        assert trs.datasets.paths() == jrs.datasets.paths()
        jds, tds = jrs.datasets["points"], trs.datasets["points"]
        assert tds.meta_items() == jds.meta_items()
        assert tds.feature_tree.oid == jds.feature_tree.oid
        for path, entry in list(jds.feature_tree.walk_blobs())[:10]:
            pks = tds.decode_path_to_pks(path)
            assert pks == jds.decode_path_to_pks(path)
            assert tds.path_encoder.encode_pks_to_path(pks) == path
            data = trepo.odb.read_blob(entry.oid)
            tf, jf = tds.get_feature(pks, data=data), jds.get_feature(pks, data=data)
            assert {k: bytes(v) if hasattr(v, "to_hex_wkb") else v for k, v in tf.items()} == {
                k: bytes(v) if hasattr(v, "to_hex_wkb") else v for k, v in jf.items()}
            assert tds.feature_json_str_from_data(pks, data) == jds.feature_json_str_from_data(
                pks, data)


def test_absent_object_raises_with_its_oid(repos):
    _, trepo = repos
    oid = "12" * 20
    with pytest.raises(ObjectMissing) as e:
        trepo.odb.read_blob(oid)
    assert e.value.oid == oid
    with pytest.raises(ObjectMissing):
        trepo.odb.read_blobs_data_ordered([bytes.fromhex(oid)])


OBJECTS = [("blob", b"x" * n + bytes([n % 256])) for n in (0, 1, 100, 5000)] + [
    ("tree", b""), ("blob", os.urandom(70000))]


def test_port_pack_read_by_kart_tpu(tmp_path):
    with tpacks.PackWriter(str(tmp_path), level=1) as w:
        oids = [w.add(t, c) for t, c in OBJECTS]
        w.add(*OBJECTS[0])  # deduplicated
    pack = jpacks.Packfile(w.pack_path, w.idx_path)
    assert pack.count == len(OBJECTS)
    for oid, obj in zip(oids, OBJECTS):
        assert pack.read(bytes.fromhex(oid)) == obj
    assert open(w.idx_path, "rb").read()[-20:] == hashlib.sha1(
        open(w.idx_path, "rb").read()[:-20]).digest()


def test_kart_tpu_pack_read_by_port(tmp_path):
    with jpacks.PackWriter(str(tmp_path)) as w:
        oids = [w.add(t, c) for t, c in OBJECTS]
        oids += w.add_batch("blob", [b"batch-%d" % i for i in range(50)])
    pack = tpacks.Packfile(w.pack_path, w.idx_path)
    coll = tpacks.PackCollection([str(tmp_path)])
    want = OBJECTS + [("blob", b"batch-%d" % i) for i in range(50)]
    for oid, obj in zip(oids, want):
        assert pack.read(bytes.fromhex(oid)) == obj
    shas = [bytes.fromhex(o) for o in oids][::-1]
    assert coll.read_blob_data_ordered(shas) == [
        c if t == "blob" else None for t, c in want[::-1]]


def _delta(base, target):
    """A git delta: copy base[0:8], insert a literal, copy the rest."""
    def size(n):
        out = bytearray()
        while True:
            b = n & 0x7F
            n >>= 7
            out.append(b | (0x80 if n else 0))
            if not n:
                return bytes(out)
    lit = target[8:-(len(base) - 8)] if len(base) > 8 else target[8:]
    d = size(len(base)) + size(len(target))
    d += bytes([0x80 | 0x10, 8])  # copy offset 0, size 8
    d += bytes([len(lit)]) + lit
    d += bytes([0x80 | 0x01 | 0x10, 8, len(base) - 8])  # copy offset 8, rest
    return d


def test_delta_records_read_alike(tmp_path):
    """OFS_DELTA and REF_DELTA records (git writes them; kart_tpu's writer
    does not) resolve to the same objects in both readers."""
    base = b"0123456789abcdefghij"
    t1 = base[:8] + b"INSERTED" + base[8:]
    t2 = base[:8] + b"OTHER" + base[8:]

    def head(type_code, size):
        byte0 = (type_code << 4) | (size & 0x0F)
        size >>= 4
        out = bytearray()
        while size:
            out.append(byte0 | 0x80)
            byte0 = size & 0x7F
            size >>= 7
        out.append(byte0)
        return bytes(out)

    records, entries = b"", []
    pos = 12

    def add(sha, rec):
        nonlocal records, pos
        entries.append((sha, zlib.crc32(rec) & 0xFFFFFFFF, pos))
        records += rec
        pos += len(rec)

    sha = lambda t, c: hashlib.sha1(b"%s %d\x00" % (t, len(c)) + c).digest()  # noqa: E731
    base_sha = sha(b"blob", base)
    add(base_sha, head(3, len(base)) + zlib.compress(base))
    d1 = _delta(base, t1)
    back = pos - 12  # OFS_DELTA: distance back to the base record
    add(sha(b"blob", t1), head(6, len(d1)) + bytes([back]) + zlib.compress(d1))
    d2 = _delta(base, t2)
    add(sha(b"blob", t2), head(7, len(d2)) + base_sha + zlib.compress(d2))
    body = b"PACK" + struct.pack(">II", 2, 3) + records
    pack_sha = hashlib.sha1(body).digest()
    pack_path = tmp_path / ("pack-%s.pack" % pack_sha.hex())
    pack_path.write_bytes(body + pack_sha)
    idx_path = str(pack_path)[:-5] + ".idx"
    jpacks.write_pack_index(idx_path, entries, pack_sha)
    jp, tp = jpacks.Packfile(str(pack_path)), tpacks.Packfile(str(pack_path))
    for s, content in ((base_sha, base), (sha(b"blob", t1), t1), (sha(b"blob", t2), t2)):
        assert tp.read(s) == jp.read(s) == ("blob", content)
    out = [None] * 3
    filled = tp.read_blob_data_into([sha(b"blob", t2), sha(b"blob", t1), base_sha], out,
                                    [0, 1, 2])
    assert filled.all() and out == [t2, t1, base]
    assert tp.index.all_offsets_sorted().tolist() == sorted(e[2] for e in entries)
