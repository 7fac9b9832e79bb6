"""Git packfiles: the v2 ``.idx`` reader, the pack reader (with OFS_DELTA
and REF_DELTA resolution), and a pack writer.

    pack:   "PACK" | version(4, =2) | count(4) | records... | sha1(pack)
            record = varint header (type in bits 6-4 of byte 0, size
                     4+7+7... bits) [+ ofs-delta backref | ref-delta base
                     sha1] + zlib stream
    idx v2: "\\377tOc" | version(4, =2) | fanout[256] | sha1[n] | crc32[n]
            | offset32[n] (MSB -> index into offset64) | offset64[...]
            | sha1(pack) | sha1(idx)

Counterpart of kart_tpu's ``core/packs.py`` (``PackIndex``, ``Packfile``
with its batch reads, ``apply_delta``, ``PackCollection``, ``PackWriter``
with its framed batches and background flush, the idx writer). Batches
are inflated and framed by the port's native IO core
(:mod:`kart_tpu_torch.native`); the writer emits non-delta records only,
as kart_tpu's does.
"""

import hashlib
import mmap
import os
import struct
import tempfile
import threading
import zlib
from binascii import crc32

import numpy as np

OBJ_COMMIT = 1
OBJ_TREE = 2
OBJ_BLOB = 3
OBJ_TAG = 4
OBJ_OFS_DELTA = 6
OBJ_REF_DELTA = 7

TYPE_NAMES = {OBJ_COMMIT: "commit", OBJ_TREE: "tree", OBJ_BLOB: "blob", OBJ_TAG: "tag"}
TYPE_CODES = {v: k for k, v in TYPE_NAMES.items()}

IDX_MAGIC = b"\xfftOc"


class PackFormatError(ValueError):
    pass


class PackIndex:
    """A .idx v2 file, mmap'd: sha1 -> pack offset through the 256-way
    fanout and a binary search (one at a time or vectorized)."""

    def __init__(self, path):
        self.path = path
        with open(path, "rb") as f:
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        mm = self._mm
        if mm[:4] != IDX_MAGIC or struct.unpack(">I", mm[4:8])[0] != 2:
            raise PackFormatError(f"Not a v2 pack index: {path}")
        self.fanout = struct.unpack(">256I", mm[8 : 8 + 1024])
        self.count = self.fanout[255]
        self._sha_base = 8 + 1024
        self._off_base = self._sha_base + 24 * self.count  # after sha + crc tables
        self._off64_base = self._off_base + 4 * self.count
        self._sha_arr = None
        self._sorted_offsets = None

    def _sha_at(self, i):
        b = self._sha_base + 20 * i
        return self._mm[b : b + 20]

    def _bisect(self, sha):
        first = sha[0]
        lo = self.fanout[first - 1] if first else 0
        hi = self.fanout[first]
        while lo < hi:
            mid = (lo + hi) // 2
            cur = self._sha_at(mid)
            if cur == sha:
                return mid
            if cur < sha:
                lo = mid + 1
            else:
                hi = mid
        return None

    def _offset_at(self, i):
        b = self._off_base + 4 * i
        (off,) = struct.unpack(">I", self._mm[b : b + 4])
        if off & 0x80000000:
            b64 = self._off64_base + 8 * (off & 0x7FFFFFFF)
            (off,) = struct.unpack(">Q", self._mm[b64 : b64 + 8])
        return off

    def offset_of(self, sha):
        """20-byte sha -> byte offset in the pack, or None."""
        i = self._bisect(sha)
        return None if i is None else self._offset_at(i)

    def __contains__(self, sha):
        return self._bisect(sha) is not None

    def offsets_of_batch(self, shas):
        """[20-byte sha] -> int64 offsets (-1 where absent), one vectorized
        searchsorted over the sha table."""
        if self._sha_arr is None:
            self._sha_arr = np.frombuffer(self._mm, dtype="S20", count=self.count,
                                          offset=self._sha_base)
        arr = self._sha_arr
        out = np.full(len(shas), -1, dtype=np.int64)
        if not len(shas) or not self.count:
            return out
        q = np.frombuffer(b"".join(shas), dtype="S20")
        pos = np.searchsorted(arr, q)
        pos_c = np.minimum(pos, self.count - 1)
        hit = (pos < self.count) & (arr[pos_c] == q)
        offs = np.frombuffer(self._mm, dtype=">u4", count=self.count,
                             offset=self._off_base)[pos_c].astype(np.int64)
        out[hit] = offs[hit]
        for i in np.flatnonzero(hit & (offs & 0x80000000 != 0)):
            out[i] = self._offset_at(int(pos_c[i]))  # 64-bit offset table
        return out

    def all_offsets_sorted(self):
        """Every record's offset, ascending (a record ends where the next
        one starts)."""
        if self._sorted_offsets is None:
            offs = np.frombuffer(self._mm, dtype=">u4", count=self.count,
                                 offset=self._off_base).astype(np.int64)
            for i in np.flatnonzero(offs & 0x80000000):
                offs[i] = self._offset_at(int(i))
            self._sorted_offsets = np.sort(offs)
        return self._sorted_offsets

    def iter_shas(self):
        for i in range(self.count):
            yield self._sha_at(i)

    def shas_with_prefix(self, prefix_bytes, odd_nibble=None):
        """Binary sha prefix [+ one extra high nibble] -> matching shas."""
        lo = self.fanout[prefix_bytes[0] - 1] if prefix_bytes[0] else 0
        hi = self.fanout[prefix_bytes[0]]
        out = []
        for i in range(lo, hi):
            sha = self._sha_at(i)
            if sha.startswith(prefix_bytes) and (
                odd_nibble is None or (sha[len(prefix_bytes)] >> 4) == odd_nibble
            ):
                out.append(sha)
        return out


def _decode_varint_header(mm, pos):
    """Pack record header at pos -> (type, size, next_pos)."""
    b = mm[pos]
    pos += 1
    obj_type = (b >> 4) & 7
    size = b & 0x0F
    shift = 4
    while b & 0x80:
        b = mm[pos]
        pos += 1
        size |= (b & 0x7F) << shift
        shift += 7
    return obj_type, size, pos


def _decode_ofs_backref(mm, pos):
    b = mm[pos]
    pos += 1
    off = b & 0x7F
    while b & 0x80:
        b = mm[pos]
        pos += 1
        off = ((off + 1) << 7) | (b & 0x7F)
    return off, pos


def _read_delta_size(data, pos):
    size = shift = 0
    while True:
        b = data[pos]
        pos += 1
        size |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return size, pos


def apply_delta(base, delta):
    """git delta application: copy/insert opcodes over the base buffer."""
    base_size, pos = _read_delta_size(delta, 0)
    if base_size != len(base):
        raise PackFormatError(f"Delta base size mismatch: {base_size} != {len(base)}")
    result_size, pos = _read_delta_size(delta, pos)
    out = bytearray()
    n = len(delta)
    while pos < n:
        op = delta[pos]
        pos += 1
        if op & 0x80:  # copy from base
            cp_off = cp_size = 0
            for i in range(4):
                if op & (1 << i):
                    cp_off |= delta[pos] << (8 * i)
                    pos += 1
            for i in range(3):
                if op & (1 << (4 + i)):
                    cp_size |= delta[pos] << (8 * i)
                    pos += 1
            out += base[cp_off : cp_off + (cp_size or 0x10000)]
        elif op:  # insert literal
            out += delta[pos : pos + op]
            pos += op
        else:
            raise PackFormatError("Delta opcode 0 is reserved")
    if len(out) != result_size:
        raise PackFormatError(f"Delta result size mismatch: {len(out)} != {result_size}")
    return bytes(out)


class PackBaseMissing(PackFormatError):
    def __init__(self, hex_sha):
        super().__init__(f"REF_DELTA base not in pack: {hex_sha}")
        self.hex_sha = hex_sha


class Packfile:
    """One .pack + .idx pair, mmap'd, with delta-chain resolution and a
    small cache of resolved records."""

    def __init__(self, pack_path, idx_path=None):
        self.pack_path = pack_path
        self.index = PackIndex(idx_path or pack_path[:-5] + ".idx")
        with open(pack_path, "rb") as f:
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[:4] != b"PACK":
            raise PackFormatError(f"Not a packfile: {pack_path}")
        (self.version,) = struct.unpack(">I", self._mm[4:8])
        if self.version not in (2, 3):
            raise PackFormatError(f"Unsupported pack version {self.version}")
        (self.count,) = struct.unpack(">I", self._mm[8:12])
        self._cache = {}  # offset -> (type_code, content)

    def close(self):
        self._mm.close()
        self.index._mm.close()

    def _inflate_at(self, pos, expected_size):
        """zlib stream starting at pos -> bytes of length ``expected_size``."""
        d = zlib.decompressobj()
        mm = self._mm
        out = bytearray()
        n = len(mm)
        step = max(expected_size + 64, 4096)
        while not d.eof and pos < n:
            chunk = mm[pos : pos + step]
            out += d.decompress(chunk)
            pos += len(chunk) - len(d.unused_data)
            if d.unused_data:
                break
        if not d.eof or len(out) != expected_size:
            raise PackFormatError(
                f"Inflated size mismatch at {pos}: {len(out)} != {expected_size}"
            )
        return bytes(out)

    def _record_at(self, offset, _depth=0):
        """-> (type_code in 1..4, content bytes), resolving delta chains."""
        if _depth > 64:
            raise PackFormatError("Delta chain too deep")
        cached = self._cache.get(offset)
        if cached is not None:
            return cached
        obj_type, size, pos = _decode_varint_header(self._mm, offset)
        if obj_type == OBJ_OFS_DELTA:
            back, pos = _decode_ofs_backref(self._mm, pos)
            base_type, base = self._record_at(offset - back, _depth + 1)
            content = apply_delta(base, self._inflate_at(pos, size))
        elif obj_type == OBJ_REF_DELTA:
            base_sha = self._mm[pos : pos + 20]
            pos += 20
            base_off = self.index.offset_of(base_sha)
            if base_off is None:
                raise PackBaseMissing(base_sha.hex())
            base_type, base = self._record_at(base_off, _depth + 1)
            content = apply_delta(base, self._inflate_at(pos, size))
        elif obj_type in TYPE_NAMES:
            base_type = obj_type
            content = self._inflate_at(pos, size)
        else:
            raise PackFormatError(f"Bad object type {obj_type} at {offset}")
        if len(self._cache) >= 512:
            self._cache.clear()
        self._cache[offset] = (base_type, content)
        return base_type, content

    def read(self, sha):
        """20-byte sha -> (type_str, content) or None."""
        off = self.index.offset_of(sha)
        if off is None:
            return None
        type_code, content = self._record_at(off)
        return TYPE_NAMES[type_code], content

    #: the payload bytes one native inflate call may hold
    BATCH_BYTE_BUDGET = 256 * 1024 * 1024

    def _inflate_sorted(self, offsets):
        """Batch-inflate the records at ascending ``offsets``: yields (i,
        type code, payload) for each record i the native core inflates
        (type 0 for a delta record, with no payload); a record it finds
        malformed ends the batch and the rest are yielded as (i, None,
        None) for a read one at a time."""
        from kart_tpu_torch import native

        pos = 0
        while pos < len(offsets):
            res = native.inflate_pack_batch(self._mm, offsets[pos:],
                                            max_total=self.BATCH_BYTE_BUDGET)
            if res is None:
                for i in range(pos, len(offsets)):
                    yield i, None, None
                return
            take, types, payload, po = res
            po = po.tolist()
            for i, t in enumerate(types.tolist()):
                yield pos + i, t, (payload[po[i] : po[i + 1]].tobytes() if t else None)
            pos += take

    def read_blob_data_into(self, shas, out, slots, type_code=OBJ_BLOB):
        """For each ``shas[i]`` this pack holds as an object of ``type_code``
        (a blob by default), set ``out[slots[i]]`` to its payload: records
        batch-inflated in pack order, delta chains resolved one at a time.
        -> bool array of the filled positions."""
        offs = self.index.offsets_of_batch(shas)
        filled = np.zeros(len(shas), dtype=bool)
        f_idx = np.flatnonzero(offs >= 0)
        if not len(f_idx):
            return filled
        f_idx = f_idx[np.argsort(offs[f_idx], kind="stable")]
        starts = offs[f_idx]
        f_idx = f_idx.tolist()
        for i, t, content in self._inflate_sorted(starts):
            if t == type_code:
                out[slots[f_idx[i]]] = content
            elif t in (0, None):  # a delta record, or one to read alone
                base_type, content = self._record_at(int(starts[i]))
                if base_type != type_code:
                    continue
                out[slots[f_idx[i]]] = content
            else:
                continue
            filled[f_idx[i]] = True
        return filled

    def read_batch(self, shas):
        """[20-byte sha] -> {sha: (type_str, content)} of the non-delta
        records this pack holds, batch-inflated in pack order; shas it
        lacks and delta records are left to the caller's one-at-a-time
        read."""
        offs = self.index.offsets_of_batch(shas)
        found = sorted((int(off), sha) for off, sha in zip(offs.tolist(), shas) if off >= 0)
        if not found:
            return {}
        starts = np.fromiter((o for o, _ in found), dtype=np.int64, count=len(found))
        return {found[i][1]: (TYPE_NAMES[t], content)
                for i, t, content in self._inflate_sorted(starts) if t in TYPE_NAMES}

    def __contains__(self, sha):
        return sha in self.index


class PackCollection:
    """All packs under one or more ``objects/pack`` directories, scanned
    lazily; ``refresh()`` after writing a new pack."""

    def __init__(self, pack_dirs):
        self.pack_dirs = list(pack_dirs)
        self._packs = None
        self._blob_pack_pref = None
        self._scanned_mtimes = None

    def _dir_mtimes(self):
        out = []
        for d in self.pack_dirs:
            try:
                out.append(os.stat(d).st_mtime_ns)
            except OSError:
                out.append(None)
        return out

    @property
    def packs(self):
        packs = self._packs
        if packs is None:
            packs = []
            self._scanned_mtimes = self._dir_mtimes()
            for d in self.pack_dirs:
                if not os.path.isdir(d):
                    continue
                for name in sorted(os.listdir(d)):
                    if name.endswith(".pack"):
                        idx = os.path.join(d, name[:-5] + ".idx")
                        if os.path.exists(idx):
                            packs.append(Packfile(os.path.join(d, name), idx))
            self._packs = packs
        return packs

    def refresh(self):
        self._packs = None
        self._blob_pack_pref = None

    def maybe_refresh(self):
        """Rescan when a pack directory changed since the last scan (a pack
        another writer added): one stat a directory, so that a loop of
        misses does not reopen every pack. -> True when it rescanned."""
        if self._packs is not None and self._dir_mtimes() == self._scanned_mtimes:
            return False
        self.refresh()
        return True

    def close(self):
        for pack in self._packs or ():
            pack.close()
        self._packs = None

    def read(self, sha):
        """20-byte sha -> (type_str, content) or None."""
        for pack in self.packs:
            got = pack.read(sha)
            if got is not None:
                return got
        return None

    def read_blob_data_ordered(self, shas, obj_type="blob"):
        """[20-byte sha] -> [blob (or ``obj_type``) bytes | None] in request
        order across all packs; the pack that served most of the previous
        call goes first."""
        out = [None] * len(shas)
        slots = list(range(len(shas)))
        sub = list(shas)
        packs = list(self.packs)
        pref = self._blob_pack_pref
        if pref is not None and pref in packs:
            packs.remove(pref)
            packs.insert(0, pref)
        for pack in packs:
            if not sub:
                break
            filled = pack.read_blob_data_into(sub, out, slots, TYPE_CODES[obj_type])
            if filled.any():
                if pack is not pref and filled.sum() * 2 >= len(filled):
                    self._blob_pack_pref = pack
                keep = np.flatnonzero(~filled).tolist()
                sub = [sub[i] for i in keep]
                slots = [slots[i] for i in keep]
        return out

    def read_batch(self, shas):
        """[20-byte sha] -> {sha: (type_str, content)} across all packs,
        batch-inflated; absent shas and delta records are left out."""
        out = {}
        remaining = list(shas)
        for pack in self.packs:
            if not remaining:
                break
            got = pack.read_batch(remaining)
            if got:
                out.update(got)
                remaining = [s for s in remaining if s not in got]
        return out

    def __contains__(self, sha):
        return any(sha in p for p in self.packs)

    def iter_shas(self):
        seen = set()
        for pack in self.packs:
            for sha in pack.index.iter_shas():
                if sha not in seen:
                    seen.add(sha)
                    yield sha

    def shas_with_prefix(self, hex_prefix):
        """Hex prefix (>= 2 chars) -> sorted hex shas across all packs."""
        prefix_bytes = bytes.fromhex(hex_prefix[: len(hex_prefix) // 2 * 2])
        odd = int(hex_prefix[-1], 16) if len(hex_prefix) % 2 else None
        out = set()
        for pack in self.packs:
            for sha in pack.index.shas_with_prefix(prefix_bytes, odd):
                out.add(sha.hex())
        return sorted(out)


def _record_head(obj_type, size):
    byte0 = (TYPE_CODES[obj_type] << 4) | (size & 0x0F)
    size >>= 4
    head = bytearray()
    while size:
        head.append(byte0 | 0x80)
        byte0 = size & 0x7F
        size >>= 7
    head.append(byte0)
    return bytes(head)


class PackWriter:
    """Streams (type, content) records into a new pack + idx v2 pair::

        with PackWriter(pack_dir) as w:
            oid = w.add("blob", data)
        # w.pack_path / w.idx_path now exist

    Records are non-delta, deflated at ``level`` (0 = stored blocks) and
    deduplicated within the pack. A batch of one type (:meth:`add_batch`,
    :meth:`add_batch_raw`) is hashed, deflated and framed in one call of
    the native IO core and written with one file write; the import
    pipeline frames on one thread and appends on another
    (:meth:`append_framed`). Object ids never depend on the route; the
    compressed bytes may (the native core writes payloads of up to 256
    bytes as stored streams), as across zlib versions in git."""

    #: fdatasync the stream every this many bytes, on a helper thread, so
    #: that the disk's writeback of a large import overlaps the stream and
    #: :meth:`finish`'s fsync has little left to flush
    _SYNC_EVERY = 32 << 20

    def __init__(self, pack_dir, level=1):
        self.pack_dir = pack_dir
        self.level = level
        os.makedirs(pack_dir, exist_ok=True)
        fd, self._tmp_path = tempfile.mkstemp(dir=pack_dir, prefix=".tmp-pack-")
        self._f = os.fdopen(fd, "w+b")
        self._f.write(b"PACK" + struct.pack(">II", 2, 0))
        self._entries = []  # (20-byte sha, crc32, offset) of the one-at-a-time path
        self._entry_chunks = []  # (oids (n, 20), crcs, offsets) of whole batches
        self._seen = set()  # exact shas, the ground truth of the dedupe
        # first 8 bytes of every sha as ints: a batch whose prefixes miss
        # them holds no duplicate; only a hit makes the batches' shas exact
        self._seen_pref = set()
        # the batches' sorted prefixes, a stack of runs of decreasing size
        # merged as a binary counter, probed with searchsorted
        self._seen_pref_chunks = []
        self._pending_shas = []  # batch oid arrays not yet in _seen
        self._count = 0
        self._unsynced = 0
        self._flush_thread = None
        self.pack_path = None
        self.idx_path = None

    @property
    def object_count(self):
        return self._count

    def _materialise_pending(self):
        for arr in self._pending_shas:
            b = arr.tobytes()
            self._seen.update(b[i : i + 20] for i in range(0, len(b), 20))
        self._pending_shas = []

    def _have(self, sha):
        if sha in self._seen:
            return True
        if self._pending_shas:
            p = int.from_bytes(sha[:8], "big")
            hit = p in self._seen_pref
            if not hit:
                for arr in self._seen_pref_chunks:
                    i = int(np.searchsorted(arr, p))
                    if i < arr.size and int(arr[i]) == p:
                        hit = True
                        break
            if hit:
                self._materialise_pending()
                return sha in self._seen
        return False

    def add_sha(self, obj_type, content):
        """-> 20-byte sha of the object (written unless already here)."""
        sha = hashlib.sha1(b"%s %d\x00" % (obj_type.encode(), len(content)))
        sha.update(content)
        sha = sha.digest()
        if self._have(sha):
            return sha
        record = _record_head(obj_type, len(content)) + zlib.compress(content, self.level)
        offset = self._f.tell()
        self._f.write(record)
        self._entries.append((sha, crc32(record) & 0xFFFFFFFF, offset))
        self._seen.add(sha)
        self._seen_pref.add(int.from_bytes(sha[:8], "big"))
        self._count += 1
        return sha

    def add(self, obj_type, content):
        """-> hex oid."""
        return self.add_sha(obj_type, content).hex()

    def add_batch(self, obj_type, contents):
        """-> list of hex oids of ``contents``, objects of one type."""
        hexes = self.add_batch_raw(obj_type, contents).tobytes().hex()
        return [hexes[i : i + 40] for i in range(0, len(hexes), 40)]

    def add_batch_raw(self, obj_type, contents):
        """Many objects of one type, hashed, deflated and framed in one
        native call and written with one write. -> (n, 20) uint8 oids."""
        if not contents:
            return np.zeros((0, 20), dtype=np.uint8)
        from kart_tpu_torch import native

        return self.append_framed(
            native.pack_records_batch(obj_type, TYPE_CODES[obj_type], contents, self.level))

    def append_framed(self, framed):
        """Append a framed batch (``native.pack_records_batch``'s result) and
        book its idx entries; -> (n, 20) uint8 oids. Only one thread may
        call it at a time (the import pipeline's pack stage)."""
        oids, crcs, buf, offs = framed
        n = len(oids)
        base = self._f.tell()
        prefs = oids[:, :8].copy().view(">u8").ravel().astype(np.uint64)
        bs = np.sort(prefs)
        clean = n == 1 or not bool((bs[1:] == bs[:-1]).any())
        if clean:
            for arr in self._seen_pref_chunks:
                pos = np.minimum(np.searchsorted(arr, bs), arr.size - 1)
                if bool((arr[pos] == bs).any()):
                    clean = False
                    break
        if clean and self._seen_pref:
            sp = np.fromiter(self._seen_pref, dtype=np.uint64, count=len(self._seen_pref))
            pos = np.minimum(np.searchsorted(bs, sp), bs.size - 1)
            clean = not bool((bs[pos] == sp).any())
        if clean:
            self._f.write(buf)
            self._entry_chunks.append((oids, crcs, base + offs[:n].astype(np.int64)))
            chunks = self._seen_pref_chunks
            chunks.append(bs)
            while len(chunks) >= 2 and chunks[-1].size >= chunks[-2].size:
                b, a = chunks.pop(), chunks.pop()
                at = np.searchsorted(a, b) + np.arange(b.size)
                merged = np.empty(a.size + b.size, dtype=np.uint64)
                keep = np.ones(merged.size, dtype=bool)
                keep[at] = False
                merged[at] = b
                merged[keep] = a
                chunks.append(merged)
            self._pending_shas.append(oids)
            self._count += n
            self._unsynced += len(buf)
            if self._unsynced >= self._SYNC_EVERY:
                self._f.flush()
                t = self._flush_thread
                if t is None or not t.is_alive():
                    t = threading.Thread(target=_advisory_datasync, args=(self._f.fileno(),),
                                         name="kart-pack-sync", daemon=True)
                    t.start()
                    self._flush_thread = t
                self._unsynced = 0
            return oids
        # a duplicate somewhere: skip the records of objects already here,
        # writing the rest in contiguous runs with their offsets shifted
        self._materialise_pending()
        seg_start = shift = 0
        mv = memoryview(buf)
        for i in range(n):
            sha = oids[i].tobytes()
            if sha in self._seen:
                lo, hi = int(offs[i]), int(offs[i + 1])
                if lo > seg_start:
                    self._f.write(mv[seg_start:lo])
                shift += hi - lo
                seg_start = hi
                continue
            self._seen.add(sha)
            self._seen_pref.add(int(prefs[i]))
            self._entries.append((sha, int(crcs[i]), base + int(offs[i]) - shift))
            self._count += 1
        if len(buf) > seg_start:
            self._f.write(mv[seg_start:])
        return oids

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.abort()
        else:
            self.finish()

    def _join_flusher(self):
        t = self._flush_thread
        if t is not None:
            t.join(timeout=60.0)
            self._flush_thread = None

    def abort(self):
        self._join_flusher()
        self._f.close()
        if os.path.exists(self._tmp_path):
            os.remove(self._tmp_path)

    def finish(self):
        """Patch the object count, append the pack trailer, write the idx.
        An empty writer aborts instead. -> pack path, or None when empty.
        The idx tables are sorted on a helper thread while this one
        re-hashes and fsyncs the pack."""
        from kart_tpu_torch import faults

        faults.fire("pack.finalise")
        if not self._count:
            self.abort()
            return None
        self._join_flusher()
        f = self._f
        f.flush()
        prep = {}

        def _prep():
            try:
                prep["tables"] = prepare_pack_index(self._entries, self._entry_chunks)
            except BaseException as exc:  # re-raised below, on this thread
                prep["error"] = exc

        prep_t = threading.Thread(name="kart-idx-prep", target=_prep, daemon=True)
        prep_t.start()
        f.seek(8)
        f.write(struct.pack(">I", self._count))
        f.seek(0)
        sha = hashlib.sha1()
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            sha.update(chunk)
        pack_sha = sha.digest()
        f.write(pack_sha)
        f.flush()
        os.fsync(f.fileno())
        f.close()
        prep_t.join()
        if "error" in prep:
            raise prep["error"]
        name = pack_sha.hex()
        self.pack_path = os.path.join(self.pack_dir, f"pack-{name}.pack")
        self.idx_path = os.path.join(self.pack_dir, f"pack-{name}.idx")
        os.replace(self._tmp_path, self.pack_path)
        write_prepared_index(self.idx_path, prep["tables"], pack_sha)
        return self.pack_path


def _advisory_datasync(fd):
    """Writeback of a pack stream mid-write; :meth:`PackWriter.finish`'s
    fsync is the durability bar, so a failure here changes nothing."""
    try:
        os.fdatasync(fd)
    except OSError:
        pass


def prepare_pack_index(entries, chunks=None):
    """The sorted v2 .idx tables (fanout, shas, crcs, offsets) of
    ``entries`` = [(20-byte sha, crc32, offset)] and the columnar
    ``chunks`` = [(oids (n, 20) uint8, crcs, offsets)], as bytes."""
    n_scalar = len(entries)
    shas = (np.frombuffer(b"".join(e[0] for e in entries), dtype=np.uint8).reshape(n_scalar, 20)
            if n_scalar else np.zeros((0, 20), np.uint8))
    crcs = np.fromiter((e[1] for e in entries), dtype=np.uint64, count=n_scalar)
    offs = np.fromiter((e[2] for e in entries), dtype=np.uint64, count=n_scalar)
    if chunks:
        shas = np.concatenate([shas] + [c[0] for c in chunks])
        crcs = np.concatenate([crcs] + [c[1].astype(np.uint64) for c in chunks])
        offs = np.concatenate([offs] + [c[2].astype(np.uint64) for c in chunks])
    # sort on the first 8 bytes, then order the (rare) tied runs on the rest
    w0 = shas[:, 0:8].copy().view(">u8")[:, 0]
    order = np.argsort(w0, kind="stable")
    w0s = w0[order]
    dup = w0s[1:] == w0s[:-1]
    if dup.any():
        tied = np.flatnonzero(np.concatenate(([False], dup)) | np.concatenate((dup, [False])))
        rows = order[tied]
        w1 = shas[rows, 8:16].copy().view(">u8")[:, 0]
        w2 = np.pad(shas[rows, 16:20], ((0, 0), (0, 4))).copy().view(">u8")[:, 0]
        order[tied] = rows[np.lexsort((w2, w1, w0[rows]))]
    shas, crcs, offs = shas[order], crcs[order], offs[order]
    fanout = np.cumsum(np.bincount(shas[:, 0], minlength=256)).astype(">u4")
    big = offs >= 0x80000000
    off_table = offs.astype(np.uint32)
    off_table[big] = 0x80000000 | np.arange(int(big.sum()), dtype=np.uint32)
    return (fanout.tobytes() + shas.tobytes() + crcs.astype(">u4").tobytes()
            + off_table.astype(">u4").tobytes() + offs[big].astype(">u8").tobytes())


def write_prepared_index(idx_path, tables, pack_sha):
    """Write a v2 .idx from :func:`prepare_pack_index`'s tables and the
    pack's sha; tmp file + rename, so a crash never leaves half an idx."""
    from kart_tpu_torch import faults

    faults.fire("idx.write")
    body = IDX_MAGIC + struct.pack(">I", 2) + tables + pack_sha
    tmp = idx_path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(body)
        f.write(hashlib.sha1(body).digest())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, idx_path)


def write_pack_index(idx_path, entries, pack_sha, chunks=None):
    """Sort, serialise and write a v2 .idx in one call."""
    write_prepared_index(idx_path, prepare_pack_index(entries, chunks), pack_sha)
