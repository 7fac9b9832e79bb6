"""Git packfiles: the v2 ``.idx`` reader, the pack reader (with OFS_DELTA
and REF_DELTA resolution), and a pack writer.

    pack:   "PACK" | version(4, =2) | count(4) | records... | sha1(pack)
            record = varint header (type in bits 6-4 of byte 0, size
                     4+7+7... bits) [+ ofs-delta backref | ref-delta base
                     sha1] + zlib stream
    idx v2: "\\377tOc" | version(4, =2) | fanout[256] | sha1[n] | crc32[n]
            | offset32[n] (MSB -> index into offset64) | offset64[...]
            | sha1(pack) | sha1(idx)

Counterpart of kart_tpu's ``core/packs.py`` (``PackIndex``, ``Packfile``,
``apply_delta``, ``PackCollection``, ``PackWriter``, the idx writer).
Where kart_tpu batch-inflates through its optional C++ library, this
module runs a zlib loop; the writer emits non-delta records only, as
kart_tpu's does.
"""

import hashlib
import mmap
import os
import struct
import tempfile
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

    def _inflate_at(self, pos, expected_size, end=None):
        """zlib stream starting at pos (ending by ``end`` when known) ->
        bytes of length ``expected_size``."""
        d = zlib.decompressobj()
        mm = self._mm
        if end is not None:
            out = d.decompress(mm[pos:end])
        else:
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

    def read_blob_data_into(self, shas, out, slots, type_code=OBJ_BLOB):
        """For each ``shas[i]`` this pack holds as an object of ``type_code``
        (a blob by default), set ``out[slots[i]]`` to its payload (records
        read in pack order, each inflated in one call over its exact
        extent). -> bool array of the filled positions."""
        offs = self.index.offsets_of_batch(shas)
        filled = np.zeros(len(shas), dtype=bool)
        f_idx = np.flatnonzero(offs >= 0)
        if not len(f_idx):
            return filled
        f_idx = f_idx[np.argsort(offs[f_idx], kind="stable")]
        starts = offs[f_idx]
        all_offs = self.index.all_offsets_sorted()
        nxt = np.searchsorted(all_offs, starts, side="right")
        ends = np.where(nxt < len(all_offs), all_offs[np.minimum(nxt, len(all_offs) - 1)],
                        len(self._mm) - 20)
        mm = self._mm
        for j, start, end in zip(f_idx.tolist(), starts.tolist(), ends.tolist()):
            obj_type, size, pos = _decode_varint_header(mm, start)
            if obj_type == type_code:
                out[slots[j]] = self._inflate_at(pos, size, end)
            elif obj_type in (OBJ_OFS_DELTA, OBJ_REF_DELTA):
                base_type, content = self._record_at(start)
                if base_type != type_code:
                    continue
                out[slots[j]] = content
            else:
                continue
            filled[j] = True
        return filled

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

    def __contains__(self, sha):
        return any(sha in p for p in self.packs)

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

    Records are non-delta, deflated at ``level`` (0 = stored blocks),
    deduplicated within the pack."""

    def __init__(self, pack_dir, level=1):
        self.pack_dir = pack_dir
        self.level = level
        os.makedirs(pack_dir, exist_ok=True)
        fd, self._tmp_path = tempfile.mkstemp(dir=pack_dir, prefix=".tmp-pack-")
        self._f = os.fdopen(fd, "w+b")
        self._f.write(b"PACK" + struct.pack(">II", 2, 0))
        self._pos = 12
        self._entries = {}  # 20-byte sha -> (crc32, offset)
        self.pack_path = None
        self.idx_path = None

    @property
    def object_count(self):
        return len(self._entries)

    def add_sha(self, obj_type, content):
        """-> 20-byte sha of the object (written unless already here)."""
        sha = hashlib.sha1(b"%s %d\x00" % (obj_type.encode(), len(content)))
        sha.update(content)
        sha = sha.digest()
        if sha not in self._entries:
            record = _record_head(obj_type, len(content)) + zlib.compress(content, self.level)
            self._f.write(record)
            self._entries[sha] = (crc32(record) & 0xFFFFFFFF, self._pos)
            self._pos += len(record)
        return sha

    def add(self, obj_type, content):
        """-> hex oid."""
        return self.add_sha(obj_type, content).hex()

    def add_batch_raw(self, obj_type, contents):
        """:meth:`add_sha` of many objects of one type: the same records, a
        loop with its lookups hoisted, and at level 0 each small record's
        stored block written as the bytes ``zlib.compress(content, 0)``
        gives, without a deflate stream's setup for each (a feature tree
        writes millions). -> (n, 20) uint8 oid array."""
        head = b"%s %%d\x00" % obj_type.encode()
        entries, write, sha1 = self._entries, self._f.write, hashlib.sha1
        pack, adler, stored = struct.pack, zlib.adler32, self.level == 0
        record_heads = {}
        pos = self._pos
        shas = []
        for content in contents:
            n = len(content)
            h = sha1(head % n)
            h.update(content)
            sha = h.digest()
            shas.append(sha)
            if sha in entries:
                continue
            rh = record_heads.get(n)
            if rh is None:
                rh = record_heads[n] = _record_head(obj_type, n)
            if stored and n < 32768:
                record = b"".join((rh, b"\x78\x01\x01", pack("<HH", n, n ^ 0xFFFF), content,
                                   pack(">I", adler(content))))
            else:
                record = rh + zlib.compress(content, self.level)
            write(record)
            entries[sha] = (crc32(record) & 0xFFFFFFFF, pos)
            pos += len(record)
        self._pos = pos
        return np.frombuffer(b"".join(shas), dtype=np.uint8).reshape(-1, 20).copy()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.abort()
        else:
            self.finish()

    def abort(self):
        self._f.close()
        if os.path.exists(self._tmp_path):
            os.remove(self._tmp_path)

    def finish(self):
        """Patch the object count, append the pack trailer, write the idx.
        An empty writer aborts instead. -> pack path, or None when empty."""
        if not self._entries:
            self.abort()
            return None
        f = self._f
        f.flush()
        f.seek(8)
        f.write(struct.pack(">I", len(self._entries)))
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
        name = pack_sha.hex()
        self.pack_path = os.path.join(self.pack_dir, f"pack-{name}.pack")
        self.idx_path = os.path.join(self.pack_dir, f"pack-{name}.idx")
        os.replace(self._tmp_path, self.pack_path)
        write_pack_index(self.idx_path, self._entries, pack_sha)
        return self.pack_path


def write_pack_index(idx_path, entries, pack_sha):
    """Write a v2 .idx for ``entries`` = {20-byte sha: (crc32, offset)};
    tmp file + rename, so a crash never leaves half an idx."""
    n = len(entries)
    keys = np.frombuffer(b"".join(entries), dtype="S20")
    order = np.argsort(keys, kind="stable")
    values = np.fromiter((v for pair in entries.values() for v in pair), dtype=np.uint64,
                         count=2 * n).reshape(n, 2)[order]
    crcs, offs = values[:, 0], values[:, 1]
    sha_arr = keys[order].view(np.uint8).reshape(n, 20)
    fanout = np.cumsum(np.bincount(sha_arr[:, 0], minlength=256)).astype(">u4")
    big = offs >= 0x80000000
    off_table = offs.astype(np.uint32)
    off_table[big] = 0x80000000 | np.arange(int(big.sum()), dtype=np.uint32)
    body = (
        IDX_MAGIC + struct.pack(">I", 2) + fanout.tobytes() + sha_arr.tobytes()
        + crcs.astype(">u4").tobytes() + off_table.astype(">u4").tobytes()
        + offs[big].astype(">u8").tobytes() + pack_sha
    )
    tmp = idx_path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(body)
        f.write(hashlib.sha1(body).digest())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, idx_path)
