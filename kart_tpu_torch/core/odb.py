"""The content-addressed object database: git-format loose objects
(``objects/aa/bb...``, zlib of ``"<type> <len>\\0" + content``) and packs.

Reads are tri-state: an object is present, absent (:class:`ObjectMissing`)
or promised by a partial clone's promisor remote (:class:`ObjectPromised`).
A read never yields an empty value for an object that is not there.

Counterpart of kart_tpu's ``core/odb.py`` (``ObjectDb`` loose and packed
reads, alternates, ``write_raw``, ``write_blob``, ``write_many``,
``write_blobs_raw`` (one native call a batch under ``bulk_pack``),
``bulk_pack``, the batch reads
``read_blobs_batch`` and ``read_blobs_data_ordered`` on the native batch
inflate, ``iter_oids``; ``TreeView``). A miss costs a stat of the loose
path and of the pack directory (a rescan only when that changed), so the
transfer's walk and a partial clone's working-copy write ask in batches
(``contains_snapshot``, ``absent``).
"""

import os
import threading
import zlib
from contextlib import contextmanager

import numpy as np

from kart_tpu_torch import faults
from kart_tpu_torch.core.objects import (
    Commit,
    ObjectFormatError,
    Tag,
    TreeEntry,
    hash_object,
    parse_tree,
)
from kart_tpu_torch.core.packs import PackCollection, PackWriter


class ObjectMissing(KeyError):
    """Object not in the store and not promised by any remote."""

    def __init__(self, oid, message=None):
        super().__init__(message or f"Object not found: {oid}")
        self.oid = oid


class ObjectPromised(ObjectMissing):
    """Object not present locally, but a promisor remote has it."""

    def __init__(self, oid):
        super().__init__(oid, f"Object is promised but not present: {oid}")


class ObjectDb:
    def __init__(self, objects_dir, promisor_check=None):
        self.objects_dir = objects_dir
        self._promisor_check = promisor_check or (lambda: False)
        self._alternates = None
        self._packs = None
        self._bulk_writer = None
        self._bulk_lock = threading.Lock()
        self._tree_cache = {}

    @contextmanager
    def bulk_pack(self, level=1):
        """Redirect every object write into one new pack for the duration;
        the objects become readable when the context exits."""
        with self._bulk_lock:
            w = PackWriter(os.path.join(self.objects_dir, "pack"), level=level)
            self._bulk_writer = w
            try:
                yield w
            except BaseException:
                self._bulk_writer = None
                w.abort()
                raise
            self._bulk_writer = None
            faults.fire("odb.bulk_pack")
            if w.finish() is not None:
                self.packs.refresh()

    def pack_writer(self, level=1):
        """A PackWriter into this store's pack directory; after its
        ``finish()`` the caller refreshes ``packs``."""
        return PackWriter(os.path.join(self.objects_dir, "pack"), level=level)

    @property
    def packs(self):
        """The packs of this store and of its alternates."""
        if self._packs is None:
            self._packs = PackCollection([os.path.join(d, "pack")
                                          for d in (self.objects_dir, *self.alternates)])
        return self._packs

    @property
    def alternates(self):
        """The object directories listed in ``objects/info/alternates``,
        whose objects this store reads as its own."""
        alternates = self._alternates
        if alternates is None:
            alternates = []
            info = os.path.join(self.objects_dir, "info", "alternates")
            if os.path.exists(info):
                with open(info) as f:
                    for line in f:
                        line = line.strip()
                        if line and not line.startswith("#"):
                            alternates.append(line)
            self._alternates = alternates
        return alternates

    def add_alternate(self, objects_dir):
        info_dir = os.path.join(self.objects_dir, "info")
        os.makedirs(info_dir, exist_ok=True)
        with open(os.path.join(info_dir, "alternates"), "a") as f:
            f.write(objects_dir + "\n")
        self._alternates = None
        self._packs = None

    def _path(self, oid):
        return os.path.join(self.objects_dir, oid[:2], oid[2:])

    def _find(self, oid):
        """-> the loose object's file, here or in an alternate, or None."""
        for root in (self.objects_dir, *self.alternates):
            p = os.path.join(root, oid[:2], oid[2:])
            if os.path.exists(p):
                return p
        return None

    def _missing(self, oid):
        return ObjectPromised(oid) if self._promisor_check() else ObjectMissing(oid)

    def contains(self, oid):
        if self._find(oid) is not None:
            return True
        sha = bytes.fromhex(oid)
        if sha in self.packs:
            return True
        return self.packs.maybe_refresh() and sha in self.packs  # a pack written since the scan

    def loose_oids(self):
        """The oids of the loose objects, here and in the alternates, from
        one listing of each store."""
        out = set()
        for root in (self.objects_dir, *self.alternates):
            if not os.path.isdir(root):
                continue
            for fan in os.listdir(root):
                d = os.path.join(root, fan)
                if len(fan) == 2 and os.path.isdir(d):
                    out.update(fan + name for name in os.listdir(d) if len(name) == 38)
        return out

    def contains_snapshot(self):
        """-> ``contains`` of the store as it is now, with no file system
        call a query: the packs as scanned and the loose objects listed
        once. For a reader that nothing writes under (a transfer's walk),
        where a stat a query would cost more than the walk."""
        self.packs.maybe_refresh()
        loose, packs = self.loose_oids(), self.packs
        return lambda oid: oid in loose or bytes.fromhex(oid) in packs

    def absent(self, oids):
        """The oids among ``oids`` that the store lacks (packed ones are
        looked up in memory, the loose ones listed once): a batch's misses
        without a stat each."""
        missing = [o for o in oids if bytes.fromhex(o) not in self.packs]
        if missing and self.packs.maybe_refresh():
            missing = [o for o in missing if bytes.fromhex(o) not in self.packs]
        if not missing:
            return set()
        loose = self.loose_oids()
        return {o for o in missing if o not in loose}

    def read_raw(self, oid):
        """-> (type_str, content bytes). Raises ObjectMissing/ObjectPromised.
        Packs are looked at first: a stat of the loose path for each of a
        merge's ~100k tree reads costs more than the reads themselves on a
        slow filesystem."""
        sha = bytes.fromhex(oid)
        packed = self.packs.read(sha)
        if packed is not None:
            return packed
        path = self._find(oid)
        if path is None:
            # a pack written since the scan
            packed = self.packs.read(sha) if self.packs.maybe_refresh() else None
            if packed is None:
                raise self._missing(oid)
            return packed
        with open(path, "rb") as f:
            raw = zlib.decompress(f.read())
        nul = raw.index(b"\x00")
        obj_type, _, size = raw[:nul].decode("ascii").partition(" ")
        content = raw[nul + 1 :]
        if len(content) != int(size):
            raise ObjectFormatError(f"Corrupt object {oid}: size mismatch")
        return obj_type, content

    def read_blobs_data_ordered(self, shas):
        """[20-byte sha] -> [blob bytes] in request order: packed blobs in
        pack order, the rest (loose objects) one by one. Raises
        ObjectMissing/ObjectPromised naming the first absent oid."""
        out = self.packs.read_blob_data_ordered(shas)
        for i, data in enumerate(out):
            if data is None:
                out[i] = self.read_blob(shas[i].hex())
        return out

    def read_trees_ordered(self, shas):
        """[20-byte sha] -> [tree bytes] in request order: packed trees in
        pack order, the rest one by one. Raises ObjectMissing/ObjectPromised
        for an absent one and ObjectFormatError for one that is not a
        tree."""
        out = self.packs.read_blob_data_ordered(shas, "tree")
        for i, data in enumerate(out):
            if data is None:
                obj_type, out[i] = self.read_raw(shas[i].hex())
                if obj_type != "tree":
                    raise ObjectFormatError(f"{shas[i].hex()} is a {obj_type}, expected tree")
        return out

    def read_blobs_batch(self, oids):
        """[hex oid] -> {oid: blob bytes} for the packed non-delta blobs
        among them, batch-inflated in pack order (the diff's chunk
        prefetch, the transfer's enumerator); anything else is left to the
        caller's one-at-a-time read, which raises the right error."""
        shas = {}
        for o in oids:
            try:
                shas[bytes.fromhex(o)] = o
            except ValueError:
                continue
        got = self.packs.read_batch(list(shas))
        return {shas[s]: content for s, (obj_type, content) in got.items() if obj_type == "blob"}

    def write_raw(self, obj_type, content) -> str:
        faults.fire("odb.write_raw")
        if self._bulk_writer is not None:
            return self._bulk_writer.add(obj_type, content)
        oid = hash_object(obj_type, content)
        path = self._path(oid)
        if os.path.exists(path):
            return oid
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(zlib.compress(b"%s %d\x00" % (obj_type.encode(), len(content)) + content, 1))
        os.replace(tmp, path)
        return oid

    def write_blob(self, content) -> str:
        return self.write_raw("blob", content)

    def write_many(self, items):
        """[(type, content)] -> [oid]; objects already here are skipped."""
        return [self.write_raw(t, c) for t, c in items]

    def write_raw_many(self, obj_type, contents):
        """list[bytes] of one object type -> (n, 20) uint8 oid array."""
        if self._bulk_writer is not None:
            return self._bulk_writer.add_batch_raw(obj_type, contents)
        hexes = "".join(self.write_raw(obj_type, c) for c in contents)
        return np.frombuffer(bytes.fromhex(hexes), dtype=np.uint8).reshape(-1, 20)

    def write_blobs_raw(self, contents):
        """list[bytes] -> (n, 20) uint8 oid array."""
        return self.write_raw_many("blob", contents)

    def read_blob(self, oid) -> bytes:
        obj_type, content = self.read_raw(oid)
        if obj_type != "blob":
            raise ObjectFormatError(f"{oid} is a {obj_type}, expected blob")
        return content

    def object_type(self, oid) -> str:
        return self.read_raw(oid)[0]

    def read_commit(self, oid) -> Commit:
        obj_type, content = self.read_raw(oid)
        if obj_type == "tag":  # peel annotated tags
            return self.read_commit(Tag.parse(content).target)
        if obj_type != "commit":
            raise ObjectFormatError(f"{oid} is a {obj_type}, expected commit")
        return Commit.parse(content)

    def write_commit(self, commit: Commit) -> str:
        return self.write_raw("commit", commit.serialise())

    def read_tree_entries(self, oid):
        cached = self._tree_cache.get(oid)
        if cached is not None:
            return cached
        obj_type, content = self.read_raw(oid)
        if obj_type != "tree":
            raise ObjectFormatError(f"{oid} is a {obj_type}, expected tree")
        entries = parse_tree(content)
        if len(self._tree_cache) >= 4096:
            self._tree_cache.clear()
        self._tree_cache[oid] = entries
        return entries

    def tree(self, oid) -> "TreeView":
        return TreeView(self, oid)

    def iter_oids(self):
        """Every oid stored here (not in the alternates), loose and
        packed."""
        seen = set()
        for prefix in sorted(os.listdir(self.objects_dir)):
            if len(prefix) != 2:
                continue
            d = os.path.join(self.objects_dir, prefix)
            for name in sorted(os.listdir(d)):
                if len(name) == 38 and not name.endswith(".tmp"):
                    oid = prefix + name
                    seen.add(oid)
                    yield oid
        own_packs = PackCollection([os.path.join(self.objects_dir, "pack")])
        try:
            for sha in own_packs.iter_shas():
                oid = sha.hex()
                if oid not in seen:
                    yield oid
        finally:
            own_packs.close()

    def find_oids_with_prefix(self, hex_prefix):
        """Oids starting with ``hex_prefix`` (>= 2 chars), loose and packed."""
        fan, rest = hex_prefix[:2], hex_prefix[2:]
        seen = set()
        d = os.path.join(self.objects_dir, fan)
        if os.path.isdir(d):
            for name in sorted(os.listdir(d)):
                if len(name) == 38 and name.startswith(rest):
                    seen.add(fan + name)
        seen.update(self.packs.shas_with_prefix(hex_prefix))
        return sorted(seen)


#: the mode bytes of a subtree entry (git writes "40000")
_TREE_MODES = (b"40000", b"040000")


def _fixed_width_blobs(data, prefix, paths, shas):
    """A leaf tree of blob entries whose names all have one length (an
    int-pk feature leaf) parsed as one (entries, width) matrix: appends its
    paths and 20-byte shas and returns True. False, with nothing appended,
    for any other tree. Every row must start with the first row's mode and
    space and hold its first NUL where the first row does, so the matrix
    reads exactly the entries a sequential parse reads."""
    sp = data.find(b" ")
    nul = data.find(b"\x00", sp + 1)
    width = nul + 21
    if sp <= 0 or nul < 0 or len(data) % width or data[:sp] in _TREE_MODES:
        return False
    rows = np.frombuffer(data, dtype=np.uint8).reshape(-1, width)
    if not ((rows[:, : sp + 1] == rows[0, : sp + 1]).all() and (rows[:, nul] == 0).all()
            and (rows[:, sp + 1 : nul] != 0).all()):
        return False
    name_len = nul - sp - 1
    names = rows[:, sp + 1 : nul].tobytes().decode("utf8")
    if len(names) != name_len * len(rows):
        return False  # multi-byte characters: let the sequential parse slice them
    paths.extend([prefix + names[k : k + name_len] for k in range(0, len(names), name_len)])
    shas.append(rows[:, nul + 1 :].tobytes())
    return True


class TreeView:
    """A tree bound to its object db; subtrees come back as TreeViews and
    blobs as BlobHandles."""

    __slots__ = ("odb", "oid", "name")

    def __init__(self, odb, oid, name=""):
        self.odb = odb
        self.oid = oid
        self.name = name

    def entries(self):
        return self.odb.read_tree_entries(self.oid)

    def __iter__(self):
        for e in self.entries():
            yield self._wrap(e)

    def _wrap(self, entry: TreeEntry):
        if entry.is_tree:
            return TreeView(self.odb, entry.oid, entry.name)
        return BlobHandle(self.odb, entry.oid, entry.name)

    def entry(self, name) -> TreeEntry:
        for e in self.entries():
            if e.name == name:
                return e
        raise KeyError(name)

    def get(self, path):
        """'a/b/c' -> TreeView or BlobHandle. KeyError if absent."""
        node = self
        for part in path.split("/"):
            if not part:
                continue
            if not isinstance(node, TreeView):
                raise KeyError(path)
            node = node._wrap(node.entry(part))
        return node

    def get_or_none(self, path):
        try:
            return self.get(path)
        except ObjectMissing:
            raise
        except KeyError:
            return None

    def walk_blobs(self, prefix=""):
        """Depth-first (path, TreeEntry) for every blob under this tree."""
        for e in self.entries():
            path = f"{prefix}{e.name}"
            if e.is_tree:
                yield from TreeView(self.odb, e.oid).walk_blobs(path + "/")
            else:
                yield path, e

    def blob_columns(self):
        """(paths, oids (N, 20) uint8) of every blob under this tree, in
        :meth:`walk_blobs` order, parsed straight from the raw tree objects
        (no entry objects, no hex strings). The tree is read a level at a
        time, each level's trees in pack order, and a level whose entries
        share one layout (every level of a feature tree) is parsed as one
        matrix: a feature tree of millions of blobs is read in one pass. A
        tree that holds blobs above its deepest level takes the depth-first
        walk."""
        paths, shas = [], []
        level = [("", bytes.fromhex(self.oid))]
        while level:
            datas = self.odb.read_trees_ordered([sha for _, sha in level])
            subtrees = []
            if not _fixed_width_level(datas, [prefix for prefix, _ in level], subtrees, paths,
                                      shas):
                for (prefix, _), data in zip(level, datas):
                    _parse_tree(data, prefix, subtrees, paths, shas)
            if subtrees and paths:
                return self._blob_columns_depth_first()
            level = subtrees
        return paths, np.frombuffer(b"".join(shas), dtype=np.uint8).reshape(-1, 20)

    def _blob_columns_depth_first(self):
        paths, shas = [], []
        odb = self.odb

        def walk(oid, prefix):
            obj_type, data = odb.read_raw(oid)
            if obj_type != "tree":
                raise ObjectFormatError(f"{oid} is a {obj_type}, expected tree")
            subtrees = []
            _parse_tree(data, prefix, subtrees, paths, shas, nested=walk)

        walk(self.oid, "")
        return paths, np.frombuffer(b"".join(shas), dtype=np.uint8).reshape(-1, 20)


def _parse_tree(data, prefix, subtrees, paths, shas, nested=None):
    """One tree object's entries: blobs appended to ``paths``/``shas``,
    subtrees to ``subtrees`` as (prefix, 20-byte sha), or, given
    ``nested(hex oid, prefix)``, walked in place (depth-first order)."""
    if _fixed_width_blobs(data, prefix, paths, shas):
        return
    i, n = 0, len(data)
    while i < n:
        sp = data.index(b" ", i)
        nul = data.index(b"\x00", sp)
        name = data[sp + 1 : nul].decode("utf8")
        sha = data[nul + 1 : nul + 21]
        if data[i:sp] in _TREE_MODES:
            if nested is not None:
                nested(sha.hex(), f"{prefix}{name}/")
            else:
                subtrees.append((f"{prefix}{name}/", sha))
        else:
            paths.append(prefix + name)
            shas.append(sha)
        i = nul + 21


def _fixed_width_level(datas, prefixes, subtrees, paths, shas):
    """Every tree of one level parsed as one (entries, width) matrix when
    all their entries share one mode and one name length (the levels of a
    feature tree): blobs appended to ``paths``/``shas``, subtrees to
    ``subtrees``. -> False, with nothing appended, for any other level."""
    first = next((d for d in datas if d), None)
    if first is None:
        return False
    sp = first.find(b" ")
    nul = first.find(b"\x00", sp + 1)
    width = nul + 21
    if sp <= 0 or nul < 0 or any(len(d) % width for d in datas):
        return False
    rows = np.frombuffer(b"".join(datas), dtype=np.uint8).reshape(-1, width)
    if not ((rows[:, : sp + 1] == rows[0, : sp + 1]).all() and (rows[:, nul] == 0).all()
            and (rows[:, sp + 1 : nul] != 0).all()):
        return False
    name_len = nul - sp - 1
    names = rows[:, sp + 1 : nul].tobytes().decode("utf8")
    if len(names) != name_len * len(rows):
        return False  # multi-byte characters: the sequential parse slices them
    names = [names[k : k + name_len] for k in range(0, len(names), name_len)]
    owners = [p for p, d in zip(prefixes, datas) for _ in range(len(d) // width)]
    if first[:sp] in _TREE_MODES:
        child = rows[:, nul + 1 :].tobytes()
        subtrees.extend((f"{p}{name}/", child[20 * k : 20 * k + 20])
                        for k, (p, name) in enumerate(zip(owners, names)))
    else:
        paths.extend([p + name for p, name in zip(owners, names)])
        shas.append(rows[:, nul + 1 :].tobytes())
    return True


class BlobHandle:
    """Lazy blob reference; ``.data`` reads through the odb."""

    __slots__ = ("odb", "oid", "name")

    def __init__(self, odb, oid, name=""):
        self.odb = odb
        self.oid = oid
        self.name = name

    @property
    def data(self) -> bytes:
        return self.odb.read_blob(self.oid)
