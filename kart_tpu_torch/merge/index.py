"""The persistent state of an ongoing merge: :class:`MergeIndex`.

The clean merge result is already a written tree, so the index holds only
the conflicts (each a named ancestor/ours/theirs triple of (path, oid)
entries) and the user's resolves. ``<gitdir>/MERGE_INDEX`` has two
encodings, told apart by content: JSON below ``_BINARY_THRESHOLD``
conflicts, and the columnar binary block "KMIX2" at and above it ("KMIX1"
still reads), so that a 1M-conflict merge writes arrays, not strings.

Counterpart of kart_tpu's ``merge/index.py``, byte for byte in both
encodings: each package reads the other's files.
"""

import json
import struct
from collections.abc import Mapping

import numpy as np

from kart_tpu_torch.core.repo import MERGE_INDEX

VERSION_NAMES = ("ancestor", "ours", "theirs")

_BINARY_THRESHOLD = 10_000
_BINARY_MAGIC_V1 = b"KMIX1\n"
_BINARY_MAGIC = b"KMIX2\n"
# KMIX2 path-block dedup: a path block whose u64 length is this sentinel is
# followed by a u64 version index whose path bytes it shares (the three
# versions of a tree conflict usually carry identical path columns)
_PATH_REF_SENTINEL = 0xFFFFFFFFFFFFFFFF
# KMIX2 derived path block: for int-pk datasets the path column is a pure
# function of the pks, so the block stores {prefix, encoder spec} + the raw
# int64 pk array (8 bytes/row) instead of ~35 bytes/row of path strings —
# the reader rebuilds the same lazy column, nothing materialises until a
# path is touched
_PATH_DERIVED_SENTINEL = 0xFFFFFFFFFFFFFFFE
# same idea for the label column: "<ds>:feature:<pk>" is derivable from
# {ds_path} + the pk array
_LABEL_DERIVED_SENTINEL = 0xFFFFFFFFFFFFFFFD


class AncestorOursTheirs:
    """A named (ancestor, ours, theirs) triple."""

    __slots__ = ("ancestor", "ours", "theirs")

    def __init__(self, ancestor=None, ours=None, theirs=None):
        self.ancestor = ancestor
        self.ours = ours
        self.theirs = theirs

    def get(self, name):
        if name not in VERSION_NAMES:
            raise KeyError(name)
        return getattr(self, name)

    def __iter__(self):
        yield self.ancestor
        yield self.ours
        yield self.theirs

    def as_dict(self):
        return {n: self.get(n) for n in VERSION_NAMES}

    def __repr__(self):
        return f"AOT(a={self.ancestor!r}, o={self.ours!r}, t={self.theirs!r})"


class ConflictEntry:
    """One version of one conflicted item: a (path, oid) pair."""

    __slots__ = ("path", "oid")

    def __init__(self, path, oid):
        self.path = path
        self.oid = oid

    def to_json(self):
        return {"path": self.path, "oid": self.oid}

    @classmethod
    def from_json(cls, d):
        return cls(d["path"], d["oid"]) if d else None


class EncodedPkPaths:
    """Lazy path column for int-pk conflicts: the feature path is a pure
    function of the pk, so nothing is stored — single lookups encode one
    path, ``batch()`` uses the vectorized whole-column encoder (memoised:
    ancestor/ours/theirs share one instance, so the column encodes once).
    KMIX2 stores it as its spec and the pk column."""

    __slots__ = ("prefix", "encoder", "keys", "_batch")

    def __init__(self, prefix, encoder, keys):
        self.prefix = prefix
        self.encoder = encoder
        self.keys = keys
        self._batch = None

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, i):
        if self._batch is not None:
            return self._batch[i]
        return self.prefix + self.encoder.encode_pks_to_path((int(self.keys[i]),))

    def batch(self):
        if self._batch is None:
            self._batch = [
                self.prefix + p for p in self.encoder.encode_paths_batch(self.keys)
            ]
        return self._batch


class RowPaths:
    """Lazy path column backed by a block's path list + per-conflict row
    indices (-1 where the version lacks the row: a version in which the
    dataset is absent)."""

    __slots__ = ("prefix", "paths", "rows")

    def __init__(self, prefix, paths, rows):
        self.prefix = prefix
        self.paths = paths
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.prefix + self.paths[self.rows[i]]

    def batch(self):
        prefix, rows = self.prefix, self.rows
        take = getattr(self.paths, "take", None)
        if take is None:
            paths = self.paths
            return [prefix + paths[r] if r >= 0 else "" for r in rows.tolist()]
        found = take(rows[rows >= 0])[::-1]  # a sidecar's paths, read in one batch
        return [prefix + found.pop() if r >= 0 else "" for r in rows.tolist()]


class PkLabels:
    """Lazy label column `<ds>:feature:<pk>` from the conflict pk array."""

    __slots__ = ("ds_path", "keys")

    def __init__(self, ds_path, keys):
        self.ds_path = ds_path
        self.keys = keys

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, i):
        return f"{self.ds_path}:feature:{int(self.keys[i])}"

    def batch(self):
        head = f"{self.ds_path}:feature:"
        return [head + str(k) for k in self.keys.tolist()]

    def joined_bytes(self, sep=b"\x00"):
        """Serialised column in one pass: the int->str conversion runs as a
        vectorized numpy astype instead of 1M Python str() calls."""
        if len(self.keys) == 0:
            return b""
        head = f"{self.ds_path}:feature:"
        strs = self.keys.astype("U21").tolist()
        return (head + (sep.decode() + head).join(strs)).encode()


class JoinedStrs:
    """Lazy string column over NUL-joined bytes (the KMIX1 on-disk form):
    reading a 1M-conflict index is O(1) until a column is actually touched."""

    __slots__ = ("raw", "n", "_list")

    def __init__(self, raw, n):
        self.raw = raw
        self.n = n
        self._list = None

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.batch()[i]

    def batch(self):
        if self._list is None:
            self._list = self.raw.decode().split("\x00") if self.n else []
        return self._list

    def joined_bytes(self, sep=b"\x00"):
        """Read->rewrite roundtrip (resolve flow): the on-disk bytes are
        already the serialised column."""
        return self.raw if sep == b"\x00" else None


def _materialise_col(src):
    """Path/label column -> list[str]."""
    if isinstance(src, list):
        return src
    return src.batch() if hasattr(src, "batch") else list(src)


def _derived_path_block(paths):
    """KMIX2 derived-block payload for an :class:`EncodedPkPaths` column
    (u32 spec length + JSON {prefix, encoder} + raw little-endian int64
    pks), or None when the column isn't pk-derivable."""
    if not isinstance(paths, EncodedPkPaths):
        return None
    to_dict = getattr(paths.encoder, "to_dict", None)
    if to_dict is None:
        return None
    spec = json.dumps(
        {"prefix": paths.prefix, "encoder": to_dict()}
    ).encode()
    keys = np.ascontiguousarray(paths.keys, dtype="<i8")
    return struct.pack("<I", len(spec)) + spec + keys.tobytes()


def _paths_from_derived_block(payload, n):
    """Inverse of :func:`_derived_path_block`."""
    from kart_tpu_torch.models.paths import PathEncoder

    (slen,) = struct.unpack_from("<I", payload, 0)
    spec = json.loads(payload[4 : 4 + slen].decode())
    keys = np.frombuffer(payload[4 + slen :], dtype="<i8")
    if len(keys) != n:
        raise ValueError(
            f"Corrupt derived path block: {len(keys)} pks for {n} conflicts"
        )
    return EncodedPkPaths(spec["prefix"], PathEncoder.get(**spec["encoder"]), keys)


class ColumnarConflicts(Mapping):
    """Column-oriented conflict set: numpy presence/oid columns plus lazy
    label/path columns. Behaves as the {label: AncestorOursTheirs} mapping
    the rest of the engine expects, but a 1M-conflict merge stores ~60MB of
    arrays instead of 4M Python objects, and serialisation reads the columns
    directly (BASELINE config #5).

    ``versions``: one (present bool (n,), oids_u8 (n, 20), paths) triple per
    ancestor/ours/theirs, where paths is a list or a lazy column
    (:class:`EncodedPkPaths` / :class:`RowPaths`). ``labels`` likewise."""

    __slots__ = ("n", "_labels_src", "versions", "_labels", "_where")

    def __init__(self, labels, versions):
        self.n = len(labels)
        self._labels_src = labels
        self.versions = list(versions)
        self._labels = labels if isinstance(labels, list) else None
        self._where = None

    @property
    def labels(self):
        if self._labels is None:
            self._labels = _materialise_col(self._labels_src)
        return self._labels

    def _label_index(self, label):
        if self._where is None:
            self._where = {l: i for i, l in enumerate(self.labels)}
        return self._where.get(label)

    def _entry(self, v, i):
        present, oids_u8, paths = self.versions[v]
        if not present[i]:
            return None
        return ConflictEntry(paths[i], bytes(oids_u8[i]).hex())

    def _aot(self, i):
        return AncestorOursTheirs(*(self._entry(v, i) for v in range(3)))

    # -- Mapping protocol ----------------------------------------------------

    def __len__(self):
        return self.n

    def __iter__(self):
        return iter(self.labels)

    def __contains__(self, label):
        return self._label_index(label) is not None

    def __getitem__(self, label):
        i = self._label_index(label)
        if i is None:
            raise KeyError(label)
        return self._aot(i)

    def items(self):
        labels = self.labels
        return ((labels[i], self._aot(i)) for i in range(self.n))

    def values(self):
        return (self._aot(i) for i in range(self.n))

    def to_columns(self):
        """-> (labels, [(present, oids_u8, paths)] x3); labels and paths stay
        lazy column objects so the serialiser can use their batch/joined-bytes
        fast paths."""
        labels = self._labels if self._labels is not None else self._labels_src
        return labels, list(self.versions)

    def summary_counts(self):
        """``{(ds_path, part): count}`` — the ``-ss`` conflict summary as
        raw counts. A :class:`PkLabels` column (the common int-pk dataset)
        answers from its shape alone — no label strings materialise, so a
        1M-conflict rejection report costs O(1), not a million f-strings."""
        src = self._labels_src if self._labels is None else self._labels
        if isinstance(src, PkLabels):
            return {(src.ds_path, "feature"): self.n} if self.n else {}
        counts = {}
        for label in self.labels:
            key = tuple(label.split(":", 2)[:2])
            counts[key] = counts.get(key, 0) + 1
        return counts


class CombinedConflicts(Mapping):
    """Ordered chain of conflict mappings (one ColumnarConflicts per dataset
    + a plain dict for meta/attachment conflicts) presenting as one mapping.
    Keeps each part columnar so serialisation never flattens to objects."""

    __slots__ = ("parts",)

    def __init__(self, parts=None):
        self.parts = [p for p in (parts or []) if len(p)]

    def add(self, part):
        if len(part):
            self.parts.append(part)

    def __len__(self):
        return sum(len(p) for p in self.parts)

    def __iter__(self):
        for p in self.parts:
            yield from p

    def __contains__(self, label):
        return any(label in p for p in self.parts)

    def __getitem__(self, label):
        for p in self.parts:
            if label in p:
                return p[label]
        raise KeyError(label)

    def items(self):
        for p in self.parts:
            yield from p.items()

    def values(self):
        for p in self.parts:
            yield from p.values()

    def summary_counts(self):
        """Aggregate ``{(ds_path, part): count}`` over every part, using
        each columnar part's fast path and a label loop for plain dicts."""
        counts = {}
        for p in self.parts:
            sub = getattr(p, "summary_counts", None)
            if sub is not None:
                for key, n in sub().items():
                    counts[key] = counts.get(key, 0) + n
                continue
            for label in p:
                key = tuple(label.split(":", 2)[:2])
                counts[key] = counts.get(key, 0) + 1
        return counts


def _conflicts_as_columns(conflicts):
    """Any conflict mapping -> (labels list, [(present, oids_u8, paths)] x3)
    columns. The common single-dataset case passes the lazy path columns
    straight through (the serialiser uses their batch fast paths); multi-part
    and plain-dict conflict sets are concatenated, looping per item only for
    dict parts."""
    parts = (
        conflicts.parts
        if isinstance(conflicts, CombinedConflicts)
        else [conflicts]
    )
    if len(parts) == 1 and isinstance(parts[0], ColumnarConflicts):
        return parts[0].to_columns()

    labels = []
    cols = [([], [], []) for _ in VERSION_NAMES]  # (present, oids, paths)
    for part in parts:
        if isinstance(part, ColumnarConflicts):
            part_labels, part_versions = part.to_columns()
            labels.extend(_materialise_col(part_labels))
            for v, (present, oids_u8, paths) in enumerate(part_versions):
                cols[v][0].append(np.asarray(present, dtype=np.uint8))
                cols[v][1].append(oids_u8)
                cols[v][2].extend(_materialise_col(paths))
            continue
        n = len(part)
        for v_name, col in zip(VERSION_NAMES, cols):
            present = np.zeros(n, dtype=np.uint8)
            oids = np.zeros((n, 20), dtype=np.uint8)
            paths = []
            for i, aot in enumerate(part.values()):
                entry = aot.get(v_name)
                if entry is not None:
                    present[i] = 1
                    oids[i] = np.frombuffer(bytes.fromhex(entry.oid), np.uint8)
                    paths.append(entry.path)
                else:
                    paths.append("")
            col[0].append(present)
            col[1].append(oids)
            col[2].extend(paths)
        labels.extend(part.keys())
    out = []
    for present_chunks, oid_chunks, paths in cols:
        present = (
            np.concatenate(present_chunks)
            if present_chunks
            else np.zeros(0, dtype=np.uint8)
        )
        oids = (
            np.concatenate(oid_chunks)
            if oid_chunks
            else np.zeros((0, 20), dtype=np.uint8)
        )
        out.append((present, oids, paths))
    return labels, out


class MergeIndex:
    """Conflicts + resolves for an in-progress merge.

    ``conflicts``: label -> AncestorOursTheirs of ConflictEntry|None.
    ``resolves``: label -> list[ConflictEntry] (empty list = resolved as
    delete).
    ``merged_tree``: oid of the tree with all *clean* changes applied.
    """

    def __init__(self, merged_tree, conflicts=None, resolves=None):
        self.merged_tree = merged_tree
        self.conflicts = conflicts or {}
        self.resolves = resolves or {}

    # -- persistence ---------------------------------------------------------

    def to_json(self):
        return {
            "kart.merge_index/v1": {
                "mergedTree": self.merged_tree,
                "conflicts": {
                    label: {
                        name: (entry.to_json() if entry else None)
                        for name, entry in aot.as_dict().items()
                    }
                    for label, aot in self.conflicts.items()
                },
                "resolves": {
                    label: [e.to_json() for e in entries]
                    for label, entries in self.resolves.items()
                },
            }
        }

    @classmethod
    def from_json(cls, data):
        body = data["kart.merge_index/v1"]
        conflicts = {
            label: AncestorOursTheirs(
                **{
                    name: ConflictEntry.from_json(entry)
                    for name, entry in versions.items()
                }
            )
            for label, versions in body["conflicts"].items()
        }
        resolves = {
            label: [ConflictEntry.from_json(e) for e in entries]
            for label, entries in body["resolves"].items()
        }
        return cls(body["mergedTree"], conflicts, resolves)

    # -- binary encoding (columnar, for large conflict sets) ----------------

    def _binary_chunks(self):
        """Yield the KMIX2 byte chunks: magic, u32 header length, JSON header
        {mergedTree, resolves, n}, then per column: u64 byte length +
        payload. Columns: NUL-joined label bytes, then per version (a/o/t) a
        present mask, (n,20) oids, and a path block. A path block is one of:
        plain NUL-joined path bytes (empty for absent rows); a
        _PATH_REF_SENTINEL length + u64 version index sharing an earlier
        version's block; or a _PATH_DERIVED_SENTINEL length + u64 payload
        length + payload ({prefix, encoder spec} + raw int64 pks — int-pk
        paths are recomputed, not stored).

        Columnar conflict sets serialise column-to-column (no per-conflict
        objects); plain dicts are looped in _conflicts_as_columns. Chunked so
        write_to_repo streams to disk without joining a second in-memory
        copy."""
        labels, version_cols = _conflicts_as_columns(self.conflicts)
        n = len(labels)
        header = json.dumps(
            {
                "mergedTree": self.merged_tree,
                "n": n,
                "resolves": {
                    label: [e.to_json() for e in entries]
                    for label, entries in self.resolves.items()
                },
            }
        ).encode()

        yield _BINARY_MAGIC
        yield struct.pack("<I", len(header))
        yield header
        if isinstance(labels, PkLabels):
            spec = json.dumps({"ds_path": labels.ds_path}).encode()
            keys = np.ascontiguousarray(labels.keys, dtype="<i8")
            payload = struct.pack("<I", len(spec)) + spec + keys.tobytes()
            yield struct.pack("<QQ", _LABEL_DERIVED_SENTINEL, len(payload))
            yield payload
        else:
            label_jb = getattr(labels, "joined_bytes", None)
            label_bytes = label_jb() if label_jb is not None else None
            if label_bytes is None:
                label_bytes = "\x00".join(_materialise_col(labels)).encode()
            yield struct.pack("<Q", len(label_bytes))
            yield label_bytes
        # versions routinely share one path column (a tree conflict keeps the
        # same feature path in ancestor/ours/theirs) — encode AND write those
        # bytes once, later versions reference the earlier block (~1/3 the
        # file at 1M conflicts)
        written_paths = {}  # id(path column) -> version index written at
        for v, (present, oids, paths) in enumerate(version_cols):
            yield struct.pack(
                "<Q", len(present)
            )
            yield np.ascontiguousarray(present, dtype=np.uint8).tobytes()
            oid_bytes = np.ascontiguousarray(oids, dtype=np.uint8).tobytes()
            yield struct.pack("<Q", len(oid_bytes))
            yield oid_bytes
            if np.all(present):
                ref = written_paths.get(id(paths))
                if ref is not None:
                    yield struct.pack("<QQ", _PATH_REF_SENTINEL, ref)
                    continue
                derived = _derived_path_block(paths)
                if derived is not None:
                    yield struct.pack(
                        "<QQ", _PATH_DERIVED_SENTINEL, len(derived)
                    )
                    yield derived
                    written_paths[id(paths)] = v
                    continue
                jb = getattr(paths, "joined_bytes", None)
                path_bytes = jb() if jb is not None else None
                if path_bytes is None:
                    path_bytes = "\x00".join(_materialise_col(paths)).encode()
                written_paths[id(paths)] = v
            else:
                # absent rows must serialise with an empty path (padding rows
                # of lazy columns can carry junk paths; mask them out)
                lst = _materialise_col(paths)
                path_bytes = "\x00".join(
                    p if ok else "" for p, ok in zip(lst, present)
                ).encode()
            yield struct.pack("<Q", len(path_bytes))
            yield path_bytes

    def _to_binary(self):
        return b"".join(self._binary_chunks())

    @classmethod
    def _from_binary(cls, raw):
        v2 = raw.startswith(_BINARY_MAGIC)
        pos = len(_BINARY_MAGIC if v2 else _BINARY_MAGIC_V1)
        (hlen,) = struct.unpack_from("<I", raw, pos)
        pos += 4
        header = json.loads(raw[pos : pos + hlen].decode())
        pos += hlen
        n = header["n"]

        def block():
            nonlocal pos
            (blen,) = struct.unpack_from("<Q", raw, pos)
            pos += 8
            if v2 and blen == _PATH_REF_SENTINEL:
                (ref,) = struct.unpack_from("<Q", raw, pos)
                pos += 8
                return ref  # back-reference to version `ref`'s path block
            if v2 and blen in (_PATH_DERIVED_SENTINEL, _LABEL_DERIVED_SENTINEL):
                (plen,) = struct.unpack_from("<Q", raw, pos)
                pos += 8
                payload = raw[pos : pos + plen]
                pos += plen
                kind = "derived" if blen == _PATH_DERIVED_SENTINEL else "labels"
                return (kind, payload)
            data = raw[pos : pos + blen]
            pos += blen
            return data

        label_block = block()
        if isinstance(label_block, tuple):
            (slen,) = struct.unpack_from("<I", label_block[1], 0)
            spec = json.loads(label_block[1][4 : 4 + slen].decode())
            keys = np.frombuffer(label_block[1][4 + slen :], dtype="<i8")
            if len(keys) != n:
                raise ValueError(
                    f"Corrupt derived label block: {len(keys)} pks for {n}"
                )
            labels = PkLabels(spec["ds_path"], keys)
        else:
            labels = JoinedStrs(label_block, n)
        versions = []
        for _ in VERSION_NAMES:
            present = np.frombuffer(block(), dtype=np.uint8)
            oids = np.frombuffer(block(), dtype=np.uint8).reshape(n, 20)
            path_block = block()
            if isinstance(path_block, int):
                paths = versions[path_block][2]  # shared column object
            elif isinstance(path_block, tuple):
                paths = _paths_from_derived_block(path_block[1], n)
            else:
                paths = JoinedStrs(path_block, n)
            versions.append((present, oids, paths))

        # stays columnar on read: `kart conflicts`/`kart resolve` on a
        # 1M-conflict index materialise only the entries they actually touch
        conflicts = ColumnarConflicts(labels, versions)
        resolves = {
            label: [ConflictEntry.from_json(e) for e in entries]
            for label, entries in header["resolves"].items()
        }
        return cls(header["mergedTree"], conflicts, resolves)

    # -- repo persistence ----------------------------------------------------

    def write_to_repo(self, repo):
        import os

        path = repo.gitdir_file(MERGE_INDEX)
        if len(self.conflicts) >= _BINARY_THRESHOLD:
            tmp = path + f".tmp{os.getpid()}"
            try:
                with open(tmp, "wb") as f:
                    for chunk in self._binary_chunks():
                        f.write(chunk)
                os.replace(tmp, path)
            except BaseException:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise
        else:
            repo.write_gitdir_file(MERGE_INDEX, json.dumps(self.to_json()))

    @classmethod
    def read_from_repo(cls, repo):
        import os

        path = repo.gitdir_file(MERGE_INDEX)
        if not os.path.exists(path):
            from kart_tpu_torch.core.repo import InvalidOperation

            raise InvalidOperation(
                "Repository is in 'merging' state but MERGE_INDEX is missing - "
                'run "kart merge --abort" to recover'
            )
        with open(path, "rb") as f:
            raw = f.read()
        if raw.startswith(_BINARY_MAGIC) or raw.startswith(_BINARY_MAGIC_V1):
            return cls._from_binary(raw)
        return cls.from_json(json.loads(raw.decode()))

    # -- resolution ----------------------------------------------------------

    @property
    def unresolved_labels(self):
        return [l for l in self.conflicts if l not in self.resolves]

    def add_resolve(self, label, entries):
        if label not in self.conflicts:
            raise KeyError(label)
        self.resolves[label] = entries

    def write_resolved_tree(self, odb):
        """All conflicts resolved -> the final tree's oid."""
        assert not self.unresolved_labels
        from kart_tpu_torch.core.tree_builder import TreeBuilder

        tb = TreeBuilder(odb, self.merged_tree)
        for label, aot in self.conflicts.items():
            # clear every version's path, then write the resolution
            for entry in aot:
                if entry is not None:
                    tb.remove(entry.path)
            for entry in self.resolves.get(label, ()):
                tb.insert(entry.path, entry.oid)
        return tb.flush()
