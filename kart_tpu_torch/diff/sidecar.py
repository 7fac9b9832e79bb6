"""Columnar sidecar files (KCOL1): read by mmap, and written byte for byte
as kart_tpu writes them.

Layout (one file per feature tree, ``.kart/columnar/<tree-oid>.kcol``):

    magic   b"KCOL1\\n"
    header  one json line: {"count": N, "keys_are_pks": bool,
                            "paths_bytes": M, "envelope_bytes": E,
                            "agg_block_rows": B}   (B only with aggregates)
    arrays  keys   int64[N]    little-endian, sorted: the pk, or the
                               filename hash of a hash-keyed dataset
            oids   uint8[N,20]
            offs   uint32[N+1], paths utf8   (hash-keyed files only: the
                                              blob paths under feature/)
            envs   float32[N,4]              (when envelope_bytes > 0)
            agg    float32[ceil(N/B),4]      (when agg_block_rows is set:
                                              per-block union wsen)
            flags  uint8[ceil(N/B)]          (non-zero: aggregate not tight)
            geom   bytes                     (when geom_bytes is set)

A hash-keyed file's paths are read through :class:`LazyPaths`, a view
that decodes one path when it is asked for, so a diff decodes only its
changed rows' filenames. The ``geom`` section (the vertex column of
:mod:`kart_tpu_torch.geom`) is written as kart_tpu writes it, and read as
an undecoded view that :meth:`FeatureBlock.vertex_column` decodes on first
use. The repo-level helpers (:func:`sidecar_file`, :func:`has_sidecar`,
:func:`load_block`, :func:`ensure_block`, :func:`save_sidecar`,
:func:`build_sidecar`, :func:`derive_sidecar`) mirror kart_tpu's
``diff/sidecar.py``, with :func:`_feature_envelope_wsen` for envelopes
read from blobs. :func:`derive_sidecar` writes a new tree's sidecar from
an older one and the rows that changed: the changed-block CDC does it for
a pushed tip (envelopes, no vertex column), and a commit does it through
:func:`update_sidecar_for_commit` from its feature deltas (envelopes and
the vertex column, carried over from the parent's sidecar).
:class:`SidecarCapture` collects an import's (key, oid) columns as they
stream and writes the new tree's sidecar from them, with no tree walk.
"""

import json
import os

import numpy as np

from kart_tpu_torch.core.objects import hash_object
from kart_tpu_torch.geom import VertexColumn, encode_vertex_column, vertex_column_from_blobs
from kart_tpu_torch.geometry import Geometry
from kart_tpu_torch.ops.blocks import PAD_KEY, FeatureBlock, bucket_size, hash_keys_for_paths

MAGIC = b"KCOL1\n"

#: rows per envelope-aggregate block, as kart_tpu writes them
AGG_BLOCK_ROWS = 4096


class SidecarError(ValueError):
    """A sidecar file is truncated or malformed."""


class LazyPaths:
    """List-like view of a hash-keyed sidecar's paths section (offsets and
    utf8 bytes): a path is decoded only when it is looked up, alone or as
    one of the rows :meth:`take` decodes in a batch."""

    __slots__ = ("offs", "data")

    def __init__(self, offs, data):
        self.offs = offs
        self.data = memoryview(data)

    def __len__(self):
        return len(self.offs) - 1

    def __getitem__(self, i):
        return str(self.data[self.offs[i] : self.offs[i + 1]], "utf8")

    def take(self, rows):
        """The paths of ``rows`` (int array), as a list of str."""
        rows = np.asarray(rows, dtype=np.int64)
        data = self.data
        return [str(data[a:b], "utf8")
                for a, b in zip(self.offs[rows].tolist(), self.offs[rows + 1].tolist())]


def _paths_section(paths, order):
    """Paths in ``order`` -> (uint32 offsets (N+1,), utf8 bytes). ``paths``
    is a list of str, or an (N, W) uint8 matrix of ascii paths all W
    bytes long."""
    if isinstance(paths, np.ndarray):
        n, width = paths.shape
        return (np.arange(n + 1, dtype=np.int64) * width).astype("<u4"), paths[order].tobytes()
    ordered = [paths[i] for i in order.tolist()]
    text = "".join(ordered)
    data = text.encode("utf8")
    if len(data) == len(text):  # ascii: a path's byte length is its length
        lengths = np.fromiter(map(len, ordered), dtype=np.int64, count=len(ordered))
    else:
        lengths = np.fromiter((len(p.encode("utf8")) for p in ordered), dtype=np.int64,
                              count=len(ordered))
    offs = np.zeros(len(ordered) + 1, dtype="<u4")
    offs[1:] = np.cumsum(lengths)
    return offs, data


def block_aggregates(env_arr, block_rows, chunk_rows=4_194_304):
    """(N,4) f32 envelopes -> ((nb,4) f32 union bboxes, (nb,) u8 flags).
    Wrapping members widen their block's union to full longitude and flag
    it; degenerate (n < s) and non-finite members flag it; NaN members
    widen it to the whole world. Same bytes as kart_tpu's writer."""
    n = len(env_arr)
    nb = -(-n // block_rows)
    agg = np.empty((nb, 4), dtype=np.float32)
    flags = np.zeros(nb, dtype=np.uint8)
    chunk_blocks = max(1, chunk_rows // block_rows)
    for b0 in range(0, nb, chunk_blocks):
        b1 = min(b0 + chunk_blocks, nb)
        lo, hi = b0 * block_rows, min(b1 * block_rows, n)
        m = hi - lo
        pad = np.empty(((b1 - b0) * block_rows, 4), dtype=np.float32)
        pad[:m] = env_arr[lo:hi]
        pad[m:] = (np.inf, np.inf, -np.inf, -np.inf)  # neutral for min/max
        wraps = pad[:m, 2] < pad[:m, 0]
        degen = pad[:m, 3] < pad[:m, 1]
        nonfin = ~np.isfinite(pad[:m]).all(axis=1)
        if wraps.any():
            pad[:m, 0] = np.where(wraps, np.float32(-180.0), pad[:m, 0])
            pad[:m, 2] = np.where(wraps, np.float32(180.0), pad[:m, 2])
        nans = np.isnan(pad[:m]).any(axis=1)
        if nans.any():
            pad[:m][nans] = (-180.0, -90.0, 180.0, 90.0)
        bad = wraps | degen | nonfin
        if bad.any():
            flags[b0 + np.unique(np.nonzero(bad)[0] // block_rows)] = 1
        r = pad.reshape(b1 - b0, block_rows, 4)
        agg[b0:b1, 0] = r[:, :, 0].min(axis=1)
        agg[b0:b1, 1] = r[:, :, 1].min(axis=1)
        agg[b0:b1, 2] = r[:, :, 2].max(axis=1)
        agg[b0:b1, 3] = r[:, :, 3].max(axis=1)
    return agg, flags


def save_sidecar_file(path, keys, oids_u8, envelopes=None, vertices=None, *, paths=None):
    """Write a sidecar. ``keys`` int64 (N,), ``oids_u8`` uint8 (N, 20),
    ``envelopes`` (N, 4) wsen or None, ``vertices`` a
    :class:`~kart_tpu_torch.geom.VertexColumn` of N rows or None, ``paths``
    the N blob paths of a hash-keyed dataset, whose keys are their hashes
    (a list, or a fixed-width matrix: :func:`_paths_section`), or None for
    an int-pk one -- not necessarily sorted. Atomic (tmp +
    rename). -> path."""
    order = np.argsort(keys, kind="stable")
    keys = np.ascontiguousarray(np.asarray(keys)[order], dtype="<i8")
    oids_u8 = np.ascontiguousarray(np.asarray(oids_u8)[order], dtype=np.uint8)
    offs, path_blob = (None, b"") if paths is None else _paths_section(paths, order)
    env_arr = agg = flags = None
    if envelopes is not None:
        env_arr = np.ascontiguousarray(np.asarray(envelopes)[order], dtype="<f4")
        if len(env_arr):
            agg, flags = block_aggregates(env_arr, AGG_BLOCK_ROWS)
    geom_blob = b""
    if vertices is not None and len(vertices) == len(keys):
        geom_blob = encode_vertex_column(vertices.take(order))
    header_fields = {
        "count": int(len(keys)),
        "keys_are_pks": paths is None,
        "paths_bytes": len(path_blob),
        "envelope_bytes": int(env_arr.nbytes) if env_arr is not None else 0,
    }
    if agg is not None:
        header_fields["agg_block_rows"] = AGG_BLOCK_ROWS
    if geom_blob:
        header_fields["geom_bytes"] = len(geom_blob)
    header = json.dumps(header_fields).encode() + b"\n"
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(header)
        f.write(keys.tobytes())
        f.write(oids_u8.tobytes())
        if offs is not None:
            f.write(offs.tobytes())
            f.write(path_blob)
        if env_arr is not None:
            f.write(env_arr.tobytes())
        if agg is not None:
            f.write(np.ascontiguousarray(agg, dtype="<f4").tobytes())
            f.write(flags.tobytes())
        if geom_blob:
            f.write(geom_blob)
    os.replace(tmp, path)
    return path


def load_block_file(path, pad=False):
    """KCOL1 file -> FeatureBlock of mmap views (keys, oids, envelopes and
    block aggregates; a hash-keyed file's paths as :class:`LazyPaths`);
    ``pad=True`` copies keys/oids into bucket-padded arrays. Raises
    SidecarError on a malformed file."""
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    try:
        if bytes(mm[: len(MAGIC)]) != MAGIC:
            raise SidecarError(f"{path}: not a KCOL1 sidecar")
        nl = int(np.flatnonzero(mm[len(MAGIC) : len(MAGIC) + 256] == 0x0A)[0])
        header = json.loads(bytes(mm[len(MAGIC) : len(MAGIC) + nl]))
        n = int(header["count"])
        hashed = not header["keys_are_pks"]
        paths_bytes = int(header.get("paths_bytes", 0)) if hashed else 0
        pos = len(MAGIC) + nl + 1
        end = pos + 28 * n + int(header.get("envelope_bytes", 0))
        if hashed:
            end += 4 * (n + 1) + paths_bytes
        block_rows = int(header.get("agg_block_rows", 0))
        if header.get("envelope_bytes") and block_rows:
            end += 17 * -(-n // block_rows)
        geom_bytes = int(header.get("geom_bytes", 0))
        end += geom_bytes
        if end > len(mm):
            raise SidecarError(f"{path}: truncated ({len(mm)} of {end} bytes)")
        keys = np.frombuffer(mm, dtype="<i8", count=n, offset=pos)
        pos += 8 * n
        oids_u8 = np.frombuffer(mm, dtype=np.uint8, count=20 * n, offset=pos)
        pos += 20 * n
        paths = None
        if hashed:
            offs = np.frombuffer(mm, dtype="<u4", count=n + 1, offset=pos)
            pos += 4 * (n + 1)
            paths = LazyPaths(offs, mm[pos : pos + paths_bytes])
            pos += paths_bytes
        envelopes = env_blocks = None
        if header.get("envelope_bytes"):
            envelopes = np.frombuffer(mm, dtype="<f4", count=4 * n, offset=pos).reshape(n, 4)
            pos += int(header["envelope_bytes"])
            if block_rows:
                nb = -(-n // block_rows)
                agg = np.frombuffer(mm, dtype="<f4", count=4 * nb, offset=pos).reshape(nb, 4)
                pos += 16 * nb
                flags = np.frombuffer(mm, dtype=np.uint8, count=nb, offset=pos)
                env_blocks = (agg, flags, block_rows)
                pos += nb
        geom_raw = mm[pos : pos + geom_bytes] if geom_bytes else None
    except (IndexError, KeyError, TypeError, ValueError) as e:
        if isinstance(e, SidecarError):
            raise
        raise SidecarError(f"{path}: malformed sidecar ({e})") from e

    oid_rows = (
        oids_u8.reshape(n, 5, 4).view(np.uint32).reshape(n, 5)
        if n else np.zeros((0, 5), dtype=np.uint32)
    )
    if pad:
        size = bucket_size(max(n, 1))
        keys_p = np.full(size, PAD_KEY, dtype=np.int64)
        keys_p[:n] = keys
        oids_p = np.zeros((size, 5), dtype=np.uint32)
        oids_p[:n] = oid_rows
        keys, oid_rows = keys_p, oids_p
    return FeatureBlock(keys, oid_rows, n, envelopes=envelopes,
                        env_blocks=env_blocks, paths=paths, geom_raw=geom_raw)


def sidecar_file(repo, feature_tree_oid):
    """The sidecar path of a feature tree: ``.kart/columnar/<oid>.kcol``."""
    return os.path.join(repo.gitdir, "columnar", feature_tree_oid + ".kcol")


class SidecarCapture:
    """The (key, oid) rows an import writes, captured as it streams: an
    int-pk dataset's pks, or a hash-keyed one's paths, with the blob oids;
    :meth:`save` writes the sidecar from them."""

    def __init__(self):
        self._pk_chunks = []  # int64 arrays
        self._path_chunks = []  # lists of paths under feature/
        self._oid_chunks = []  # 20 bytes an oid
        self.count = 0

    def add_int_raw(self, pks, oid_bytes):
        """An int64 pk array and its concatenated 20-byte oids."""
        self._pk_chunks.append(np.asarray(pks, dtype=np.int64))
        self._oid_chunks.append(oid_bytes)
        self.count += len(pks)

    def add_path_batch(self, rel_paths, oid_hexes):
        self._path_chunks.append(list(rel_paths))
        self._oid_chunks.append(bytes.fromhex("".join(oid_hexes)))
        self.count += len(rel_paths)

    def int_columns(self):
        """(pks int64 (n,), oids (n, 20) uint8) of an int-pk capture, or
        None: the importer builds the feature tree from them."""
        if not self._pk_chunks or self._path_chunks:
            return None
        return (np.concatenate(self._pk_chunks),
                np.frombuffer(b"".join(self._oid_chunks), dtype=np.uint8).reshape(-1, 20))

    def mark(self):
        """A checkpoint of what was captured, for :meth:`rewind` (the
        pipelined import's restart after a native-reader fallback)."""
        return len(self._pk_chunks), len(self._path_chunks), len(self._oid_chunks), self.count

    def rewind(self, mark):
        """Drop everything captured since ``mark``."""
        n_pk, n_path, n_oid, count = mark
        del self._pk_chunks[n_pk:]
        del self._path_chunks[n_path:]
        del self._oid_chunks[n_oid:]
        self.count = count

    def replace_int_columns(self, pks_arr, oids_u8):
        """Replace the captured int-pk columns (the importer's last-wins
        dedup: the sidecar holds what the tree holds)."""
        self._pk_chunks = [np.ascontiguousarray(pks_arr, dtype=np.int64)]
        self._oid_chunks = [np.ascontiguousarray(oids_u8, dtype=np.uint8).tobytes()]
        self.count = len(pks_arr)

    def save(self, repo, feature_tree_oid):
        """Write the sidecar of ``feature_tree_oid``; -> its path, or None
        when nothing (or a mix of keys) was captured."""
        if not self.count:
            return None
        oids_u8 = np.frombuffer(b"".join(self._oid_chunks), dtype=np.uint8).reshape(-1, 20)
        if self._pk_chunks and not self._path_chunks:
            return save_sidecar(repo, feature_tree_oid, np.concatenate(self._pk_chunks), oids_u8)
        if self._path_chunks and not self._pk_chunks:
            paths = [p for chunk in self._path_chunks for p in chunk]
            return save_sidecar(repo, feature_tree_oid, hash_keys_for_paths(paths), oids_u8,
                                paths=paths)
        return None


def has_sidecar(repo, dataset):
    feature_tree = dataset.feature_tree
    return feature_tree is not None and os.path.exists(
        sidecar_file(repo, feature_tree.oid)
    )


def load_block(repo, dataset, pad=False):
    """A dataset version's FeatureBlock from its sidecar (mmap views unless
    ``pad``), or None when the file is absent or malformed (it is a cache:
    the caller takes the tree walk)."""
    feature_tree = dataset.feature_tree
    if feature_tree is None:
        return None
    try:
        return load_block_file(sidecar_file(repo, feature_tree.oid), pad=pad)
    except (OSError, SidecarError):
        return None


def ensure_block(repo, dataset, pad=False):
    """A dataset version's FeatureBlock: its sidecar, built from one walk of
    the feature tree when absent or malformed."""
    block = load_block(repo, dataset, pad=pad)
    if block is None:
        block = build_sidecar(repo, dataset, pad=pad)
    return block


def _feature_envelope_wsen(feature, geom_col):
    """(w, s, e, n) of one feature's geometry; the whole world for a NULL,
    empty or unreadable geometry, or without a geometry column (such a row
    matches every spatial predicate)."""
    full = (-180.0, -90.0, 180.0, 90.0)
    if geom_col is None:
        return full
    geom = feature.get(geom_col) if hasattr(feature, "get") else None
    if geom is None:
        return full
    try:
        env = Geometry.of(geom).envelope()  # (x0, x1, y0, y1)
    except Exception:
        return full
    if env is None:
        return full
    x0, x1, y0, y1 = env
    return (x0, y0, x1, y1)


def save_sidecar(repo, feature_tree_oid, keys, oids_u8, envelopes=None, vertices=None, *,
                 paths=None):
    """Persist a sidecar for a feature tree (keys, oids and a hash-keyed
    dataset's ``paths`` need not be sorted). -> path."""
    os.makedirs(os.path.join(repo.gitdir, "columnar"), exist_ok=True)
    return save_sidecar_file(sidecar_file(repo, feature_tree_oid), keys, oids_u8, envelopes,
                             vertices, paths=paths)


def build_sidecar(repo, dataset, pad=False):
    """Walk the dataset's feature tree once and persist its sidecar: pks as
    keys, or for a hash-keyed dataset the filename hashes with the paths.
    -> the FeatureBlock read back, or None when it has no feature tree."""
    feature_tree = dataset.feature_tree
    if feature_tree is None:
        return None
    paths, pk_arr, oids_u8 = dataset.feature_index()
    if pk_arr is not None:
        save_sidecar(repo, feature_tree.oid, pk_arr.astype(np.int64), oids_u8)
    else:
        save_sidecar(repo, feature_tree.oid, hash_keys_for_paths(paths), oids_u8, paths=paths)
    return load_block(repo, dataset, pad=pad)


def update_sidecar_for_commit(repo, old_ds, new_feature_tree_oid, feature_diff):
    """Derive the sidecar of a commit's new feature tree from the parent
    dataset's sidecar and the commit's feature deltas, in O(changed) work:
    an int-pk dataset only, and nothing when the new tree has a sidecar
    already or the parent has none (a sidecar is a cache). The parent's
    envelope and vertex columns are carried over, the added rows' read
    from their new values. -> the sidecar's path, or None."""
    if old_ds is None or old_ds.feature_tree is None:
        return None
    if old_ds.path_encoder.scheme != "int":
        return None
    target = sidecar_file(repo, new_feature_tree_oid)
    if os.path.exists(target):
        return target
    block = load_block(repo, old_ds)
    if block is None:
        return None
    schema = old_ds.schema
    geom_col = old_ds.geom_column_name
    removed, added = set(), {}
    added_envs = {} if block.envelopes is not None else None
    added_geoms = {} if block.vertex_column() is not None else None
    for delta in feature_diff.values():
        if delta.old is not None:
            removed.add(int(delta.old_key))
        if delta.new is not None:
            pk_values, blob = schema.encode_feature_blob(delta.new_value)
            pk = int(pk_values[0])
            added[pk] = hash_object("blob", blob)
            if added_envs is not None:
                added_envs[pk] = _feature_envelope_wsen(delta.new_value, geom_col)
            if added_geoms is not None:
                value = (delta.new_value.get(geom_col)
                         if geom_col is not None and hasattr(delta.new_value, "get") else None)
                added_geoms[pk] = bytes(value) if value else None
    return derive_sidecar(repo, block, new_feature_tree_oid, removed, added, added_envs,
                          added_geoms)


def derive_sidecar(repo, old_block, new_feature_tree_oid, removed, added, added_envs=None,
                   added_geoms=None):
    """A new feature tree's sidecar from an older int-pk block and the
    change set, in O(changed) array work: ``removed`` the pks that went,
    ``added`` {pk: oid hex} the rows written (an added pk overrides a
    removal). ``added_envs`` {pk: wsen} carries the envelope column over
    when the old block has one, and ``added_geoms`` {pk: GPKG geometry or
    None} the vertex column the same way: kept rows are gathered, added
    rows extracted. -> its path."""
    keys = old_block.keys[: old_block.count]
    oids_u8 = np.ascontiguousarray(old_block.oids[: old_block.count]).view(np.uint8).reshape(-1, 20)
    envs = (np.asarray(old_block.envelopes)
            if old_block.envelopes is not None and added_envs is not None else None)
    verts = old_block.vertex_column() if added_geoms is not None else None
    drop = set(removed) | set(added)
    if drop:
        mask = ~np.isin(keys, np.fromiter(drop, dtype=np.int64, count=len(drop)))
        keys, oids_u8 = keys[mask], oids_u8[mask]
        if envs is not None:
            envs = envs[mask]
        if verts is not None:
            verts = verts.take(np.flatnonzero(mask))
    if added:
        add_keys = np.fromiter(added.keys(), dtype=np.int64, count=len(added))
        add_oids = np.frombuffer(bytes.fromhex("".join(added.values())),
                                 dtype=np.uint8).reshape(-1, 20)
        keys = np.concatenate([keys, add_keys])
        oids_u8 = np.concatenate([oids_u8, add_oids])
        if envs is not None:
            add_env = np.array([added_envs[int(pk)] for pk in add_keys],
                               dtype=np.float32).reshape(-1, 4)
            envs = np.concatenate([envs, add_env])
        if verts is not None:
            add_verts = vertex_column_from_blobs(added_geoms.get(int(pk)) for pk in add_keys)
            verts = VertexColumn.concat([verts, add_verts])
    return save_sidecar(repo, new_feature_tree_oid, keys, oids_u8, envelopes=envs,
                        vertices=verts)
