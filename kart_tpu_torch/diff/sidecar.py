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
an older one and the rows that changed (what the changed-block CDC does
for a pushed tip); deriving one inside a commit, and the importer's
capture, are not ported (the port neither commits diffs nor imports).
"""

import json
import os

import numpy as np

from kart_tpu_torch.geom import encode_vertex_column
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


def derive_sidecar(repo, old_block, new_feature_tree_oid, removed, added, added_envs=None):
    """A new feature tree's sidecar from an older int-pk block and the
    change set, in O(changed) array work: ``removed`` the pks that went,
    ``added`` {pk: oid hex} the rows written (an added pk overrides a
    removal). ``added_envs`` {pk: wsen} carries the envelope column over
    when the old block has one. The new sidecar has no vertex column.
    -> its path."""
    keys = old_block.keys[: old_block.count]
    oids_u8 = np.ascontiguousarray(old_block.oids[: old_block.count]).view(np.uint8).reshape(-1, 20)
    envs = (np.asarray(old_block.envelopes)
            if old_block.envelopes is not None and added_envs is not None else None)
    drop = set(removed) | set(added)
    if drop:
        mask = ~np.isin(keys, np.fromiter(drop, dtype=np.int64, count=len(drop)))
        keys, oids_u8 = keys[mask], oids_u8[mask]
        if envs is not None:
            envs = envs[mask]
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
    return save_sidecar(repo, new_feature_tree_oid, keys, oids_u8, envelopes=envs)
