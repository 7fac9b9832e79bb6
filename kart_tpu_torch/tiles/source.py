"""Commit-pinned tile data source: one dataset version's columnar identity
(its sidecar FeatureBlock) and the block-pruned row selection a tile runs
against it.

A :class:`TileSource` is keyed by commit oid, never by ref, so everything
it derives (the mmap'd sidecar block, the fallback envelope and vertex
columns, the block aggregates) holds for the life of the revision and is
shared by every tile of it; :func:`source_for` keeps the recent ones.

Row selection classifies the sidecar's per-block union bboxes against the
tile's padded query rectangle (:func:`kart_tpu_torch.ops.bbox
.classify_env_blocks_np`): all-out blocks are never read, all-in blocks
give every row, and only boundary blocks' envelope rows are scanned.

Counterpart of kart_tpu's ``tiles/source.py``: the same rows, the same
fallbacks and the same errors. kart_tpu's fallbacks read a geometry's own
coordinates, with no CRS transform, and so do these.
"""

import os
import threading
import time
from collections import OrderedDict

import numpy as np

from kart_tpu_torch.ops.bbox import (
    BLOCK_ALL_IN,
    BLOCK_ALL_OUT,
    bbox_intersects_np,
    classify_env_blocks_np,
)


class TileSourceError(ValueError):
    """The (commit, dataset) pair cannot serve tiles: no such dataset, no
    geometry column, no feature identity."""


class TileDataUnavailable(TileSourceError):
    """Feature values are needed (the geojson and props layers) but a blob
    is promised or absent."""


class TileSource:
    """One (commit oid, dataset path) pair, ready to answer tile queries.

    ``block`` is the unpadded sidecar FeatureBlock (mmap'd keys and oids,
    and the envelope column with its block aggregates when the sidecar
    carries them). A sidecar without envelopes gets in-memory fallback
    columns built once from the feature blobs; a dataset without a geometry
    column is refused."""

    def __init__(self, repo, commit_oid, ds_path):
        from kart_tpu_torch.core.structure import RepoStructure
        from kart_tpu_torch.diff import sidecar

        self.repo = repo
        self.commit_oid = commit_oid
        self.ds_path = ds_path
        structure = RepoStructure(repo, commit_oid)
        ds = structure.datasets.get(ds_path)
        if ds is None:
            raise TileSourceError(f"No dataset {ds_path!r} at commit {commit_oid[:12]}")
        if ds.geom_column_name is None:
            raise TileSourceError(f"Dataset {ds_path!r} has no geometry column; tiles need one")
        self.dataset = ds
        block = sidecar.ensure_block(repo, ds, pad=False)
        if block is None:
            raise TileSourceError(
                f"Dataset {ds_path!r} at {commit_oid[:12]} has no feature "
                f"identity (empty feature tree?)"
            )
        self.block = block
        self._lock = threading.Lock()
        self._fallback_envs = None
        self._fallback_aggs = None
        self._fallback_verts = None

    # -- envelope and vertex columns -----------------------------------------

    def envelopes(self):
        """(count, 4) f32 wsen envelope columns: the sidecar's, or the
        fallback built once from the blobs."""
        if self.block.envelopes is not None:
            return self.block.envelopes
        with self._lock:
            if self._fallback_envs is None:
                self._fallback_envs = self._build_fallback_envelopes()
            return self._fallback_envs

    def _build_fallback_envelopes(self, chunk=100_000):
        """One pass over the feature blobs in the block's row order; a row
        whose envelope cannot be read (NULL or undecodable geometry) gets
        the whole world and appears in every tile."""
        from kart_tpu_torch.diff.sidecar import _feature_envelope_wsen

        ds = self.dataset
        geom_col = ds.geom_column_name
        n = self.block.count
        out = np.empty((n, 4), dtype=np.float32)
        for lo in range(0, n, chunk):
            rows = np.arange(lo, min(lo + chunk, n), dtype=np.int64)
            data = self.feature_blobs(rows)
            for i, (pks, blob) in enumerate(zip(self.pks_for_rows(rows), data)):
                feature = ds.get_feature(pks, data=blob)
                out[lo + i] = _feature_envelope_wsen(feature, geom_col)
        return out

    def vertices(self):
        """The revision's :class:`kart_tpu_torch.geom.VertexColumn` for the
        geom layer: the sidecar's geometry section, else a column built once
        from the blobs. Unreadable geometries are kind 0 (the layer draws
        their envelope box), and a source whose blobs cannot be read at all
        gets an all-kind-0 column rather than an error."""
        col = self.block.vertex_column()
        if col is not None:
            return col
        with self._lock:
            if self._fallback_verts is None:
                self._fallback_verts = self._build_fallback_vertices()
            return self._fallback_verts

    def _build_fallback_vertices(self, chunk=100_000):
        from kart_tpu_torch.geom import VertexColumn, vertex_column_from_blobs

        ds = self.dataset
        geom_col = ds.geom_column_name
        n = self.block.count
        parts = []
        for lo in range(0, n, chunk):
            rows = np.arange(lo, min(lo + chunk, n), dtype=np.int64)
            try:
                data = self.feature_blobs(rows)
            except TileDataUnavailable:
                return VertexColumn.empty(n)
            blobs = []
            for pks, blob in zip(self.pks_for_rows(rows), data):
                value = ds.get_feature(pks, data=blob).get(geom_col)
                blobs.append(bytes(value) if value is not None else None)
            parts.append(vertex_column_from_blobs(blobs))
        if not parts:
            return VertexColumn.empty(0)
        return parts[0] if len(parts) == 1 else _concat_columns(parts)

    def env_blocks(self):
        """(agg (nb, 4) f32, flags (nb,) u8, block_rows), or None for a
        sidecar with envelopes but no aggregates (a full scan)."""
        if self.block.envelopes is not None:
            return self.block.env_blocks
        from kart_tpu_torch.diff.sidecar import AGG_BLOCK_ROWS, block_aggregates

        envs = self.envelopes()
        with self._lock:
            if self._fallback_aggs is None and len(envs):
                agg, flags = block_aggregates(envs, AGG_BLOCK_ROWS)
                self._fallback_aggs = (agg, flags, AGG_BLOCK_ROWS)
            return self._fallback_aggs

    # -- the block-pruned row selection --------------------------------------

    def rows_for_bbox(self, query_wsen):
        """-> (ascending int64 rows whose envelope meets the query
        rectangle, stats): ``blocks_total``, ``blocks_pruned``,
        ``blocks_read`` (boundary and all-in) and ``rows_scanned``."""
        n = self.block.count
        query = np.asarray(query_wsen, dtype=np.float64)
        stats = {"blocks_total": 0, "blocks_pruned": 0, "blocks_read": 0, "rows_scanned": 0}
        if n == 0:
            return np.zeros(0, dtype=np.int64), stats
        envs = self.envelopes()
        blocks = self.env_blocks()
        if blocks is None:
            stats["blocks_total"] = stats["blocks_read"] = 1
            stats["rows_scanned"] = n
            return np.flatnonzero(bbox_intersects_np(envs, query)), stats
        agg, flags, block_rows = blocks
        cls = classify_env_blocks_np(agg, flags, query)
        nb = len(cls)
        pruned = int(np.count_nonzero(cls == BLOCK_ALL_OUT))
        stats.update(blocks_total=nb, blocks_pruned=pruned, blocks_read=nb - pruned)
        parts = []
        for b in np.nonzero(cls != BLOCK_ALL_OUT)[0]:
            lo = int(b) * block_rows
            hi = min(lo + block_rows, n)
            if cls[b] == BLOCK_ALL_IN:
                parts.append(np.arange(lo, hi, dtype=np.int64))
            else:
                stats["rows_scanned"] += hi - lo
                hit = bbox_intersects_np(envs[lo:hi], query)
                parts.append(np.flatnonzero(hit).astype(np.int64) + lo)
        idx = np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)
        return idx, stats

    # -- values --------------------------------------------------------------

    def pks_for_rows(self, rows):
        """-> pk tuples of the given rows (an int-pk key is the pk; a
        hash-keyed dataset decodes its stored paths)."""
        ds = self.dataset
        keys = self.block.keys
        if ds.path_encoder.scheme == "int":
            return [(int(keys[i]),) for i in rows]
        return [ds.decode_path_to_pks(self.block.paths[int(i)]) for i in rows]

    def feature_blobs(self, rows):
        """Feature blob bytes of the given rows, in order: the ordered pack
        read, then one object at a time for the rest. Raises
        :class:`TileDataUnavailable` for a promised or absent blob."""
        from kart_tpu_torch.core.odb import ObjectMissing, ObjectPromised
        from kart_tpu_torch.ops.blocks import unpack_oid_bytes, unpack_oid_hex

        odb = self.dataset._feature_odb()
        oid_rows = np.asarray(self.block.oids[rows])
        data = odb.packs.read_blob_data_ordered(unpack_oid_bytes(oid_rows))
        missing = [i for i, d in enumerate(data) if d is None]
        if missing:
            for i, oid_hex in zip(missing, unpack_oid_hex(oid_rows[missing])):
                try:
                    data[i] = odb.read_blob(oid_hex)
                except (ObjectPromised, ObjectMissing):
                    raise TileDataUnavailable(
                        f"Feature blob {oid_hex} of {self.ds_path!r} is "
                        f"not present locally (partial clone?); serve the "
                        f"binary layer only, or backfill first"
                    )
        return data


def _concat_columns(parts):
    """VertexColumns in row order -> one."""
    from kart_tpu_torch.geom import VertexColumn

    feat, ring, shift_r, shift_v = [np.zeros(1, np.int64)], [np.zeros(1, np.int64)], 0, 0
    for p in parts:
        feat.append(p.feat_offsets[1:] + shift_r)
        ring.append(p.ring_offsets[1:] + shift_v)
        shift_r += int(p.feat_offsets[-1])
        shift_v += int(p.ring_offsets[-1])
    return VertexColumn(
        np.concatenate([p.kinds for p in parts]), np.concatenate(feat), np.concatenate(ring),
        np.concatenate([p.x for p in parts]), np.concatenate([p.y for p in parts]))


# ---------------------------------------------------------------------------
# the per-process source cache: (gitdir, commit, dataset) -> TileSource,
# bounded by an LRU (fallback columns can be large)
# ---------------------------------------------------------------------------

_SOURCES = OrderedDict()
_SOURCES_MAX = 8
_SOURCES_INFLIGHT = {}  # key -> threading.Event of a build in progress
_sources_lock = threading.Lock()

#: how long a caller waits on another thread's build before building itself
_SOURCE_BUILD_TIMEOUT = 600.0


def source_for(repo, commit_oid, ds_path):
    """The cached :class:`TileSource` of (repo, commit, dataset). Concurrent
    callers for one key share one build."""
    key = (os.path.realpath(repo.gitdir), commit_oid, ds_path)
    deadline = time.monotonic() + _SOURCE_BUILD_TIMEOUT
    own_event = None
    while own_event is None:
        with _sources_lock:
            src = _SOURCES.get(key)
            if src is not None:
                _SOURCES.move_to_end(key)
                return src
            event = _SOURCES_INFLIGHT.get(key)
            if event is None:
                _SOURCES_INFLIGHT[key] = own_event = threading.Event()
                break
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break  # a wedged build: build independently
        event.wait(min(remaining, 60.0))
    try:
        src = TileSource(repo, commit_oid, ds_path)
        with _sources_lock:
            _SOURCES[key] = src
            _SOURCES.move_to_end(key)
            while len(_SOURCES) > _SOURCES_MAX:
                _SOURCES.popitem(last=False)
        return src
    finally:
        if own_event is not None:
            with _sources_lock:
                if _SOURCES_INFLIGHT.get(key) is own_event:
                    _SOURCES_INFLIGHT.pop(key, None)
            own_event.set()


def drop_sources(gitdir=None):
    """Drop cached sources: all, or those of one repository."""
    with _sources_lock:
        if gitdir is None:
            _SOURCES.clear()
        else:
            real = os.path.realpath(gitdir)
            for key in [k for k in _SOURCES if k[0] == real]:
                _SOURCES.pop(key, None)
