"""The feature envelope index, ``<gitdir>/feature_envelopes.db``: a sqlite
table of 20-byte blob oid -> 10-byte packed EPSG:4326 envelope
(:mod:`kart_tpu_torch.ops.envelope_codec`), and a ``commits`` table of the
commits already indexed.

Counterpart of kart_tpu's ``spatial_filter/index.py``: the reader
(:class:`EnvelopeIndexReader`), and the writer behind ``kart
spatial-filter index`` (:func:`update_spatial_filter_index`), which writes
the same rows as kart_tpu's, so that each package reads an index the other
wrote. Indexing is incremental: a run walks only the commits not yet in
``commits``. Envelopes of projected datasets go to EPSG:4326 through the
vectorized :class:`~kart_tpu_torch.crs.Transform` in buckets of
:attr:`_BatchedEnvelopeExtractor.BATCH` rows, one bucket per transform,
with longitudes past the anti-meridian wrapped into cyclic envelopes
(:func:`wrap_lon`).
"""

import logging
import os
import sqlite3

import numpy as np

from kart_tpu_torch.crs import CRS, Transform, make_crs
from kart_tpu_torch.geometry import Geometry
from kart_tpu_torch.ops.envelope_codec import EnvelopeCodec

L = logging.getLogger(__name__)

DB_NAME = "feature_envelopes.db"

_SCHEMA = """
CREATE TABLE IF NOT EXISTS feature_envelopes (
    blob_id BLOB PRIMARY KEY,
    envelope BLOB NOT NULL
) WITHOUT ROWID;
CREATE TABLE IF NOT EXISTS commits (
    commit_id BLOB PRIMARY KEY
) WITHOUT ROWID;
"""


def db_path(gitdir):
    return os.path.join(gitdir, DB_NAME)


class EnvelopeIndexReader:
    """Read-only access to the envelope table."""

    def __init__(self, path):
        self.path = path
        self.con = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
        self.codec = EnvelopeCodec()
        tables = {
            r[0]
            for r in self.con.execute("SELECT name FROM sqlite_master WHERE type = 'table'")
        }
        # early kart_tpu builds named the table 'blobs'; read it where it is
        self.table = "blobs" if "feature_envelopes" not in tables and "blobs" in tables \
            else "feature_envelopes"

    @classmethod
    def open(cls, gitdir):
        """The reader for the repo at ``gitdir``, or None without an index."""
        path = db_path(gitdir)
        if not os.path.exists(path):
            return None
        return cls(path)

    def all_envelopes(self):
        """-> (oids list[str], (N,4) float64 wsen array), in the table's
        key order."""
        rows = self.con.execute(f"SELECT blob_id, envelope FROM {self.table}").fetchall()
        oids = [r[0].hex() for r in rows]
        if not rows:
            return oids, np.empty((0, 4))
        packed = np.frombuffer(b"".join(r[1] for r in rows), dtype=np.uint8).reshape(
            len(rows), -1
        )
        return oids, self.codec.decode_batch(packed)

    def close(self):
        self.con.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def wrap_lon(v):
    """Longitudes past the anti-meridian wrap rather than clamp: an
    envelope reaching lon 182 becomes part of a cyclic envelope (w > e),
    which the codec stores as it is and every overlap test evaluates
    cyclically. Non-finite values clamp to the bounds."""
    v = np.asarray(v, dtype=np.float64)
    finite = np.isfinite(v)
    with np.errstate(invalid="ignore"):
        wrapped = np.where(
            finite & ((v > 180.0) | (v < -180.0)),
            ((v + 180.0) % 360.0) - 180.0,
            v,
        )
        return np.where(finite, wrapped, np.clip(v, -180.0, 180.0))


def _migrate_legacy_table(con):
    """Early kart_tpu builds named the envelope table 'blobs': rename it in
    place, or the 'commits' table would claim everything indexed while the
    new table sat empty."""
    names = {r[0] for r in con.execute("SELECT name FROM sqlite_master WHERE type = 'table'")}
    if "blobs" in names and "feature_envelopes" not in names:
        con.execute("ALTER TABLE blobs RENAME TO feature_envelopes")
        con.commit()


def update_spatial_filter_index(repo, *, clear=False, dry_run=False):
    """Index the feature envelopes of every commit reachable from a ref or
    HEAD and not indexed yet. -> (features indexed, commits indexed)."""
    con = sqlite3.connect(db_path(repo.gitdir))
    try:
        _migrate_legacy_table(con)
        con.executescript(_SCHEMA)
        if clear:
            con.execute("DELETE FROM feature_envelopes")
            con.execute("DELETE FROM commits")
            con.commit()

        indexed_commits = {row[0].hex() for row in con.execute("SELECT commit_id FROM commits")}
        tips = [oid for _, oid in repo.refs.iter_refs("refs/")]
        head = repo.refs.head_resolved()
        if head:
            tips.append(head)
        todo = [oid for oid in repo.topo_commits(set(tips)) if oid not in indexed_commits]
        if not todo:
            return 0, 0

        extractor = _BatchedEnvelopeExtractor(repo, EnvelopeCodec())
        n_features = 0
        seen_trees = set()
        for commit_oid in todo:
            for ds in repo.structure(commit_oid).datasets:
                n_features += extractor.index_dataset(con, ds, seen_trees)
            con.execute("INSERT OR IGNORE INTO commits (commit_id) VALUES (?)",
                        (bytes.fromhex(commit_oid),))
        extractor.flush(con)
        if dry_run:
            con.rollback()
        else:
            con.commit()
        L.info("indexed %d features over %d commits", n_features, len(todo))
        return n_features, len(todo)
    finally:
        con.close()


class _BatchedEnvelopeExtractor:
    """Gathers (oid, native envelope) rows in one bucket per transform,
    moves each full bucket to EPSG:4326 in one vectorized call, and writes
    its packed rows."""

    BATCH = 4096

    def __init__(self, repo, codec):
        self.repo = repo
        self.codec = codec
        self.crs_4326 = make_crs("EPSG:4326")
        self._pending = {}  # id(transform) -> (transform or None, [(oid bytes, env)])

    def index_dataset(self, con, ds, seen_trees):
        if ds.geom_column_name is None:
            return 0
        try:
            feature_tree = ds.feature_tree
        except KeyError:
            return 0
        if feature_tree is None or feature_tree.oid in seen_trees:
            return 0
        seen_trees.add(feature_tree.oid)

        transform = self._transform_for(ds)
        bucket = self._pending.setdefault(id(transform), (transform, []))[1]
        geom_col = ds.geom_column_name
        already = _IndexedOidCache(con)
        read_blob = self.repo.odb.read_blob
        count = 0
        for path, entry in feature_tree.walk_blobs():
            oid_bytes = bytes.fromhex(entry.oid)
            if already.contains(oid_bytes):
                continue
            try:
                data = read_blob(entry.oid)
                geom = ds.get_feature(ds.decode_path_to_pks(path), data=data).get(geom_col)
            except Exception:  # kart_tpu's policy: an unreadable feature is skipped
                continue
            if geom is None:
                continue
            env = Geometry.of(geom).envelope()
            if env is None:
                continue
            bucket.append((oid_bytes, env))
            count += 1
            if len(bucket) >= self.BATCH:
                self._flush_bucket(con, transform, bucket)
                bucket.clear()
        return count

    def _transform_for(self, ds):
        """The dataset's transform to EPSG:4326, or None for a geographic,
        missing or unusable CRS (indexed in its native axes)."""
        try:
            ids = ds.crs_identifiers()
            crs_wkt = ds.get_crs_definition(ids[0]) if ids else None
            if crs_wkt:
                ds_crs = CRS(crs_wkt)
                if not ds_crs.is_geographic:
                    return Transform(ds_crs, self.crs_4326)
        except Exception as e:  # kart_tpu's policy: index in native axes
            L.debug("indexing %s in native axes (CRS unusable: %s)", getattr(ds, "path", ds), e)
        return None

    def _flush_bucket(self, con, transform, bucket):
        if not bucket:
            return
        envs = np.array([e for _, e in bucket], dtype=np.float64)  # x0 x1 y0 y1
        if transform is not None:
            x0, y0 = transform.transform(envs[:, 0], envs[:, 2])
            x1, y1 = transform.transform(envs[:, 1], envs[:, 3])
            w = np.minimum(x0, x1)
            e = np.maximum(x0, x1)
            s = np.minimum(y0, y1)
            n = np.maximum(y0, y1)
        else:
            w, e, s, n = envs[:, 0], envs[:, 1], envs[:, 2], envs[:, 3]
        # a span of 180 degrees or more is ambiguous once wrapped, and a
        # non-finite edge (out of the projection's domain) cannot be
        # encoded: both leave the row out, so a filtered clone ships the
        # blob (it fails open on a missing row)
        with np.errstate(invalid="ignore"):
            keep = ~((e - w) >= 180.0)
        keep &= np.isfinite(w) & np.isfinite(e) & np.isfinite(s) & np.isfinite(n)
        if not keep.all():
            (idx,) = np.nonzero(keep)
            w, e, s, n = w[idx], e[idx], s[idx], n[idx]
            bucket = [bucket[i] for i in idx]
        if not bucket:
            return
        w = wrap_lon(w)
        e = wrap_lon(e)
        wsen = np.stack([w, np.clip(s, -90, 90), e, np.clip(n, -90, 90)], axis=1)
        packed = self.codec.encode_batch(wsen)
        con.executemany(
            "INSERT OR REPLACE INTO feature_envelopes (blob_id, envelope) VALUES (?, ?)",
            [(bucket[i][0], packed[i].tobytes()) for i in range(len(bucket))],
        )

    def flush(self, con):
        for transform, bucket in self._pending.values():
            self._flush_bucket(con, transform, bucket)
            bucket.clear()


class _IndexedOidCache:
    """Memoized "is this blob already in the table?" for one dataset walk."""

    def __init__(self, con):
        self.con = con
        self._checked = {}

    def contains(self, oid_bytes):
        hit = self._checked.get(oid_bytes)
        if hit is None:
            hit = self.con.execute(
                "SELECT 1 FROM feature_envelopes WHERE blob_id = ?", (oid_bytes,)
            ).fetchone() is not None
            self._checked[oid_bytes] = hit
        return hit
