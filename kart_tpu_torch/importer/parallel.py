"""The fanned-out import: an int-pk GPKG table's features spread over
worker processes, each of which

1. reads one contiguous pk range of the table (an indexed range scan),
2. encodes its rows with ``GPKGImportSource.batch_row_encoder``, the
   serial route's encoder,
3. hashes, deflates and frames each batch in one native call into a pack
   of its own, and writes its whole leaf trees
   (``feature_tree.emit_leaf_trees``),

and returns ``[(leaf tree path, tree oid)]``; the parent inserts the
leaves under the dataset's feature root with the tree builder.

Shard bounds are count-balanced pk quantiles aligned down to a multiple of
``branches``, so that every leaf tree ``(pk // branches) % max_trees``
lands whole in one worker. ``shardable`` refuses negative pks and a pk
span wider than ``branches ** (levels + 1)``, where two buckets could
share a leaf index.

The workers start from ``spawn``: the parent may hold threads and a
card's context, which a fork would copy half-made. A worker imports only
the port's host modules (no torch, no CUDA), and the parent's main module
(``python -m kart_tpu_torch`` keeps its CLI under the main guard). The
pool's resource tracker is stopped with the pool.

Counterpart of kart_tpu's ``importer/parallel.py``, with the same shards,
objects and trees.
"""

import contextlib
import multiprocessing
import os
import sqlite3
from concurrent.futures import ProcessPoolExecutor

from kart_tpu_torch.core.objects import MODE_TREE

#: a worker per this many features at most
MIN_FEATURES_FOR_PARALLEL = 20_000


def default_workers():
    """``KART_IMPORT_WORKERS`` when set, else the core count, or 1 with
    fewer than 4 cores (or none known), where the in-process pipeline
    wins."""
    env = os.environ.get("KART_IMPORT_WORKERS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    cores = os.cpu_count()
    if cores is None or cores < 4:
        return 1
    return cores


def clamp_workers(n_workers, feature_count):
    """No more workers than one per :data:`MIN_FEATURES_FOR_PARALLEL`
    features, and at least 1."""
    if feature_count <= 0:
        return 1
    return max(1, min(n_workers, feature_count // MIN_FEATURES_FOR_PARALLEL))


def shardable(source, encoder, n_workers):
    """True when this (source, encoder) pair can take the fan-out."""
    from kart_tpu_torch.adapters.gpkg import quote
    from kart_tpu_torch.importer import GPKGImportSource

    if n_workers < 2 or encoder.scheme != "int":
        return False
    if not isinstance(source, GPKGImportSource):
        return False
    if source.feature_count < MIN_FEATURES_FOR_PARALLEL:
        return False
    pk_cols = [c for c in source.schema.columns if c.pk_index is not None]
    if len(pk_cols) != 1:
        return False
    con = sqlite3.connect(source.gpkg_path)
    try:
        lo, hi = con.execute(f"SELECT MIN({quote(pk_cols[0].name)}), "
                             f"MAX({quote(pk_cols[0].name)}) "
                             f"FROM {quote(source.table_name)}").fetchone()
    finally:
        con.close()
    if lo is None or lo < 0:
        return False
    return (hi - lo) < encoder.branches ** (encoder.levels + 1)


def _shard_bounds(source, pk_name, branches, n_shards):
    """Count-balanced interior shard bounds: pk quantiles from the pk
    index, each aligned down to a multiple of ``branches``, sorted and
    unique (fewer than asked for on a skewed table). Each quantile query
    steps OFFSET from the previous bound, one pass over the index in
    all."""
    from kart_tpu_torch.adapters.gpkg import quote

    con = sqlite3.connect(source.gpkg_path)
    try:
        q_pk, q_table = quote(pk_name), quote(source.table_name)
        (total,) = con.execute(f"SELECT COUNT(*) FROM {q_table}").fetchone()
        step = total // n_shards
        if step == 0:
            return []
        bounds = set()
        prev = None
        for _ in range(1, n_shards):
            if prev is None:
                row = con.execute(f"SELECT {q_pk} FROM {q_table} ORDER BY {q_pk} "
                                  f"LIMIT 1 OFFSET ?", (step,)).fetchone()
            else:
                row = con.execute(f"SELECT {q_pk} FROM {q_table} WHERE {q_pk} >= ? "
                                  f"ORDER BY {q_pk} LIMIT 1 OFFSET ?", (prev, step)).fetchone()
            if row is None:
                break
            prev = row[0]
            bounds.add(prev - prev % branches)
    finally:
        con.close()
    return sorted(bounds)


@contextlib.contextmanager
def _stops_resource_tracker():
    """Stop, on the way out, the resource tracker the pool starts, unless
    one ran before (the caller's): it would outlive the pool until this
    process exits."""
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    had_tracker = tracker._pid is not None
    try:
        yield
    finally:
        if not had_tracker:
            tracker._stop()


def run_parallel_import(repo, tb, source, ds_path, encoder, prefix, n_workers, log=None,
                        capture=None):
    """Fan the source out over ``n_workers`` processes and insert their
    leaf trees under ``prefix`` in ``tb``; ``capture`` (a SidecarCapture)
    gets each worker's (pk, oid) columns. -> the feature count."""
    schema_dicts = source.schema.to_column_dicts()
    (pk_col,) = [c for c in source.schema.columns if c.pk_index is not None]
    bounds = _shard_bounds(source, pk_col.name, encoder.branches, n_workers)
    edges = [None, *bounds, None]  # [lo, hi) a shard; None is an open end
    args = [(os.path.join(repo.gitdir, "objects"), source.gpkg_path, source.table_name,
             schema_dicts, encoder.to_dict(), edges[i], edges[i + 1])
            for i in range(len(edges) - 1)]
    total = 0
    ctx = multiprocessing.get_context("spawn")
    with _stops_resource_tracker(), ProcessPoolExecutor(max_workers=len(args),
                                                        mp_context=ctx) as pool:
        for count, leaf_entries, pks, oid_bytes in pool.map(_import_shard, args):
            total += count
            for leaf_path, tree_oid in leaf_entries:
                tb.insert(prefix + leaf_path, tree_oid, mode=MODE_TREE)
            if capture is not None and count:
                capture.add_int_raw(pks, oid_bytes)
    repo.odb.packs.refresh()
    if log:
        log(f"  {ds_path}: {total} features over {len(args)} workers")
    return total


def _import_shard(packed_args):
    """A worker: read one pk range of the table, encode it in batches and
    write one pack of its feature blobs and leaf trees. -> (count,
    [(leaf tree path, tree oid)], pks int64, oid bytes)."""
    objects_dir, gpkg_path, table_name, schema_dicts, encoder_dict, lo, hi = packed_args

    import numpy as np

    from kart_tpu_torch.adapters.gpkg import quote
    from kart_tpu_torch.core.feature_tree import emit_leaf_trees, plan_int_feature_tree
    from kart_tpu_torch.core.packs import PackWriter
    from kart_tpu_torch.importer import GPKGImportSource
    from kart_tpu_torch.models.paths import PathEncoder
    from kart_tpu_torch.models.schema import Schema

    schema = Schema.from_column_dicts(schema_dicts)
    encoder = PathEncoder.get(**encoder_dict)
    (pk_col,) = [c for c in schema.columns if c.pk_index is not None]
    src = GPKGImportSource(gpkg_path, table_name)
    encode = src.batch_row_encoder(schema)
    where, params = [], []
    if lo is not None:
        where.append(f"{quote(pk_col.name)} >= ?")
        params.append(lo)
    if hi is not None:
        where.append(f"{quote(pk_col.name)} < ?")
        params.append(hi)
    sql = src._select_sql(schema, where=(" WHERE " + " AND ".join(where)) if where else "")

    count = 0
    pks_out, oid_parts = [], []
    con = sqlite3.connect(gpkg_path)
    try:
        with PackWriter(os.path.join(objects_dir, "pack")) as writer:
            cursor = con.execute(sql, params)
            cursor.arraysize = 10000
            while True:
                rows = cursor.fetchmany()
                if not rows:
                    break
                pks, blobs = encode(rows)
                oid_parts.append(writer.add_batch_raw("blob", blobs).tobytes())
                pks_out.append(np.asarray(pks, dtype=np.int64))
                count += len(pks)
            if count:
                pks_arr = np.concatenate(pks_out)
                oids_arr = np.frombuffer(b"".join(oid_parts), dtype=np.uint8).reshape(-1, 20)
                leaf_entries = emit_leaf_trees(writer, plan_int_feature_tree(pks_arr, encoder),
                                               oids_arr, pks_arr)
            else:
                pks_arr = np.zeros(0, dtype=np.int64)
                oids_arr = np.zeros((0, 20), dtype=np.uint8)
                leaf_entries = []
    finally:
        con.close()
    return count, leaf_entries, pks_arr, oids_arr.tobytes()
