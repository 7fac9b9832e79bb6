"""Import: sources -> dataset trees -> one commit.

Each source's features are encoded into blobs in batches and written into
one new pack (``ObjectDb.bulk_pack``) by one of three routes, chosen as
kart_tpu chooses:

* the pipeline (:mod:`.pipeline`): the read and encode, the native hash +
  deflate + framing and the pack append on threads of their own, for a
  source the native GPKG reader takes (``KART_IMPORT_NATIVE_READ``,
  ``KART_IMPORT_FAST``), and for any source of
  ``pipeline.PIPELINE_MIN_FEATURES`` features or more
  (``KART_IMPORT_PIPELINE``: ``0`` never, ``1`` always);
* the fan-out over worker processes (:mod:`.parallel`,
  ``KART_IMPORT_WORKERS``) for an int-pk GPKG the native reader does not
  take;
* serial batches in this thread.

All three write the same objects and the same root tree. An int-pk
dataset's feature tree is built from its (pk, blob oid) columns in one
vectorized pass (during the stream, in the pipeline); a hash-keyed one
through the tree builder. The commit is written after the pack is
complete, so a failed import leaves HEAD where it was and only the pack's
``.tmp-pack-*`` file behind.

The import writes the new feature tree's columnar sidecar straight from
the columns it captured (:class:`~kart_tpu_torch.diff.sidecar
.SidecarCapture`, for a dataset of :data:`SIDECAR_MIN_FEATURES` or more),
so the first diff reads it on the card; ``--replace-ids`` derives the new
sidecar from the old one and the ids it replaced, in O(changed) work.

Counterpart of kart_tpu's ``importer/importer.py``: ``import_sources`` (with
``replace_existing`` and ``replace_ids``), ``ReplaceIdsCapture``, the
router, ``_run_import_pipeline`` with its one native-reader retry and
``LAST_IMPORT_PIPELINE``, writing the same objects and sidecar bytes.
kart_tpu's phase telemetry (``LAST_IMPORT_PHASES``) is not ported.
"""

import gc
import logging
import time
from contextlib import contextmanager

import numpy as np

from kart_tpu_torch.core.feature_tree import emit_feature_tree, plan_int_feature_tree
from kart_tpu_torch.core.objects import MODE_TREE
from kart_tpu_torch.core.serialise import json_pack
from kart_tpu_torch.core.tree_builder import TreeBuilder
from kart_tpu_torch.diff import sidecar
from kart_tpu_torch.importer.pk_generation import PkGeneratingImportSource
from kart_tpu_torch.models.dataset import Dataset3
from kart_tpu_torch.models.paths import encoder_for_schema

#: features encoded and written a batch
BATCH_SIZE = 10000
#: below this many features a dataset's first diff walks its tree: no sidecar
SIDECAR_MIN_FEATURES = 10000
#: a progress line every this many features
PROGRESS_EVERY = 100000

#: the busy seconds of each stage of the last pipelined import in this
#: process, {"read", "encode", "hash", "pack", "tree", "wall"}: the stages
#: run on threads of their own, so their sum exceeding "wall" is the
#: overlap at work. None when the last import took another route.
LAST_IMPORT_PIPELINE = None

#: the route the last import's last dataset took: "pipeline-native" (the
#: native fused read + encode), "pipeline" (a Python producer), "fan-out",
#: "serial" or "replace-ids"
LAST_IMPORT_ROUTE = None

L = logging.getLogger(__name__)


class ImportError_(RuntimeError):
    pass


class ReplaceIdsCapture:
    """What a ``--replace-ids`` import changed: the pks it removed and the
    (pk, oid hex) rows it wrote, for the O(changed) sidecar derivation."""

    def __init__(self):
        self.removed_pks = []
        self.added = []


def _chunked(iterable, size):
    batch = []
    for item in iterable:
        batch.append(item)
        if len(batch) == size:
            yield batch
            batch = []
    if batch:
        yield batch


@contextmanager
def _paused_gc():
    """The encode loop makes short-lived acyclic objects by the million:
    the cyclic collector only costs there."""
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


def _hex_list(oids_u8):
    hexes = oids_u8.tobytes().hex()
    return [hexes[i : i + 40] for i in range(0, len(hexes), 40)]


def import_sources(repo, sources, *, message=None, replace_existing=False, replace_ids=None,
                   log=None):
    """Import each source as a dataset in one commit; -> its oid.

    ``replace_ids`` (pk values) re-imports those features only: the
    dataset's tree is kept, each listed id removed and written again when
    the source still has it (so a listed id the source lacks is deleted).
    It implies ``replace_existing``; an empty list re-imports no feature
    but still updates the meta items."""
    sources = list(sources)
    structure = repo.structure("HEAD") if not repo.head_is_unborn else None
    existing_paths = set(structure.datasets.paths()) if structure is not None else set()
    if replace_ids is not None:
        replace_existing = True
        if len(sources) != 1:
            raise ImportError_("--replace-ids requires a single-table import (the id list "
                               "would be applied to every table)")
    global LAST_IMPORT_PIPELINE, LAST_IMPORT_ROUTE
    LAST_IMPORT_PIPELINE = LAST_IMPORT_ROUTE = None  # set by the route taken
    tb = TreeBuilder(repo.odb, repo.head_tree_oid)
    ds_paths, captures = [], {}
    total = 0
    t0 = time.monotonic()
    with repo.odb.bulk_pack():
        for source in sources:
            source = PkGeneratingImportSource.wrap_if_needed(source, repo)
            ds_path = source.dest_path.strip("/")
            if ds_path in existing_paths and not replace_existing:
                raise ImportError_(f"Dataset {ds_path!r} already exists — use --replace-existing")
            if replace_existing and replace_ids is None:
                tb.remove(ds_path)
            existing_ds = structure.datasets.get(ds_path) if structure is not None else None
            capture = sidecar.SidecarCapture() if replace_ids is None else ReplaceIdsCapture()
            total += _import_single_source(repo, tb, source, ds_path, log=log, capture=capture,
                                           replace_ids=replace_ids, existing_ds=existing_ds)
            ds_paths.append(ds_path)
            captures[ds_path] = (capture, existing_ds)
        new_tree = tb.flush()

    if message is None:
        message = f"Import {len(ds_paths)} dataset(s): " + ", ".join(ds_paths)
    parents = [repo.head_commit_oid] if repo.head_commit_oid else []
    commit_oid = repo.create_commit("HEAD", new_tree, message, parents)

    root = repo.odb.tree(new_tree)
    for ds_path, (capture, existing_ds) in captures.items():
        node = root.get_or_none(f"{ds_path}/{Dataset3.DATASET_DIRNAME}/feature")
        if node is None:
            continue
        if isinstance(capture, ReplaceIdsCapture):
            enc = getattr(existing_ds, "path_encoder", None) if existing_ds else None
            if enc is None or enc.scheme != "int":
                continue  # a hash-keyed dataset's sidecar is built when first read
            old_block = sidecar.load_block(repo, existing_ds)
            if old_block is None:
                continue
            sidecar.derive_sidecar(repo, old_block, node.oid, capture.removed_pks,
                                   dict(capture.added))
            continue
        if capture.count >= SIDECAR_MIN_FEATURES:
            capture.save(repo, node.oid)
    dt = time.monotonic() - t0
    if log:
        rate = total / dt if dt > 0 else float("inf")
        log(f"Imported {total} features in {dt:.2f}s ({rate:.0f} features/s)")
    return commit_oid


def _sanitise_pk(schema, pk):
    """A listed id (text) -> the pk column's type."""
    col = schema.pk_columns[0]
    if col.data_type == "integer":
        try:
            return int(pk)
        except (TypeError, ValueError):
            raise ImportError_(f"Invalid integer primary key: {pk!r}")
    return pk


def _check_replace_ids_compatible(existing_ds, schema, encoder):
    """``--replace-ids`` keeps the tree: the new features' paths must land
    where the old ones are, so the path encoder and the pk must not change."""
    if existing_ds is None:
        return
    old_enc = getattr(existing_ds, "path_encoder", None)
    if old_enc is not None and old_enc.to_dict() != encoder.to_dict():
        raise ImportError_(
            "--replace-ids cannot change the feature path encoding "
            f"({old_enc.to_dict()} -> {encoder.to_dict()}); re-import the "
            "whole dataset with --replace-existing instead")
    old_pks = [(c.name, c.data_type) for c in existing_ds.schema.pk_columns]
    new_pks = [(c.name, c.data_type) for c in schema.pk_columns]
    if old_pks != new_pks:
        raise ImportError_(
            f"--replace-ids cannot change the primary key ({old_pks} -> {new_pks}); "
            "re-import the whole dataset with --replace-existing instead")


def _import_replace_ids(repo, tb, source, schema, encoder, prefix, replace_ids, *, log=None,
                        existing_ds=None, capture=None):
    """Remove every listed id's path, then write the listed features the
    source still has; the rest of the tree is kept."""
    if len(schema.pk_columns) != 1:
        raise ImportError_("--replace-ids requires the dataset to have a single-column "
                           "primary key")
    _check_replace_ids_compatible(existing_ds, schema, encoder)
    pks = [_sanitise_pk(schema, pk) for pk in replace_ids]
    for pk in pks:
        tb.remove(prefix + encoder.encode_pks_to_path((pk,)))
    if capture is not None:
        capture.removed_pks = pks
    count = 0
    for batch in _chunked(source.get_features(pks, ignore_missing=True), BATCH_SIZE):
        encoded = [schema.encode_feature_blob(f) for f in batch]
        oids = _hex_list(repo.odb.write_blobs_raw([blob for _, blob in encoded]))
        tb.insert_many((prefix + encoder.encode_pks_to_path(pkv) for pkv, _ in encoded), oids)
        if capture is not None:
            capture.added.extend((pkv[0], oid) for (pkv, _), oid in zip(encoded, oids))
        count += len(batch)
    if log:
        log(f"  replaced {count} of {len(pks)} listed id(s); {len(pks) - count} deleted")
    return count


def _import_single_source(repo, tb, source, ds_path, *, log=None, capture, replace_ids=None,
                          existing_ds=None):
    global LAST_IMPORT_ROUTE
    from kart_tpu_torch.importer import parallel as par
    from kart_tpu_torch.importer import pipeline as pipe

    schema = source.schema
    encoder = encoder_for_schema(schema)
    meta = source.meta_items()
    for path, data in Dataset3.new_dataset_meta_blobs(
            ds_path, schema, title=meta.get("title"), description=meta.get("description"),
            crs_defs=source.crs_definitions(), path_encoder=encoder):
        tb.insert(path, repo.odb.write_blob(data))
    prefix = f"{ds_path}/{Dataset3.DATASET_DIRNAME}/{Dataset3.FEATURE_PATH}"
    if replace_ids is not None:
        LAST_IMPORT_ROUTE = "replace-ids"
        return _import_replace_ids(repo, tb, source, schema, encoder, prefix, replace_ids,
                                   log=log, existing_ds=existing_ds, capture=capture)

    # the route: a source the native reader takes goes through the
    # pipeline (one native reader outruns the fan-out's per-worker Python
    # encode), a shardable one fans out over worker processes, the rest
    # run serially, or pipelined from PIPELINE_MIN_FEATURES features
    mode = pipe.pipeline_mode()
    n_workers = par.default_workers()
    if n_workers > 1:
        n_workers = par.clamp_workers(n_workers, source.feature_count)
    native_pipe = mode != "off" and pipe.native_read_capable(source, encoder)
    if (mode != "force" and not native_pipe and n_workers > 1
            and par.shardable(source, encoder, n_workers)):
        LAST_IMPORT_ROUTE = "fan-out"
        return par.run_parallel_import(repo, tb, source, ds_path, encoder, prefix, n_workers,
                                       log=log, capture=capture)
    use_pipeline = mode == "force" or (
        mode == "auto" and source.feature_count >= pipe.PIPELINE_MIN_FEATURES)
    if use_pipeline and repo.odb._bulk_writer is None:
        use_pipeline = False  # the pack stage appends to the bulk writer

    count = 0
    int_paths = encoder.scheme == "int"
    fast_batches = None
    if int_paths and not use_pipeline:
        fast = getattr(source, "encoded_feature_batches", None)
        if fast is not None:
            fast_batches = fast(schema)
    stream_root = None
    LAST_IMPORT_ROUTE = "serial"
    with _paused_gc():
        if use_pipeline:
            count, stream_root = _run_import_pipeline(repo, tb, source, schema, encoder, prefix,
                                                      capture=capture, int_paths=int_paths,
                                                      log=log, ds_path=ds_path)
        elif fast_batches is not None:
            for n_batch, (pk_list, blobs) in enumerate(fast_batches, 1):
                if n_batch % 100 == 0:
                    gc.collect()
                oids_u8 = repo.odb.write_blobs_raw(blobs)
                capture.add_int_raw(np.asarray(pk_list, dtype=np.int64), oids_u8.tobytes())
                count += len(pk_list)
                if log and count % PROGRESS_EVERY == 0:
                    log(f"  {ds_path}: {count} features...")
        else:
            for n_batch, batch in enumerate(_chunked(source.features(), BATCH_SIZE), 1):
                if n_batch % 100 == 0:
                    gc.collect()  # a source's own cycles, if it makes any
                encoded = [schema.encode_feature_blob(f) for f in batch]
                oids_u8 = repo.odb.write_blobs_raw([blob for _, blob in encoded])
                if int_paths:
                    pks = np.fromiter((pkv[0] for pkv, _ in encoded), dtype=np.int64,
                                      count=len(encoded))
                    capture.add_int_raw(pks, oids_u8.tobytes())
                else:
                    rel_paths = [encoder.encode_pks_to_path(pkv) for pkv, _ in encoded]
                    oids = _hex_list(oids_u8)
                    tb.insert_many((prefix + rel for rel in rel_paths), oids)
                    capture.add_path_batch(rel_paths, oids)
                count += len(batch)
                if log and count % PROGRESS_EVERY == 0:
                    log(f"  {ds_path}: {count} features...")

    feature_path = f"{ds_path}/{Dataset3.DATASET_DIRNAME}/feature"
    if int_paths and count and stream_root is not None:
        # the pipeline built the tree from the sorted stream, whose strictly
        # increasing pks also rule out duplicates
        tb.insert(feature_path, stream_root, mode=MODE_TREE)
    elif int_paths and count:
        pks_arr, oids_u8 = capture.int_columns()
        if len(pks_arr) > 1:
            # a pk twice in the source: the last one wins (git fast-import's
            # rule), in the tree and in the sidecar alike
            order = np.argsort(pks_arr, kind="stable")
            sorted_pks = pks_arr[order]
            is_last = np.append(sorted_pks[1:] != sorted_pks[:-1], True)
            if not is_last.all():
                keep = np.sort(order[is_last])
                pks_arr, oids_u8 = pks_arr[keep], oids_u8[keep]
                capture.replace_int_columns(pks_arr, oids_u8)
        ftree, _ = emit_feature_tree(repo.odb, plan_int_feature_tree(pks_arr, encoder), oids_u8)
        tb.insert(feature_path, ftree, mode=MODE_TREE)

    late_meta = source.post_import_meta_items()
    for name, value in late_meta.items():
        data = value if isinstance(value, bytes) else json_pack(value)
        tb.insert(f"{ds_path}/{Dataset3.DATASET_DIRNAME}/{Dataset3.META_PATH}{name}",
                  repo.odb.write_blob(data))
    if log:
        log(f"  {ds_path}: {count} features")
    return count


def _run_import_pipeline(repo, tb, source, schema, encoder, prefix, *, capture, int_paths, log,
                         ds_path):
    """Stream one source through the pipeline (:mod:`.pipeline`): the fused
    read + encode (one native call a batch for an int-pk GPKG), the native
    hash + deflate + framing, and the pack append, with the (pk, oid)
    columns collected here in stream order. The sorted pks also drive the
    leaf-tree build during the stream (:class:`~kart_tpu_torch.core
    .feature_tree.StreamingLeafEmitter`): finished leaves go back through
    the hash and pack stages on the side channel. The serial route's
    objects and root tree, byte for byte; the stages' busy seconds land in
    :data:`LAST_IMPORT_PIPELINE`.
    -> (feature count, the stream-built feature root's hex oid or None)."""
    from kart_tpu_torch import native
    from kart_tpu_torch.core.feature_tree import StreamingLeafEmitter
    from kart_tpu_torch.core.packs import TYPE_CODES
    from kart_tpu_torch.importer.pipeline import batch_rows, run_pipeline

    global LAST_IMPORT_PIPELINE, LAST_IMPORT_ROUTE
    writer = repo.odb._bulk_writer
    level = writer.level
    blob_code, tree_code = TYPE_CODES["blob"], TYPE_CODES["tree"]

    def make_producer(allow_native):
        if int_paths and allow_native:
            nat = getattr(source, "native_encoded_batches", None)
            producer = nat(schema, batch_rows=batch_rows()) if nat is not None else None
            if producer is not None:
                route[0] = "pipeline-native"
                return producer
        route[0] = "pipeline"
        fast = getattr(source, "encoded_feature_batches", None)
        fb = fast(schema) if (int_paths and fast is not None) else None
        if fb is not None:
            return (("py",) + tuple(item) for item in fb)

        def generic():
            for batch in _chunked(source.features(), BATCH_SIZE):
                keys, blobs = [], []
                for feature in batch:
                    pk_values, blob = schema.encode_feature_blob(feature)
                    keys.append(pk_values[0] if int_paths
                                else encoder.encode_pks_to_path(pk_values))
                    blobs.append(blob)
                yield ("py", keys, blobs)

        return generic()

    def hash_fn(item):
        tag = item[0]
        if tag == "enc":
            _, pks, buf, offs = item
            return ("f", pks, native.pack_records_base("blob", blob_code, buf, offs, level))
        if tag == "py":
            _, keys, blobs = item
            return ("f", keys, native.pack_records_batch("blob", blob_code, blobs, level))
        _, buf, offs, leaf_ids = item  # "tree": a leaf batch from the side channel
        return ("tf", leaf_ids, native.pack_records_base("tree", tree_code, buf, offs, level))

    def pack_fn(item):
        tag, keys, framed = item
        return ("t" if tag == "tf" else "b", keys, writer.append_framed(framed))

    route = [None]
    leaf_stream = StreamingLeafEmitter(encoder) if int_paths else None
    count = n_batches = 0
    tree_oid_chunks = []  # the leaves' (n, 20) oids, in emission order
    tree_busy = 0.0

    def consume(item, inject=None):
        nonlocal count, n_batches, tree_busy
        tag, keys, oids_u8 = item
        if tag == "t":
            tree_oid_chunks.append(oids_u8)
            return
        n_batches += 1
        if n_batches % 100 == 0:
            gc.collect()  # a source's own cycles (the collector is paused)
        if int_paths:
            pks = keys if isinstance(keys, np.ndarray) else np.asarray(keys, dtype=np.int64)
            capture.add_int_raw(pks, oids_u8.tobytes())
            if leaf_stream.ok:
                t0 = time.perf_counter()
                out = leaf_stream.feed(pks, oids_u8)
                tree_busy += time.perf_counter() - t0
                if out is not None:
                    inject(("tree",) + out)
        else:
            oid_list = _hex_list(oids_u8)
            tb.insert_many((prefix + rel for rel in keys), oid_list)
            capture.add_path_batch(keys, oid_list)
        count += len(keys)
        if log and count % PROGRESS_EVERY < len(keys):
            log(f"  {ds_path}: {count} features...")

    def on_feat_done(inject):
        nonlocal tree_busy
        if leaf_stream.ok:
            t0 = time.perf_counter()
            out = leaf_stream.finish()
            tree_busy += time.perf_counter() - t0
            if out is not None:
                inject(("tree",) + out)

    # A row the native reader cannot encode bit for bit raises
    # GpkgReaderFallback mid-stream: reset what the partial run collected
    # and stream again through the Python encoder. Blobs already appended
    # are deduplicated by the pack writer, and leaves already written stay
    # in the pack unreferenced.
    cap_mark = capture.mark()
    t0 = time.perf_counter()
    allow_native = True
    while True:
        try:
            stage_s = run_pipeline(make_producer(allow_native),
                                   [("hash", hash_fn), ("pack", pack_fn)], consume,
                                   side_stage="hash" if int_paths else None,
                                   on_feat_done=on_feat_done if int_paths else None)
            break
        except native.GpkgReaderFallback:
            if not allow_native:
                raise  # the Python encoder never raises it
            allow_native = False
            L.warning("native GPKG reader met a row it cannot reproduce bit-identically; "
                      "restarting import stream through the Python encoder")
            count = n_batches = 0
            tree_busy = 0.0
            tree_oid_chunks.clear()
            capture.rewind(cap_mark)
            if leaf_stream is not None:
                leaf_stream = StreamingLeafEmitter(encoder)
    wall = time.perf_counter() - t0

    stream_root = None
    if int_paths and leaf_stream.ok and count:
        stream_root = leaf_stream.build_root(repo.odb, tree_oid_chunks)
    produce_s = stage_s.get("produce", 0.0)
    read_s = min((getattr(source, "phase_seconds", None) or {}).get("source_read", 0.0),
                 produce_s)
    LAST_IMPORT_PIPELINE = {"read": read_s, "encode": produce_s - read_s,
                            "hash": stage_s.get("hash", 0.0), "pack": stage_s.get("pack", 0.0),
                            "tree": tree_busy, "wall": wall}
    LAST_IMPORT_ROUTE = route[0]
    return count, stream_root
