"""Import: sources -> dataset trees -> one commit.

Each source's features are encoded into blobs in batches and written into
one new pack (``ObjectDb.bulk_pack``), in this one process, by kart_tpu's
generic route (no native reader, no fork). An int-pk dataset's feature tree
is built from its (pk, blob oid) columns in one vectorized pass; a
hash-keyed one through the tree builder. The commit is written after the
pack is complete, so a failed import leaves HEAD where it was.

The import writes the new feature tree's columnar sidecar straight from
the columns it captured (:class:`~kart_tpu_torch.diff.sidecar
.SidecarCapture`, for a dataset of :data:`SIDECAR_MIN_FEATURES` or more),
so the first diff reads it on the card; ``--replace-ids`` derives the new
sidecar from the old one and the ids it replaced, in O(changed) work.

Counterpart of kart_tpu's ``importer/importer.py``: ``import_sources`` (with
``replace_existing`` and ``replace_ids``), ``ReplaceIdsCapture`` and the
generic single-source route, writing the same objects and sidecar bytes.
"""

import gc
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
    schema = source.schema
    encoder = encoder_for_schema(schema)
    meta = source.meta_items()
    for path, data in Dataset3.new_dataset_meta_blobs(
            ds_path, schema, title=meta.get("title"), description=meta.get("description"),
            crs_defs=source.crs_definitions(), path_encoder=encoder):
        tb.insert(path, repo.odb.write_blob(data))
    prefix = f"{ds_path}/{Dataset3.DATASET_DIRNAME}/{Dataset3.FEATURE_PATH}"
    if replace_ids is not None:
        return _import_replace_ids(repo, tb, source, schema, encoder, prefix, replace_ids,
                                   log=log, existing_ds=existing_ds, capture=capture)

    count = 0
    int_paths = encoder.scheme == "int"
    with _paused_gc():
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

    if int_paths and count:
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
        tb.insert(f"{ds_path}/{Dataset3.DATASET_DIRNAME}/feature", ftree, mode=MODE_TREE)

    late_meta = source.post_import_meta_items()
    for name, value in late_meta.items():
        data = value if isinstance(value, bytes) else json_pack(value)
        tb.insert(f"{ds_path}/{Dataset3.DATASET_DIRNAME}/{Dataset3.META_PATH}{name}",
                  repo.odb.write_blob(data))
    if log:
        log(f"  {ds_path}: {count} features")
    return count
