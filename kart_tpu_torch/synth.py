"""Synthetic repositories at benchmark scale: a real repository (packs,
Merkle feature trees, commits, refs, columnar sidecars) built straight
from generated (pk, oid) columns.

Counterpart of kart_tpu's ``synth.py`` ``synth_repo`` for ``blobs="real"``
(every feature blob written) and ``blobs="changed"`` (real blobs for the
edited rows only, in both revisions; every other blob oid is in the trees
and sidecars but its object is absent), with ``spatial=False``. Given the
same arguments, commit dates (``GIT_AUTHOR_DATE``/``GIT_COMMITTER_DATE``)
and seed, it writes the same commits and byte-identical sidecars as
kart_tpu. The spatial schema and the polygon repository are not ported.
"""

import numpy as np

from kart_tpu_torch.core.feature_tree import emit_feature_tree, plan_int_feature_tree
from kart_tpu_torch.core.objects import MODE_TREE
from kart_tpu_torch.core.repo import KartRepo
from kart_tpu_torch.core.tree_builder import TreeBuilder
from kart_tpu_torch.diff import sidecar
from kart_tpu_torch.models.dataset import Dataset3
from kart_tpu_torch.models.paths import PathEncoder
from kart_tpu_torch.models.schema import ColumnSchema, Schema

SYNTH_SCHEMA = Schema([
    ColumnSchema(id="a1b2c3d4-0001-4000-8000-000000000001", name="fid",
                 data_type="integer", pk_index=0, extra_type_info={"size": 64}),
    ColumnSchema(id="a1b2c3d4-0002-4000-8000-000000000002", name="rating",
                 data_type="float", pk_index=None, extra_type_info={"size": 64}),
])


def _blob_oids(odb, pks, ratings, batch=200_000):
    """Write the feature blobs {fid: pk, rating: r}; -> (n, 20) uint8 oids."""
    out = np.empty((len(pks), 20), dtype=np.uint8)
    encode = SYNTH_SCHEMA.encode_feature_blob
    for i in range(0, len(pks), batch):
        sl = slice(i, i + batch)
        contents = [encode({"fid": pk, "rating": r})[1]
                    for pk, r in zip(pks[sl].tolist(), ratings[sl].tolist())]
        out[sl] = odb.write_blobs_raw(contents)
    return out


def synth_repo(path, n, *, edit_frac=0.01, seed=0, blobs="changed", ds_path="synth"):
    """Create a repo at ``path`` with one int-pk dataset of ``n`` features
    and two commits: the base import and an ``edit_frac`` rating rewrite.
    -> (repo, {"base_commit", "edit_commit", "n", "n_edits"})."""
    if blobs not in ("real", "changed"):
        raise ValueError(f"blobs={blobs!r}: only 'real' and 'changed' are ported")
    repo = KartRepo.init_repository(path)
    repo.config.set_many({"user.name": "Synth", "user.email": "synth@example.com"})
    odb = repo.odb
    base = 1 << 24  # keeps every filename the same width (uint32 msgpack)
    pks = np.arange(base, base + n, dtype=np.int64)

    if blobs == "real":
        with odb.bulk_pack(level=0):
            oids1 = _blob_oids(odb, pks, pks / 2.0)
    else:
        oids1 = np.random.default_rng(seed).integers(0, 256, size=(n, 20), dtype=np.uint8)

    n_edits = max(1, int(n * edit_frac)) if edit_frac else 0
    rng = np.random.default_rng(seed + 1)
    edit_rows = rng.choice(n, size=n_edits, replace=False) if n_edits else np.zeros(0, np.int64)
    oids2 = oids1.copy()
    if n_edits:
        sel = pks[edit_rows]
        if blobs == "real":
            with odb.bulk_pack(level=0):
                oids2[edit_rows] = _blob_oids(odb, sel, sel.astype(np.float64))
        else:
            with odb.bulk_pack(level=0):
                oids1[edit_rows] = _blob_oids(odb, sel, sel / 2.0)
                oids2[edit_rows] = _blob_oids(odb, sel, sel.astype(np.float64))

    plan = plan_int_feature_tree(pks)
    commits = []
    prev = None
    for oids_u8, message in ((oids1, "synth import"), (oids2, "synth edits")):
        with odb.bulk_pack(level=0):
            ftree, leaf_oids = emit_feature_tree(odb, plan, oids_u8, prev=prev)
            prev = (leaf_oids, edit_rows)
            tb = TreeBuilder(odb, repo.head_tree_oid if commits else None)
            for blob_path, data in Dataset3.new_dataset_meta_blobs(
                ds_path, SYNTH_SCHEMA, title="synthetic benchmark layer",
                path_encoder=PathEncoder.INT_PK_ENCODER,
            ):
                tb.insert(blob_path, odb.write_blob(data))
            tb.insert(f"{ds_path}/{Dataset3.DATASET_DIRNAME}/feature", ftree, mode=MODE_TREE)
            root = tb.flush()
        commits.append(repo.create_commit("HEAD", root, message, commits[-1:]))
        sidecar.save_sidecar(repo, ftree, pks, oids_u8)
    return repo, {"base_commit": commits[0], "edit_commit": commits[1], "n": n,
                  "n_edits": n_edits}
