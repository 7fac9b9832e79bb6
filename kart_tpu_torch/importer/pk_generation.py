"""Stable generated primary keys for sources without one (a CSV or GeoJSON
file with no integer ``id``/``fid``).

A re-import must give a feature the pk it had, or every re-import reads as
a delete and an insert of everything. Each feature's non-pk content is
hashed: an unchanged feature finds its pk by hash; a changed one by
column-level similarity (an old x new matrix of per-column hash matches,
assigned best first); a new feature takes the next pk. The state is the
dataset's ``generated-pks.json`` meta item, so it travels with the
repository.

Counterpart of kart_tpu's ``importer/pk_generation.py``.
"""

import json
import math

import numpy as np

from kart_tpu_torch.core.serialise import b64hash, msg_pack, uint32hash
from kart_tpu_torch.importer import ImportSource
from kart_tpu_torch.models.schema import ColumnSchema, Schema

GENERATED_PKS_ITEM = "generated-pks.json"
DEFAULT_PK_NAME = "auto_pk"
#: a changed feature keeps an old pk when at least this share of its columns
#: match the old feature's
SIMILARITY_THRESHOLD = 0.5


class PkGeneratingImportSource(ImportSource):
    """A pk-less source with a generated int64 pk column in front."""

    def __init__(self, delegate, repo=None, *, pk_name=DEFAULT_PK_NAME):
        self.delegate = delegate
        self.dest_path = delegate.dest_path
        self.pk_name = pk_name
        self.prev_state = _load_previous_state(repo, self.dest_path)
        self._generated_state = None

    @classmethod
    def wrap_if_needed(cls, source, repo=None):
        if source.schema.pk_columns:
            return source
        existing = {c.name for c in source.schema.columns}
        pk_name = DEFAULT_PK_NAME
        n = 2
        while pk_name in existing:  # a real column called auto_pk
            pk_name = f"{DEFAULT_PK_NAME}_{n}"
            n += 1
        return cls(source, repo, pk_name=pk_name)

    @property
    def schema(self) -> Schema:
        pk_col = ColumnSchema(
            id=ColumnSchema.deterministic_id(self.dest_path, self.pk_name),
            name=self.pk_name, data_type="integer", pk_index=0,
            extra_type_info={"size": 64})
        return Schema([pk_col, *self.delegate.schema.columns])

    def meta_items(self):
        return dict(self.delegate.meta_items())

    def post_import_meta_items(self):
        items = dict(self.delegate.post_import_meta_items())
        if self._generated_state is not None:
            items[GENERATED_PKS_ITEM] = self._generated_state
        return items

    def crs_definitions(self):
        return self.delegate.crs_definitions()

    @property
    def feature_count(self):
        return self.delegate.feature_count

    def features(self):
        """The delegate's features with their pks: all read first, for the
        matching."""
        raw_features = list(self.delegate.features())
        col_names = [c.name for c in self.delegate.schema.columns]
        pks, state = assign_pks(raw_features, col_names, self.prev_state)
        self._generated_state = state
        for pk, feature in zip(pks, raw_features):
            yield {self.pk_name: int(pk), **feature}


def _load_previous_state(repo, ds_path):
    """The dataset's ``generated-pks.json`` at HEAD, or None."""
    if repo is None or repo.head_is_unborn:
        return None
    try:
        ds = repo.datasets("HEAD").get(ds_path)
        if ds is None:
            return None
        raw = ds.get_meta_item(GENERATED_PKS_ITEM)
        if isinstance(raw, (bytes, str)):
            raw = json.loads(raw)
        return raw
    except Exception:
        return None


def feature_content_hash(feature, col_names):
    """The hash of a feature's non-pk values in schema order."""
    return b64hash(msg_pack([feature.get(c) for c in col_names]))


def _column_hash_matrix(features, col_names):
    """(N, C) uint32 hashes of each value: the unit of similarity."""
    out = np.empty((len(features), len(col_names)), dtype=np.uint32)
    for i, f in enumerate(features):
        for j, c in enumerate(col_names):
            out[i, j] = uint32hash(msg_pack(f.get(c)))
    return out


def assign_pks(features, col_names, prev_state):
    """-> (int64 pks, the new state): an exact content match keeps its pk,
    then a column-similarity match, then a new pk. Each content hash maps
    to a list of pks, so rows of equal content keep theirs too."""
    prev_state = prev_state or {}
    prev_pks = {h: list(v) if isinstance(v, list) else [v]
                for h, v in prev_state.get("pks", {}).items()}
    next_pk = int(prev_state.get("next", 1))

    n = len(features)
    pks = np.zeros(n, dtype=np.int64)
    hashes = [feature_content_hash(f, col_names) for f in features]
    col_matrix = _column_hash_matrix(features, col_names)

    unmatched_new = []
    available = {h: list(v) for h, v in prev_pks.items()}
    for i, h in enumerate(hashes):
        bucket = available.get(h)
        if bucket:
            pks[i] = bucket.pop(0)
        else:
            unmatched_new.append(i)
    used_pks = {int(pk) for pk in pks if pk}

    old_hash_rows = prev_state.get("column_hashes", {})
    candidates = [
        (pk, np.asarray(old_hash_rows[h], dtype=np.uint32))
        for h, remaining in available.items()
        for pk in remaining
        if h in old_hash_rows and pk not in used_pks
        # a row of another width (the schema changed) cannot be compared
        and len(old_hash_rows[h]) == len(col_names)
    ]
    if unmatched_new and candidates:
        new_matrix = col_matrix[unmatched_new]
        old_matrix = np.stack([row for _, row in candidates])
        sim = (old_matrix[:, None, :] == new_matrix[None, :, :]).sum(axis=2)
        threshold = max(1, math.ceil(len(col_names) * SIMILARITY_THRESHOLD))
        order = np.argsort(sim, axis=None)[::-1]  # best pairs first
        taken_old, taken_new = set(), set()
        for flat in order:
            o, m = divmod(int(flat), sim.shape[1])
            if sim[o, m] < threshold:
                break
            if o in taken_old or m in taken_new:
                continue
            taken_old.add(o)
            taken_new.add(m)
            pks[unmatched_new[m]] = candidates[o][0]
        unmatched_new = [i for k, i in enumerate(unmatched_new) if k not in taken_new]

    for i in unmatched_new:
        pks[i] = next_pk
        next_pk += 1

    new_pk_lists = {}
    for h, pk in zip(hashes, pks):
        new_pk_lists.setdefault(h, []).append(int(pk))
    state = {
        "pks": new_pk_lists,
        "column_hashes": {h: [int(v) for v in col_matrix[i]] for i, h in enumerate(hashes)},
        "next": int(max(next_pk, int(pks.max(initial=0)) + 1)),
    }
    return pks, state
