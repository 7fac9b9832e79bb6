"""The 3-way merge engine: ``kart merge``, its conflicts and its state.

Each dataset's features go through one classify of the whole pk union
(:func:`~kart_tpu_torch.ops.merge_kernel.merge_classify`: K4 on the card,
its plain version with ``device="cpu"``); meta items and attachments go
through the same rule on the host. Clean changes are written to a merged
tree at once; conflicts become a :class:`~kart_tpu_torch.merge.index
.MergeIndex` and move the repository into the MERGING state.

A hash-keyed dataset's keys are hashes of its filenames. When two rows of
one version share a key, the dataset is merged by path on the host with
kart_tpu's dict semantics (:func:`_merge_dataset_features_host`, counted
as ``hash_collision_fallbacks``): a second semantic path, not a fallback
from the kernel. Its conflict labels are decoded from the paths when they
are first read (:class:`_DeferredLabels`).

Counterpart of kart_tpu's ``merge/__init__.py``, with one difference of
policy: the classify never falls back (kart_tpu's sharded, streamed and
host routes of it). A merge that commits (a fast-forward, a clean merge,
``--continue``) writes the new HEAD into the working copy, as kart_tpu
does (:func:`reset_working_copy`); a merge with conflicts leaves it alone.
"""

import numpy as np

from kart_tpu_torch import runtime
from kart_tpu_torch.core.repo import (
    MERGE_BRANCH,
    MERGE_HEAD,
    MERGE_INDEX,
    MERGE_MSG,
    InvalidOperation,
    KartRepoState,
)
from kart_tpu_torch.core.structure import DATASET_DIRNAMES, RepoStructure
from kart_tpu_torch.core.tree_builder import TreeBuilder
from kart_tpu_torch.diff import sidecar
from kart_tpu_torch.merge.index import (
    AncestorOursTheirs,
    ColumnarConflicts,
    CombinedConflicts,
    ConflictEntry,
    EncodedPkPaths,
    MergeIndex,
    PkLabels,
    RowPaths,
)
from kart_tpu_torch.models.paths import decode_filenames
from kart_tpu_torch.ops.blocks import FeatureBlock, unpack_oid_hex
from kart_tpu_torch.ops.merge_kernel import CONFLICT, TAKE_THEIRS, merge_classify
from kart_tpu_torch.workingcopy import get_working_copy


class MergeResult:
    """Outcome of :func:`do_merge`."""

    def __init__(self, *, commit_oid=None, fast_forward=False, already_merged=False,
                 merge_index=None, dry_run=False, stats=None, merging=False,
                 merged_tree=None):
        self.commit_oid = commit_oid
        self.fast_forward = fast_forward
        self.already_merged = already_merged
        self.merge_index = merge_index
        self.dry_run = dry_run
        self.stats = stats or {}
        self.merging = merging
        self.merged_tree = merged_tree

    @property
    def has_conflicts(self):
        return self.merge_index is not None and bool(self.merge_index.conflicts)


def _dataset_blocks(structures, ds_path):
    """Per-version FeatureBlock of ``ds_path`` (an absent dataset gives an
    empty block) and the versions' datasets. A hash-keyed version with a
    sidecar is read from it (keys, oids and its paths section, the same
    columns a walk of its tree gives, as mmap views); any other version
    walks its feature tree."""
    blocks, datasets = [], []
    for structure in structures:
        ds = structure.datasets.get(ds_path) if structure.tree is not None else None
        datasets.append(ds)
        block = None
        if ds is None:
            block = FeatureBlock.from_arrays(
                np.zeros(0, dtype=np.int64), np.zeros((0, 5), np.uint32), [])
        elif ds.path_encoder.scheme != "int" and ds.repo is not None:
            block = sidecar.load_block(ds.repo, ds)
        blocks.append(block if block is not None else FeatureBlock.from_dataset(ds))
    return blocks, datasets


def _paths_of(block, rows):
    """The paths of ``block``'s rows ``rows``, a sidecar's read in one
    batch."""
    take = getattr(block.paths, "take", None)
    return take(rows) if take is not None else [block.paths[r] for r in rows.tolist()]


def _keys_to_block_rows(block, keys):
    """Keys (K,) -> each key's row in ``block``, or -1 where it is absent."""
    real = block.keys[: block.count]
    if not block.count:
        return np.full(len(keys), -1, dtype=np.int64)
    idx = np.searchsorted(real, keys)
    idxc = np.minimum(idx, block.count - 1)
    return np.where((real[idxc] == keys) & (idx < block.count), idxc, -1)


def _feature_label(ds_path, datasets, rel_paths):
    """The conflict label ``<ds>:feature:<pk>`` (a composite pk's values
    joined by commas) from the first version that can decode its path,
    else ``<ds>:feature:<path>``."""
    for ds, rel in zip(datasets, rel_paths):
        if ds is not None and rel is not None:
            try:
                pks = ds.decode_path_to_pks(rel)
            except Exception:  # noqa: BLE001 - kart_tpu labels an undecodable name by its path
                continue
            return f"{ds_path}:feature:{','.join(str(pk) for pk in pks)}"
    rel = next((r for r in rel_paths if r), "?")
    return f"{ds_path}:feature:{rel}"


def _merge_dataset_features(ds_path, structures, tree_builder, device):
    """The per-feature 3-way of one dataset, one classify launch. Applies
    the clean theirs-changes to ``tree_builder``; -> (conflicts, stats)."""
    blocks, datasets = _dataset_blocks(structures, ds_path)
    if any(b.has_key_collisions() for b in blocks):
        runtime.count("hash_collision_fallbacks")
        return _merge_dataset_features_host(ds_path, blocks, datasets, tree_builder)
    a_block, o_block, t_block = blocks
    union, decision, _presence, stats = merge_classify(a_block, o_block, t_block, device)

    inner = next((ds.inner_path for ds in datasets if ds is not None), None)
    if inner is None:
        return {}, stats

    # clean theirs-changes: one searchsorted a side, then the changed rows
    take_keys = union[decision == TAKE_THEIRS]
    t_rows = _keys_to_block_rows(t_block, take_keys)
    o_rows = _keys_to_block_rows(o_block, take_keys)
    present = t_rows >= 0
    rows = t_rows[present]
    for path, oid in zip(_paths_of(t_block, rows), unpack_oid_hex(t_block.oids[rows])):
        tree_builder.insert(f"{inner}/feature/{path}", oid)
    gone = o_rows[~present]
    for path in _paths_of(o_block, gone[gone >= 0]):
        tree_builder.remove(f"{inner}/feature/{path}")

    conflict_idx = np.nonzero(decision == CONFLICT)[0]
    return materialise_conflicts(ds_path, blocks, datasets, inner, union, conflict_idx), stats


def materialise_conflicts(ds_path, blocks, datasets, inner, union, conflict_idx):
    """Conflict rows -> :class:`ColumnarConflicts`: three (present, oids)
    column pairs, one searchsorted and one gather each, with the labels
    and paths left as lazy columns that serialisation reads in batch."""
    if not len(conflict_idx):
        return {}
    conflict_keys = union[conflict_idx]
    n = len(conflict_keys)
    prefix = f"{inner}/feature/"
    versions = []
    rows_per_block = []
    pk_path_cols = {}  # encoder id -> one shared EncodedPkPaths
    for block, ds in zip(blocks, datasets):
        rows = _keys_to_block_rows(block, conflict_keys)
        rows_per_block.append(rows)
        present = rows >= 0
        oids_u8 = np.zeros((n, 20), dtype=np.uint8)
        if np.any(present):
            sel = np.ascontiguousarray(block.oids[rows[present]])
            oids_u8[present] = sel.view(np.uint8).reshape(-1, 20)
        encoder = ds.path_encoder if ds is not None else None
        if encoder is not None and encoder.scheme == "int":
            # the path is a function of the pk: versions with one encoder
            # share one lazy column
            paths = pk_path_cols.get(id(encoder))
            if paths is None:
                paths = pk_path_cols[id(encoder)] = EncodedPkPaths(prefix, encoder, conflict_keys)
        else:
            paths = RowPaths(prefix, block.paths, rows)
        versions.append((present, oids_u8, paths))
    schemes = {ds.path_encoder.scheme for ds in datasets if ds is not None}
    if schemes == {"int"}:
        # the keys are the pks: the labels derive from the key column
        labels = PkLabels(ds_path, conflict_keys)
    else:
        # hash keys, or versions whose encoders differ (a pk type change):
        # each conflict's label comes from a version that holds it
        labels = _DeferredLabels(ds_path, datasets, blocks, rows_per_block)
    return ColumnarConflicts(labels, versions)


class _DeferredLabels:
    """The label column of a dataset with hash keys: the paths are decoded
    when the labels are first read (serialisation, conflict listing), once."""

    __slots__ = ("ds_path", "datasets", "blocks", "rows_per_block", "_batch")

    def __init__(self, ds_path, datasets, blocks, rows_per_block):
        self.ds_path = ds_path
        self.datasets = datasets
        self.blocks = blocks
        self.rows_per_block = rows_per_block
        self._batch = None

    def __len__(self):
        return len(self.rows_per_block[0])

    def __getitem__(self, i):
        return self.batch()[i]

    def batch(self):
        if self._batch is None:
            self._batch = _conflict_labels_batch(self.ds_path, self.datasets, self.blocks,
                                                 self.rows_per_block)
        return self._batch


def _conflict_labels_batch(ds_path, datasets, blocks, rows_per_block):
    """Labels ``<ds>:feature:<pk>`` of every conflict, each decoded from
    the path of the first version (ancestor, ours, theirs) that holds it,
    with that version's encoder, all of a version's paths in one batch (an
    undecodable batch is labelled one path at a time)."""
    n = len(rows_per_block[0])
    labels = [None] * n
    for v, (rows, block) in enumerate(zip(rows_per_block, blocks)):
        row_list, found = rows.tolist(), (rows >= 0).tolist()
        pending = [i for i in range(n) if labels[i] is None and found[i]]
        if not pending:
            continue
        take = getattr(block.paths, "take", None)
        rels = (take(rows[np.asarray(pending, dtype=np.int64)]) if take is not None
                else [block.paths[row_list[i]] for i in pending])
        ds = datasets[v]
        encoder = ds.path_encoder if ds is not None else None
        if encoder is not None:
            try:
                if encoder.scheme == "int":
                    pk_parts = encoder.decode_paths_batch(rels).tolist()
                else:
                    pk_parts = [",".join(str(pk) for pk in pks)
                                for pks in decode_filenames([r.rsplit("/", 1)[-1] for r in rels])]
            except Exception:  # noqa: BLE001 - kart_tpu re-derives each label below
                pk_parts = None
            if pk_parts is not None:
                for i, part in zip(pending, pk_parts):
                    labels[i] = f"{ds_path}:feature:{part}"
                continue
        version_datasets = [None] * len(blocks)
        version_datasets[v] = ds
        for i, rel in zip(pending, rels):
            rel_row = [None] * len(blocks)
            rel_row[v] = rel
            labels[i] = _feature_label(ds_path, version_datasets, rel_row)
    return [f"{ds_path}:feature:?" if label is None else label for label in labels]


def _merge_dataset_features_host(ds_path, blocks, datasets, tree_builder):
    """kart_tpu's merge by path, for a dataset whose hash keys collide:
    dict semantics over each version's (path, oid), the conflicts labelled
    and keyed in path order. -> (conflicts, stats)."""
    def index(block):
        return dict(zip(block.paths, unpack_oid_hex(block.oids[: block.count])))

    a, o, t = (index(b) for b in blocks)
    inner = next((ds.inner_path for ds in datasets if ds is not None), None)
    conflicts = {}
    stats = {"conflicts": 0, "take_theirs": 0}
    for rel in sorted(set(a) | set(o) | set(t)):
        av, ov, tv = a.get(rel), o.get(rel), t.get(rel)
        if ov == tv or tv == av:
            continue
        if ov == av:
            stats["take_theirs"] += 1
            if tv is not None:
                tree_builder.insert(f"{inner}/feature/{rel}", tv)
            else:
                tree_builder.remove(f"{inner}/feature/{rel}")
        else:
            stats["conflicts"] += 1
            conflicts[_feature_label(ds_path, datasets, [rel] * 3)] = AncestorOursTheirs(
                *(ConflictEntry(f"{inner}/feature/{rel}", v) if v is not None else None
                  for v in (av, ov, tv)))
    return conflicts, stats


def _non_feature_items(structure):
    """{repo path: oid} of every blob that is not a feature (meta items,
    attachments), without descending into any dataset's ``feature/``."""
    out = {}
    tree = structure.tree
    if tree is None:
        return out
    odb = structure.repo.odb

    def walk(node, prefix):
        for entry in node.entries():
            path = f"{prefix}{entry.name}"
            if not entry.is_tree:
                out[path] = entry.oid
            elif entry.name in DATASET_DIRNAMES:
                for inner_entry in odb.tree(entry.oid).entries():
                    if inner_entry.name == "feature":
                        continue
                    if inner_entry.is_tree:
                        walk(odb.tree(inner_entry.oid), f"{path}/{inner_entry.name}/")
                    else:
                        out[f"{path}/{inner_entry.name}"] = inner_entry.oid
            else:
                walk(odb.tree(entry.oid), f"{path}/")

    walk(tree, "")
    return out


def _label_for_non_feature(structures, path):
    for structure in structures:
        if structure.tree is None:
            continue
        ds_path, part, item = structure.decode_path(path)
        if part == "meta":
            return f"{ds_path}:meta:{item}"
        break
    return f"<root>:attachment:{path}"


def _merge_non_features(structures, tree_builder):
    a_items, o_items, t_items = (_non_feature_items(s) for s in structures)
    conflicts = {}
    for path in sorted(set(a_items) | set(o_items) | set(t_items)):
        av, ov, tv = a_items.get(path), o_items.get(path), t_items.get(path)
        if ov == tv or tv == av:
            continue
        if ov == av:
            if tv is not None:
                tree_builder.insert(path, tv)
            else:
                tree_builder.remove(path)
        else:
            conflicts[_label_for_non_feature(structures, path)] = AncestorOursTheirs(
                *(ConflictEntry(path, v) if v is not None else None for v in (av, ov, tv)))
    return conflicts


def merge_trees_vectorized(repo, ancestor_struct, ours_struct, theirs_struct, device=None):
    """-> (merged tree oid, conflicts, stats). The merged tree holds every
    clean change; conflicted paths keep their ours content until resolved.
    One classify launch a dataset on ``device``."""
    structures = (ancestor_struct, ours_struct, theirs_struct)
    tb = TreeBuilder(repo.odb, ours_struct.tree_oid)
    all_conflicts = CombinedConflicts()
    total_stats = {"take_theirs": 0, "conflicts": 0}
    ds_paths = set()
    for structure in structures:
        if structure.tree is not None:
            ds_paths.update(structure.datasets.paths())
    for ds_path in sorted(ds_paths):
        conflicts, stats = _merge_dataset_features(ds_path, structures, tb, device)
        all_conflicts.add(conflicts)
        for k in total_stats:
            total_stats[k] += stats.get(k, 0)
    all_conflicts.add(_merge_non_features(structures, tb))
    if not tb:
        return ours_struct.tree_oid, all_conflicts, total_stats
    # the rewritten trees (every leaf a clean change touches) go into one
    # pack, not one loose file each
    with repo.odb.bulk_pack(level=0):
        merged_tree = tb.flush()
    return merged_tree, all_conflicts, total_stats


def do_merge(repo, theirs_refish, *, message=None, dry_run=False, ff=True, ff_only=False,
             device=None):
    """Merge ``theirs_refish`` into HEAD."""
    if repo.state != KartRepoState.NORMAL:
        raise InvalidOperation(
            KartRepoState.bad_state_message(repo.state, (KartRepoState.NORMAL,)))
    ours_oid = repo.head_commit_oid
    if ours_oid is None:
        raise InvalidOperation("Repository has no commits yet")
    theirs_oid, theirs_ref = _resolve_commit_and_ref(repo, theirs_refish)
    if theirs_oid is None:
        raise InvalidOperation(f"Cannot resolve {theirs_refish!r}")
    ancestor_oid = repo.merge_base(ours_oid, theirs_oid)
    if ancestor_oid is None:
        raise InvalidOperation("Commits have no common ancestor")

    if ancestor_oid == theirs_oid:
        return MergeResult(already_merged=True, commit_oid=ours_oid, dry_run=dry_run)
    if ancestor_oid == ours_oid and ff:
        if not dry_run:
            _update_head_to(repo, theirs_oid, device)
        return MergeResult(commit_oid=theirs_oid, fast_forward=True, dry_run=dry_run)
    if ff_only:
        raise InvalidOperation("Can't resolve as a fast-forward merge and --ff-only specified")

    merged_tree, conflicts, stats = merge_trees_vectorized(
        repo, RepoStructure(repo, ancestor_oid), RepoStructure(repo, ours_oid),
        RepoStructure(repo, theirs_oid), device)

    branch_name = _branch_shorthand(theirs_refish, theirs_ref)
    if message is None:
        message = f'Merge branch "{branch_name}"' if branch_name else f"Merge {theirs_oid[:8]}"
    if conflicts:
        merge_index = MergeIndex(merged_tree, conflicts)
        if not dry_run:
            merge_index.write_to_repo(repo)
            repo.write_gitdir_file(MERGE_HEAD, theirs_oid)
            repo.write_gitdir_file(MERGE_MSG, message)
            if branch_name:
                repo.write_gitdir_file(MERGE_BRANCH, branch_name)
        return MergeResult(merge_index=merge_index, dry_run=dry_run, stats=stats,
                           merging=not dry_run, merged_tree=merged_tree)
    if dry_run:
        return MergeResult(dry_run=True, stats=stats, merged_tree=merged_tree)
    commit_oid = _create_merge_commit(repo, merged_tree, message, [ours_oid, theirs_oid])
    reset_working_copy(repo, device)
    return MergeResult(commit_oid=commit_oid, stats=stats, merged_tree=merged_tree)


def complete_merging_state(repo, *, message=None, device=None):
    """``kart merge --continue``: commit the resolved merge."""
    if repo.state != KartRepoState.MERGING:
        raise InvalidOperation("No merge is ongoing")
    merge_index = MergeIndex.read_from_repo(repo)
    unresolved = merge_index.unresolved_labels
    if unresolved:
        raise InvalidOperation(
            f"Merge is not yet complete - {len(unresolved)} conflicts "
            'still need resolving. See "kart conflicts" / "kart resolve"')
    theirs_oid = repo.read_gitdir_file(MERGE_HEAD).strip()
    message = message or repo.read_gitdir_file(MERGE_MSG) or "Merge"
    final_tree = merge_index.write_resolved_tree(repo.odb)
    commit_oid = _create_merge_commit(repo, final_tree, message,
                                      [repo.head_commit_oid, theirs_oid])
    abort_merging_state(repo)
    reset_working_copy(repo, device)
    return commit_oid


def abort_merging_state(repo):
    """Delete whichever ``MERGE_*`` state files exist."""
    for name in (MERGE_HEAD, MERGE_INDEX, MERGE_BRANCH, MERGE_MSG):
        repo.remove_gitdir_file(name)


def _resolve_commit_and_ref(repo, refish):
    oid, ref = repo.resolve_refish(refish)
    if oid is not None:
        oid = repo._peel_to_commit_oid(oid)
    return oid, ref


def _branch_shorthand(refish, ref):
    if ref and ref.startswith("refs/heads/"):
        return ref[len("refs/heads/"):]
    if ref and ref.startswith("refs/remotes/"):
        return ref[len("refs/remotes/"):]
    if isinstance(refish, str) and not all(c in "0123456789abcdef" for c in refish.lower()):
        return refish
    return None


def _update_head_to(repo, commit_oid, device=None):
    branch = repo.head_branch
    if branch:
        repo.refs.set(branch, commit_oid, log_message="merge: fast-forward")
    else:
        repo.refs.set_head(commit_oid, log_message="merge: fast-forward")
    reset_working_copy(repo, device)


def reset_working_copy(repo, device=None):
    """Write HEAD's tree into the working copy, when there is one (a forced
    reset: no classify)."""
    wc = get_working_copy(repo, device=device)
    if wc is not None:
        wc.reset(RepoStructure(repo, "HEAD"), force=True)


def _create_merge_commit(repo, tree_oid, message, parents):
    return repo.create_commit(repo.head_branch or "HEAD", tree_oid, message, parents)
