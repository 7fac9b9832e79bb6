"""The 3-way merge engine: ``kart merge``, its conflicts and its state.

Each dataset's features go through one classify of the whole pk union
(:func:`~kart_tpu_torch.ops.merge_kernel.merge_classify`: K4 on the card,
its plain version with ``device="cpu"``); meta items and attachments go
through the same rule on the host. Clean changes are written to a merged
tree at once; conflicts become a :class:`~kart_tpu_torch.merge.index
.MergeIndex` and move the repository into the MERGING state.

Counterpart of kart_tpu's ``merge/__init__.py``, with two differences of
policy: nothing falls back (kart_tpu's host path for colliding hash keys,
its sharded, streamed and host routes of the classify), and the working
copy is never touched. Where kart_tpu would reset a working copy, the port
raises :class:`NotYetImplemented` before it writes anything. Hash-keyed
datasets raise :class:`NotYetImplemented` when their blocks are read.
"""

import numpy as np

from kart_tpu_torch.core.repo import (
    MERGE_BRANCH,
    MERGE_HEAD,
    MERGE_INDEX,
    MERGE_MSG,
    InvalidOperation,
    KartRepoState,
    NotYetImplemented,
)
from kart_tpu_torch.core.structure import DATASET_DIRNAMES, RepoStructure
from kart_tpu_torch.core.tree_builder import TreeBuilder
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
from kart_tpu_torch.ops.blocks import FeatureBlock, unpack_oid_hex
from kart_tpu_torch.ops.merge_kernel import CONFLICT, TAKE_THEIRS, merge_classify


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
    empty block) and the versions' datasets."""
    blocks, datasets = [], []
    for structure in structures:
        ds = structure.datasets.get(ds_path) if structure.tree is not None else None
        datasets.append(ds)
        if ds is None:
            blocks.append(FeatureBlock.from_arrays(
                np.zeros(0, dtype=np.int64), np.zeros((0, 5), np.uint32), []))
        else:
            blocks.append(FeatureBlock.from_dataset(ds))
    return blocks, datasets


def _keys_to_block_rows(block, keys):
    """Keys (K,) -> each key's row in ``block``, or -1 where it is absent."""
    real = block.keys[: block.count]
    if not block.count:
        return np.full(len(keys), -1, dtype=np.int64)
    idx = np.searchsorted(real, keys)
    idxc = np.minimum(idx, block.count - 1)
    return np.where((real[idxc] == keys) & (idx < block.count), idxc, -1)


def _merge_dataset_features(ds_path, structures, tree_builder, device):
    """The per-feature 3-way of one dataset, one classify launch. Applies
    the clean theirs-changes to ``tree_builder``; -> (conflicts, stats)."""
    blocks, datasets = _dataset_blocks(structures, ds_path)
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
    for row, oid in zip(rows.tolist(), unpack_oid_hex(t_block.oids[rows])):
        tree_builder.insert(f"{inner}/feature/{t_block.paths[row]}", oid)
    for row in o_rows[~present].tolist():
        if row >= 0:
            tree_builder.remove(f"{inner}/feature/{o_block.paths[row]}")

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
    pk_path_cols = {}  # encoder id -> one shared EncodedPkPaths
    for block, ds in zip(blocks, datasets):
        rows = _keys_to_block_rows(block, conflict_keys)
        present = rows >= 0
        oids_u8 = np.zeros((n, 20), dtype=np.uint8)
        if np.any(present):
            sel = np.ascontiguousarray(block.oids[rows[present]])
            oids_u8[present] = sel.view(np.uint8).reshape(-1, 20)
        encoder = ds.path_encoder if ds is not None else None
        if encoder is not None:
            # the path is a function of the pk: versions with one encoder
            # share one lazy column
            paths = pk_path_cols.get(id(encoder))
            if paths is None:
                paths = pk_path_cols[id(encoder)] = EncodedPkPaths(prefix, encoder, conflict_keys)
        else:
            paths = RowPaths(prefix, block.paths, rows)
        versions.append((present, oids_u8, paths))
    # every version is int-pk (a hash-keyed one raised when its block was
    # read), so the labels derive from the key column
    return ColumnarConflicts(PkLabels(ds_path, conflict_keys), versions)


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
    with repo.odb.bulk_pack():
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
            _require_no_working_copy(repo)
            _update_head_to(repo, theirs_oid)
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
            _require_no_working_copy(repo)
            merge_index.write_to_repo(repo)
            repo.write_gitdir_file(MERGE_HEAD, theirs_oid)
            repo.write_gitdir_file(MERGE_MSG, message)
            if branch_name:
                repo.write_gitdir_file(MERGE_BRANCH, branch_name)
        return MergeResult(merge_index=merge_index, dry_run=dry_run, stats=stats,
                           merging=not dry_run, merged_tree=merged_tree)
    if dry_run:
        return MergeResult(dry_run=True, stats=stats, merged_tree=merged_tree)
    _require_no_working_copy(repo)
    commit_oid = _create_merge_commit(repo, merged_tree, message, [ours_oid, theirs_oid])
    return MergeResult(commit_oid=commit_oid, stats=stats, merged_tree=merged_tree)


def complete_merging_state(repo, *, message=None):
    """``kart merge --continue``: commit the resolved merge."""
    if repo.state != KartRepoState.MERGING:
        raise InvalidOperation("No merge is ongoing")
    merge_index = MergeIndex.read_from_repo(repo)
    unresolved = merge_index.unresolved_labels
    if unresolved:
        raise InvalidOperation(
            f"Merge is not yet complete - {len(unresolved)} conflicts "
            'still need resolving. See "kart conflicts" / "kart resolve"')
    _require_no_working_copy(repo)
    theirs_oid = repo.read_gitdir_file(MERGE_HEAD).strip()
    message = message or repo.read_gitdir_file(MERGE_MSG) or "Merge"
    final_tree = merge_index.write_resolved_tree(repo.odb)
    commit_oid = _create_merge_commit(repo, final_tree, message,
                                      [repo.head_commit_oid, theirs_oid])
    abort_merging_state(repo)
    return commit_oid


def abort_merging_state(repo):
    """Delete whichever ``MERGE_*`` state files exist."""
    for name in (MERGE_HEAD, MERGE_INDEX, MERGE_BRANCH, MERGE_MSG):
        repo.remove_gitdir_file(name)


def _require_no_working_copy(repo):
    """kart_tpu resets the working copy after this step; the port does not
    write one, so it refuses before writing anything."""
    location = repo.working_copy_location()
    if location is not None:
        raise NotYetImplemented(f"Updating the working copy ({location}) is not ported yet")


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


def _update_head_to(repo, commit_oid):
    branch = repo.head_branch
    if branch:
        repo.refs.set(branch, commit_oid, log_message="merge: fast-forward")
    else:
        repo.refs.set_head(commit_oid, log_message="merge: fast-forward")


def _create_merge_commit(repo, tree_oid, message, parents):
    return repo.create_commit(repo.head_branch or "HEAD", tree_oid, message, parents)
