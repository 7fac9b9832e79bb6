"""A repository at one revision, and the datasets in its tree.

Counterpart of kart_tpu's ``core/structure.py``: ``Datasets``,
``RepoStructure`` with ``decode_path``, and the write path, where a
RepoDiff becomes one commit: ``create_tree_from_diff`` (every dataset's
diff applied through one tree builder, conflict-checked),
``check_values_match_schema`` (``SchemaViolation``), ``commit_diff`` and
``_update_sidecars``, which derives each changed int-pk dataset's sidecar
for the new feature tree from its parent's (a cache: a failed derivation
logs a warning and never fails the commit).
"""

import logging

from kart_tpu_torch.core.odb import TreeView
from kart_tpu_torch.core.repo import InvalidOperation, NotFound
from kart_tpu_torch.core.tree_builder import TreeBuilder
from kart_tpu_torch.models.dataset import Dataset2, Dataset3, dataset_class_for_version
from kart_tpu_torch.models.schema import Schema

L = logging.getLogger(__name__)

_RESERVED_DIRS = {".kart", ".sno", ".git"}
#: the inner directory names of V3 and of V2 datasets
DATASET_DIRNAMES = (Dataset3.DATASET_DIRNAME, Dataset2.DATASET_DIRNAME)
MAX_DATASET_DEPTH = 5


class SchemaViolation(InvalidOperation):
    pass


class PatchApplyError(InvalidOperation):
    pass


class Datasets:
    """The dataset trees found in a root tree, by path: V3 and V2 trees
    alike, as kart_tpu finds them. A repository whose structure version is
    neither raises NotYetImplemented here, as kart_tpu's does."""

    def __init__(self, repo, tree):
        self.repo = repo
        self.tree = tree
        self.dataset_class = dataset_class_for_version(repo.version)
        self._cache = None

    def _discover(self):
        if self._cache is None:
            found = {}
            if self.tree is not None:
                self._walk(self.tree, "", found, MAX_DATASET_DEPTH)
            self._cache = found
        return self._cache

    def _walk(self, tree, prefix, found, depth):
        for cls in (Dataset3, Dataset2):
            if cls.is_dataset_tree(tree):
                found[prefix] = cls(tree, prefix, self.repo)
                return
        if depth <= 0:
            return
        for entry in tree.entries():
            if entry.is_tree and entry.name not in _RESERVED_DIRS:
                sub = f"{prefix}/{entry.name}" if prefix else entry.name
                self._walk(TreeView(tree.odb, entry.oid), sub, found, depth - 1)

    def __iter__(self):
        return iter(self._discover().values())

    def paths(self):
        return list(self._discover().keys())

    def __getitem__(self, ds_path):
        ds = self.get(ds_path)
        if ds is None:
            raise NotFound(f"No dataset at path {ds_path!r}")
        return ds

    def get(self, ds_path):
        return self._discover().get(ds_path.strip("/"))


class RepoStructure:
    """repo@revision."""

    def __init__(self, repo, refish="HEAD"):
        self.repo = repo
        self.refish = refish
        self.commit_oid, self.ref = repo.resolve_refish(refish if refish is not None else "HEAD")
        # a bare tree oid is a valid revision too (only raw-oid revisions
        # can be trees: named refs always peel to commits)
        self._bare_tree_oid = None
        if self.commit_oid is not None and self.ref is None:
            try:
                if repo.odb.object_type(self.commit_oid) == "tree":
                    self._bare_tree_oid, self.commit_oid = self.commit_oid, None
            except KeyError:
                pass

    @property
    def commit(self):
        return self.repo.odb.read_commit(self.commit_oid) if self.commit_oid else None

    @property
    def tree_oid(self):
        if self._bare_tree_oid is not None:
            return self._bare_tree_oid
        commit = self.commit
        return commit.tree if commit else None

    @property
    def tree(self):
        oid = self.tree_oid
        return self.repo.odb.tree(oid) if oid else None

    @property
    def datasets(self):
        ds = self.__dict__.get("_datasets")
        if ds is None:
            ds = self.__dict__["_datasets"] = Datasets(self.repo, self.tree)
        return ds

    def decode_path(self, full_path):
        """Repo-root path -> (ds_path, part, item), part being 'feature',
        'meta', 'inner' or 'attachment'."""
        for dirname in DATASET_DIRNAMES:
            marker = f"/{dirname}/"
            if marker in full_path:
                ds_path, _, inner = full_path.partition(marker)
                if inner.startswith("feature/"):
                    return ds_path, "feature", inner[len("feature/"):]
                if inner.startswith("meta/"):
                    return ds_path, "meta", inner[len("meta/"):]
                return ds_path, "inner", inner
        ds_path, _, name = full_path.rpartition("/")
        return ds_path, "attachment", name

    # -- writing -------------------------------------------------------------

    def create_tree_from_diff(self, repo_diff, *, allow_missing_old=False):
        """Apply a RepoDiff to this revision's tree -> the new tree oid. A
        dataset the revision lacks must come with a schema insert."""
        tb = TreeBuilder(self.repo.odb, self.tree_oid)
        datasets = self.datasets
        for ds_path, ds_diff in repo_diff.items():
            ds = datasets.get(ds_path)
            if ds is None:
                meta_diff = ds_diff.get("meta")
                if not meta_diff or "schema.json" not in meta_diff:
                    raise PatchApplyError(
                        f"Diff contains dataset {ds_path!r} which is not in this revision")
                ds = datasets.dataset_class(None, ds_path, self.repo)
            ds.apply_diff(ds_diff, tb, allow_missing_old=allow_missing_old)
        return tb.flush()

    def commit_diff(self, repo_diff, message, *, ref="HEAD", allow_empty=False, amend=False,
                    author=None, committer=None, validate=True):
        """Validate and apply a RepoDiff, derive the changed datasets'
        sidecars and commit -> the commit oid. ``ref`` HEAD moves the ref
        this revision was resolved from (HEAD itself for an oid)."""
        if validate:
            self.check_values_match_schema(repo_diff)
        new_tree = self.create_tree_from_diff(repo_diff)
        if not allow_empty and not amend and new_tree == self.tree_oid:
            raise InvalidOperation("No changes to commit", "NO_CHANGES")
        self._update_sidecars(repo_diff, new_tree)
        if amend:
            commit = self.commit
            if commit is None:
                raise InvalidOperation("Cannot amend: no commit at this revision")
            parents = list(commit.parents)
            if message is None:
                message = commit.message
        else:
            parents = [self.commit_oid] if self.commit_oid else []
        return self.repo.create_commit(
            ref if self.ref is None else (self.ref if ref == "HEAD" else ref),
            new_tree, message, parents, author=author, committer=committer)

    def _update_sidecars(self, repo_diff, new_tree):
        """Derive each changed dataset's sidecar for its new feature tree
        (not when its meta changed too: its blobs may follow a new schema).
        A failure logs a warning and leaves the next diff to walk the tree."""
        from kart_tpu_torch.diff import sidecar

        try:
            root = self.repo.odb.tree(new_tree)
            for ds_path, ds_diff in repo_diff.items():
                feature_diff = ds_diff.get("feature")
                if not feature_diff or ds_diff.get("meta"):
                    continue
                old_ds = self.datasets.get(ds_path)
                if old_ds is None:
                    continue
                node = root.get_or_none(f"{ds_path}/{old_ds.DATASET_DIRNAME}/feature")
                if node is not None:
                    sidecar.update_sidecar_for_commit(self.repo, old_ds, node.oid, feature_diff)
        except Exception:
            L.warning("columnar sidecar update failed (cache only)", exc_info=True)

    def check_values_match_schema(self, repo_diff):
        """Raise SchemaViolation naming every column whose new value does
        not fit its type (one example a column)."""
        datasets = self.datasets
        all_violations = {}
        for ds_path, ds_diff in repo_diff.items():
            feature_diff = ds_diff.get("feature")
            if not feature_diff:
                continue
            meta_diff = ds_diff.get("meta") or {}
            if "schema.json" in meta_diff and meta_diff["schema.json"].new is not None:
                schema = Schema.from_column_dicts(meta_diff["schema.json"].new_value)
            else:
                ds = datasets.get(ds_path)
                if ds is None:
                    continue
                schema = ds.schema
            violations = {}
            for delta in feature_diff.values():
                if delta.new is not None:
                    schema.validate_feature(delta.new_value, violations)
            if violations:
                all_violations[ds_path] = violations
        if all_violations:
            details = "\n".join(v for ds in all_violations.values() for v in ds.values())
            raise SchemaViolation(f"Schema violation:\n{details}")
