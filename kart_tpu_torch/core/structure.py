"""A repository at one revision, and the datasets in its tree.

Counterpart of the read side of kart_tpu's ``core/structure.py``
(``Datasets``, ``RepoStructure`` with ``decode_path``). Committing a diff
(``commit_diff``/``create_tree_from_diff``) is not ported.
"""

from kart_tpu_torch.core.odb import TreeView
from kart_tpu_torch.core.repo import NotFound
from kart_tpu_torch.models.dataset import Dataset2, Dataset3, dataset_class_for_version

_RESERVED_DIRS = {".kart", ".sno", ".git"}
#: the inner directory names of V3 and of V2 datasets
DATASET_DIRNAMES = (Dataset3.DATASET_DIRNAME, Dataset2.DATASET_DIRNAME)
MAX_DATASET_DEPTH = 5


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
