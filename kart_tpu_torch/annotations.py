"""The diff annotations cache: ``<gitdir>/annotations.db`` (sqlite).

It memoises facts about tree pairs, today the estimated feature-change
counts of ``kart diff --only-feature-count``, under a key that is the same
for A<>B and B<>A. When the gitdir cannot be written, entries live in
memory for the process.

It also holds each commit's exact per-dataset feature-change counts
against its first parent: :meth:`DiffAnnotations.count_changes` fills one
entry from a diff on the engine (one K1 launch a dataset when both
revisions have sidecars, the tree walk otherwise), and
:meth:`DiffAnnotations.build_all` (``kart build-annotations``) fills them
for HEAD's history.

Counterpart of kart_tpu's ``annotations.py`` (all of it): the same file,
table, index, keys and JSON values, so each package reads what the other
wrote.
"""

import json
import os
import sqlite3

_DDL = """
CREATE TABLE IF NOT EXISTS kart_annotations (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    object_id TEXT NOT NULL,
    annotation_type TEXT NOT NULL,
    data TEXT NOT NULL
);
CREATE UNIQUE INDEX IF NOT EXISTS kart_annotations_multicol
    ON kart_annotations (object_id, annotation_type);
"""

DEFAULT_TYPE = "feature-change-counts-exact"


class DiffAnnotations:
    def __init__(self, repo):
        self.repo = repo
        self.db_path = os.path.join(repo.gitdir, "annotations.db")
        self._memory = {}
        self._readonly = False
        try:
            with self._connect() as con:
                con.executescript(_DDL)
        except sqlite3.OperationalError:
            self._readonly = True

    def _connect(self):
        return sqlite3.connect(self.db_path)

    @staticmethod
    def _object_id(base_tree, target_tree):
        a, b = sorted([base_tree or "", target_tree or ""])
        return f"{a}...{b}"

    def get(self, base_tree, target_tree, annotation_type=DEFAULT_TYPE):
        """-> the JSON value stored for the tree pair, or None."""
        key = (self._object_id(base_tree, target_tree), annotation_type)
        if key in self._memory:
            return self._memory[key]
        if self._readonly:
            return None
        with self._connect() as con:
            row = con.execute(
                "SELECT data FROM kart_annotations WHERE object_id = ? AND annotation_type = ?",
                key,
            ).fetchone()
        return json.loads(row[0]) if row else None

    def set(self, base_tree, target_tree, data, annotation_type=DEFAULT_TYPE):
        key = (self._object_id(base_tree, target_tree), annotation_type)
        self._memory[key] = data
        if self._readonly:
            return
        with self._connect() as con:
            con.execute(
                "INSERT OR REPLACE INTO kart_annotations (object_id, annotation_type, data) "
                "VALUES (?, ?, ?)",
                (*key, json.dumps(data)),
            )

    def count_changes(self, base_rs, target_rs, device=None):
        """Per-dataset feature-change counts between two revisions, from the
        cache or from a diff on ``device`` (which then fills it)."""
        base_tree = base_rs.tree_oid if base_rs else None
        target_tree = target_rs.tree_oid if target_rs else None
        cached = self.get(base_tree, target_tree)
        if cached is not None:
            return cached
        from kart_tpu_torch.diff.engine import get_repo_diff

        diff = get_repo_diff(base_rs, target_rs, device=device)
        counts = {ds_path: len(ds_diff.get("feature", ())) for ds_path, ds_diff in diff.items()}
        self.set(base_tree, target_tree, counts)
        return counts

    def build_all(self, all_reachable=False, device=None):
        """Count the changes of HEAD's history, newest first, each commit
        against its first parent: the newest 100 commits, or every one with
        ``all_reachable``. -> the number of commits annotated."""
        repo = self.repo
        if repo.head_is_unborn:
            return 0
        built = 0
        for oid, commit in repo.walk_commits(repo.head_commit_oid):
            parent = commit.parents[0] if commit.parents else None
            self.count_changes(repo.structure(parent) if parent else None, repo.structure(oid),
                               device=device)
            built += 1
            if not all_reachable and built >= 100:
                break
        return built
