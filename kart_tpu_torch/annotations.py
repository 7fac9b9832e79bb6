"""The diff annotations cache: ``<gitdir>/annotations.db`` (sqlite).

It memoises facts about tree pairs, today the estimated feature-change
counts of ``kart diff --only-feature-count``, under a key that is the same
for A<>B and B<>A. When the gitdir cannot be written, entries live in
memory for the process.

Counterpart of kart_tpu's ``annotations.py`` (``DiffAnnotations.get`` and
``set``): the same file, table, index, keys and JSON values, so each
package reads what the other wrote. ``count_changes`` and ``build_all``
are not ported.
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
