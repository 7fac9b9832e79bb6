"""Batched multi-path tree writer: collects blob inserts at any depth, then
:meth:`TreeBuilder.flush` rewrites only the changed spine of the base tree,
bottom-up, writing each new tree object once.

Counterpart of kart_tpu's ``core/tree_builder.py`` (inserts only; removal
is not ported).
"""

from kart_tpu_torch.core.objects import MODE_BLOB, MODE_TREE, TreeEntry, serialise_tree


class TreeBuilder:
    def __init__(self, odb, base_tree_oid=None):
        self.odb = odb
        self.base_tree_oid = base_tree_oid
        self._changes = {}  # name -> (mode, oid) | dict (subtree)

    def insert(self, path, oid, mode=MODE_BLOB):
        """Schedule ``oid`` at ``path`` ('a/b/c')."""
        *dirs, name = path.split("/")
        node = self._changes
        for part in dirs:
            child = node.get(part)
            if not isinstance(child, dict):
                child = node[part] = {}
            node = child
        node[name] = (mode, oid)

    def flush(self):
        """Apply the pending inserts to the base tree; -> new root tree oid."""
        result = self._build(self.base_tree_oid, self._changes)
        self._changes = {}
        self.base_tree_oid = result
        return result

    def _build(self, base_oid, changes):
        entries = ({e.name: e for e in self.odb.read_tree_entries(base_oid)}
                   if base_oid is not None else {})
        for name, change in changes.items():
            if isinstance(change, dict):
                base_child = entries.get(name)
                child_oid = self._build(
                    base_child.oid if base_child is not None and base_child.is_tree else None,
                    change,
                )
                entries[name] = TreeEntry(name, MODE_TREE, child_oid)
            else:
                mode, oid = change
                entries[name] = TreeEntry(name, mode, oid)
        if base_oid is not None and not changes:
            return base_oid
        return self.odb.write_raw("tree", serialise_tree(entries.values()))
