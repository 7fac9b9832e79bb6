"""Batched multi-path tree writer: collects blob inserts and removals at
any depth, then :meth:`TreeBuilder.flush` rewrites only the changed spine
of the base tree, bottom-up, writing each new tree object once. A tree
left with no entries is dropped from its parent; an all-deleted root
flushes to the empty tree.

Counterpart of kart_tpu's ``core/tree_builder.py``.
"""

from kart_tpu_torch.core.objects import (
    MODE_BLOB,
    MODE_TREE,
    ObjectFormatError,
    serialise_records,
    tree_record,
    tree_records,
)

_DELETED = object()

# a key of a subtree's changes: the base tree's entries of this subtree are
# ignored (it was removed or overwritten before these inserts)
_CLEARED = object()


class TreeBuilder:
    def __init__(self, odb, base_tree_oid=None):
        self.odb = odb
        self.base_tree_oid = base_tree_oid
        # nested dict: name -> _DELETED | (mode, oid) | dict (subtree)
        self._changes = {}
        self._count = 0

    def __bool__(self):
        return bool(self._changes)

    @property
    def change_count(self):
        return self._count

    def _node_for_dir(self, dir_parts):
        node = self._changes
        for part in dir_parts:
            child = node.get(part)
            if not isinstance(child, dict):
                # below a deleted or overwritten entry the new subtree must
                # not inherit the base tree's contents
                child = {_CLEARED: True} if child is not None else {}
                node[part] = child
            node = child
        return node

    def insert(self, path, oid, mode=MODE_BLOB):
        """Schedule ``oid`` at ``path`` ('a/b/c')."""
        *dirs, name = path.split("/")
        self._node_for_dir(dirs)[name] = (mode, oid)
        self._count += 1

    def remove(self, path):
        *dirs, name = path.split("/")
        self._node_for_dir(dirs)[name] = _DELETED
        self._count += 1

    def remove_tree(self, path):
        """Remove the whole subtree at ``path``."""
        self.remove(path)

    def insert_many(self, paths, oids, mode=MODE_BLOB):
        for path, oid in zip(paths, oids):
            self.insert(path, oid, mode)

    def flush(self):
        """Apply the pending changes to the base tree; -> new root tree oid."""
        result = self._build(self.base_tree_oid, self._changes)
        self._changes = {}
        self._count = 0
        if result is None:
            result = self.odb.write_raw("tree", b"")  # everything deleted
        self.base_tree_oid = result
        return result

    def _build(self, base_oid, changes):
        """-> new tree oid, or None when the tree ends up empty. Entries are
        kept as their bytes, so an unchanged one is copied, not re-encoded."""
        if changes.pop(_CLEARED, False):
            base_oid = None
        records = {}
        if base_oid is not None:
            obj_type, data = self.odb.read_raw(base_oid)
            if obj_type != "tree":
                raise ObjectFormatError(f"{base_oid} is a {obj_type}, expected tree")
            records = tree_records(data)
        for name, change in changes.items():
            if change is _DELETED:
                records.pop(name, None)
            elif isinstance(change, dict):
                base_child = records.get(name)
                child_oid = self._build(
                    base_child[1][-20:].hex()
                    if base_child is not None and base_child[0] == MODE_TREE else None,
                    change,
                )
                if child_oid is None:
                    records.pop(name, None)
                else:
                    records[name] = (MODE_TREE, tree_record(name, MODE_TREE, child_oid))
            else:
                mode, oid = change
                records[name] = (mode, tree_record(name, mode, oid))
        if not records:
            return None
        if base_oid is not None and not changes:
            return base_oid
        return self.odb.write_raw("tree", serialise_records(records))
