"""Batched multi-path tree writer: collects blob inserts and removals at
any depth, then :meth:`TreeBuilder.flush` rewrites only the changed spine
of the base tree, bottom-up, writing each new tree object once. It reads
the base trees it rewrites a level at a time in pack order, and writes a
level's new trees in one batch (a merge of a hash-keyed dataset may
rewrite hundreds of thousands of leaves). A tree left with no entries is dropped from its parent; an
all-deleted root flushes to the empty tree.

Counterpart of kart_tpu's ``core/tree_builder.py``.
"""

from kart_tpu_torch.core.objects import (
    MODE_BLOB,
    MODE_TREE,
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
        result = self._build_levels()
        self._changes = {}
        self._count = 0
        if result is None:
            result = self.odb.write_raw("tree", b"")  # everything deleted
        self.base_tree_oid = result
        return result

    def _build_levels(self):
        """The changed spine, a level at a time: top-down, each level's base
        trees read in one batch (pack order) and parsed; then bottom-up,
        each node's entries patched (its subtrees' results from the level
        below) and the level's new trees written in one batch. Entries are
        kept as their bytes, so an unchanged one is copied, not re-encoded.
        -> the new root oid, or None when the tree ends up empty."""
        levels = []  # per depth: [base oid or None, changes, base records]
        level = [[self.base_tree_oid, self._changes]]
        while level:
            for node in level:
                if node[1].pop(_CLEARED, False):
                    node[0] = None
            based = [node for node in level if node[0] is not None]
            datas = self.odb.read_trees_ordered([bytes.fromhex(node[0]) for node in based])
            records = {id(node): tree_records(data) for node, data in zip(based, datas)}
            below = []
            for node in level:
                recs = records.get(id(node), {})
                node.append(recs)
                for name, change in node[1].items():
                    if isinstance(change, dict):
                        child = recs.get(name)
                        below.append([child[1][-20:].hex()
                                      if child is not None and child[0] == MODE_TREE else None,
                                      change])
            levels.append(level)
            level = below
        results = {}  # id(changes) -> new oid or None
        for level in reversed(levels):
            for node, oid in zip(level, _level_results(level, results, self.odb)):
                results[id(node[1])] = oid
        return results[id(self._changes)]


def _level_results(level, results, odb):
    """-> each node's new tree oid (or its base oid when unchanged, None
    when empty), its subtrees' results read from ``results``; the new trees
    written in one batch."""
    out, payloads = [], []
    for base_oid, changes, recs in level:
        for name, change in changes.items():
            if change is _DELETED:
                recs.pop(name, None)
            elif isinstance(change, dict):
                child_oid = results[id(change)]
                if child_oid is None:
                    recs.pop(name, None)
                else:
                    recs[name] = (MODE_TREE, tree_record(name, MODE_TREE, child_oid))
            else:
                mode, oid = change
                recs[name] = (mode, tree_record(name, mode, oid))
        if not recs:
            out.append(None)
        elif base_oid is not None and not changes:
            out.append(base_oid)
        else:
            out.append(len(payloads))
            payloads.append(serialise_records(recs))
    oids = odb.write_raw_many("tree", payloads)
    return [bytes(oids[x]).hex() if isinstance(x, int) else x for x in out]
