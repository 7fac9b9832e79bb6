"""Want/have negotiation: which objects a transfer ships.

The sender walks history from the *want* tips, stopping at what the
receiver already *has*, then walks each new commit's tree, skipping whole
subtrees the receiver has: the reachability ``git rev-list --objects A ^B``
computes, over this package's object store. Three more axes:

* ``depth``: a shallow clone or fetch cuts the commit walk N commits below
  each tip and reports the cut commits as ``shallow_boundary``;
* ``blob_filter``: a callable ``(path, oid) -> bool`` that may veto a blob
  (a spatially filtered clone); a vetoed blob is left out and the receiver
  records its remote as a promisor;
* ``exclude``: oids the receiver holds without any closure guarantee; they
  are not shipped, but the walk still goes down through them.

Counterpart of kart_tpu's ``transport/protocol.py`` ``ObjectEnumerator``,
with its ``(type, content)`` sequence in its order. The structured
rejection of a refused push and its wire fields serve the network lanes and
are not ported.
"""

from kart_tpu_torch.core.objects import Tag
from kart_tpu_torch.core.odb import ObjectMissing


class ObjectEnumerator:
    """Iterable over the ``(type, content)`` pairs a receiver is missing.

    After iteration: ``object_count`` (objects yielded),
    ``omitted_blob_count`` (blobs vetoed or absent), ``shallow_boundary``
    (commit oids shipped without their parents) and ``commit_count``."""

    #: blobs wait in a list of at most this many, then go out in batches
    BLOB_BATCH = 10000

    def __init__(self, odb, wants, *, has=None, depth=None, blob_filter=None,
                 sender_shallow=frozenset(), exclude=frozenset()):
        self.odb = odb
        self.wants = list(wants)
        self.has = has or (lambda oid: False)
        self.depth = depth
        self.blob_filter = blob_filter
        self.sender_shallow = set(sender_shallow)
        self.exclude = frozenset(exclude)
        self.object_count = 0
        self.omitted_blob_count = 0
        self.commit_count = 0
        self.shallow_boundary = set()

    def __iter__(self):
        shipped_trees, pending = set(), []
        for commit_oid in self._select_commits():
            if commit_oid not in self.exclude:
                yield self.odb.read_raw(commit_oid)
                self.object_count += 1
                self.commit_count += 1
            tree_oid = self._tree_oid_of(commit_oid)
            if tree_oid is not None:
                yield from self._walk_tree(tree_oid, "", shipped_trees, pending)
        yield from self._flush_blobs(pending)

    def _select_commits(self):
        """Commit (and tag) oids to ship, newest first in each layer of a
        breadth-first walk; tags are peeled to their targets."""
        out, visited, frontier = [], set(), []
        for want in self.wants:
            peeled = self._peel_want(want, out)
            if peeled is not None:
                frontier.append((peeled, 1))  # depth counts commits from the tip
        while frontier:
            next_frontier = []
            for oid, d in frontier:
                if oid in visited:
                    continue
                visited.add(oid)
                # with a depth, walk on through what the receiver has: that
                # is how a shallow clone deepens
                if self.has(oid) and self.depth is None:
                    continue
                try:
                    commit = self.odb.read_commit(oid)
                except ObjectMissing:
                    continue  # the sender's own shallow or partial boundary
                if not self.has(oid):
                    out.append(oid)
                at_depth_limit = self.depth is not None and d >= self.depth
                if (at_depth_limit or oid in self.sender_shallow) and commit.parents:
                    self.shallow_boundary.add(oid)
                    continue
                next_frontier.extend((p, d + 1) for p in commit.parents)
            frontier = next_frontier
        return out

    def _peel_want(self, oid, out):
        """A want tip -> its commit oid (None: nothing to walk); the tag
        objects on the way are appended to ``out``."""
        while True:
            if self.has(oid) and self.depth is None:
                return None
            try:
                obj_type, content = self.odb.read_raw(oid)
            except ObjectMissing:
                return None
            if obj_type == "commit":
                return oid
            if obj_type != "tag":
                return None  # a tree or blob want: the tree walk covers it
            out.append(oid)
            oid = Tag.parse(content).target

    def _tree_oid_of(self, commit_oid):
        try:
            return self.odb.read_commit(commit_oid).tree
        except ObjectMissing:
            return None

    def _walk_tree(self, tree_oid, prefix, shipped, pending):
        if tree_oid in shipped or self.has(tree_oid):
            return
        shipped.add(tree_oid)
        try:
            entries = self.odb.read_tree_entries(tree_oid)
            _, content = self.odb.read_raw(tree_oid)
        except ObjectMissing:
            return
        # an excluded tree is not shipped but still walked: its blobs may
        # not have arrived
        if tree_oid not in self.exclude:
            yield "tree", content
            self.object_count += 1
        for e in entries:
            path = f"{prefix}{e.name}"
            if e.is_tree:
                yield from self._walk_tree(e.oid, path + "/", shipped, pending)
                continue
            if e.oid in shipped or self.has(e.oid) or e.oid in self.exclude:
                continue
            if self.blob_filter is not None and not self.blob_filter(path, e.oid):
                self.omitted_blob_count += 1
                continue
            shipped.add(e.oid)
            pending.append(e.oid)
            if len(pending) >= self.BLOB_BATCH:
                yield from self._flush_blobs(pending)

    def _flush_blobs(self, pending):
        """The pending blobs, read in batches of 1000 from the packs and one
        by one where a batch cannot serve them; a blob the store lacks (a
        promised one on a partial clone that serves) is left out."""
        for i in range(0, len(pending), 1000):
            chunk = pending[i : i + 1000]
            batch = self.odb.read_blobs_batch(chunk)
            for oid in chunk:
                blob = batch.get(oid)
                if blob is None:
                    try:
                        _, blob = self.odb.read_raw(oid)
                    except ObjectMissing:
                        self.omitted_blob_count += 1
                        continue
                yield "blob", blob
                self.object_count += 1
        pending.clear()
