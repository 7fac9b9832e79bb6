"""Want/have negotiation: decide which objects to ship.

The sender walks history from the *want* tips, pruning at anything the
receiver already *has* (the local analog of git's have/want exchange), then
walks each new commit's tree, pruning whole subtrees the receiver has — the
same reachability shape `git rev-list --objects A ^B` computes, re-expressed
over our object store (reference transport: kart/cli.py:211-253).

Two extra axes the reference gets from its forked git:

* **depth** — shallow clone/fetch (`kart clone --depth`, kart/clone.py:72-75):
  the commit walk is cut N commits below each tip; the cut points are
  reported as ``shallow_boundary`` for the receiver to record.
* **blob_filter** — partial clone (`--filter=extension:spatial=…`,
  vendor/spatial-filter/spatial_filter.cpp:212-260): a callback may veto
  individual blobs (by path + oid); vetoed blobs are *omitted* and the
  receiver records the remote as a promisor so later reads raise
  ObjectPromised instead of hard-failing.

A third axis backs resumable fetch: **exclude** — exact oids the receiver
already holds, salvaged from a torn earlier transfer. Unlike ``has`` these
carry *no* closure guarantee (a disconnect delivers commits before their
trees' blobs), so they suppress shipping object-by-object while the walk
still descends through them to find the missing remainder.

This module also defines the **structured rejection frame** both servers
speak when a receive-pack is refused (docs/SERVING.md §6): a
:class:`Rejection` stays tuple-compatible with the plain ``(kind, message)``
API while carrying machine-readable extras — a ``conflict_report`` the
client renders exactly like a local ``kart merge`` conflict, a ``terminal``
flag the retry policy obeys (no blind re-push of commits that will conflict
again), and the ``retry_after``/``shed`` pacing fields of the 429 lane.
"""

from kart_tpu_torch.core.odb import ObjectMissing

#: wire fields a structured rejection may carry beyond "error" — one list
#: so the HTTP JSON body and the stdio response frame can never drift
REJECTION_WIRE_FIELDS = (
    "code", "ref", "terminal", "conflict_report", "retry_after", "shed"
)


class Rejection(tuple):
    """A ``(kind, message)`` receive-pack rejection with structured extras.

    ``kind``: ``"conflict"`` (precondition failed against current state),
    ``"bad"`` (malformed/incomplete request), or ``"busy"`` (back-pressure:
    merge queue overflow / CAS re-validation budget exhausted — retryable
    with pacing, the 429 lane). Tuple compatibility keeps every plain-tuple caller
    (``status, msg = rejection``) working unchanged.

    Extras: ``code`` — machine-readable cause (``cas_stale`` /
    ``merge_conflict`` / ``non_ff`` / ``denied`` / ``df_conflict`` /
    ``queue_full`` / ``cas_busy``); ``ref`` — the ref that tripped it;
    ``terminal`` — a deterministic application-level verdict no retry
    policy may override; ``conflict_report`` — the structured three-way
    conflict document (byte-identical JSON to a local
    ``kart merge <tip> --dry-run -o json``); ``retry_after``/``shed`` —
    pacing for the busy lane."""

    def __new__(cls, kind, message, *, code=None, ref=None, terminal=False,
                conflict_report=None, retry_after=None, shed=False):
        self = super().__new__(cls, (kind, message))
        self.kind = kind
        self.message = message
        self.code = code
        self.ref = ref
        self.terminal = bool(terminal)
        self.conflict_report = conflict_report
        self.retry_after = retry_after
        self.shed = bool(shed)
        return self


def rejection_wire_fields(rejection):
    """The extra response fields ``rejection`` puts on the wire (beyond the
    kind/message every server already sends) — shared by the HTTP error
    body and the stdio error frame so the two transports report a conflict
    identically. Plain ``(kind, msg)`` tuples contribute nothing."""
    out = {}
    for name in REJECTION_WIRE_FIELDS:
        value = getattr(rejection, name, None)
        # identity checks: retry_after=0 ("retry immediately") must ride
        # the wire — `0 in (None, False)` would be True and drop it
        if value is None or value is False:
            continue
        out[name] = value
    return out


def error_attrs_from_wire(body):
    """Inverse of :func:`rejection_wire_fields` on the client: the keyword
    attrs a transport error should carry for a structured rejection body
    (``terminal``/``conflict_report``/``retry_after``/``shed``). Works on
    any dict-shaped error payload; unknown/absent fields contribute
    nothing."""
    if not isinstance(body, dict):
        return {}
    out = {}
    if body.get("terminal"):
        out["terminal"] = True
    if body.get("conflict_report") is not None:
        out["conflict_report"] = body["conflict_report"]
    if body.get("retry_after") is not None:
        out["retry_after"] = body["retry_after"]
    if body.get("shed"):
        out["shed"] = True
    return out


class ObjectEnumerator:
    """Iterable over the ``(type, content)`` pairs a receiver is missing.

    After iteration, inspect:
      * ``object_count`` — objects yielded
      * ``omitted_blob_count`` — blobs vetoed by blob_filter
      * ``shallow_boundary`` — commit oids shipped without their parents
      * ``commit_count`` — commits shipped
      * ``emitted`` — with ``record_emitted=True``, the ordered
        ``(type, oid)`` pairs yielded: the walk-free replay script the
        server's pack-enumeration cache memoizes (docs/SERVING.md §2) —
        re-reading those oids in that order reproduces the pack
        byte-identically without re-walking reachability.
    """

    def __init__(
        self,
        odb,
        wants,
        *,
        has=None,
        depth=None,
        blob_filter=None,
        sender_shallow=frozenset(),
        exclude=frozenset(),
        record_emitted=False,
    ):
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
        self.emitted = [] if record_emitted else None

    # blobs are read through the native batch inflate in chunks of this many
    # (kartpack has no deltas and receivers write objects independently, so
    # stream order is free — batching is pure win for serve/clone)
    BLOB_BATCH = 10000

    def __iter__(self):
        shipped_trees = set()
        pending = []
        for commit_oid in self._select_commits():
            # excluded commits aren't re-shipped, but their trees are still
            # walked: the receiver salvaged the commit object itself, not
            # necessarily anything below it
            if commit_oid not in self.exclude:
                obj_type, content = self.odb.read_raw(commit_oid)
                if self.emitted is not None:
                    self.emitted.append((obj_type, commit_oid))
                yield obj_type, content
                self.object_count += 1
                self.commit_count += 1
            tree_oid = self._tree_oid_of(commit_oid)
            if tree_oid is not None:
                yield from self._walk_tree(tree_oid, "", shipped_trees, pending)
        yield from self._flush_blobs(pending)

    # -- commit selection --------------------------------------------------

    def _select_commits(self):
        """Commit (and tag) oids to ship, newest-first per BFS layer.
        Tag objects are shipped inline and peeled to their targets."""
        out = []
        visited = set()
        # (oid, depth) — depth counts commits from the tip, tip = 1
        frontier = []
        for want in self.wants:
            peeled = self._peel_want(want, out)
            if peeled is not None:
                frontier.append((peeled, 1))
        while frontier:
            next_frontier = []
            for oid, d in frontier:
                if oid in visited:
                    continue
                visited.add(oid)
                # with an explicit depth, keep walking even through commits
                # the receiver has — that's how a shallow clone deepens
                if self.has(oid) and self.depth is None:
                    continue
                try:
                    commit = self.odb.read_commit(oid)
                except ObjectMissing:
                    continue  # sender-side shallow/partial boundary
                if not self.has(oid):
                    out.append(oid)
                at_depth_limit = self.depth is not None and d >= self.depth
                at_sender_boundary = oid in self.sender_shallow
                if (at_depth_limit or at_sender_boundary) and commit.parents:
                    self.shallow_boundary.add(oid)
                    continue
                for p in commit.parents:
                    next_frontier.append((p, d + 1))
            frontier = next_frontier
        return out

    def _peel_want(self, oid, out):
        """Resolve a want tip to a commit oid; tag objects along the way are
        appended to ``out`` for shipping."""
        while True:
            if self.has(oid) and self.depth is None:
                return None  # with depth set, keep walking (deepening fetch)
            try:
                obj_type, content = self.odb.read_raw(oid)
            except ObjectMissing:
                return None
            if obj_type == "commit":
                return oid
            if obj_type == "tag":
                from kart_tpu_torch.core.objects import Tag

                out.append(oid)
                oid = Tag.parse(content).target
                continue
            # tree/blob want (unusual): ship nothing here; tree walk covers it
            return None

    def _tree_oid_of(self, commit_oid):
        try:
            return self.odb.read_commit(commit_oid).tree
        except ObjectMissing:
            return None

    # -- tree walk ---------------------------------------------------------

    def _walk_tree(self, tree_oid, prefix, shipped, pending):
        if tree_oid in shipped or self.has(tree_oid):
            return
        shipped.add(tree_oid)
        try:
            entries = self.odb.read_tree_entries(tree_oid)
            _, content = self.odb.read_raw(tree_oid)
        except ObjectMissing:
            return
        # an excluded tree still recurses: the receiver may hold the tree
        # object while its blobs were lost to the disconnect (blobs ship in
        # deferred batches behind the trees that reference them)
        if tree_oid not in self.exclude:
            if self.emitted is not None:
                self.emitted.append(("tree", tree_oid))
            yield "tree", content
            self.object_count += 1
        for e in entries:
            path = f"{prefix}{e.name}"
            if e.is_tree:
                yield from self._walk_tree(e.oid, path + "/", shipped, pending)
            else:
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
        """Drain the pending blob oids: batch pack reads in bounded slices
        (so huge-blob datasets can't materialise the whole flush in RAM at
        once — the server spools the pack to disk for exactly that reason),
        per-object fallback for whatever a batch couldn't resolve (loose,
        delta, promised — promised blobs on a serving partial clone are
        omitted, as before)."""
        if not pending:
            return
        SLICE = 1000
        for i in range(0, len(pending), SLICE):
            chunk = pending[i : i + SLICE]
            batch = self.odb.read_blobs_batch(chunk)
            for oid in chunk:
                blob = batch.get(oid)
                if blob is None:
                    try:
                        _, blob = self.odb.read_raw(oid)
                    except ObjectMissing:
                        self.omitted_blob_count += 1
                        continue
                if self.emitted is not None:
                    self.emitted.append(("blob", oid))
                yield "blob", blob
                self.object_count += 1
        pending.clear()
