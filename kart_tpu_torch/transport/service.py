"""Transport-agnostic server-side operations.

The four verbs every kart_tpu_torch transport speaks — ls-refs, fetch-pack,
fetch-blobs, receive-pack — implemented once over a repo, shared by the HTTP
server (:mod:`kart_tpu_torch.transport.http`) and the stdio/ssh server
(:mod:`kart_tpu_torch.transport.stdio`). The reference gets the same sharing from
git itself: upload-pack/receive-pack behave identically whether invoked by
``git daemon``, ssh, or https (kart/cli.py:211-253).

Receive-pack is *quarantined* (the analog of git's tmp_objdir): the pushed
pack drains into a temporary objects dir that borrows the main store via
alternates, and objects migrate into the live store only after the pack
checksum and every ref-update precondition pass — a failed, torn or
rejected push leaves the served store byte-identical.

Contended pushes are *auto-rebased server-side* (docs/SERVING.md §6): a
receive-pack that passes its checksum but loses the ref CAS — a contending
writer moved the tip first — is three-way merged against the new tip by the
merge-index classifier, still inside the quarantine, and re-validated under
the push locks; real conflicts reject with a structured report the client
renders exactly like a local ``kart merge`` conflict (and never blindly
retries). K contending writers are serialised through a per-ref FIFO merge
queue instead of convoying on the push lock.

Counterpart of kart_tpu's ``transport/service.py``. The served kernels run
on the server's device (``device``: None the card, ``"cpu"`` the plain
versions): K3 in a filtered fetch-pack's blob filter, K4 in a rebase's
three-way merge. The rebase merges in a view over the quarantine's store
that reads sidecars and never writes one, so no sidecar or annotation of
a quarantined commit reaches the live repository.
"""

import hashlib
import io
import json
import os
import shutil
import tempfile
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager, nullcontext

from kart_tpu_torch import faults
from kart_tpu_torch import telemetry as tm
from kart_tpu_torch.core.odb import ObjectMissing
from kart_tpu_torch.core.refs import RefError, check_ref_format
from kart_tpu_torch.core.repo import KartRepo
from kart_tpu_torch.core.singleflight import SingleFlightLRU
from kart_tpu_torch.transport.protocol import ObjectEnumerator, Rejection

#: subdirectory of <gitdir>/objects holding in-flight push quarantines
QUARANTINE_SUBDIR = "quarantine"

#: how many times a contended push's CAS is re-validated (each failed
#: re-check costing one server-side rebase onto the newest tip) before the
#: server gives up and sheds the push back to the paced-retry lane
#: (``KART_SERVE_REBASE_ATTEMPTS`` overrides)
DEFAULT_REBASE_ATTEMPTS = 3

#: per-ref merge-queue depth bound: more than this many writers waiting on
#: one ref sheds the newcomer with 429 + Retry-After instead of growing the
#: line without bound (``KART_SERVE_MERGE_QUEUE`` overrides; 0 = unbounded)
DEFAULT_MERGE_QUEUE_DEPTH = 32

#: a writer queued behind a wedged merge-queue holder stops waiting after
#: this long and sheds as busy — the line must never wedge harder than the
#: push it is ordering
MERGE_QUEUE_TIMEOUT = 600.0

#: default byte budget for the per-repo pack-enumeration cache
#: (``KART_SERVE_ENUM_CACHE`` overrides; ``0`` disables caching entirely)
DEFAULT_ENUM_CACHE_BYTES = 256 * 1024 * 1024

#: how long a request waits on another request's in-flight walk for the
#: same cache key before giving up and walking independently (a wedged
#: filler must not wedge every client behind it)
SINGLEFLIGHT_TIMEOUT = 600.0


def ls_refs_info(repo):
    """The advertisement: branch/tag tips, HEAD branch, shallow set."""
    from kart_tpu_torch.transport.remote import read_shallow

    tm.incr("transport.server.requests", verb="ls-refs")

    heads = {
        ref[len("refs/heads/"):]: oid
        for ref, oid in repo.refs.iter_refs("refs/heads/")
    }
    tags = {
        ref[len("refs/tags/"):]: oid
        for ref, oid in repo.refs.iter_refs("refs/tags/")
    }
    kind, target = repo.refs.head_target()
    head_branch = (
        target[len("refs/heads/"):]
        if kind == "symbolic" and target.startswith("refs/heads/")
        else None
    )
    return {
        "heads": heads,
        "tags": tags,
        "head_branch": head_branch,
        "shallow": sorted(read_shallow(repo)),
    }


def make_fetch_enum(repo, req, *, count_request=True, record_emitted=False, device=None):
    """fetch-pack request dict -> (ObjectEnumerator, header_fn). The header
    callable reads the enumerator's counters, so evaluate it only after the
    pack drain. ``count_request=False`` skips the request counters (the
    enum-cache front end :func:`serve_fetch_pack` counts them itself so a
    cache hit still shows up as a request). A ``filter`` runs its blob
    filter on ``device`` (None: the card, one K3 launch)."""
    from kart_tpu_torch.transport.remote import read_shallow
    from kart_tpu_torch.transport.http import have_closure

    if count_request:
        _count_fetch_request(req)
    blob_filter = None
    if req.get("filter"):
        from kart_tpu_torch.spatial_filter import blob_filter_for_spec

        blob_filter = blob_filter_for_spec(repo, req["filter"], device=device)
    has = None
    if req.get("haves"):
        closure = have_closure(repo.odb, req["haves"], req.get("have_shallow", ()))
        has = closure.__contains__
    enum = ObjectEnumerator(
        repo.odb,
        req.get("wants", []),
        has=has,
        depth=req.get("depth"),
        blob_filter=blob_filter,
        sender_shallow=read_shallow(repo),
        # the resume protocol: exact oids the client already holds (salvaged
        # from a torn earlier transfer). Unlike `haves` these carry no
        # closure guarantee, so they suppress shipping object-by-object
        # without pruning the walk — a resumed fetch ships only the missing
        # remainder.
        exclude=frozenset(req.get("exclude") or ()),
        record_emitted=record_emitted,
    )

    def header():
        return {
            "shallow_boundary": sorted(enum.shallow_boundary),
            "object_count": enum.object_count,
            "omitted_blob_count": enum.omitted_blob_count,
        }

    return enum, header


def _count_fetch_request(req):
    tm.incr("transport.server.requests", verb="fetch-pack")
    if req.get("exclude"):
        # a non-empty exclusion list IS the resume protocol: the client is
        # completing a torn earlier transfer (docs/ROBUSTNESS.md §3)
        tm.incr("transport.server.fetch_resumes")
        tm.incr("transport.server.excluded_oids", len(req["exclude"]))


def collect_blobs(repo, oids):
    """fetch-blobs (promisor backfill): -> (header, [(type, content)])."""
    tm.incr("transport.server.requests", verb="fetch-blobs")
    missing = []
    objects = []
    for oid in oids:
        try:
            objects.append(repo.odb.read_raw(oid))
        except ObjectMissing:
            missing.append(oid)
    return {"missing": missing}, objects


# ---------------------------------------------------------------------------
# pack-enumeration cache (docs/SERVING.md §2)
#
# The expensive half of serving a fetch is the reachability walk + tree
# recursion, and under concurrent clones of a hot repo every client used to
# re-pay it. The cache memoizes, per (wants, haves, shallow, depth, filter,
# excludes, ref-tips fingerprint) key: the final response header, a size
# estimate, and either the complete framed response bytes (small packs — a
# hit is a memcpy) or the ordered (type, oid) list the walk emitted (big
# packs — a hit replays object reads in order, no walk). Concurrent
# requests for an in-flight key block on the first walk (single-flight)
# instead of duplicating it. Ref updates invalidate: the fingerprint is
# part of the key, and apply_ref_updates additionally drops every entry so
# stale keys don't linger in the LRU.
# ---------------------------------------------------------------------------


class _CacheEntry:
    __slots__ = ("header", "data", "emitted", "nbytes", "etag")

    def __init__(self, header, data, emitted, etag):
        self.header = header
        self.data = data          # complete framed response bytes, or None
        self.emitted = emitted    # ordered (type, oid) replay list, or None
        self.etag = etag
        if data is not None:
            self.nbytes = len(data)
        else:
            # oid-list replay entry, charged at measured CPython cost:
            # ~89B hex-oid str + 56B tuple + interned type ref + list slot
            self.nbytes = 160 * len(emitted) + 1024


class PackEnumCache(SingleFlightLRU):
    """LRU-by-byte-budget memo of fetch-pack enumerations with
    single-flight fill (one instance per served repo). The concurrency
    machinery — single-flight tokens, the wedged-filler bypass, the
    poison-barrier publish, LRU eviction — is the shared
    :class:`~kart_tpu_torch.core.singleflight.SingleFlightLRU` (the tile cache
    runs the same core); this class contributes the entry shape
    (:class:`_CacheEntry`), the telemetry names and the fault point.

    A fill publishes a complete ``_CacheEntry``; a filler wedged past
    ``SINGLEFLIGHT_TIMEOUT`` stops gating (waiters walk uncached)."""

    SINGLEFLIGHT_TIMEOUT = SINGLEFLIGHT_TIMEOUT

    def __init__(self, budget_bytes):
        super().__init__(budget_bytes)
        # a single entry may use at most budget/8 bytes as raw framed
        # bytes; larger packs store the oid replay list instead, so one
        # huge clone can't evict every hot entry
        self.bytes_cap = max(1, budget_bytes // 8)

    def entry_nbytes(self, entry):
        return entry.nbytes

    def publish_fault(self):
        # the injectable failure of the cache-fill frame: a fault here must
        # poison nothing — the entry is never inserted (tests/test_faults.py)
        faults.fire("server.enum_cache")

    def count(self, event, n=1):
        if event == "hits":
            tm.incr("server.enum_cache.hits", n)
        elif event == "misses":
            tm.incr("server.enum_cache.misses", n)
        elif event == "singleflight_waits":
            tm.incr("server.enum_cache.singleflight_waits", n)
        elif event == "evictions":
            tm.incr("server.enum_cache.evictions", n)

    def gauge(self, total):
        tm.gauge_set("server.enum_cache.bytes", total)


#: gitdir -> PackEnumCache for every repo this process serves (bounded: a
#: long-lived test process churning tmp repos must not accrete caches)
_ENUM_CACHES = OrderedDict()
_ENUM_CACHES_MAX = 64
_enum_caches_lock = threading.Lock()


def enum_cache_for(repo):
    """The (process-wide) enumeration cache serving ``repo``, or None when
    disabled via ``KART_SERVE_ENUM_CACHE=0``."""
    from kart_tpu_torch.transport.retry import _env_int

    budget = _env_int("KART_SERVE_ENUM_CACHE", DEFAULT_ENUM_CACHE_BYTES)
    if budget <= 0:
        return None
    key = os.path.realpath(repo.gitdir)
    with _enum_caches_lock:
        cache = _ENUM_CACHES.get(key)
        if cache is None or cache.budget != budget:
            cache = _ENUM_CACHES[key] = PackEnumCache(budget)
        _ENUM_CACHES.move_to_end(key)
        while len(_ENUM_CACHES) > _ENUM_CACHES_MAX:
            _ENUM_CACHES.popitem(last=False)
    return cache


def refs_fingerprint(repo):
    """Digest of every (ref, oid) pair: part of each cache key, so a ref
    update — even by another process (an ssh push landing while the HTTP
    server runs) — changes every key rather than serving a stale walk."""
    h = hashlib.sha256()
    for ref, oid in sorted(repo.refs.iter_refs("refs/")):
        h.update(f"{ref}\0{oid}\n".encode())
    return h.hexdigest()


def _enum_cache_key(repo, req):
    payload = json.dumps(
        {
            # wants stay ordered: the walk order (and so the pack bytes)
            # follows them; everything set-like is canonicalised
            "wants": list(req.get("wants") or ()),
            "haves": sorted(req.get("haves") or ()),
            "have_shallow": sorted(req.get("have_shallow") or ()),
            "depth": req.get("depth"),
            "filter": req.get("filter"),
            "exclude": sorted(req.get("exclude") or ()),
            "refs": refs_fingerprint(repo),
        },
        sort_keys=True,
    )
    return hashlib.sha256(payload.encode()).hexdigest()


def _etag_for(key):
    """The strong validator for byte-range resume (If-Range): same key ⇒
    byte-identical response, and the key embeds the ref fingerprint."""
    return f'"{key[:32]}"'


class FetchPlan:
    """How to answer one fetch-pack request, produced by
    :func:`serve_fetch_pack`:

    * ``data`` set — a cache hit on stored framed bytes; send as-is.
    * otherwise — drain ``source`` through ``write_framed`` (``header`` is
      the deferred header callable), then ``publish()`` the spool /
      ``abandon()`` on failure. ``cached`` marks whether ``source`` is a
      cache replay (no walk ran).

    ``etag`` is the strong validator the transports hand out for
    byte-range resume; identical for hit, replay and fresh walks of the
    same key."""

    __slots__ = ("header", "data", "source", "etag", "cached", "_token", "_enum")

    def __init__(self, header, data, source, etag, cached, token=None, enum=None):
        self.header = header
        self.data = data
        self.source = source
        self.etag = etag
        self.cached = cached
        self._token = token
        self._enum = enum

    def publish(self, spool, length):
        """Memoize a freshly-spooled walk: small responses as their framed
        bytes, big ones as the ordered oid list (``spool`` is left at EOF;
        the caller rewinds)."""
        if self._token is None:
            return
        header = self.header() if callable(self.header) else self.header
        cache = self._token.cache
        etag = _etag_for(self._token.key)
        if length <= cache.bytes_cap:
            spool.seek(0)
            self._token.publish(
                _CacheEntry(header, spool.read(length), None, etag)
            )
        elif self._enum is not None and self._enum.emitted is not None:
            self._token.publish(
                _CacheEntry(header, None, list(self._enum.emitted), etag)
            )
        else:
            self._token.abandon()

    def abandon(self):
        if self._token is not None:
            self._token.abandon()


def iter_recorded(odb, emitted):
    """Replay an enumeration from its recorded ``(type, oid)`` list:
    byte-identical object stream, zero walk. Blob runs go through the
    batched pack reader exactly like the original walk's flush."""
    i, n = 0, len(emitted)
    while i < n:
        obj_type, oid = emitted[i]
        if obj_type != "blob":
            yield obj_type, odb.read_raw(oid)[1]
            i += 1
            continue
        j = i
        while j < n and emitted[j][0] == "blob":
            j += 1
        run = [oid for _, oid in emitted[i:j]]
        SLICE = 1000
        for k in range(0, len(run), SLICE):
            chunk = run[k : k + SLICE]
            batch = odb.read_blobs_batch(chunk)
            for o in chunk:
                blob = batch.get(o)
                if blob is None:
                    _, blob = odb.read_raw(o)
                yield "blob", blob
        i = j


def _replay_source(cache, key, odb, emitted):
    """iter_recorded, with poisoned-entry hygiene: an entry whose objects
    have vanished (gc raced the cache) is evicted and the error surfaces —
    the next request re-walks instead of re-hitting the corpse."""
    try:
        yield from iter_recorded(odb, emitted)
    except Exception:
        cache.evict(key)
        raise


def serve_fetch_pack(repo, req, *, use_cache=True, device=None):
    """The cache-fronted fetch-pack verb: -> :class:`FetchPlan`.

    First request for a key runs (and records) the walk; concurrent
    requests for the same key block on it and hit; later requests hit
    the memo. With the cache disabled (``KART_SERVE_ENUM_CACHE=0``, or
    ``use_cache=False`` for single-connection servers where a memo could
    never be re-hit) the plan is a plain fresh walk — still carrying the
    deterministic etag, so byte-range resume works regardless."""
    _count_fetch_request(req)
    # an exclusion-bearing request is a one-shot resume: its key embeds the
    # exact oids that happened to land before a tear, so no second request
    # can ever hit it — memoizing would only evict hot repeatable entries.
    # The etag/deterministic-replay contract holds regardless.
    if req.get("exclude"):
        use_cache = False
    cache = enum_cache_for(repo) if use_cache else None
    key = _enum_cache_key(repo, req)
    etag = _etag_for(key)
    if cache is None:
        enum, header = make_fetch_enum(repo, req, count_request=False, device=device)
        return FetchPlan(header, None, enum, etag, False)
    mode, got = cache.lookup_or_begin(key)
    if mode == "hit":
        # the cache decision joins this request's access-log record
        tm.annotate(enum_cache="hit")
        if got.data is not None:
            return FetchPlan(got.header, got.data, None, got.etag, True)
        return FetchPlan(
            got.header,
            None,
            _replay_source(cache, key, repo.odb, got.emitted),
            got.etag,
            True,
        )
    try:
        tm.annotate(enum_cache="miss")
        enum, header = make_fetch_enum(
            repo, req, count_request=False, record_emitted=True, device=device
        )
    except BaseException:
        # a pre-walk failure (malformed filter spec, unreadable shallow
        # file) must release the fill token, or every later request for
        # this key would block on an event nobody will ever set
        if got is not None:
            got.abandon()
        raise
    return FetchPlan(header, None, enum, etag, False, token=got, enum=enum)


def materialise_plan(plan):
    """-> (file-like at position 0, total length) of the complete framed
    response for ``plan``; fresh walks are spooled, published into the
    cache, and rewound. The caller owns (and must close) the handle."""
    from kart_tpu_torch.transport.http import write_framed

    if plan.data is not None:
        with tm.span("server.enum_replay"):
            return io.BytesIO(plan.data), len(plan.data)
    span = "server.enum_replay" if plan.cached else "server.enum_walk"
    buf = tempfile.SpooledTemporaryFile(max_size=64 * 1024 * 1024)
    try:
        with tm.span(span):
            write_framed(buf, plan.header, plan.source)
        length = buf.tell()
        plan.publish(buf, length)
    except BaseException:
        plan.abandon()
        buf.close()
        raise
    buf.seek(0)
    return buf, length


# ---------------------------------------------------------------------------
# the per-ref merge queue (docs/SERVING.md §6)
#
# K writers racing one branch used to convoy on the push lock: every CAS
# loser re-validated at a random position and could lose again, unbounded.
# The queue turns the race into an ordered line per ref — each writer waits
# its turn, rebases exactly once onto its predecessor's tip, and lands.
# Depth and wait are measured; overflow sheds into the 429 + Retry-After
# lane the client RetryPolicy already paces itself against.
# ---------------------------------------------------------------------------


class MergeQueueFull(Exception):
    """The per-ref line is at its depth bound — shed, don't queue."""


class MergeQueue:
    """FIFO ticket line per contended ref (one instance per served repo).

    ``slot(ref)`` is a context manager: entering takes the next ticket and
    blocks until every earlier ticket for the same ref released; the body
    runs the CAS/rebase/migrate sequence with no same-ref writer racing it
    in this process (cross-process safety stays with ``push_file_lock`` —
    the queue is the *ordering* layer, not the correctness layer). Yields
    the seconds spent waiting."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lines = {}  # ref -> {"cond", "next", "serving", "cancelled"}

    def _depth_locked(self):
        return sum(l["next"] - l["serving"] for l in self._lines.values())

    @contextmanager
    def slot(self, ref, *, depth_limit=None, timeout=MERGE_QUEUE_TIMEOUT):
        from kart_tpu_torch.transport.retry import _env_int

        if depth_limit is None:
            depth_limit = _env_int(
                "KART_SERVE_MERGE_QUEUE", DEFAULT_MERGE_QUEUE_DEPTH
            )
        with self._lock:
            line = self._lines.get(ref)
            if line is None:
                line = self._lines[ref] = {
                    "cond": threading.Condition(self._lock),
                    "next": 0,
                    "serving": 0,
                    "cancelled": set(),
                }
            queued = line["next"] - line["serving"]
            if depth_limit > 0 and queued >= depth_limit:
                tm.incr("server.merge_queue.shed")
                raise MergeQueueFull(
                    f"Merge queue for {ref} is full "
                    f"({queued} writers waiting); retry"
                )
            ticket = line["next"]
            line["next"] += 1
            tm.gauge_set("server.merge_queue.depth", self._depth_locked())
            t0 = time.monotonic()
            deadline = t0 + timeout
            waited = line["serving"] != ticket
            if waited:
                tm.incr("server.merge_queue.waits")
            while line["serving"] != ticket:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # a wedged predecessor must not wedge the whole line:
                    # cancel this ticket (release skips it) and shed
                    line["cancelled"].add(ticket)
                    tm.gauge_set(
                        "server.merge_queue.depth", self._depth_locked()
                    )
                    tm.incr("server.merge_queue.shed")
                    raise MergeQueueFull(
                        f"Merge queue for {ref} stalled for {timeout:.0f}s; retry"
                    )
                line["cond"].wait(min(remaining, 60.0))
            wait_s = time.monotonic() - t0
            if waited:
                tm.observe("server.merge_queue.wait_seconds", wait_s)
        try:
            yield wait_s
        finally:
            with self._lock:
                line["serving"] += 1
                while line["serving"] in line["cancelled"]:
                    line["cancelled"].discard(line["serving"])
                    line["serving"] += 1
                if line["serving"] >= line["next"]:
                    self._lines.pop(ref, None)
                else:
                    line["cond"].notify_all()
                tm.gauge_set("server.merge_queue.depth", self._depth_locked())


#: gitdir -> MergeQueue, mirroring _ENUM_CACHES' bounds. Eviction of a
#: still-waiting queue only de-links it from *new* pushes (waiters keep the
#: instance alive via their slot closure; push_file_lock keeps two queues
#: for one repo correct, merely unordered) — and only past 64 served repos.
_MERGE_QUEUES = OrderedDict()
_merge_queues_lock = threading.Lock()


def merge_queue_for(repo):
    key = os.path.realpath(repo.gitdir)
    with _merge_queues_lock:
        queue = _MERGE_QUEUES.get(key)
        if queue is None:
            queue = _MERGE_QUEUES[key] = MergeQueue()
        _MERGE_QUEUES.move_to_end(key)
        while len(_MERGE_QUEUES) > _ENUM_CACHES_MAX:
            _MERGE_QUEUES.popitem(last=False)
    return queue


# ---------------------------------------------------------------------------
# server-side rebase of a CAS-losing push (docs/SERVING.md §6)
# ---------------------------------------------------------------------------


class _QuarantineRepoView:
    """Just enough of the KartRepo surface for a server-side three-way
    merge: every object read and write routes through the quarantine's odb
    (live store wired in as an alternate), so the incoming — not yet
    migrated — commits are visible, and everything the rebase produces
    (merged trees, the merge commit) lands in the quarantine and migrates,
    or is discarded, together with the push itself."""

    def __init__(self, repo, odb):
        self._repo = repo
        self.odb = odb
        self.refs = repo.refs
        self.config = repo.config
        self.workdir = repo.workdir
        self.gitdir = repo.gitdir

    @property
    def version(self):
        return self._repo.version

    def signature(self, role="committer"):
        return self._repo.signature(role)

    # history helpers re-bound onto this view so revision resolution and
    # ancestry/merge-base walks read through the quarantine odb, not only
    # the live store
    resolve_refish = KartRepo.resolve_refish
    _resolve_plain = KartRepo._resolve_plain
    _peel_to_commit_oid = KartRepo._peel_to_commit_oid
    merge_base = KartRepo.merge_base
    _ancestor_set = KartRepo._ancestor_set
    is_ancestor = KartRepo.is_ancestor


def _rebaseable_update(header):
    """The single branch update a lost CAS may auto-rebase: exactly one
    update, non-force, creating/moving (not deleting) a ``refs/heads/``
    ref. Multi-ref transactions and force/delete updates keep the plain
    reject-on-stale behaviour — a human asked for something atomic or
    destructive; the server must not reinterpret it."""
    updates = header.get("updates", [])
    if len(updates) != 1:
        return None
    upd = updates[0]
    if upd.get("force") or not upd.get("new"):
        return None
    if not upd["ref"].startswith("refs/heads/"):
        return None
    return upd


#: clock-skew slack for the containment walk's commit-time pruning: a
#: commit this much older than the target may still (with skewed clocks)
#: have the target below it, so it is still descended
_CONTAINS_TIME_SLACK = 86_400


def _commit_contains(view, tip_oid, target_oid):
    """Is ``target_oid`` an ancestor of (or equal to) ``tip_oid``? A DFS
    from the tip that stops at the target and prunes commits meaningfully
    older than it — O(commits since the target) on real pushes, never the
    O(entire history) ancestor-set walk. Pruning errs safe: a skew-induced
    false negative merely sends the push through the rebase path, whose
    own ff/noop detection lands it identically."""
    if tip_oid == target_oid:
        return True
    try:
        target_time = view.odb.read_commit(target_oid).committer.time
    except (ObjectMissing, KeyError, ValueError):
        return False
    floor = target_time - _CONTAINS_TIME_SLACK
    seen = set()
    stack = [tip_oid]
    while stack:
        oid = stack.pop()
        if oid == target_oid:
            return True
        if oid in seen:
            continue
        seen.add(oid)
        try:
            commit = view.odb.read_commit(oid)
        except (ObjectMissing, KeyError, ValueError):
            continue  # shallow/partial boundary
        if commit.committer.time >= floor:
            stack.extend(commit.parents)
    return False


def _ff_precheck(view, repo, header):
    """-> ``({ref: observed tip}, first non-ff update or None)``.

    The server-side half of the fast-forward rule the client used to
    enforce alone: the CAS cannot see divergence that predates the
    advertisement the client pushed against (old matches, yet the incoming
    commit doesn't contain the tip). The ancestry walks run OUTSIDE the
    push locks — the caller re-verifies every observed tip under the locks
    and loops if one moved meanwhile."""
    observed = {}
    stale = None
    for upd in header.get("updates", []):
        new = upd.get("new")
        if not new or upd.get("force") or not upd["ref"].startswith("refs/heads/"):
            continue
        current = repo.refs.get(upd["ref"])
        observed[upd["ref"]] = current
        if (
            stale is None
            and current is not None
            and current != new
            and not _commit_contains(view, new, current)
        ):
            stale = upd
    return observed, stale


def _rebase_onto(repo, q, upd, current_tip, device=None):
    """Three-way merge of the incoming commit against the tip that beat it,
    computed entirely inside the quarantine.

    -> ``("ff"|"noop"|"merge", oid)`` — the oid the contended ref should
    land at; ``("conflict", report)`` — real conflicts, with the structured
    report document; ``None`` — not auto-mergeable (unrelated histories).

    Every frame is an injectable crash (``KART_FAULTS=server.rebase:<n>``):
    1 = the ancestry/classifier run, 2 = the merge-commit write, 3 = the
    quarantine-side temp-ref write. A kill at any of them propagates out,
    the quarantine is discarded, and the live store stays byte-identical
    (tests/test_faults.py kill matrix). The classifier is K4 on ``device``
    (None: the card)."""
    from kart_tpu_torch.core.objects import Commit
    from kart_tpu_torch.core.structure import RepoStructure
    from kart_tpu_torch.merge import merge_trees_vectorized

    ref, incoming = upd["ref"], upd["new"]
    view = _QuarantineRepoView(repo, q.odb)
    faults.fire("server.rebase")  # frame 1: ancestry + classifier run
    if current_tip is None:
        # the contended branch vanished between CAS checks: recreate it at
        # the incoming commit — a plain fast-forward of the create case
        return "ff", incoming
    # EXACT ancestry here, not the time-pruned precheck walk: this is the
    # backstop that turns a precheck false negative (clock skew) back into
    # the identical ff/noop landing instead of a spurious merge commit
    if view.is_ancestor(current_tip, incoming):
        return "ff", incoming  # incoming already contains the tip
    if view.is_ancestor(incoming, current_tip):
        return "noop", current_tip  # nothing new to land
    ancestor = view.merge_base(current_tip, incoming)
    if ancestor is None:
        return None  # unrelated histories: humans decide
    with tm.span("server.rebase", ref=ref):
        merged_tree, conflicts, stats = merge_trees_vectorized(
            view,
            RepoStructure(view, ancestor),
            # ours = the incoming commit, theirs = the tip that beat it:
            # the exact orientation the losing client would get from a
            # local `kart merge <tip>`, so the conflict report below is
            # byte-identical to that dry run (one source of truth —
            # tests/test_merge_service.py parity test)
            RepoStructure(view, incoming),
            RepoStructure(view, current_tip),
            device=device,
        )
    if conflicts:
        from kart_tpu_torch.cli.merge_cmds import merge_conflict_report

        tm.incr("server.rebase.conflicts")
        return "conflict", {
            "ref": ref,
            "ancestor": ancestor,
            "ours": incoming,
            "theirs": current_tip,
            "conflicts_total": len(conflicts),
            # the exact `kart merge <theirs> --dry-run -o json` document
            "merge": merge_conflict_report(conflicts),
        }
    faults.fire("server.rebase")  # frame 2: the merge-commit write
    sig = view.signature()
    short = ref[len("refs/heads/"):] if ref.startswith("refs/heads/") else ref
    commit = Commit(
        tree=merged_tree,
        parents=(current_tip, incoming),
        author=sig,
        committer=sig,
        message=(
            f"Merge {incoming[:8]} into {short} "
            f"(server-side rebase onto {current_tip[:8]})\n"
        ),
    )
    merged_oid = q.odb.write_commit(commit)
    faults.fire("server.rebase")  # frame 3: quarantine temp-ref write
    q.write_temp_ref(ref, merged_oid)
    return "merge", merged_oid


def current_branch_ref(repo):
    kind, target = repo.refs.head_target()
    return target if kind == "symbolic" else None


@contextmanager
def push_file_lock(repo):
    """Cross-process push lock over the gitdir: every ssh push spawns its
    own serve-stdio process, so an in-process lock can't serialise the
    compare-and-swap (two concurrent pushes would both pass the CAS check
    and one would be silently lost). The HTTP server holds its thread lock
    too, so mixed http+ssh pushes against one repo stay safe."""
    lock_path = os.path.join(repo.gitdir, ".push-lock")
    with open(lock_path, "w") as lock:
        try:
            import fcntl

            fcntl.flock(lock, fcntl.LOCK_EX)
        except ImportError:  # non-POSIX: best effort
            pass
        yield


def locked_ref_updates(repo, header):
    """apply_ref_updates under the cross-process push lock (back-compat
    entry point for callers that drained objects into the live store
    themselves; the servers use :func:`quarantined_receive`)."""
    with push_file_lock(repo):
        return apply_ref_updates(repo, header)


class ReceiveQuarantine:
    """A temporary objects dir under ``<gitdir>/objects/quarantine/``
    holding a pushed pack until it earns its way into the live store (the
    analog of git's receive-pack ``tmp_objdir``). The main store is wired
    in as an alternate, so connectivity/containment checks see quarantined
    + live objects together while the live store stays untouched."""

    def __init__(self, repo):
        from kart_tpu_torch.core.odb import ObjectDb

        self.repo = repo
        base = os.path.join(repo.gitdir, "objects", QUARANTINE_SUBDIR)
        os.makedirs(base, exist_ok=True)
        self.dir = tempfile.mkdtemp(prefix="incoming-", dir=base)
        self.odb = ObjectDb(self.dir)
        self.odb.add_alternate(os.path.join(repo.gitdir, "objects"))

    def discard(self):
        """Drop everything received — the live store is byte-identical to
        before the push started."""
        shutil.rmtree(self.dir, ignore_errors=True)

    def write_temp_ref(self, ref, oid):
        """Record an in-flight server-side rebase result on a quarantine-
        side temp ref (``<quarantine>/refs/<mangled-name>``): visible to
        crash forensics, swept with the quarantine, never under the live
        ``refs/`` tree — so a rejected or crashed rebase leaves zero ref
        debris for gc to misread."""
        refs_dir = os.path.join(self.dir, "refs")
        os.makedirs(refs_dir, exist_ok=True)
        with open(os.path.join(refs_dir, ref.replace("/", "+")), "w") as f:
            f.write(oid + "\n")

    def migrate(self):
        """Move the quarantined pack(s) (and any loose strays) into the live
        store. Only called after the pack checksum and every ref-update
        precondition passed. Same-filesystem renames; ``.pack`` moves before
        its ``.idx`` so a concurrent reader never sees an idx without its
        pack."""
        objects_dir = self.repo.odb.objects_dir
        qpack = os.path.join(self.dir, "pack")
        if os.path.isdir(qpack):
            dst_pack = os.path.join(objects_dir, "pack")
            os.makedirs(dst_pack, exist_ok=True)
            names = sorted(
                os.listdir(qpack), key=lambda n: (n.endswith(".idx"), n)
            )
            for name in names:
                if name.startswith("."):
                    continue  # writer temp files never migrate
                os.replace(
                    os.path.join(qpack, name), os.path.join(dst_pack, name)
                )
        for prefix in os.listdir(self.dir):
            if len(prefix) != 2:
                continue
            src_d = os.path.join(self.dir, prefix)
            dst_d = os.path.join(objects_dir, prefix)
            os.makedirs(dst_d, exist_ok=True)
            for name in os.listdir(src_d):
                os.replace(
                    os.path.join(src_d, name), os.path.join(dst_d, name)
                )
        self.repo.odb.packs.refresh()
        self.discard()


def quarantined_receive(repo, header, pack_fp, *, thread_lock=None, device=None):
    """The full receive-pack verb: drain the pushed pack into quarantine,
    validate the ref updates, migrate, apply — and, when the CAS was lost
    to a contending writer, auto-rebase the incoming commit onto the new
    tip before re-validating (docs/SERVING.md §6). A torn pack, a checksum
    mismatch, any rejected precondition, or a crash at any rebase frame
    leaves the live store byte-identical (the quarantine is discarded);
    objects reach the live store only in the success path, under the push
    locks.

    -> ``("ok", {"updated": {ref: oid|None}, "rebase": {...}})`` |
    ``(kind, rejection)`` where ``rejection`` is a
    :class:`~kart_tpu_torch.transport.protocol.Rejection` (tuple-compatible with
    the old ``(kind, msg)``; ``kind`` gains ``"busy"`` for the paced-retry
    lane). Transfer-level failures (torn/corrupt pack) raise instead, so
    each server reports them the same way as any other I/O failure."""
    from kart_tpu_torch.transport.pack import read_pack

    tm.incr("transport.server.requests", verb="receive-pack")
    q = ReceiveQuarantine(repo)
    try:
        with tm.span("transport.receive_drain"), q.odb.bulk_pack():
            for obj_type, content in read_pack(pack_fp):
                q.odb.write_raw(obj_type, content)
    except BaseException:
        tm.incr("transport.server.receive_outcomes", outcome="torn")
        q.discard()
        raise
    try:
        return _land_quarantined(repo, q, header, thread_lock, device)
    except BaseException:
        q.discard()  # no-op after a successful migrate
        raise


def _land_quarantined(repo, q, header, thread_lock, device=None):
    """Validate + (rebase-as-needed) + migrate + apply a drained quarantine.

    The CAS re-validation loop is bounded by ``KART_SERVE_REBASE_ATTEMPTS``
    and — for the single-branch-update pushes that can rebase — ordered
    through the per-ref merge queue, so K contending writers form a line
    and each rebases exactly once onto its predecessor's tip."""
    from kart_tpu_torch.transport.retry import _env_int

    upd = _rebaseable_update(header)
    attempts_cap = max(
        1, _env_int("KART_SERVE_REBASE_ATTEMPTS", DEFAULT_REBASE_ATTEMPTS)
    )
    retry_after = max(0, _env_int("KART_SERVE_RETRY_AFTER", 1))
    info = {"rebased": 0, "cas_attempts": 0, "queue_wait_seconds": 0.0}

    def reject(rejection):
        tm.incr("transport.server.receive_outcomes", outcome=rejection[0])
        tm.annotate(
            rejected=getattr(rejection, "code", None) or rejection[0],
            ref=getattr(rejection, "ref", None),
        )
        q.discard()
        return rejection

    try:
        slot = (
            merge_queue_for(repo).slot(upd["ref"])
            if upd is not None
            else nullcontext(0.0)
        )
        with slot as waited:
            info["queue_wait_seconds"] = round(waited or 0.0, 6)
            if upd is not None:
                tm.annotate(
                    ref=upd["ref"],
                    queue_wait_seconds=info["queue_wait_seconds"] or None,
                )
            view = _QuarantineRepoView(repo, q.odb)
            for attempt in range(1, attempts_cap + 1):
                info["cas_attempts"] = attempt
                # the (potentially deep) fast-forward ancestry walk runs
                # before the locks; the observed tips are re-verified under
                # them, and movement in between just restarts the loop
                observed, stale = _ff_precheck(view, repo, header)
                with (thread_lock if thread_lock is not None else nullcontext()):
                    with push_file_lock(repo):
                        # injectable frame 1: the CAS (re-)check under both
                        # push locks
                        faults.fire("server.ref_cas")
                        rejection = validate_ref_updates(
                            repo, header, contains=q.odb.contains
                        )
                        if rejection is None:
                            for ref, tip in observed.items():
                                if repo.refs.get(ref) != tip:
                                    # a writer landed between the precheck
                                    # and the locks: the ff verdict is
                                    # stale, go around again
                                    rejection = Rejection(
                                        "conflict",
                                        f"Ref {ref} moved during validation",
                                        code="cas_stale",
                                        ref=ref,
                                    )
                                    break
                        if rejection is None and stale is not None:
                            # old matched but history diverged before the
                            # advertisement: same contended-write situation
                            # as a lost CAS
                            rejection = Rejection(
                                "conflict",
                                f"Ref {stale['ref']} update is not a "
                                f"fast-forward; fetch first or use --force",
                                code="cas_stale" if stale is upd else "non_ff",
                                ref=stale["ref"],
                                terminal=stale is not upd,
                            )
                        if rejection is None:
                            # injectable frame 2: quarantine migrate into
                            # the live store
                            faults.fire("server.ref_cas")
                            q.migrate()
                            tm.incr(
                                "transport.server.receive_outcomes",
                                outcome="ok",
                            )
                            if info["rebased"]:
                                tm.incr("server.rebase.landed")
                                tm.annotate(
                                    rebased=True,
                                    rebase_mode=info.get("mode"),
                                )
                            updated = _apply_validated_updates(repo, header)
                            # kart_tpu adds the booked live-update sequence
                            # here when an event emitter runs; the port has
                            # none (the events feed is not ported)
                            return "ok", {"updated": updated, "rebase": info}
                        current = (
                            repo.refs.get(upd["ref"]) if upd is not None else None
                        )
                if upd is None or getattr(rejection, "code", None) != "cas_stale":
                    return reject(rejection)
                if attempt >= attempts_cap:
                    break
                # CAS lost to a contending writer: rebase outside the locks
                # (the classifier run must not extend the critical section)
                tm.incr("server.rebase.attempts")
                outcome = _rebase_onto(repo, q, upd, current, device)
                if outcome is None:
                    return reject(
                        Rejection(
                            "conflict",
                            f"Push to {upd['ref']} rejected (non-fast-forward: "
                            f"no common ancestor with the current tip); fetch "
                            f"first or use --force",
                            code="non_ff",
                            ref=upd["ref"],
                            terminal=True,
                        )
                    )
                kind, value = outcome
                if kind == "conflict":
                    return reject(
                        Rejection(
                            "conflict",
                            f"Push to {upd['ref']} rejected: merging the "
                            f"incoming commit with the current tip conflicts "
                            f"({value['conflicts_total']} conflicts); pull and "
                            f"resolve locally, then push the merge",
                            code="merge_conflict",
                            ref=upd["ref"],
                            conflict_report=value,
                            terminal=True,
                        )
                    )
                info["rebased"] = 1
                info["mode"] = kind  # "merge" | "ff" | "noop"
                upd["old"], upd["new"] = current, value
            tm.incr("server.rebase.exhausted")
            return reject(
                Rejection(
                    "busy",
                    f"Ref {upd['ref']} kept moving through {attempts_cap} CAS "
                    f"attempts; retry shortly",
                    code="cas_busy",
                    ref=upd["ref"],
                    retry_after=retry_after,
                    shed=True,
                )
            )
    except MergeQueueFull as e:
        return reject(
            Rejection(
                "busy",
                str(e),
                code="queue_full",
                retry_after=retry_after,
                shed=True,
            )
        )


def _df_collision(repo, ref):
    """A ref name colliding with an existing ref at a directory/file
    boundary (``refs/heads/a`` vs ``refs/heads/a/b``) can never be created
    — the loose-ref store would need ``a`` to be both a file and a
    directory, and ``refs.set`` would die half-way with debris. A
    server-constructed rebased ref must trip this cleanly, not crash.
    -> message, or None. O(path depth), not O(refs): this runs under the
    push locks."""
    existing = repo.refs.df_conflict(ref)
    if existing is not None:
        return (
            f"Ref {ref} conflicts with existing ref {existing} "
            f"(directory/file collision); delete it first"
        )
    return None


def validate_ref_updates(repo, header, *, contains=None):
    """Check every precondition of a receive-pack's ref updates without
    moving anything: refname hygiene (including names shaped like crash
    debris and directory/file collisions with existing refs),
    checked-out-branch protection, CAS against the current tips, and
    object connectivity via ``contains`` (a quarantine's combined
    live+incoming check during a push).

    -> None when everything passes, else a
    :class:`~kart_tpu_torch.transport.protocol.Rejection` — tuple-compatible
    ``("conflict"|"bad", msg)`` carrying a machine-readable ``code`` the
    rebase loop keys on (only ``cas_stale`` is recoverable)."""
    contains = contains or repo.odb.contains
    deny_current = (
        repo.workdir is not None
        and (repo.config.get("receive.denyCurrentBranch") or "refuse").lower()
        not in ("ignore", "false")
    )

    for upd in header.get("updates", []):
        ref, old, new = upd["ref"], upd.get("old"), upd.get("new")
        # wire-supplied names must be real refs — git's receive-pack rejects
        # non-refs/ names via check_refname_format; without this a push with
        # ref='config' or 'HEAD' would overwrite arbitrary gitdir files.
        try:
            check_ref_format(ref, require_refs_prefix=True)
        except RefError as e:
            return Rejection("bad", str(e), code="bad_ref", ref=ref,
                             terminal=True)
        if deny_current and ref == current_branch_ref(repo):
            return Rejection(
                "conflict",
                f"Refusing to update checked-out branch {ref} (the server's "
                f"working copy would go out of sync). Serve a bare repo, or "
                f"set receive.denyCurrentBranch=ignore there.",
                code="denied",
                ref=ref,
                terminal=True,
            )
        if new is not None:
            collision = _df_collision(repo, ref)
            if collision is not None:
                return Rejection(
                    "conflict", collision, code="df_conflict", ref=ref,
                    terminal=True,
                )
        current = repo.refs.get(ref)
        if not upd.get("force") and current != old:
            return Rejection(
                "conflict",
                f"Ref {ref} moved (expected {old}, is {current}); "
                f"fetch first or use --force",
                code="cas_stale",
                ref=ref,
            )
        if new is not None and not contains(new):
            return Rejection(
                "bad", f"Push incomplete: {new} not received",
                code="incomplete", ref=ref,
            )
    return None


def _apply_validated_updates(repo, header):
    """Apply pre-validated ref updates; -> {ref: oid|None}."""
    import sys

    from kart_tpu_torch.transport.remote import _update_shallow

    updated = {}
    for upd in header.get("updates", []):
        ref, new = upd["ref"], upd.get("new")
        prev = repo.refs.get(ref)
        if new is None:
            if prev is not None:
                repo.refs.delete(ref)
            updated[ref] = None
        else:
            repo.refs.set(ref, new, log_message="push")
            updated[ref] = new
    if header.get("shallow"):
        _update_shallow(repo, header["shallow"])
    # a ref moved: enumeration keys embed the ref fingerprint so new
    # requests re-key anyway, but drop the stale entries now rather than
    # letting them squat in the LRU until evicted
    with _enum_caches_lock:
        cache = _ENUM_CACHES.get(os.path.realpath(repo.gitdir))
    if cache is not None:
        cache.invalidate()
    # kart_tpu books a live-update event for ``changes`` here when an
    # event emitter is active; the port has no emitter (the events feed is
    # not ported), which is kart_tpu's case when nobody subscribed, so
    # nothing is booked. Tile-cache keys are commit-pinned and never go
    # stale, but the tiles of a commit a ref just left are probably dead
    # weight: release their budget now. sys.modules guard: a process that
    # never imported the tile machinery holds no tile caches.
    tiles_cache = sys.modules.get("kart_tpu_torch.tiles.cache")
    if tiles_cache is not None:
        tiles_cache.invalidate_tile_caches(repo.gitdir)
    # query-result keys are commit-pinned too: same reasoning, same drop
    # (no warm-then-announce exemption — there is no query warmer)
    query_cache = sys.modules.get("kart_tpu_torch.query.cache")
    if query_cache is not None:
        query_cache.invalidate_query_caches(repo.gitdir)
    return updated


def apply_ref_updates(repo, header):
    """CAS-validate then apply a receive-pack's ref updates (the pack must
    already be drained into the odb). All updates are validated before any
    is applied, so a rejected request leaves no ref moved. The caller holds
    whatever lock serialises concurrent pushes.

    -> ("ok", {ref: oid|None}) | ("conflict", msg) | ("bad", msg)."""
    rejection = validate_ref_updates(repo, header)
    if rejection is not None:
        return rejection
    return "ok", _apply_validated_updates(repo, header)
