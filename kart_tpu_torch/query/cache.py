"""The commit-addressed query result cache (docs/QUERY.md §5).

Byte-budgeted LRU of complete query result documents (the JSON bytes the
HTTP lane sends) with single-flight fill — one instance per served repo,
same machinery as the tile cache. The key hashes the commit oid(s)
plus the *normalized* request (predicate, bbox, output form, page, part),
so a key can never go stale: a ref update changes which key new requests
compute, never what an existing key means. The strong ETag is derived
from the key alone — any holder of bytes with a matching validator holds
*the* bytes.

A fill crash (including an armed ``query.scan`` / ``query.join`` fault)
publishes nothing — the kill-matrix tests prove a poisoned result is
never served and the retried query is byte-identical.

Counterpart of kart_tpu's ``query/cache.py``: the same keys and ETags.
"""

import hashlib
import os
import threading
from collections import OrderedDict

from kart_tpu_torch import telemetry as tm
from kart_tpu_torch.core.singleflight import SingleFlightLRU
from kart_tpu_torch.query import _bump

#: result-document format version — part of every key: a payload change
#: MUST change every key, or clients would revalidate old-format bytes
#: into keeping them forever (same rule as the tile lane).
#: v2: exact-refine semantics — documents carry ``exact`` and
#: refine stats, and default spatial verdicts changed from envelope-only
#: to exact, so v1 bytes must never revalidate.
QUERY_PAYLOAD_VERSION = 2

#: default byte budget (``KART_QUERY_CACHE`` overrides; 0 disables)
DEFAULT_QUERY_CACHE_BYTES = 64 * 1024 * 1024


def query_request_key(commit_oid, ds_path, *, where=None, bbox=None,
                      commit_oid2=None, ds_path2=None, output="count",
                      count_by=None, page=None, page_size=None, part=None,
                      approx=False):
    """The cache key / strong validator digest of one query request: a
    sha256 over the format version, the pinned commit oid(s) and the
    normalized request — every field that changes the result bytes is in
    the digest, nothing else is. ``approx`` must be the *effective* mode
    (request flag OR ``KART_GEOM_REFINE=0``): exact and envelope-only
    answers are different bytes and must never share a validator."""
    payload = "\0".join(
        (
            f"v{QUERY_PAYLOAD_VERSION}",
            commit_oid,
            ds_path,
            where or "",
            bbox or "",
            commit_oid2 or "",
            ds_path2 or "",
            output,
            count_by or "",
            str(page if page is not None else ""),
            str(page_size if page_size is not None else ""),
            part or "",
            "approx" if approx else "",
        )
    )
    return hashlib.sha256(payload.encode()).hexdigest()


def etag_for(key):
    """Strong validator: same key ⇒ byte-identical result document."""
    return f'"{key[:32]}"'


class QueryCache(SingleFlightLRU):
    """LRU-by-byte-budget memo of query result bytes with single-flight
    fill (one instance per served repo): N concurrent cold requests for
    one query run ONE scan/join; entries are the complete JSON documents,
    charged at their length."""

    #: scans/joins are seconds-scale, not multi-minute pack walks — a
    #: wedged filler should release its waiters on that scale
    SINGLEFLIGHT_TIMEOUT = 120.0

    def count(self, event, n=1):
        if event == "hits":
            tm.incr("query.cache.hits", n)
            _bump("cache_hits", n)
        elif event == "misses":
            tm.incr("query.cache.misses", n)
            _bump("cache_misses", n)
        elif event == "singleflight_waits":
            tm.incr("query.cache.singleflight_waits", n)
        elif event == "evictions":
            tm.incr("query.cache.evictions", n)

    def gauge(self, total):
        tm.gauge_set("query.cache.bytes", total)


#: gitdir -> QueryCache for every repo this process serves (bounded, like
#: the enum and tile cache registries)
_QUERY_CACHES = OrderedDict()
_QUERY_CACHES_MAX = 64
_query_caches_lock = threading.Lock()


def query_cache_for(repo):
    """The process-wide query result cache serving ``repo``, or None when
    disabled via ``KART_QUERY_CACHE=0``."""
    from kart_tpu_torch.transport.retry import _env_int

    budget = _env_int("KART_QUERY_CACHE", DEFAULT_QUERY_CACHE_BYTES)
    if budget <= 0:
        return None
    key = os.path.realpath(repo.gitdir)
    with _query_caches_lock:
        cache = _QUERY_CACHES.get(key)
        if cache is None or cache.budget != budget:
            cache = _QUERY_CACHES[key] = QueryCache(budget)
        _QUERY_CACHES.move_to_end(key)
        while len(_QUERY_CACHES) > _QUERY_CACHES_MAX:
            _QUERY_CACHES.popitem(last=False)
    return cache


def query_filled(cache, key, compute):
    """The single-flight fill shape of the query lane: memo hit, else one
    caller runs ``compute()`` (the scan/join + JSON encode) and publishes
    its bytes; a crash — including an armed ``query.scan``/``query.join``
    fault — abandons the token so nothing is ever published from a failed
    fill. ``cache`` may be None (disabled): compute uncached."""
    if cache is None:
        return compute()
    mode, got = cache.lookup_or_begin(key)
    if mode == "hit":
        return got
    token = got  # a FillToken, or None (wedged-filler bypass)
    try:
        payload = compute()
    except BaseException:
        if token is not None:
            token.abandon()
        raise
    if token is not None:
        token.publish(payload)
    return payload


def invalidate_query_caches(gitdir):
    """The explicit ref-update drop hook (called from
    ``transport.service._apply_validated_updates`` next to the enum/tile
    cache drops): keys are commit-pinned so nothing can go *stale*, but
    results for a commit a ref just moved away from are likely dead
    weight — release the budget now instead of waiting for LRU
    pressure."""
    with _query_caches_lock:
        cache = _QUERY_CACHES.get(os.path.realpath(gitdir))
    if cache is not None:
        cache.invalidate()
