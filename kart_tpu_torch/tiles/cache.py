"""The commit-addressed tile cache (docs/TILES.md §3).

Byte-budgeted LRU of complete tile payloads with single-flight fill,
modelled on the pack-enumeration cache
(:class:`kart_tpu_torch.transport.service.PackEnumCache`) — one instance per
served repo, keyed by

    (commit oid, dataset, z/x/y, layers, extent, buffer)

The commit oid is resolved from the requested ref *at request time*, so a
key can never go stale: a ref update changes which key new requests
compute, never what an existing key means — invalidation by construction.
The explicit :func:`invalidate_tile_caches` drop hook (called next to the
``apply_ref_updates``) exists purely to release memory early: after a
ref moves (especially a force-push) the old commit's tiles may never be
requested again, and squatting in the LRU until natural eviction is wasted
budget, not a correctness hazard.

A fill crash publishes nothing (the ``tiles.cache`` fault point arms the
publish frame; tests/test_faults.py proves a poisoned tile is never
served), and a wedged filler stops gating waiters after a timeout.

Counterpart of kart_tpu's ``tiles/cache.py``: the same keys and ETags.
"""

import hashlib
import os
import threading
from collections import OrderedDict

from kart_tpu_torch import faults
from kart_tpu_torch import telemetry as tm
from kart_tpu_torch.core.singleflight import SingleFlightLRU

#: default byte budget (``KART_TILE_CACHE`` overrides; 0 disables)
DEFAULT_TILE_CACHE_BYTES = 128 * 1024 * 1024


def tile_key(commit_oid, ds_path, z, x, y, layers, extent, buffer):
    """The cache key / strong validator digest for one tile request. The
    payload format version is part of the key: the HTTP layer marks
    payloads immutable and answers 304 from this digest alone, so a future
    encoder change MUST change every key — otherwise clients holding
    old-format bytes would revalidate into keeping them forever. The
    ``geom`` layer's simplification tolerance folds in the same way —
    it changes payload bytes, so two servers tuned differently via
    ``KART_GEOM_SIMPLIFY`` must never share a validator (keys without
    the geom layer ignore it: their bytes don't depend on it)."""
    from kart_tpu_torch.tiles.clip import simplify_tolerance
    from kart_tpu_torch.tiles.encode import PAYLOAD_VERSION

    payload = "\0".join(
        (
            f"v{PAYLOAD_VERSION}",
            commit_oid,
            ds_path,
            f"{z}/{x}/{y}",
            ",".join(layers),
            str(extent),
            str(buffer),
            repr(simplify_tolerance()) if "geom" in layers else "",
        )
    )
    return hashlib.sha256(payload.encode()).hexdigest()


def etag_for(key, raw=False):
    """Strong validator: same key ⇒ byte-identical payload (the key pins
    the commit, so it never needs revalidation). ``raw`` marks the
    *unframed* representation (a bare MVT body negotiated via ``Accept``
    / ``?format=mvt`` — docs/TILES.md §5): different bytes on the wire
    must mean a different strong validator, even though both derive from
    one cache key."""
    return f'"{key[:32]}-raw"' if raw else f'"{key[:32]}"'


class TileCache(SingleFlightLRU):
    """LRU-by-byte-budget memo of tile payload bytes with single-flight
    fill (one instance per served repo). The concurrency machinery is the
    shared :class:`~kart_tpu_torch.core.singleflight.SingleFlightLRU` (the
    pack-enumeration cache runs the same core); entries here are the
    complete payload byte strings, charged at their length.

    Concurrent requests for one cold tile run ONE encode (the second
    blocks on the first's fill and hits); a wedged filler stops gating
    after ``SINGLEFLIGHT_TIMEOUT`` (waiters encode uncached)."""

    #: tiles are seconds-scale encodes, not multi-minute pack walks — a
    #: wedged filler should release its waiters much sooner
    SINGLEFLIGHT_TIMEOUT = 120.0

    def publish_fault(self):
        # the injectable failure of the cache-publish frame: a fault here
        # must poison nothing — the entry is never inserted
        faults.fire("tiles.cache")

    def count(self, event, n=1):
        if event == "hits":
            tm.incr("tiles.cache.hits", n)
        elif event == "misses":
            tm.incr("tiles.cache.misses", n)
        elif event == "singleflight_waits":
            tm.incr("tiles.cache.singleflight_waits", n)
        elif event == "evictions":
            tm.incr("tiles.cache.evictions", n)

    def gauge(self, total):
        tm.gauge_set("tiles.cache.bytes", total)


#: gitdir -> TileCache for every repo this process serves (bounded, like
#: the enum-cache registry)
_TILE_CACHES = OrderedDict()
_TILE_CACHES_MAX = 64
_tile_caches_lock = threading.Lock()


def tile_cache_for(repo):
    """The process-wide tile cache serving ``repo``, or None when disabled
    via ``KART_TILE_CACHE=0``."""
    from kart_tpu_torch.transport.retry import _env_int

    budget = _env_int("KART_TILE_CACHE", DEFAULT_TILE_CACHE_BYTES)
    if budget <= 0:
        return None
    key = os.path.realpath(repo.gitdir)
    with _tile_caches_lock:
        cache = _TILE_CACHES.get(key)
        if cache is None or cache.budget != budget:
            cache = _TILE_CACHES[key] = TileCache(budget)
        _TILE_CACHES.move_to_end(key)
        while len(_TILE_CACHES) > _TILE_CACHES_MAX:
            _TILE_CACHES.popitem(last=False)
    return cache


def invalidate_tile_caches(gitdir):
    """The explicit ref-update drop hook (called from
    ``transport.service._apply_validated_updates`` next to the enum-cache
    drop): keys are commit-pinned so nothing can go *stale*, but tiles of
    a commit a ref just moved away from are likely dead weight — release
    the budget now instead of waiting for LRU pressure."""
    with _tile_caches_lock:
        cache = _TILE_CACHES.get(os.path.realpath(gitdir))
    if cache is not None:
        cache.invalidate()
