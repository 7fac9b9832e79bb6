"""Single-flight byte-budgeted LRU memo — the shared concurrency core
behind the pack-enumeration cache (docs/SERVING.md §2) and the tile cache
(docs/TILES.md §3).

The contract both serving caches rely on, implemented once:

* **lookup_or_begin(key)** returns a ``("hit", entry)``, or hands exactly
  one caller a :class:`FillToken` (the right to build + publish that key)
  while concurrent callers for the same key block on it — a publish turns
  them into hits, an abandon sends them for their own token. A filler
  wedged past the timeout stops gating: waiters proceed with their own
  uncached build (token ``None`` — nothing to publish).
* **publish is the poison barrier**: the subclass's ``publish_fault()``
  (a :func:`kart_tpu_torch.faults.fire` point) is armed *before* the entry is
  inserted, so an injected crash at the publish frame inserts nothing —
  a poisoned entry is never served (kill-matrix tested for both caches).
* **LRU by byte budget**: entries are charged by ``entry_nbytes`` and the
  least-recently-used evict past ``budget`` (always keeping at least the
  newest entry).

Subclasses provide the telemetry with *literal* metric names (the KTL002
grammar rule requires literal ``subsystem.`` prefixes at the call sites)
via ``count(event, n)`` / ``gauge(total)``.

Counterpart of kart_tpu's ``core/singleflight.py``.
"""

import threading
import time
from collections import OrderedDict


class FillToken:
    """The right to publish one cache entry: handed to the single caller
    that runs the build for a key; every other caller for that key waits
    on ``event`` until publish/abandon."""

    __slots__ = ("cache", "key", "event")

    def __init__(self, cache, key, event):
        self.cache = cache
        self.key = key
        self.event = event

    def publish(self, entry):
        self.cache._publish(self, entry)

    def abandon(self):
        self.cache._abandon(self)


class SingleFlightLRU:
    """LRU-by-byte-budget memo with single-flight fill.

    Subclass surface: :attr:`SINGLEFLIGHT_TIMEOUT`, :meth:`count`,
    :meth:`gauge`, :meth:`publish_fault`, :meth:`entry_nbytes`."""

    #: how long a caller waits on another caller's in-flight build of the
    #: same key before giving up and building independently (a wedged
    #: filler must not wedge every request behind it)
    SINGLEFLIGHT_TIMEOUT = 600.0

    def __init__(self, budget_bytes):
        self.budget = budget_bytes
        self._lock = threading.Lock()
        self._entries = OrderedDict()  # key -> entry
        self._inflight = {}            # key -> threading.Event
        self._total = 0

    # -- subclass surface ---------------------------------------------------

    def count(self, event, n=1):
        """Telemetry counter hook; ``event`` is one of ``hits`` /
        ``misses`` / ``singleflight_waits`` / ``evictions``."""

    def gauge(self, total):
        """Telemetry gauge hook for the cache's resident byte total."""

    def publish_fault(self):
        """The injectable publish frame: raise here and the entry is never
        inserted (override with a faults.fire point)."""

    def entry_nbytes(self, entry):
        return len(entry)

    # -- lookup / single-flight --------------------------------------------

    def peek(self, key):
        """A plain hit-or-None read: counts/refreshes the hit like
        ``lookup_or_begin`` but never takes a fill token, so concurrent
        hot-key readers stay a lock-hold apart instead of serialising
        through token hand-offs. Misses count nothing — the caller is
        expected to follow up with ``lookup_or_begin`` (which books the
        miss) or not to fill at all."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.count("hits")
            return entry

    def lookup_or_begin(self, key, timeout=None):
        """-> ("hit", entry) | ("fill", FillToken) | ("fill", None)."""
        if timeout is None:
            timeout = self.SINGLEFLIGHT_TIMEOUT
        deadline = time.monotonic() + timeout
        waited = False
        while True:
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    self.count("hits")
                    return "hit", entry
                event = self._inflight.get(key)
                if event is None:
                    self._inflight[key] = event = threading.Event()
                    self.count("misses")
                    return "fill", FillToken(self, key, event)
            if not waited:
                waited = True
                self.count("singleflight_waits")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self.count("misses")
                return "fill", None
            event.wait(min(remaining, 60.0))

    # -- fill side ----------------------------------------------------------

    def _publish(self, token, entry):
        try:
            self.publish_fault()
        except BaseException:
            self._abandon(token)
            raise
        nbytes = self.entry_nbytes(entry)
        with self._lock:
            self._inflight.pop(token.key, None)
            self._entries[token.key] = entry
            self._entries.move_to_end(token.key)
            self._total += nbytes
            while self._total > self.budget and len(self._entries) > 1:
                _, evicted = self._entries.popitem(last=False)
                self._total -= self.entry_nbytes(evicted)
                self.count("evictions")
            self.gauge(self._total)
        token.event.set()

    def _abandon(self, token):
        with self._lock:
            self._inflight.pop(token.key, None)
        token.event.set()

    # -- invalidation -------------------------------------------------------

    def evict(self, key):
        """Drop one entry (poisoned-entry hygiene)."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._total -= self.entry_nbytes(entry)
                self.count("evictions")
                self.gauge(self._total)

    def invalidate(self):
        """Drop everything."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._total = 0
            if n:
                self.count("evictions", n)
            self.gauge(0)

    def stats(self):
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._total}
