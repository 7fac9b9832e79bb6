"""Fault injection for crash/disconnect testing (``KART_FAULTS``).

The transport and object-store layers call :func:`hook`/:func:`fire` at the
points where a real deployment fails — a socket dropping mid-packstream, a
process dying between a pack and its idx, a disk filling during a bulk
write. Armed via the environment so the same switch reaches spawned servers
(``kart serve``, ``ssh … kart serve-stdio``) without any plumbing:

    KART_FAULTS=<point>:<n>[,<point>:<n>...]

fires :class:`InjectedFault` on the *n*-th hit of ``<point>`` in this
process (``<point>`` alone means the 1st hit). Each armed point fires
**once** and then disarms, so a retry after the injected failure behaves
exactly like a retry after a real transient failure — which is what the
fault-matrix tests assert. Counters are per-process (a spawned server
parses the spec afresh) and reset whenever the spec string changes.

Registered points:

    transport.read.frame    every record boundary in ``read_pack``
    transport.write.frame   every record boundary in ``write_pack``
    odb.write_raw           every ObjectDb.write_raw call
    odb.bulk_pack           bulk_pack context exit, before the pack finalises
    pack.finalise           PackWriter.finish entry (pack trailer/rename)
    idx.write               write_pack_index entry (idx serialise/rename)
    import.encode           every producer batch of the pipelined import
    import.pack_stream      every pack-write batch of the pipelined import
    diff.device_transfer    every host->device round of the sharded diff
                            backend's batch loader (fallback: host-native)
    server.enum_cache       the pack-enumeration cache: entry publish, and
                            every chunk of a cached stream being served (a
                            mid-cached-stream kill / poisoned-fill probe)
    server.shed             the serve admission check — an armed hit sheds
                            the request (429 + Retry-After) regardless of
                            actual load
    server.rebase           every frame of a server-side rebase of a
                            CAS-losing push: 1 = ancestry/classifier run,
                            2 = merge-commit write, 3 = quarantine temp-ref
                            write (a kill leaves the live store
                            byte-identical — the quarantine is discarded)
    server.ref_cas          the locked landing frames of a receive-pack:
                            1 = the CAS (re-)validation, 2 = just before
                            quarantine migrate
    tiles.encode            the tile payload build (kart_tpu_torch/tiles/encode):
                            1 = after the block-pruned row selection,
                            2 = layers built, before payload assembly —
                            a crash at either frame publishes nothing
    tiles.cache             the tile cache's entry-publish frame: a fault
                            here must poison nothing (the fresh payload is
                            never inserted; a poisoned tile is never
                            served)
    tiles.streams           the KTB2/props stream codec (tiles/encode):
                            each encode_ktb2/props_layer entry (an armed
                            encode publishes nothing — the cache never
                            sees the payload) and each decode entry (the
                            client-side crash probe)
    tiles.export            every batch boundary of the ordered pyramid-
                            export writer: a kill leaves every previously
                            written tile complete and nothing of the
                            doomed batch; the re-run overwrites
                            byte-identically
    fleet.sync              every frame of a replica's sync cycle:
                            1 = the pack-migrate boundary (pulled objects
                            durable, no ref moved), 2+ = before each
                            individual ref advance — a killed cycle re-runs
                            and the replica converges byte-identical
    fleet.proxy             the write relay of a replica: 1 = before any
                            byte reaches the primary (pre-write — a retry
                            lands exactly once), 2 = after the primary
                            answered, before the response relays (the push
                            landed; the client's retry is absorbed
                            idempotently)
    events.emit             the live-update emission frames: 1 = the CDC
                            computation, 2 = the event-log append (the
                            announce). A crash at either leaves refs/store
                            byte-identical and the tip un-announced; the
                            emitter's reconcile pass replays the missed
                            emission (docs/EVENTS.md §3)
    events.warm             the dirty-tile pre-warm pass, before any tile
                            encodes: a crash abandons warming but must
                            not poison the tile cache or lose the
                            announcement (warm is best-effort)
    query.scan              the pushdown scan (kart_tpu_torch/query/scan.py):
                            1 = scan entry (before any stage runs), 2+ =
                            each blob-decode batch — an armed scan dies
                            publishing nothing (no query/peer/HTTP cache
                            entry) and the retried scan is byte-identical
    query.join              the spatial join (kart_tpu_torch/query/join.py):
                            1 = join entry, 2+ = each build-side tile —
                            same publish-nothing / byte-identical-retry
                            contract as query.scan
    query.refine            the exact-refine stage of a scan or join
                            each refine batch, before any
                            verdict lands — an armed refine dies
                            publishing nothing (no query/peer/HTTP cache
                            entry) and the retried query is byte-identical
    geom.extract            vertex extraction from feature blobs
                            (kart_tpu_torch/geom.py::vertex_column_from_blobs):
                            fires before any rows are built, so an armed
                            extraction (import sidecar build, query/tile
                            blob fallback) publishes nothing

Disabled (``KART_FAULTS`` unset) the fast path is a single environ dict
lookup with no allocation: frame-boundary loops additionally hoist
``hook(point)`` — which returns ``None`` when the point is unarmed —
outside the loop, so the per-record cost there is one ``is None`` test;
one-shot sites (``write_raw``, finalisers) just call :func:`fire`.

Counterpart of kart_tpu's ``faults.py``: the same variable, spec and point
names. The port fires every point its modules have counterparts for; the
fleet's (``fleet.sync``, ``fleet.proxy``), the events log's and the warm
pass's (``events.warm``, ``events.emit`` frame 2) and the diff's device
transfer (``diff.device_transfer``) wait for their modules.
"""

import os
import threading

ENV_VAR = "KART_FAULTS"


class InjectedFault(OSError):
    """The injected failure. An OSError so every layer that tolerates real
    I/O failures (retry policies, salvage paths) treats it identically."""

    def __init__(self, point, hit):
        super().__init__(f"injected fault at {point} (hit {hit})")
        self.point = point
        self.hit = hit


_lock = threading.Lock()
_spec_src = None  # the env string the state below was parsed from
_armed = {}  # point -> fire-on-this-hit (None once fired)
_hits = {}  # point -> hits so far


def _parse(src):
    armed = {}
    for part in src.split(","):
        part = part.strip()
        if not part:
            continue
        point, _, n = part.partition(":")
        try:
            armed[point] = max(1, int(n)) if n else 1
        except ValueError:
            armed[point] = 1
    return armed


def _refresh():
    """Re-parse when the env spec changed; counters reset with it."""
    global _spec_src, _armed, _hits
    src = os.environ.get(ENV_VAR) or ""
    if src != _spec_src:
        _spec_src = src
        _armed = _parse(src)
        _hits = {}
    return _armed


def hook(point):
    """-> a zero-arg callable that counts a hit of ``point`` (raising
    InjectedFault on the armed hit), or None when the point is unarmed —
    so hot loops pay nothing when faults are off."""
    if not os.environ.get(ENV_VAR):  # fast path: one dict lookup, no lock
        return None
    with _lock:
        armed = _refresh()
        if point not in armed:
            return None

    def _hit():
        with _lock:
            if _refresh().get(point) is None:
                return  # spec changed / already fired
            _hits[point] = hit = _hits.get(point, 0) + 1
            if hit < _armed[point]:
                return
            _armed[point] = None  # one-shot: disarm before raising
        raise InjectedFault(point, hit)

    return _hit


def fire(point):
    """Count a hit of ``point`` (convenience for non-loop call sites)."""
    h = hook(point)
    if h is not None:
        h()
