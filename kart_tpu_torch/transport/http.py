"""HTTP transport: serve and consume the kartpack wire format over HTTP.

A small JSON + kartpack API with git's fetch semantics: want/have
negotiation, shallow clone and fetch, the server-side spatially filtered
partial clone (the blob filter runs on the server: K3 on its device),
promisor backfill, and pushes that land through a quarantine, auto-rebased
on the server by a three-way merge (K4) when they lost the race for a
branch. The query (K2, K5, K6) and tile (K7) endpoints run their kernels
on the server's device too. Each request runs on its own handler thread.

Counterpart of kart_tpu's ``transport/http.py``, with its endpoints,
status codes, headers, ETags and bytes. The fleet lane (replicas, the peer
cache, the query scatter) and the live-update events feed are not ported:
``GET /api/v1/events`` answers 501, and a fleet role asked for through
``KART_REPLICA_OF`` or ``KART_PEER_CACHE`` refuses to start.

Endpoints (all JSON unless noted):

    GET  <base>/api/v1/refs
        -> {"heads": {...}, "tags": {...}, "head_branch": ..., "shallow": [...]}
    GET  <base>/api/v1/events
        -> 501: the live-update feed is not ported
        (``KART_SERVE_EVENTS=0`` disables: 404).
    GET  <base>/api/v1/tiles/<ref>/<dataset>/<z>/<x>/<y>[?layers=...][&format=mvt]
        -> one framed tile payload (docs/TILES.md): vector tile of the
        named ref's commit, served straight off the columnar sidecar —
        block-pruned, commit-addressed-cached, strong ETag (the ref is
        pinned to its commit oid at request time, so the validator never
        needs revalidation). ``<ref>`` is URL-encoded (refs/heads/main →
        refs%2Fheads%2Fmain); bare branch/tag names and commit oids work
        unescaped. Layer negotiation (docs/TILES.md §5): ``?layers=``
        picks from bin/geojson/ktb2/mvt/props; absent, the server default
        (``KART_TILE_ENCODING``) applies; ``?format=mvt`` — or an
        ``Accept: application/vnd.mapbox-vector-tile`` header — serves
        the **bare MVT protobuf body** (no kart framing, its own strong
        ETag) so off-the-shelf MapLibre clients can point a tile URL
        template here. Responses carry ``Vary: Accept``. Tile requests
        ARE load-shed (429 + Retry-After past the inflight ceiling) —
        unlike /api/v1/stats, a tile is ordinary work.
        ``KART_SERVE_TILES=0`` (or ``kart serve --no-tiles``) disables
        the endpoint (404).
    POST <base>/api/v1/fetch-pack
        {"wants": [...], "haves": [...], "have_shallow": [...],
         "depth": N|null, "filter": "w,s,e,n"|null}
        -> framed response: 8-byte big-endian header length, JSON header
           {"shallow_boundary": [...], "object_count": N}, kartpack bytes.
        Responses carry a strong ETag; a retry may send
        ``Range: bytes=N-`` + ``If-Range: <etag>`` with the *identical*
        body to resume a torn stream mid-pack (206; docs/SERVING.md §3).
        Enumerations are cached + single-flighted per request key
        (docs/SERVING.md §2), and the server sheds load with
        429 + Retry-After past ``KART_SERVE_MAX_INFLIGHT``.
    POST <base>/api/v1/fetch-blobs
        {"oids": [...]} -> framed response (header + kartpack)
    POST <base>/api/v1/receive-pack
        framed request: 8-byte header length, JSON header
        {"updates": [{"ref", "old", "new", "force"}], "shallow": [...]},
        kartpack bytes -> {"updated": {...}} (409 on a rejected update)

There is no authentication — this is a LAN/localhost collaboration server,
like ``git daemon``. Put a reverse proxy in front for anything else.
"""

import json
import os
import re
import struct
import sys
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.error import HTTPError
from urllib.parse import urlsplit
from urllib.request import Request, urlopen

from kart_tpu_torch import faults
from kart_tpu_torch import telemetry as tm
from kart_tpu_torch.core.odb import ObjectMissing
from kart_tpu_torch.core.singleflight import SingleFlightLRU
from kart_tpu_torch.telemetry import access as rq_access
from kart_tpu_torch.telemetry import context as rq_context
from kart_tpu_torch.transport.pack import write_pack

API = "/api/v1"

#: what the events endpoint and the stdio ``events`` op answer
EVENTS_NOT_PORTED = (
    "The live-update events feed is not ported yet: it needs the fleet and "
    "events lane"
)

#: the Mapbox Vector Tile media type: requesting it (Accept header or
#: ``?format=mvt``) negotiates the bare protobuf representation of a tile
_MVT_MIME = "application/vnd.mapbox-vector-tile"
_HEADER_LEN = struct.Struct(">Q")

#: raw-MVT unwrap memo: strong validator -> bare protobuf body. Payloads
#: are immutable per ETag (the commit oid is in the key), so a hit skips
#: the per-request frame reparse on the hot MapLibre path. Byte-budgeted
#: LRU with single-flight fill — the same discipline as the TileCache,
#: which holds the framed representation of these bytes.
_RAW_MVT_MEMO_BUDGET = 16 << 20
_RAW_MVT_MEMO = SingleFlightLRU(_RAW_MVT_MEMO_BUDGET)


def _raw_mvt_body(payload, etag):
    """The framed tile payload's bare ``mvt`` layer bytes, memoized by its
    (immutable) strong validator."""
    status, got = _RAW_MVT_MEMO.lookup_or_begin(etag)
    if status == "hit":
        return got
    from kart_tpu_torch import tiles

    try:
        _header, layer_bytes = tiles.parse_payload(payload)
        body = layer_bytes["mvt"]
    except BaseException:
        if got is not None:
            got.abandon()
        raise
    if got is not None:
        got.publish(body)
    return body

#: default per-socket timeout (connect + each recv) for the quick JSON GETs
#: — a dead server fails fast instead of hanging forever. Every verb flow
#: starts with ls_refs, so this is the fail-fast gate for the whole fetch/
#: push/clone. Env KART_HTTP_TIMEOUT overrides both this and the POST
#: budget below.
DEFAULT_HTTP_TIMEOUT = 30.0

#: default for the pack-carrying POSTs: the server spools its ENTIRE
#: response pack (and, for receive-pack, quarantines + migrates + applies
#: refs) before its first response byte, so the time-to-first-byte scales
#: with repo size — a 30s budget would abort healthy large transfers, and a
#: push timed out client-side after the server committed would report a
#: false failure with refs already moved.
DEFAULT_HTTP_POST_TIMEOUT = 600.0

#: HTTP statuses that recur only transiently (proxy reload, backend
#: restart, throttling) — the module recommends a reverse proxy for
#: production, so these must stay retryable
_TRANSIENT_HTTP_STATUSES = (429, 502, 503, 504)


def http_timeout(default=DEFAULT_HTTP_TIMEOUT):
    try:
        return float(os.environ.get("KART_HTTP_TIMEOUT", default))
    except (TypeError, ValueError):
        return default


class HttpTransportError(ValueError):
    """Transport failure. ``transient`` marks connection-level failures a
    bounded retry may recover from (vs server-reported op errors, which
    recur deterministically); ``pre_write`` marks failures that provably
    happened before any request byte reached the server, the only kind a
    non-idempotent verb retries. ``retry_after`` carries a server-sent
    ``Retry-After`` (seconds) — the load-shedding 429 path — which the
    retry policy honours as a backoff floor. ``shed`` marks an HTTP 429:
    by its semantics the server refused the request *before applying
    anything*, so even a non-idempotent verb (push) may safely retry — the
    paced-queue behaviour load shedding (and the contended-push busy lane)
    is designed for. ``terminal`` marks an application-level final verdict
    the retry policy never overrides, and ``conflict_report`` carries the
    structured three-way conflict document of a rejected contended push
    (docs/SERVING.md §6) for the client to render like a local merge."""

    transient = False
    pre_write = False
    retry_after = None
    shed = False
    terminal = False
    conflict_report = None

    def __init__(self, message, *, transient=None, pre_write=None,
                 retry_after=None, shed=None, terminal=None,
                 conflict_report=None):
        super().__init__(message)
        if transient is not None:
            self.transient = transient
        if pre_write is not None:
            self.pre_write = pre_write
        if retry_after is not None:
            self.retry_after = retry_after
        if shed is not None:
            self.shed = shed
        if terminal is not None:
            self.terminal = terminal
        if conflict_report is not None:
            self.conflict_report = conflict_report


def _retry_after_of(http_error):
    """Seconds from an HTTPError's Retry-After header (seconds form only;
    an HTTP-date or garbage is ignored), or None."""
    try:
        value = float(http_error.headers.get("Retry-After", ""))
    except (AttributeError, TypeError, ValueError):
        return None
    return value if value >= 0 else None


# ---------------------------------------------------------------------------
# framing: [8-byte header length][JSON header][kartpack bytes]
# ---------------------------------------------------------------------------


def write_framed(fp, header, pack_source):
    """pack_source: iterable of (type, content) -> frames header + pack into
    fp. The pack is buffered (spooled) first, and a callable header is only
    evaluated after that drain — so the header can carry enumeration results
    (shallow boundary, counts) without materialising the objects in RAM."""
    with tempfile.SpooledTemporaryFile(max_size=64 * 1024 * 1024) as buf:
        write_pack(buf, iter(pack_source))
        if callable(header):
            header = header()
        raw_header = json.dumps(header).encode()
        fp.write(_HEADER_LEN.pack(len(raw_header)))
        fp.write(raw_header)
        buf.seek(0)
        while True:
            chunk = buf.read(1 << 20)
            if not chunk:
                break
            fp.write(chunk)


def read_framed(fp):
    """-> (header dict, file-like positioned at the pack)."""
    raw = fp.read(_HEADER_LEN.size)
    if len(raw) != _HEADER_LEN.size:
        raise HttpTransportError("Truncated framed response", transient=True)
    (n,) = _HEADER_LEN.unpack(raw)
    if n > 1 << 24:
        raise HttpTransportError("Framed header implausibly large")
    body = fp.read(n)
    if len(body) != n:
        raise HttpTransportError("Truncated framed header", transient=True)
    try:
        header = json.loads(body.decode())
    except (ValueError, UnicodeDecodeError):
        # the declared escape for crafted bytes is HttpTransportError;
        # json/unicode errors leaking here broke the wire-fuzz contract
        raise HttpTransportError("Malformed framed header") from None
    if not isinstance(header, dict):
        raise HttpTransportError("Malformed framed header")
    return header, fp


# ---------------------------------------------------------------------------
# negotiation helper: what does the peer (claim to) have?
# ---------------------------------------------------------------------------


def have_closure(odb, haves, have_shallow=()):
    """Object oids the peer has, given its declared ref tips: every commit
    reachable from the tips (stopping at the peer's shallow boundary, where
    its history is known-truncated), plus the full tree closure of each tip
    commit — tip trees prune the bulk of unchanged subtrees/blobs from a
    typical tip-to-tip transfer."""
    have_shallow = set(have_shallow)
    closure = set()
    frontier = [o for o in haves if o]
    tips = list(frontier)
    while frontier:
        oid = frontier.pop()
        if oid in closure:
            continue
        try:
            commit = odb.read_commit(oid)
        except (ObjectMissing, KeyError, ValueError):
            continue
        closure.add(oid)
        if oid in have_shallow:
            continue  # peer's history stops here
        frontier.extend(commit.parents)

    def add_tree(tree_oid):
        if tree_oid in closure:
            return
        closure.add(tree_oid)
        try:
            entries = odb.read_tree_entries(tree_oid)
        except (ObjectMissing, KeyError, ValueError):
            return
        for e in entries:
            if e.is_tree:
                add_tree(e.oid)
            else:
                closure.add(e.oid)

    for tip in tips:
        try:
            add_tree(odb.read_commit(tip).tree)
        except (ObjectMissing, KeyError, ValueError):
            continue
    return closure


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class KartRequestHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "kart-tpu-serve/1"
    # buffered response writes: headers + a small body leave as ONE
    # sendall instead of two (BaseHTTPRequestHandler defaults to an
    # unbuffered wfile); large pack/tile streams still flush per chunk
    # past the buffer, and handle_one_request flushes at request end
    wbufsize = 64 * 1024

    @property
    def repo(self):
        return self.server.kart_repo

    def log_message(self, fmt, *args):  # route through logging, not stderr
        import logging

        logging.getLogger("kart_tpu_torch.serve").debug(fmt, *args)

    # -- plumbing -----------------------------------------------------------

    def send_response(self, code, message=None):
        # status capture for the access log + trace-context echo: every
        # response carries the request's traceparent back to the client
        self._kart_status = code
        super().send_response(code, message)
        traceparent = rq_context.current_traceparent()
        if traceparent:
            self.send_header(rq_context.TRACEPARENT_HEADER, traceparent)

    def send_header(self, keyword, value):
        if keyword.lower() == "content-length":
            try:
                self._kart_bytes_out = int(value)
            except (TypeError, ValueError):
                pass
        super().send_header(keyword, value)

    def _json(self, status, payload, headers=None):
        raw = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(raw)

    def _framed(self, header, pack_source):
        # spool to disk past 64MB — never hold a whole pack in RAM per
        # request (ThreadingHTTPServer multiplies that by concurrent clients)
        with tempfile.SpooledTemporaryFile(max_size=64 * 1024 * 1024) as buf:
            write_framed(buf, header, pack_source)
            length = buf.tell()
            tm.incr("transport.server.bytes_sent", length)
            buf.seek(0)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-kartpack")
            self.send_header("Content-Length", str(length))
            self.end_headers()
            while True:
                chunk = buf.read(1 << 20)
                if not chunk:
                    break
                self.wfile.write(chunk)

    def _read_body(self):
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n)

    def _read_body_spooled(self):
        n = int(self.headers.get("Content-Length", 0))
        tm.incr("transport.server.bytes_received", n)
        buf = tempfile.SpooledTemporaryFile(max_size=64 * 1024 * 1024)
        remaining = n
        while remaining > 0:
            chunk = self.rfile.read(min(remaining, 1 << 20))
            if not chunk:
                break
            buf.write(chunk)
            remaining -= len(chunk)
        buf.seek(0)
        return buf

    # -- admission: inflight gauge + load shedding --------------------------

    def _admit(self):
        """Count this request in; shed with 429 + Retry-After when the
        inflight ceiling (``KART_SERVE_MAX_INFLIGHT``; 0/unset = unlimited)
        is breached — the client RetryPolicy treats 429 as transient and
        honours Retry-After as its backoff floor, so a storm decays into a
        paced queue instead of a pile-up. -> False when shed (the caller
        must return without handling)."""
        from kart_tpu_torch.transport.retry import _env_int

        server = self.server
        with server.inflight_lock:
            server.inflight += 1
            n = server.inflight
        tm.gauge_set("server.inflight", n)
        limit = _env_int("KART_SERVE_MAX_INFLIGHT", 0)
        shed = limit > 0 and n > limit
        if not shed:
            try:
                # the injectable storm: shed this request regardless of load
                faults.fire("server.shed")
            except faults.InjectedFault:
                shed = True
        if not shed:
            return True
        self._leave()
        tm.incr("server.shed")  # exposition: kart_server_shed_total
        tm.annotate(shed=True)  # access-log: this request was refused
        retry_after = _env_int("KART_SERVE_RETRY_AFTER", 1)
        raw = json.dumps(
            {"error": f"Server over capacity ({limit} inflight); retry"}
        ).encode()
        self.send_response(429)
        self.send_header("Retry-After", str(max(0, retry_after)))
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)
        return False

    def _leave(self):
        server = self.server
        with server.inflight_lock:
            server.inflight -= 1
            n = server.inflight
        tm.gauge_set("server.inflight", n)

    # -- routes -------------------------------------------------------------

    #: route -> access-log verb (matches the transport.server.requests
    #: verb labels, so rates and latency histograms join up)
    _VERBS = {
        f"{API}/stats": "stats",
        f"{API}/refs": "ls-refs",
        f"{API}/events": "events",
        f"{API}/query": "query",
        f"{API}/fetch-pack": "fetch-pack",
        f"{API}/fetch-blobs": "fetch-blobs",
        f"{API}/receive-pack": "receive-pack",
    }

    def _verb_for(self, path):
        if path.startswith(f"{API}/tiles/"):
            return "tiles"
        return self._VERBS.get(path, "other")

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def _dispatch(self, method):
        """Every request runs inside a request scope (trace context adopted
        from the client's ``traceparent`` header, or minted here), under a
        ``transport.request`` span, and books one access-log record +
        latency observation on the way out — whatever the handler did."""
        try:
            path = urlsplit(self.path).path.rstrip("/")
        except ValueError:
            # a malformed request line (e.g. a broken IPv6 literal) must
            # still get an answer and an access-log record, not a dead
            # handler thread
            path = None
        verb = self._verb_for(path) if path is not None else "other"
        self._kart_status = None
        self._kart_bytes_out = 0
        t0 = time.perf_counter()
        with rq_context.request_scope(
            verb=verb,
            traceparent=self.headers.get(rq_context.TRACEPARENT_HEADER),
            record=rq_access.slow_threshold() is not None,
            # a request without a traceparent mints a fresh trace (handler
            # threads start context-free anyway; this pins the contract)
            inherit=False,
        ) as ctx:
            try:
                with tm.span("transport.request", verb=verb):
                    if path is None:
                        self._json(
                            400,
                            {"error": f"Malformed request path: {self.path!r}"},
                        )
                    else:
                        self._route(method, path)
            except Exception as e:  # surface server errors to the client
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
            finally:
                try:
                    bytes_in = int(self.headers.get("Content-Length") or 0)
                except (TypeError, ValueError):
                    bytes_in = 0  # a bogus header must not kill the record
                rq_access.record_request(
                    verb=verb,
                    status=self._kart_status,
                    bytes_in=bytes_in,
                    bytes_out=self._kart_bytes_out,
                    seconds=time.perf_counter() - t0,
                    ctx=ctx,
                )

    def _route(self, method, path):
        if method == "GET":
            if path == f"{API}/stats":
                # never shed the stats endpoint: observability of a server
                # in overload is the whole point of having it
                return self._handle_stats()
            if not self._admit():
                return
            try:
                if path == f"{API}/refs":
                    return self._handle_refs()
                if path == f"{API}/events":
                    return self._handle_events()
                if path == f"{API}/query":
                    return self._handle_query()
                if path.startswith(f"{API}/tiles/"):
                    return self._handle_tile(path)
                self._json(404, {"error": f"No such endpoint: {self.path}"})
            finally:
                self._leave()
        else:
            if not self._admit():
                return
            try:
                if path == f"{API}/receive-pack":
                    return self._handle_receive_pack()
                if path == f"{API}/fetch-pack":
                    return self._handle_fetch_pack()
                if path == f"{API}/fetch-blobs":
                    return self._handle_fetch_blobs()
                self._json(404, {"error": f"No such endpoint: {self.path}"})
            finally:
                self._leave()

    def _handle_refs(self):
        from kart_tpu_torch.transport.service import ls_refs_info

        self._json(200, ls_refs_info(self.repo))

    def _handle_events(self):
        """``GET /api/v1/events``: kart_tpu's live-update feed, which needs
        its fleet and events lane; the port answers 501 (404 when
        ``KART_SERVE_EVENTS=0`` disables the endpoint, as kart_tpu's
        does)."""
        if os.environ.get("KART_SERVE_EVENTS", "1") in ("0", "false"):
            return self._json(
                404, {"error": "Event serving is disabled on this server"}
            )
        tm.incr("transport.server.requests", verb="events")
        self._json(501, {"error": EVENTS_NOT_PORTED})

    @staticmethod
    def _if_none_match_hits(header_value, etag):
        """RFC 9110 If-None-Match: a comma-separated validator list, each
        optionally weak-prefixed (``W/``), or ``*``. A browser/proxy that
        coalesced several stored responses sends the list form — exact
        string equality would silently kill the 304 fast path for it."""
        if not header_value:
            return False
        if header_value.strip() == "*":
            return True
        for part in header_value.split(","):
            candidate = part.strip()
            if candidate.startswith("W/"):
                candidate = candidate[2:]
            if candidate == etag:
                return True
        return False

    def _handle_tile(self, path):
        """``GET /api/v1/tiles/<ref>/<dataset>/<z>/<x>/<y>``: serve one
        vector tile of the named revision straight off the columnar store
        (docs/TILES.md), its rows projected on the server's device (K7 on
        the card). Dataset paths may contain slashes; the last three
        segments are always z/x/y and the first is the (URL-encoded) ref."""
        from urllib.parse import parse_qs, unquote

        from kart_tpu_torch import tiles

        if os.environ.get("KART_SERVE_TILES", "1") in ("0", "false"):
            return self._json(
                404, {"error": "Tile serving is disabled on this server"}
            )
        tm.incr("transport.server.requests", verb="tiles")
        parts = [unquote(p) for p in path[len(f"{API}/tiles/"):].split("/")]
        if len(parts) < 5 or not all(parts):
            return self._json(
                400,
                {"error": "Tile address must be <ref>/<dataset>/<z>/<x>/<y>"},
            )
        ref, ds_path = parts[0], "/".join(parts[1:-3])
        z, x, y = parts[-3:]
        tm.annotate(ref=ref, dataset=ds_path, tile=f"{z}/{x}/{y}")
        query = urlsplit(self.path).query
        params = parse_qs(query) if query else {}
        layers = params.get("layers", [None])[0]
        fmt = params.get("format", [None])[0]
        # content negotiation (docs/TILES.md §5): ?format=mvt — or, with
        # no explicit layer spec, an MVT Accept header — means the client
        # wants the bare protobuf body an off-the-shelf MapLibre renderer
        # can consume; everything else gets the framed multi-layer payload
        raw_mvt = False
        if fmt is not None:
            if fmt != "mvt":
                return self._json(
                    400, {"error": f"Unknown tile format {fmt!r} (try mvt)"}
                )
            raw_mvt = True
            if layers is None:
                layers = "mvt"
        elif layers is None and self._accepts_mvt(self.headers.get("Accept")):
            layers, raw_mvt = "mvt", True
        try:
            # the validator derives from the request key alone (commit oid
            # + address + layers): a revalidating client is answered 304
            # before any source is built or payload encoded
            key, etag, commit_oid, (zi, xi, yi), norm_layers = (
                tiles.tile_request_key(
                    self.repo, ref, ds_path, z, x, y, layers=layers
                )
            )
            if raw_mvt:
                if norm_layers != ("mvt",):
                    return self._json(
                        400,
                        {"error": "format=mvt serves exactly one layer: "
                                  "mvt (drop layers= or set layers=mvt)"},
                    )
                # different representation bytes => different strong
                # validator, even though one cache key backs both
                etag = tiles.etag_for(key, raw=True)
            if self._if_none_match_hits(self.headers.get("If-None-Match"), etag):
                # commit-addressed: a matching validator can never be stale
                tm.annotate(revalidated=True)
                self.send_response(304)
                self.send_header("ETag", etag)
                self.send_header("Vary", "Accept")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            payload, framed_etag, _cached = tiles.serve_tile(
                self.repo, ref, ds_path, zi, xi, yi, layers=norm_layers,
                commit_oid=commit_oid, device=self.server.kart_device,
            )
            if not raw_mvt:
                etag = framed_etag
        except tiles.TileTooLarge as e:
            return self._json(
                413, {"error": str(e), "count": e.count, "limit": e.limit}
            )
        except tiles.TileDataUnavailable as e:
            return self._json(422, {"error": str(e)})
        except tiles.TileSourceError as e:
            return self._json(404, {"error": str(e)})
        except (tiles.TileAddressError, tiles.TileEncodeError) as e:
            return self._json(400, {"error": str(e)})
        self._send_tile(payload, etag, raw_mvt=raw_mvt)

    @staticmethod
    def _accepts_mvt(accept):
        """Does the Accept header positively request the MVT media type?
        RFC 9110 list form with q-values: a client sending
        ``application/vnd.mapbox-vector-tile;q=0`` is *refusing* the type
        — a substring test would hand it the bare protobuf anyway."""
        if not accept:
            return False
        for part in accept.split(","):
            media, _, params = part.partition(";")
            if media.strip().lower() != _MVT_MIME:
                continue
            q = 1.0
            for param in params.split(";"):
                name, _, value = param.partition("=")
                if name.strip().lower() == "q":
                    try:
                        q = float(value.strip())
                    except ValueError:
                        q = 1.0
            return q > 0.0
        return False

    def _send_tile(self, payload, etag, raw_mvt=False):
        if raw_mvt:
            # unwrap the framed payload: the bare MVT body is what an
            # off-the-shelf renderer consumes (the frame — and the cache
            # entry behind it — still carries the layer). The unwrap
            # (json header decode + slice) is memoized by strong validator
            # — payloads are immutable per ETag — so cache-hit raw-MVT
            # requests skip the reparse on the hot MapLibre path. Note
            # tiles.bytes_out deliberately counts the FRAMED bytes (the
            # cache-entry size, consistent across representations); wire
            # egress is transport.server.bytes_sent below.
            payload = _raw_mvt_body(payload, etag)
        tm.incr("transport.server.bytes_sent", len(payload))
        self.send_response(200)
        self.send_header(
            "Content-Type", _MVT_MIME if raw_mvt else "application/x-kart-tile"
        )
        self.send_header("ETag", etag)
        # the payload is immutable for its key (the commit oid is in it):
        # downstream HTTP caches may keep it as long as they like
        self.send_header("Cache-Control", "public, max-age=31536000, immutable")
        # the Accept header can negotiate the representation (bare MVT vs
        # framed): shared caches must key on it
        self.send_header("Vary", "Accept")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _handle_query(self):
        """``GET /api/v1/query``: the serving face of the query engine
        (docs/QUERY.md §5), predicate-pushdown scans and spatial joins over
        one commit, their kernels on the server's device. Results are
        commit-addressed (the strong ETag derives from the resolved oid(s)
        + the normalized request), so a matching validator can never be
        stale and responses cache forever. ``part=lo:hi`` answers a join
        over a block range of its probe side."""
        from urllib.parse import parse_qs

        from kart_tpu_torch import query as query_mod
        from kart_tpu_torch.geom import geom_refine_enabled
        from kart_tpu_torch.query import cache as qcache

        tm.incr("transport.server.requests", verb="query")
        params = parse_qs(urlsplit(self.path).query)

        def one(name, default=None):
            return params.get(name, [default])[0]

        ref, ds_path = one("ref"), one("dataset")
        if not ref or not ds_path:
            return self._json(
                400, {"error": "query needs ref= and dataset= parameters"}
            )
        where, bbox = one("where"), one("bbox")
        raw_intersects = one("intersects")
        output = one("output", "count")
        count_by = one("count_by")
        raw_part = one("part")
        # fold the *effective* mode into the key: a server pinned to
        # envelope semantics (KART_GEOM_REFINE=0) serves different bytes
        # and must never share a validator with an exact answer
        approx = (
            one("approx") in ("1", "true") or not geom_refine_enabled()
        )
        try:
            page = int(one("page")) if one("page") is not None else None
            page_size = (
                int(one("page_size")) if one("page_size") is not None else None
            )
        except ValueError:
            return self._json(
                400, {"error": "page/page_size must be integers"}
            )
        try:
            commit1 = query_mod.resolve_query_commit(self.repo, ref)
            intersects = commit2 = ds_path2 = None
            if raw_intersects:
                refish2, sep, ds2 = raw_intersects.partition(":")
                if not sep or not refish2 or not ds2:
                    raise query_mod.QueryError(
                        f"intersects wants <refish>:<dataset>,"
                        f" got {raw_intersects!r}"
                    )
                commit2 = query_mod.resolve_query_commit(self.repo, refish2)
                ds_path2 = ds2
                intersects = (commit2, ds_path2)
            part = part_str = None
            if raw_part:
                m = re.fullmatch(r"(\d+):(\d+)", raw_part)
                if m is None:
                    raise query_mod.QueryError(
                        f"part wants <lo>:<hi> row numbers, got {raw_part!r}"
                    )
                part = (int(m.group(1)), int(m.group(2)))
                part_str = f"{part[0]}:{part[1]}"
        except query_mod.QueryError as e:
            return self._json(400, {"error": str(e)})
        tm.annotate(ref=ref, dataset=ds_path)

        # the validator derives from the request key alone: a revalidating
        # client is answered 304 before any scan or join runs
        key = qcache.query_request_key(
            commit1, ds_path, where=where, bbox=bbox, commit_oid2=commit2,
            ds_path2=ds_path2, output=output, count_by=count_by, page=page,
            page_size=page_size, part=part_str, approx=approx,
        )
        etag = qcache.etag_for(key)
        if self._if_none_match_hits(self.headers.get("If-None-Match"), etag):
            tm.annotate(revalidated=True)
            self.send_response(304)
            self.send_header("ETag", etag)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return

        def compute():
            doc = query_mod.run_query(
                self.repo, commit1, ds_path, where=where, bbox=bbox,
                intersects=intersects, output=output, count_by=count_by,
                page=page, page_size=page_size, part=part, approx=approx,
                device=self.server.kart_device,
            )
            return json.dumps(doc, sort_keys=True).encode()

        try:
            payload = qcache.query_filled(
                qcache.query_cache_for(self.repo), key, compute
            )
        except query_mod.QueryError as e:
            return self._json(400, {"error": str(e)})
        tm.incr("transport.server.bytes_sent", len(payload))
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("ETag", etag)
        # immutable for its key (the commit oids are in it): downstream
        # HTTP caches may keep it as long as they like
        self.send_header("Cache-Control", "public, max-age=31536000, immutable")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _handle_stats(self):
        """Prometheus-style text exposition of this server process's metric
        registry (`kart stats <url>` reads this). ``?format=json`` returns
        the structured stats document instead — bucketed histograms with
        quantile estimates, windowed rates, the slow-request exemplar ring
        and live inflight/queue depth (what ``kart top`` renders)."""
        from urllib.parse import parse_qs

        from kart_tpu_torch.telemetry import sinks

        tm.incr("transport.server.requests", verb="stats")
        params = parse_qs(urlsplit(self.path).query)
        if params.get("format", [""])[0] == "json":
            extra = {"inflight": self.server.inflight}
            # the query-engine operator view (docs/QUERY.md §7): present
            # once any query has run in this process
            query_mod = sys.modules.get("kart_tpu_torch.query")
            if query_mod is not None:
                extra["query"] = query_mod.status_dict()
            return self._json(200, rq_access.stats_payload(extra=extra))
        raw = sinks.prometheus_text().encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _range_offset(self, etag, length):
        """The validated resume offset of a ``Range: bytes=N-`` request
        (0 = serve the full response). If-Range must present the exact
        strong validator we handed out — the etag embeds the ref-tips
        fingerprint, so a ref update between attempts forces a clean full
        response instead of splicing bytes from two different packs."""
        rng = self.headers.get("Range")
        if not rng or self.headers.get("If-Range") != etag:
            return 0
        m = re.match(r"bytes=(\d+)-$", rng.strip())
        if not m:
            return 0
        offset = int(m.group(1))
        return offset if 0 < offset < length else 0

    def _handle_fetch_pack(self):
        from contextlib import closing

        from kart_tpu_torch.transport.service import materialise_plan, serve_fetch_pack

        req = json.loads(self._read_body().decode() or "{}")
        # cache-fronted enumeration: a hit (or a single-flight wait on a
        # concurrent identical request) skips the ObjectEnumerator walk;
        # a fresh walk spools, publishes, then streams
        plan = serve_fetch_pack(self.repo, req, device=self.server.kart_device)
        fp, length = materialise_plan(plan)
        with closing(fp):
            offset = self._range_offset(plan.etag, length)
            if offset:
                tm.incr("server.range_resumes")
                tm.annotate(range_resume=True)
                # a validated byte-range request IS a resumed fetch, same
                # as a non-empty oid-exclusion list on the wire field —
                # but count each resumed request once (a range retry of an
                # exclusion-seeded body was already counted)
                if not req.get("exclude"):
                    tm.incr("transport.server.fetch_resumes")
                fp.seek(offset)
                self.send_response(206)
                self.send_header(
                    "Content-Range", f"bytes {offset}-{length - 1}/{length}"
                )
            else:
                self.send_response(200)
            self.send_header("Content-Type", "application/x-kartpack")
            self.send_header("ETag", plan.etag)
            self.send_header("Accept-Ranges", "bytes")
            self.send_header("Content-Length", str(length - offset))
            self.end_headers()
            tm.incr("transport.server.bytes_sent", length - offset)
            fault = faults.hook("server.enum_cache") if plan.cached else None
            while True:
                try:
                    if fault is not None:
                        fault()
                    chunk = fp.read(1 << 20)
                except faults.InjectedFault:
                    # the injected mid-cached-stream kill: truncate the
                    # response like a dying server would (no trailing 500
                    # junk that would pad out Content-Length) — the client
                    # salvages and resumes (tests/test_faults.py)
                    self.close_connection = True
                    return
                if not chunk:
                    break
                self.wfile.write(chunk)

    def _handle_fetch_blobs(self):
        from kart_tpu_torch.transport.service import collect_blobs

        req = json.loads(self._read_body().decode() or "{}")
        header, objects = collect_blobs(self.repo, req.get("oids", []))
        self._framed(header, objects)

    def _handle_receive_pack(self):
        from kart_tpu_torch.transport.protocol import rejection_wire_fields
        from kart_tpu_torch.transport.service import quarantined_receive

        # the pack drains into a quarantine objects dir and migrates into
        # the live store only after checksum + ref preconditions pass — a
        # torn or rejected push leaves the store byte-identical; a push
        # that lost its CAS to a contending writer is auto-rebased against
        # the new tip before re-validating (docs/SERVING.md §6). The CAS is
        # atomic across handler threads AND across processes (an ssh push
        # is a separate serve-stdio process): thread lock + gitdir file
        # lock, both held inside quarantined_receive.
        with self._read_body_spooled() as body:
            header, pack_fp = read_framed(body)
            result = quarantined_receive(
                self.repo, header, pack_fp, thread_lock=self.server.push_lock,
                device=self.server.kart_device,
            )
        if result[0] == "ok":
            self._json(200, result[1])
            return
        # a structured rejection: conflict -> 409 (terminal ones carry the
        # report), busy (merge queue full / CAS budget exhausted) -> the
        # same paced 429 + Retry-After lane the load shedder uses
        status = {"conflict": 409, "busy": 429}.get(result[0], 400)
        payload = {"error": result[1]}
        payload.update(rejection_wire_fields(result))
        headers = None
        retry_after = payload.get("retry_after")
        if status == 429 and retry_after is not None:
            headers = {"Retry-After": str(max(0, int(retry_after)))}
        self._json(status, payload, headers)


def refuse_fleet():
    """Raise NotYetImplemented when the environment asks for a fleet role
    (``KART_REPLICA_OF``, ``KART_PEER_CACHE``): kart_tpu's replica and
    peer-cache tiers are not ported, so the server refuses before it binds
    its port."""
    from kart_tpu_torch.core.repo import NotYetImplemented

    for name in ("KART_REPLICA_OF", "KART_PEER_CACHE"):
        if os.environ.get(name):
            raise NotYetImplemented(
                f"{name} asks for a fleet role: the fleet and events lane "
                f"(replicas, the peer cache, the events feed) is not ported yet"
            )


def make_server(repo, host="127.0.0.1", port=0, *, device=None):
    """-> ThreadingHTTPServer serving `repo`; port 0 picks a free port.
    ``device``: where the served kernels run (None: the card, ``"cpu"``:
    the plain versions); without a card and without ``"cpu"`` this raises
    before it binds.

    Serving turns metrics on (a server without observable counters is
    undebuggable in production — the registry feeds ``GET /api/v1/stats``)
    and configures the shared ``kart_tpu_torch`` logger so a spawned server
    honours ``KART_LOG`` without the CLI having run."""
    from kart_tpu_torch import runtime

    refuse_fleet()
    runtime.resolve_device(device)
    tm.configure_logging()
    tm.enable(metrics=True)
    server = ThreadingHTTPServer((host, port), KartRequestHandler)
    server.kart_repo = repo
    server.kart_device = device
    # narrow write lock: held only around ref validation + quarantine
    # migrate inside quarantined_receive — concurrent pushes drain their
    # (per-push) quarantines in parallel and serialise only at the CAS
    server.push_lock = threading.Lock()
    # admission control: live request gauge feeding the load shedder
    server.inflight = 0
    server.inflight_lock = threading.Lock()
    return server


def serve(repo, host="127.0.0.1", port=8470, *, in_thread=False, device=None):
    """Run the collaboration server (blocking unless in_thread; then the
    caller owns ``server.shutdown()`` and ``server.server_close()``)."""
    server = make_server(repo, host, port, device=device)
    if in_thread:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server
    try:
        server.serve_forever()
    finally:
        server.server_close()


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class _CountingReader:
    """Byte-counting file pass-through. Two users: the fetch client
    measures the framed-header prefix exactly (``read_framed`` reads exact
    sizes, no read-ahead) to anchor ``Range: bytes=N-`` resume offsets;
    the stdio server wraps both pipe ends so per-op deltas feed the
    access-log bytes_in/bytes_out fields (write/flush pass through with
    the same accounting)."""

    __slots__ = ("_fp", "count")

    def __init__(self, fp, start=0):
        self._fp = fp
        self.count = start

    def read(self, n=-1):
        data = self._fp.read(n)
        self.count += len(data)
        return data

    def write(self, data):
        self.count += len(data)
        return self._fp.write(data)

    def flush(self):
        self._fp.flush()


def _pack_body_source(resp):
    """-> file-like over the rest of ``resp``'s body (the pack stream): a
    large C-level read-ahead buffer under the per-record parser (cuts the
    Python stream-layer cost ~2.5x), while still *streaming* — consuming
    at drain speed keeps the socket's backpressure, which under a client
    storm is what staggers concurrent drains instead of letting every
    client buffer its whole pack and then fight for the same cores."""
    import io

    return io.BufferedReader(resp, buffer_size=1 << 20)


class HttpRemote:
    """Client for the API above; the HTTP implementation of the transport
    verbs remote.py's fetch/push/clone are written against.

    Fault tolerance: every verb runs under ``retry`` (a
    :class:`~kart_tpu_torch.transport.retry.RetryPolicy`). The idempotent verbs
    (``ls_refs``, ``fetch_pack``, ``fetch_blobs``) retry on any transient
    failure — and ``fetch_pack`` *resumes*: objects salvaged from a torn
    stream are excluded from the re-negotiation, so a retry transfers only
    the missing remainder. ``receive_pack`` retries only when the
    connection was never established (the server provably saw nothing)."""

    def __init__(self, url, retry=None):
        from kart_tpu_torch.transport.retry import RetryPolicy

        self.base = url.rstrip("/")
        self.retry = retry if retry is not None else RetryPolicy.from_config()

    def close(self):
        """No persistent connection; symmetric with StdioRemote so callers
        can close any network client unconditionally."""

    def reset(self, *_):
        """No per-connection state to tear down between retries."""

    @staticmethod
    def _trace_headers():
        """The cross-process trace-context header for the active request
        scope (docs/OBSERVABILITY.md §8): the server adopts the id, so its
        spans and access-log lines name *this* logical request."""
        traceparent = rq_context.current_traceparent()
        if traceparent is None:
            return {}
        return {rq_context.TRACEPARENT_HEADER: traceparent}

    def _get(self, path):
        headers = self._trace_headers()
        try:
            req = Request(self.base + path, headers=headers)
            with urlopen(req, timeout=http_timeout()) as resp:
                return json.loads(resp.read().decode())
        except HTTPError as e:
            raise HttpTransportError(
                f"Remote {self.base!r} error: {e}",
                transient=e.code in _TRANSIENT_HTTP_STATUSES,
                retry_after=_retry_after_of(e),
                shed=e.code == 429,
            )
        except OSError as e:
            # connection-level (refused / DNS / socket timeout): transient,
            # and for GETs necessarily pre-write
            raise HttpTransportError(
                f"Cannot reach remote {self.base!r}: {e}",
                transient=True,
                pre_write=True,
            )

    def _post(self, path, data, *, raw=False, length=None, headers=None):
        """data: JSON-able object, or (raw=True) bytes / a file-like with an
        explicit length. ``headers``: extra request headers (the byte-range
        resume path sends Range/If-Range)."""
        all_headers = {
            "Content-Type": "application/x-kartpack" if raw else "application/json"
        }
        all_headers.update(self._trace_headers())
        if headers:
            all_headers.update(headers)
        body = data if raw else json.dumps(data).encode()
        if length is not None:
            all_headers["Content-Length"] = str(length)
        req = Request(
            self.base + path, data=body, headers=all_headers, method="POST"
        )
        try:
            return urlopen(req, timeout=http_timeout(DEFAULT_HTTP_POST_TIMEOUT))
        except HTTPError as e:
            # the server answered: usually a deterministic op error, except
            # the proxy-layer statuses that recur only transiently
            from kart_tpu_torch.transport.protocol import error_attrs_from_wire

            body = None
            try:
                body = json.loads(e.read().decode())
            except (OSError, ValueError, AttributeError):
                # non-JSON / unreadable error body: the HTTP status below
                # is still reported
                pass
            detail = body.get("error", "") if isinstance(body, dict) else ""
            attrs = {
                "transient": e.code in _TRANSIENT_HTTP_STATUSES,
                "retry_after": _retry_after_of(e),
                "shed": e.code == 429,
            }
            # structured-rejection fields from the body (terminal verdicts,
            # the conflict report, busy pacing) — the header/status values
            # above win where both are present
            for name, value in error_attrs_from_wire(body).items():
                if attrs.get(name) in (None, False):
                    attrs[name] = value
            raise HttpTransportError(
                f"Remote {self.base!r} error: {detail or e}", **attrs
            )
        except OSError as e:
            reason = getattr(e, "reason", e)
            raise HttpTransportError(
                f"Remote {self.base!r} error: {e}",
                transient=True,
                # connect refused ⇒ no request byte ever left this process,
                # so even a non-idempotent verb may safely retry
                pre_write=isinstance(reason, ConnectionRefusedError),
            )

    # -- verbs --------------------------------------------------------------

    def ls_refs(self):
        # one request scope per verb call: every retry attempt carries the
        # same request id on the wire, so the server's access log shows one
        # logical request with N attempts, not N anonymous requests
        with rq_context.request_scope(verb="ls-refs"):
            return self.retry.call(
                lambda: self._get(f"{API}/refs"), label="ls-refs",
                on_retry=self.reset,
            )

    def fetch_pack(self, dst_repo, wants, *, haves=(), have_shallow=(),
                   depth=None, filter_spec=None, exclude=None):
        """-> header dict; objects are written straight into dst_repo.

        Resumable, twice over. In-process retries resume *mid-pack* by byte
        range: every attempt tracks the absolute offset of the last
        complete record it consumed, and the retry re-sends the identical
        request with ``Range: bytes=N-`` + the server's strong validator
        (``If-Range``), so the server — whose enumeration is deterministic
        per key, cache or no cache — ships only the unseen tail. If the
        validator no longer matches (a ref moved, the entry was evicted)
        the server answers 200 with a fresh full response, and the salvaged
        objects still suppress re-writing. Cross-process resume stays
        oid-exclusion based: ``exclude`` seeds the exclusion set (the oids
        salvaged by the earlier, killed process), and the set is shared in
        place so the caller sees everything salvaged even when every
        attempt fails."""
        from kart_tpu_torch.transport.retry import drain_pack_salvaging, exclude_arg

        received = exclude if isinstance(exclude, set) else set(exclude or ())
        # byte-range resume state across retry attempts: the validator, the
        # exact body that produced it (byte-identical key on the server),
        # the response header already read, and the committed byte offset
        state = {"etag": None, "body": None, "header": None, "offset": 0}

        def attempt():
            resp = None
            if state["etag"] and state["offset"] > 0:
                resp = self._post(
                    f"{API}/fetch-pack",
                    state["body"],
                    headers={
                        "Range": f"bytes={state['offset']}-",
                        "If-Range": state["etag"],
                    },
                )
                if getattr(resp, "status", 200) == 206:
                    tm.incr("transport.range_resumes")
                    with resp:
                        base = state["offset"]
                        drain_pack_salvaging(
                            dst_repo.odb,
                            # read-ahead is safe: the response body IS the
                            # pack remainder, bounded by Content-Length
                            _pack_body_source(resp),
                            received,
                            mid_stream=True,
                            commit=lambda off: state.update(offset=base + off),
                        )
                    return state["header"]
                # validator mismatch: the server sent a fresh full response
                # — fall through and consume it as one
            if resp is None:
                body = {
                    "wants": list(wants),
                    "haves": list(haves),
                    "have_shallow": sorted(have_shallow),
                    "depth": depth,
                    "filter": filter_spec,
                    "exclude": exclude_arg(received),
                }
                resp = self._post(f"{API}/fetch-pack", body)
                state["body"] = body
            with resp:
                counting = _CountingReader(resp)
                header, _ = read_framed(counting)
                prefix = counting.count  # 8-byte length + JSON header
                state.update(
                    etag=resp.headers.get("ETag"), header=header, offset=0
                )
                drain_pack_salvaging(
                    dst_repo.odb,
                    _pack_body_source(resp),
                    received,
                    commit=lambda off: state.update(offset=prefix + off),
                )
            return header

        with rq_context.request_scope(verb="fetch-pack"):
            return self.retry.call(
                attempt, label="fetch-pack", on_retry=self.reset
            )

    def fetch_blobs(self, dst_repo, oids):
        from kart_tpu_torch.transport.retry import drain_pack_salvaging

        received = set()

        def attempt():
            # a retry re-requests only what the torn attempt didn't land
            want = [o for o in oids if o not in received]
            if not want:
                return {}
            resp = self._post(f"{API}/fetch-blobs", {"oids": want})
            with resp:
                header, pack_fp = read_framed(resp)
                drain_pack_salvaging(dst_repo.odb, pack_fp, received)
            return header

        with rq_context.request_scope(verb="fetch-blobs"):
            header = self.retry.call(
                attempt, label="fetch-blobs", on_retry=self.reset
            )
        if header.get("missing"):
            raise HttpTransportError(
                f"Remote is missing promised objects: {header['missing'][:5]}"
            )
        return len(received)

    def receive_pack(self, objects, updates, *, shallow=()):
        """objects: iterable of (type, content); updates: [{ref, old, new,
        force}]; shallow: oids or a callable evaluated after the objects
        drain (an ObjectEnumerator's boundary is only final then).
        -> the server's full receive payload: ``{"updated": {ref:
        oid|None}, "rebase": {...}}`` (``rebase`` reports whether the
        server auto-rebased a contended push, its CAS attempt count and
        merge-queue wait; docs/SERVING.md §6).

        Not idempotent: only pre-write failures (connect refused — the
        server saw no byte of this request) and paced 429s — load shedding
        or the contended-push busy lane, both of which provably applied
        nothing — are retried. A structured conflict rejection is
        ``terminal``: surfaced once, never blindly re-pushed."""
        from kart_tpu_torch.transport.retry import is_pre_write

        def retryable(exc):
            return is_pre_write(exc) or getattr(exc, "shed", False)

        with tempfile.SpooledTemporaryFile(max_size=64 * 1024 * 1024) as buf:
            write_framed(
                buf,
                lambda: {
                    "updates": updates,
                    "shallow": sorted(shallow() if callable(shallow) else shallow),
                },
                objects,
            )
            length = buf.tell()

            def attempt():
                buf.seek(0)
                return self._post(
                    f"{API}/receive-pack", buf, raw=True, length=length
                )

            with rq_context.request_scope(verb="receive-pack"):
                resp = self.retry.call(
                    attempt, label="receive-pack", retryable=retryable,
                    on_retry=self.reset,
                )
        with resp:
            return json.loads(resp.read().decode())
