"""SSH / stdio transport: the four transport verbs over a spawned process's
stdin and stdout.

The client spawns ``ssh [user@]host kart serve-stdio <path>`` (the ssh
binary from ``$KART_SSH``, the remote kart command from ``$KART_SSH_KART``)
and exchanges the HTTP transport's framed messages, [8-byte header
length][JSON header][kartpack bytes], one request frame and one response
frame an exchange, any number of exchanges a connection. The served verbs
are the shared service layer's (:mod:`kart_tpu_torch.transport.service`),
so a filtered fetch runs K3 and a diverged push K4 on the server's device,
as over HTTP.

Counterpart of kart_tpu's ``transport/stdio.py``: ``StdioRemote``,
``parse_ssh_url``, ``is_ssh_url`` and ``serve_stdio``. The ``events`` op
answers an error frame: the live-update feed is not ported.

URL forms (git's own):

    ssh://[user@]host[:port]/abs/path
    [user@]host:path        (scp-like)
"""

import json
import logging
import os
import shlex
import subprocess
import threading
import time

from kart_tpu_torch.telemetry import access as rq_access
from kart_tpu_torch.telemetry import context as rq_context
from kart_tpu_torch.transport.http import (
    _HEADER_LEN,
    EVENTS_NOT_PORTED,
    _CountingReader,
    HttpTransportError,
    read_framed,
    write_framed,
)
from kart_tpu_torch.transport.pack import read_pack
from kart_tpu_torch.transport.remote import is_ssh_url, parse_ssh_url  # noqa: F401

#: how long the client waits for a response frame to *start* before the
#: hung-ssh watchdog kills the transport process (the server spools its
#: whole pack before the first response byte, so keep this generous);
#: env KART_STDIO_TIMEOUT overrides, <= 0 disables.
DEFAULT_STDIO_TIMEOUT = 600.0


def stdio_timeout():
    try:
        return float(os.environ.get("KART_STDIO_TIMEOUT", DEFAULT_STDIO_TIMEOUT))
    except (TypeError, ValueError):
        return DEFAULT_STDIO_TIMEOUT


class Watchdog:
    """An inactivity bound around a blocking read that cannot be given a
    timeout (a pipe from a hung ssh): when the guarded work goes ``timeout``
    seconds without a :meth:`touch`, ``on_timeout`` runs (it kills the
    process that owns the pipe, so the read returns EOF) and :attr:`fired`
    is set. ``timeout`` of None or <= 0 disarms it. Counterpart of
    kart_tpu's ``runtime.Watchdog``."""

    def __init__(self, timeout, on_timeout):
        self.timeout = timeout
        self.on_timeout = on_timeout
        self.fired = False
        self._timer = None
        self._closed = False
        self._last = time.monotonic()

    def touch(self):
        self._last = time.monotonic()

    def _fire(self):
        if self._closed:
            return
        remaining = self.timeout - (time.monotonic() - self._last)
        if remaining > 0:  # progress since arming: re-arm for the rest
            self._timer = threading.Timer(remaining, self._fire)
            self._timer.daemon = True
            self._timer.start()
            return
        self.fired = True
        from kart_tpu_torch import telemetry as tm

        tm.incr("runtime.watchdog_fired")
        try:
            self.on_timeout()
        except Exception:  # the guarded read reports the real failure
            logging.getLogger("kart_tpu_torch.transport.stdio").debug(
                "watchdog on_timeout raised", exc_info=True)

    def __enter__(self):
        if self.timeout is not None and self.timeout > 0:
            self._last = time.monotonic()
            self._timer = threading.Timer(self.timeout, self._fire)
            self._timer.daemon = True
            self._timer.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._closed = True
        if self._timer is not None:
            self._timer.cancel()
        return False


class StdioTransportError(HttpTransportError):
    """Transport failure over the spawned-process pipe. Subclasses the HTTP
    error so remote.py's error handling covers both wire transports."""


class StdioRemote:
    """Client half: mirrors HttpRemote's verb API over one spawned process.
    The subprocess starts lazily and is reused across calls (one ssh
    connection per remote instance, like git).

    Fault tolerance mirrors HttpRemote: idempotent verbs retry under
    ``retry`` (the connection is respawned between attempts — a failed RPC
    leaves the pipe desynced), ``fetch_pack`` resumes via oid exclusion,
    ``receive_pack`` retries only on spawn failure (pre-write). A hung ssh
    (dead relay, wedged server) is bounded by a watchdog that kills the
    transport process when a response frame doesn't start within
    $KART_STDIO_TIMEOUT seconds."""

    def __init__(self, url, retry=None):
        from kart_tpu_torch.transport.retry import RetryPolicy

        self.url = url
        parsed = parse_ssh_url(url)
        if parsed is None:
            raise StdioTransportError(f"Not an ssh remote: {url!r}")
        self.userhost, self.port, self.path = parsed
        self.retry = retry if retry is not None else RetryPolicy.from_config()
        self._proc = None

    # -- process management --------------------------------------------------

    def _command(self):
        ssh = shlex.split(os.environ.get("KART_SSH", "ssh"))
        kart = os.environ.get("KART_SSH_KART", "kart")
        cmd = list(ssh)
        if self.port:
            cmd += ["-p", str(self.port)]
        cmd += [self.userhost, f"{kart} serve-stdio {shlex.quote(self.path)}"]
        return cmd

    def _ensure(self):
        if self._proc is not None and self._proc.poll() is None:
            return self._proc
        try:
            self._proc = subprocess.Popen(
                self._command(),
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                # stderr passes through: ssh auth prompts/errors stay visible
            )
        except OSError as e:
            raise StdioTransportError(
                f"Cannot spawn transport for {self.url!r}: {e}",
                transient=True,
                pre_write=True,  # nothing was spawned: no byte reached anyone
            )
        return self._proc

    def close(self, timeout=5.0):
        """Shut the transport process down, bounded: close the pipes, wait
        up to ``timeout`` for a clean exit, then kill. Never raises from
        callers' cleanup paths, never leaves a zombie (the post-kill wait
        reaps), and a second close() is a no-op."""
        proc, self._proc = self._proc, None
        if proc is None:
            return
        for fp in (proc.stdin, proc.stdout):
            try:
                if fp is not None:
                    fp.close()
            except OSError:
                pass
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            # a wedged remote must not leak an ssh process or hang us
            proc.kill()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:  # pragma: no cover - kernel lag
                pass

    def reset(self, *_):
        """Between retries: a failed RPC leaves the pipe desynced, so drop
        the process; the next RPC respawns."""
        self.close(timeout=1.0)

    def __del__(self):  # best-effort; close() is the real API
        try:
            # interpreter shutdown must not stall behind a wedged ssh —
            # give it a moment, then kill
            self.close(timeout=0.5)
        except Exception:  # kart: noqa(KTL006): __del__ at interpreter shutdown — modules may already be torn down; close() is the real API and raises normally
            pass

    # -- framing -------------------------------------------------------------

    def _watchdog_kill(self):
        proc = self._proc
        if proc is not None and proc.poll() is None:
            proc.kill()

    class _TouchReader:
        """File wrapper marking watchdog progress on every completed read,
        so the hung-ssh bound is an *inactivity* timeout over the whole
        response — header AND pack body — not a cap on transfer time."""

        __slots__ = ("_fp", "_wd")

        def __init__(self, fp, wd):
            self._fp = fp
            self._wd = wd

        def read(self, n=-1):
            data = self._fp.read(n)
            self._wd.touch()
            return data

    def _rpc(self, header, objects=(), drain=None):
        """Send one framed request; -> (response header, drain result).
        ``drain(pack_fp)`` consumes the response pack *inside* the
        hung-transport watchdog (re-armed on every read, so a stalled peer
        dies within the budget of its last byte while a slow-but-flowing
        transfer runs to completion); by default the (empty) pack is
        discarded."""
        # trace-context wire field (docs/OBSERVABILITY.md §8): the server
        # adopts this request's id for its spans/access-log lines
        traceparent = rq_context.current_traceparent()
        if traceparent is not None:
            if callable(header):
                inner = header
                header = lambda: {  # noqa: E731 - deferred header, same shape
                    **inner(),
                    rq_context.TRACEPARENT_HEADER: traceparent,
                }
            else:
                header = {
                    **header, rq_context.TRACEPARENT_HEADER: traceparent
                }
        proc = self._ensure()
        try:
            write_framed(proc.stdin, header, objects)
            proc.stdin.flush()
        except (OSError, ValueError) as e:
            raise StdioTransportError(
                f"Transport for {self.url!r} died while sending: {e}",
                transient=True,
            )
        with Watchdog(stdio_timeout(), self._watchdog_kill) as wd:
            guarded = self._TouchReader(proc.stdout, wd)

            def stalled():
                return StdioTransportError(
                    f"Remote {self.url!r} did not respond within "
                    f"{stdio_timeout():.0f}s (killed; set "
                    f"KART_STDIO_TIMEOUT to wait longer)",
                    transient=True,
                )

            try:
                resp, pack_fp = read_framed(guarded)
            except HttpTransportError:
                if wd.fired:
                    raise stalled()
                rc = proc.poll()
                raise StdioTransportError(
                    f"Remote {self.url!r} closed the connection"
                    + (f" (exit code {rc})" if rc is not None else ""),
                    transient=True,
                )
            if "error" in resp:
                # drain the (empty) pack so the pipe stays usable
                for _ in read_pack(pack_fp):
                    pass
                from kart_tpu_torch.transport.protocol import error_attrs_from_wire

                # structured-rejection fields (terminal verdicts, the
                # conflict report, busy pacing) ride the error frame so the
                # ssh transport reports a contended push exactly like HTTP
                raise StdioTransportError(
                    f"Remote {self.url!r} error: {resp['error']}",
                    **error_attrs_from_wire(resp),
                )
            try:
                if drain is None:
                    for _ in read_pack(pack_fp):
                        pass
                    result = None
                else:
                    result = drain(pack_fp)
            except (OSError, ValueError) as e:
                if wd.fired:
                    raise stalled() from e
                raise
        return resp, result

    # -- verbs (HttpRemote-compatible) ---------------------------------------

    def ls_refs(self):
        # one request scope per verb call (retry attempts share the id on
        # the wire — the server logs one logical request, N attempts)
        with rq_context.request_scope(verb="ls-refs"):
            return self.retry.call(
                lambda: self._rpc({"op": "refs"})[0],
                label="ls-refs",
                on_retry=self.reset,
            )

    def fetch_pack(self, dst_repo, wants, *, haves=(), have_shallow=(),
                   depth=None, filter_spec=None, exclude=None):
        from kart_tpu_torch.transport.retry import drain_pack_salvaging, exclude_arg

        received = exclude if isinstance(exclude, set) else set(exclude or ())

        def attempt():
            resp, _ = self._rpc(
                {
                    "op": "fetch-pack",
                    "wants": list(wants),
                    "haves": list(haves),
                    "have_shallow": sorted(have_shallow),
                    "depth": depth,
                    "filter": filter_spec,
                    "exclude": exclude_arg(received),
                },
                drain=lambda fp: drain_pack_salvaging(dst_repo.odb, fp, received),
            )
            return resp

        with rq_context.request_scope(verb="fetch-pack"):
            return self.retry.call(
                attempt, label="fetch-pack", on_retry=self.reset
            )

    def fetch_blobs(self, dst_repo, oids):
        from kart_tpu_torch.transport.retry import drain_pack_salvaging

        received = set()

        def attempt():
            want = [o for o in oids if o not in received]
            if not want:
                return {}
            resp, _ = self._rpc(
                {"op": "fetch-blobs", "oids": want},
                drain=lambda fp: drain_pack_salvaging(dst_repo.odb, fp, received),
            )
            return resp

        with rq_context.request_scope(verb="fetch-blobs"):
            resp = self.retry.call(
                attempt, label="fetch-blobs", on_retry=self.reset
            )
        if resp.get("missing"):
            raise StdioTransportError(
                f"Remote is missing promised objects: {resp['missing'][:5]}"
            )
        return len(received)

    def receive_pack(self, objects, updates, *, shallow=()):
        """Not idempotent: only spawn failures (pre-write — no byte reached
        the server) and the server's paced busy rejections (merge queue
        full / CAS budget exhausted — provably applied nothing) are
        retried; a structured conflict rejection is terminal. -> the full
        receive payload ``{"updated": ..., "rebase": ...}``, like
        HttpRemote."""
        from kart_tpu_torch.transport.retry import is_pre_write

        def retryable(exc):
            return is_pre_write(exc) or getattr(exc, "shed", False)

        def attempt():
            resp, _ = self._rpc(
                lambda: {
                    "op": "receive-pack",
                    "updates": updates,
                    "shallow": sorted(shallow() if callable(shallow) else shallow),
                },
                objects,
            )
            return resp

        with rq_context.request_scope(verb="receive-pack"):
            return self.retry.call(
                attempt, label="receive-pack", retryable=retryable,
                on_retry=self.reset,
            )


# ---------------------------------------------------------------------------
# server side: `kart serve-stdio <path>`
# ---------------------------------------------------------------------------


#: known stdio ops -> the HTTP server's verb labels (one name per verb
#: across transports); anything else books as "other"
_STDIO_VERBS = {
    "refs": "ls-refs",
    "stats": "stats",
    "events": "events",
    "fetch-pack": "fetch-pack",
    "fetch-blobs": "fetch-blobs",
    "receive-pack": "receive-pack",
}


def serve_stdio(repo, in_fp, out_fp, *, device=None):
    """Serve one connection: read framed requests from ``in_fp`` until EOF,
    answer each on ``out_fp``. stdout discipline is absolute — anything else
    the process prints must go to stderr or the frames corrupt.

    Every op runs inside a request scope adopted from the frame's
    ``traceparent`` field (echoed back on the response frame), under a
    ``transport.request`` span, and books one access-log record — the
    stdio server reports requests exactly like the HTTP server. The
    served kernels run on ``device`` (None: the card; ``"cpu"``: the plain
    versions)."""
    from kart_tpu_torch import telemetry as tm
    from kart_tpu_torch.transport.pack import PackFormatError
    from kart_tpu_torch.transport.service import (
        collect_blobs,
        ls_refs_info,
        quarantined_receive,
        serve_fetch_pack,
    )

    # a spawned server honours KART_LOG (stderr only — stdout is frames)
    # and serves its metric registry via the "stats" op
    tm.configure_logging()
    tm.enable(metrics=True)
    in_c = _CountingReader(in_fp)
    out_c = _CountingReader(out_fp)

    while True:
        raw = in_c.read(_HEADER_LEN.size)
        if not raw:
            return  # clean EOF: client closed the connection
        if len(raw) != _HEADER_LEN.size:
            raise StdioTransportError("Truncated request frame")
        (n,) = _HEADER_LEN.unpack(raw)
        if n > 1 << 24:
            raise StdioTransportError("Request header implausibly large")
        try:
            header = json.loads(in_c.read(n).decode())
        except ValueError as e:
            # stream position is unknowable now: answer + close
            write_framed(out_c, {"error": f"Bad request header: {e}"}, ())
            out_c.flush()
            return
        op = header.get("op")
        # access-log/histogram verb labels: known ops map to the HTTP
        # server's names (the "refs" op is the ls-refs verb); anything
        # else is "other" — a client-chosen junk op must not mint
        # unbounded metric label values or write itself into the access
        # log (the HTTP side gets the same from _verb_for)
        verb = _STDIO_VERBS.get(op, "other")

        t0 = time.perf_counter()
        in0, out0 = in_c.count, out_c.count
        status = "ok"
        keep_serving = True
        with rq_context.request_scope(
            verb=verb,
            traceparent=header.get(rq_context.TRACEPARENT_HEADER),
            record=rq_access.slow_threshold() is not None,
            # a frame without a traceparent mints a fresh trace — it must
            # not inherit this process's own CLI root context
            inherit=False,
        ) as ctx:
            # the response frame echoes the context back to the client —
            # both directions of the wire carry the same request id
            echo = {rq_context.TRACEPARENT_HEADER: ctx.traceparent()}

            def respond(frame_header, objects=()):
                if callable(frame_header):
                    inner = frame_header
                    write_framed(
                        out_c, lambda: {**inner(), **echo}, objects
                    )
                else:
                    write_framed(out_c, {**frame_header, **echo}, objects)

            try:
                with tm.span("transport.request", verb=verb):
                    if op == "receive-pack":
                        # the request pack drains into quarantine and
                        # migrates only after checksum + ref preconditions
                        # pass (a torn push leaves the store byte-identical
                        # and desyncs the stream, handled by the
                        # PackFormatError close below); a CAS lost to a
                        # contending writer is auto-rebased server-side,
                        # and a structured rejection's extras ride the
                        # error frame
                        from kart_tpu_torch.transport.protocol import (
                            rejection_wire_fields,
                        )

                        result = quarantined_receive(repo, header, in_c, device=device)
                        if result[0] == "ok":
                            respond(result[1])
                        else:
                            status = result[0]
                            frame = {"error": result[1], "status": result[0]}
                            frame.update(rejection_wire_fields(result))
                            respond(frame)
                    else:
                        # every other op carries an empty request pack
                        for _ in read_pack(in_c):
                            pass
                        if op == "refs":
                            respond(ls_refs_info(repo))
                        elif op == "stats":
                            from kart_tpu_torch.telemetry import sinks

                            tm.incr(
                                "transport.server.requests", verb="stats"
                            )
                            if header.get("format") == "json":
                                import sys as _sys

                                extra = {}
                                query_mod = _sys.modules.get(
                                    "kart_tpu_torch.query"
                                )
                                if query_mod is not None:
                                    extra["query"] = (
                                        query_mod.status_dict()
                                    )
                                respond(
                                    {
                                        "stats": rq_access.stats_payload(
                                            extra=extra
                                        )
                                    }
                                )
                            else:
                                respond({"metrics": sinks.prometheus_text()})
                        elif op == "events":
                            # kart_tpu's stdio twin of GET /api/v1/events:
                            # the feed is not ported
                            tm.incr(
                                "transport.server.requests", verb="events"
                            )
                            status = "error"
                            respond({"error": EVENTS_NOT_PORTED})
                        elif op == "fetch-pack":
                            # same code path and counters as the HTTP
                            # server, but uncached: a serve-stdio process
                            # serves exactly one connection and a client
                            # retry respawns it, so a memo could never be
                            # re-hit. The plan streams straight to the pipe
                            # (no materialise spool — stdio has no
                            # byte-range to serve from an offset)
                            plan = serve_fetch_pack(
                                repo, header, use_cache=False, device=device
                            )
                            respond(plan.header, plan.source)
                        elif op == "fetch-blobs":
                            resp_header, objects = collect_blobs(
                                repo, header.get("oids", [])
                            )
                            respond(resp_header, objects)
                        else:
                            status = "error"
                            respond({"error": f"Unknown op {op!r}"})
            except PackFormatError as e:
                # a corrupt request pack desyncs the stream: answer + close
                status = "error"
                keep_serving = False
                respond({"error": f"Bad request pack: {e}"})
            except Exception as e:
                # op-level failure (bad filter spec, missing object, ...):
                # the request was fully read, so report and keep serving —
                # the HTTP server's 500 equivalent
                status = "error"
                respond({"error": f"{type(e).__name__}: {e}"})
            finally:
                rq_access.record_request(
                    verb=verb,
                    status=status,
                    bytes_in=in_c.count - in0,
                    bytes_out=out_c.count - out0,
                    seconds=time.perf_counter() - t0,
                    ctx=ctx,
                )
        out_c.flush()
        if not keep_serving:
            return
