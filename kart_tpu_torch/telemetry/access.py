"""Per-request observability sinks: the structured access log, the
slow-request exemplar ring, and the windowed rate sampler
(docs/OBSERVABILITY.md §10-§11).

Both transport servers funnel every finished request through
:func:`record_request`, which in one place:

* observes the per-verb latency histogram ``server.request_seconds{verb=}``
  (bucketed — the server can report its own p50/p99, not just count/sum),
* appends one JSON line to the access log when ``KART_ACCESS_LOG`` names a
  file — request id, trace id, verb, status, bytes, latency, and the
  decision annotations the handlers attached (shed, cache hit, rebase),
* captures a **slow-request exemplar** when the latency crosses
  ``KART_SLOW_REQUEST_SECONDS``: the request's recorded span tree joins a
  ring of the last :data:`EXEMPLAR_RING` slow requests (served via
  ``/api/v1/stats?format=json`` and written into the access-log line), so
  one p99 outlier in a storm is explainable after the fact without tracing
  everything,
* samples the counter registry into a time ring so the stats payload can
  expose **rates** (requests/s, tiles/s) over the ``KART_STATS_WINDOWS``
  windows (default 10s and 60s) — what ``kart top`` renders.

Everything here is per *request*, never per row; with none of the env
switches set the only residual cost is one histogram observation and a
time-gated counter-dict copy per request.
"""

import json
import logging
import os
import threading
import time
from collections import deque

from kart_tpu_torch.telemetry import context
from kart_tpu_torch.telemetry import core as tm

L = logging.getLogger("kart_tpu_torch.telemetry.access")

#: how many slow-request exemplars the ring keeps (newest wins)
EXEMPLAR_RING = 16

#: default rate windows (seconds) when KART_STATS_WINDOWS is unset
DEFAULT_WINDOWS = (10.0, 60.0)

#: minimum spacing between counter-ring samples; also bounds ring growth
_SAMPLE_MIN_INTERVAL = 1.0
_SAMPLE_RING_MAX = 256

_lock = threading.Lock()
_exemplars = deque(maxlen=EXEMPLAR_RING)
_samples = deque(maxlen=_SAMPLE_RING_MAX)  # (monotonic_ts, counters dict)
_last_sample = [0.0]
#: separate lock for the access-log file append: log I/O (possibly a slow
#: filesystem) must never serialise the exemplar ring or the rate sampler
#: that the stats endpoint reads under ``_lock``
_log_lock = threading.Lock()
_log_files = {}  # path -> cached append handle (one open per path, not
                 # three syscalls per request; closed by reset())
_log_warned = [False]


def slow_threshold(environ=os.environ):
    """Seconds past which a request dumps its span tree as an exemplar, or
    None when disabled (unset / unparseable / <= 0)."""
    raw = environ.get("KART_SLOW_REQUEST_SECONDS", "")
    try:
        value = float(raw)
    except (TypeError, ValueError):
        return None
    return value if value > 0 else None


def access_log_path(environ=os.environ):
    """The JSON-lines access log file, or None when disabled."""
    return environ.get("KART_ACCESS_LOG") or None


def stats_windows(environ=os.environ):
    """The rate windows (seconds, ascending) from ``KART_STATS_WINDOWS``
    (comma-separated seconds, e.g. ``10,60,300``)."""
    raw = environ.get("KART_STATS_WINDOWS", "")
    windows = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            value = float(part)
        except ValueError:
            continue
        if value > 0:
            windows.append(value)
    return tuple(sorted(windows)) or DEFAULT_WINDOWS


def reset():
    """Clear the exemplar ring, rate samples and cached log handles
    (tests; fork children)."""
    with _lock:
        _exemplars.clear()
        _samples.clear()
        _last_sample[0] = 0.0
    with _log_lock:
        for f in _log_files.values():
            try:
                f.close()
            except OSError:
                pass  # a dead handle has nothing left to flush
        _log_files.clear()
        _log_warned[0] = False


def _maybe_sample(now=None, counters=None):
    """Append a counter-registry sample to the rate ring, time-gated so a
    storm costs one dict copy per second, not per request. ``counters``:
    a registry snapshot the caller already took (avoids a second copy)."""
    now = time.monotonic() if now is None else now
    with _lock:
        if now - _last_sample[0] < _SAMPLE_MIN_INTERVAL:
            return
        _last_sample[0] = now
        _samples.append(
            (now, counters if counters is not None else tm.counters_snapshot())
        )


def record_request(*, verb, status=None, bytes_in=0, bytes_out=0, seconds,
                   ctx=None):
    """Book one finished server request: latency histogram, access-log
    line, slow-request exemplar, rate sample. -> the access record dict
    (annotated; tests and the stdio server reuse it)."""
    ctx = ctx if ctx is not None else context.current()
    tm.observe("server.request_seconds", seconds, verb=verb)
    record = {
        "ts": round(time.time(), 3),
        "verb": verb,
        "status": status,
        "bytes_in": int(bytes_in or 0),
        "bytes_out": int(bytes_out or 0),
        "seconds": round(seconds, 6),
    }
    if ctx is not None:
        record["request_id"] = ctx.request_id
        record["trace_id"] = ctx.trace_id
        for k, v in ctx.baggage.items():
            if k != "verb":
                record[k] = v
        if ctx.annotations:
            record.update(ctx.annotations)
    threshold = slow_threshold()
    if threshold is not None and seconds >= threshold:
        record["slow"] = True
        tm.incr("server.slow_requests", verb=verb)
        exemplar = dict(record)
        exemplar["spans"] = ctx.span_tree() if ctx is not None else []
        if ctx is not None and ctx.events_dropped:
            exemplar["spans_dropped"] = ctx.events_dropped
        with _lock:
            _exemplars.append(exemplar)
        record["spans"] = exemplar["spans"]
    _maybe_sample()
    path = access_log_path()
    if path:
        line = json.dumps(record, default=str)
        try:
            with _log_lock:
                f = _log_files.get(path)
                if f is None:
                    # ownership lives in the module cache: the handle is
                    # deliberately long-lived (one open per path, not three
                    # syscalls per request) and closed by reset()
                    _log_files[path] = open(path, "a")  # kart: noqa(KTL004): process-lifetime cached append handle, closed in reset() and dropped+reopened on write failure
                    f = _log_files[path]
                f.write(line + "\n")
                f.flush()
        except OSError as e:
            # the access log is best-effort (serving must not die for it)
            # but a misconfigured path is reported, once; the handle is
            # dropped so a repaired path reopens cleanly
            with _log_lock:
                _log_files.pop(path, None)
                warn = not _log_warned[0]
                _log_warned[0] = True
            if warn:
                L.warning("access log %s not writable: %s", path, e)
    return record


def exemplars():
    """The slow-request exemplar ring, oldest first."""
    with _lock:
        return list(_exemplars)


def window_rates(now=None):
    """Per-counter rates over each configured window: ``{"10s": [[name,
    labels, rate], ...], ...}``. Computed against a fresh registry read, so
    an idle server's rates decay to zero between requests."""
    now = time.monotonic() if now is None else now
    current = tm.counters_snapshot()
    _maybe_sample(now, counters=current)
    with _lock:
        samples = list(_samples)
    rates = {}
    for window in stats_windows():
        floor = now - window
        base = None
        # the oldest sample still inside the window; an empty/young ring
        # falls back to the oldest sample we have (rate over actual span)
        for ts, snap in samples:
            if ts >= floor:
                base = (ts, snap)
                break
        if base is None and samples:
            base = samples[0]
        key = f"{window:g}s"
        if base is None or now - base[0] <= 0:
            rates[key] = []
            continue
        elapsed = now - base[0]
        entries = []
        for (name, labels), value in sorted(current.items()):
            delta = value - base[1].get((name, labels), 0)
            if delta > 0:
                entries.append([name, dict(labels), round(delta / elapsed, 4)])
        rates[key] = entries
    return rates


def stats_payload(extra=None):
    """The JSON stats document (``/api/v1/stats?format=json``; the stdio
    ``stats`` op's ``format: "json"``): the metric snapshot with bucketed
    histograms + quantiles, windowed rates, the slow-request exemplar
    ring, and the trace-buffer drop count. ``kart top`` renders this."""
    payload = {
        "snapshot": tm.snapshot(),
        "rates": window_rates(),
        "exemplars": exemplars(),
        "events_dropped": tm.events_dropped_count(),
        "windows": list(stats_windows()),
    }
    if extra:
        payload.update(extra)
    return payload
