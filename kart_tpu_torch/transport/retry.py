"""Fault tolerance for the wire transports: retry with capped exponential
backoff, transient-error classification, and the salvaging pack drain that
makes fetch resumable.

The reference inherits all of this from git (curl retries, packfile
quarantine, ``http.lowSpeedLimit``); our native transports implement the
same production posture directly:

* **RetryPolicy** — attempts / base-delay / cap, configured per remote
  (``remote.<name>.retries`` etc.), globally via env, or per client. Only
  *idempotent* verbs (``ls_refs``, ``fetch_pack``, ``fetch_blobs``) retry
  automatically; ``receive_pack`` retries only on pre-write failures (the
  connection was never established, so the server saw nothing).
* **Transient classification** — connection-level failures (OSError,
  injected faults, torn packstreams) are retryable; server-reported op
  errors (bad filter spec, CAS conflict, HTTP status errors) are not.
  Errors carry an optional ``transient`` attribute that overrides the
  class-based default, and ``pre_write=True`` marks failures that provably
  happened before any request byte reached the server. ``terminal=True``
  marks an application-level final verdict (a structured merge-conflict
  rejection) that no retryable predicate may override — see
  :func:`is_terminal`.
* **drain_pack_salvaging** — objects are content-addressed and each pack
  record is individually length/zlib-checked, so everything received before
  a disconnect is durable: on a torn stream the partial pack is *finalised*
  (not discarded) and the error re-raised. A retry then excludes the
  salvaged oids from the re-negotiation and the server ships only the
  remainder.

Counterpart of kart_tpu's ``transport/retry.py``: the same environment and
config keys.
"""

import logging
import os
import time

from kart_tpu_torch import telemetry as tm
from kart_tpu_torch.transport.pack import PackFormatError, read_pack

L = logging.getLogger("kart_tpu_torch.transport.retry")

#: largest oid-exclusion list a resuming fetch sends; beyond this the tail
#: is simply not excluded (exclusions are an optimisation — dropping some
#: re-transfers a little, never corrupts) so request headers stay bounded
#: (the stdio server caps request headers at 16MB).
EXCLUDE_CAP = 100_000

#: ceiling on how far a server-sent Retry-After may stretch one backoff
#: sleep: the header is honoured as a *floor* on the computed exponential
#: delay (a shedding server knows its own recovery horizon better than our
#: guess), but a hostile/buggy header must not park a client for an hour.
RETRY_AFTER_CAP = 60.0


def is_transient(exc):
    """Should a bounded retry be attempted after ``exc``?

    An explicit ``transient`` attribute wins; otherwise OS-level errors and
    torn packstreams are transient, everything else (server-reported op
    errors, protocol violations) is not."""
    t = getattr(exc, "transient", None)
    if t is not None:
        return bool(t)
    return isinstance(exc, (OSError, PackFormatError))


def is_pre_write(exc):
    """True when the failure provably happened before any request byte
    reached the server (e.g. TCP connect refused, spawn failure) — the only
    failures a non-idempotent verb may retry."""
    return bool(getattr(exc, "pre_write", False))


def is_terminal(exc):
    """True for an application-level *final* verdict — the server examined
    the request and rejected it deterministically (the structured
    merge-conflict report of a contended push: a human must resolve it).
    Terminal errors are never retried, whatever the per-verb ``retryable``
    predicate says: a blind re-push of the same commits is guaranteed to
    conflict again, and that retry amplification is exactly the failure
    mode the server-side rebase exists to remove (docs/SERVING.md §6)."""
    return bool(getattr(exc, "terminal", False))


def _env_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class RetryPolicy:
    """Capped exponential backoff: attempt *k* failing transiently sleeps
    ``min(max_delay, base_delay * 2**(k-1))`` before attempt *k+1*, up to
    ``attempts`` total attempts. ``sleep`` is injectable for tests."""

    def __init__(self, attempts=3, base_delay=0.2, max_delay=10.0, sleep=time.sleep):
        self.attempts = max(1, int(attempts))
        self.base_delay = max(0.0, float(base_delay))
        self.max_delay = max(0.0, float(max_delay))
        self.sleep = sleep

    @classmethod
    def from_config(cls, config=None, remote_name=None):
        """Resolve the policy for a remote: env (operational override) >
        ``remote.<name>.*`` config > defaults.

        Config keys: ``remote.<name>.retries``, ``.retrybasedelay``,
        ``.retrymaxdelay``. Env: ``KART_TRANSPORT_RETRIES``,
        ``KART_TRANSPORT_RETRY_BASE``, ``KART_TRANSPORT_RETRY_CAP``."""
        attempts, base, cap = 3, 0.2, 10.0
        if config is not None and remote_name is not None:
            prefix = f"remote.{remote_name}."
            try:
                attempts = config.get_int(prefix + "retries", attempts)
                base = float(config.get(prefix + "retrybasedelay", base))
                cap = float(config.get(prefix + "retrymaxdelay", cap))
            except (TypeError, ValueError):
                pass
        attempts = _env_int("KART_TRANSPORT_RETRIES", attempts)
        base = _env_float("KART_TRANSPORT_RETRY_BASE", base)
        cap = _env_float("KART_TRANSPORT_RETRY_CAP", cap)
        return cls(attempts, base, cap)

    def delay_for(self, attempt):
        """Backoff before attempt ``attempt + 1`` (1-based attempts)."""
        return min(self.max_delay, self.base_delay * (2 ** (attempt - 1)))

    def call(self, fn, *, retryable=is_transient, label="", on_retry=None):
        """Run ``fn()`` with up to ``attempts`` tries. ``retryable(exc)``
        gates each retry; ``on_retry(exc, attempt)`` runs before the backoff
        sleep (transports use it to reset a desynced connection)."""
        for attempt in range(1, self.attempts + 1):
            try:
                return fn()
            except Exception as e:
                # a terminal verdict outranks every retryable classification
                # — "conflicts, human required" must surface exactly once,
                # while "CAS lost, server still rebasing" stays in the
                # paced-retry lane below
                if attempt >= self.attempts or is_terminal(e) or not retryable(e):
                    raise
                delay = self.delay_for(attempt)
                # a server-sent Retry-After (the 429/503 shedding path) is
                # the backoff floor — capped, and never *lowering* a larger
                # exponential delay
                retry_after = getattr(e, "retry_after", None)
                try:
                    retry_after = float(retry_after)
                except (TypeError, ValueError):
                    retry_after = None
                if retry_after is not None and retry_after > 0:
                    floored = max(delay, min(retry_after, RETRY_AFTER_CAP))
                    if floored > delay:
                        tm.incr("transport.retry_after_honoured")
                    delay = floored
                tm.incr("transport.retries", verb=label or "operation")
                tm.incr("transport.backoff_seconds", delay)
                # the retry ladder joins the request's trace: all attempts
                # run inside one verb scope (one request id on the wire)
                # and the warning below carries it as rid= — the server's
                # access log shows one logical request with N attempts
                L.warning(
                    "transport %s failed (%s: %s); retrying %d/%d in %.2fs",
                    label or "operation",
                    type(e).__name__,
                    e,
                    attempt,
                    self.attempts - 1,
                    delay,
                )
                if on_retry is not None:
                    on_retry(e, attempt)
                if delay > 0:
                    self.sleep(delay)


def drain_pack_salvaging(odb, pack_fp, received=None, *, mid_stream=False,
                         commit=None):
    """Drain a kartpack stream into ``odb`` as one new pack, *keeping* what
    arrived if the stream tears.

    Every record is individually zlib- and length-verified by
    ``read_pack``, and oids are recomputed from content on write, so the
    objects landed before a disconnect are exactly as trustworthy as a
    complete transfer's — the stream checksum trailer only guards the
    record *framing* we already re-derive. On any failure the partial pack
    is finalised (fsck-clean, immediately readable) and the error
    re-raised; ``received`` (if given) accumulates the hex oids written so
    a retry can exclude them from re-negotiation.

    ``mid_stream=True`` consumes a byte-range-resumed stream (starts at a
    record boundary, not the magic); ``commit(pack_bytes)`` (if given) is
    called each time a run of records has landed in the writer, with the
    exact pack-stream bytes consumed through the last *written* record —
    the range-resume path derives its next ``Range:`` offset from it, so a
    resume can never skip a record that was read but still buffered when
    the stream tore.

    Records are written in same-type runs through the writer's batched
    path (one native hash+deflate+frame call per run) — at clone scale the
    per-object Python of ``PackWriter.add`` dominated the whole drain.
    Runs are bounded (count and bytes) so a tear forfeits at most one
    run's worth of already-verified records.

    -> number of objects written this drain."""
    w = odb.pack_writer()
    count = 0
    run_type = None
    run = []  # contents of the current same-type run
    run_bytes = 0
    consumed = [0]   # stream offset after the last record *read*
    run_end = 0      # stream offset after the last record in `run`

    def flush():
        nonlocal count, run, run_bytes
        if not run:
            return
        oids = w.add_batch(run_type, run)
        count += len(run)
        if received is not None:
            received.update(oids)
        run = []
        run_bytes = 0
        if commit is not None:
            commit(run_end)

    try:
        with tm.span("transport.pack_drain"):
            for obj_type, content in read_pack(
                pack_fp, mid_stream=mid_stream, consumed=consumed
            ):
                if (
                    obj_type != run_type
                    or len(run) >= _DRAIN_RUN_OBJECTS
                    or run_bytes >= _DRAIN_RUN_BYTES
                ):
                    flush()
                    run_type = obj_type
                run.append(content)
                run_bytes += len(content)
                run_end = consumed[0]
            flush()
    except BaseException:
        try:
            flush()  # the tail run is fully verified — salvage it too
        except Exception:
            L.warning("drain salvage: tail run write failed; kept %d", count)
        tm.incr("transport.salvage_events")
        tm.incr("transport.objects_salvaged", count)
        try:
            if w.finish() is not None:
                odb.packs.refresh()
        except Exception:
            w.abort()
        raise
    tm.incr("transport.objects_received", count)
    if w.finish() is not None:
        odb.packs.refresh()
    return count


#: drain run bounds: big enough that the native batch call amortises the
#: per-call overhead, small enough that a tear forfeits little and huge
#: blobs can't balloon the buffered run
_DRAIN_RUN_OBJECTS = 4096
_DRAIN_RUN_BYTES = 8 << 20


def exclude_arg(received):
    """The ``exclude`` list a resuming fetch sends: sorted for determinism,
    capped so request headers stay bounded (see EXCLUDE_CAP)."""
    if not received:
        return []
    out = sorted(received)
    return out[:EXCLUDE_CAP]
