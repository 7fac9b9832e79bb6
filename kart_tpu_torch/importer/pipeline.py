"""The pipelined import: source read + encode, hash + deflate + framing,
and the pack append run on threads of their own, joined by bounded
order-preserving queues, so that the import's wall time approaches its
slowest stage instead of the sum of all four.

    [read+encode] --q--> [hash] --q--> [pack] --q--> caller

* read+encode pulls source batches and encodes them: for an int-pk GPKG
  one native call a batch steps the SELECT and encodes its rows without
  the GIL (``GPKGImportSource.native_encoded_batches``); other sources run
  the Python encoder. Read and encode share a thread on purpose: both are
  GIL-bound in the Python route, so a split buys no overlap.
* hash is one native call a batch (``native.pack_records_base`` /
  ``pack_records_batch``): SHA-1, deflate and pack-record framing, with
  the GIL released.
* pack appends the framed buffer to the bulk pack and books its idx
  entries (``PackWriter.append_framed``), the only thread that touches the
  writer while the stream runs.
* the caller collects the (pk, oid) columns in stream order.

Each queue holds ``KART_IMPORT_QUEUE_BATCHES`` batches (default 4) of
``KART_IMPORT_BATCH_ROWS`` rows (default 65,536), which bounds the memory
a fast reader can fill.

The stages are deterministic and the queues keep order, so the pipelined
route writes the serial route's objects and root tree. The first stage
error sets the shared stop flag, every thread drains, and the error is
raised again on the caller's thread, so the enclosing ``odb.bulk_pack``
aborts with a quiesced writer: only ``.tmp-pack-*`` debris is left, and
HEAD is untouched.

Counterpart of kart_tpu's ``importer/pipeline.py``. kart_tpu's telemetry
spans and its ``import.encode`` and ``import.pack_stream`` fault points
are not ported yet.
"""

import os
import queue
import threading
import time

from kart_tpu_torch import faults

#: below this many features, starting threads and queue hops cost more
#: than the overlap gains
PIPELINE_MIN_FEATURES = 16384

_DEFAULT_QUEUE_BATCHES = 4
_DEFAULT_BATCH_ROWS = 65536

_DONE = object()
#: the end of the feature stream only, with a side channel open: the stage
#: keeps serving side items until _DONE arrives there
_FEAT_DONE = object()


def pipeline_mode():
    """``KART_IMPORT_PIPELINE``: unset or ``auto`` -> by size, ``0`` ->
    never, ``1``/``force`` -> always (tiny imports too)."""
    raw = (os.environ.get("KART_IMPORT_PIPELINE") or "").strip().lower()
    if raw in ("0", "off", "no"):
        return "off"
    if raw in ("1", "force", "always"):
        return "force"
    return "auto"


def queue_batches():
    """The bound, in batches, of each queue between stages."""
    raw = os.environ.get("KART_IMPORT_QUEUE_BATCHES")
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            pass
    return _DEFAULT_QUEUE_BATCHES


def batch_rows():
    """Rows a producer batch (``KART_IMPORT_BATCH_ROWS``, at least 1024)."""
    raw = os.environ.get("KART_IMPORT_BATCH_ROWS")
    if raw:
        try:
            return max(1024, int(raw))
        except ValueError:
            pass
    return _DEFAULT_BATCH_ROWS


def native_read_capable(source, encoder):
    """True when ``source`` feeds the pipeline's native fused read +
    encode: an int-pk dataset from a source with ``native_encoded_batches``,
    and neither ``KART_IMPORT_NATIVE_READ=0`` nor ``KART_IMPORT_FAST=0``.
    The router then prefers the pipeline to the process fan-out."""
    if encoder.scheme != "int":
        return False
    if getattr(source, "native_encoded_batches", None) is None:
        return False
    if os.environ.get("KART_IMPORT_NATIVE_READ") == "0":
        return False
    return os.environ.get("KART_IMPORT_FAST") != "0"


class _PipelineState:
    """The stop flag and the first error, shared by the stage threads."""

    def __init__(self):
        self.stop = threading.Event()
        self._err_lock = threading.Lock()
        self.error = None

    def fail(self, exc):
        with self._err_lock:
            if self.error is None:
                self.error = exc
        self.stop.set()


def _put(q, item, state):
    """A bounded put that never blocks a stopping pipeline."""
    while not state.stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            continue
    return False


def _get(q, state):
    """-> the next item, or _DONE once the pipeline stops."""
    while not state.stop.is_set():
        try:
            return q.get(timeout=0.05)
        except queue.Empty:
            continue
    return _DONE


class _Stage(threading.Thread):
    """One stage: ``fn`` of every upstream item, in order; the read stage
    (``source`` instead of ``in_q``) drains an iterator, its pulls counted
    as busy time."""

    def __init__(self, name, state, fn=None, source=None, in_q=None, out_q=None, side_q=None,
                 end=_DONE):
        super().__init__(name=f"kart-import-{name}", daemon=True)
        self.stage_name = name
        self.state = state
        self.fn = fn
        self.source = source
        self.in_q = in_q
        self.out_q = out_q
        # unbounded on purpose: a bounded put from the consumer would close
        # a cycle of queues and could deadlock
        self.side_q = side_q
        self.end = end
        self.busy_s = 0.0
        self.fault_hook = None  # a faults.hook, counted once an item

    def _timed(self, thunk):
        t0 = time.perf_counter()
        out = thunk()
        self.busy_s += time.perf_counter() - t0
        return out

    def _run_read(self):
        state = self.state
        it = iter(self.source)
        fault = self.fault_hook
        try:
            while not state.stop.is_set():
                try:
                    item = self._timed(lambda: next(it))
                except StopIteration:
                    break
                if fault is not None:
                    fault()
                if not _put(self.out_q, item, state):
                    return
            _put(self.out_q, self.end, state)
        finally:
            # an aborted pipeline leaves the producer mid-stream: close it
            # (its source connection) on the thread that drove it
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def _run_apply(self):
        state = self.state
        fault = self.fault_hook
        feat_done = False
        while True:
            item = None
            if self.side_q is not None and not feat_done:
                # injected work first: its results unblock the consumer
                try:
                    item = self.side_q.get_nowait()
                except queue.Empty:
                    item = None
            if item is None:
                item = _get(self.side_q if feat_done else self.in_q, state)
            if item is _DONE:
                break
            if item is _FEAT_DONE:
                # the features ended; the consumer may still inject, and
                # answers with _DONE on the side channel
                if not _put(self.out_q, _FEAT_DONE, state):
                    return
                if self.side_q is not None:
                    feat_done = True
                continue
            if fault is not None:
                fault()
            out = self._timed(lambda: self.fn(item))
            if not _put(self.out_q, out, state):
                return
        _put(self.out_q, _DONE, state)

    def run(self):
        try:
            if self.in_q is None:
                self._run_read()
            else:
                self._run_apply()
        except BaseException as exc:  # raised again on the caller's thread
            self.state.fail(exc)


def run_pipeline(read_iter, stages, consume, *, side_stage=None, on_feat_done=None):
    """Drive the pipeline: ``read_iter``'s batches flow through each
    ``(name, fn)`` stage on a thread of its own, and ``consume(result)``
    runs on this thread in stream order. -> {stage name: busy seconds},
    the producer's under ``"produce"``.

    ``side_stage`` opens an unbounded channel into the named stage:
    ``consume`` then gets an ``inject(item)`` second argument that pushes
    work through that stage and the ones after it (the streamed leaf
    trees). Shutdown is then two-phase: once the end of the features
    reaches this thread, ``on_feat_done(inject)`` may inject the last
    items, then the side channel closes and the stages drain.

    Raises the first stage error here, after every stage thread has
    drained, so that the caller's cleanup (the bulk pack's abort) sees a
    quiet writer."""
    state = _PipelineState()
    cap = queue_batches()
    side_q = queue.Queue() if side_stage is not None else None
    prev_q = queue.Queue(maxsize=cap)
    read = _Stage("produce", state, source=read_iter, out_q=prev_q,
                  end=_FEAT_DONE if side_q is not None else _DONE)
    read.fault_hook = faults.hook("import.encode")
    threads = [read]
    for name, fn in stages:
        out_q = queue.Queue(maxsize=cap)
        stage = _Stage(name, state, fn=fn, in_q=prev_q, out_q=out_q,
                       side_q=side_q if name == side_stage else None)
        if name == "pack":
            stage.fault_hook = faults.hook("import.pack_stream")
        threads.append(stage)
        prev_q = out_q
    for t in threads:
        t.start()

    def inject(item):
        side_q.put(item)  # unbounded: never blocks the consuming thread

    try:
        while True:
            item = _get(prev_q, state)
            if item is _DONE:
                break
            if item is _FEAT_DONE:
                if on_feat_done is not None:
                    on_feat_done(inject)
                side_q.put(_DONE)
                continue
            if side_q is not None:
                consume(item, inject)
            else:
                consume(item)
    except BaseException as exc:  # raised again below, once the stages drained
        state.fail(exc)
    finally:
        # the stop flag unblocks every stage's put and get; the joins are
        # bounded so that a wedged stage cannot hang the import
        for t in threads:
            t.join(timeout=10.0)
    if state.error is not None:
        raise state.error
    return {t.stage_name: t.busy_s for t in threads}
