"""Batch tile export: walk a zoom pyramid over a dataset's extent and write
every non-empty tile payload to disk (``kart export tiles``).

The tile cover is enumerated once (the addresses over the dataset's
envelope only, in z, x, y order), cut into batches of
``KART_EXPORT_BATCH_TILES`` tiles, and the batches are encoded

* in this process, each batch's projection through the backend seam
  (:func:`kart_tpu_torch.diff.backend.project_envelopes`): one K7 launch a
  batch with a tile to write on the card, numpy with ``--device cpu``.
  This is the default on the card;
* or by a pool of worker processes, each with its own mmap'd
  :class:`~kart_tpu_torch.tiles.source.TileSource`, projecting with numpy:
  the default with ``--device cpu`` (kart_tpu's rule: the core count on a
  box of 4 or more), or whenever ``--workers`` or ``KART_EXPORT_WORKERS``
  asks for more than one.

Either way an ordered writer consumes the batches in enumeration order;
each file lands by rename as ``<out>/<z>/<x>/<y>.ktile`` (the whole framed
payload). The bytes are the same whatever the route or worker count. A
tile over the feature ceiling is skipped and recorded (``tiles_skipped``).

The pool's processes come from a ``forkserver``: a process that holds a
CUDA context and PyTorch's threads is not forked, and the workers run
numpy only. The server imports this module and the caller's main module
once; each worker then forks from it, takes the caller's environment (the server's may be older, and
the payload knobs are read from it) and opens its own source. The server
and the resource tracker that a pool starts are stopped when it ends, so
an export leaves no process behind it.

Counterpart of kart_tpu's ``tiles/pyramid.py``, whose pool forks the
caller directly; the files and stats are the same. kart_tpu pools by
default whatever its device, so on the card the stats' worker count (1
here) is the one field that differs from it.
"""

import contextlib
import hashlib
import multiprocessing
import os
from collections import deque

import numpy as np

from kart_tpu_torch import faults, runtime
from kart_tpu_torch.tiles.encode import _env_int, encode_tile_batch
from kart_tpu_torch.tiles.grid import DEFAULT_BUFFER, DEFAULT_EXTENT, tile_range_for_bbox

#: tiles an encode batch (``KART_EXPORT_BATCH_TILES`` overrides)
DEFAULT_BATCH_TILES = 64


def export_workers(on_card=False):
    """The pool's worker count: ``KART_EXPORT_WORKERS`` when set (1 runs in
    this process, through the device seam), else 1 ``on_card`` (K7
    projects in this process), else the core count on a box of 4 cores or
    more, else 1."""
    configured = _env_int("KART_EXPORT_WORKERS", 0)
    if configured > 0:
        return configured
    if on_card:
        return 1
    cores = os.cpu_count()
    if cores is None or cores < 4:
        return 1
    return cores


def export_batch_tiles():
    return max(1, _env_int("KART_EXPORT_BATCH_TILES", DEFAULT_BATCH_TILES))


def dataset_bbox_wsen(source):
    """The dataset's (w, s, e, n) envelope from its block aggregates (else
    its envelope column); a wrapping or non-finite member widens the
    longitudes to the whole world."""
    blocks = source.env_blocks()
    if blocks is not None:
        env = np.asarray(blocks[0], dtype=np.float64)
    else:
        env = np.asarray(source.envelopes(), dtype=np.float64)
    if not len(env):
        return (-180.0, -90.0, 180.0, 90.0)
    bad = ~np.isfinite(env).all(axis=1) | (env[:, 2] < env[:, 0])
    if bad.any():
        w, e = -180.0, 180.0
    else:
        w, e = float(env[:, 0].min()), float(env[:, 2].max())
    lat = env[np.isfinite(env[:, 1]) & np.isfinite(env[:, 3])]
    if len(lat):
        s, n = float(lat[:, 1].min()), float(lat[:, 3].max())
    else:
        s, n = -90.0, 90.0
    return (max(w, -180.0), max(s, -90.0), min(e, 180.0), min(n, 90.0))


def tile_cover(source, zooms):
    """The export's tile addresses, lazily, in z, x, y order: every (z, x, y)
    over the dataset envelope."""
    bbox = dataset_bbox_wsen(source)
    for z in zooms:
        x0, y0, x1, y1 = tile_range_for_bbox(z, bbox)
        for x in range(x0, x1 + 1):
            for y in range(y0, y1 + 1):
                yield (z, x, y)


def cover_size(source, zooms):
    """How many addresses :func:`tile_cover` yields, by arithmetic."""
    bbox = dataset_bbox_wsen(source)
    total = 0
    for z in zooms:
        x0, y0, x1, y1 = tile_range_for_bbox(z, bbox)
        total += (x1 - x0 + 1) * (y1 - y0 + 1)
    return total


def tree_digest(out_dir):
    """sha256 over an exported pyramid's sorted relative paths and file
    bytes: the definition of a byte-identical pyramid."""
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(out_dir)):
        dirnames.sort()
        for name in sorted(filenames):
            p = os.path.join(dirpath, name)
            h.update(os.path.relpath(p, out_dir).encode())
            with open(p, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def batched(iterable, size):
    """Lists of ``size`` items (the last one shorter) from ``iterable``."""
    batch = []
    for item in iterable:
        batch.append(item)
        if len(batch) >= size:
            yield batch
            batch = []
    if batch:
        yield batch


# ---------------------------------------------------------------------------
# the pool's workers: each opens the repository and builds its own mmap'd
# source; only addresses and payload bytes cross the pipe
# ---------------------------------------------------------------------------

_WORKER = {}


def _pool_init(repo_path, commit_oid, ds_path, environ):
    from kart_tpu_torch.core.repo import KartRepo
    from kart_tpu_torch.tiles.source import source_for

    # the caller's environment (the payload knobs among it), not the one the
    # fork server started with
    os.environ.clear()
    os.environ.update(environ)
    _WORKER["source"] = source_for(KartRepo(repo_path), commit_oid, ds_path)


def _pool_encode(args):
    addresses, layers, extent, buffer, max_features = args
    return encode_tile_batch(_WORKER["source"], addresses, layers=layers, extent=extent,
                             buffer=buffer, max_features=max_features, allow_device=False)


def _pool_context():
    ctx = multiprocessing.get_context("forkserver")
    # the server imports the caller's main module and this one once; a
    # worker forked from it then skips both imports
    ctx.set_forkserver_preload(["__main__", __name__])
    return ctx


@contextlib.contextmanager
def _pool_processes():
    """Stop, on the way out, the fork server and the resource tracker that
    a pool starts meanwhile; either one already running is the caller's
    and stays. Both would otherwise outlive the pool until this process
    exits, and linger for a moment after it."""
    from multiprocessing import forkserver, resource_tracker

    server, tracker = forkserver._forkserver, resource_tracker._resource_tracker
    had_server = server._forkserver_pid is not None
    had_tracker = tracker._pid is not None
    try:
        yield
    finally:
        # the server holds the tracker's pipe, so it goes first
        if not had_server:
            server._stop()
        if not had_tracker:
            tracker._stop()


def export_pyramid(source, zooms, out_dir, *, layers=None, extent=DEFAULT_EXTENT,
                   buffer=DEFAULT_BUFFER, max_features=None, progress=None, workers=None,
                   batch_tiles=None, device=None):
    """Export every non-empty tile of ``source`` at ``zooms``. In-process
    batches project on ``device`` (None: the card, K7; ``"cpu"``: numpy);
    the pool's workers project with numpy. ``workers`` None:
    :func:`export_workers` for the device.

    -> stats: ``tiles_written``, ``tiles_empty``, ``tiles_too_large`` (and
    ``tiles_skipped``, their addresses), ``features_out``, ``bytes_out``
    and ``export_workers``. ``progress(z, x, y, status)`` is called for
    each tile visited."""
    from concurrent.futures import ProcessPoolExecutor

    if workers is None:
        workers = export_workers(on_card=runtime.resolve_device(device).type == "cuda")
    batch = batch_tiles if batch_tiles is not None else export_batch_tiles()
    total = cover_size(source, zooms)
    batches = batched(tile_cover(source, zooms), batch)
    # a worker rebuilds its source cheaply only from a sidecar's envelope
    # column: a fallback source would repeat its blob scan in every worker
    use_pool = workers > 1 and total > batch and source.block.envelopes is not None
    stats = {
        "tiles_written": 0,
        "tiles_empty": 0,
        "tiles_too_large": 0,
        "tiles_skipped": [],
        "features_out": 0,
        "bytes_out": 0,
        "export_workers": workers if use_pool else 1,
    }

    def consume(batch_addresses, results):
        faults.fire("tiles.export")  # batch boundary
        for (z, x, y), (status, payload, count) in zip(batch_addresses, results):
            if status == "empty":
                stats["tiles_empty"] += 1
            elif status == "too_large":
                stats["tiles_too_large"] += 1
                stats["tiles_skipped"].append((z, x, y))
            else:
                z_dir = os.path.join(out_dir, str(z), str(x))
                os.makedirs(z_dir, exist_ok=True)
                path = os.path.join(z_dir, f"{y}.ktile")
                tmp = path + f".tmp{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(payload)
                os.replace(tmp, path)
                stats["tiles_written"] += 1
                stats["features_out"] += count
                stats["bytes_out"] += len(payload)
            if progress is not None:
                progress(z, x, y, status if status != "ok" else "written")

    if use_pool:
        repo_path = source.repo.workdir or source.repo.gitdir
        with _pool_processes(), ProcessPoolExecutor(
                max_workers=workers, mp_context=_pool_context(), initializer=_pool_init,
                initargs=(repo_path, source.commit_oid, source.ds_path,
                          dict(os.environ))) as pool:
            # a bounded window of batches in flight, consumed strictly in order
            window = deque()
            for b in batches:
                window.append((b, pool.submit(_pool_encode,
                                              (b, layers, extent, buffer, max_features))))
                if len(window) >= workers * 2:
                    done_batch, fut = window.popleft()
                    consume(done_batch, fut.result())
            while window:
                done_batch, fut = window.popleft()
                consume(done_batch, fut.result())
    else:
        for b in batches:
            consume(b, encode_tile_batch(source, b, layers=layers, extent=extent, buffer=buffer,
                                         max_features=max_features, device=device))
    return stats
