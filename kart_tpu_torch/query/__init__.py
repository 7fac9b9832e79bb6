"""``kart query``: "what is" over one commit, where the diff answers "what
changed".

* :mod:`.scan` -- predicate-pushdown scans: a ``--where``/``--bbox``
  predicate prunes whole sidecar blocks, filters rows on the key column,
  then on the feature blobs of the survivors; ``count``, ``count by`` and
  the bbox union never build rows. A ``--bbox`` runs K2 over the envelope
  column and K6 against the rectangle's polygon.
* :mod:`.join` -- the spatial join of two datasets, or two commits of one
  (the time-travel join): the build side in 4096-row tiles, the probe side
  pruned by block against each tile and streamed in batches through K5,
  each batch's pairs refined exactly by K6.
* :mod:`.cache` -- the commit-addressed single-flight result cache behind
  ``GET /api/v1/query`` (its strong ETag is the cache key).

Counterpart of kart_tpu's ``query/__init__.py``, ``scan.py``, ``join.py``
and ``cache.py``, with the same result documents byte for byte. A query
runs on one device: the card unless ``device="cpu"``, which runs the plain
versions.
"""

import threading


class QueryError(Exception):
    """A malformed query: unknown column, a literal of the wrong type, a
    grammar error, no envelope or sidecar support. Exit 2 in the CLI."""


#: process-wide query counters: the ``query`` block of
#: ``/api/v1/stats?format=json`` and ``kart top``
STATS = {
    "scans": 0,
    "joins": 0,
    "blocks_pruned": 0,
    "rows_scanned": 0,
    "pairs_emitted": 0,
    "pairs_refined": 0,
    "refine_dropped": 0,
    "scatter_requests": 0,
    "scatter_parts": 0,
    "cache_hits": 0,
    "cache_misses": 0,
}
_STATS_LOCK = threading.Lock()


def _bump(name, n=1):
    with _STATS_LOCK:
        STATS[name] += int(n)


def status_dict():
    """The ``query`` block of the stats document (transport/http.py,
    transport/stdio.py); what ``kart top`` renders."""
    with _STATS_LOCK:
        return dict(STATS)


def resolve_query_commit(repo, refish):
    """refish -> full commit oid (a query is pinned to the commit, never to
    a ref that may move)."""
    try:
        oid, _ = repo.resolve_refish(refish)
    except Exception as e:
        raise QueryError(f"cannot resolve {refish!r}: {e}") from None
    if oid is None:
        raise QueryError(f"cannot resolve {refish!r} to a commit")
    return str(oid)


def load_query_dataset(repo, commit_oid, ds_path):
    """(commit, dataset path) -> the Dataset3, or a QueryError."""
    try:
        ds = repo.structure(commit_oid).datasets[ds_path]
    except KeyError:
        raise QueryError(f"no dataset {ds_path!r} at {commit_oid[:12]}") from None
    except Exception as e:
        raise QueryError(f"cannot load {ds_path!r}: {e}") from None
    return ds


def run_query(repo, refish, ds_path, *, where=None, bbox=None, intersects=None,
              output="count", count_by=None, page=None, page_size=None, part=None,
              approx=False, device=None):
    """Route to the scan or the spatial join -> the JSON-ready result
    document. ``intersects`` is ``(refish2, ds_path2)``: the join, which
    takes no ``where`` or ``count_by``. ``approx=True`` stops spatial
    verdicts at the envelopes. The kernels run on ``device`` (None: the
    card; ``"cpu"``: the plain versions); on several cards each stage goes
    to the mesh by its own rows (a scan's block, a refine's candidates, a
    join's probe side), as kart_tpu routes them. ``part`` ``(lo, hi)``:
    a join over the probe rows ``[lo, hi)`` alone."""
    from kart_tpu_torch.diff.backend import select_backend

    backend = select_backend(device)
    if intersects is not None:
        if where or count_by:
            raise QueryError("--intersects cannot be combined with --where")
        from kart_tpu_torch.query.join import run_join

        return run_join(repo, refish, ds_path, intersects[0], intersects[1], bbox=bbox,
                        output=output, page=page, page_size=page_size, part=part,
                        approx=approx, backend=backend)
    if part is not None:
        raise QueryError("block-range partials apply to join queries only")
    from kart_tpu_torch.query.scan import run_scan

    return run_scan(repo, refish, ds_path, where=where, bbox=bbox, output=output,
                    count_by=count_by, page=page, page_size=page_size, approx=approx,
                    backend=backend)


__all__ = ["QueryError", "STATS", "run_query", "status_dict"]
