"""The spatial join of two datasets, or of two commits of one dataset (the
time-travel join), over envelope columns, refined exactly where both sides
carry vertex columns.

1. The ``--intersects`` side (the build side) is cut into 4096-row tiles;
   each tile's union bbox comes from the sidecar's aggregate builder, so
   it holds every member.
2. For each tile the probe side's block aggregates are classified against
   that bbox: an all-out probe block is skipped unread.
3. The surviving probe rows stream in ``KART_QUERY_BATCH_ROWS`` batches
   through K5, which gives each probe row's overlap count and, when the
   join is exact, the overlapping pairs; K6 refines the pairs whose both
   sides have usable geometry, and the pairs it drops are taken off the
   counts.

Both sides' envelopes go to the device once; a batch is a slice of them.
Counterpart of kart_tpu's ``query/join.py`` (``_alive_ranges``,
:func:`join_counts_for_range`, ``_make_refine_ctx``, ``_refine_chunk``,
:func:`run_join`), whose documents it writes byte for byte; kart_tpu
rebuilds each batch's pair matrix on the host, where the port takes the
pairs from K5.
"""

import numpy as np
import torch

from kart_tpu_torch import faults
from kart_tpu_torch import telemetry as tm
from kart_tpu_torch.query import QueryError, _bump, load_query_dataset, resolve_query_commit
from kart_tpu_torch.query.scan import (
    _load_block,
    _page,
    _pks_for_index,
    batch_rows,
    parse_bbox,
)

#: build-side tile rows: the sidecar's aggregate block, so one probe block
#: class covers one tile test
TILE_ROWS = 4096


def _envelopes_or_raise(block, what):
    if block.envelopes is None:
        raise QueryError(
            f"--intersects needs envelope columns on the {what} side"
            " (no geometry in the sidecar)")
    return block.envelopes


def _probe_aggregates(block):
    """(agg (nb,4) f32, flags (nb,) u8, block_rows) of the probe side: the
    sidecar's, else computed once from its envelope column."""
    if block.env_blocks is not None:
        return block.env_blocks
    from kart_tpu_torch.diff.sidecar import AGG_BLOCK_ROWS, block_aggregates

    agg, flags = block_aggregates(np.asarray(block.envelopes, dtype=np.float32), AGG_BLOCK_ROWS)
    return agg, flags, AGG_BLOCK_ROWS


def _alive_ranges(cls, block_rows, lo, hi):
    """The probe blocks that are not all-out, clipped to ``[lo, hi)`` ->
    [(row_lo, row_hi)], consecutive blocks merged into one run."""
    from kart_tpu_torch.ops.bbox import BLOCK_ALL_OUT

    b0 = lo // block_rows
    b1 = -(-hi // block_rows)
    ranges = []
    run_start = None
    for b in range(b0, b1):
        alive = cls[b] != BLOCK_ALL_OUT
        if alive and run_start is None:
            run_start = b
        elif not alive and run_start is not None:
            ranges.append((run_start, b))
            run_start = None
    if run_start is not None:
        ranges.append((run_start, b1))
    return [(max(rb0 * block_rows, lo), min(rb1 * block_rows, hi)) for rb0, rb1 in ranges]


def _make_refine_ctx(col_build, build_feat, build_env, col_probe, probe_env, device, hook=None):
    """The exact refine's state, on ``device``. ``build_feat`` maps a build
    envelope row to its vertex-column feature (they differ when ``--bbox``
    gathers the build side). Only pairs whose both sides have usable,
    non-wrapping geometry are refined; every other pair keeps its envelope
    verdict, so the exact matches are a subset of the envelope matches."""
    build_feat = np.asarray(build_feat, dtype=np.int64)
    build_env = np.asarray(build_env, dtype=np.float32)
    probe_env = np.asarray(probe_env, dtype=np.float32)
    as_tensor = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return {
        "col_build": col_build,
        "col_probe": col_probe,
        "build_feat": as_tensor(build_feat),
        "build_ok": as_tensor(col_build.usable()[build_feat] & ~(build_env[:, 2] < build_env[:, 0])),
        "probe_ok": as_tensor(col_probe.usable() & ~(probe_env[:, 2] < probe_env[:, 0])),
        "hook": hook,
    }


def _refine_chunk(refine, pairs, t, c_lo, counts, lo, total, *, backend, stats):
    """Exact-refine one (build tile x probe batch): K5's pairs, those with
    usable geometry on both sides through K6, and the dropped ones taken
    off ``counts`` (a tensor of the rows ``[lo, ...)``). -> the pair total
    after the refine."""
    pair_probe, pair_build = pairs
    env_row = t * TILE_ROWS + pair_build.to(torch.int64)
    probe_row = c_lo + pair_probe.to(torch.int64)
    u = refine["probe_ok"][probe_row] & refine["build_ok"][env_row]
    if not bool(u.any()):
        return total
    if refine["hook"] is not None:
        refine["hook"]()
    bi = refine["build_feat"][env_row[u]]
    pj = probe_row[u]
    verdict = backend.refine_pairs(refine["col_build"], bi, refine["col_probe"], pj)
    stats["pairs_refined"] += int(pj.numel())
    dropped = pj[~verdict] - lo
    n_drop = int(dropped.numel())
    if n_drop:
        counts.index_add_(0, dropped, torch.full_like(dropped, -1))
        total -= n_drop
        stats["refine_dropped"] += n_drop
    return total


def join_counts_for_range(build_env, probe_block, lo, hi, *, backend, stats=None, refine=None,
                          join_hook=None):
    """Per-probe match counts of probe rows ``[lo:hi)`` against the whole
    build side -> (counts int64 (hi-lo,), pair total): tile, prune, stream
    batches through K5 on the backend's device; with a ``refine`` context
    (:func:`_make_refine_ctx`) each batch's pairs are refined by K6 before
    the next batch."""
    from kart_tpu_torch.diff.sidecar import block_aggregates
    from kart_tpu_torch.ops.bbox import BLOCK_ALL_OUT, classify_env_blocks_np
    from kart_tpu_torch.ops.blocks import to_device

    probe_env = _envelopes_or_raise(probe_block, "probe")
    if stats is None:
        stats = {}
    for key in ("tiles", "blocks_pruned", "block_tests", "batches", "pairs_refined",
                "refine_dropped"):
        stats.setdefault(key, 0)
    if not len(build_env) or hi <= lo:
        return np.zeros(max(hi - lo, 0), dtype=np.int64), 0

    device = backend.device
    build_env = np.ascontiguousarray(build_env, dtype=np.float32)
    tile_agg, _tile_flags = block_aggregates(build_env, TILE_ROWS)
    probe_agg, probe_flags, block_rows = _probe_aggregates(probe_block)
    build_t = to_device(build_env, device)
    probe_t = to_device(np.asarray(probe_env[lo:hi], dtype=np.float32), device)
    counts = torch.zeros(hi - lo, dtype=torch.int64, device=device)
    total = 0
    batch = batch_rows()

    n_tiles = len(tile_agg)
    stats["tiles"] += n_tiles
    b0 = lo // block_rows
    b1 = -(-hi // block_rows)
    for t in range(n_tiles):
        if join_hook is not None:
            join_hook()
        tile_t = build_t[t * TILE_ROWS : (t + 1) * TILE_ROWS]
        cls = classify_env_blocks_np(probe_agg, probe_flags, tile_agg[t].astype(np.float64))
        stats["block_tests"] += b1 - b0
        stats["blocks_pruned"] += int(np.count_nonzero(cls[b0:b1] == BLOCK_ALL_OUT))
        for r_lo, r_hi in _alive_ranges(cls, block_rows, lo, hi):
            for c_lo in range(r_lo, r_hi, batch):
                c_hi = min(c_lo + batch, r_hi)
                c, c_total, pairs = backend.join_counts(
                    tile_t, probe_t[c_lo - lo : c_hi - lo], pairs=refine is not None)
                counts[c_lo - lo : c_hi - lo] += c
                total += c_total
                stats["batches"] += 1
                if refine is not None and c_total:
                    total = _refine_chunk(refine, pairs, t, c_lo, counts, lo, total,
                                          backend=backend, stats=stats)
    return counts.cpu().numpy(), total


def run_join(repo, refish, ds_path, refish2, ds_path2, *, bbox=None, output="count", page=None,
             page_size=None, part=None, approx=False, backend):
    """The spatial join behind ``kart query --intersects`` -> the JSON-ready
    result document. The probe side is ``(refish, ds_path)``, whose rows the
    join reports; the build side is the ``--intersects`` operand.
    ``approx=True`` (or ``KART_GEOM_REFINE=0``) stops at envelope verdicts;
    otherwise pairs are refined wherever both sides carry vertex columns.
    ``backend`` (:mod:`kart_tpu_torch.diff.backend`) picks the device, or
    the plain versions on the card to check the kernels against. ``part``
    ``(lo, hi)`` joins the probe rows ``[lo, hi)`` alone: a block-range
    partial of a served join."""
    from kart_tpu_torch.geom import geom_refine_enabled
    from kart_tpu_torch.query.scan import vertices_for_block

    if output not in ("count", "json"):
        raise QueryError(f"unknown join output {output!r} (count, json)")
    commit1 = resolve_query_commit(repo, refish)
    commit2 = resolve_query_commit(repo, refish2)
    probe_ds = load_query_dataset(repo, commit1, ds_path)
    build_ds = load_query_dataset(repo, commit2, ds_path2)
    probe_block = _load_block(repo, probe_ds, ds_path)
    build_block = _load_block(repo, build_ds, ds_path2)
    _envelopes_or_raise(probe_block, "probe")
    build_env = np.asarray(_envelopes_or_raise(build_block, "build"), dtype=np.float32)
    build_feat = np.arange(build_block.count, dtype=np.int64)
    query = parse_bbox(bbox) if bbox is not None else None

    col_probe = col_build = None
    if not approx and geom_refine_enabled():
        col_probe = vertices_for_block(probe_ds, probe_block)
        col_build = vertices_for_block(build_ds, build_block)
    exact = col_probe is not None and col_build is not None

    n_probe = probe_block.count
    lo, hi = 0, n_probe
    if part is not None:
        lo, hi = int(part[0]), int(part[1])
        if not (0 <= lo <= hi <= n_probe):
            raise QueryError(f"part {lo}:{hi} outside probe rows 0:{n_probe}")

    join_hook = faults.hook("query.join")
    refine_hook = faults.hook("query.refine")
    stats = {
        "build_rows": int(build_block.count),
        "probe_rows": int(n_probe),
        "tiles": 0,
        "blocks_pruned": 0,
        "block_tests": 0,
        "batches": 0,
        "pairs_refined": 0,
        "refine_dropped": 0,
    }
    if join_hook is not None:
        join_hook()
    probe_mask = None
    if query is not None:
        # --bbox restricts both sides: the build side by gather, the probe
        # side by zeroing the excluded rows' counts after the join
        b_hits = _hits(backend, build_block, query)
        build_feat = np.flatnonzero(b_hits).astype(np.int64)
        build_env = np.ascontiguousarray(build_env[build_feat])
        probe_mask = _hits(backend, probe_block, query)[lo:hi]
    # the join's batches and refines route on the whole probe side, as
    # kart_tpu's route_rows does
    backend = backend.for_rows(n_probe)
    refine = None
    if exact:
        refine = _make_refine_ctx(col_build, build_feat, build_env, col_probe,
                                  probe_block.envelopes, backend.device, hook=refine_hook)
    counts, total = join_counts_for_range(build_env, probe_block, lo, hi, backend=backend,
                                          stats=stats, refine=refine, join_hook=join_hook)
    if probe_mask is not None:
        counts[~probe_mask] = 0
        total = int(counts.sum())
    if total != int(counts.sum()):
        raise RuntimeError(f"join pair total mismatch: {total} != {int(counts.sum())}")

    result = {
        "kind": "join",
        "commit": commit1,
        "dataset": ds_path,
        "commit2": commit2,
        "dataset2": ds_path2,
        "bbox": [float(v) for v in query] if query is not None else None,
        "part": [lo, hi] if part is not None else None,
        "exact": exact,
        "pairs": int(total),
        "count": int(np.count_nonzero(counts)),
        "stats": stats,
    }
    if output == "json":
        pg, ps = _page(page, page_size)
        nz = np.flatnonzero(counts)
        matches = []
        for i in nz[pg * ps : (pg + 1) * ps].tolist():
            pks = _pks_for_index(probe_block, probe_ds, lo + i)
            matches.append({"pk": pks[0] if len(pks) == 1 else list(pks),
                            "matches": int(counts[i])})
        result["matches"] = matches
        result["page"] = pg
        result["page_size"] = ps
        result["next_page"] = pg + 1 if (pg + 1) * ps < len(nz) else None

    tm.incr("query.joins")
    tm.incr("query.pairs_emitted", int(total))
    tm.incr("query.blocks_pruned", stats["blocks_pruned"])
    tm.incr("query.pairs_refined", stats["pairs_refined"])
    _bump("joins")
    _bump("pairs_emitted", int(total))
    _bump("blocks_pruned", stats["blocks_pruned"])
    _bump("pairs_refined", stats["pairs_refined"])
    _bump("refine_dropped", stats["refine_dropped"])
    return result


def _hits(backend, block, query):
    """bool (count,) host array: the block's envelopes against ``query`` (K2)."""
    if not block.count:
        return np.zeros(0, dtype=bool)
    return backend.envelope_hits(block, query).cpu().numpy()
