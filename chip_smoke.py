#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and hold every
kernel against its plain PyTorch version.

    python3 chip_smoke.py [--rows 10000000] [--index-rows 1000000]
                          [--repo-rows 5000000] [--spatial-rows 2000000]
                          [--index-repo-rows 400000]
                          [--merge-rows 2000000]
                          [--text-rows 5000000] [--text-merge-rows 500000] [--seed 0]
                          [--stream-rows 100000000] [--crossover-rows 1000000,...]
                          [--crossover-reps 3] [--chunk-sweep 2000000,...]
                          [--history-commits 6]
                          [--k4-only | --hash-only | --query-only | --kernels-only |
                           --tiles-only | --history-only | --stream-only]

Run from the repository root on a machine with an sm_90 (Hopper) card and
the CUDA toolkit; the kernels are built from ``kart_tpu_torch/csrc`` on
first use. Phases:

0. card name and power limit; refuse anything but compute capability 9.0
1. build the kernels (one nvcc per source, in parallel)
2. generate a base and an edited int-pk version from ``--seed`` (1%
   updates rotating the flipped oid word, 0.1% deletes, 0.1% inserts
   interleaved and past the max pk; point envelopes, small boxes,
   anti-meridian boxes, NaN rows, moved envelopes), write both as KCOL1
   sidecars and mmap them back; write a feature_envelopes.db
3-5. the main path, with the launch counters zeroed before and read after:
   classify_changed and feature_count (K1), feature_count under a
   non-wrapping and a wrapping rect (K2), bbox_intersects twice through the
   resident cache and envelope_prepass on the index (K3)
   ... then every kernel's output against its plain version on the card
   (bit-identical), K1's tile co-ranks against its plain partition, and the
   counts against the generated truth
6. timings beside each kernel's bound: the wrapper's time (CUDA events,
   after warm-up) and the kernels' own device time (torch.profiler),
   checked by CUDA events with the wrapper's host work fenced off
7. build a repository with the port's ``synth.synth_repo``: ``--repo-rows``
   int-pk features, real blobs for the 1% edited rows only, from ``--seed``
8-10. ``kart diff`` through the port's CLI entry point (``kart_tpu_torch.cli
   .main``, what ``python -m kart_tpu_torch`` calls), each phase with the
   launch counters zeroed before and read after and K1 launched exactly
   once (one dataset): ``-o feature-count`` on the card (counts-only K1);
   ``-o json-lines`` on the card and again with ``--device cpu``
   (byte-identical files), then each once more under cProfile; ``-o json``
   on the card and with ``--device cpu`` (byte-identical files)
10a. on the same repository: ``diff HEAD^...HEAD`` (text), ``-o geojson``,
   ``-o html``, ``show HEAD``, ``show -o json HEAD`` and ``create-patch
   HEAD``, each on the card (exactly one K1 launch) and with ``--device
   cpu`` (equal sha256); the card's text diff again under cProfile
10b. ``diff --only-feature-count`` at veryfast, fast, medium and good, and
   at medium with ``-o json``: the annotations cache deleted before each
   route, one counts-only K1 launch on the card, the same bytes with
   ``--device cpu``, then a second card run answered by the cache (no
   launch, the same bytes); ``good`` and ``exact`` (no launch) print [8]'s
   count; K1 counts-only timed on each accuracy's sampled rows
11. build a spatial repository with ``synth.synth_repo(spatial=True)``:
   ``--spatial-rows`` point features whose sidecars carry envelope and
   vertex columns, real blobs for the 1% edited rows only
Q1. ``kart query`` scans on it, each on the card (counted) and with
   ``--device cpu`` (equal sha256): ``--bbox`` ([12]'s rectangle) ``-o
   count`` (one K2, K6 on the candidates), the same ``--approx`` (no K6),
   ``-o bbox``, ``-o json --where ... --page 1 --page-size 1000`` (an empty
   page, and a page of edited features picked by an IN list), a wrapping
   ``--bbox`` (no K6)
Q2. ``query HEAD synth --intersects HEAD^:synth -o count`` on the card at
   full depth (K5 once a batch, and once more for a batch's pairs; K6 once
   a refined batch), its document
   equal to the same join through the plain versions on the card; the join
   under an 18-degree ``--bbox`` strip (``-o count``, ``-o json --page 0``,
   ``--approx``) on the card and with ``--device cpu`` (equal sha256); the
   card's full join under cProfile
Q3. K5 on the middle build tile of Q2's join x the probe batch the join
   gives it, on the same tile x 12,288 rows of that batch, and on a
   4096-row tile x a 65,536-row batch of dense envelopes (at least half the
   probe rows matched, pairs with both and with one side wrapping the
   anti-meridian, NaN and edge rows); K6 on 100,000 random pairs of
   ``synth.synth_shapes`` (stars with holes, points, polylines, vertices on
   the world's edge), on 100,000 pairs of them whose boxes overlap, and on
   the refine batch Q2's join hands it for the same tile and batch (box x
   box): bit-identical to their plain versions on the card, timed (wrapper,
   profiler device time over every kernel of the wrapper, ``fenced_ms``)
   beside their bounds, computed from the same inputs (K5: its least
   instructions, given each row's wrap bit; K6: its design's work, what its
   exact culls leave, and beside it the reference's work, every cell of a
   false verdict)
T3. run first of the three: K7 on the whole layer's 2M envelopes and on
   the largest z4 batch of T1's card route, each with edge rows (the
   poles, the mercator clamp, the anti-meridian, -0.0, subnormals, NaN,
   infinities): bit-identical to its plain version on the card; against
   numpy's host projection the largest ulp gap and difference, inside the
   quantizer's margin, and the quantized boxes equal at zooms 0, 4, 11,
   18, 24 and 30 (each row in its own tile), with the rows the quantizer
   projected again; timed beside its bound (bytes, or its SASS's f64
   instructions)
T1. ``kart export tiles HEAD --dataset synth --zoom 0-4 --layers
   bin,ktb2,mvt,geom`` on the point layer three ways: on the card as a
   user runs it (in this process, K7 launched exactly once for each encode
   batch that writes a tile), with ``--device cpu --workers 1``, and with
   ``--device cpu``'s default, the pool of workers (numpy's projection, no
   launch): equal tree digests, stats lines and warnings (z0-z2 hold tiles
   over the 65,536-feature ceiling), one worker on the first two routes
   and more on the pool's; ``--strict`` over z0-z2 exits 2 with the same
   message on the card and the CPU; the card's export again under cProfile
T2. the default layers (bin,geojson) on the same layer, whose blobs only
   the edited rows hold: the same ``Feature blob ... not present locally``
   error and exit code 2 on the card (K7 once) and the CPU, nothing
   written; then ``--layers bin --zoom 5`` on both, equal digests
12. write a rectangular spatial filter into its config, then run ``-o
   feature-count`` and ``-o json-lines`` on the card and with ``--device
   cpu``: equal counts and sha256, and on the card exactly two K2 launches
   (one a side) and one K1 launch a command, counts-only for
   feature-count, with the rows the prefilter kept read from the same
   run's counters; then the json-lines run on the card under cProfile
12a. under the same rectangle, ``-o text``, ``-o geojson --crs EPSG:4277``
   and ``-o json-lines --crs EPSG:4277`` (OSGB 1936: a 7-parameter datum
   shift): two K2 and one K1 launch a card command, equal sha256 with
   ``--device cpu``, the features [12]'s json-lines wrote
12b. three projected filters: an NZTM (EPSG:2193) polygon over New
   Zealand, a Web Mercator (EPSG:3857) rectangle over Europe and a UTM 60S
   (EPSG:32760) polygon whose EPSG:4326 envelope reaches past the
   anti-meridian; under each, ``-o feature-count`` and ``-o json-lines`` on
   the card (two K2 and one K1 launch a command, counts-only for
   feature-count) and with ``--device cpu`` (equal sha256); then under
   [12]'s rectangle ``-o json-lines --crs EPSG:2193`` and ``-o geojson --crs
   EPSG:3857`` the same way, each output reprojected
13. the same under a polygon filter with a hole (``-o json`` and ``quiet
   --exit-code``: equal sha256 and exit codes), and under a rect around one
   unedited feature (``quiet --exit-code`` exits 0, json-lines has no
   feature line)
H0. (after [13], on [11]'s layer) ``--history-commits`` commits of
   ``synth.commit_point_edits``, each moving 0.1% of the rows (real blobs),
   deleting 0.01% and inserting 0.01% past the max pk (real blobs), the
   second onto the poles and the anti-meridian; no sidecar written, as a
   pushed history arrives; each commit's truth recorded
H1. the changed-block CDC: ``events.cdc.dirty_tiles`` at zooms 0-8 for
   each consecutive pair on the card (one K1 launch an event; the new
   tip's sidecar derived, with envelopes and no vertex column), each
   event's split (derive, classify, cover); then, the derived files deleted
   and the tile sources dropped, with ``device="cpu"``: equal summary and
   derived-sidecar sha256, ``changed`` equal to H0's truth; the whole range
   from [11]'s edit commit (truncated, one K1), a created ref (no K1) and an
   identical pair (empty, no K1) on both routes
H2. ``kart log`` on the card and with ``--device cpu`` (equal stdout
   sha256 and exit codes): text, ``--oneline --graph``, ``-o json
   --with-dataset-changes`` (all but the root: one K1 a commit), ``-o
   json-lines --with-feature-count veryfast`` (the cache deleted before each
   route; one counts-only K1 a commit but the root), ``-o json
   --with-feature-count exact -n 3`` (no K1), ``--oneline -n 1
   synth:feature:<pk>`` for a pk the first history commit moved (one K1 a
   walked commit), ``--grep``, ``--author``, ``--since @<epoch>``, ``--skip
   2 -n 3`` (no K1)
H3. ``kart build-annotations`` on the card with a fresh cache (one K1 a
   commit but the root, whose diff is the tree walk), again (no launch),
   and with ``--device cpu`` on a fresh cache: equal ``kart_annotations``
   rows in order
11i. (after [13]) a point layer with every blob real,
   ``synth.synth_repo(spatial=True, blobs="real")`` at ``--index-repo-rows``:
   ``kart spatial-filter index`` through the CLI (its line counts the
   features; each row's point inside its decoded envelope; a second run
   indexes 0), ``kart spatial-filter resolve -o json`` of [12b]'s three
   filters, then ``blob_filter_for_spec`` with [12]'s rectangle and with the
   NZTM polygon's wire argument over every feature blob of HEAD and HEAD^,
   on the card (K3 once a filter, the second filter uploading nothing: the
   index's columns stay resident) and with ``device="cpu"``: equal verdict
   sha256, equal to K3's plain version on the card; K3 timed on the index's
   envelopes beside its bound
14. build a merge repository with the port's own code, oids only (no
   blob): ``synth.synth_repo(--merge-rows, edit_frac=0.5)`` gives the
   ancestor and ours (``main``, half the rows rewritten); branch
   ``theirs`` off the ancestor rewrites 99% of ours' rows differently and
   deletes the rest (the conflicts), rewrites a fifth of the rows ours
   left alone, deletes 1% more and inserts 1% past the max pk (the
   take-theirs rows); branch ``theirs-clean`` makes only the latter
   changes. At 2,000,000 rows: 1,000,000 conflicts and 440,000
   take-theirs, checked against a numpy truth computed by row from the
   generated oids
15. K4 on the three commits' blocks and on a 10M-row-a-side triple from
   ``--seed``: ``merge_classify_sides`` bit-identical to its plain version
   (``torch.unique``, then the plain join) on the card, its union equal to
   ``np.unique``, its counts to the truth and its slice plan to the plain
   plan; wrapper time, device time (profiler mean over K4's four kernels,
   and ``fenced_ms`` of the launch alone), bound, plain time and two
   partial yardsticks the port never calls: ``torch.searchsorted`` of the
   union into one side, and ``torch.unique`` of the concatenated keys (the
   union step K4 absorbs)
16. ``merge theirs --dry-run -o json`` and ``merge theirs -o json`` on the
   card (exactly one K4 launch each) and with ``--device cpu``: equal
   stdout and MERGE_INDEX (KMIX2) sha256, the two routes each after the
   other's ``merge --abort``; ``conflicts -ss -o json``, ``conflicts -o
   quiet`` (exit 1), ``merge --abort``; the card's merge under cProfile
17. ``merge theirs-clean --no-ff -o json`` on the card (one K4 launch) and,
   after ``main`` is reset with the port's refs, with ``--device cpu``:
   the same commit and merged tree oids
18. build a hash-keyed repository with ``synth.synth_repo(pk="text")``:
   ``--text-rows`` G-NAF-shaped text ids (one leaf tree a feature, under the
   hashed path encoder), real blobs for the 1% edited rows only, sidecars
   keyed by the filename hashes with their paths
19. on it, ``diff -o feature-count``, ``-o json-lines``, ``-o json``, the
   text diff and ``show HEAD`` on the card (exactly one K1 launch each, a
   full classify: a hash-keyed dataset's count needs its changed rows) and
   with ``--device cpu`` (equal sha256), ``--only-feature-count fast`` (the
   tree sampler: no launch) on both, and the card's json-lines under cProfile
20. K1 on [18]'s blocks (keys uniform over [0, 2^63)): bit-identical to its
   plain version, counts against the truth, timed beside its bound
21. a text-pk merge repository of [14]'s shape at ``--text-merge-rows``
   (the inserts new ids): K4 on its commits' blocks against its plain
   version, ``np.unique`` and the truth, timed; ``merge --dry-run -o
   json``, then ``merge -o json`` (KMIX2), ``conflicts -ss -o json``,
   ``resolve <a text-pk label> --with theirs`` and ``merge --abort`` on the
   card (one K4 launch a merge) and with ``--device cpu`` (equal stdout and
   MERGE_INDEX sha256, before and after the resolve); the card's merge
   under cProfile; ``merge theirs-clean --no-ff`` committing the same
   oids on both routes. Every counted phase fails if a dataset took the
   host path for colliding hash keys (``hash_collision_fallbacks``)
S3. (run at the end of [10b] on [7]'s repository, and after [16] on
   [14]'s) the streamed routes through the CLI: with
   ``KART_TORCH_STREAM_MIN_ROWS=1`` and ``KART_TORCH_STREAM_CHUNK_ROWS`` a
   fifth of the larger side, ``diff -o feature-count`` (also with
   ``--device cpu``) and ``-o json-lines`` (K1 once a chunk, 5 or more;
   [9]'s sha256), and ``merge theirs -o json`` then ``merge --abort`` (K4
   once a chunk; [16]'s stdout and MERGE_INDEX sha256)
S1. ``free -g`` and ``df`` of the output directory, then ``--stream-rows``
   int pks a side from ``--seed`` (phase [2]'s generator, no envelopes: a
   base, its edit, and a second edit of the base), written as KCOL1
   sidecars and mmap'd back; the diff of base and edit on the host floor
   (``ops/host_classify.py``, a copy of kart_tpu's native merge-join), on
   the card in one chunk (one K1 launch: the row knob raised) and streamed
   (the default chunk size): equal classes sha256 and counts on the three,
   the floor's changed keys against the truth, counts-only too; each card
   route's split (pinned allocation, staging from the mmap, the copy up,
   K1, the download) from its own run
S2. the 3-way merge of the three sides (base, edit, second edit) in one
   chunk and streamed (one K4 launch a chunk): equal union, decision and
   presence sha256 and counts, equal to K4's plain version on the card
   over the whole sides, and the union size and counts equal to what the
   edits' truths give; each route's split
S4. ``columnar_equal`` (B12) on 8 x 10M int64 columns with null masks, on
   the card against the CPU; with ``--stream-only`` first the crossover:
   the floor, the card in one chunk and the card streamed at
   ``--crossover-rows`` a side (prefixes of [S1]'s sides), host walls
   first and best of ``--crossover-reps``, and the streamed route at
   ``--stream-rows`` by ``--chunk-sweep`` chunk rows
22. each group of phases' host wall (S1-S4 first, [1-6] the build, the data
   and phases 3-6; [12b], [11i] and H0-H3 on their own), the ``kernels`` JSON line
   (K1-K7, K3's figures on [11i]'s index in ``index_envelopes``, each
   kernel's ``launches`` is the sum of ``launches_by_phase``: every launch
   of the main path's runs, the cProfile runs included, and none of the
   comparisons with the plain versions), the card line, and the result
   line

``kart conflicts`` as text or GeoJSON (and ``--crs``) and ``resolve
--with-file`` run no kernel, and the merge repository has no blobs to show,
so they are held to kart_tpu by the CPU tests only
(``tests/test_torch_merge_cli.py``). Each phase prints its host wall.

Any failed check exits non-zero without the result line. ``--k4-only`` runs
phases 0, 1, 14 and 15 alone and prints K4's timings as JSON, with no
result line; ``--hash-only`` runs phases 0, 1 and 18-21 alone the same
way, ``--query-only`` phases 0, 1, 11 and Q1-Q3, ``--kernels-only`` phases 0,
1, 11 and Q3, ``--tiles-only`` phases 0, 1, 11 and T1-T3, ``--history-only``
phases 0, 1, 11 and H0-H3, ``--stream-only``
phases 0, 1 and S1-S4 (S3 on repositories it builds at ``--repo-rows`` and
``--merge-rows``, with the monolithic card and ``--device cpu`` runs of its
commands made there).

To time another checkout's K5 and K6 on the same inputs (a parent commit,
say), run this script with that checkout's package in its place:
``PYTHONSAFEPATH=1 PYTHONPATH=<checkout> python3 chip_smoke.py
--kernels-only``.
"""

import argparse
import contextlib
import cProfile
import hashlib
import io
import json
import os
import pstats
import re
import sqlite3
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from kart_tpu_torch import runtime
from kart_tpu_torch.cli import main as kart_main
from kart_tpu_torch.core.feature_tree import (
    emit_feature_tree,
    plan_feature_tree,
    plan_int_feature_tree,
)
from kart_tpu_torch.core.objects import MODE_TREE
from kart_tpu_torch.core.tree_builder import TreeBuilder
from kart_tpu_torch.diff.backend import (
    PlainTorchBackend,
    envelope_scan,
    envelope_scan_plain,
    select_backend,
)
from kart_tpu_torch.diff.engine import (
    classify_changed,
    feature_count,
    prefilter_rect,
)
from kart_tpu_torch.diff.estimation import ACCURACY_SUBTREE_SAMPLES, sample_block
from kart_tpu_torch.diff.sidecar import (
    block_aggregates,
    load_block,
    load_block_file,
    save_sidecar,
    save_sidecar_file,
    sidecar_file,
)
from kart_tpu_torch.models.paths import PathEncoder
from kart_tpu_torch.ops import _build
from kart_tpu_torch.ops import bbox as bbox_ops
from kart_tpu_torch.ops.blocks import FeatureBlock, block_tensors, to_device
from kart_tpu_torch.ops.diff_kernel import (
    TILE_ROWS,
    block_splits,
    classify,
    classify_blocks,
    classify_plain,
    columnar_equal,
    stream_chunk_rows,
    tile_coranks,
    tile_coranks_plain,
)
from kart_tpu_torch.ops.envelope_codec import EnvelopeCodec
from kart_tpu_torch.ops.envelope_join import envelope_join, envelope_join_plain
from kart_tpu_torch.ops.geom_refine import (
    PLAIN_SLAB_ELEMENTS,
    _slabs,
    geom_refine,
    geom_refine_plain,
    resident_segments,
)
from kart_tpu_torch.ops.host_classify import classify_blocks_host
from kart_tpu_torch.ops.merge_kernel import (
    launch_merge_classify,
    merge_classify,
    merge_classify_sides,
    merge_classify_sides_plain,
    merge_tile_plan,
    merge_tile_plan_plain,
)
from kart_tpu_torch.spatial_filter import (
    PREPASS_PAD,
    ResolvedSpatialFilterSpec,
    blob_filter_for_spec,
    envelope_prepass,
)
from kart_tpu_torch.spatial_filter.index import DB_NAME, EnvelopeIndexReader, db_path
from kart_tpu_torch.query.join import (
    TILE_ROWS,
    _alive_ranges,
    _make_refine_ctx,
    _probe_aggregates,
    run_join,
)
from kart_tpu_torch.query.scan import batch_rows
from kart_tpu_torch.synth import (
    HashedColumns,
    commit_point_edits,
    gnaf_ids,
    synth_repo,
    synth_shapes,
)
from kart_tpu_torch.ops.merc import merc, merc_plain
from kart_tpu_torch.tiles.clip import _host_merc, quantize_boxes, quantize_margin, refine_rows
from kart_tpu_torch.tiles.encode import max_features_limit
from kart_tpu_torch.tiles.grid import MERC_MAX_LAT, parse_zoom_spec, tile_query_wsen
from kart_tpu_torch.tiles.pyramid import batched, export_batch_tiles, tile_cover, tree_digest
from kart_tpu_torch.tiles.source import drop_sources, source_for
from kart_tpu_torch.events import cdc

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
#: non-tensor-core f32 rate, used for every bound below
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: clock cycles of the sleep kernel that holds the stream while a timed call
#: is enqueued (~1 ms at the H100's boost clock)
FENCE_CYCLES = 2_000_000

#: filter rects (f64 bounds that are not f32-representable), and the
#: anti-meridian-wrapping one
RECT_PLAIN = (-73.123456789, -33.3333333333, 151.2222222222, 61.7777777777)
RECT_WRAP = (170.0, -60.0, -170.0, 60.0)
BBOX_QUERY = (-30.3, -20.7, 60.1, 40.9)
PREPASS_WSEN = "-30.3,-20.7,60.1,40.9"

#: the spatial repository's filters: a rectangle (about 12% of the synthetic
#: globe) and a polygon with a hole, whose edges cut some envelopes
FILTER_RECT = "EPSG:4326;POLYGON((-60 -30,60 -30,60 30,-60 30,-60 -30))"
FILTER_POLY = ("EPSG:4326;POLYGON((-60 -40,0 -50,60 -40,40 40,-40 40,-60 -40),"
               "(-10 -10,10 -10,10 10,-10 10,-10 -10))")


#: [12b]'s projected filters: an NZTM polygon over New Zealand, a Web
#: Mercator rectangle over Europe, and a UTM 60S polygon whose EPSG:4326
#: envelope reaches past the anti-meridian
FILTERS_PROJECTED = {
    "nztm": "EPSG:2193;POLYGON((1090000 4740000,2100000 4740000,2100000 6200000,"
            "1600000 6250000,1090000 6200000,1090000 4740000))",
    "webmerc": "EPSG:3857;POLYGON((-1113195 4163881,3339585 4163881,3339585 8399738,"
               "-1113195 8399738,-1113195 4163881))",
    "utm60s": "EPSG:32760;POLYGON((600000 5500000,900000 5500000,900000 7500000,"
              "600000 7500000,600000 5500000))",
}


class SmokeFailure(RuntimeError):
    pass


#: a launch count of :func:`counted` that must be at least 1
SOME = object()


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def ecc_line():
    """The card's volatile ECC error totals, corrected and uncorrected, as
    nvidia-smi reports them (a card that faults is read here first)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=ecc.errors.corrected.volatile.total,"
         "ecc.errors.uncorrected.volatile.total", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


# --- data -------------------------------------------------------------------

def make_envelopes(rng, n, n_nan=0):
    """Point envelopes over the world, 1% small boxes, 0.01% boxes wrapping
    the anti-meridian, ``n_nan`` NaN rows."""
    lon = rng.uniform(-180, 180, n)
    lat = rng.uniform(-90, 90, n)
    env = np.stack([lon, lat, lon, lat], axis=1)
    box = rng.random(n) < 0.01
    env[box, 2] += rng.uniform(0, 0.5, box.sum())
    env[box, 3] += rng.uniform(0, 0.5, box.sum())
    wrap = rng.random(n) < 0.0001
    env[wrap, 0] = rng.uniform(179, 180, wrap.sum())
    env[wrap, 2] = rng.uniform(-180, -179, wrap.sum())
    if n_nan:
        env[rng.choice(n, n_nan, replace=False)] = np.nan
    return env.astype(np.float32)


def make_dense_envelopes(rng, n):
    """Envelopes packed so that a probe row meets tens of build rows:
    points and boxes up to 3 degrees in two 20-degree squares, one at the
    origin and a quarter of the rows in one across the anti-meridian (15% of
    those wrap it), with NaN, -0.0, subnormal, infinite and corner-sharing
    rows: every branch of the join's overlap test."""
    w = rng.uniform(-10, 10, n)
    s = rng.uniform(-10, 10, n)
    far = rng.random(n) < 0.25
    w[far] = np.where(w[far] < 0, w[far] + 180, w[far] - 180)
    e = np.minimum(w + rng.uniform(0, 3, n) * (rng.random(n) < 0.7), 180)
    north = s + rng.uniform(0, 3, n) * (rng.random(n) < 0.7)
    wrap = far & (rng.random(n) < 0.15)
    w[wrap] = rng.uniform(170, 180, wrap.sum())
    e[wrap] = rng.uniform(-180, -170, wrap.sum())
    env = np.stack([w, s, e, north], axis=1).astype(np.float32)
    env[0] = np.nan
    env[1] = (-0.0, -0.0, 0.0, 0.0)
    env[2] = (0.0, 0.0, 1e-45, 1e-45)
    env[3] = (-np.inf, -1.0, np.inf, 1.0)
    env[4] = (1.0, 1.0, 2.0, 2.0)
    env[5] = (2.0, 2.0, 3.0, 3.0)  # shares a corner with row 4
    env[6, 1] = np.nan
    return env


def make_versions(rng, n, envelopes=True, beyond_offset=1):
    """Base and edited (keys, oids, envelopes or None), plus the changed
    keys; the inserts past the max pk start ``beyond_offset`` above it."""
    pks = np.cumsum(rng.integers(1, 4, n)).astype(np.int64) + 1000
    oids = rng.integers(0, 2**32, size=(n, 5), dtype=np.uint32)
    env = make_envelopes(rng, n, n_nan=7) if envelopes else None
    return (pks, oids, env), *edit_version(rng, pks, oids, env, beyond_offset)


def edit_version(rng, pks, oids, env=None, beyond_offset=1):
    """An edit of a base version: 1% updates (the flipped oid word
    rotating), 0.1% deletes, 0.1% inserts (half into gaps, half past the
    max pk). -> (keys, oids, envelopes or None) unsorted, and the truth."""
    n = len(pks)
    n_upd, n_del, n_ins = n // 100, n // 1000, n // 1000
    rows = rng.permutation(n)
    upd = np.sort(rows[:n_upd])
    dele = np.sort(rows[n_upd : n_upd + n_del])
    oids2 = oids.copy()
    oids2[upd, np.arange(n_upd) % 5] ^= rng.integers(1, 2**32, n_upd, dtype=np.uint32)
    env2 = None
    if env is not None:
        env2 = env.copy()
        moved = upd[: n_upd // 2]
        env2[moved] = make_envelopes(rng, len(moved))
    keep = np.ones(n, dtype=bool)
    keep[dele] = False
    free = np.flatnonzero(np.diff(pks) > 1)
    inter = pks[rng.choice(free, n_ins // 2, replace=False)] + 1
    beyond = pks[-1] + beyond_offset + 7 * np.arange(n_ins - n_ins // 2, dtype=np.int64)
    ins = np.concatenate([inter, beyond])
    keys2 = np.concatenate([pks[keep], ins])
    oids2 = np.concatenate([oids2[keep], rng.integers(0, 2**32, size=(n_ins, 5), dtype=np.uint32)])
    if env is not None:
        env2 = np.concatenate([env2[keep], make_envelopes(rng, n_ins)])
    truth = {"upd": pks[upd], "del": pks[dele], "ins": np.sort(ins)}
    return (keys2, oids2, env2), truth


def write_index(rng, gitdir, n):
    """A feature_envelopes.db of ``n`` random blob oids -> packed envelopes."""
    w = rng.uniform(-180, 180, n)
    s = rng.uniform(-90, 90, n)
    env = np.stack([w, s, np.minimum(w + rng.uniform(0, 2, n), 180),
                    np.minimum(s + rng.uniform(0, 2, n), 90)], axis=1)
    wrap = rng.random(n) < 0.001
    env[wrap, 0] = rng.uniform(179, 180, wrap.sum())
    env[wrap, 2] = rng.uniform(-180, -179, wrap.sum())
    packed = EnvelopeCodec().encode_batch(env)
    oids = rng.integers(0, 256, size=(n, 20), dtype=np.uint8)
    con = sqlite3.connect(os.path.join(gitdir, DB_NAME))
    try:
        con.execute("CREATE TABLE feature_envelopes (blob_id BLOB PRIMARY KEY, "
                    "envelope BLOB NOT NULL) WITHOUT ROWID")
        con.executemany("INSERT OR REPLACE INTO feature_envelopes VALUES (?, ?)",
                        zip(map(bytes, oids), map(bytes, packed)))
        con.commit()
    finally:
        con.close()


# --- timing -----------------------------------------------------------------

def time_ms(fn, batches=5, per_batch=10, warmup=3):
    """Median over ``batches`` of the mean per-call time of ``per_batch``
    back-to-back calls, by CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / per_batch)
    return statistics.median(out)


def device_ms(fn, kernels, calls=20):
    """:func:`device_times` without the fenced time."""
    return device_times(fn, kernels, calls)[0]


def device_times(fn, kernels, calls=20):
    """Device time per launch of each CUDA kernel whose name contains one of
    ``kernels`` (each launched once a call), from a torch.profiler window of
    ``calls`` calls after warm-up: the mean over the launches the profiler
    recorded, which it reports beside the launches made when it saw fewer,
    and beside :func:`fenced_ms` of the same call.
    -> ({name fragment: ms} for the kernels the profiler saw, fenced ms)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per, seen = {}, {}
    for e in prof.key_averages():
        for k in kernels:
            if k in e.key and e.count:
                t = getattr(e, "device_time_total", None)
                us = e.cuda_time_total if t is None else t
                per[k] = per.get(k, 0.0) + us / e.count / 1e3
                seen[k] = seen.get(k, 0) + e.count
    short = {k: n for k, n in seen.items() if n != calls}
    if short:
        print(f"    the profiler recorded {short} launches of {calls} made")
    if not per:
        timed = [e.key for e in prof.key_averages()
                 if (getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0))]
        print(f"    the profiler saw no kernel named {'/'.join(kernels)}; it timed {timed[:8]}")
    fenced = fenced_ms(fn, calls)
    print(f"    device check {'+'.join(kernels)}: profiler {fmt_ms(total_ms(per))} a call; "
          f"CUDA events, host work fenced off, {fenced:.4f} ms a call")
    return per, fenced


def fenced_ms(fn, calls=20):
    """Device time of one call of ``fn`` by CUDA events, with a sleep kernel
    holding the stream while the host enqueues the call, so that the
    wrapper's host work is not counted (its small fills are): the median
    over ``calls`` calls. A check of :func:`device_ms` that needs no
    profiler."""
    out = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(FENCE_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def total_ms(per):
    """The sum of a :func:`device_ms` split, None if it saw no kernel."""
    return sum(per.values()) if per else None


def fmt_ms(t):
    return "not seen by the profiler" if t is None else f"{t:.4f} ms"


def bound(bytes_moved, ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mismatches(a, b):
    """The largest absolute difference of two integer tensors (``b`` moved
    to ``a``'s device: the card's classify returns its classes on the host)."""
    b = b.to(a.device)
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


# --- the kart diff CLI on a repository ---------------------------------------

def kart_cli(*argv, rc_want=0):
    """One in-process ``python -m kart_tpu_torch`` call; -> host wall
    seconds. Raises unless it exits ``rc_want``."""
    t = time.perf_counter()
    rc = kart_main(list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    check(rc == rc_want, f"kart {' '.join(argv)} exited {rc}, expected {rc_want}")
    return wall


def counted(label, fn, launches, want=1, want_k2=0, want_k4=0, want_k5=0, want_k6=0,
            want_k7=0, want_k3=0):
    """Run ``fn`` with the launch counters zeroed before and read after;
    fail unless K1 launched exactly ``want`` times (once for each dataset
    the columnar route classifies), K2 ``want_k2`` times, K4 ``want_k4``
    times, K5 ``want_k5`` times, K6 ``want_k6`` times, K7 ``want_k7`` times
    and K3 ``want_k3`` times (``SOME``: at least once), and no hash-keyed
    dataset took the host path for colliding keys
    (``hash_collision_fallbacks`` 0), and add the launches read to
    ``launches[label]`` ([K1, K2, K4, K5, K6, K7, K3]).
    -> (fn's result, the counters read)."""
    runtime.reset_stats()
    out = fn()
    stats = runtime.stats_snapshot()
    got = [stats["classify_launches"], stats["envelope_scan_launches"],
           stats["merge_classify_launches"], stats["envelope_join_launches"],
           stats["geom_refine_launches"], stats["merc_launches"], stats["bbox_launches"]]
    for name, n, w in zip(("K1", "K2", "K4", "K5", "K6", "K7", "K3"), got,
                          (want, want_k2, want_k4, want_k5, want_k6, want_k7, want_k3)):
        check(n >= 1 if w is SOME else n == w,
              f"{name} launched {n} times in phase {label}, expected "
              f"{'at least 1' if w is SOME else w}")
    check(stats["hash_collision_fallbacks"] == 0,
          f"phase {label} took the host path for colliding hash keys")
    total = launches.setdefault(label, [0] * 7)
    for i, n in enumerate(got):
        total[i] += n
    return out, stats


def sha256_of(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


#: the host steps of the fused json-lines route: {step: function name}
JSONL_STEPS = {
    "classify (sidecar mmap, upload, K1, changed rows)": "get_feature_diff_rows",
    "blob reads (pack index, zlib)": "read_blobs_data_ordered",
    "JSON serialisation (msgpack decode, compiled serialiser)": "feature_json_str_from_data",
    "tree walk": "tree_diff_entries",
}

#: the host steps of a spatially filtered json-lines run (the delta route)
FILTERED_JSONL_STEPS = {
    "K2 and the prefilter's host work (envelope upload, masks, hit keys)":
        "spatial_prefilter_blocks",
    "compaction of the survivors": "_compact",
    "K1 (upload of the survivors, classify, changed rows)": "classify_changed",
    "blob reads (pack index, zlib)": "read_blobs_batch",
    "residue (blob decode, exact match)": "_delta_matches_filter",
    "serialisation": "_feature_json_str",
}


def profile_split(fn, steps=JSONL_STEPS, top=12):
    """cProfile of one call -> (text of the top functions by own time,
    {step: cumulative seconds}) for ``steps``."""
    prof = cProfile.Profile()
    prof.runcall(fn)
    st = pstats.Stats(prof)
    split = {}
    for step, fn_name in steps.items():
        split[step] = max((v[3] for k, v in st.stats.items() if k[2] == fn_name), default=0.0)
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(top)
    return out.getvalue(), split


def cli_phases(args, card, launches, s_walls=None):
    """Phases 7-10: build the repository, then drive ``kart diff`` through
    the CLI, adding every card command's launches to ``launches``; with
    ``s_walls``, [S3]'s diff on the same repository (its wall in
    ``s_walls``)."""
    with tempfile.TemporaryDirectory(prefix="kart_smoke_repo_") as tmp:
        t = time.perf_counter()
        repo, info = synth_repo(os.path.join(tmp, "repo"), args.repo_rows, edit_frac=0.01,
                                seed=args.seed, blobs="changed")
        build_s = time.perf_counter() - t
        packs = repo.odb.packs.packs
        n_objects = sum(p.count for p in packs)
        pack_bytes = sum(os.path.getsize(p.pack_path) for p in packs)
        n_edits = info["n_edits"]
        path = repo.workdir
        print(f"[7] repo: {args.repo_rows} features, {n_edits} edited, built in "
              f"{build_s:.2f} s host wall; {n_objects} objects in {len(packs)} packs, "
              f"{pack_bytes} pack bytes")

        out = os.path.join(tmp, "count.txt")
        wall, _ = counted("8", lambda: kart_cli(
            "-C", path, "diff", "-o", "feature-count", "--output", out, "HEAD^...HEAD"),
            launches)
        with open(out) as f:
            text = f.read()
        check(text == f"synth:\n\t{n_edits} features changed\n", f"feature-count said {text!r}")
        print(f"[8] feature-count on the card: {n_edits} features changed, K1 launches 1, "
              f"{wall:.4f} s host wall on {card}")

        card_out, cpu_out = os.path.join(tmp, "card.jsonl"), os.path.join(tmp, "cpu.jsonl")
        jsonl = ["-C", path, "diff", "-o", "json-lines", "HEAD^...HEAD", "--output"]
        wall_card, _ = counted("9", lambda: kart_cli(*jsonl, card_out), launches)
        wall_cpu = kart_cli("--device", "cpu", *jsonl, cpu_out)
        digest = sha256_of(card_out)
        check(digest == sha256_of(cpu_out), "json-lines on the card differs from --device cpu")
        with open(card_out) as f:
            first = f.readline()
            n_lines = sum(1 for _ in f)
        check('"type":"version"' in first and n_lines == n_edits,
              f"json-lines has {n_lines} feature lines, expected {n_edits}")
        jsonl_digest = digest
        print(f"[9] json-lines: card {wall_card:.4f} s, cpu {wall_cpu:.4f} s host wall, "
              f"{os.path.getsize(card_out)} bytes, sha256 {digest} on both; "
              f"K1 launches 1 on {card}")
        for where, pre in (("card", []), ("cpu", ["--device", "cpu"])):
            profile, split = counted(
                "9", lambda: profile_split(lambda: kart_cli(*pre, *jsonl, card_out)),
                launches, want=int(where == "card"))[0]
            print(f"[9] host profile of the {where} run (cProfile, cumulative s): "
                  + "; ".join(f"{k} {v:.4f}" for k, v in split.items()))
            print(profile)

        json_args = ["-C", path, "diff", "-o", "json", "HEAD^...HEAD", "--output"]
        card_out, cpu_out = os.path.join(tmp, "card.json"), os.path.join(tmp, "cpu.json")
        wall_card, _ = counted("10", lambda: kart_cli(*json_args, card_out), launches)
        wall_cpu = kart_cli("--device", "cpu", *json_args, cpu_out)
        digest = sha256_of(card_out)
        check(digest == sha256_of(cpu_out), "json on the card differs from --device cpu")
        with open(card_out) as f:
            doc = json.load(f)
        n_json = len(doc["kart.diff/v1+hexwkb"]["synth"]["feature"])
        check(n_json == n_edits, f"json diff has {n_json} features, expected {n_edits}")
        print(f"[10] json: card {wall_card:.4f} s, cpu {wall_cpu:.4f} s host wall, "
              f"{n_json} features, {os.path.getsize(card_out)} bytes, sha256 {digest} on "
              f"both; K1 launches 1 on {card}")
        t = time.perf_counter()
        writer_phases(path, tmp, card, launches, n_edits, repo)
        print(f"[10a] phase host wall {time.perf_counter() - t:.4f} s on {card}")
        t = time.perf_counter()
        k1_estimation = estimation_phases(path, tmp, card, launches, n_edits, repo)
        print(f"[10b] phase host wall {time.perf_counter() - t:.4f} s on {card}")
        if s_walls is not None:
            s_walls["S3"] = s_walls.get("S3", 0.0) + stream_cli_diff(
                repo, path, tmp, card, launches, n_edits, jsonl_digest)
    return k1_estimation


#: the host steps of the text diff (the delta route), by cProfile name
TEXT_STEPS = {
    "classify (sidecar mmap, upload, K1, changed rows)": "classify_changed",
    "deltas from the changed rows": "get_feature_diff_columnar",
    "blob reads (pack index, zlib)": "read_blobs_batch",
    "feature decode (msgpack)": "get_feature",
    "text of the deltas": "write_feature_delta",
}


def writer_phases(path, tmp, card, launches, n_edits, repo):
    """Phase [10a] on [7]'s repository: the text, GeoJSON and HTML diffs,
    ``show`` (text and json) and ``create-patch`` on the card (one K1
    launch each) and with ``--device cpu``: equal sha256; then the card's
    text diff under cProfile."""
    head, parent = repo.refs.get("refs/heads/main"), repo.odb.read_commit(
        repo.refs.get("refs/heads/main")).parents[0]
    spec = "HEAD^...HEAD"
    runs = {
        "text": (["diff", spec], False),
        "geojson": (["diff", "-o", "geojson", spec], False),
        "html": (["diff", "-o", "html", spec], False),
        "show": (["show", "HEAD"], True),
        "show-json": (["show", "-o", "json", "HEAD"], True),
        "create-patch": (["create-patch", "HEAD"], False),
    }
    for name, (argv, stdout) in runs.items():
        out = os.path.join(tmp, name)
        w_card, w_cpu, digest, _ = card_and_cpu("10a", ["-C", path, *argv], out, launches, k2=0,
                                                stdout=stdout)
        with open(f"{out}.card") as f:
            body = f.read()
        if name in ("text", "show"):
            n = body.count("\n--- synth:feature:") + body.startswith("--- synth:feature:")
            check(n == n_edits, f"{name} shows {n} features, expected {n_edits}")
            check(name == "text" or body.startswith(f"commit {head}\n"), "show's header")
        elif name == "geojson":
            n = len(json.loads(body)["features"])
            check(n == 2 * n_edits, f"geojson has {n} features, expected {2 * n_edits}")
        elif name == "html":
            check(body.startswith("<!DOCTYPE html>") and body.count('"U+::') == n_edits,
                  "the html page lacks the features")
        else:
            doc = json.loads(body)
            n = len(doc["kart.diff/v1+hexwkb"]["synth"]["feature"])
            check(n == n_edits, f"{name} has {n} features, expected {n_edits}")
            check(doc["kart.show/v1"]["commit"] == head, f"{name}'s header")
            check(name == "show-json" or doc["kart.patch/v1"]["base"] == parent,
                  "create-patch's base")
        print(f"[10a] {' '.join(argv)}: {len(body)} chars, sha256 {digest} on both; card "
              f"{w_card:.4f} s, cpu {w_cpu:.4f} s host wall; K1 launches 1 on {card}")
    out = os.path.join(tmp, "text.prof")
    profile, split = counted("10a", lambda: profile_split(
        lambda: kart_cli("-C", path, "diff", spec, "--output", out), TEXT_STEPS), launches)[0]
    print("[10a] host profile of the card's text diff (cProfile, cumulative s): "
          + "; ".join(f"{k} {v:.4f}" for k, v in split.items()) + f" on {card}")
    print(profile)


def estimation_phases(path, tmp, card, launches, n_edits, repo):
    """Phase [10b] on [7]'s repository: ``diff --only-feature-count`` at
    each sampled accuracy and with ``-o json``: the annotations cache
    deleted before each route, one counts-only K1 launch on the card, the
    same bytes with ``--device cpu``; then a second card run answered by
    the cache (no launch, the same bytes); ``good`` and ``exact`` (no
    launch) print [8]'s count. Times K1 counts-only on each accuracy's
    sampled rows. -> those timings, for the kernels line."""
    db = os.path.join(repo.gitdir, "annotations.db")
    dev = runtime.resolve_device(None)
    old = load_block(repo, repo.structure("HEAD^").datasets["synth"])
    new = load_block(repo, repo.structure("HEAD").datasets["synth"])
    timings = []
    cases = [(acc, []) for acc in ACCURACY_SUBTREE_SAMPLES] + [("medium", ["-o", "json"])]
    for acc, extra in cases:
        argv = ["-C", path, "diff", "--only-feature-count", acc, *extra, "HEAD^...HEAD"]
        out = os.path.join(tmp, f"estimate-{acc}{'-json' if extra else ''}")
        walls = {}
        for where in ("card", "cpu"):
            if os.path.exists(db):
                os.remove(db)
            pre = [] if where == "card" else ["--device", "cpu"]

            def go(pre=pre, to=f"{out}.{where}"):
                with open(to, "w") as f, contextlib.redirect_stdout(f):
                    return kart_cli(*pre, *argv)

            if where == "card":
                walls[where], stats = counted("10b", go, launches)
                check(stats["classify_counts_only_launches"] == 1,
                      f"the {acc} estimate's K1 launch was not counts-only")
            else:
                walls[where] = go()
        walls["cached"], _ = counted("10b", lambda: go([], f"{out}.cached"), launches, want=0)
        digest = sha256_of(f"{out}.card")
        check(digest == sha256_of(f"{out}.cpu") == sha256_of(f"{out}.cached"),
              f"the {acc} estimate differs card / cpu / cached")
        with open(f"{out}.card") as f:
            text = f.read()
        if acc == "good" and not extra:
            check(text == f"synth:\n\t{n_edits} features changed\n",
                  f"good estimate said {text!r}")
        k = min(ACCURACY_SUBTREE_SAMPLES[acc], 64)
        so, sn = sample_block(old, k), sample_block(new, k)
        if not extra:
            ok, oo = block_tensors(so, dev)
            nk, no = block_tensors(sn, dev)
            rows = so.count + sn.count
            steps = so.count * np.log2(max(sn.count, 2)) + sn.count * np.log2(max(so.count, 2))
            b = bound(rows * 28 + 24, steps + rows * 5)
            t = {"accuracy": acc, "rows": [so.count, sn.count],
                 "ms": time_ms(lambda: classify(ok, oo, nk, no, counts_only=True)),
                 "device_ms": total_ms(device_ms(lambda: classify(ok, oo, nk, no, counts_only=True),
                                                 ("corank_kernel", "classify_tiles"))),
                 "bound_ms": b[0], "bound_by": b[1]}
            timings.append(t)
            del ok, oo, nk, no
        print(f"[10b] --only-feature-count {acc} {' '.join(extra)}: {text.strip()!r}; sampled "
              f"rows (old, new) ({so.count}, {sn.count}); sha256 {digest} card / cpu / cached; "
              f"host wall s: " + ", ".join(f"{w} {v:.4f}" for w, v in walls.items())
              + (f"; K1 counts-only {t['ms']:.4f} ms, device {fmt_ms(t['device_ms'])}, bound "
                 f"{t['bound_ms']:.4f} ms by {t['bound_by']}" if not extra else "")
              + f"; K1 launches 1 (cached: 0) on {card}")
    out = os.path.join(tmp, "estimate-exact")
    with open(out, "w") as f, contextlib.redirect_stdout(f):
        wall, _ = counted("10b", lambda: kart_cli("-C", path, "diff", "--only-feature-count",
                                                  "exact", "HEAD^...HEAD"), launches, want=0)
    with open(out) as f:
        text = f.read()
    check(text == f"synth:\n\t{n_edits} features changed\n", f"exact estimate said {text!r}")
    print(f"[10b] --only-feature-count exact: {text.strip()!r} (the tree walk, no launch); "
          f"{wall:.4f} s host wall on {card}")
    return timings


def set_filter(repo, spec_text):
    repo.config.set_many(ResolvedSpatialFilterSpec.from_spec_string(spec_text).config_items())


def card_and_cpu(label, argv, out_path, launches, rc_want=0, counts_only=False, k2=2,
                 stdout=False):
    """One command on the card, counted: exactly one K1 launch (one
    dataset; counts-only for ``counts_only``) and ``k2`` K2 launches (two
    under a spatial filter, one a side), added to ``launches``; then with
    ``--device cpu``. Fail unless both exit ``rc_want`` and write the same
    bytes to ``out_path`` (when given: ``--output``, or the standard output
    for ``stdout``). -> (card wall s, cpu wall s, sha256 or None, (old,
    new) rows the card's prefilter kept)."""
    walls, outs = [], []
    for where in ("card", "cpu"):
        path = None if out_path is None else f"{out_path}.{where}"
        cmd = [*argv, *([] if path is None or stdout else ["--output", path])]
        pre = [] if where == "card" else ["--device", "cpu"]

        def go():
            if not stdout:
                return kart_cli(*pre, *cmd, rc_want=rc_want)
            with open(path, "w") as f, contextlib.redirect_stdout(f):
                return kart_cli(*pre, *cmd, rc_want=rc_want)

        if where == "cpu":
            walls.append(go())
        else:
            wall, stats = counted(label, go, launches, want=1, want_k2=k2)
            n = stats["classify_counts_only_launches"]
            check(n == int(counts_only), f"K1 ran counts-only {n} times in phase {label}")
            survivors = (stats["prefilter_old_survivors"], stats["prefilter_new_survivors"])
            walls.append(wall)
        outs.append(path)
    digest = None
    if out_path is not None:
        digest = sha256_of(outs[0])
        check(digest == sha256_of(outs[1]), f"phase {label}: card and --device cpu differ")
    return walls[0], walls[1], digest, survivors


def spatial_phases(args, card, launches, dev, filters=True, query=True, tiles=True,
                   history=True):
    """Phases 11-13, Q1-Q3 and T1-T3: build the spatial repository, drive
    ``kart query`` on it (unless not ``query``; Q3 alone where ``query`` is
    ``"kernels"``) and ``kart export tiles``
    (unless not ``tiles``), before any spatial filter is set, then
    spatially filtered ``kart diff`` commands (unless not ``filters``),
    through the CLI on the card and with ``--device cpu``, adding every card
    command's launches to ``launches``; then [H0]-[H3] on the same layer
    (unless not ``history``). -> {"k5", "k6", "k7": entries of the kernels
    line (without launches)} for the phases run, and {"walls": {phase: host
    wall s}} for [12b] and [H0]-[H3]."""
    kernels = {}
    with tempfile.TemporaryDirectory(prefix="kart_smoke_spatial_") as tmp:
        t = time.perf_counter()
        repo, info = synth_repo(os.path.join(tmp, "repo"), args.spatial_rows, edit_frac=0.01,
                                seed=args.seed, blobs="changed", spatial=True)
        build_s = time.perf_counter() - t
        packs = repo.odb.packs.packs
        n_objects = sum(p.count for p in packs)
        pack_bytes = sum(os.path.getsize(p.pack_path) for p in packs)
        sidecar_bytes = sum(os.path.getsize(os.path.join(repo.gitdir, "columnar", f))
                            for f in os.listdir(os.path.join(repo.gitdir, "columnar")))
        n_edits, path = info["n_edits"], repo.workdir
        print(f"[11] spatial repo: {args.spatial_rows} point features, {n_edits} edited, "
              f"built in {build_s:.2f} s host wall; {n_objects} objects in {len(packs)} "
              f"packs, {pack_bytes} pack bytes, {sidecar_bytes} sidecar bytes on {card}")
        if query:
            t = time.perf_counter()
            kernels["k5"], kernels["k6"] = (
                query_kernels_alone(card, dev, *point_layer(repo)) if query == "kernels"
                else query_phases(repo, tmp, card, launches, dev))
            print(f"[Q] phases Q1-Q3 host wall {time.perf_counter() - t:.2f} s on {card}")
        if tiles:
            t = time.perf_counter()
            kernels["k7"] = tile_phases(repo, tmp, card, launches, dev)
            print(f"[T] phases T1-T3 host wall {time.perf_counter() - t:.2f} s on {card}")
        kernels["walls"] = {}
        if not filters:
            if history:
                kernels["walls"].update(history_phases(repo, tmp, card, launches,
                                                       args.history_commits, args.seed))
            return kernels

        spec = ["-C", path, "diff"]
        # [12] the rectangle
        set_filter(repo, FILTER_RECT)
        count_out = os.path.join(tmp, "count")
        w_card, w_cpu, _, survivors = card_and_cpu(
            "12", [*spec, "-o", "feature-count", "HEAD^...HEAD"], count_out, launches,
            counts_only=True)
        with open(f"{count_out}.card") as f:
            text = f.read()
        count = int(text.split("\t")[1].split()[0])
        check(0 < count < n_edits, f"filtered feature-count said {text!r}")
        print(f"[12] rect filter, survivors (old, new) {survivors}; "
              f"feature-count {count} of {n_edits} edits: card {w_card:.4f} s, cpu "
              f"{w_cpu:.4f} s host wall, equal output; K1 1 (counts-only), K2 2 on {card}")
        jl_out = os.path.join(tmp, "rect.jsonl")
        jsonl = [*spec, "-o", "json-lines", "HEAD^...HEAD"]
        w_card, w_cpu, digest, _ = card_and_cpu("12", jsonl, jl_out, launches)
        with open(f"{jl_out}.card") as f:
            n_lines = sum('"type":"feature"' in line for line in f)
        check(0 < n_lines <= count, f"filtered json-lines has {n_lines} feature lines")
        print(f"[12] rect filter json-lines: {n_lines} feature lines, "
              f"{os.path.getsize(jl_out + '.card')} bytes, sha256 {digest} on both; card "
              f"{w_card:.4f} s, cpu {w_cpu:.4f} s host wall; K1 1, K2 2 on {card}")
        profile, split = counted("12", lambda: profile_split(
            lambda: kart_cli(*jsonl, "--output", jl_out + ".prof"), FILTERED_JSONL_STEPS),
            launches, want_k2=2)[0]
        print("[12] host profile of the card's filtered json-lines run (cProfile, cumulative "
              "s): " + "; ".join(f"{k} {v:.4f}" for k, v in split.items()) + f" on {card}")
        print(profile)

        # [12a] text, and GeoJSON and json-lines reprojected to OSGB 1936
        t = time.perf_counter()
        plain_jsonl = sha256_of(f"{jl_out}.card")
        for name, argv in (("text", ["-o", "text"]),
                           ("geojson-4277", ["-o", "geojson", "--crs", "EPSG:4277"]),
                           ("jsonl-4277", ["-o", "json-lines", "--crs", "EPSG:4277"])):
            out = os.path.join(tmp, f"rect-{name}")
            w_card, w_cpu, digest, _ = card_and_cpu("12a", [*spec, *argv, "HEAD^...HEAD"], out,
                                                    launches)
            with open(f"{out}.card") as f:
                body = f.read()
            if name == "text":
                n = body.count("--- synth:feature:")
            elif name.startswith("geojson"):
                n = len(json.loads(body)["features"]) // 2
            else:
                n = body.count('"type":"feature"')
                check(digest != plain_jsonl, "--crs EPSG:4277 left the json-lines as they were")
            check(n == n_lines, f"filtered {name} has {n} features, json-lines {n_lines}")
            print(f"[12a] rect filter {' '.join(argv)}: {n} features, sha256 {digest} on both; "
                  f"card {w_card:.4f} s, cpu {w_cpu:.4f} s host wall; K1 1, K2 2 on {card}")
        print(f"[12a] phase host wall {time.perf_counter() - t:.4f} s on {card}")

        # [12b] projected filters, and projected --crs targets under the rectangle
        t = time.perf_counter()
        for name, spec_text in FILTERS_PROJECTED.items():
            set_filter(repo, spec_text)
            out = os.path.join(tmp, f"{name}-count")
            w_count, w_count_cpu, _, survivors = card_and_cpu(
                "12b", [*spec, "-o", "feature-count", "HEAD^...HEAD"], out, launches,
                counts_only=True)
            with open(f"{out}.card") as f:
                text = f.read()
            n_count = int(text.split("\t")[1].split()[0]) if text.strip() else 0
            check(0 < n_count < n_edits, f"[12b] {name} feature-count said {text!r}")
            out = os.path.join(tmp, f"{name}.jsonl")
            w_card, w_cpu, digest, _ = card_and_cpu(
                "12b", [*spec, "-o", "json-lines", "HEAD^...HEAD"], out, launches)
            with open(f"{out}.card") as f:
                n = sum('"type":"feature"' in line for line in f)
            check(0 < n <= n_count, f"[12b] {name} json-lines has {n} feature lines")
            wsen = ResolvedSpatialFilterSpec.from_spec_string(spec_text).envelope_wsen_4326
            if name == "utm60s":
                check(wsen[2] > 180, f"[12b] the UTM 60S filter's envelope {wsen} stops short "
                                     "of the anti-meridian")
            print(f"[12b] {name} filter (EPSG:4326 envelope {tuple(round(v, 4) for v in wsen)}), "
                  f"survivors (old, new) {survivors}: feature-count {n_count} (card "
                  f"{w_count:.4f} s, cpu {w_count_cpu:.4f} s host wall, K1 1 counts-only, K2 2), "
                  f"json-lines {n} features, sha256 {digest} on both (card {w_card:.4f} s, cpu "
                  f"{w_cpu:.4f} s host wall, K1 1, K2 2) on {card}")
        set_filter(repo, FILTER_RECT)
        for name, argv in (("jsonl-2193", ["-o", "json-lines", "--crs", "EPSG:2193"]),
                           ("geojson-3857", ["-o", "geojson", "--crs", "EPSG:3857"])):
            out = os.path.join(tmp, f"rect-{name}")
            w_card, w_cpu, digest, _ = card_and_cpu("12b", [*spec, *argv, "HEAD^...HEAD"], out,
                                                    launches)
            with open(f"{out}.card") as f:
                body = f.read()
            if name.startswith("geojson"):
                feats = json.loads(body)["features"]
                n = len(feats) // 2
                check(any(abs(c) > 180 for f in feats if f["geometry"]
                          for c in f["geometry"]["coordinates"]),
                      "--crs EPSG:3857 left the GeoJSON in degrees")
            else:
                n = body.count('"type":"feature"')
                check(digest != plain_jsonl, "--crs EPSG:2193 left the json-lines as they were")
            check(n == n_lines, f"[12b] rect filter {name} has {n} features, json-lines {n_lines}")
            print(f"[12b] rect filter {' '.join(argv)}: {n} features, sha256 {digest} on both; "
                  f"card {w_card:.4f} s, cpu {w_cpu:.4f} s host wall; K1 1, K2 2 on {card}")
        kernels["walls"]["12b"] = time.perf_counter() - t
        print(f"[12b] phase host wall {kernels['walls']['12b']:.4f} s on {card}")

        # [13] the polygon with a hole
        set_filter(repo, FILTER_POLY)
        js_out = os.path.join(tmp, "poly.json")
        w_card, w_cpu, digest, survivors = card_and_cpu(
            "13", [*spec, "-o", "json", "HEAD^...HEAD"], js_out, launches)
        with open(f"{js_out}.card") as f:
            n_json = len(json.load(f)["kart.diff/v1+hexwkb"]["synth"]["feature"])
        check(n_json > 0, "polygon-filtered json has no feature")
        print(f"[13] polygon filter, survivors (old, new) {survivors}; json "
              f"{n_json} features, sha256 {digest} on both; card {w_card:.4f} s, cpu "
              f"{w_cpu:.4f} s host wall; K1 1, K2 2 on {card}")
        quiet = [*spec, "-o", "quiet", "--exit-code", "HEAD^...HEAD"]
        w_card, w_cpu, _, _ = card_and_cpu("13", quiet, None, launches, rc_want=1)
        print(f"[13] polygon filter quiet --exit-code: 1 on both; card {w_card:.4f} s, cpu "
              f"{w_cpu:.4f} s host wall; K1 1, K2 2 on {card}")

        # a rect around one unedited feature: survivors, but no change
        old = load_block(repo, repo.structure("HEAD^").datasets["synth"])
        new = load_block(repo, repo.structure("HEAD").datasets["synth"])
        same = np.flatnonzero((np.asarray(old.oids[: old.count])
                               == np.asarray(new.oids[: new.count])).all(axis=1))
        w, s, e, n = (float(v) for v in old.envelopes[same[len(same) // 2]])
        cx, cy = (w + e) / 2, (s + n) / 2
        lone = (f"EPSG:4326;POLYGON(({cx - 2e-4} {cy - 2e-4},{cx + 2e-4} {cy - 2e-4},"
                f"{cx + 2e-4} {cy + 2e-4},{cx - 2e-4} {cy + 2e-4},{cx - 2e-4} {cy - 2e-4}))")
        set_filter(repo, lone)
        w_card, w_cpu, _, survivors = card_and_cpu("13", quiet, None, launches, rc_want=0)
        check(min(survivors) > 0, "the lone-feature rect has no survivor")
        none_out = os.path.join(tmp, "none.jsonl")
        w2_card, w2_cpu, digest, _ = card_and_cpu("13", jsonl, none_out, launches)
        with open(f"{none_out}.card") as f:
            lines = f.read().splitlines()
        check(len(lines) == 1 and '"type":"version"' in lines[0],
              f"json-lines under the lone-feature rect holds {len(lines) - 1} more lines")
        print(f"[13] rect around one unedited feature, survivors (old, new) "
              f"{survivors}: quiet --exit-code 0 on both (card {w_card:.4f} s, cpu "
              f"{w_cpu:.4f} s host wall), json-lines the version line only (card "
              f"{w2_card:.4f} s, cpu {w2_cpu:.4f} s); K1 1, K2 2 a command on {card}")
        if history:
            kernels["walls"].update(history_phases(repo, tmp, card, launches,
                                                   args.history_commits, args.seed))
    return kernels


# --- history on [11]'s layer: the changed-block CDC, kart log, build-annotations (K1) ---

def history_commits(repo, n_commits, seed):
    """[H0]: ``n_commits`` commits on top of [11]'s HEAD, each moving 0.1%
    of the live rows (real blobs at new points), deleting 0.01% and
    inserting 0.01% past the max pk (real blobs); the second moves half
    its rows onto the anti-meridian (+-180 and +-179.99999) and a third
    onto the poles. No sidecar is written, as a pushed history arrives.
    -> (the tips from [11]'s edit commit on, each commit's truth, a pk
    moved by the first commit and by no later one)."""
    rng = np.random.default_rng(seed + 11)
    ds = repo.structure("HEAD").datasets["synth"]
    block = load_block(repo, ds)
    live = np.asarray(block.keys[: block.count]).copy()
    next_pk = int(live[-1]) + 1
    tips, truths, touched = [repo.head_commit_oid], [], []
    for c in range(n_commits):
        k_move, k_ins = len(live) // 1000, len(live) // 10000
        pick = rng.choice(len(live), k_move + k_ins, replace=False)
        moved, gone = live[pick[:k_move]], live[pick[k_move:]]
        lon, lat = rng.uniform(-180.0, 180.0, k_move), rng.uniform(-85.0, 85.0, k_move)
        if c == 1 % n_commits:
            lon[: k_move // 2] = rng.choice([-180.0, 180.0, 179.99999, -179.99999], k_move // 2)
            lat[::3] = rng.choice([-90.0, 90.0], len(lat[::3]))
        new = np.arange(next_pk, next_pk + k_ins, dtype=np.int64)
        next_pk += k_ins
        tips.append(commit_point_edits(
            repo, moves=(moved, lon, lat),
            inserts=(new, rng.uniform(-180.0, 180.0, k_ins), rng.uniform(-85.0, 85.0, k_ins)),
            deletes=gone, message=f"history {c}\n\nmoves {k_move}, deletes and inserts {k_ins}"))
        touched.append((moved, gone))
        live = np.sort(np.concatenate([np.setdiff1d(live, gone, assume_unique=True), new]))
        truths.append({"inserts": k_ins, "updates": k_move, "deletes": k_ins})
    later = np.concatenate([np.concatenate(t) for t in touched[1:]] or [np.zeros(0, np.int64)])
    first_moved = int(np.setdiff1d(touched[0][0], later)[0])
    return tips, truths, first_moved


def _tip_sidecar(repo, commit):
    return sidecar_file(repo, repo.structure(commit).datasets["synth"].feature_tree.oid)


def _derived_header(path):
    with open(path, "rb") as f:
        f.readline()
        return json.loads(f.readline())


class _Split:
    """Host seconds spent in the CDC's three steps (derive, classify,
    cover), read by wrapping the module's functions while it runs."""

    STEPS = {"derive": "ensure_derived_sidecar", "classify": "changed_envelopes",
             "cover": "tiles_for_envelopes"}

    def __enter__(self):
        self.seconds = dict.fromkeys(self.STEPS, 0.0)
        self._saved = {}
        for step, name in self.STEPS.items():
            fn = getattr(cdc, name)
            self._saved[name] = fn

            def timed(*a, _fn=fn, _step=step, **kw):
                t = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.seconds[_step] += time.perf_counter() - t

            setattr(cdc, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(cdc, name, fn)


def _summary_sha(summary):
    return hashlib.sha256(json.dumps(summary).encode()).hexdigest()


def cdc_phase(repo, tips, truths, card, launches):
    """[H1]: ``dirty_tiles`` at zooms 0-8 for each consecutive pair of
    tips on the card (one K1 launch an event, the new tip's sidecar
    derived), then, with the derived files deleted and the tile sources
    dropped, with ``device="cpu"``: equal summary and derived-sidecar
    sha256, and ``changed`` equal to [H0]'s truth. Then the whole range
    (truncated, with a bbox), a created ref (``old_oid=None``: no K1) and
    an identical pair (empty, no K1), on both routes."""
    files = [_tip_sidecar(repo, t) for t in tips[1:]]
    routes = {}
    for route in ("card", "cpu"):
        for f in files:
            if os.path.exists(f):
                os.remove(f)
        drop_sources(repo.gitdir)
        device = None if route == "card" else "cpu"
        rows = []
        for i, (old, new, f) in enumerate(zip(tips, tips[1:], files)):
            check(not os.path.exists(f), f"[H1] {new[:7]} has a sidecar before its event")
            t = time.perf_counter()
            with _Split() as split:
                if route == "card":
                    summary = counted("H1", lambda: cdc.dirty_tiles(repo, old, new),
                                      launches)[0]
                else:
                    summary = cdc.dirty_tiles(repo, old, new, device="cpu")
            wall = time.perf_counter() - t
            entry = summary.get("synth", {})
            check(entry.get("changed") == truths[i],
                  f"[H1] {route} event {i} changed {entry.get('changed')} != {truths[i]}")
            header = _derived_header(f)
            check(header["envelope_bytes"] > 0 and "geom_bytes" not in header,
                  f"[H1] {new[:7]}'s sidecar was not derived: {header}")
            rows.append((_summary_sha(summary), sha256_of(f), entry["tile_count"],
                         entry["truncated"]))
            print(f"[H1] {route} event {i} {old[:7]}..{new[:7]}: {entry['changed']}, "
                  f"{entry['tile_count']} tiles (truncated {entry['truncated']}), wall "
                  f"{wall:.4f} s: " + ", ".join(f"{k} {v:.4f}" for k, v in split.seconds.items())
                  + f" s on {card}")
        extra = []
        for label, old, new, want in (("range", tips[0], tips[-1], 1),
                                      ("create", None, tips[-1], 0),
                                      ("same", tips[-1], tips[-1], 0)):
            t = time.perf_counter()
            if route == "card":
                summary = counted("H1", lambda: cdc.dirty_tiles(repo, old, new), launches,
                                  want=want)[0]
            else:
                summary = cdc.dirty_tiles(repo, old, new, device="cpu")
            wall = time.perf_counter() - t
            if label == "same":
                check(summary == {}, f"[H1] an identical pair gave {summary}")
            else:
                entry = summary["synth"]
                check(entry["truncated"] and entry["tiles"] is None and entry["bbox"] is not None,
                      f"[H1] {label}: truncated {entry['truncated']}, bbox {entry['bbox']}")
            extra.append(_summary_sha(summary))
            print(f"[H1] {route} {label}: {json.dumps(summary)[:160]}; wall {wall:.4f} s on {card}")
        routes[route] = (rows, extra)
    check(routes["card"] == routes["cpu"], "[H1] the card's summaries or derived sidecars differ "
                                           "from the CPU route's")
    n_changed = sum(sum(t.values()) for t in truths)
    print(f"[H1] {len(files)} events, {n_changed} changed rows: summaries and derived sidecars "
          f"equal on the card and the CPU, changed equal to [H0]'s truth on {card}")


def _log_runs(path, tmp, label, argv, launches, k1, counts_only=0, db=None, rc_want=0):
    """One ``kart log`` on the card (K1 ``k1`` times, ``counts_only`` of
    them counts-only) and with ``--device cpu``, ``db`` (the annotations
    cache) deleted before each: equal stdout sha256 and exit codes.
    -> (sha256, card wall s, cpu wall s)."""
    out = os.path.join(tmp, f"log-{label}")
    walls = []
    for where in ("card", "cpu"):
        if db is not None and os.path.exists(db):
            os.remove(db)
        pre = [] if where == "card" else ["--device", "cpu"]

        def go():
            with open(f"{out}.{where}", "w") as f, contextlib.redirect_stdout(f):
                return kart_cli(*pre, "-C", path, "log", *argv, rc_want=rc_want)

        if where == "card":
            wall, stats = counted("H2", go, launches, want=k1)
            n = stats["classify_counts_only_launches"]
            check(n == counts_only, f"[H2] {label}: K1 ran counts-only {n} times, expected "
                                    f"{counts_only}")
        else:
            wall = go()
        walls.append(wall)
    digest = sha256_of(f"{out}.card")
    check(digest == sha256_of(f"{out}.cpu"), f"[H2] log {' '.join(argv)}: card and --device cpu "
                                             "differ")
    return digest, walls[0], walls[1]


def _annotation_rows(db):
    with contextlib.closing(sqlite3.connect(db)) as con:
        return con.execute("SELECT id, object_id, annotation_type, data FROM kart_annotations "
                           "ORDER BY id").fetchall()


def log_phase(repo, tmp, tips, moved_pk, card, launches):
    """[H2]: ``kart log`` on the card and with ``--device cpu``: equal
    stdout sha256 and exit codes, K1 as the history predicts (every diffed
    commit has a sidecar on both sides but the root, whose diff is the tree
    walk)."""
    path, db = repo.workdir, os.path.join(repo.gitdir, "annotations.db")
    n_hist = len(tips) - 1
    n_all = n_hist + 2  # with [11]'s import and edit commits
    head_time = repo.odb.read_commit(tips[-1]).committer.time
    cases = [
        ("text", [], 0, 0),
        ("oneline-graph", ["--oneline", "--graph"], 0, 0),
        # the root's diff is a tree walk of every row on each route: left
        # out here, it runs in [H3]
        ("json-datasets", ["-o", "json", "--with-dataset-changes", "-n", str(n_all - 1)],
         n_all - 1, 0),
        ("jsonl-veryfast", ["-o", "json-lines", "--with-feature-count", "veryfast"],
         n_all - 1, n_all - 1),
        ("json-exact-3", ["-o", "json", "--with-feature-count", "exact", "-n", "3"], 0, 0),
        # the newest change of a moved feature: one K1 a walked commit
        ("feature", ["--oneline", "-n", "1", f"synth:feature:{moved_pk}"], n_hist, 0),
        ("grep", ["--oneline", "--grep", "^history [02468]"], 0, 0),
        ("author", ["--oneline", "--author", "Synth", "--author", "^Nobody"], 0, 0),
        ("since", ["-o", "json", "--since", f"@{head_time}"], 0, 0),
        ("skip", ["--oneline", "--skip", "2", "-n", "3"], 0, 0),
    ]
    for label, argv, k1, k1_counts in cases:
        digest, w_card, w_cpu = _log_runs(path, tmp, label, argv, launches, k1, k1_counts,
                                          db=db if "--with-feature-count" in argv else None)
        with open(os.path.join(tmp, f"log-{label}.card")) as f:
            body = f.read()
        check(body.strip(), f"[H2] log {' '.join(argv)} printed nothing")
        print(f"[H2] log {' '.join(argv)}: {len(body.splitlines())} lines, sha256 {digest} on "
              f"both; card {w_card:.4f} s, cpu {w_cpu:.4f} s host wall; K1 {k1}"
              + (f" ({k1_counts} counts-only)" if k1_counts else "") + f" on {card}")
    with open(os.path.join(tmp, "log-feature.card")) as f:
        check(f.read().split()[0] == tips[1][:7], "[H2] the feature filter did not stop at the "
                                                  "commit that moved the feature")


def annotations_phase(repo, tips, card, launches):
    """[H3]: ``kart build-annotations`` on the card with a fresh cache (one
    K1 a commit but the root), again (no launch: every count cached), and
    with ``--device cpu`` on a fresh cache: equal rows in order."""
    path, db = repo.workdir, os.path.join(repo.gitdir, "annotations.db")
    n_all = len(tips) + 1
    runs = []
    for label, pre, fresh, k1 in (("card", [], True, n_all - 1), ("card again", [], False, 0),
                                  ("cpu", ["--device", "cpu"], True, None)):
        if fresh and os.path.exists(db):
            os.remove(db)
        buf = io.StringIO()

        def go():
            with contextlib.redirect_stdout(buf):
                return kart_cli(*pre, "-C", path, "build-annotations")

        wall = counted("H3", go, launches, want=k1)[0] if k1 is not None else go()
        check(buf.getvalue() == f"Built annotations for {n_all} commit(s)\n",
              f"[H3] {label} printed {buf.getvalue()!r}")
        rows = _annotation_rows(db)
        runs.append(rows)
        print(f"[H3] build-annotations ({label}): {len(rows)} rows, {wall:.4f} s host wall; "
              f"K1 {k1 if k1 is not None else '(cpu)'} on {card}")
    check(runs[0] == runs[1] == runs[2], "[H3] the annotation rows differ between the runs")
    counts = [json.loads(r[3]).get("synth") for r in runs[0]]
    print(f"[H3] rows equal on the three runs; counts newest first {counts} on {card}")


def history_phases(repo, tmp, card, launches, n_commits, seed):
    """[H0]-[H3] on [11]'s layer (after every phase that reads it at its
    own HEAD). -> {phase: host wall s}."""
    walls = {}
    t = time.perf_counter()
    tips, truths, moved_pk = history_commits(repo, n_commits, seed)
    walls["H0"] = time.perf_counter() - t
    print(f"[H0] {n_commits} commits on the point layer, each {truths[0]}: "
          f"{walls['H0']:.4f} s host wall on {card}")
    for label, fn in (("H1", lambda: cdc_phase(repo, tips, truths, card, launches)),
                      ("H2", lambda: log_phase(repo, tmp, tips, moved_pk, card, launches)),
                      ("H3", lambda: annotations_phase(repo, tips, card, launches))):
        t = time.perf_counter()
        fn()
        walls[label] = time.perf_counter() - t
    print("[H] phase walls s: " + ", ".join(f"[{k}] {v:.2f}" for k, v in walls.items())
          + f"; all {sum(walls.values()):.2f} on {card}")
    return walls


# --- the envelope index and the blob filter on a layer of real blobs (K3) -----

#: [11i]'s blob filters: [12]'s rectangle as w,s,e,n, then the NZTM polygon's
#: wire argument
BLOB_FILTER_RECT = "-60,-30,60,30"


def _cli_stdout(label, launches, *argv):
    """One counted CLI command that launches no kernel. -> (wall s, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        wall = counted(label, lambda: kart_cli(*argv), launches, want=0)[0]
    return wall, buf.getvalue()


def _verdicts(blob_filter, pairs):
    """The filter's verdict on every (path, oid) as bytes. -> (bytes, wall s)."""
    t = time.perf_counter()
    out = bytes(bytearray(blob_filter(p, o) for p, o in pairs))
    return out, time.perf_counter() - t


def index_phases(args, card, launches, dev):
    """Phase 11i: ``synth_repo(spatial=True, blobs="real")`` at
    ``--index-repo-rows``, ``kart spatial-filter index`` (twice) and
    ``resolve`` through the CLI, then ``blob_filter_for_spec`` on the card
    (one K3 launch a filter, the second filter's columns resident) and with
    ``device="cpu"`` over every feature blob of HEAD and HEAD^, its
    verdicts held to K3's plain version on the card. -> K3's figures on
    the index's envelopes, and the phase's host wall."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kart_smoke_index_") as tmp:
        t = time.perf_counter()
        repo, info = synth_repo(os.path.join(tmp, "repo"), args.index_repo_rows, seed=args.seed,
                                blobs="real", spatial=True)
        build_s = time.perf_counter() - t
        n, n_edits, path = info["n"], info["n_edits"], repo.workdir
        index_s, line = _cli_stdout("11i", launches, "-C", path, "spatial-filter", "index")
        m = re.fullmatch(r"Indexed (\d+) feature envelopes over (\d+) new commits\n", line)
        check(m is not None and int(m[2]) == 2 and int(m[1]) >= n + n_edits,
              f"[11i] spatial-filter index said {line!r}")
        again_s, line2 = _cli_stdout("11i", launches, "-C", path, "spatial-filter", "index")
        check(line2 == "Indexed 0 feature envelopes over 0 new commits\n",
              f"[11i] the second index run said {line2!r}")
        with EnvelopeIndexReader.open(repo.gitdir) as reader:
            oids, wsen = reader.all_envelopes()
        check(len(oids) == n + n_edits, f"[11i] the index holds {len(oids)} rows, "
                                        f"expected {n + n_edits}")
        row = {o: i for i, o in enumerate(oids)}
        pairs, checked = [], 0
        for rev in ("HEAD^", "HEAD"):
            ds = repo.structure(rev).datasets["synth"]
            paths, pks, blob_oids = ds.feature_index()
            hexes = blob_oids.tobytes().hex()
            rev_oids = [hexes[40 * i: 40 * i + 40] for i in range(len(paths))]
            pairs += [(f"synth/.table-dataset/feature/{p}", o) for p, o in zip(paths, rev_oids)]
            block = load_block(repo, ds, pad=False)
            env = np.asarray(block.envelopes).astype(np.float64)
            # each row's blob is the point at its sidecar envelope's south-west
            # corner: the decoded envelope must hold it
            idx = np.asarray([row[o] for o in rev_oids])
            by_key = np.searchsorted(np.asarray(block.keys[: block.count]), pks)
            x, y = env[by_key, 0], env[by_key, 1]
            got = wsen[idx]
            check(bool(((got[:, 0] <= x) & (x <= got[:, 2]) & (got[:, 1] <= y)
                        & (y <= got[:, 3])).all()),
                  f"[11i] an indexed envelope of {rev} misses its row's point")
            checked += len(idx)
        print(f"[11i] real-blob layer: {n} point features, {n_edits} edited, built in "
              f"{build_s:.2f} s; spatial-filter index {line.strip()!r} in {index_s:.2f} s host "
              f"wall, again {line2.strip()!r} in {again_s:.4f} s; {len(oids)} index rows, "
              f"{checked} rows' points inside their decoded envelopes on {card}")

        for name in FILTERS_PROJECTED:
            spec_text = FILTERS_PROJECTED[name]
            wall, out = _cli_stdout("11i", launches, "-C", path, "spatial-filter", "resolve",
                                    "-o", "json", spec_text)
            doc = json.loads(out)["kart.spatialfilter/v1"]
            w, s_, e, n_ = ResolvedSpatialFilterSpec.from_spec_string(spec_text).envelope_wsen_4326
            check(doc["crs"] == spec_text.split(";")[0]
                  and doc["envelope4326"] == {"w": w, "s": s_, "e": e, "n": n_},
                  f"[11i] resolve {name} printed {doc}")
            print(f"[11i] spatial-filter resolve -o json {name}: envelope4326 "
                  f"{doc['envelope4326']} in {wall:.4f} s host wall on {card}")

        q_args = [BLOB_FILTER_RECT, ResolvedSpatialFilterSpec.from_spec_string(
            FILTERS_PROJECTED["nztm"]).filter_arg]
        padded = [torch.from_numpy(c).to(dev) for c in bbox_ops.pad_envelopes(wsen)[:4]]
        uploads = []
        for arg in q_args:
            t = time.perf_counter()
            bf, stats = counted("11i", lambda arg=arg: blob_filter_for_spec(repo, arg), launches,
                                want=0, want_k3=1)
            make_s = time.perf_counter() - t
            uploads.append(stats["bbox_uploads"])
            card_v, card_s = _verdicts(bf, pairs)
            cpu_v, cpu_s = _verdicts(blob_filter_for_spec(repo, arg, device="cpu"), pairs)
            check(card_v == cpu_v, f"[11i] blob filter {arg}: card and cpu verdicts differ")
            w, s_, e, n_ = (float(v) for v in arg.split(","))
            q = (w - PREPASS_PAD, s_ - PREPASS_PAD, e + PREPASS_PAD, n_ + PREPASS_PAD)
            plain = bbox_ops.bbox_cyclic_plain(*padded, q)[: len(oids)].cpu().numpy()
            want = bytes(bytearray(bool(plain[row[o]]) for _, o in pairs))
            check(card_v == want, f"[11i] blob filter {arg}: verdicts differ from K3's plain "
                                  "version")
            kept = sum(card_v)
            check(0 < kept < len(pairs), f"[11i] blob filter {arg} kept {kept} of {len(pairs)}")
            print(f"[11i] blob_filter_for_spec {arg}: {kept} of {len(pairs)} feature blobs "
                  f"kept, verdict sha256 {hashlib.sha256(card_v).hexdigest()} on the card, the "
                  f"cpu and K3's plain version; filter built in {make_s:.4f} s (K3 1, "
                  f"{stats['bbox_uploads']} upload), verdicts {card_s:.2f} s card / "
                  f"{cpu_s:.2f} s cpu host wall on {card}")
        check(uploads == [1, 0], f"[11i] the blob filters uploaded {uploads} times, "
                                 "expected [1, 0] (the second resident)")

        # K3 alone on the index's envelopes
        key = ("envidx", db_path(repo.gitdir), os.stat(db_path(repo.gitdir)).st_mtime_ns)
        w, s_, e, n_, cnt = bbox_ops._resident_columns(key, wsen, dev)
        query = [float(v) for v in BLOB_FILTER_RECT.split(",")]
        b = bound(cnt * 16 + w.numel(), cnt * 16)
        per, fenced = device_times(lambda: bbox_ops.bbox_cyclic(w, s_, e, n_, query, cnt),
                                   ("bbox_kernel",))
        k3_index = {
            "rows": cnt,
            "ms": time_ms(lambda: bbox_ops.bbox_cyclic(w, s_, e, n_, query, cnt)),
            "device_ms": total_ms(per), "fenced_ms": fenced,
            "plain_ms": time_ms(lambda: bbox_ops.bbox_cyclic_plain(w, s_, e, n_, query),
                                batches=3, per_batch=3),
            "bound_ms": b[0], "bound_by": b[1],
        }
        print(f"[11i] K3 on the index's {cnt} envelopes: {k3_index['ms']:.4f} ms, device "
              f"{fmt_ms(k3_index['device_ms'])}, fenced {fenced:.4f} ms (plain "
              f"{k3_index['plain_ms']:.4f} ms, bound {b[0]:.4f} ms by {b[1]}) on {card}")
    wall = time.perf_counter() - t_phase
    print(f"[11i] phase host wall {wall:.2f} s on {card}")
    return k3_index, wall


# --- kart query on the point layer: scans, the time-travel join, K5 and K6 ----

#: [Q1]'s rectangle, the bounding box of [12]'s filter, and a rectangle
#: wrapping the anti-meridian
QUERY_RECT = "-60,-30,60,30"
QUERY_WRAP = "170,-30,-170,30"
#: [Q2]'s restriction for the --device cpu comparison: an 18-degree meridian
#: strip, ~5% of the point layer (~100,000 rows a side)
JOIN_STRIP = "0,-90,18,90"
#: the synthetic layer's first pk
SYNTH_PK_BASE = 1 << 24

#: K5's least instructions a pair test, each row's wrap bit known (one
#: compare a row): 4 f32 compares chained on their predicate (lat & a & b
#: where neither row wraps, lat & (a | b) where one does) and the count's
#: add; 2 compares and the add where both wrap (lat alone)
K5_OPS_PER_TEST = 5
K5_OPS_BOTH_WRAP = 3
#: K6's integer instructions: a segment test (16 widening multiplies, 4
#: int64 subtractions of 2, 8 int64 sign tests of 2, 24 int32 subtractions,
#: ~2 of logic) and a ray crossing (4 int32 subtractions, 2 widening
#: multiplies, 1 int64 subtraction of 2, 4 int32 and 2 int64 compares, ~2 of
#: logic)
K6_OPS_PER_SEGMENT_TEST = 58
K6_OPS_PER_CROSSING = 14
#: K6's culls (csrc/geom_refine.cu): a segment's box (4 min/max), a box
#: test (4 compares), a start (or a feature's box) against the other side's
#: start range (3 compares), the half-open y test of a crossing (2 compares
#: and their xor)
K6_OPS_SEGMENT_BOX = 4
K6_OPS_BOX_TEST = 4
K6_OPS_START = 3
K6_OPS_UPWARD = 3
#: the kernels each wrapper launches, by name fragment for the profiler (K6's
#: last, the one kernel of its earlier design, so that --kernels-only times
#: an older checkout too)
K5_KERNELS = ("envelope_join_kernel",)
K6_KERNELS = ("geom_refine_short_kernel", "geom_refine_long_kernel", "geom_refine_kernel")
#: the longest side of a pair K6's short kernel takes (SHORT_SEGMENTS in
#: ops/geom_refine.py): the main path's box pairs must be short
K6_SHORT_SIDE = 8
#: the smaller join batch Q3 times K5 on
SMALL_BATCH_ROWS = 12_288
#: H100 SXM issue rates at the 1,980 MHz boost clock over 132 SMs: f32
#: compares and predicate logic on the 128 FMA/ALU lanes of an SM, int32
#: multiply-adds on its 64 integer lanes
PRED_OPS_PER_S = 132 * 128 * 1.98e9
INT_OPS_PER_S = 132 * 64 * 1.98e9

#: the host steps of the card's full join (cProfile function names)
JOIN_STEPS = {
    "vertex column decode (none when the process memo holds it)": "decode_vertex_column",
    "segment tables (build, upload)": "resident_segments",
    "block classes (host)": "classify_env_blocks_np",
    "K5's wrapper (launch, total read back, pairs)": "envelope_join",
    "the refine's glue (pair masks, gathers, count updates)": "_refine_chunk",
    "K6's wrapper": "geom_refine",
    "the join loop": "join_counts_for_range",
}


def query_doc(path):
    with open(path) as f:
        return json.load(f)["kart.query/v2"]


def query_card_and_cpu(label, argv, out_path, launches, k2=0, k5=0, k6=0, rc_want=0):
    """``kart query`` on the card, counted (K2, K5 and K6 as asked, no K1
    or K4), then with ``--device cpu``: both exit alike (``rc_want``, or
    any code when it is None) and print the same bytes. -> (card wall s,
    cpu wall s, sha256, card counters, exit code)."""
    walls, rcs = [], []
    for where in ("card", "cpu"):
        pre = [] if where == "card" else ["--device", "cpu"]

        def go(pre=pre, to=f"{out_path}.{where}"):
            t = time.perf_counter()
            with open(to, "w") as f, contextlib.redirect_stdout(f):
                rcs.append(kart_main([*pre, *argv]))
            torch.cuda.synchronize()
            return time.perf_counter() - t

        if where == "card":
            wall, stats = counted(label, go, launches, want=0, want_k2=k2, want_k5=k5,
                                  want_k6=k6)
        else:
            wall = go()
        walls.append(wall)
    check(rcs[0] == rcs[1] and rc_want in (None, rcs[0]),
          f"kart {' '.join(argv)} exited {rcs} (card, cpu), expected {rc_want}")
    digest = sha256_of(f"{out_path}.card")
    check(digest == sha256_of(f"{out_path}.cpu"), f"phase {label}: card and --device cpu differ "
                                                  f"on {' '.join(argv)}")
    return walls[0], walls[1], digest, stats, rcs[0]


def point_layer(repo):
    """[11]'s point layer at HEAD^ and HEAD, as feature blocks."""
    return tuple(load_block(repo, repo.structure(rev).datasets["synth"])
                 for rev in ("HEAD^", "HEAD"))


def query_phases(repo, tmp, card, launches, dev):
    """Phases Q1-Q3 on [11]'s point layer. -> K5's and K6's entries of the
    kernels line (without launches)."""
    path = repo.workdir
    spec = ["-C", path, "query", "HEAD", "synth"]
    old, new = point_layer(repo)
    n_rows = new.count

    # [Q1] scans
    rect = [*spec, "--bbox", QUERY_RECT]
    out = os.path.join(tmp, "q1-count")
    w_card, w_cpu, digest, st, _ = query_card_and_cpu("Q1", [*rect, "-o", "count"], out, launches,
                                                   k2=1, k6=SOME)
    exact = query_doc(f"{out}.card")
    check(exact["exact"] and 0 < exact["count"] < n_rows
          and exact["stats"]["pairs_refined"] >= exact["stats"]["rows_scanned"] > 0,
          f"the exact --bbox scan said {exact}")
    print(f"[Q1] query --bbox {QUERY_RECT} -o count: {exact['count']} of {n_rows} rows, "
          f"pairs_refined {exact['stats']['pairs_refined']}, blocks pruned "
          f"{exact['stats']['blocks_pruned']} of {exact['stats']['blocks']}; K2 1, K6 "
          f"{st['geom_refine_launches']}; sha256 {digest} on both; card {w_card:.4f} s, cpu "
          f"{w_cpu:.4f} s host wall on {card}")
    out = os.path.join(tmp, "q1-approx")
    w_card, w_cpu, digest, *_ = query_card_and_cpu(
        "Q1", [*rect, "-o", "count", "--approx"], out, launches, k2=1, k6=0)
    approx = query_doc(f"{out}.card")
    # each feature's geometry is its envelope's box: every candidate is
    # refined, and the refine only drops (a box the f32 envelope test keeps
    # but whose quantized corners miss the rectangle)
    check(not approx["exact"] and exact["count"] <= approx["count"]
          == exact["stats"]["pairs_refined"],
          f"--approx counted {approx['count']}, the exact scan {exact}")
    print(f"[Q1] --approx: {approx['count']} rows, K2 1, K6 0; sha256 {digest} on both; card "
          f"{w_card:.4f} s, cpu {w_cpu:.4f} s host wall on {card}")
    out = os.path.join(tmp, "q1-bbox")
    w_card, w_cpu, digest, *_ = query_card_and_cpu("Q1", [*rect, "-o", "bbox"], out, launches,
                                                  k2=1, k6=SOME)
    union = query_doc(f"{out}.card")["bbox_union"]
    check(-60.01 < union[0] and union[2] < 60.01 and -30.01 < union[1] and union[3] < 30.01,
          f"bbox union {union} outside the query")
    print(f"[Q1] -o bbox: union {union}; sha256 {digest} on both; card {w_card:.4f} s, cpu "
          f"{w_cpu:.4f} s host wall on {card}")
    # at 2M rows the first 50,000 fids lie in the southernmost band, outside
    # the rectangle: an empty page; where some lie inside, the page reads
    # blobs that this layer does not hold and both routes refuse it alike
    out = os.path.join(tmp, "q1-json-first")
    where = f"fid < {SYNTH_PK_BASE + 50000}"
    *_, rc = query_card_and_cpu(
        "Q1", [*rect, "-o", "json", "--where", where, "--page", "1", "--page-size", "1000"], out,
        launches, k2=1, k6=SOME, rc_want=None)
    first = f"exit {rc}"
    if rc == 0:
        doc = query_doc(f"{out}.card")
        first += f", {doc['count']} rows, page 1 holds {len(doc['features'])}"
    # a page of real features: the edited rows (the only ones with blobs) in
    # the rectangle's interior
    keys = np.asarray(new.keys[:n_rows])
    edited = np.flatnonzero((np.asarray(old.oids[: old.count]) != np.asarray(new.oids[:n_rows]))
                            .any(axis=1))
    env = np.asarray(new.envelopes[:n_rows])[edited]
    inside = edited[(env[:, 0] > -59) & (env[:, 2] < 59) & (env[:, 1] > -29) & (env[:, 3] < 29)]
    pks = keys[inside[:2500]]
    where = f"fid >= {SYNTH_PK_BASE} AND fid IN ({','.join(str(int(k)) for k in pks)})"
    out = os.path.join(tmp, "q1-json")
    w_card, w_cpu, digest, *_ = query_card_and_cpu(
        "Q1", [*rect, "-o", "json", "--where", where, "--page", "1", "--page-size", "1000"], out,
        launches, k2=1, k6=SOME)
    doc = query_doc(f"{out}.card")
    got = [f["fid"] for f in doc["features"]]
    check(doc["count"] == len(pks) and got == [int(k) for k in pks[1000:2000]]
          and doc["stats"]["rows_decoded"] == len(got),
          f"the json page holds {len(got)} features of {doc['count']}")
    print(f"[Q1] -o json --where 'fid < base + 50000' --page 1: {first}, the same on both; "
          f"--where 'fid IN ({len(pks)} edited pks)' --page 1: {len(got)} features of "
          f"{doc['count']}; sha256 {digest} on both; card {w_card:.4f} s, cpu {w_cpu:.4f} s host "
          f"wall on {card}")
    out = os.path.join(tmp, "q1-wrap")
    w_card, w_cpu, digest, *_ = query_card_and_cpu(
        "Q1", [*spec, "--bbox", QUERY_WRAP, "-o", "count"], out, launches, k2=1, k6=0)
    doc = query_doc(f"{out}.card")
    check(doc["count"] > 0 and doc["stats"]["pairs_refined"] == 0,
          f"the wrapping --bbox said {doc}")
    print(f"[Q1] wrapping --bbox {QUERY_WRAP}: {doc['count']} rows, K2 1, K6 0; sha256 {digest} "
          f"on both; card {w_card:.4f} s, cpu {w_cpu:.4f} s host wall on {card}")

    # [Q2] the time-travel join
    join = [*spec, "--intersects", "HEAD^:synth"]
    out = os.path.join(tmp, "q2-full")

    def full():
        with open(out, "w") as f, contextlib.redirect_stdout(f):
            return kart_cli(*join, "-o", "count")

    wall, st = counted("Q2", full, launches, want=0, want_k5=SOME, want_k6=SOME)
    doc = query_doc(out)
    stats = doc["stats"]
    check(doc["exact"] and doc["count"] == n_rows and doc["pairs"] >= n_rows
          and stats["batches"] <= st["envelope_join_launches"] <= 2 * stats["batches"]
          and stats["pairs_refined"] >= n_rows,
          f"the full join said {doc}, launches {st}")
    print(f"[Q2] query HEAD synth --intersects HEAD^:synth -o count at {n_rows} x {old.count}: "
          f"pairs {doc['pairs']}, count {doc['count']}, stats {stats}; K5 "
          f"{st['envelope_join_launches']}, K6 {st['geom_refine_launches']}; {wall:.4f} s host "
          f"wall on {card}")
    runtime.reset_stats()
    t = time.perf_counter()
    plain = run_join(repo, "HEAD", "synth", "HEAD^", "synth", output="count",
                     backend=PlainTorchBackend(dev))
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t
    st = runtime.stats_snapshot()
    check(st["envelope_join_launches"] == st["geom_refine_launches"] == 0,
          "the plain join launched a kernel")
    check(plain == doc, f"the plain versions on the card said {plain}, the kernels {doc}")
    print(f"[Q2] the same join through the plain versions on the card: equal document (pairs "
          f"{plain['pairs']}, count {plain['count']}); {plain_wall:.4f} s host wall on {card}")
    strip = [*join, "--bbox", JOIN_STRIP]
    for name, argv, k6 in (("count", ["-o", "count"], SOME),
                           ("json", ["-o", "json", "--page", "0"], SOME),
                           ("approx", ["-o", "count", "--approx"], 0)):
        out = os.path.join(tmp, f"q2-strip-{name}")
        w_card, w_cpu, digest, st, _ = query_card_and_cpu("Q2", [*strip, *argv], out, launches, k2=2,
                                                       k5=SOME, k6=k6)
        doc = query_doc(f"{out}.card")
        check(0 < doc["count"] < n_rows and doc["exact"] == (name != "approx"),
              f"the strip join said {doc['count']}")
        print(f"[Q2] --bbox {JOIN_STRIP} {' '.join(argv)}: {doc['stats']['tiles']} build "
              f"tiles, pairs {doc['pairs']}, count {doc['count']}; K2 2, "
              f"K5 {st['envelope_join_launches']}, K6 {st['geom_refine_launches']}; sha256 "
              f"{digest} on both; card {w_card:.4f} s, cpu {w_cpu:.4f} s host wall on {card}")
    profile, split = counted("Q2", lambda: profile_split(full, JOIN_STEPS), launches, want=0,
                             want_k5=SOME, want_k6=SOME)[0]
    print("[Q2] host profile of the card's full join (cProfile, cumulative s): "
          + "; ".join(f"{k} {v:.4f}" for k, v in split.items()) + f" on {card}")
    print(profile)

    # [Q3] the kernels alone
    return query_kernels_alone(card, dev, old, new)


def main_path_join_batch(build_block, probe_block):
    """What Q2's full join hands K5 for its middle build tile: that tile's
    envelopes and the probe batch holding the tile's middle row (in the
    time-travel join most of the tile's features meet themselves there),
    as host f32 arrays, with the tile's index and the batch's first row."""
    build_env = np.ascontiguousarray(build_block.envelopes, dtype=np.float32)
    probe_env = np.asarray(probe_block.envelopes, dtype=np.float32)
    tile_agg, _ = block_aggregates(build_env, TILE_ROWS)
    probe_agg, probe_flags, block_rows = _probe_aggregates(probe_block)
    t = len(tile_agg) // 2
    cls = bbox_ops.classify_env_blocks_np(probe_agg, probe_flags, tile_agg[t].astype(np.float64))
    mid = t * TILE_ROWS + TILE_ROWS // 2
    for r_lo, r_hi in _alive_ranges(cls, block_rows, 0, probe_block.count):
        for c_lo in range(r_lo, r_hi, batch_rows()):
            c_hi = min(c_lo + batch_rows(), r_hi)
            if c_lo <= mid < c_hi:
                return (build_env[t * TILE_ROWS : (t + 1) * TILE_ROWS].copy(),
                        probe_env[c_lo:c_hi].copy(), t, c_lo)
    raise SystemExit(f"FAIL: [Q3] no probe batch of tile {t} holds row {mid}")


def main_path_refine_batch(build, probe, t, c_lo, build_block, probe_block, dev):
    """What Q2's full join hands K6 for the same tile and batch: K5's pairs
    (from its plain version) whose both sides have usable, non-wrapping
    geometry, as ``_refine_chunk`` passes them on. -> (build column, build
    features, probe column, probe rows), the indices int64 on ``dev``."""
    _, _, (pair_probe, pair_build) = envelope_join_plain(build, probe, pairs=True)
    col_build, col_probe = build_block.vertex_column(), probe_block.vertex_column()
    check(col_build is not None and col_probe is not None, "[Q3] the layer has no vertex column")
    refine = _make_refine_ctx(col_build, np.arange(build_block.count),
                              np.asarray(build_block.envelopes, dtype=np.float32), col_probe,
                              probe_block.envelopes, dev)
    env_row = t * TILE_ROWS + pair_build.to(torch.int64)
    probe_row = c_lo + pair_probe.to(torch.int64)
    u = refine["probe_ok"][probe_row] & refine["build_ok"][env_row]
    return col_build, refine["build_feat"][env_row[u]], col_probe, probe_row[u]


def overlapping_pairs(col_a, col_b, n, rng):
    """``n`` random pairs of ``col_a`` x ``col_b`` features whose integer
    vertex boxes overlap, as the join's candidates' envelopes do."""
    def boxes(col):
        x0, y0, x1, y1, offs = col.segment_table()
        lo = offs[:-1].copy()
        b = [np.minimum.reduceat(np.minimum(x0, x1), lo),
             np.maximum.reduceat(np.maximum(x0, x1), lo),
             np.minimum.reduceat(np.minimum(y0, y1), lo),
             np.maximum.reduceat(np.maximum(y0, y1), lo)]
        check(bool((np.diff(offs) > 0).all()), "[Q3] a shape without segments")
        return b
    (alx, ahx, aly, ahy), (blx, bhx, bly, bhy) = boxes(col_a), boxes(col_b)
    ia_all, ib_all = [], []
    while sum(map(len, ia_all)) < n:
        ia = rng.integers(0, len(col_a), 4 * n)
        ib = rng.integers(0, len(col_b), 4 * n)
        keep = ((alx[ia] <= bhx[ib]) & (blx[ib] <= ahx[ia]) & (aly[ia] <= bhy[ib])
                & (bly[ib] <= ahy[ia]))
        ia_all.append(ia[keep])
        ib_all.append(ib[keep])
    return np.concatenate(ia_all)[:n], np.concatenate(ib_all)[:n]


def k6_work(seg_a, ia, seg_b, ib, verdict):
    """The exact refine's work on these pairs, in integer instructions, two
    ways (computed from the inputs on their device, in the plain version's
    padded slabs, not from K6's counters) -> (reference work, design work).
    Reference: a false verdict's every cell, a segment test and a crossing
    a polygon side; a true verdict one segment test. Design (K6's culls on
    the features' boxes, which the resident table holds): a false verdict
    tests the two feature boxes; where they meet, it computes every
    segment's box and tests it against the other feature's box, tests every
    cell of two surviving segments by their boxes, and runs the segment
    test where those meet; where the other side is a polygon and this
    side's box reaches its start range (three compares), it tests every
    start against the other side's box, and for a surviving start runs the
    half-open y test on every segment of the other side, and the rest of
    the crossing where that holds. A true verdict: one segment test, as the
    reference counts it (the least any order needs)."""
    ref = des = 0.0
    n = len(ia)
    longest = lambda segs, idx: int((segs[4][idx + 1] - segs[4][idx]).max())  # noqa: E731
    rows = max(PLAIN_SLAB_ELEMENTS // (max(longest(seg_a, ia), 1) * max(longest(seg_b, ib), 1)),
               1)
    for lo in range(0, n, rows):
        hi = min(lo + rows, n)
        a, a_n, a_poly = _slabs(seg_a, ia[lo:hi])
        b, b_n, b_poly = _slabs(seg_b, ib[lo:hi])
        am = torch.arange(a[0].shape[1], device=ia.device)[None, :] < a_n[:, None]
        bm = torch.arange(b[0].shape[1], device=ia.device)[None, :] < b_n[:, None]
        big = 1 << 40

        def seg_boxes(v, m):
            return (torch.where(m, torch.minimum(v[0], v[2]), big),
                    torch.where(m, torch.maximum(v[0], v[2]), -big),
                    torch.where(m, torch.minimum(v[1], v[3]), big),
                    torch.where(m, torch.maximum(v[1], v[3]), -big))

        def meets(p, q):
            return (p[0] <= q[1]) & (q[0] <= p[1]) & (p[2] <= q[3]) & (q[2] <= p[3])

        sa, sb = seg_boxes(a, am), seg_boxes(b, bm)
        fa = (sa[0].min(1).values, sa[1].max(1).values, sa[2].min(1).values, sa[3].max(1).values)
        fb = (sb[0].min(1).values, sb[1].max(1).values, sb[2].min(1).values, sb[3].max(1).values)
        fmeet = meets(fa, fb)
        live_a = am & meets(sa, [v[:, None] for v in fb]) & fmeet[:, None]
        live_b = bm & meets(sb, [v[:, None] for v in fa]) & fmeet[:, None]
        box_hits = (meets([v[:, :, None] for v in sa], [v[:, None, :] for v in sb])
                    & live_a[:, :, None] & live_b[:, None, :]).sum(dim=(1, 2))

        def starts(x, y, n_x, poly_other, fx, f, ring, ring_m):
            reach = poly_other & (fx[3] >= f[2]) & (fx[2] < f[3]) & (fx[0] < f[1])
            live = ((torch.arange(x.shape[1], device=x.device)[None, :] < n_x[:, None])
                    & reach[:, None] & (y >= f[2][:, None]) & (y < f[3][:, None])
                    & (x < f[1][:, None]))
            py = y[:, :, None]
            upward = ((ring[1][:, None, :] <= py) != (ring[3][:, None, :] <= py))
            ups = (upward & live[:, :, None] & ring_m[:, None, :]).sum(dim=(1, 2))
            return (K6_OPS_START * (poly_other.long() + reach * n_x)
                    + K6_OPS_UPWARD * live.sum(1) * ring_m.sum(1)
                    + (K6_OPS_PER_CROSSING - K6_OPS_UPWARD) * ups)

        work = (K6_OPS_BOX_TEST
                + fmeet * ((K6_OPS_SEGMENT_BOX + K6_OPS_BOX_TEST) * (a_n + b_n)
                           + K6_OPS_BOX_TEST * live_a.sum(1) * live_b.sum(1)
                           + K6_OPS_PER_SEGMENT_TEST * box_hits)
                + starts(a[0], a[1], a_n, b_poly, fa, fb, b, bm)
                + starts(b[0], b[1], b_n, a_poly, fb, fa, a, am))
        cells = a_n * b_n * (K6_OPS_PER_SEGMENT_TEST
                             + K6_OPS_PER_CROSSING * (a_poly.long() + b_poly.long()))
        false = ~verdict[lo:hi]
        n_true = int((~false).sum())
        ref += float(cells[false].sum()) + n_true * K6_OPS_PER_SEGMENT_TEST
        des += float(work[false].sum()) + n_true * K6_OPS_PER_SEGMENT_TEST
    return ref, des


def k6_bytes(seg_a, ia, seg_b, ib):
    """What a refine call must move: the pair indices and verdicts, and each
    distinct feature's segments, offsets, kind and box once."""
    out = len(ia) * 17
    for segs, idx in ((seg_a, ia), (seg_b, ib)):
        u = torch.unique(idx)
        out += int((segs[4][u + 1] - segs[4][u]).sum()) * 16 + len(u) * 25
    return out


def k6_entry(label, seg_a, ia, seg_b, ib, card):
    """K6 on one draw of pairs: bit for bit against its plain version,
    timed beside its two bounds. -> the entry, its largest difference."""
    want = geom_refine_plain(seg_a, ia, seg_b, ib)
    err = mismatches(geom_refine(seg_a, ia, seg_b, ib), want)
    n_true = int(want.sum())
    ref_ops, des_ops = k6_work(seg_a, ia, seg_b, ib, want)
    moved = k6_bytes(seg_a, ia, seg_b, ib)
    b_ref = max(bound(moved, 0), (ref_ops / INT_OPS_PER_S * 1e3, "operations"))
    b_des = max(bound(moved, 0), (des_ops / INT_OPS_PER_S * 1e3, "operations"))
    sa = (seg_a[4][ia + 1] - seg_a[4][ia]).cpu().numpy()
    sb = (seg_b[4][ib + 1] - seg_b[4][ib]).cpu().numpy()
    call = lambda: geom_refine(seg_a, ia, seg_b, ib)  # noqa: E731
    per, fenced = device_times(call, K6_KERNELS)
    plain = time_ms(lambda: geom_refine_plain(seg_a, ia, seg_b, ib), batches=2, per_batch=1,
                    warmup=0) if len(ia) > 10_000 else time_ms(
        lambda: geom_refine_plain(seg_a, ia, seg_b, ib), batches=3, per_batch=3)
    entry = {
        "pairs": len(ia), "true": n_true, "segment_cells": int((sa * sb).sum()),
        "short_pairs": int(((sa <= K6_SHORT_SIDE) & (sb <= K6_SHORT_SIDE)).sum()),
        "max_abs_err": err,
        "ms": time_ms(call), "device_ms": total_ms(per), "device_split": per,
        "fenced_ms": fenced, "plain_ms": plain,
        "bound_ms": b_des[0], "bound_by": b_des[1],
        "bound_count": f"{des_ops:.6g} integer instructions (K6's culls, then the terms on what "
                       f"survives; true verdicts one segment test) at {INT_OPS_PER_S:.4g} a "
                       f"second; {moved} bytes",
        "reference_bound_ms": b_ref[0], "reference_bound_by": b_ref[1],
        "reference_bound_count": f"{ref_ops:.6g} integer instructions (the reference's work: "
                                 f"false verdicts every cell's terms, true one segment test)",
    }
    print(f"[Q3] K6 on {label}: {len(ia)} pairs ({entry['short_pairs']} short, "
          f"{entry['segment_cells']} segment cells, {n_true} true), bit-identical to the plain "
          f"version; {entry['ms']:.4f} ms, device {fmt_ms(entry['device_ms'])} "
          f"(fenced {fenced:.4f}), plain {plain:.4f} ms; bound (the design's work) "
          f"{b_des[0]:.4f} ms by {b_des[1]}, reference-work bound {b_ref[0]:.4f} ms by "
          f"{b_ref[1]} on {card}")
    return entry, err


def check_k5(build, probe):
    """K5 with its pairs against the plain version on the same card tensors.
    -> (largest difference, pair total, probe rows with a match, pairs whose
    both sides wrap, pairs where one side wraps)."""
    counts, total, pairs = envelope_join(build, probe, pairs=True)
    p_counts, p_total, p_pairs = envelope_join_plain(build, probe, pairs=True)
    err = max(mismatches(counts, p_counts), abs(total - p_total),
              mismatches(pairs[0], p_pairs[0]), mismatches(pairs[1], p_pairs[1]))
    check(len(pairs[0]) == total, f"K5 wrote {len(pairs[0])} pairs of {total}")
    wraps = lambda env, rows: (env[:, 2] < env[:, 0])[rows.to(torch.int64)]  # noqa: E731
    pw, bw = wraps(probe, p_pairs[0]), wraps(build, p_pairs[1])
    return (err, total, int((p_counts > 0).sum()), int((pw & bw).sum()), int((pw ^ bw).sum()))


def k5_bound(build, probe):
    """K5's bound on one tile x batch, from its inputs: the larger of its
    bytes (each envelope read once, the counts and the total written once:
    the counts pass, which is what is timed) and its least instructions
    (:data:`K5_OPS_PER_TEST` a test, :data:`K5_OPS_BOTH_WRAP` where both
    rows wrap, one compare a row for its wrap bit).
    -> {bound_ms, bound_by, bound_count}."""
    t, b = len(build), len(probe)
    wraps = lambda env: int((env[:, 2] < env[:, 0]).sum())  # noqa: E731
    both = wraps(build) * wraps(probe)
    ops = t * b * K5_OPS_PER_TEST - both * (K5_OPS_PER_TEST - K5_OPS_BOTH_WRAP) + t + b
    ms, by = max(bound((t + b) * 16 + b * 4 + 8, 0),
                 (ops / PRED_OPS_PER_S * 1e3, "operations"))
    return {"bound_ms": ms, "bound_by": by,
            "bound_count": f"{t * b} pair tests ({both} with both rows wrapping) x "
                           f"{K5_OPS_PER_TEST} instructions ({K5_OPS_BOTH_WRAP} both wrapping) "
                           f"and {t + b} wrap compares, {ops} in all, at {PRED_OPS_PER_S:.4g} a "
                           f"second"}


def k5_times(build, probe):
    """K5's wrapper time (alone and with its pairs), device time beside
    ``fenced_ms``, the plain version's time and the bound on one tile x
    batch."""
    per, fenced = device_times(lambda: envelope_join(build, probe), K5_KERNELS)
    return {
        "ms": time_ms(lambda: envelope_join(build, probe)),
        "ms_pairs": time_ms(lambda: envelope_join(build, probe, pairs=True)),
        "device_ms": total_ms(per), "fenced_ms": fenced,
        "plain_ms": time_ms(lambda: envelope_join_plain(build, probe), batches=3, per_batch=3),
        **k5_bound(build, probe),
    }


def query_kernels_alone(card, dev, build_block, probe_block):
    """Phase Q3: K5 on the (build tile, probe batch) that Q2's full join
    gives it, on 12,288 rows of that batch around the tile's middle row and
    on a 4096-row tile x a 65,536-row batch of dense envelopes that reach
    every branch of the overlap test; K6 on 100,000 pairs of seeded shapes
    drawn at random, on 100,000 drawn so that their boxes overlap, and on
    the refine batch Q2's join hands it for the same tile and batch (box x
    box); each bit for bit against its plain version on the card, timed
    beside its bound (K6 beside two: the reference's work and its own
    design's). -> their entries of the kernels line (without launches)."""
    rng = np.random.default_rng(9)
    build_np, probe_np, tile, c_lo = main_path_join_batch(build_block, probe_block)
    build, probe = torch.from_numpy(build_np).to(dev), torch.from_numpy(probe_np).to(dev)
    t, b = len(build), len(probe)
    err_k5, total, matched, _, _ = check_k5(build, probe)
    check(err_k5 == 0 and total >= t // 2,
          f"K5 differs from its plain version ({err_k5}) or found {total} pairs for a {t}-row "
          f"tile of the time-travel join")
    mid = tile * TILE_ROWS + TILE_ROWS // 2 - c_lo
    s_lo = min(max(mid - SMALL_BATCH_ROWS // 2, 0), max(b - SMALL_BATCH_ROWS, 0))
    s_probe = probe[s_lo : s_lo + SMALL_BATCH_ROWS].contiguous()
    s_err, s_total, s_matched, _, _ = check_k5(build, s_probe)
    check(s_err == 0 and s_total > 0, f"K5 differs from its plain version on {len(s_probe)} "
                                      f"rows ({s_err}) or found no pair")
    d_build = torch.from_numpy(make_dense_envelopes(rng, 4096)).to(dev)
    d_probe = torch.from_numpy(make_dense_envelopes(rng, 65536)).to(dev)
    d_err, d_total, d_matched, both_wrap, one_wrap = check_k5(d_build, d_probe)
    check(d_err == 0 and d_matched >= len(d_probe) // 2 and both_wrap > 0 and one_wrap > 0,
          f"K5 differs from its plain version on dense envelopes ({d_err}), or they reach too "
          f"few branches: {d_total} pairs, {d_matched} of {len(d_probe)} probe rows matched, "
          f"{both_wrap} both wrapping, {one_wrap} one wrapping")
    dense = {"shape": [4096, 65536], "pairs": d_total, "probe_rows_matched": d_matched,
             "both_wrap_pairs": both_wrap, "one_wrap_pairs": one_wrap, "max_abs_err": d_err,
             **k5_times(d_build, d_probe)}
    small = {"shape": [t, len(s_probe)], "pairs": s_total, "probe_rows_matched": s_matched,
             "max_abs_err": s_err, **k5_times(build, s_probe)}
    k5 = {
        "name": "envelope_join", "route": "cuda",
        "source": "kart_tpu_torch/csrc/envelope_join.cu",
        "replaces": "kart_tpu/diff/backend.py:514",
        "max_abs_err": max(err_k5, s_err, d_err), "shape": [t, b], "pairs": total,
        "probe_rows_matched": matched, **k5_times(build, probe),
        "library_ms": None, "checked": True, "dense": dense, "batch_12288": small,
    }
    for label, e in (("Q2's middle build tile x its probe batch", k5),
                     (f"the same tile x {len(s_probe)} rows of that batch", small),
                     ("dense envelopes", dense)):
        shape = e["shape"]
        print(f"[Q3] K5 on {label} ({shape[0]} x {shape[1]} rows): bit-identical counts, "
              f"total {e['pairs']} ({e['probe_rows_matched']} probe rows matched) and pairs to "
              f"the plain version; {e['ms']:.4f} ms ({e['ms_pairs']:.4f} with the pairs), "
              f"device {fmt_ms(e['device_ms'])} (fenced {e['fenced_ms']:.4f}; "
              f"{_per_test_ns(e, shape)} ns a test), plain {e['plain_ms']:.4f} ms, bound "
              f"{e['bound_ms']:.4f} ms by {e['bound_by']} ({e['bound_count']}) on {card}")
    print(f"[Q3] dense envelopes: {both_wrap} pairs both wrapping, {one_wrap} one wrapping")

    col_a, col_b = synth_shapes(20_000, seed=11), synth_shapes(20_000, seed=12)
    ia = rng.integers(0, len(col_a), 100_000)
    ib = rng.integers(0, len(col_b), 100_000)
    seg_a, seg_b = resident_segments(col_a, dev), resident_segments(col_b, dev)
    ia_t, ib_t = torch.from_numpy(ia).to(dev), torch.from_numpy(ib).to(dev)
    k6_rand, err_rand = k6_entry("100,000 random pairs of seeded shapes", seg_a, ia_t, seg_b,
                                 ib_t, card)
    check(err_rand == 0 and 0 < k6_rand["true"] < len(ia),
          f"K6 differs from its plain version ({err_rand}) or its verdicts are all alike "
          f"({k6_rand['true']})")
    oa, ob = overlapping_pairs(col_a, col_b, 100_000, rng)
    k6_over, err_over = k6_entry("100,000 pairs of seeded shapes whose boxes overlap", seg_a,
                                 torch.from_numpy(oa).to(dev), seg_b,
                                 torch.from_numpy(ob).to(dev), card)
    check(err_over == 0 and 0 < k6_over["true"] < len(oa),
          f"K6 differs from its plain version on overlapping pairs ({err_over}) or its verdicts "
          f"are all alike ({k6_over['true']})")
    col_build, bi, col_probe, pj = main_path_refine_batch(build, probe, tile, c_lo, build_block,
                                                          probe_block, dev)
    check(len(bi) >= t // 2, f"[Q3] the refine batch holds {len(bi)} pairs for a {t}-row tile")
    k6_box, err_box = k6_entry("Q2's refine batch of the same tile and batch (box x box)",
                               resident_segments(col_build, dev), bi,
                               resident_segments(col_probe, dev), pj, card)
    check(err_box == 0 and k6_box["short_pairs"] == len(bi),
          f"K6 differs from its plain version on the box batch ({err_box}) or a box pair was "
          f"not short ({k6_box['short_pairs']} of {len(bi)})")
    k6 = {
        "name": "geom_refine", "route": "cuda", "source": "kart_tpu_torch/csrc/geom_refine.cu",
        "replaces": "kart_tpu/diff/backend.py:609",
        **k6_rand, "max_abs_err": max(err_rand, err_over, err_box),
        "library_ms": None, "checked": True, "overlapping": k6_over, "box_batch": k6_box,
    }
    return k5, k6


def _per_test_ns(entry, shape):
    t = entry["device_ms"]
    return "n/a" if t is None else f"{t * 1e6 / (shape[0] * shape[1]):.6f}"


# --- kart export tiles on the point layer: the pyramid, the default layers, K7 --

#: T1's pyramid: zooms and layers of every route (z0-z5 took the tile
#: phases past their 150 s; z0-z4 still encodes every row twice)
TILE_ZOOMS = "0-4"
TILE_LAYERS = "bin,ktb2,mvt,geom"
#: T1's --strict runs: the zooms whose tiles exceed the 65,536-feature
#: ceiling at 2M features (z0-z1 all, z2 half), so that the runs that must
#: fail do not encode the whole pyramid twice more
TILE_STRICT_ZOOMS = "0-2"
#: (route, global options, export options) of the card's default and of
#: --device cpu in this process
ROUTES_IN_PROCESS = (("card", [], []), ("cpu", ["--device", "cpu"], ["--workers", "1"]))
#: the zooms T3 quantizes K7's columns at, each row in its own tile
QUANT_ZOOMS = (0, 4, 11, 18, 24, 30)
#: H100 SXM f64 instruction rate at the 1,980 MHz boost clock: 64 FP64 lanes an
#: SM over 132 SMs
F64_OPS_PER_S = 132 * 64 * 1.98e9
#: the SASS opcodes counted as K7's f64 work
F64_OPCODES = re.compile(r"^(DADD|DMUL|DFMA|DSETP|DSET|DMNMX|MUFU\.RCP64H|MUFU\.RSQ64H)\b")

#: the host steps of the card's export (cProfile function names)
TILE_STEPS = {
    "prune (block classes, envelope scan)": "rows_for_bbox",
    "refine": "refine_rows",
    "projection wrapper (upload, K7, download)": "merc_envelopes",
    "quantize": "quantize_from_merc",
    "layer encoders": "build_layers",
    "writes (the ordered writer)": "consume",
}


def export_cli(argv, out_dir):
    """One in-process ``kart export tiles`` into ``out_dir``; -> (host wall
    s, exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = kart_main([*argv, "-o", out_dir])
    torch.cuda.synchronize()
    return time.perf_counter() - t, rc, out.getvalue(), err.getvalue()


def written_tiles(out_dir):
    """The (z, x, y) addresses of an exported pyramid's files."""
    found = set()
    for dirpath, _, names in os.walk(out_dir):
        rel = os.path.relpath(dirpath, out_dir).split(os.sep)
        if len(rel) == 2:
            found |= {(int(rel[0]), int(rel[1]), int(n[: -len(".ktile")])) for n in names}
    return found


def batches_with_tiles(source, zooms, out_dir):
    """The encode batches of an export that hold a written tile: on the
    card route, one K7 launch each."""
    written = written_tiles(out_dir)
    return sum(any(a in written for a in b)
               for b in batched(tile_cover(source, zooms), export_batch_tiles()))


def stats_line(stdout, out_dir):
    """An export's stdout line with its output directory and worker count
    taken out, so that routes compare."""
    return re.sub(r"; \d+ workers\]", "; N workers]", stdout.replace(out_dir, "<out>"))


def largest_batch(source, zooms, zoom):
    """The (M, 4) f64 envelopes that the card route's batch encoder projects
    for its batch with the most rows among those holding tiles of ``zoom``:
    each tile's pruned and refined rows, tiles over the feature ceiling left
    out, in address order."""
    env_all = source.envelopes()
    limit = max_features_limit()
    best = np.zeros((0, 4))
    for b in batched(tile_cover(source, zooms), export_batch_tiles()):
        if not any(z == zoom for z, _, _ in b):
            continue
        parts = []
        for z, x, y in b:
            rows, env = refine_rows(env_all, source.rows_for_bbox(tile_query_wsen(z, x, y))[0],
                                    z, x, y)
            if len(rows) and not (limit and len(rows) > limit):
                parts.append(env)
        cat = np.concatenate(parts) if parts else best
        if len(cat) > len(best):
            best = cat
    return best


def edge_envelopes():
    """(w, s, e, n) rows at the projection's edges: the poles, the mercator
    clamp exactly, the anti-meridian, -0.0, subnormals, NaN, infinities."""
    m = MERC_MAX_LAT
    return np.array([
        (-180.0, -90.0, 180.0, 90.0), (180.0, 90.0, -180.0, -90.0),
        (-180.0, -m, 180.0, m), (0.0, m, 0.0, -m),
        (-0.0, -0.0, 0.0, 0.0), (0.0, -0.0, -0.0, 0.0),
        (5e-324, -5e-324, 1e-310, -1e-310), (-2.2e-308, 2.2e-308, 1e-320, -1e-320),
        (np.nan, 1.0, 2.0, np.nan), (np.nan, np.nan, np.nan, np.nan),
        (np.inf, np.inf, -np.inf, -np.inf), (-np.inf, -m, np.inf, m),
        (179.99999, m - 1e-12, -179.99999, -m + 1e-12), (-179.99999, 89.9, 179.99999, -89.9),
    ], dtype=np.float64)


def ulp_gap(a, b):
    """The largest distance in units of the last place between finite f64
    values of ``a`` and ``b`` (the same shape)."""
    def ordered(x):
        i = x.view(np.int64)
        return np.where(i < 0, np.int64(-(2 ** 63)) - i, i)

    fin = np.isfinite(a) & np.isfinite(b)
    if not fin.any():
        return 0
    return int(np.abs(ordered(a[fin]) - ordered(b[fin])).max())


def merc_f64_per_row():
    """K7's f64 instructions a row, counted in its SASS: the f64 opcodes
    (:data:`F64_OPCODES`) of the grid-stride loop's body, from the target of
    its backward branch (the widest one) to the branch. Each row runs the body once; the
    slow-path subroutines after the loop (huge-argument trig reduction, the
    division's special cases) are left out, and every branch inside the body
    is counted as taken, so the count is an upper bound of what a row of
    finite degrees runs."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", os.path.join(_build.build_dir(), "libmerc.so")],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "merc_kernel" in line
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if inside and m:
            body.append((int(m.group(1), 16), re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(2))))
    loop = [(a, int(ins.split()[-1], 16)) for a, ins in body
            if ins.startswith("BRA") and int(ins.split()[-1], 16) < a]
    check(loop, "no backward branch (the grid-stride loop) in K7's SASS")
    # the grid-stride loop is the widest backward branch (the slow paths'
    # own loops are short)
    end, start = max(loop, key=lambda b: b[0] - b[1])
    n = sum(1 for a, ins in body if start <= a <= end and F64_OPCODES.match(ins))
    check(n > 0, "no f64 instruction in K7's loop body")
    return n


def k7_alone(label, env, dev, card):
    """K7 on ``env`` (M, 4) f64 with the edge rows added: bit for bit against
    its plain version on the card; the ulp gap and largest difference
    against numpy's host projection, inside the quantizer's margin at each
    of :data:`QUANT_ZOOMS`; the quantized boxes equal to the host's there,
    each row in its own tile; then timed. -> its entry (without the bound:
    :func:`k7_bound`)."""
    env = np.ascontiguousarray(np.concatenate([env, edge_envelopes()]), dtype=np.float64)
    e = torch.from_numpy(env).to(dev)
    k, p = merc(e).cpu().numpy(), merc_plain(e).cpu().numpy()
    mism = int((k.view(np.int64) != p.view(np.int64)).sum())
    check(mism == 0, f"[T3] K7 differs from its plain version in {mism} values on {label}")
    host = np.stack(_host_merc(env))
    fin = np.isfinite(k)
    check(np.array_equal(fin, np.isfinite(host))
          and np.array_equal(k[~fin], host[~fin], equal_nan=True),
          f"[T3] K7's non-finite values differ from numpy's on {label}")
    gap = ulp_gap(k, host)
    diff = float(np.abs(k[fin] - host[fin]).max())
    patched = {}
    with np.errstate(invalid="ignore"):
        for z in QUANT_ZOOMS:
            scale = float(1 << z) * 4096
            check(diff * scale < quantize_margin(z),
                  f"[T3] K7 is {diff} from numpy: outside the quantizer's margin at zoom {z}")
            n_t = 1 << z
            xt = np.clip(np.floor(np.nan_to_num(host[0]) * n_t), 0, n_t - 1).astype(np.int64)
            yt = np.clip(np.floor(np.nan_to_num(host[1]) * n_t), 0, n_t - 1).astype(np.int64)
            got, patched[z] = quantize_boxes(env, tuple(k), z, xt, yt)
            want, _ = quantize_boxes(env, tuple(host), z, xt, yt)
            check(np.array_equal(got, want), f"[T3] K7's boxes differ from the host's at zoom {z} "
                                             f"on {label}")
    rows = len(env)
    entry = {"rows": rows, "max_abs_err": mism, "ulp_gap_numpy": gap, "max_diff_numpy": diff,
             "rows_patched": patched}
    print(f"[T3] K7 on {label} ({rows} rows with {len(edge_envelopes())} edge rows): "
          f"bit-identical to its plain version; against numpy's host projection {gap} ulps at "
          f"most, largest difference {diff:.3e}, inside the quantizer's margin at zooms "
          f"{list(QUANT_ZOOMS)}; boxes equal to the host's there, rows patched "
          f"{patched} on {card}")
    entry.update({
        "ms": time_ms(lambda: merc(e)),
        "device_ms": total_ms(device_ms(lambda: merc(e), ("merc_kernel",))),
        "fenced_ms": fenced_ms(lambda: merc(e)),
        "plain_ms": time_ms(lambda: merc_plain(e), batches=3, per_batch=3),
    })
    t = time.perf_counter()
    select_backend(dev).merc_envelopes(env)
    entry["seam_ms"] = (time.perf_counter() - t) * 1e3
    entry["label"] = label
    return entry


def k7_bound(entry, f64_per_row, card):
    """Add K7's bound to its entry: its bytes (64 a row) or its SASS's f64
    instructions, whichever takes longer; print its timings beside it."""
    rows = entry["rows"]
    b = bound(rows * 64, 0)
    b = max(b, (rows * f64_per_row / F64_OPS_PER_S * 1e3, "operations"))
    entry.update({
        "bound_ms": b[0], "bound_by": b[1],
        "bound_count": f"{rows} rows x 64 bytes at {HBM_BYTES_PER_S:.4g} B/s; {f64_per_row} f64 "
                       f"instructions a row (SASS) at {F64_OPS_PER_S:.4g} a second",
    })
    print(f"[T3] K7 on {entry['label']}: {entry['ms']:.4f} ms, device "
          f"{fmt_ms(entry['device_ms'])}, fenced {entry['fenced_ms']:.4f} ms, plain "
          f"{entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms by {entry['bound_by']} "
          f"({entry['bound_count']}); the backend seam (upload, K7, download) "
          f"{entry['seam_ms']:.4f} ms host wall on {card}")


def tile_phases(repo, tmp, card, launches, dev):
    """Phases T1-T3 on [11]'s point layer. -> K7's entry of the kernels line
    (without launches)."""
    path = repo.workdir
    head = repo.resolve_refish("HEAD")[0]
    zooms = parse_zoom_spec(TILE_ZOOMS)
    spec = ["-C", path, "export", "tiles", "HEAD", "--dataset", "synth"]
    pyramid = [*spec, "--zoom", TILE_ZOOMS, "--layers", TILE_LAYERS]
    t = time.perf_counter()
    source = source_for(repo, head, "synth")
    source.envelopes()
    source.vertices()
    print(f"[T1] source set-up (sidecar mmap, vertex column; shared by the in-process routes "
          f"below) {time.perf_counter() - t:.4f} s host wall on {card}")

    # [T3] K7 alone, run first: the whole layer, and the largest z4 batch of
    # T1's card route (in whole-script runs the profiler timed no kernel in
    # T3's windows when T3 came after T1's pool and T2)
    n = source.block.count
    k7 = {"name": "merc", "route": "cuda", "source": "kart_tpu_torch/csrc/merc.cu",
          "replaces": "kart_tpu/diff/backend.py:415", "library_ms": None,
          "library_call": "none: no single PyTorch call computes B11", "checked": True}
    k7.update(k7_alone("the whole layer's envelopes",
                       np.asarray(source.envelopes()[:n], dtype=np.float64), dev, card))
    batch = largest_batch(source, zooms, zooms[-1])
    k7["main_path_batch"] = k7_alone(f"T1's largest z{zooms[-1]} batch", batch, dev, card)
    k7["max_abs_err"] = max(k7["max_abs_err"], k7["main_path_batch"]["max_abs_err"])
    k7["f64_per_row"] = f64_per_row = merc_f64_per_row()
    for entry in (k7, k7["main_path_batch"]):
        k7_bound(entry, f64_per_row, card)

    # [T1] the pyramid, three ways: the card's default (in this process),
    # --device cpu in this process, and --device cpu's default (the pool)
    runs = {}
    for (route, pre, extra), k7_want in zip((*ROUTES_IN_PROCESS, ("pool", ["--device", "cpu"], [])),
                                            (SOME, 0, 0)):
        out_dir = os.path.join(tmp, f"tiles-{route}")
        runs[route], st = counted("T1", lambda: export_cli([*pre, *pyramid, *extra], out_dir),
                                  launches, want=0, want_k7=k7_want)
        wall, rc, stdout, stderr = runs[route]
        check(rc == 0, f"[T1] export on the {route} route exited {rc}: {stderr}")
        runs[route] += (tree_digest(out_dir), out_dir, st["merc_launches"])
        print(f"[T1] {route}: {stdout.strip()}; K7 {st['merc_launches']}; {wall:.4f} s host wall "
              f"on {card}")
    want_k7 = batches_with_tiles(source, zooms, runs["card"][5])
    check(runs["card"][6] == want_k7, f"[T1] K7 launched {runs['card'][6]} times, the export "
                                      f"has {want_k7} batches with a tile")
    workers = {r: int(re.search(r"; (\d+) workers\]", v[2]).group(1)) for r, v in runs.items()}
    check(workers["card"] == workers["cpu"] == 1 and workers["pool"] > 1,
          f"[T1] the routes ran {workers} workers: the card's default is this process, "
          f"--device cpu's the pool")
    digests = {r: v[4] for r, v in runs.items()}
    check(len(set(digests.values())) == 1, f"[T1] the routes' pyramids differ: {digests}")
    lines = {r: stats_line(v[2], v[5]) for r, v in runs.items()}
    check(len(set(lines.values())) == 1 and len({v[3] for v in runs.values()}) == 1,
          f"[T1] the routes' stats lines or warnings differ: {lines}")
    skipped = int(re.search(r"(\d+) over the feature ceiling", lines["card"]).group(1))
    check(skipped > 0 and runs["card"][3].startswith(f"warning: {skipped} tiles skipped"),
          f"[T1] {skipped} tiles over the ceiling, stderr {runs['card'][3]!r}")
    print(f"[T1] tree digest {digests['card']} on all three routes, equal stats lines; K7 once a "
          f"batch with a tile ({want_k7}) on {card}")
    strict = []
    for route, pre, extra in ROUTES_IN_PROCESS:
        argv = [*pre, *spec, "--zoom", TILE_STRICT_ZOOMS, "--layers", TILE_LAYERS, *extra,
                "--strict"]
        out_dir = os.path.join(tmp, f"tiles-strict-{route}")
        res, st = counted("T1", lambda: export_cli(argv, out_dir), launches, want=0,
                          want_k7=SOME if route == "card" else 0)
        strict.append(res + (tree_digest(out_dir),))
        if route == "card":
            want = batches_with_tiles(source, parse_zoom_spec(TILE_STRICT_ZOOMS), out_dir)
            check(st["merc_launches"] == want, f"[T1] --strict: K7 launched "
                                               f"{st['merc_launches']} times, {want} batches")
    (w_card, rc, out, err, dig), (w_cpu, rc2, out2, err2, dig2) = strict
    check(rc == rc2 == 2 and out == out2 == "" and err == err2 and dig == dig2
          and err.startswith("Error: --strict: ") and "tiles exceeded the feature ceiling" in err,
          f"[T1] --strict exited {rc} / {rc2}: {err!r} / {err2!r}")
    print(f"[T1] --strict --zoom {TILE_STRICT_ZOOMS}: exit 2 on both, the same message "
          f"({err.strip()[:90]}...); card {w_card:.4f} s, cpu {w_cpu:.4f} s host wall on {card}")
    prof_dir = os.path.join(tmp, "tiles-profile")
    profile, split = counted("T1", lambda: profile_split(
        lambda: export_cli(pyramid, prof_dir), TILE_STEPS), launches,
        want=0, want_k7=want_k7)[0]
    check(tree_digest(prof_dir) == digests["card"], "[T1] the profiled export differs")
    print("[T1] host profile of the card's export (cProfile, cumulative s): "
          + "; ".join(f"{k} {v:.4f}" for k, v in split.items()) + f" on {card}")
    print(profile)

    # [T2] the default layers, then bin at zoom 5
    default = []
    for route, pre, extra in ROUTES_IN_PROCESS:
        out_dir = os.path.join(tmp, f"tiles-default-{route}")
        res, st = counted("T2", lambda: export_cli([*pre, *spec, "--zoom", TILE_ZOOMS, *extra],
                                                   out_dir),
                          launches, want=0, want_k7=1 if route == "card" else 0)
        default.append(res + (written_tiles(out_dir),))
    (w_card, rc, out, err, files), (w_cpu, rc2, out2, err2, files2) = default
    check(rc == rc2 == 2 and out == out2 == "" and err == err2 and not files and not files2
          and err.startswith("Error: Feature blob ") and "is not present locally" in err,
          f"[T2] the default layers exited {rc} / {rc2}: {err!r} / {err2!r}")
    print(f"[T2] default layers (bin,geojson): exit 2 on both, the same message "
          f"({err.strip()[:100]}...), nothing written; card {w_card:.4f} s (K7 1), cpu "
          f"{w_cpu:.4f} s host wall on {card}")
    bins = {}
    for route, pre, extra in ROUTES_IN_PROCESS:
        out_dir = os.path.join(tmp, f"tiles-bin-{route}")
        (wall, rc, out, err), st = counted(
            "T2", lambda: export_cli([*pre, *spec, "--zoom", "5", "--layers", "bin", *extra],
                                     out_dir),
            launches, want=0, want_k7=SOME if route == "card" else 0)
        check(rc == 0, f"[T2] --layers bin --zoom 5 exited {rc} on the {route} route: {err}")
        bins[route] = (tree_digest(out_dir), stats_line(out, out_dir), wall, st["merc_launches"])
        if route == "card":
            want = batches_with_tiles(source, [5], out_dir)
            check(st["merc_launches"] == want, f"[T2] K7 launched {st['merc_launches']} times, "
                                               f"{want} batches")
    check(bins["card"][:2] == bins["cpu"][:2], f"[T2] --layers bin differs: {bins}")
    print(f"[T2] --layers bin --zoom 5: {bins['card'][1].strip()}; tree digest {bins['card'][0]} "
          f"on both; K7 {bins['card'][3]}; card {bins['card'][2]:.4f} s, cpu {bins['cpu'][2]:.4f} "
          f"s host wall on {card}")

    return k7


# --- the merge CLI on a repository with 1M conflicts -------------------------

#: the host steps of ``kart merge`` (cProfile function names)
MERGE_STEPS = {
    "tree walks (feature_index)": "feature_index",
    "classify (upload, K4 with the union, download)": "merge_classify",
    "of it K4's wrapper (launch, union size read back)": "merge_classify_sides",
    "of it K4's launch": "launch_merge_classify",
    "tree inserts and removals": "_node_for_dir",
    "tree build (flush)": "flush",
    "materialise_conflicts": "materialise_conflicts",
    "index write (KMIX2)": "write_to_repo",
}

MERGE_DATE = "1700000000 +0000"


def commit_version(repo, parent, ref, pks, oids, message):
    """Commit ``parent``'s tree with its feature tree replaced by the (pk,
    oid) columns ``pks`` (sorted int64) and ``oids`` ((n, 5) uint32), as
    ``synth_repo`` builds its edit commit; -> the commit oid."""
    odb = repo.odb
    with odb.bulk_pack(level=0):
        ftree, _ = emit_feature_tree(odb, plan_int_feature_tree(pks),
                                     np.ascontiguousarray(oids).view(np.uint8).reshape(-1, 20))
        tb = TreeBuilder(odb, odb.read_commit(parent).tree)
        tb.insert("synth/.table-dataset/feature", ftree, mode=MODE_TREE)
        root = tb.flush()
    return repo.create_commit(ref, root, message, [parent])


def merge_truth(n_rows, versions):
    """The 3-way decisions by row (rows 0..n_rows-1: the ancestor's rows,
    then the inserts), from each version's (present rows, oids by row):
    an implementation of the rule independent of the merge code.
    -> (decision int8 (n_rows,), present rows of the union)."""
    cols = []
    for rows, oids in versions:
        p = np.zeros(n_rows, bool)
        w = np.zeros((n_rows, 5), np.uint32)
        p[rows] = True
        w[rows] = oids
        cols.append((p, w))
    (pa, wa), (po, wo), (pt, wt) = cols

    def same(p1, w1, p2, w2):
        return (~p1 & ~p2) | (p1 & p2 & (w1 == w2).all(axis=1))

    d = np.where(same(po, wo, pt, wt), 0,
                 np.where(same(po, wo, pa, wa), 1, np.where(same(pt, wt, pa, wa), 0, 2)))
    return d.astype(np.int8), pa | po | pt


def build_merge_repo(path, n, seed):
    """Phase [14]: the merge repository (module docstring). -> (repo,
    {name: FeatureBlock} of ancestor, ours, theirs and theirs-clean,
    {name: decision by union row} of theirs and theirs-clean)."""
    repo, info = synth_repo(path, n, edit_frac=0.5, seed=seed, blobs="promised")
    ancestor = repo.odb.read_commit(info["edit_commit"]).parents[0]
    a = load_block(repo, repo.structure(ancestor).datasets["synth"])
    o = load_block(repo, repo.structure("HEAD").datasets["synth"])
    pks = np.array(a.keys[: a.count])
    a_oids, o_oids = np.array(a.oids[: a.count]), np.array(o.oids[: o.count])
    check(np.array_equal(pks, np.asarray(o.keys[: o.count])), "ours' keys differ from the ancestor's")
    rewritten = (a_oids != o_oids).any(axis=1)
    rng = np.random.default_rng(seed + 14)
    edited = rng.permutation(np.flatnonzero(rewritten))
    untouched = rng.permutation(np.flatnonzero(~rewritten))
    cut, n_take, n_del, n_ins = len(edited) * 99 // 100, n // 5, n // 100, n // 100
    ins_pks = pks[-1] + 1 + np.arange(n_ins, dtype=np.int64)
    ins_oids = rng.integers(0, 2**32, size=(n_ins, 5), dtype=np.uint32)
    t_oids = a_oids.copy()
    rewrite = np.concatenate([edited[:cut], untouched[:n_take]])
    t_oids[rewrite] = rng.integers(0, 2**32, size=(len(rewrite), 5), dtype=np.uint32)
    all_rows = np.arange(n)
    versions, blocks = {}, {}
    for name, gone, oids in (
        ("theirs", np.concatenate([edited[cut:], untouched[n_take : n_take + n_del]]), t_oids),
        ("theirs-clean", untouched[n_take : n_take + n_del],
         np.where(rewritten[:, None], a_oids, t_oids)),
    ):
        keep = np.ones(n, bool)
        keep[gone] = False
        keys = np.concatenate([pks[keep], ins_pks])
        woids = np.concatenate([oids[keep], ins_oids])
        commit_version(repo, ancestor, f"refs/heads/{name}", keys, woids, f"{name} edits")
        blocks[name] = FeatureBlock.from_arrays(keys, woids, pad=False)
        versions[name] = (np.concatenate([all_rows[keep], n + np.arange(n_ins)]), woids)
    truth = {}
    for name in ("theirs", "theirs-clean"):
        d, present = merge_truth(n + n_ins, [(all_rows, a_oids), (all_rows, o_oids),
                                             versions[name]])
        truth[name] = d[present]
    blocks["ancestor"] = FeatureBlock.from_arrays(pks, a_oids, pad=False)
    blocks["ours"] = FeatureBlock.from_arrays(pks, o_oids, pad=False)
    return repo, blocks, truth


def make_merge_triple(rng, n):
    """A triple of ``n`` ancestor rows: keys with gaps; ours and theirs
    each rewrite 10% of the rows (theirs a third of its rewrites as ours
    would, so overlaps split between same and conflicting edits), delete
    1% and insert 1% (half of theirs' inserts at ours' keys: add/add)."""
    pks = np.cumsum(rng.integers(1, 4, n)).astype(np.int64) - 2**40
    a = rng.integers(0, 2**32, size=(n, 5), dtype=np.uint32)
    sides = []
    ins_o = pks[-1] + 1 + 3 * np.arange(n // 100, dtype=np.int64)
    for k in range(2):
        oids = a.copy()
        rw = np.flatnonzero(rng.random(n) < 0.1)
        flip = np.ones(len(rw), np.uint32) if k == 0 else np.where(
            rng.random(len(rw)) < 1 / 3, 1, 2).astype(np.uint32)
        oids[rw, 0] ^= flip
        keep = rng.random(n) >= 0.01
        ins = ins_o if k == 0 else np.concatenate([ins_o[::2], ins_o[-1] + 1 + np.arange(n // 200)])
        keys = np.concatenate([pks[keep], ins])
        sides.append((keys, np.concatenate([oids[keep], rng.integers(0, 2**32, size=(len(ins), 5),
                                                                         dtype=np.uint32)])))
    return [(pks, a)] + sides


def k4_inputs(blocks, dev):
    """Three blocks -> K4's nine side arguments on ``dev``."""
    args = []
    for b in blocks:
        args += [*block_tensors(b, dev), b.count]
    return args


def k4_check_and_time(label, blocks, dev, card, truth=None, phase="15"):
    """K4 against its plain version on the card, its union against
    np.unique, its decisions and counts against ``truth`` (decisions by
    union row) and its slice plan against the plain plan; -> its timings
    beside its bound and the partial yardsticks."""
    args = k4_inputs(blocks, dev)
    got = merge_classify_sides(*args)
    want = merge_classify_sides_plain(*args)
    torch.cuda.synchronize()
    check(all(g.shape == w.shape for g, w in zip(got, want)),
          f"K4's union size {len(got[0])} != plain {len(want[0])} on {label}")
    err = max(mismatches(g, w) for g, w in zip(got, want))
    check(err == 0, f"K4 differs from its plain version on {label}")
    union = got[0]
    u = len(union)
    check(np.array_equal(union.cpu().numpy(),
                         np.unique(np.concatenate([np.asarray(b.keys[: b.count]) for b in blocks]))),
          f"K4's union differs from np.unique on {label}")
    counts = got[3].tolist()
    if truth is not None:
        check(np.array_equal(got[1].cpu().numpy(), truth), f"K4 decisions differ from the truth on {label}")
        want_counts = [int((truth == 2).sum()), int((truth == 1).sum())]
        check(counts == want_counts, f"K4 counts {counts} != truth {want_counts} on {label}")
    keys = [(args[i], args[i + 2]) for i in (0, 3, 6)]
    check(torch.equal(merge_tile_plan(*(x for kc in keys for x in kc)),
                      merge_tile_plan_plain(*(k[:c] for k, c in keys))),
          f"K4's slice plan differs from the plain plan on {label}")
    rows = sum(b.count for b in blocks)
    b = bound(rows * 28 + u * 8 + u * 2, 0)
    cat_keys = torch.cat([args[0], args[3], args[6]])

    def launch():
        return launch_merge_classify(*args)

    out = {
        "max_abs_err": err,
        "ms": time_ms(lambda: merge_classify_sides(*args)),
        "device_split": device_ms(launch, ("tile_plan_kernel", "tile_rows_kernel",
                                           "merge_tiles_kernel", "compact_kernel")),
        "fenced_ms": fenced_ms(launch),
        "plain_ms": time_ms(lambda: merge_classify_sides_plain(*args), batches=3, per_batch=3),
        "bound_ms": b[0], "bound_by": b[1],
        "library_ms": time_ms(lambda: torch.searchsorted(args[0], union)),
        "unique_ms": time_ms(lambda: torch.unique(cat_keys)),
    }
    out["device_ms"] = total_ms(out["device_split"])
    print(f"[{phase}] K4 on {label} ({blocks[0].count} / {blocks[1].count} / {blocks[2].count} "
          f"rows, union {u}): bit-identical to plain and np.unique, plan as planned, counts "
          f"[conflicts, take_theirs] {counts}; wrapper {out['ms']:.4f} ms, device "
          f"{fmt_ms(out['device_ms'])} ("
          + ", ".join(f"{k} {v:.4f}" for k, v in out["device_split"].items())
          + f"), fenced {out['fenced_ms']:.4f} ms (plain "
          f"{out['plain_ms']:.4f} ms, bound {b[0]:.4f} ms by {b[1]}; partial yardsticks: "
          f"torch.searchsorted(ancestor_keys, union) {out['library_ms']:.4f} ms, torch.unique"
          f"(concatenated keys) {out['unique_ms']:.4f} ms) on {card}")
    return out


def merge_phases(args, card, launches, dev, s_walls=None):
    """Phases 14-17: build the merge repository, check and time K4, then
    drive ``kart merge`` and ``kart conflicts`` through the CLI on the
    card and with ``--device cpu``, adding every card command's launches
    to ``launches``; with ``s_walls``, [S3]'s merge after [16] (its wall in
    ``s_walls``). -> K4's entry of the kernels line (without launches)."""
    os.environ.update(GIT_AUTHOR_DATE=MERGE_DATE, GIT_COMMITTER_DATE=MERGE_DATE)
    n = args.merge_rows
    with tempfile.TemporaryDirectory(prefix="kart_smoke_merge_") as tmp:
        t = time.perf_counter()
        repo, blocks, truth = build_merge_repo(os.path.join(tmp, "repo"), n, args.seed)
        build_s = time.perf_counter() - t
        packs = repo.odb.packs.packs
        n_conf, n_take = int((truth["theirs"] == 2).sum()), int((truth["theirs"] == 1).sum())
        check((n_conf, n_take) == (n // 2, n // 5 + n // 50),
              f"truth has {n_conf} conflicts and {n_take} take-theirs")
        check(((truth["theirs-clean"] == 2).sum(), (truth["theirs-clean"] == 1).sum())
              == (0, n_take), "theirs-clean's truth is not clean")
        print(f"[14] merge repo: {n} features, ours rewrote {n // 2}; theirs: truth "
              f"{n_conf} conflicts, {n_take} take-theirs; theirs-clean: 0 and {n_take}; built "
              f"in {build_s:.2f} s host wall, {sum(p.count for p in packs)} objects, "
              f"{sum(os.path.getsize(p.pack_path) for p in packs)} pack bytes on {card}")

        # [15] K4 on the commits' blocks, then on a 10M-row triple
        trio = [blocks["ancestor"], blocks["ours"], blocks["theirs"]]
        k4 = k4_check_and_time("the merge repo's commits", trio, dev, card, truth["theirs"])
        k4_check_and_time("ancestor, ours, theirs-clean",
                          [blocks["ancestor"], blocks["ours"], blocks["theirs-clean"]], dev, card,
                          truth["theirs-clean"])
        rng = np.random.default_rng(args.seed + 15)
        big = [FeatureBlock.from_arrays(k, o, pad=False) for k, o in make_merge_triple(rng, args.rows)]
        k4_big = k4_check_and_time(f"a {args.rows}-row triple", big, dev, card)
        del big
        k4.update({f"{k}_10m": v for k, v in k4_big.items() if k.endswith("ms")})
        if args.k4_only:
            return k4

        # [16] merge on the card and with --device cpu
        path = repo.workdir
        mi_path = os.path.join(repo.gitdir, "MERGE_INDEX")

        def cli_to(name, *argv, rc_want=0, where="card"):
            pre = [] if where == "card" else ["--device", "cpu"]
            with open(os.path.join(tmp, name), "w") as f, contextlib.redirect_stdout(f):
                return kart_cli(*pre, "-C", path, *argv, rc_want=rc_want)

        def out_sha(name):
            return sha256_of(os.path.join(tmp, name))

        dry = ["merge", "theirs", "--dry-run", "-o", "json"]
        w_card, _ = counted("16", lambda: cli_to("dry.card", *dry), launches, want=0, want_k4=1)
        w_cpu = cli_to("dry.cpu", *dry, where="cpu")
        check(out_sha("dry.card") == out_sha("dry.cpu"), "dry-run json differs card / cpu")
        with open(os.path.join(tmp, "dry.card")) as f:
            doc = json.load(f)
        check(doc == {"kart.merge/v1": {"conflicts": {"synth": {"feature": n_conf}},
                                        "state": "merging", "dryRun": True}},
              f"dry-run said {doc}")
        check(not os.path.exists(mi_path), "a dry run wrote MERGE_INDEX")
        print(f"[16] merge --dry-run -o json: {n_conf} conflicts; card {w_card:.4f} s, cpu "
              f"{w_cpu:.4f} s host wall, sha256 {out_sha('dry.card')} on both; K4 1 on {card}")

        merge = ["merge", "theirs", "-o", "json"]
        walls = {}
        walls["merge card"], _ = counted("16", lambda: cli_to("merge.card", *merge), launches,
                                         want=0, want_k4=1)
        mi_card = sha256_of(mi_path)
        with open(mi_path, "rb") as f:
            check(f.read(6) == b"KMIX2\n", "MERGE_INDEX of 1M conflicts is not KMIX2")
        mi_bytes = os.path.getsize(mi_path)
        walls["conflicts -ss"] = cli_to("conflicts.json", "conflicts", "-ss", "-o", "json")
        with open(os.path.join(tmp, "conflicts.json")) as f:
            doc = json.load(f)
        check(doc == {"kart.conflicts/v1": {"synth": {"feature": n_conf}}}, f"conflicts said {doc}")
        walls["conflicts quiet"] = cli_to("quiet", "conflicts", "-o", "quiet", rc_want=1)
        walls["abort"] = cli_to("abort", "merge", "--abort")
        check(not os.path.exists(mi_path), "merge --abort left MERGE_INDEX")
        walls["merge cpu"] = cli_to("merge.cpu", *merge, where="cpu")
        check(out_sha("merge.card") == out_sha("merge.cpu"), "merge json differs card / cpu")
        check(sha256_of(mi_path) == mi_card, "MERGE_INDEX differs card / cpu")
        cli_to("abort", "merge", "--abort", where="cpu")
        print(f"[16] merge -o json: stdout sha256 {out_sha('merge.card')} and MERGE_INDEX (KMIX2, "
              f"{mi_bytes} bytes) sha256 {mi_card} equal card / cpu; host wall s: "
              + ", ".join(f"{k} {v:.4f}" for k, v in walls.items()) + f"; K4 1 on {card}")
        (profile, split), _ = counted(
            "16", lambda: profile_split(lambda: cli_to("merge.prof", *merge), MERGE_STEPS),
            launches, want=0, want_k4=1)
        cli_to("abort", "merge", "--abort")
        print("[16] host profile of the card's merge (cProfile, cumulative s): "
              + "; ".join(f"{k} {v:.4f}" for k, v in split.items()) + f" on {card}")
        print(profile)
        if s_walls is not None:
            s_walls["S3"] = s_walls.get("S3", 0.0) + stream_cli_merge(
                path, tmp, card, launches, trio, (out_sha("merge.card"), mi_card))

        # [17] the clean merge, committed, on both routes
        head = repo.refs.get("refs/heads/main")
        clean = ["merge", "theirs-clean", "--no-ff", "-o", "json"]
        results = {}
        for where in ("card", "cpu"):
            repo.refs.set("refs/heads/main", head)
            if where == "card":
                wall, _ = counted("17", lambda: cli_to("clean.card", *clean), launches, want=0,
                                  want_k4=1)
            else:
                wall = cli_to("clean.cpu", *clean, where="cpu")
            with open(os.path.join(tmp, f"clean.{where}")) as f:
                commit = json.load(f)["kart.merge/v1"]["commit"]
            c = repo.odb.read_commit(commit)
            check(list(c.parents) == [head, repo.refs.get("refs/heads/theirs-clean")],
                  "the clean merge's parents")
            check(repo.refs.get("refs/heads/main") == commit, "main is not at the merge commit")
            results[where] = (commit, c.tree, wall)
        check(results["card"][:2] == results["cpu"][:2], f"clean merge differs: {results}")
        print(f"[17] merge theirs-clean --no-ff: commit {results['card'][0]}, tree "
              f"{results['card'][1]} on both; card {results['card'][2]:.4f} s, cpu "
              f"{results['cpu'][2]:.4f} s host wall; K4 1 on {card}")
    return k4


# --- hash-keyed datasets: text pks on K1 and K4 -------------------------------

#: the host steps of the hash-keyed json-lines run (the delta route)
HASH_JSONL_STEPS = {
    "classify (sidecar mmap, upload, K1, changed rows)": "classify_changed",
    "deltas from the changed rows (filename decode of the changed paths)":
        "get_feature_diff_columnar",
    "of it the collision guard's filenames": "_filenames",
    "blob reads (pack index, zlib)": "read_blobs_batch",
    "serialisation": "_feature_json_str",
}


def hash_diff_phases(args, card, launches, dev):
    """Phases 18-20: build a text-pk repository (hash-keyed sidecars), drive
    ``kart diff``, ``show`` and ``--only-feature-count fast`` on the card and
    with ``--device cpu``, then check and time K1 on its blocks. -> K1's
    hash-key timings, for the kernels line."""
    n = args.text_rows
    with tempfile.TemporaryDirectory(prefix="kart_smoke_text_") as tmp:
        t = time.perf_counter()
        repo, info = synth_repo(os.path.join(tmp, "repo"), n, edit_frac=0.01, seed=args.seed,
                                blobs="changed", pk="text")
        build_s = time.perf_counter() - t
        packs = repo.odb.packs.packs
        col_dir = os.path.join(repo.gitdir, "columnar")
        sidecar_bytes = sum(os.path.getsize(os.path.join(col_dir, f)) for f in os.listdir(col_dir))
        n_edits, path = info["n_edits"], repo.workdir
        print(f"[18] text-pk repo: {n} G-NAF-shaped ids, {n_edits} edited, built in "
              f"{build_s:.2f} s host wall; {sum(p.count for p in packs)} objects in {len(packs)} "
              f"packs, {sum(os.path.getsize(p.pack_path) for p in packs)} pack bytes, "
              f"{sidecar_bytes} sidecar bytes (hash-keyed, with paths) on {card}")

        spec = "HEAD^...HEAD"
        runs = {
            "feature-count": (["diff", "-o", "feature-count", spec], False),
            "json-lines": (["diff", "-o", "json-lines", spec], False),
            "json": (["diff", "-o", "json", spec], False),
            "text": (["diff", spec], False),
            "show": (["show", "HEAD"], True),
        }
        for name, (argv, stdout) in runs.items():
            out = os.path.join(tmp, name)
            w_card, w_cpu, digest, _ = card_and_cpu("19", ["-C", path, *argv], out, launches,
                                                    k2=0, stdout=stdout)
            with open(f"{out}.card") as f:
                body = f.read()
            if name == "feature-count":
                check(body == f"synth:\n\t{n_edits} features changed\n",
                      f"feature-count said {body!r}")
            elif name == "json-lines":
                check(body.count('"type":"feature"') == n_edits, "json-lines feature lines")
            elif name == "json":
                got = len(json.loads(body)["kart.diff/v1+hexwkb"]["synth"]["feature"])
                check(got == n_edits, f"json has {got} features, expected {n_edits}")
            else:
                got = body.count("\n--- synth:feature:GA") + body.startswith("--- synth:feature:")
                check(got == n_edits, f"{name} shows {got} features, expected {n_edits}")
            print(f"[19] {' '.join(argv)}: {len(body)} chars, sha256 {digest} on both; card "
                  f"{w_card:.4f} s, cpu {w_cpu:.4f} s host wall; K1 1 (full classify, not "
                  f"counts-only), hash_collision_fallbacks 0 on {card}")
        db = os.path.join(repo.gitdir, "annotations.db")
        argv = ["-C", path, "diff", "--only-feature-count", "fast", spec]
        outs, walls = {}, {}
        for where in ("card", "cpu"):
            if os.path.exists(db):
                os.remove(db)
            pre = [] if where == "card" else ["--device", "cpu"]
            outs[where] = os.path.join(tmp, f"fast.{where}")

            def go(pre=pre, to=outs[where]):
                with open(to, "w") as f, contextlib.redirect_stdout(f):
                    return kart_cli(*pre, *argv)

            if where == "card":
                walls[where], _ = counted("19", go, launches, want=0)
            else:
                walls[where] = go()
        digest = sha256_of(outs["card"])
        check(digest == sha256_of(outs["cpu"]), "the fast estimate differs card / cpu")
        with open(outs["card"]) as f:
            text = f.read()
        est = int(text.split("\t")[1].split()[0])
        check(0.5 * n_edits < est < 1.5 * n_edits, f"fast estimate said {text!r}")
        print(f"[19] --only-feature-count fast: {text.strip()!r} (the tree sampler, no launch); "
              f"sha256 {digest} on both; card {walls['card']:.4f} s, cpu {walls['cpu']:.4f} s "
              f"host wall on {card}")
        jl = ["-C", path, "diff", "-o", "json-lines", spec, "--output",
              os.path.join(tmp, "prof.jsonl")]
        profile, split = counted("19", lambda: profile_split(lambda: kart_cli(*jl),
                                                            HASH_JSONL_STEPS), launches)[0]
        print("[19] host profile of the card's json-lines run (cProfile, cumulative s): "
              + "; ".join(f"{k} {v:.4f}" for k, v in split.items()) + f" on {card}")
        print(profile)

        # [20] K1 on the hash-keyed blocks
        old = load_block(repo, repo.structure("HEAD^").datasets["synth"])
        new = load_block(repo, repo.structure("HEAD").datasets["synth"])
        ok, oo = block_tensors(old, dev)
        nk, no = block_tensors(new, dev)
        got = classify(ok, oo, nk, no)
        want = classify_plain(ok, oo, nk, no)
        torch.cuda.synchronize()
        err = max(mismatches(g, w) for g, w in zip(got, want))
        check(err == 0, "K1 differs from its plain version on hash keys")
        check(got[2].tolist() == [0, n_edits, 0], f"K1 counts {got[2].tolist()} on hash keys")
        keys = np.asarray(new.keys[: new.count])
        rows = old.count + new.count
        steps = old.count * np.log2(max(new.count, 2)) + new.count * np.log2(max(old.count, 2))
        b = bound(rows * 28 + rows, steps + rows * 5)
        split = device_ms(lambda: classify(ok, oo, nk, no), ("corank_kernel", "classify_tiles"))
        k1 = {"rows": [old.count, new.count], "max_abs_err": err,
              "key_range": [int(keys.min()), int(keys.max())],
              "ms": time_ms(lambda: classify(ok, oo, nk, no)), "device_ms": total_ms(split),
              "device_split": split, "fenced_ms": fenced_ms(lambda: classify(ok, oo, nk, no)),
              "plain_ms": time_ms(lambda: classify_plain(ok, oo, nk, no), batches=3, per_batch=3),
              "bound_ms": b[0], "bound_by": b[1],
              "library_ms": time_ms(lambda: torch.searchsorted(nk, ok))}
        print(f"[20] K1 on the hash-keyed blocks ({old.count} / {new.count} rows, keys in "
              f"[{k1['key_range'][0]}, {k1['key_range'][1]}]): bit-identical to plain, counts "
              f"{got[2].tolist()}; wrapper {k1['ms']:.4f} ms, device {fmt_ms(k1['device_ms'])} ("
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"), fenced {k1['fenced_ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms, bound "
              f"{b[0]:.4f} ms by {b[1]}, torch.searchsorted {k1['library_ms']:.4f} ms on {card}")
        del ok, oo, nk, no, got, want
    return k1


def commit_text_version(repo, parent, ref, cols, rows, oids, message):
    """Commit ``parent``'s tree with its feature tree replaced by the text-pk
    rows ``rows`` of ``cols`` (:class:`~kart_tpu_torch.synth.HashedColumns`)
    with blob oids ``oids`` ((n, 5) uint32), and its sidecar; -> the commit
    oid."""
    odb = repo.odb
    oids_u8 = np.ascontiguousarray(oids).view(np.uint8).reshape(-1, 20)
    with odb.bulk_pack(level=0):
        plan = plan_feature_tree(cols.leaf_ids[rows], cols.b64[rows], cols.b64_len[rows],
                                 PathEncoder.GENERAL_ENCODER)
        ftree, _ = emit_feature_tree(odb, plan, oids_u8)
        tb = TreeBuilder(odb, odb.read_commit(parent).tree)
        tb.insert("synth/.table-dataset/feature", ftree, mode=MODE_TREE)
        root = tb.flush()
    save_sidecar(repo, ftree, cols.keys[rows], oids_u8, paths=cols.paths[rows])
    return repo.create_commit(ref, root, message, [parent])


def build_text_merge_repo(path, n, seed):
    """Phase [21]'s repository: [14]'s shape (module docstring) on a text-pk
    layer of ``n`` G-NAF-shaped ids, the inserts new ids. -> (repo,
    {name: FeatureBlock}, {name: decision by union row}) as
    :func:`build_merge_repo`, and the id of a conflicted feature."""
    repo, info = synth_repo(path, n, edit_frac=0.5, seed=seed, blobs="promised", pk="text")
    n_ins = n // 100
    cols = HashedColumns(gnaf_ids(np.arange(n + n_ins)))
    ancestor = repo.odb.read_commit(info["edit_commit"]).parents[0]
    by_row = []
    for rev in (ancestor, "HEAD"):
        block = load_block(repo, repo.structure(rev).datasets["synth"])
        pos = np.searchsorted(np.asarray(block.keys[: block.count]), cols.keys[:n])
        by_row.append(np.array(block.oids[: block.count])[pos])
    a_oids, o_oids = by_row
    rewritten = (a_oids != o_oids).any(axis=1)
    rng = np.random.default_rng(seed + 21)
    edited = rng.permutation(np.flatnonzero(rewritten))
    untouched = rng.permutation(np.flatnonzero(~rewritten))
    cut, n_take, n_del = len(edited) * 99 // 100, n // 5, n // 100
    ins_oids = rng.integers(0, 2**32, size=(n_ins, 5), dtype=np.uint32)
    t_oids = a_oids.copy()
    rewrite = np.concatenate([edited[:cut], untouched[:n_take]])
    t_oids[rewrite] = rng.integers(0, 2**32, size=(len(rewrite), 5), dtype=np.uint32)
    all_rows = np.arange(n)
    versions, blocks = {}, {}
    for name, gone, oids in (
        ("theirs", np.concatenate([edited[cut:], untouched[n_take : n_take + n_del]]), t_oids),
        ("theirs-clean", untouched[n_take : n_take + n_del],
         np.where(rewritten[:, None], a_oids, t_oids)),
    ):
        keep = np.ones(n, bool)
        keep[gone] = False
        rows = np.concatenate([all_rows[keep], n + np.arange(n_ins)])
        woids = np.concatenate([oids[keep], ins_oids])
        commit_text_version(repo, ancestor, f"refs/heads/{name}", cols, rows, woids,
                            f"{name} edits")
        blocks[name] = FeatureBlock.from_arrays(cols.keys[rows], woids, pad=False)
        versions[name] = (rows, woids)
    order = np.argsort(cols.keys)  # union rows in key order
    conflict_id = gnaf_ids(edited[:1])[0]  # ours and theirs rewrote it
    truth = {}
    for name in ("theirs", "theirs-clean"):
        d, present = merge_truth(n + n_ins, [(all_rows, a_oids), (all_rows, o_oids),
                                             versions[name]])
        truth[name] = d[order][present[order]]
    blocks["ancestor"] = FeatureBlock.from_arrays(cols.keys[:n], a_oids, pad=False)
    blocks["ours"] = FeatureBlock.from_arrays(cols.keys[:n], o_oids, pad=False)
    return repo, blocks, truth, conflict_id


def hash_merge_phases(args, card, launches, dev):
    """Phase 21: the text-pk merge repository, K4 on its commits' blocks,
    then ``kart merge``, ``conflicts``, ``resolve`` and ``merge --abort``
    through the CLI on the card and with ``--device cpu``. -> K4's
    hash-key timings, for the kernels line."""
    os.environ.update(GIT_AUTHOR_DATE=MERGE_DATE, GIT_COMMITTER_DATE=MERGE_DATE)
    n = args.text_merge_rows
    with tempfile.TemporaryDirectory(prefix="kart_smoke_text_merge_") as tmp:
        t = time.perf_counter()
        repo, blocks, truth, conflict_id = build_text_merge_repo(os.path.join(tmp, "repo"), n,
                                                                 args.seed)
        build_s = time.perf_counter() - t
        packs = repo.odb.packs.packs
        n_conf, n_take = int((truth["theirs"] == 2).sum()), int((truth["theirs"] == 1).sum())
        check((n_conf, n_take) == (n // 2, n // 5 + n // 50),
              f"truth has {n_conf} conflicts and {n_take} take-theirs")
        print(f"[21] text-pk merge repo: {n} features, ours rewrote {n // 2}; theirs: truth "
              f"{n_conf} conflicts, {n_take} take-theirs; built in {build_s:.2f} s host wall, "
              f"{sum(p.count for p in packs)} objects, "
              f"{sum(os.path.getsize(p.pack_path) for p in packs)} pack bytes on {card}")
        trio = [blocks["ancestor"], blocks["ours"], blocks["theirs"]]
        k4 = k4_check_and_time("the text-pk merge repo's commits (hash keys)", trio, dev, card,
                               truth["theirs"], phase="21")

        path, mi_path = repo.workdir, os.path.join(repo.gitdir, "MERGE_INDEX")

        def cli_to(name, *argv, rc_want=0, where="card"):
            pre = [] if where == "card" else ["--device", "cpu"]
            with open(os.path.join(tmp, name), "w") as f, contextlib.redirect_stdout(f):
                return kart_cli(*pre, "-C", path, *argv, rc_want=rc_want)

        def card_counted(name, *argv):
            return counted("21", lambda: cli_to(name, *argv), launches, want=0, want_k4=1)[0]

        def out_sha(name):
            return sha256_of(os.path.join(tmp, name))

        walls = {}
        dry = ["merge", "theirs", "--dry-run", "-o", "json"]
        walls["dry-run card"] = card_counted("dry.card", *dry)
        walls["dry-run cpu"] = cli_to("dry.cpu", *dry, where="cpu")
        check(out_sha("dry.card") == out_sha("dry.cpu"), "dry-run json differs card / cpu")
        with open(os.path.join(tmp, "dry.card")) as f:
            check(json.load(f) == {"kart.merge/v1": {"conflicts": {"synth": {"feature": n_conf}},
                                                     "state": "merging", "dryRun": True}},
                  "the text-pk dry run's conflicts")
        label = f"synth:feature:{conflict_id}"
        merge = ["merge", "theirs", "-o", "json"]
        results = {}
        for where in ("card", "cpu"):
            if where == "card":
                walls["merge card"] = card_counted("merge.card", *merge)
            else:
                walls["merge cpu"] = cli_to("merge.cpu", *merge, where="cpu")
            with open(mi_path, "rb") as f:
                check(f.read(6) == b"KMIX2\n", "the text-pk MERGE_INDEX is not KMIX2")
            mi_sha = sha256_of(mi_path)
            walls[f"conflicts -ss {where}"] = cli_to(f"ss.{where}", "conflicts", "-ss", "-o",
                                                     "json", where=where)
            walls[f"resolve {where}"] = cli_to(f"resolve.{where}", "resolve", label, "--with",
                                               "theirs", where=where)
            resolved_sha = sha256_of(mi_path)
            walls[f"abort {where}"] = cli_to(f"abort.{where}", "merge", "--abort", where=where)
            check(not os.path.exists(mi_path), "merge --abort left MERGE_INDEX")
            results[where] = [out_sha(f"merge.{where}"), mi_sha, out_sha(f"ss.{where}"),
                              out_sha(f"resolve.{where}"), resolved_sha]
        check(results["card"] == results["cpu"], f"text-pk merge outputs differ: {results}")
        with open(os.path.join(tmp, "ss.card")) as f:
            check(json.load(f) == {"kart.conflicts/v1": {"synth": {"feature": n_conf}}},
                  "the text-pk conflicts -ss")
        print(f"[21] merge -o json, conflicts -ss -o json, resolve {label} --with theirs, merge "
              f"--abort: stdout, MERGE_INDEX (KMIX2) and resolved MERGE_INDEX sha256 "
              f"{results['card'][0]}, {results['card'][1]}, {results['card'][4]} equal card / "
              f"cpu; host wall s: " + ", ".join(f"{k} {v:.4f}" for k, v in walls.items())
              + f"; K4 1 a card merge, hash_collision_fallbacks 0 on {card}")
        (profile, split), _ = counted(
            "21", lambda: profile_split(lambda: cli_to("merge.prof", *merge), MERGE_STEPS),
            launches, want=0, want_k4=1)
        cli_to("abort", "merge", "--abort")
        print("[21] host profile of the card's text-pk merge (cProfile, cumulative s): "
              + "; ".join(f"{k} {v:.4f}" for k, v in split.items()) + f" on {card}")
        print(profile)

        head = repo.refs.get("refs/heads/main")
        clean = ["merge", "theirs-clean", "--no-ff", "-o", "json"]
        commits = {}
        for where in ("card", "cpu"):
            repo.refs.set("refs/heads/main", head)
            wall = (card_counted("clean.card", *clean) if where == "card"
                    else cli_to("clean.cpu", *clean, where="cpu"))
            with open(os.path.join(tmp, f"clean.{where}")) as f:
                commit = json.load(f)["kart.merge/v1"]["commit"]
            commits[where] = (commit, repo.odb.read_commit(commit).tree, wall)
        check(commits["card"][:2] == commits["cpu"][:2], f"clean text-pk merge differs: {commits}")
        print(f"[21] merge theirs-clean --no-ff: commit {commits['card'][0]}, tree "
              f"{commits['card'][1]} on both; card {commits['card'][2]:.4f} s, cpu "
              f"{commits['cpu'][2]:.4f} s host wall; K4 1 on {card}")
    return k4


# --- main -------------------------------------------------------------------

# --- the classify at north-star scale: the host floor and the streamed routes ------

#: the environment knobs of the streamed routes (``ops/diff_kernel.py``)
MIN_ROWS_KNOB, CHUNK_KNOB = "KART_TORCH_STREAM_MIN_ROWS", "KART_TORCH_STREAM_CHUNK_ROWS"
MONOLITHIC = {MIN_ROWS_KNOB: str(2**62)}
STREAMED = {MIN_ROWS_KNOB: "1"}


@contextlib.contextmanager
def knobs(values):
    """Set environment knobs for the block, then put them back."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def release_pinned():
    """Return cached pinned host memory and free device memory, so that
    the next route pays its own pinned allocation, as a new process does."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()


def classes_digest(*arrays):
    """sha256 over the bytes of each array (tensors on any device, numpy)."""
    h = hashlib.sha256()
    for a in arrays:
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def run_route(route, old, new, dev, counts_only=False, timings=None):
    """One classify of two blocks by ``route`` ("floor", "monolithic",
    "streamed", or "upload": each column through ``to_device``, one K1
    launch, the classes brought back with ``.cpu()``, the card's route
    before it had one driver), from the blocks' arrays to classes and
    counts on the host; a card route's split goes into ``timings``.
    -> ((old_class, new_class, counts) tensors on the host, host wall s)."""
    release_pinned()
    t = time.perf_counter()
    if route == "floor":
        out = classify_blocks_host(old, new)
        if counts_only:
            out = (None, None, out[2])
    elif route == "upload":
        out = classify(*block_tensors(old, dev), *block_tensors(new, dev),
                       counts_only=counts_only)
        out = tuple(None if x is None else x.cpu() for x in out)
    else:
        with knobs(MONOLITHIC if route == "monolithic" else STREAMED):
            out = classify_blocks(old, new, dev, counts_only=counts_only, timings=timings)
        out = tuple(None if x is None else x.cpu() for x in out)
    return out, time.perf_counter() - t


def side_blocks(tmp, name, keys, oids):
    """Write one side as a KCOL1 sidecar (keys and oids only) and mmap it
    back. -> its FeatureBlock."""
    path = save_sidecar_file(os.path.join(tmp, f"{name}.kcol"), keys, oids.view(np.uint8))
    return load_block_file(path)


def fmt_split(split):
    return ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in split.items())


def merge_expectation(base_rows, ours, theirs, truth_o, truth_t):
    """The 3-way merge of a base with two edits of it, from the edits'
    truths alone (no merge code): every key only theirs changed is
    take-theirs, every key both changed is a conflict unless ours and
    theirs now agree (both deleted, or equal oids), and the union is the
    base plus both sides' inserts. -> (union rows, conflicts, take-theirs)."""
    def changed(truth):
        return np.union1d(np.union1d(truth["upd"], truth["del"]), truth["ins"])

    ch_o, ch_t = changed(truth_o), changed(truth_t)
    both = np.intersect1d(ch_o, ch_t)

    def look(block):
        keys = np.asarray(block.keys[: block.count])
        i = np.searchsorted(keys, both)
        ic = np.minimum(i, max(len(keys) - 1, 0))
        return (i < len(keys)) & (keys[ic] == both), np.asarray(block.oids)[ic]

    (po, wo), (pt, wt) = look(ours), look(theirs)
    agree = (~po & ~pt) | (po & pt & (wo == wt).all(axis=1))
    return (base_rows + len(np.union1d(truth_o["ins"], truth_t["ins"])),
            int((~agree).sum()), len(np.setdiff1d(ch_t, ch_o)))


def stream_phases(args, card, launches, dev):
    """Phases S1, S2 and S4 (S3 runs inside the CLI and merge phases, on
    their repositories): the diff and the merge at ``--stream-rows`` a side
    at block level, on the host floor, the card in one chunk and the card
    streamed, each card route's split from its own run; ``columnar_equal``;
    with ``--stream-only`` also the crossover of the three routes and the
    chunk sweep that set the knobs' defaults. -> ({phase: wall s}, K1's
    and K4's streamed timings, the crossover table)."""
    walls, out = {}, {}
    n = args.stream_rows
    tmp = tempfile.TemporaryDirectory(prefix="kart_smoke_stream_")
    print("[S1] host memory and the output directory's disk before generating:")
    print(subprocess.run(["free", "-g"], capture_output=True, text=True).stdout.rstrip())
    print(subprocess.run(["df", "-h", tmp.name], capture_output=True, text=True).stdout.rstrip())
    t_phase = t = time.perf_counter()
    rng = np.random.default_rng(args.seed + 100)
    (k1, o1, _), (k2, o2, _), truth = make_versions(rng, n, envelopes=False)
    old = side_blocks(tmp.name, "old", k1, o1)
    new = side_blocks(tmp.name, "new", k2, o2)
    (k3, o3, _), truth_t = edit_version(np.random.default_rng(args.seed + 101), k1, o1,
                                        beyond_offset=3)
    theirs = side_blocks(tmp.name, "theirs", k3, o3)
    del k1, o1, k2, o2, k3, o3
    gen_s = time.perf_counter() - t
    want = [len(truth["ins"]), len(truth["upd"]), len(truth["del"])]
    print(f"[S1] data: {old.count} / {new.count} / {theirs.count} rows (base, edited, theirs), "
          f"sidecars {sum(os.path.getsize(os.path.join(tmp.name, f)) for f in os.listdir(tmp.name))}"
          f" bytes written and mmap'd back in {gen_s:.2f} s; the page cache is warm: this "
          f"process wrote the files just now; truth {want}")

    # [S1] the diff on the three routes, each card route's split from its own run
    results, split = {}, {"monolithic": {}, "streamed": {}}
    for route in ("floor", "monolithic", "streamed"):
        (res, wall), stats = counted(
            "S1", lambda: run_route(route, old, new, dev, timings=split.get(route)), launches,
            want=0 if route == "floor" else SOME)
        results[route] = (classes_digest(*res[:2]), res[2].tolist(), wall,
                          stats["classify_launches"])
        if route == "floor":
            oc, nc = res[0].numpy(), res[1].numpy()
            keys_old, keys_new = np.asarray(old.keys[: old.count]), np.asarray(new.keys[: new.count])
            check(np.array_equal(keys_old[oc == 3], truth["del"])
                  and np.array_equal(keys_old[oc == 2], truth["upd"])
                  and np.array_equal(keys_new[nc == 2], truth["upd"])
                  and np.array_equal(keys_new[nc == 1], truth["ins"]),
                  "S1: the floor's changed keys differ from the truth")
            del oc, nc, keys_old, keys_new
        del res
    _, (_, n_chunks) = block_splits((old, new))
    check(results["monolithic"][3] == 1 == split["monolithic"]["chunks"],
          f"S1: the monolithic route launched K1 {results['monolithic'][3]} times")
    check(results["streamed"][3] == n_chunks == split["streamed"]["chunks"],
          f"S1: the streamed route launched K1 {results['streamed'][3]} times for "
          f"{n_chunks} chunks")
    digests = {r: v[0] for r, v in results.items()}
    check(len(set(digests.values())) == 1, f"S1: classes differ between routes: {digests}")
    check(all(v[1] == want for v in results.values()), f"S1: counts differ: {results}")
    for route in ("floor", "monolithic", "streamed"):
        (res, wall), _ = counted("S1", lambda: run_route(route, old, new, dev, counts_only=True),
                                 launches, want=0 if route == "floor" else SOME)
        check(res[2].tolist() == want, f"S1: {route} counts-only said {res[2].tolist()}")
        results[route] += (wall,)
    print(f"[S1] classes sha256 {digests['floor']} and counts {want} on the floor, the card in "
          f"one chunk and the card streamed ({n_chunks} chunks of {stream_chunk_rows()} rows); "
          "host wall s (full, counts-only): "
          + ", ".join(f"{r} {v[2]:.4f} / {v[4]:.4f}" for r, v in results.items()) + f" on {card}")
    for route, sp in split.items():
        print(f"[S1] {route} split (the full run above): {fmt_split(sp)} on {card}")
    out["k1_streamed"] = {"rows": n, "chunks": n_chunks, "chunk_rows": stream_chunk_rows(),
                          "wall_s": {r: v[2] for r, v in results.items()},
                          "counts_only_wall_s": {r: v[4] for r, v in results.items()},
                          "split": split}
    walls["S1"] = time.perf_counter() - t_phase

    # [S2] the merge on the card, one chunk and streamed, against K4's plain
    # version on the whole sides and against the edits' truths
    t = time.perf_counter()
    merges, m_split = {}, {}
    blocks = (old, new, theirs)
    _, (_, m_chunks) = block_splits(blocks)
    for route, values, k4 in (("monolithic", MONOLITHIC, 1), ("streamed", STREAMED, m_chunks)):
        release_pinned()
        m_split[route] = {}
        with knobs(values):
            (res, stats) = counted("S2", lambda: timed_call(
                lambda: merge_classify(*blocks, dev, timings=m_split[route])),
                launches, want=0, want_k4=k4)
        (union, decision, presence, counts), wall = res
        merges[route] = (classes_digest(union), classes_digest(decision),
                         classes_digest(presence), counts, wall, len(union))
        del union, decision, presence, res
    check(merges["monolithic"][:4] == merges["streamed"][:4],
          f"S2: the streamed merge differs from the one-chunk merge: {merges}")
    release_pinned()
    t_ref = time.perf_counter()
    ref_args = k4_inputs(blocks, dev)
    ref = merge_classify_sides_plain(*ref_args)
    ref_c = ref[3].tolist()
    plain = (classes_digest(ref[0]), classes_digest(ref[1]), classes_digest(ref[2]),
             {"conflicts": ref_c[0], "take_theirs": ref_c[1]})
    ref_s = time.perf_counter() - t_ref
    del ref_args, ref
    release_pinned()
    check(merges["streamed"][:4] == plain,
          f"S2: the streamed merge differs from K4's plain version on the card: "
          f"{merges['streamed'][:4]} against {plain}")
    u_want, c_want, t_want = merge_expectation(old.count, new, theirs, truth, truth_t)
    got = merges["streamed"]
    check((got[5], got[3]["conflicts"], got[3]["take_theirs"]) == (u_want, c_want, t_want),
          f"S2: union {got[5]}, counts {got[3]} against the truths' {u_want}, {c_want}, {t_want}")
    check(c_want > 0 and t_want > 0, "S2: the merge has no conflicts or no take-theirs rows")
    print(f"[S2] merge of {n} rows a side: union {got[5]} rows, sha256 union {got[0]}, decision "
          f"{got[1]}, presence {got[2]}, counts {got[3]}: equal in one chunk, streamed ({m_chunks}"
          f" chunks, K4 {m_chunks}) and K4's plain version on the card over the whole sides "
          f"({ref_s:.4f} s with the upload); union size and counts equal to the edits' truths; "
          f"host wall s: monolithic {merges['monolithic'][4]:.4f}, streamed {got[4]:.4f} on {card}")
    for route, sp in m_split.items():
        print(f"[S2] {route} split: {fmt_split(sp)} on {card}")
    out["k4_streamed"] = {"rows": n, "chunks": m_chunks, "union": got[5],
                          "wall_s": {r: v[4] for r, v in merges.items()}, "split": m_split,
                          "plain_on_card_s": ref_s}
    walls["S2"] = time.perf_counter() - t
    del theirs, blocks

    # [S4] B12 on the card; with --stream-only the crossover and the chunk sweep
    t = time.perf_counter()
    if args.stream_only:
        out["crossover"] = crossover(args, old, new, dev, card)
    cols = torch.from_numpy(np.random.default_rng(args.seed + 104).integers(
        -2, 2, size=(8, 10_000_000), dtype=np.int64))
    new_cols = cols.clone()
    new_cols[0, ::97] += 1
    masks = [torch.zeros(cols.shape, dtype=torch.bool) for _ in range(2)]
    masks[1][3, ::89] = True
    want_eq = columnar_equal(cols, new_cols, *masks)
    d_args = [x.to(dev) for x in (cols, new_cols, *masks)]
    got_eq = columnar_equal(*d_args)
    check(torch.equal(got_eq.cpu(), want_eq), "columnar_equal on the card differs from the CPU")
    eq_card = time_ms(lambda: columnar_equal(*d_args))
    t_cpu = time.perf_counter()
    for _ in range(3):
        columnar_equal(cols, new_cols, *masks)
    eq_cpu = (time.perf_counter() - t_cpu) / 3 * 1e3
    print(f"[S4] columnar_equal on 8 x 10,000,000 int64 columns with null masks: card "
          f"{eq_card:.4f} ms (CUDA events), CPU {eq_cpu:.4f} ms (host wall, {torch.get_num_threads()}"
          f" threads), {int(want_eq.sum())} rows equal on both on {card}")
    out["columnar_equal_ms"] = {"card": eq_card, "cpu": eq_cpu}
    walls["S4"] = time.perf_counter() - t
    del cols, new_cols, masks, d_args, old, new
    release_pinned()
    tmp.cleanup()
    return walls, out


def crossover(args, old, new, dev, card):
    """[S4] with ``--stream-only``: the floor, the card's earlier one-upload
    route, the card in one chunk and the card streamed at
    ``--crossover-rows`` a side (prefixes of [S1]'s sides), interleaved,
    host walls first and best of ``--crossover-reps``; the streamed route
    at [S1]'s size by ``--chunk-sweep`` chunk rows. -> the table."""
    table = []
    keys_old = np.asarray(old.keys[: old.count])
    keys_new = np.asarray(new.keys[: new.count])
    for rows in args.crossover_rows:
        rows = min(rows, old.count)
        m = int(np.searchsorted(keys_new, keys_old[rows - 1], side="right"))
        a = FeatureBlock(old.keys[:rows], old.oids[:rows], rows)
        b = FeatureBlock(new.keys[:m], new.oids[:m], m)
        row = {"rows": rows}
        routes = ("floor", "upload", "monolithic", "streamed")
        for _ in range(args.crossover_reps):  # the routes interleaved, each rep
            for route in routes:
                split = {}
                wall = run_route(route, a, b, dev, timings=split)[1]
                row.setdefault(route, {"all_s": []})["all_s"].append(wall)
                if split and wall == min(row[route]["all_s"]):
                    row[route]["split_of_best"] = split
        for route in routes:
            ws = row[route]["all_s"]
            row[route].update(first_s=ws[0], best_s=min(ws))
        table.append(row)
        print(f"[S4] {rows} rows a side: host wall s (first, best of {args.crossover_reps}) "
              + ", ".join(f"{r} {row[r]['first_s']:.4f} / {row[r]['best_s']:.4f}" for r in routes)
              + "; best runs' splits: " + "; ".join(
                  f"{r} {fmt_split(row[r]['split_of_best'])}" for r in routes[2:]) + f" on {card}")
    sweep = {}
    for chunk in args.chunk_sweep:
        with knobs({CHUNK_KNOB: str(chunk)}):
            ws = [run_route("streamed", old, new, dev)[1] for _ in range(3)]
        sweep[chunk] = min(ws)
    print(f"[S4] streamed at {old.count} rows a side by chunk rows, best host wall s: "
          + ", ".join(f"{c} {w:.4f}" for c, w in sweep.items()) + f" on {card}")
    return {"table": table, "chunk_sweep_best_s": sweep}


def timed_call(fn):
    """-> (fn's result, host wall s, the card synchronized)."""
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


def stream_cli_diff(repo, path, tmp, card, launches, n_edits, ref):
    """[S3], the diff: on [7]'s repository with the knobs lowered so that a
    command runs 5 or more chunks, ``-o feature-count`` and ``-o
    json-lines`` through the streamed route: one K1 launch a chunk, and the
    bytes of the monolithic card run and of ``--device cpu`` (``ref``: the
    json-lines sha256 [9] found equal on both, or None to run both here).
    -> host wall s."""
    t = time.perf_counter()
    blocks = [load_block(repo, repo.structure(rev).datasets["synth"]) for rev in ("HEAD^", "HEAD")]
    chunk = max(1, max(b.count for b in blocks) // 5)
    _, (_, n_chunks) = block_splits(blocks, chunk)
    check(n_chunks >= 4, f"S3: {n_chunks} chunks")
    counts_text = f"synth:\n\t{n_edits} features changed\n"
    jsonl = ["-C", path, "diff", "-o", "json-lines", "HEAD^...HEAD", "--output"]
    out = os.path.join(tmp, "s3.jsonl")
    if ref is None:
        with knobs(MONOLITHIC):
            kart_cli(*jsonl, out)
        ref = sha256_of(out)
        kart_cli("--device", "cpu", *jsonl, out)
        check(sha256_of(out) == ref, "S3: json-lines differs card / cpu")
    with knobs({**STREAMED, CHUNK_KNOB: str(chunk)}):
        texts = []
        for pre, want in (([], n_chunks), (["--device", "cpu"], 0)):
            fc = os.path.join(tmp, "s3.count")
            counted("S3", lambda: kart_cli(*pre, "-C", path, "diff", "-o", "feature-count",
                                           "--output", fc, "HEAD^...HEAD"), launches, want=want)
            with open(fc) as f:
                texts.append(f.read())
        check(texts == [counts_text] * 2, f"S3: feature-count said {texts}")
        wall, _ = counted("S3", lambda: kart_cli(*jsonl, out), launches, want=n_chunks)
        check(sha256_of(out) == ref, "S3: the streamed json-lines differs from the monolithic run")
    print(f"[S3] diff on the {blocks[0].count}-row repo, streamed in {n_chunks} chunks of {chunk}"
          f" rows: feature-count {n_edits} (K1 {n_chunks} counts-only, equal to --device cpu), "
          f"json-lines sha256 {ref} equal to the monolithic card and --device cpu (K1 "
          f"{n_chunks}, {wall:.4f} s host wall) on {card}")
    return time.perf_counter() - t


def stream_cli_merge(path, tmp, card, launches, blocks, ref):
    """[S3], the merge: ``merge theirs -o json`` on [14]'s repository
    through the streamed route (5 or more chunks, one K4 launch each), then
    ``merge --abort``: stdout and MERGE_INDEX as ``ref`` (the sha256 pair
    [16] found equal on the card and with ``--device cpu``, or None to run
    both here). -> host wall s."""
    t = time.perf_counter()
    chunk = max(1, max(b.count for b in blocks) // 5)
    _, (_, n_chunks) = block_splits(blocks, chunk)
    check(n_chunks >= 4, f"S3: {n_chunks} merge chunks")
    mi_path = os.path.join(path, ".kart", "MERGE_INDEX")
    out = os.path.join(tmp, "s3.merge")

    def merge(*pre):
        with open(out, "w") as f, contextlib.redirect_stdout(f):
            kart_cli(*pre, "-C", path, "merge", "theirs", "-o", "json")
        digests = (sha256_of(out), sha256_of(mi_path))
        with contextlib.redirect_stdout(io.StringIO()):
            kart_cli(*pre, "-C", path, "merge", "--abort")
        return digests

    if ref is None:
        with knobs(MONOLITHIC):
            ref = merge()
        check(merge("--device", "cpu") == ref, "S3: merge differs card / cpu")
    with knobs({**STREAMED, CHUNK_KNOB: str(chunk)}):
        got, _ = counted("S3", merge, launches, want=0, want_k4=n_chunks)
    check(got == ref, f"S3: the streamed merge wrote {got}, the monolithic one {ref}")
    print(f"[S3] merge theirs -o json streamed in {n_chunks} chunks of {chunk} rows (K4 "
          f"{n_chunks}): stdout sha256 {got[0]} and MERGE_INDEX sha256 {got[1]} equal to the "
          f"monolithic card and --device cpu; {time.perf_counter() - t:.4f} s on {card}")
    return time.perf_counter() - t


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--index-rows", type=int, default=1_000_000)
    # the int CLI repo and the point layer below 10M rows: the hash-keyed
    # phases need the time within the script's limit
    ap.add_argument("--repo-rows", type=int, default=5_000_000)
    ap.add_argument("--spatial-rows", type=int, default=2_000_000)
    # [11i]'s layer of real blobs, cut from [11]'s 2M rows: the index decodes
    # every blob on the host (70 s at 500,000 rows on the card's host), and
    # [11i] with [12b] must stay within 100 s of the script's time limit
    ap.add_argument("--index-repo-rows", type=int, default=400_000)
    ap.add_argument("--merge-rows", type=int, default=2_000_000)
    # the hash-keyed repos below config #2's 10M rows and [14]'s 2M: at 10M and
    # 1M the phases before S1 alone took 1154 s of the 1,200 s on a slow host
    ap.add_argument("--text-rows", type=int, default=5_000_000)
    ap.add_argument("--text-merge-rows", type=int, default=500_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stream-rows", type=int, default=100_000_000)
    ap.add_argument("--crossover-rows", type=int_list,
                    default=[1_000_000, 2_000_000, 10_000_000, 16_000_000, 24_000_000,
                             32_000_000, 48_000_000, 64_000_000, 100_000_000])
    ap.add_argument("--crossover-reps", type=int, default=3)
    ap.add_argument("--chunk-sweep", type=int_list,
                    default=[2_000_000, 4_000_000, 8_000_000, 16_000_000, 32_000_000])
    ap.add_argument("--k4-only", action="store_true",
                    help="run phases 0, 1, 14 and 15 alone and print K4's timings (no result line)")
    ap.add_argument("--hash-only", action="store_true",
                    help="run phases 0, 1 and 18-21 alone and print K1's and K4's timings on "
                         "hash keys (no result line)")
    ap.add_argument("--query-only", action="store_true",
                    help="run phases 0, 1, 11 and Q1-Q3 alone and print K5's and K6's timings "
                         "and the launches (no result line)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="run phases 0, 1, 11 and Q3 alone and print K5's and K6's timings "
                         "(no result line)")
    ap.add_argument("--tiles-only", action="store_true",
                    help="run phases 0, 1, 11 and T1-T3 alone and print K7's timings and the "
                         "launches (no result line)")
    # 6, cut from 10: at 10 the history phases took 113.97 s on an H100 machine (PERF.md
    # §4), over their 100 s budget; the root commit's diffs (no K1) take a fixed ~45 s
    ap.add_argument("--history-commits", type=int, default=6)
    ap.add_argument("--history-only", action="store_true",
                    help="run phases 0, 1, 11 and H0-H3 alone and print the launches (no "
                         "result line)")
    ap.add_argument("--stream-only", action="store_true",
                    help="run phases 0, 1 and S1-S4 alone (S3 on repositories of its own) and "
                         "print the streamed routes' timings and the launches (no result line)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", file=sys.stderr)
        return 1
    dev = runtime.resolve_device(None)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[0] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"volatile ECC errors (corrected, uncorrected): {ecc_line()}")
    cap = torch.cuda.get_device_capability(0)
    check(tuple(cap) == runtime.SUPPORTED_CAPABILITY, f"compute capability {cap}, need (9, 0)")

    if args.k4_only:
        _build.build_all()
        print(json.dumps(merge_phases(args, card, {}, dev)))
        return 0
    if args.query_only or args.kernels_only or args.tiles_only or args.history_only:
        _build.build_all()
        launches = {}
        kernels = spatial_phases(args, card, launches, dev, filters=False,
                                 query="kernels" if args.kernels_only else args.query_only,
                                 tiles=args.tiles_only, history=args.history_only)
        print(json.dumps({**kernels, "launches": launches}))
        return 0
    if args.stream_only:
        _build.build_all()
        launches = {}
        t = time.perf_counter()
        walls = {"S3": stream_cli_alone(args, card, launches)}
        t_s, streamed = stream_phases(args, card, launches, dev)
        walls.update(t_s)
        print("[S] phase walls s: " + ", ".join(f"[{k}] {v:.2f}" for k, v in walls.items())
              + f"; all {time.perf_counter() - t:.2f} on {card}")
        print(json.dumps({**streamed, "launches": launches}))
        return 0
    if args.hash_only:
        _build.build_all()
        launches = {}
        t = time.perf_counter()
        k1 = hash_diff_phases(args, card, launches, dev)
        t_diff = time.perf_counter() - t
        k4 = hash_merge_phases(args, card, launches, dev)
        print(f"[22] phase walls s: [18-20] {t_diff:.2f}, [21] "
              f"{time.perf_counter() - t - t_diff:.2f} on {card}")
        print(json.dumps({"k1_hash_keys": k1, "k4_hash_keys": k4, "launches": launches}))
        return 0

    t_start = t0 = time.perf_counter()
    build_dir, logs = _build.build_all()
    print(f"[1] built {sorted(logs)} in {time.perf_counter() - t0:.2f} s into {build_dir}")
    for k, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {k}: {line.strip()}")

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    (k1, o1, e1), (k2, o2, e2), truth = make_versions(rng, args.rows)
    tmp = tempfile.TemporaryDirectory(prefix="kart_smoke_")
    f_old = save_sidecar_file(os.path.join(tmp.name, "old.kcol"), k1, o1.view(np.uint8), e1)
    f_new = save_sidecar_file(os.path.join(tmp.name, "new.kcol"), k2, o2.view(np.uint8), e2)
    del k1, o1, e1, k2, o2, e2
    old, new = load_block_file(f_old), load_block_file(f_new)
    write_index(rng, tmp.name, args.index_rows)
    want = {"inserts": len(truth["ins"]), "updates": len(truth["upd"]),
            "deletes": len(truth["del"])}
    print(f"[2] data: {old.count} / {new.count} rows, truth {want}, "
          f"{args.index_rows} index rows, {time.perf_counter() - t0:.2f} s")

    # ---- the main path, counted ----
    wall = {}

    def timed(label, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[label] = time.perf_counter() - t
        return out

    runtime.reset_stats()
    res = timed("classify_changed", lambda: classify_changed(old, new))
    count_all = timed("feature_count", lambda: feature_count(old, new))
    count_rect = {
        r: timed(f"feature_count_rect_{i}", lambda r=r: feature_count(old, new, prefilter_rect(r)))
        for i, r in enumerate((RECT_PLAIN, RECT_WRAP))
    }
    bbox_env = np.asarray(new.envelopes[: new.count])
    cache_key = ("chip_smoke", f_new)
    mask1 = timed("bbox_intersects_upload", lambda: bbox_ops.bbox_intersects(
        bbox_env, BBOX_QUERY, cache_key=cache_key))
    uploads_first = runtime.stats_snapshot()["bbox_uploads"]
    mask2 = timed("bbox_intersects_cached", lambda: bbox_ops.bbox_intersects(
        bbox_env, BBOX_QUERY, cache_key=cache_key))
    uploads_second = runtime.stats_snapshot()["bbox_uploads"]
    matched, rejected = timed("envelope_prepass", lambda: envelope_prepass(tmp.name, PREPASS_WSEN))
    launches = runtime.stats_snapshot()
    print(f"[3-5] main path launches {launches}; host wall seconds "
          + ", ".join(f"{k} {v:.4f}" for k, v in wall.items()))
    check(launches["classify_launches"] > 0, "K1 was not launched on the main path")
    check(launches["envelope_scan_launches"] > 0, "K2 was not launched on the main path")
    check(launches["bbox_launches"] > 0, "K3 was not launched on the main path")
    check(uploads_second == uploads_first, "second bbox_intersects re-uploaded its columns")

    # ---- K1 against its plain version and the truth ----
    ok, oo = block_tensors(old, dev)
    nk, no = block_tensors(new, dev)
    p_old, p_new, p_counts = classify_plain(ok, oo, nk, no)
    err_k1 = max(mismatches(res.old_class, p_old), mismatches(res.new_class, p_new))
    check(err_k1 == 0, "K1 classes differ from the plain version")
    check(res.counts == want, f"K1 counts {res.counts} != truth {want}")
    check(p_counts.tolist() == [want["inserts"], want["updates"], want["deletes"]],
          "plain classify counts differ from the truth")
    check(count_all == sum(want.values()), f"feature_count {count_all} != truth")
    check(len(res.old_idx) == want["updates"] + want["deletes"]
          and len(res.new_idx) == want["updates"] + want["inserts"], "changed rows miscounted")
    keys_old, keys_new = np.asarray(old.keys[: old.count]), np.asarray(new.keys[: new.count])
    oc, nc = res.old_class.cpu().numpy(), res.new_class.cpu().numpy()
    check(np.array_equal(keys_old[oc == 3], truth["del"])
          and np.array_equal(keys_old[oc == 2], truth["upd"])
          and np.array_equal(keys_new[nc == 2], truth["upd"])
          and np.array_equal(keys_new[nc == 1], truth["ins"]),
          "changed keys differ from the truth")
    _, _, c_only = classify(ok, oo, nk, no, counts_only=True)
    check(torch.equal(c_only, p_counts), "K1 counts-only differs from the plain version")
    coranks = tile_coranks(ok, nk)
    check(torch.equal(coranks, tile_coranks_plain(ok, nk)),
          "K1 tile co-ranks differ from the plain partition")
    print(f"[3] K1 ok: counts {res.counts}, feature_count {count_all}; "
          f"{len(coranks) - 1} tiles of {TILE_ROWS} merged rows")

    # ---- K2 against its plain version; filtered counts against the truth ----
    env_old = to_device(np.asarray(old.envelopes[: old.count]), dev)
    env_new = to_device(np.asarray(new.envelopes[: new.count]), dev)
    err_k2 = 0
    for rect_raw in (RECT_PLAIN, RECT_WRAP):
        rect = prefilter_rect(rect_raw)
        hits = []
        for env in (env_old, env_new):
            k = envelope_scan(env, rect)
            p = envelope_scan_plain(env, rect)
            err_k2 = max(err_k2, mismatches(k, p))
            hits.append(p.cpu().numpy())
        check(0 < hits[0].sum() < len(hits[0]), f"rect {rect_raw} hits nothing or everything")
        oh = lambda ks: hits[0][np.searchsorted(keys_old, ks)]
        nh = lambda ks: hits[1][np.searchsorted(keys_new, ks)]
        expect = int((oh(truth["upd"]) | nh(truth["upd"])).sum()
                     + oh(truth["del"]).sum() + nh(truth["ins"]).sum())
        check(count_rect[rect_raw] == expect,
              f"filtered count {count_rect[rect_raw]} != {expect} under {rect_raw}")
        print(f"[4] K2 ok under {rect_raw}: feature_count {count_rect[rect_raw]}")
    check(err_k2 == 0, "K2 masks differ from the plain version")

    # ---- K3 against its plain version ----
    w, s, e, n, cnt = bbox_ops._resident_columns(cache_key, bbox_env, dev)
    p3 = bbox_ops.bbox_cyclic_plain(w, s, e, n, BBOX_QUERY)[:cnt]
    err_k3 = max(mismatches(mask1, p3), mismatches(mask2, p3))
    check(0 < int(p3.sum()) < cnt, "bbox query hits nothing or everything")
    with EnvelopeIndexReader(os.path.join(tmp.name, DB_NAME)) as reader:
        oids, wsen = reader.all_envelopes()
    pc = [torch.from_numpy(c).to(dev) for c in bbox_ops.pad_envelopes(wsen)[:4]]
    q = [float(v) for v in PREPASS_WSEN.split(",")]
    q = (q[0] - PREPASS_PAD, q[1] - PREPASS_PAD, q[2] + PREPASS_PAD, q[3] + PREPASS_PAD)
    ph = bbox_ops.bbox_cyclic_plain(*pc, q)[: len(oids)].cpu().numpy()
    check(matched == {o for o, h in zip(oids, ph) if h}
          and rejected == {o for o, h in zip(oids, ph) if not h},
          "envelope_prepass sets differ from the plain version")
    check(len(matched) > 0 and len(rejected) > 0, "prepass matched nothing or everything")
    check(err_k3 == 0, "K3 masks differ from the plain version")
    print(f"[5] K3 ok: {int(p3.sum())} of {cnt} hit; prepass {len(matched)} matched, "
          f"{len(rejected)} rejected")

    # ---- 6. timings ----
    n_old, n_new = old.count, new.count
    rows = n_old + n_new
    search_steps = n_old * np.log2(max(n_new, 2)) + n_new * np.log2(max(n_old, 2))
    k1_bound = bound(rows * 28 + rows, search_steps + rows * 5)
    k1c_bound = bound(rows * 28 + 24, search_steps + rows * 5)
    kernels = []
    k1_names = ("corank_kernel", "classify_tiles")
    k1_split = device_ms(lambda: classify(ok, oo, nk, no), k1_names)
    k1 = {
        "name": "classify", "route": "cuda", "source": "kart_tpu_torch/csrc/classify.cu",
        "replaces": "kart_tpu/ops/diff_kernel.py:55",
        "launches": launches["classify_launches"], "max_abs_err": err_k1,
        "ms": time_ms(lambda: classify(ok, oo, nk, no)),
        "device_ms": total_ms(k1_split),
        "plain_ms": time_ms(lambda: classify_plain(ok, oo, nk, no), batches=3, per_batch=3),
        "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
        "library_ms": time_ms(lambda: torch.searchsorted(nk, ok)),
        "library_call": "torch.searchsorted(new_keys, old_keys): the join's lookup only",
        "tile_rows": TILE_ROWS,
        "checked": True,
    }
    k1_counts_ms = time_ms(lambda: classify(ok, oo, nk, no, counts_only=True))
    k1_counts_dev = total_ms(device_ms(lambda: classify(ok, oo, nk, no, counts_only=True), k1_names))
    kernels.append(k1)
    rect = prefilter_rect(RECT_PLAIN)
    rect_w = prefilter_rect(RECT_WRAP)
    k2_bound = bound(n_old * 17, n_old * 12)
    kernels.append({
        "name": "envelope_scan", "route": "cuda",
        "source": "kart_tpu_torch/csrc/envelope_scan.cu",
        "replaces": "kart_tpu/diff/backend.py:322",
        "launches": launches["envelope_scan_launches"], "max_abs_err": err_k2,
        "ms": time_ms(lambda: envelope_scan(env_old, rect)),
        "device_ms": total_ms(device_ms(lambda: envelope_scan(env_old, rect),
                                        ("envelope_scan_kernel",))),
        "plain_ms": time_ms(lambda: envelope_scan_plain(env_old, rect), batches=3, per_batch=3),
        "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": None,
        "checked": True,
    })
    k2_wrap_ms = time_ms(lambda: envelope_scan(env_old, rect_w))
    k2_wrap_dev = total_ms(device_ms(lambda: envelope_scan(env_old, rect_w),
                                     ("envelope_scan_kernel",)))
    k3_bound = bound(cnt * 16 + w.numel(), cnt * 16)
    kernels.append({
        "name": "bbox_cyclic", "route": "cuda", "source": "kart_tpu_torch/csrc/bbox.cu",
        "replaces": "kart_tpu/ops/bbox.py:126",
        "launches": launches["bbox_launches"], "max_abs_err": err_k3,
        "ms": time_ms(lambda: bbox_ops.bbox_cyclic(w, s, e, n, BBOX_QUERY, cnt)),
        "device_ms": total_ms(device_ms(lambda: bbox_ops.bbox_cyclic(w, s, e, n, BBOX_QUERY, cnt),
                                        ("bbox_kernel",))),
        "plain_ms": time_ms(lambda: bbox_ops.bbox_cyclic_plain(w, s, e, n, BBOX_QUERY),
                            batches=3, per_batch=3),
        "bound_ms": k3_bound[0], "bound_by": k3_bound[1], "library_ms": None,
        "checked": True,
    })
    for k in kernels:
        print(f"[6] {k['name']}: {k['ms']:.4f} ms, device {fmt_ms(k['device_ms'])} "
              f"(plain {k['plain_ms']:.4f} ms, "
              f"bound {k['bound_ms']:.4f} ms by {k['bound_by']}, launches {k['launches']}"
              + (f", {k['library_call']} {k['library_ms']:.4f} ms" if k["library_ms"] is not None else "")
              + f") on {card}")
    print(f"[6] classify counts-only: {k1_counts_ms:.4f} ms, device {fmt_ms(k1_counts_dev)} "
          f"(bound {k1c_bound[0]:.4f} ms by {k1c_bound[1]}) on {card}")
    print("[6] classify device split: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in k1_split.items()) + f" on {card}")
    print(f"[6] envelope_scan, wrapping rect: {k2_wrap_ms:.4f} ms, device "
          f"{fmt_ms(k2_wrap_dev)} on {card}")
    tmp.cleanup()

    # every card command of phases 8-21 is counted, its cProfile runs too
    cli_launches = {"3-5": [k1["launches"], kernels[1]["launches"], 0, 0, 0, 0,
                            kernels[2]["launches"]]}
    walls, s_walls = {"1-6": time.perf_counter() - t_start}, {}
    t = time.perf_counter()
    k1["estimation"] = cli_phases(args, card, cli_launches, s_walls)
    walls["7-10b"] = time.perf_counter() - t - s_walls["S3"]
    t = time.perf_counter()
    spatial = spatial_phases(args, card, cli_launches, dev)
    k5, k6, k7 = spatial["k5"], spatial["k6"], spatial["k7"]
    walls["11-13, Q1-Q3, T1-T3"] = time.perf_counter() - t - sum(spatial["walls"].values())
    walls.update(spatial["walls"])
    kernels[2]["index_envelopes"], walls["11i"] = index_phases(args, card, cli_launches, dev)
    t = time.perf_counter()
    s3_diff = s_walls["S3"]
    k4 = merge_phases(args, card, cli_launches, dev, s_walls)
    walls["14-17"] = time.perf_counter() - t - (s_walls["S3"] - s3_diff)
    t = time.perf_counter()
    k1["hash_keys"] = hash_diff_phases(args, card, cli_launches, dev)
    walls["18-20"] = time.perf_counter() - t
    t = time.perf_counter()
    k4["hash_keys"] = hash_merge_phases(args, card, cli_launches, dev)
    walls["21"] = time.perf_counter() - t
    t_s, streamed = stream_phases(args, card, cli_launches, dev)
    s_walls.update(t_s)
    k1["streamed"], k4_streamed = streamed["k1_streamed"], streamed["k4_streamed"]
    k1["columnar_equal_ms"] = streamed["columnar_equal_ms"]
    print("[S] phase walls s: " + ", ".join(f"[{k}] {v:.2f}" for k, v in s_walls.items())
          + f"; all {sum(s_walls.values()):.2f} on {card}")
    print("[22] phase walls s: " + ", ".join(f"[{k}] {v:.2f}" for k, v in
                                             {**s_walls, **walls}.items())
          + f"; all since the build {time.perf_counter() - t_start:.2f} on {card}")
    kernels.append({
        "name": "merge_classify", "route": "cuda",
        "source": "kart_tpu_torch/csrc/merge_classify.cu",
        "replaces": "kart_tpu/ops/merge_kernel.py:43", **k4, "streamed": k4_streamed,
        "library_call": "torch.searchsorted(ancestor_keys, union): one side's lookup only "
                        "(partial)",
        "unique_call": "torch.unique(concatenated keys): the union step only (partial)",
        "checked": True,
    })
    kernels += [k5, k6, k7]
    for k, i in ((k1, 0), (kernels[1], 1), (kernels[3], 2), (k5, 3), (k6, 4), (k7, 5),
                 (kernels[2], 6)):
        k["launches_by_phase"] = {p: n[i] for p, n in cli_launches.items() if n[i]}
        k["launches"] = sum(k["launches_by_phase"].values())

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


def int_list(text):
    return [int(x) for x in text.split(",") if x]


def stream_cli_alone(args, card, launches):
    """[S3] on repositories of its own (``--stream-only``): [7]'s at
    ``--repo-rows`` and [14]'s at ``--merge-rows``, each command's
    monolithic card and ``--device cpu`` runs made here. -> host wall s."""
    os.environ.update(GIT_AUTHOR_DATE=MERGE_DATE, GIT_COMMITTER_DATE=MERGE_DATE)
    with tempfile.TemporaryDirectory(prefix="kart_smoke_s3_") as tmp:
        repo, info = synth_repo(os.path.join(tmp, "repo"), args.repo_rows, edit_frac=0.01,
                                seed=args.seed, blobs="changed")
        wall = stream_cli_diff(repo, repo.workdir, tmp, card, launches, info["n_edits"], None)
        repo, blocks, _ = build_merge_repo(os.path.join(tmp, "merge"), args.merge_rows, args.seed)
        trio = [blocks["ancestor"], blocks["ours"], blocks["theirs"]]
        return wall + stream_cli_merge(repo.workdir, tmp, card, launches, trio, None)


def running(pid):
    """-> (state, parent pid) of a process that has not exited, else None."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            stat = f.read()
    except OSError:
        return None
    state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
    return None if state in "ZX" else (state, int(ppid))


def descendants():
    """The pids of this process's descendants that have not exited, parents
    before their children."""
    parent = {}
    for d in os.listdir("/proc"):
        if d.isdigit() and (st := running(d)) is not None:
            parent[int(d)] = st[1]
    found, frontier = [], [os.getpid()]
    while frontier:
        kids = [p for p, pp in parent.items() if pp in frontier]
        found += kids
        frontier = kids
    return found


def stop_descendants(grace_s=2.0):
    """Stop and reap whatever this script started that still runs, so that
    it leaves no process behind; each one is named on stderr."""
    left = descendants()
    for pid in left:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            cmd = "?"
        print(f"[exit] stopping leftover process {pid}: {cmd}", file=sys.stderr)
    for sig in (15, 9):
        for pid in left:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        deadline = time.monotonic() + grace_s
        while left and time.monotonic() < deadline:
            for pid in list(left):
                with contextlib.suppress(ChildProcessError):
                    os.waitpid(pid, os.WNOHANG)
                if running(pid) is None:
                    left.remove(pid)
            time.sleep(0.05)
        if not left:
            return


if __name__ == "__main__":
    try:
        rc = main()
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        rc = 1
    finally:
        stop_descendants()
    sys.exit(rc)
