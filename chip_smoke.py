#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and hold every
kernel against its plain PyTorch version.

    python3 chip_smoke.py [--rows 10000000] [--index-rows 1000000]
                          [--repo-rows 10000000] [--seed 0]

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
   after warm-up) and the kernels' own device time (torch.profiler)
7. build a repository with the port's ``synth.synth_repo``: ``--repo-rows``
   int-pk features, real blobs for the 1% edited rows only, from ``--seed``
8-10. ``kart diff`` through the port's CLI entry point (``kart_tpu_torch.cli
   .main``, what ``python -m kart_tpu_torch`` calls), each phase with the
   launch counters zeroed before and read after and K1 launched exactly
   once (one dataset): ``-o feature-count`` on the card (counts-only K1);
   ``-o json-lines`` on the card and again with ``--device cpu``
   (byte-identical files), then each once more under cProfile; ``-o json``
   on the card and with ``--device cpu`` (byte-identical files)
11. build a spatial repository with ``synth.synth_repo(spatial=True)``:
   ``--repo-rows`` point features whose sidecars carry envelope and
   vertex columns, real blobs for the 1% edited rows only
12. write a rectangular spatial filter into its config, then run ``-o
   feature-count`` and ``-o json-lines`` on the card and with ``--device
   cpu``: equal counts and sha256, and on the card exactly two K2 launches
   (one a side) and one K1 launch a command, counts-only for
   feature-count, with the rows the prefilter kept read from the same
   run's counters; then the json-lines run on the card under cProfile
13. the same under a polygon filter with a hole (``-o json`` and ``quiet
   --exit-code``: equal sha256 and exit codes), and under a rect around one
   unedited feature (``quiet --exit-code`` exits 0, json-lines has no
   feature line)
14. the ``kernels`` JSON line (each kernel's ``launches`` is the sum of
   ``launches_by_phase``: every launch of the main path's runs, the
   cProfile runs included, and none of the comparisons with the plain
   versions), the card line, and the result line

Any failed check exits non-zero without the result line.
"""

import argparse
import cProfile
import hashlib
import io
import json
import os
import pstats
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
from kart_tpu_torch.diff.backend import envelope_scan, envelope_scan_plain
from kart_tpu_torch.diff.engine import (
    classify_changed,
    feature_count,
    prefilter_rect,
)
from kart_tpu_torch.diff.sidecar import load_block, load_block_file, save_sidecar_file
from kart_tpu_torch.ops import _build
from kart_tpu_torch.ops import bbox as bbox_ops
from kart_tpu_torch.ops.blocks import block_tensors, to_device
from kart_tpu_torch.ops.diff_kernel import (
    TILE_ROWS,
    classify,
    classify_plain,
    tile_coranks,
    tile_coranks_plain,
)
from kart_tpu_torch.ops.envelope_codec import EnvelopeCodec
from kart_tpu_torch.spatial_filter import (
    PREPASS_PAD,
    ResolvedSpatialFilterSpec,
    envelope_prepass,
)
from kart_tpu_torch.spatial_filter.index import DB_NAME, EnvelopeIndexReader
from kart_tpu_torch.synth import synth_repo

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
#: non-tensor-core f32 rate, used for every bound below
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

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


class SmokeFailure(RuntimeError):
    pass


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


def make_versions(rng, n):
    """Base and edited (keys, oids, envelopes), plus the changed keys."""
    pks = np.cumsum(rng.integers(1, 4, n)).astype(np.int64) + 1000
    oids = rng.integers(0, 2**32, size=(n, 5), dtype=np.uint32)
    env = make_envelopes(rng, n, n_nan=7)
    n_upd, n_del, n_ins = n // 100, n // 1000, n // 1000
    rows = rng.permutation(n)
    upd = np.sort(rows[:n_upd])
    dele = np.sort(rows[n_upd : n_upd + n_del])
    oids2 = oids.copy()
    oids2[upd, np.arange(n_upd) % 5] ^= rng.integers(1, 2**32, n_upd, dtype=np.uint32)
    env2 = env.copy()
    moved = upd[: n_upd // 2]
    env2[moved] = make_envelopes(rng, len(moved))
    keep = np.ones(n, dtype=bool)
    keep[dele] = False
    free = np.flatnonzero(np.diff(pks) > 1)
    inter = pks[rng.choice(free, n_ins // 2, replace=False)] + 1
    beyond = pks[-1] + 1 + 7 * np.arange(n_ins - n_ins // 2, dtype=np.int64)
    ins = np.concatenate([inter, beyond])
    keys2 = np.concatenate([pks[keep], ins])
    oids2 = np.concatenate([oids2[keep], rng.integers(0, 2**32, size=(n_ins, 5), dtype=np.uint32)])
    env2 = np.concatenate([env2[keep], make_envelopes(rng, n_ins)])
    truth = {"upd": pks[upd], "del": pks[dele], "ins": np.sort(ins)}
    return (pks, oids, env), (keys2, oids2, env2), truth


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
    """Device time per call of each CUDA kernel whose name contains one of
    ``kernels``, from a torch.profiler window of ``calls`` calls after
    warm-up. -> {name fragment: ms} for the kernels the profiler saw."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        for k in kernels:
            if k in e.key:
                t = getattr(e, "device_time_total", None)
                us = e.cuda_time_total if t is None else t
                per[k] = per.get(k, 0.0) + us / calls / 1e3
    return per


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


def counted(label, fn, launches, want=1, want_k2=0):
    """Run ``fn`` with the launch counters zeroed before and read after;
    fail unless K1 launched exactly ``want`` times (once for each dataset
    the columnar route classifies) and K2 ``want_k2`` times, and add the
    launches read to ``launches[label]`` ([K1, K2]). -> (fn's result, the
    counters read)."""
    runtime.reset_stats()
    out = fn()
    stats = runtime.stats_snapshot()
    n = stats["classify_launches"]
    check(n == want, f"K1 launched {n} times in phase {label}, expected {want}")
    k2 = stats["envelope_scan_launches"]
    check(k2 == want_k2, f"K2 launched {k2} times in phase {label}, expected {want_k2}")
    total = launches.setdefault(label, [0, 0])
    total[0] += n
    total[1] += k2
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


def cli_phases(args, card, launches):
    """Phases 7-10: build the repository, then drive ``kart diff`` through
    the CLI, adding every card command's launches to ``launches``."""
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


def set_filter(repo, spec_text):
    repo.config.set_many(ResolvedSpatialFilterSpec.from_spec_string(spec_text).config_items())


def card_and_cpu(label, argv, out_path, launches, rc_want=0, counts_only=False):
    """One filtered command on the card, counted: exactly one K1 launch (the
    one dataset; counts-only for ``counts_only``) and two K2 launches (one a
    side), added to ``launches``; then with ``--device cpu``. Fail unless
    both exit ``rc_want`` and write the same bytes to ``out_path`` (when
    given). -> (card wall s, cpu wall s, sha256 or None, (old, new) rows
    the card's prefilter kept)."""
    walls, outs = [], []
    for where in ("card", "cpu"):
        path = None if out_path is None else f"{out_path}.{where}"
        cmd = [*argv, *([] if path is None else ["--output", path])]
        if where == "cpu":
            walls.append(kart_cli("--device", "cpu", *cmd, rc_want=rc_want))
        else:
            wall, stats = counted(label, lambda: kart_cli(*cmd, rc_want=rc_want), launches,
                                  want=1, want_k2=2)
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


def spatial_phases(args, card, launches):
    """Phases 11-13: build the spatial repository, then drive spatially
    filtered ``kart diff`` commands through the CLI on the card and with
    ``--device cpu``, adding every card command's launches to
    ``launches``."""
    with tempfile.TemporaryDirectory(prefix="kart_smoke_spatial_") as tmp:
        t = time.perf_counter()
        repo, info = synth_repo(os.path.join(tmp, "repo"), args.repo_rows, edit_frac=0.01,
                                seed=args.seed, blobs="changed", spatial=True)
        build_s = time.perf_counter() - t
        packs = repo.odb.packs.packs
        n_objects = sum(p.count for p in packs)
        pack_bytes = sum(os.path.getsize(p.pack_path) for p in packs)
        sidecar_bytes = sum(os.path.getsize(os.path.join(repo.gitdir, "columnar", f))
                            for f in os.listdir(os.path.join(repo.gitdir, "columnar")))
        n_edits, path = info["n_edits"], repo.workdir
        print(f"[11] spatial repo: {args.repo_rows} point features, {n_edits} edited, "
              f"built in {build_s:.2f} s host wall; {n_objects} objects in {len(packs)} "
              f"packs, {pack_bytes} pack bytes, {sidecar_bytes} sidecar bytes on {card}")

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


# --- main -------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--index-rows", type=int, default=1_000_000)
    ap.add_argument("--repo-rows", type=int, default=10_000_000)
    ap.add_argument("--seed", type=int, default=0)
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

    t0 = time.perf_counter()
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

    # every card command of phases 8-13 is counted, its cProfile runs too
    cli_launches = {"3-5": [k1["launches"], kernels[1]["launches"]]}
    cli_phases(args, card, cli_launches)
    spatial_phases(args, card, cli_launches)
    for k, i in ((k1, 0), (kernels[1], 1)):
        k["launches_by_phase"] = {p: n[i] for p, n in cli_launches.items() if n[i]}
        k["launches"] = sum(k["launches_by_phase"].values())

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
