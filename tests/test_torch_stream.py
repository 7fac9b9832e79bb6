"""The streamed routes of the classify (B1s) and the merge (B6s) against
kart_tpu's: ``stream_chunk_splits`` gives kart_tpu's split points on the
same keys; ``classify_blocks_streamed`` and ``merge_classify_streamed`` on
the CPU (their chunks through the plain versions) at chunk sizes 1, 7 and
1000 give kart_tpu's streamed routes' results on XLA-CPU and the port's
monolithic routes'; the knobs are the port's own, read at call time, a
malformed value ignored; and ``diff -o feature-count``, ``-o json-lines``
and a merge through the CLI, with the knobs lowered so that the streamed
route runs several chunks, print kart_tpu's bytes."""

import contextlib
import io
import logging
import os
import shutil

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import kart_tpu_torch
from kart_tpu.cli import cli as kart_cli
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.ops.blocks import FeatureBlock as RefBlock
from kart_tpu.ops.diff_kernel import classify_blocks_streamed as ref_classify_streamed
from kart_tpu.ops.diff_kernel import stream_chunk_splits as ref_splits
from kart_tpu.ops.merge_kernel import merge_classify_streamed as ref_merge_streamed
from kart_tpu.synth import commit_feature_edits, synth_repo
from kart_tpu_torch.cli import main as port_main
from kart_tpu_torch.diff import backend
from kart_tpu_torch.ops import blocks as tblocks
from kart_tpu_torch.ops import diff_kernel as tdk
from kart_tpu_torch.ops import merge_kernel as tmk
from kart_tpu_torch.ops.blocks import FeatureBlock

CPU = torch.device("cpu")
I64 = np.iinfo(np.int64)
KNOBS = ("KART_TORCH_STREAM_MIN_ROWS", "KART_TORCH_STREAM_CHUNK_ROWS")


def _oids(rng, n, values=2**32):
    return rng.integers(0, values, size=(n, 5), dtype=np.uint64).astype(np.uint32)


def _side(rng, base, keep=0.9, fresh=40, values=4):
    """A version of ``base`` keys: a share of the rows kept, fresh keys
    added, oids from few values (so sides agree on many rows)."""
    keys = base[rng.random(len(base)) < keep]
    new = rng.integers(base.min() if len(base) else 0, (base.max() if len(base) else 0) + 500,
                       size=fresh, dtype=np.int64)
    keys = np.unique(np.concatenate([keys, new]))
    return keys, _oids(rng, len(keys), values)


def _keys(name):
    rng = np.random.default_rng(len(name))
    base = np.unique(rng.integers(-(2**40), 2**40, size=400))
    if name == "mixed":
        return [_side(rng, base)[0], _side(rng, base)[0]]
    if name == "skewed":  # a renumbered revision: every new key past the old range
        return [base, base.max() + 1 + np.arange(300, dtype=np.int64)]
    if name == "one_empty":
        return [base, base[:0]]
    if name == "three_sides":
        return [base, _side(rng, base)[0], _side(rng, base)[0]]
    if name == "extremes":
        return [np.array([I64.min, -(2**62), 0, 2**62, I64.max]),
                np.array([I64.min, 1, 2**62 + 1, I64.max])]
    raise KeyError(name)


@pytest.mark.parametrize("chunk", [1, 7, 100, 1000])
@pytest.mark.parametrize("name", ["mixed", "skewed", "one_empty", "three_sides", "extremes"])
def test_stream_chunk_splits_match_kart_tpu(name, chunk):
    keys = _keys(name)
    got, n = tdk.stream_chunk_splits(keys, chunk)
    want, n_want = ref_splits(keys, chunk)
    assert n == n_want
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _pair(seed):
    rng = np.random.default_rng(seed)
    base = np.unique(rng.integers(0, 3000, size=500))
    return [_side(rng, base), _side(rng, base, keep=0.8, fresh=90)]


def _blocks(sides):
    port = [FeatureBlock.from_arrays(k, o, pad=False) for k, o in sides]
    ref = [RefBlock.from_arrays(k, o, [str(x) for x in k]) for k, o in sides]
    return port, ref


@pytest.mark.parametrize("chunk", [1, 7, 1000])
@pytest.mark.parametrize("seed", [0, 1])
def test_classify_streamed_matches_kart_tpu(seed, chunk):
    (old, new), (r_old, r_new) = _blocks(_pair(seed))
    want_old, want_new, want_counts = ref_classify_streamed(r_old, r_new, chunk_rows=chunk)
    got_old, got_new, got_counts = tdk.classify_blocks_streamed(old, new, CPU, chunk_rows=chunk)
    np.testing.assert_array_equal(got_old.numpy(), want_old)
    np.testing.assert_array_equal(got_new.numpy(), want_new)
    assert tdk.counts_dict(got_counts) == want_counts
    mono = tdk.classify_blocks(old, new, CPU)
    for g, m in zip((got_old, got_new, got_counts), mono):
        assert torch.equal(g, m)
    none_old, none_new, only = tdk.classify_blocks_streamed(old, new, CPU, chunk_rows=chunk,
                                                            counts_only=True)
    assert none_old is None and none_new is None and torch.equal(only, got_counts)


@pytest.mark.parametrize("chunk", [1, 7, 1000])
def test_classify_streamed_one_side_empty(chunk):
    keys = np.arange(-5, 60, dtype=np.int64)
    full = FeatureBlock.from_arrays(keys, np.ones((len(keys), 5), np.uint32), pad=False)
    empty = FeatureBlock.from_arrays(np.zeros(0, np.int64), np.zeros((0, 5), np.uint32),
                                     pad=False)
    _, new_class, counts = tdk.classify_blocks_streamed(empty, full, CPU, chunk_rows=chunk)
    assert counts.tolist() == [len(keys), 0, 0] and (new_class == tdk.INSERT).all()
    old_class, _, counts = tdk.classify_blocks_streamed(full, empty, CPU, chunk_rows=chunk)
    assert counts.tolist() == [0, 0, len(keys)] and (old_class == tdk.DELETE).all()


def _triple(seed):
    rng = np.random.default_rng(100 + seed)
    base = np.unique(rng.integers(0, 3000, size=500))
    return [(base, _oids(rng, len(base), 3)), _side(rng, base, values=3),
            _side(rng, base, keep=0.7, fresh=80, values=3)]


@pytest.mark.parametrize("chunk", [1, 7, 1000])
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_streamed_matches_kart_tpu(seed, chunk):
    port, ref = _blocks(_triple(seed))
    want = ref_merge_streamed(*ref, chunk_rows=chunk)
    got = tmk.merge_classify_streamed(*port, CPU, chunk_rows=chunk)
    mono = tmk.merge_classify(*port, "cpu")
    for g, w, m in zip(got[:3], want[:3], mono[:3]):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, m)
        assert g.dtype == m.dtype
    assert got[3] == want[3] == mono[3]
    assert got[3]["conflicts"] > 0 and got[3]["take_theirs"] > 0


def test_merge_streamed_empty_sides():
    port, ref = _blocks([(np.zeros(0, np.int64), np.zeros((0, 5), np.uint32))] * 2
                        + [(np.arange(9, dtype=np.int64), np.ones((9, 5), np.uint32))])
    got = tmk.merge_classify_streamed(*port, CPU, chunk_rows=2)
    want = ref_merge_streamed(*ref, chunk_rows=2)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3] == {"conflicts": 0, "take_theirs": 9}


# --- the knobs ------------------------------------------------------------------------------

def test_knobs_are_read_at_call_time(monkeypatch, caplog):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    assert tblocks.stream_min_rows() == tblocks.DEFAULT_STREAM_MIN_ROWS
    assert tblocks.stream_chunk_rows() == tblocks.DEFAULT_STREAM_CHUNK_ROWS
    monkeypatch.setenv("KART_TORCH_STREAM_MIN_ROWS", "123")
    monkeypatch.setenv("KART_TORCH_STREAM_CHUNK_ROWS", "45")
    assert (tblocks.stream_min_rows(), tblocks.stream_chunk_rows()) == (123, 45)
    monkeypatch.setenv("KART_TORCH_STREAM_CHUNK_ROWS", "0")
    assert tblocks.stream_chunk_rows() == 1
    with caplog.at_level(logging.WARNING, logger="kart_tpu_torch.ops"):
        monkeypatch.setenv("KART_TORCH_STREAM_MIN_ROWS", "lots")
        monkeypatch.setenv("KART_TORCH_STREAM_CHUNK_ROWS", "8M")
        assert tblocks.stream_min_rows() == tblocks.DEFAULT_STREAM_MIN_ROWS
        assert tblocks.stream_chunk_rows() == tblocks.DEFAULT_STREAM_CHUNK_ROWS
    assert "KART_TORCH_STREAM_MIN_ROWS='lots'" in caplog.text
    assert "KART_TORCH_STREAM_CHUNK_ROWS='8M'" in caplog.text


def test_streams_only_on_the_card_by_rows_or_memory(monkeypatch):
    card = torch.device("cuda", 0)
    free = {"bytes": 10**12}
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free["bytes"], 8 * 10**10))
    monkeypatch.setenv("KART_TORCH_STREAM_MIN_ROWS", "1000")
    assert not tblocks.streams(CPU, (10**9, 10**9))
    assert not tblocks.streams(card, (0, 0))
    assert not tblocks.streams(card, (999, 10))
    assert tblocks.streams(card, (10, 1000))
    free["bytes"] = 2 * 28 * 1009 - 2  # the sides fill more than half the free memory
    assert tblocks.streams(card, (999, 10))
    assert not tblocks.streams(card, (500, 9))


def test_the_card_takes_the_streamed_routes(monkeypatch):
    """On a CUDA device both entry points run their card driver (stand-ins
    here): past the row knob in chunks of the chunk knob, below it in one
    chunk of the larger side's rows; the CPU never reaches the driver."""
    card = torch.device("cuda", 0)
    calls = []
    (old, new), _ = _blocks(_pair(3))
    want = tdk.classify_blocks_streamed(old, new, CPU)[2].tolist()
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (10**12, 10**12))
    monkeypatch.setattr(tdk, "classify_blocks_streamed",
                        lambda *a, **k: calls.append(("diff", k)) or "streamed")
    monkeypatch.setattr(tmk, "merge_classify_streamed",
                        lambda *a, **k: calls.append(("merge", a[3], k)) or "streamed")
    monkeypatch.setattr(tmk.runtime, "resolve_device", lambda device=None: card)
    most = max(old.count, new.count)
    monkeypatch.setenv("KART_TORCH_STREAM_MIN_ROWS", str(most))
    assert tdk.classify_blocks(old, new, card, counts_only=True) == "streamed"
    assert tmk.merge_classify(old, new, new, None) == "streamed"
    assert calls == [("diff", {"counts_only": True, "timings": None}),
                     ("merge", card, {"timings": None})]
    calls.clear()
    monkeypatch.setenv("KART_TORCH_STREAM_MIN_ROWS", str(most + 1))
    timings = {}
    assert tdk.classify_blocks(old, new, card, timings=timings) == "streamed"
    assert tmk.merge_classify(old, new, new, None) == "streamed"
    assert calls == [("diff", {"chunk_rows": most, "counts_only": False, "timings": timings}),
                     ("merge", card, {"chunk_rows": most, "timings": None})]
    calls.clear()
    got = tdk.classify_blocks(old, new, CPU)
    assert calls == [] and got[2].tolist() == want


def test_port_reads_only_its_own_knobs():
    """kart_tpu reads its stream and device knobs once, at import: the port
    neither reads nor sets them."""
    names = ("KART_STREAM_MIN_ROWS", "KART_STREAM_CHUNK_ROWS", "KART_DEVICE_MIN_ROWS",
             "KART_DIFF_DEVICE")
    pkg = os.path.dirname(kart_tpu_torch.__file__)
    root = os.path.dirname(pkg)
    files = [os.path.join(root, "chip_smoke.py")] + [
        os.path.join(d, n) for d, _, ns in os.walk(pkg) for n in ns if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            text = f.read()
        assert not [n for n in names if n in text], path


# --- the CLI through the streamed route -----------------------------------------------------

N = 3000


def _run_port(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture
def streamed_cpu(monkeypatch):
    """The CPU taken for the card: the CPU backend runs the card's route
    (``classify_blocks``), :func:`streams` is asked about the CPU as it would
    be about the card, and every chunk's plain classify is counted."""
    chunks = {"diff": 0, "merge": 0}
    plain, plain_merge = tdk.classify_plain, tmk.merge_classify_sides_plain

    def counted(name, fn):
        def run(*a):
            chunks[name] += 1
            return fn(*a)
        return run

    monkeypatch.setitem(backend.BACKENDS, "cpu_torch", backend.DeviceTorchBackend)
    monkeypatch.setattr(tdk, "streams", lambda device, rows: max(rows) >= tblocks.stream_min_rows())
    monkeypatch.setattr(tmk, "streams", tdk.streams)
    monkeypatch.setattr(tdk, "classify_plain", counted("diff", plain))
    monkeypatch.setattr(tmk, "merge_classify_sides_plain", counted("merge", plain_merge))
    monkeypatch.setenv("KART_TORCH_STREAM_MIN_ROWS", "1")
    monkeypatch.setenv("KART_TORCH_STREAM_CHUNK_ROWS", str(N // 5))
    return chunks


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("stream") / "synth")
    synth_repo(path, N, edit_frac=0.05, seed=11, blobs="changed")
    return path


@pytest.mark.parametrize("argv", [
    ["diff", "-o", "feature-count", "HEAD^...HEAD"],
    ["diff", "-o", "json-lines", "HEAD^...HEAD"],
    ["diff", "-o", "json", "HEAD^...HEAD"],
], ids=["feature-count", "json-lines", "json"])
def test_diff_cli_streamed_matches_kart_tpu(synth, streamed_cpu, argv):
    ref = CliRunner().invoke(kart_cli, ["-C", synth, *argv])
    got = _run_port(["--device", "cpu", "-C", synth, *argv])
    assert got == (ref.exit_code, ref.stdout, "")
    assert streamed_cpu["diff"] >= 4


@pytest.fixture(scope="module")
def merge_repo(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("stream_merge") / "repo")
    dates = {k: os.environ.get(k) for k in ("GIT_AUTHOR_DATE", "GIT_COMMITTER_DATE")}
    with pytest.MonkeyPatch.context() as mp:
        for k in dates:
            mp.setenv(k, "1700000000 +0000")
        repo, _ = synth_repo(path, N, edit_frac=0.1, seed=12, blobs="real")
        base = repo.odb.read_commit(repo.head_commit_oid).parents[0]
        repo.refs.set("refs/heads/theirs", base)
        pk0 = 1 << 24
        commit_feature_edits(
            repo, "synth",
            updates=[{"fid": pk0 + r, "rating": -1.0 - r} for r in range(0, N, 7)],
            deletes=[pk0 + r for r in range(3, N, 49)],
            inserts=[{"fid": pk0 + N + r, "rating": 1.0} for r in range(20)],
            message="theirs edits", ref="refs/heads/theirs")
    return path


def test_merge_cli_streamed_matches_kart_tpu(merge_repo, streamed_cpu, tmp_path, monkeypatch):
    for k in ("GIT_AUTHOR_DATE", "GIT_COMMITTER_DATE"):
        monkeypatch.setenv(k, "1700000000 +0000")
    kpath, ppath = str(tmp_path / "k"), str(tmp_path / "p")
    shutil.copytree(merge_repo, kpath)
    shutil.copytree(merge_repo, ppath)
    for argv in (["merge", "theirs", "--dry-run", "-o", "json"], ["merge", "theirs", "-o", "json"],
                 ["conflicts", "-ss", "-o", "json"]):
        ref = CliRunner().invoke(kart_cli, ["-C", kpath, *argv])
        rc, out, _ = _run_port(["--device", "cpu", "-C", ppath, *argv])
        assert (rc, out) == (ref.exit_code, ref.stdout), argv
    assert '"kart.conflicts/v1"' in out
    with open(os.path.join(ppath, ".kart", "MERGE_INDEX"), "rb") as f, \
            open(os.path.join(kpath, ".kart", "MERGE_INDEX"), "rb") as g:
        assert f.read() == g.read()
    assert streamed_cpu["merge"] >= 2 * 4
    assert JRepo(ppath).refs.get("refs/heads/main") == JRepo(kpath).refs.get("refs/heads/main")


# --- the staging copy ------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [0, 1000, 1_000_003])
def test_stage_rows_copies_unaligned_views_exactly(rows):
    """A sidecar column is an unaligned view of an mmap: staging copies it
    as bytes, on the kept thread pool when it is large, exactly."""
    rng = np.random.default_rng(rows)
    raw = np.zeros(rows * 20 + 3, dtype=np.uint8)
    raw[3:] = rng.integers(0, 256, rows * 20, dtype=np.uint8)
    src = raw[3:].view(np.uint32).reshape(rows, 5) if rows else np.zeros((0, 5), np.uint32)
    assert rows == 0 or not src.flags.aligned
    dst = np.empty((rows, 5), dtype=np.uint32)
    tblocks.stage_rows(dst, src)
    np.testing.assert_array_equal(dst, src)
    keys = np.arange(rows, dtype=np.int64)[::-1]  # not contiguous: an element copy
    out = np.empty(rows, dtype=np.int64)
    tblocks.stage_rows(out, keys)
    np.testing.assert_array_equal(out, keys)
    if src.nbytes >= tblocks.STAGE_SPLIT_BYTES:
        assert tblocks._pool() is tblocks._pool()
