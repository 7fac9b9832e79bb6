"""``kart diff --only-feature-count``: the port's estimation
(``kart_tpu_torch.diff.estimation``, its annotations cache) against
kart_tpu's. The column sampler on the same blocks at every accuracy
(all-even pks included); the 100,000-row gate between the column and the
tree sampler; each package reading the cache the other wrote; and the CLI
with ``-o json``, dataset filters and ``--exit-code`` (equal stdout and
exit codes, the cache emptied before every run)."""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest
from click.testing import CliRunner

from helpers import edit_commit, make_imported_repo
from kart_tpu.cli import cli as kart_cli
from kart_tpu.diff import estimation as jestimation
from kart_tpu.ops.blocks import FeatureBlock as JBlock
from kart_tpu.synth import synth_repo as jsynth_repo
from kart_tpu_torch.cli import main as port_main
from kart_tpu_torch.diff import estimation
from kart_tpu_torch.ops.blocks import FeatureBlock

ACCURACIES = ["veryfast", "fast", "medium", "good", "exact"]
SAMPLED = ACCURACIES[:-1]


def _versions(kind, n, seed):
    """(keys, oids) of a base and an edited version: 5% updates, 1%
    deletes, 1% inserts. ``even``: every pk even; ``strided``: a stride of
    64 (one residue class of ``pk % 64``); ``random``: sorted random pks."""
    rng = np.random.default_rng(seed)
    if kind == "even":
        keys = 2 * np.arange(1, n + 1, dtype=np.int64)
    elif kind == "strided":
        keys = 64 * np.arange(n, dtype=np.int64) - 2**40
    else:
        keys = np.cumsum(rng.integers(1, 9, n)).astype(np.int64) - 3 * n
    oids = rng.integers(0, 2**32, size=(n, 5), dtype=np.uint32)
    new_oids = oids.copy()
    upd = rng.random(n) < 0.05
    new_oids[upd, 2] ^= np.uint32(0x5A5A)
    keep = rng.random(n) >= 0.01
    ins = keys[-1] + 2 * np.arange(1, n // 100 + 1, dtype=np.int64)
    new_keys = np.concatenate([keys[keep], ins])
    new_oids = np.concatenate([new_oids[keep], rng.integers(0, 2**32, (len(ins), 5),
                                                             dtype=np.uint32)])
    return (keys, oids), (new_keys, new_oids)


@pytest.mark.parametrize("kind", ["random", "even", "strided"])
@pytest.mark.parametrize("accuracy", SAMPLED)
def test_counts_from_blocks_match_kart_tpu(kind, accuracy):
    old, new = _versions(kind, 20_000, seed=len(kind))
    got = estimation.estimate_counts_from_blocks(
        FeatureBlock(*old, len(old[0])), FeatureBlock(*new, len(new[0])), accuracy, "cpu")
    want = jestimation.estimate_counts_from_blocks(
        JBlock(old[0], old[1], None, len(old[0])), JBlock(new[0], new[1], None, len(new[0])),
        accuracy)
    assert got == want > 0
    if accuracy == "good":
        truth = int(np.sum(~np.isin(old[0], new[0]))) + len(new[0]) - int(
            np.sum(np.isin(new[0], old[0]))) + int(np.sum(
                (old[1][np.isin(old[0], new[0])] != new[1][np.isin(new[0], old[0])]).any(axis=1)))
        assert got == truth  # all 64 classes: exact


def test_partition_class_matches_kart_tpu_mixer():
    keys = np.concatenate([np.arange(-5, 5), [2**62, -(2**63), 2**63 - 1]]).astype(np.int64)
    h = keys.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    h ^= h >> np.uint64(29)
    h *= np.uint64(0xBF58476D1CE4E5B9)
    assert np.array_equal(estimation.partition_class(keys), (h >> np.uint64(58)) % np.uint64(64))


def _run_port(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_main(argv)
    return rc, out.getvalue()


def _drop_cache(path):
    db = os.path.join(path, ".kart", "annotations.db")
    if os.path.exists(db):
        os.remove(db)


def _compare(path, opts, *, fresh=True):
    """kart_tpu's CLI and the port's, each on an empty cache (``fresh``)."""
    if fresh:
        _drop_cache(path)
    ref = CliRunner().invoke(kart_cli, ["-C", path, "diff", *opts])
    assert ref.exception is None or isinstance(ref.exception, SystemExit), ref.exception
    if fresh:
        _drop_cache(path)
    got = _run_port(["--device", "cpu", "-C", path, "diff", *opts])
    assert got == (ref.exit_code, ref.stdout)
    return got


@pytest.fixture(scope="module")
def synth_repos(tmp_path_factory):
    """kart_tpu synth repos (sidecars, no blobs) on both sides of the
    column sampler's 100,000-row gate."""
    base = tmp_path_factory.mktemp("estimate")
    out = {}
    for n in (99_999, 100_000):
        path = str(base / f"s{n}")
        jsynth_repo(path, n, edit_frac=0.03, blobs="promised", seed=11)
        out[n] = path
    return out


@pytest.fixture()
def column_calls(monkeypatch):
    calls = []
    real = estimation.estimate_counts_from_blocks

    def spy(old_block, new_block, accuracy, device=None):
        calls.append((old_block.count, new_block.count, accuracy))
        return real(old_block, new_block, accuracy, device)

    monkeypatch.setattr(estimation, "estimate_counts_from_blocks", spy)
    return calls


@pytest.mark.parametrize("n", [99_999, 100_000])
@pytest.mark.parametrize("accuracy", ACCURACIES)
def test_gate_between_samplers(synth_repos, column_calls, n, accuracy):
    """Under 100,000 rows a side the tree sampler runs, from 100,000 the
    column sampler (which can print another number): the port's choice and
    output are kart_tpu's."""
    rc, out = _compare(synth_repos[n], ["--only-feature-count", accuracy, "HEAD^...HEAD"])
    assert rc == 0 and out.startswith("synth:\n\t")
    uses_columns = n >= estimation.COLUMNAR_ESTIMATE_MIN_ROWS and accuracy != "exact"
    assert [c[2] for c in column_calls] == ([accuracy] if uses_columns else [])
    if accuracy in ("good", "exact"):
        assert out == f"synth:\n\t{int(n * 0.03)} features changed\n"


def test_gate_constant_is_kart_tpus():
    assert estimation.COLUMNAR_ESTIMATE_MIN_ROWS == jestimation.COLUMNAR_ESTIMATE_MIN_ROWS \
        == 100_000
    assert estimation.ACCURACY_SUBTREE_SAMPLES == jestimation.ACCURACY_SUBTREE_SAMPLES


def _forbid(monkeypatch, module, names):
    def boom(*args, **kwargs):
        raise AssertionError("the cache should have answered")

    for name in names:
        monkeypatch.setattr(module, name, boom)


@pytest.mark.parametrize("writer", ["kart_tpu", "port"])
def test_each_reads_the_others_cache(synth_repos, monkeypatch, writer):
    path = synth_repos[100_000]
    opts = ["diff", "--only-feature-count", "medium", "HEAD^...HEAD"]
    _drop_cache(path)
    if writer == "kart_tpu":
        first = CliRunner().invoke(kart_cli, ["-C", path, *opts]).stdout
        _forbid(monkeypatch, estimation, ["_estimate_columnar", "_estimate_tree_pair"])
        second = _run_port(["--device", "cpu", "-C", path, *opts])[1]
    else:
        first = _run_port(["--device", "cpu", "-C", path, *opts])[1]
        _forbid(monkeypatch, jestimation, ["_estimate_columnar", "_estimate_tree_pair"])
        second = CliRunner().invoke(kart_cli, ["-C", path, *opts]).stdout
    assert first == second and first.startswith("synth:")
    _drop_cache(path)


@pytest.fixture(scope="module")
def points(tmp_path_factory):
    """Imported points and one edit commit (a small repo: the tree sampler)."""
    base = tmp_path_factory.mktemp("estpoints")
    repo, ds_path = make_imported_repo(base, n=30)
    ds = repo.datasets()[ds_path]
    edit_commit(repo, ds_path, updates=[{**ds.get_feature([i]), "rating": -1.0}
                                        for i in range(1, 20)], deletes=[21, 22])
    return str(repo.workdir)


@pytest.mark.parametrize("filters", [[], ["points"], ["points:3"], ["nosuch"]],
                         ids=["none", "ds", "ds_pk", "other"])
@pytest.mark.parametrize("opts", [(), ("-o", "json"), ("--exit-code",),
                                  ("-o", "json", "--exit-code")], ids="_".join)
@pytest.mark.parametrize("accuracy", ACCURACIES)
def test_cli_matches_kart_tpu(points, accuracy, opts, filters):
    _compare(points, ["--only-feature-count", accuracy, *opts, "HEAD^...HEAD", *filters])


@pytest.mark.parametrize("spec", ["HEAD...HEAD", "HEAD^..HEAD", "HEAD...HEAD^"])
def test_cli_specs_match_kart_tpu(points, spec):
    _compare(points, ["--only-feature-count", "fast", "--exit-code", spec])


def test_cached_answer_matches(points, tmp_path):
    """A second run answers from the cache: the same bytes, also through
    a copy of the repo that kart_tpu filled."""
    path = str(tmp_path / "copy")
    shutil.copytree(points, path)
    opts = ["--only-feature-count", "veryfast", "-o", "json", "HEAD^...HEAD"]
    first = _compare(path, opts)
    assert _compare(path, opts, fresh=False) == first
