"""The port's pipelined import (``kart_tpu_torch/importer/pipeline.py`` and
the router of ``importer/importer.py``) held to its serial route and to
kart_tpu: the same root trees and commits across GPKG, GeoJSON and CSV
sources (duplicate pks included), an empty diff between a serial import
and its pipelined re-import, the same ``--replace-ids`` result, the
mid-stream native-reader fallback, the size threshold, the batch and
native encoders byte for byte over NaN, big ints, nulls, unicode, blobs
and dates, a stage error that leaves HEAD and the packs as they were, and
the worker-count rules. The counterparts of kart_tpu's
``tests/test_pipeline_import.py``; each package imports into its own
repository, with the commit dates pinned."""

import json
import logging
import os
import sqlite3
import struct

import numpy as np
import pytest

import kart_tpu.importer.parallel as jpar
import kart_tpu_torch.importer.importer as timp
import kart_tpu_torch.importer.parallel as tpar
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.importer import GPKGImportSource as JGpkg
from kart_tpu.importer import ImportSource as JSource
from kart_tpu.importer.importer import import_sources as jimport
from kart_tpu_torch import native as tnative
from kart_tpu_torch.cli import main as port_main
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.importer import GPKGImportSource as TGpkg
from kart_tpu_torch.importer import ImportSource as TSource

from helpers import create_points_gpkg


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("GIT_AUTHOR_DATE", "1700000000 +0000")
    monkeypatch.setenv("GIT_COMMITTER_DATE", "1700000000 +0000")
    for name in ("KART_IMPORT_PIPELINE", "KART_IMPORT_NATIVE_READ", "KART_IMPORT_FAST"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("KART_IMPORT_WORKERS", "1")


def _port_tree(tmp_path, name, spec, pipeline, monkeypatch, **kwargs):
    monkeypatch.setenv("KART_IMPORT_PIPELINE", "1" if pipeline else "0")
    repo = TRepo.init_repository(str(tmp_path / name))
    oid = timp.import_sources(repo, TSource.open(spec), **kwargs)
    return repo, oid, repo.odb.read_commit(oid).tree


def _kart_tpu_tree(tmp_path, spec, monkeypatch):
    monkeypatch.setenv("KART_IMPORT_PIPELINE", "0")
    repo = JRepo.init_repository(str(tmp_path / "kart_tpu"))
    oid = jimport(repo, JSource.open(spec))
    return oid, repo.odb.read_commit(oid).tree


def _write_geojson(path, n):
    feats = [{"type": "Feature", "properties": {"id": i, "name": f"row-{i}", "score": i / 4.0},
              "geometry": {"type": "Point", "coordinates": [i * 0.5, -i * 0.25]}}
             for i in range(1, n + 1)]
    path.write_text(json.dumps({"type": "FeatureCollection", "features": feats}))
    return str(path)


def _write_csv(path, n, dupes=()):
    rows = ["id,name,amount"] + [f"{i},item-{i},{i * 1.5}" for i in range(1, n + 1)]
    rows += [f"{i},item-{i}-replaced,{i * 2.5}" for i in dupes]  # the last one wins
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def test_pipelined_gpkg_matches_serial_and_kart_tpu(tmp_path, monkeypatch):
    gpkg = create_points_gpkg(str(tmp_path / "pts.gpkg"), n=400)
    _, serial_commit, serial_tree = _port_tree(tmp_path, "serial", gpkg, False, monkeypatch)
    assert timp.LAST_IMPORT_PIPELINE is None and timp.LAST_IMPORT_ROUTE == "serial"
    repo, pipe_commit, pipe_tree = _port_tree(tmp_path, "pipe", gpkg, True, monkeypatch)
    assert timp.LAST_IMPORT_ROUTE == "pipeline-native"
    assert (pipe_tree, pipe_commit) == (serial_tree, serial_commit)
    assert (serial_commit, serial_tree) == _kart_tpu_tree(tmp_path, gpkg, monkeypatch)
    stages = timp.LAST_IMPORT_PIPELINE
    assert set(stages) == {"read", "encode", "hash", "pack", "tree", "wall"}
    assert stages["wall"] > 0
    ds = list(repo.structure("HEAD").datasets)[0]
    assert ds.feature_count == 400
    assert ds.get_feature((123,))["name"] == "feature-123"


def test_pipelined_geojson_matches_serial_and_kart_tpu(tmp_path, monkeypatch):
    spec = _write_geojson(tmp_path / "feats.geojson", 150)
    _, _, serial_tree = _port_tree(tmp_path, "serial", spec, False, monkeypatch)
    _, _, pipe_tree = _port_tree(tmp_path, "pipe", spec, True, monkeypatch)
    assert pipe_tree == serial_tree == _kart_tpu_tree(tmp_path, spec, monkeypatch)[1]


def test_pipelined_csv_matches_serial_including_duplicate_pks(tmp_path, monkeypatch):
    spec = _write_csv(tmp_path / "rows.csv", 120, dupes=(7, 42))
    _, _, serial_tree = _port_tree(tmp_path, "serial", spec, False, monkeypatch)
    repo, _, pipe_tree = _port_tree(tmp_path, "pipe", spec, True, monkeypatch)
    assert pipe_tree == serial_tree == _kart_tpu_tree(tmp_path, spec, monkeypatch)[1]
    ds = list(repo.structure("HEAD").datasets)[0]
    assert ds.feature_count == 120
    assert ds.get_feature((42,))["name"] == "item-42-replaced"


def test_pipelined_reimport_diffs_empty_via_cli(tmp_path, monkeypatch, capsys):
    gpkg = create_points_gpkg(str(tmp_path / "pts.gpkg"), n=300)
    repo_dir = str(tmp_path / "repo")
    assert port_main(["--device", "cpu", "init", repo_dir]) == 0
    monkeypatch.setenv("KART_IMPORT_PIPELINE", "0")
    assert port_main(["--device", "cpu", "-C", repo_dir, "import", gpkg, "--no-checkout"]) == 0
    monkeypatch.setenv("KART_IMPORT_PIPELINE", "1")
    assert port_main(["--device", "cpu", "-C", repo_dir, "import", gpkg, "--no-checkout",
                      "--replace-existing"]) == 0
    capsys.readouterr()
    assert port_main(["--device", "cpu", "-C", repo_dir, "diff", "HEAD^...HEAD", "--exit-code",
                      "-o", "quiet"]) == 0  # no changes: the trees are the same


def test_pipelined_replace_ids_incremental_reimport(tmp_path, monkeypatch):
    gpkg = create_points_gpkg(str(tmp_path / "pts.gpkg"), n=60)
    serial_repo, _, _ = _port_tree(tmp_path, "serial", gpkg, False, monkeypatch)
    pipe_repo, _, _ = _port_tree(tmp_path, "pipe", gpkg, True, monkeypatch)
    jrepo = JRepo.init_repository(str(tmp_path / "kart_tpu"))
    jimport(jrepo, JSource.open(gpkg))
    con = sqlite3.connect(gpkg)
    con.execute("UPDATE points SET name = 'edited' WHERE fid IN (3, 9)")
    con.execute("DELETE FROM points WHERE fid = 12")
    con.commit()
    con.close()
    trees = []
    for repo, pipeline in ((serial_repo, False), (pipe_repo, True)):
        monkeypatch.setenv("KART_IMPORT_PIPELINE", "1" if pipeline else "0")
        oid = timp.import_sources(repo, TSource.open(gpkg), replace_ids=["3", "9", "12"])
        trees.append(repo.odb.read_commit(oid).tree)
        ds = list(repo.structure("HEAD").datasets)[0]
        assert ds.get_feature((3,))["name"] == "edited"
        assert ds.feature_count == 59  # fid 12 became a delete
    oid = jimport(jrepo, JSource.open(gpkg), replace_ids=["3", "9", "12"])
    assert trees[0] == trees[1] == jrepo.odb.read_commit(oid).tree


def _enveloped_point(x, y):
    return (b"GP\x00" + bytes([0x01 | (1 << 1)]) + struct.pack("<i", 4326)
            + struct.pack("<4d", x, x, y, y) + struct.pack("<BI2d", 1, 1, x, y))


def test_native_reader_fallback_mid_stream_through_pipeline(tmp_path, monkeypatch, caplog):
    """An envelope-bearing point (canonical storage has none) makes the
    native reader raise GpkgReaderFallback mid-stream: the import restarts
    through the Python encoder and still lands on the serial tree."""
    gpkg = create_points_gpkg(str(tmp_path / "pts.gpkg"), n=3000)
    con = sqlite3.connect(gpkg)  # in the third batch of 1024 rows
    con.execute("UPDATE points SET geom = ? WHERE fid = 2500", (_enveloped_point(150.0, -45.0),))
    con.commit()
    con.close()
    monkeypatch.setenv("KART_IMPORT_BATCH_ROWS", "1024")
    _, _, serial_tree = _port_tree(tmp_path, "serial", gpkg, False, monkeypatch)
    with caplog.at_level(logging.WARNING, logger="kart_tpu_torch.importer"):
        repo, _, pipe_tree = _port_tree(tmp_path, "pipe", gpkg, True, monkeypatch)
    assert any("restarting import stream" in r.message for r in caplog.records)
    assert timp.LAST_IMPORT_ROUTE == "pipeline"  # the Python producer finished it
    assert pipe_tree == serial_tree == _kart_tpu_tree(tmp_path, gpkg, monkeypatch)[1]
    ds = list(repo.structure("HEAD").datasets)[0]
    assert ds.feature_count == 3000
    assert ds.get_feature((2500,))["geom"] is not None


def test_pipeline_auto_skips_tiny_imports(tmp_path, monkeypatch):
    gpkg = create_points_gpkg(str(tmp_path / "pts.gpkg"), n=50)
    monkeypatch.delenv("KART_IMPORT_PIPELINE", raising=False)
    monkeypatch.setenv("KART_IMPORT_NATIVE_READ", "0")
    repo = TRepo.init_repository(str(tmp_path / "auto"))
    timp.import_sources(repo, TSource.open(gpkg))
    assert timp.LAST_IMPORT_PIPELINE is None  # the serial route was taken


def _mixed_gpkg(path, n=120):
    """A table of every cell kind the encoders treat apart: NaN (stored
    as NULL), big and negative ints, nulls, unicode and long text, blobs,
    booleans, dates and datetimes (space and T forms)."""
    create_points_gpkg(path, n=n)
    con = sqlite3.connect(path)
    for col, decl in (("flag", "BOOLEAN"), ("ts", "DATETIME"), ("day", "DATE"),
                      ("data", "BLOB"), ("big", "INTEGER")):
        con.execute(f"ALTER TABLE points ADD COLUMN {col} {decl}")
    texts = ["plain", "", "unicodé ☃", "x" * 300, None, "\x00nul"]
    reals = [float("nan"), -1.75, 1e300, 5e-324, None, 0.0]
    ints = [0, -1, 2**62, -(2**63), 127, 128, 65536, None, 2**63 - 1]
    for i in range(1, n + 1):
        con.execute("UPDATE points SET name=?, rating=?, flag=?, ts=?, day=?, data=?, big=? "
                    "WHERE fid=?",
                    (texts[i % 6], reals[i % 6], [1, 0, None][i % 3],
                     ["2020-01-02 03:04:05", "2020-01-02T03:04:05Z", None][i % 3],
                     ["2021-12-31", None][i % 2], [b"", b"\x00\xff" * 200, None][i % 3],
                     ints[i % 9], i))
    con.execute("UPDATE points SET geom = NULL WHERE fid % 11 = 0")
    con.commit()
    con.close()
    return path


def test_batch_row_encoder_bit_identical(tmp_path):
    path = _mixed_gpkg(str(tmp_path / "mixed.gpkg"))
    (tsrc,), (jsrc,) = TGpkg.open_all(path), JGpkg.open_all(path)
    schema = tsrc.schema
    assert schema.to_column_dicts() == jsrc.schema.to_column_dicts()
    rows = [r for batch in tsrc.raw_row_batches(schema, 50) for r in batch]
    pks, blobs = tsrc.batch_row_encoder(schema)(rows)
    assert (pks, blobs) == jsrc.batch_row_encoder(jsrc.schema)(rows)
    assert blobs == [schema.encode_feature_blob(f)[1] for f in tsrc.features()]
    assert [(p, b) for batch in tsrc.encoded_feature_batches(schema) for p, b in zip(*batch)] \
        == list(zip(pks, blobs))


def test_native_encoder_bit_identical(tmp_path):
    path = _mixed_gpkg(str(tmp_path / "mixed.gpkg"))
    (src,) = TGpkg.open_all(path)
    schema = src.schema
    want = src.batch_row_encoder(schema)(
        [r for batch in src.raw_row_batches(schema) for r in batch])
    got_pks, got_blobs = [], []
    for tag, pks, buf, offs in src.native_encoded_batches(schema, batch_rows=17):
        assert tag == "enc"
        got_pks += pks.tolist()
        got_blobs += [buf[offs[i]:offs[i + 1]].tobytes() for i in range(len(pks))]
    assert (got_pks, got_blobs) == (list(want[0]), list(want[1]))


def test_stage_error_leaves_head_untouched_with_only_tmp_pack_debris(tmp_path, monkeypatch):
    gpkg = create_points_gpkg(str(tmp_path / "pts.gpkg"), n=5000)
    repo, first, _ = _port_tree(tmp_path, "repo", gpkg, False, monkeypatch)
    pack_dir = os.path.join(repo.gitdir, "objects", "pack")
    before = set(os.listdir(pack_dir))
    calls = []
    real = tnative.pack_records_base

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected hash-stage failure")
        return real(*args, **kwargs)

    monkeypatch.setattr(tnative, "pack_records_base", failing)
    monkeypatch.setenv("KART_IMPORT_PIPELINE", "1")
    monkeypatch.setenv("KART_IMPORT_BATCH_ROWS", "1024")
    with pytest.raises(RuntimeError, match="injected hash-stage failure"):
        timp.import_sources(repo, TSource.open(gpkg), replace_existing=True)
    assert TRepo(repo.workdir).head_commit_oid == first
    left = set(os.listdir(pack_dir)) - before
    assert all(name.startswith(".tmp-pack-") for name in left)
    assert [t for t in __import__("threading").enumerate() if t.name.startswith("kart-import-")] \
        == []


def test_default_workers_cpu_count_fallbacks(monkeypatch):
    monkeypatch.delenv("KART_IMPORT_WORKERS", raising=False)
    for cores, want in ((None, 1), (1, 1), (2, 1), (8, 8)):
        monkeypatch.setattr(os, "cpu_count", lambda cores=cores: cores)
        assert tpar.default_workers() == jpar.default_workers() == want
    monkeypatch.setenv("KART_IMPORT_WORKERS", "3")
    assert tpar.default_workers() == jpar.default_workers() == 3
    monkeypatch.setenv("KART_IMPORT_WORKERS", "junk")
    assert tpar.default_workers() == jpar.default_workers() == 8


def test_clamp_workers_limits_tiny_imports(monkeypatch):
    for n, count in ((8, 0), (8, tpar.MIN_FEATURES_FOR_PARALLEL),
                     (8, 3 * tpar.MIN_FEATURES_FOR_PARALLEL), (2, 10**9)):
        assert tpar.clamp_workers(n, count) == jpar.clamp_workers(n, count)
    assert tpar.clamp_workers(8, 3 * tpar.MIN_FEATURES_FOR_PARALLEL) == 3
    monkeypatch.setattr(tpar, "MIN_FEATURES_FOR_PARALLEL", 10)
    assert tpar.clamp_workers(4, 500) == 4
    assert np.all([tpar.clamp_workers(4, c) >= 1 for c in range(0, 100, 7)])
