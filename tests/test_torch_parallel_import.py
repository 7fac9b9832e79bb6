"""The port's fanned-out import (``kart_tpu_torch/importer/parallel.py``)
held to its serial route and to kart_tpu: the same root trees with dense
and sparse pks, negative pks and a pk span wider than the leaf index
refused (the serial route takes them), and count-balanced shard bounds.
The counterparts of kart_tpu's ``tests/test_parallel_import.py``, with 2
workers and a lowered threshold (the suite runs beside other workers)."""

import os
import sqlite3

import pytest

import kart_tpu.importer.parallel as jpar
import kart_tpu_torch.importer.importer as timp
import kart_tpu_torch.importer.parallel as tpar
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.importer import GPKGImportSource as JGpkg
from kart_tpu.importer.importer import import_sources as jimport
from kart_tpu.models.paths import encoder_for_schema as jencoder_for_schema
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.importer import GPKGImportSource as TGpkg
from kart_tpu_torch.models.paths import encoder_for_schema

from helpers import create_points_gpkg


@pytest.fixture
def small_threshold(monkeypatch):
    monkeypatch.setattr(tpar, "MIN_FEATURES_FOR_PARALLEL", 10)
    monkeypatch.setattr(jpar, "MIN_FEATURES_FOR_PARALLEL", 10)
    monkeypatch.setenv("GIT_AUTHOR_DATE", "1700000000 +0000")
    monkeypatch.setenv("GIT_COMMITTER_DATE", "1700000000 +0000")
    monkeypatch.delenv("KART_IMPORT_NATIVE_READ", raising=False)


def _import_tree(tmp_path, name, gpkg, workers, monkeypatch, pipeline=None):
    monkeypatch.setenv("KART_IMPORT_WORKERS", str(workers))
    # a source the native reader takes goes to the pipeline whatever the
    # workers: pipeline "0" asks for the fan-out
    if pipeline is None:
        monkeypatch.delenv("KART_IMPORT_PIPELINE", raising=False)
    else:
        monkeypatch.setenv("KART_IMPORT_PIPELINE", pipeline)
    repo = TRepo.init_repository(str(tmp_path / name))
    oid = timp.import_sources(repo, TGpkg.open_all(gpkg))
    return repo, repo.odb.read_commit(oid).tree


def _kart_tpu_tree(tmp_path, gpkg, monkeypatch):
    monkeypatch.setenv("KART_IMPORT_WORKERS", "1")
    monkeypatch.setenv("KART_IMPORT_PIPELINE", "0")
    repo = JRepo.init_repository(str(tmp_path / "kart_tpu"))
    return repo.odb.read_commit(jimport(repo, JGpkg.open_all(gpkg))).tree


def test_parallel_import_matches_serial(tmp_path, monkeypatch, small_threshold):
    gpkg = create_points_gpkg(str(tmp_path / "pts.gpkg"), n=500)
    _, serial_tree = _import_tree(tmp_path, "serial", gpkg, 1, monkeypatch)
    repo, par_tree = _import_tree(tmp_path, "par", gpkg, 2, monkeypatch, pipeline="0")
    assert timp.LAST_IMPORT_ROUTE == "fan-out"
    assert par_tree == serial_tree == _kart_tpu_tree(tmp_path, gpkg, monkeypatch)
    pack_dir = os.path.join(repo.gitdir, "objects", "pack")
    assert len([f for f in os.listdir(pack_dir) if f.endswith(".pack")]) >= 2  # workers + bulk
    ds = list(repo.structure("HEAD").datasets)[0]
    assert ds.feature_count == 500
    assert ds.get_feature((499,))["fid"] == 499


def test_parallel_import_sparse_pks(tmp_path, monkeypatch, small_threshold):
    gpkg = create_points_gpkg(str(tmp_path / "sparse.gpkg"), n=200)
    con = sqlite3.connect(gpkg)
    con.execute("UPDATE points SET fid = fid + 5000000 WHERE fid % 2 = 0")
    con.commit()
    con.close()
    _, serial_tree = _import_tree(tmp_path, "serial", gpkg, 1, monkeypatch)
    _, par_tree = _import_tree(tmp_path, "par", gpkg, 2, monkeypatch, pipeline="0")
    assert par_tree == serial_tree == _kart_tpu_tree(tmp_path, gpkg, monkeypatch)


def test_shardable_rejects_negative_pks(tmp_path, monkeypatch, small_threshold):
    gpkg = create_points_gpkg(str(tmp_path / "neg.gpkg"), n=50)
    con = sqlite3.connect(gpkg)
    con.execute("UPDATE points SET fid = fid - 100")
    con.commit()
    con.close()
    (source,), (jsource,) = TGpkg.open_all(gpkg), JGpkg.open_all(gpkg)
    assert not tpar.shardable(source, encoder_for_schema(source.schema), 4)
    assert not jpar.shardable(jsource, jencoder_for_schema(jsource.schema), 4)
    repo, tree = _import_tree(tmp_path, "neg-repo", gpkg, 2, monkeypatch)
    assert tree == _kart_tpu_tree(tmp_path, gpkg, monkeypatch)
    ds = list(repo.structure("HEAD").datasets)[0]
    assert ds.feature_count == 50
    assert ds.get_feature((-99,))["fid"] == -99


def test_shardable_rejects_wrapping_pk_span(tmp_path, monkeypatch, small_threshold):
    gpkg = create_points_gpkg(str(tmp_path / "wide.gpkg"), n=20)
    con = sqlite3.connect(gpkg)
    con.execute("UPDATE points SET fid = 64 * 64*64*64*64 + fid WHERE fid = 19")
    con.commit()
    con.close()
    (source,) = TGpkg.open_all(gpkg)
    assert not tpar.shardable(source, encoder_for_schema(source.schema), 4)
    repo, tree = _import_tree(tmp_path, "wide-repo", gpkg, 2, monkeypatch, pipeline="0")
    assert tree == _kart_tpu_tree(tmp_path, gpkg, monkeypatch)
    assert list(repo.structure("HEAD").datasets)[0].feature_count == 20


def test_shard_bounds_balanced_single_index_pass(tmp_path):
    gpkg = create_points_gpkg(str(tmp_path / "b.gpkg"), n=1000)
    (source,), (jsource,) = TGpkg.open_all(gpkg), JGpkg.open_all(gpkg)
    bounds = tpar._shard_bounds(source, "fid", 64, 4)
    assert bounds == jpar._shard_bounds(jsource, "fid", 64, 4)
    assert bounds == sorted(set(bounds)) and all(b % 64 == 0 for b in bounds)
    assert 1 <= len(bounds) <= 3
    con = sqlite3.connect(gpkg)
    edges, sizes = [None, *bounds, None], []
    for lo, hi in zip(edges, edges[1:]):
        where, params = [], []
        if lo is not None:
            where.append("fid >= ?")
            params.append(lo)
        if hi is not None:
            where.append("fid < ?")
            params.append(hi)
        (n,) = con.execute("SELECT COUNT(*) FROM points WHERE " + " AND ".join(where),
                           params).fetchone()
        sizes.append(n)
    con.close()
    assert sum(sizes) == 1000 and all(abs(n - 250) <= 64 for n in sizes)
    assert tpar._shard_bounds(source, "fid", 64, 2000) == []
