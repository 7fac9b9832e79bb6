"""The port's write path against kart_tpu's: ``RepoStructure.commit_diff``
(through ``commit_feature_edits`` and hand-built diffs) on each package's
own copy of one repository, with the author, committer and dates pinned,
gives the same tree and commit oids; the sidecar a commit derives for its
new feature tree (keys, oids, envelopes and the vertex column) is
byte-identical; no sidecar is derived where kart_tpu derives none (a
hash-keyed dataset, a commit that changes the meta too, a parent without
one); a failed derivation logs kart_tpu's warning and still commits;
``SchemaViolation`` and ``PatchApplyError`` texts are kart_tpu's. A
hypothesis property holds random edit mixes of a point layer to the same
oids and sidecar bytes."""

import logging
import os
import shutil
import struct

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import kart_tpu.diff.structs as jstructs
import kart_tpu_torch.diff.structs as tstructs
from helpers import make_imported_repo
from kart_tpu.core.objects import Signature as JSignature
from kart_tpu.core.repo import InvalidOperation as JInvalidOperation
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.geometry import Geometry as JGeometry
from kart_tpu.synth import commit_feature_edits as jcommit_edits
from kart_tpu_torch.core.objects import Signature as TSignature
from kart_tpu_torch.core.repo import InvalidOperation as TInvalidOperation
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.diff import sidecar as tsidecar
from kart_tpu_torch.geometry import Geometry as TGeometry
from kart_tpu_torch.synth import commit_feature_edits as tcommit_edits
from kart_tpu_torch.synth import synth_repo, v2_repo

DATE = "1700000000 +0130"
BASE_PK = 1 << 24

PACKAGES = {
    "k": (JRepo, jstructs, JGeometry, jcommit_edits),
    "p": (TRepo, tstructs, TGeometry, tcommit_edits),
}


@pytest.fixture(autouse=True)
def _pinned_dates(monkeypatch):
    monkeypatch.setenv("GIT_AUTHOR_DATE", DATE)
    monkeypatch.setenv("GIT_COMMITTER_DATE", DATE)


@pytest.fixture(scope="module")
def bases(tmp_path_factory):
    """{name: path} of the repositories the tests copy: an imported GPKG
    point layer, the port's point layer with every blob and its sidecars
    (envelopes and vertex columns), a hash-keyed layer and a V2 table."""
    base = tmp_path_factory.mktemp("write")
    (base / "imp").mkdir()
    repo, _ = make_imported_repo(base / "imp", n=12)
    out = {"imported": str(repo.workdir)}
    out["points"] = synth_repo(str(base / "points"), 400, seed=7, blobs="real",
                               spatial=True)[0].workdir
    out["text"] = synth_repo(str(base / "text"), 120, seed=3, blobs="real", pk="text")[0].workdir
    out["v2"] = v2_repo(str(base / "v2"), n=8, spatial=True)[0].workdir
    return out


def _copies(src, tmp_path):
    """{"k": kart_tpu's copy, "p": the port's copy} of a repository."""
    return {name: shutil.copytree(src, str(tmp_path / name)) for name in PACKAGES}


def _point(geometry_cls, x, y):
    return geometry_cls.from_wkb(struct.pack("<BIdd", 1, 1, x, y))


def _sidecar_bytes(path, repo, ds_path, rev="HEAD"):
    ds = repo.structure(rev).datasets[ds_path]
    f = os.path.join(path, ".kart", "columnar", ds.feature_tree.oid + ".kcol")
    if not os.path.exists(f):
        return None
    with open(f, "rb") as fh:
        return fh.read()


def _point_edits(name, moves, inserts, deletes):
    """The same point-layer edit mix in one package's types."""
    _, _, geom, _ = PACKAGES[name]
    return dict(
        updates=[{"fid": pk, "geom": _point(geom, x, y), "rating": r} for pk, x, y, r in moves],
        inserts=[{"fid": pk, "geom": _point(geom, x, y), "rating": r} for pk, x, y, r in inserts],
        deletes=list(deletes),
    )


def _commit_in_both(paths, ds_path, edits_for, message="edit features"):
    """Commit the same edits in each copy -> {name: (commit oid, tree oid,
    the new feature tree's sidecar bytes or None)}."""
    out = {}
    for name, path in paths.items():
        repo_cls, _, _, commit = PACKAGES[name]
        repo = repo_cls(path)
        oid = commit(repo, ds_path, message=message, **edits_for(name))
        out[name] = (oid, repo.odb.read_commit(oid).tree, _sidecar_bytes(path, repo, ds_path))
    return out


@pytest.mark.parametrize("mix", ["moves", "inserts", "deletes", "all", "reinsert"])
def test_point_layer_commit_and_derived_sidecar_match(bases, tmp_path, mix):
    """A point layer with envelope and vertex columns: the same commit and
    tree oids, and the derived sidecar byte for byte, with both columns."""
    paths = _copies(bases["points"], tmp_path)
    moves = [(BASE_PK + 3, 12.5, -40.25, 1.5), (BASE_PK + 9, -180.0, 89.99999, 2.0),
             (BASE_PK + 200, 179.99999, -90.0, 3.0)]
    inserts = [(BASE_PK + 500, 0.0, 0.0, 9.0), (BASE_PK + 400, -72.5, 41.0, 0.5)]
    deletes = [BASE_PK + 1, BASE_PK + 399]
    mixes = {"moves": (moves, [], []), "inserts": ([], inserts, []),
             "deletes": ([], [], deletes), "all": (moves, inserts, deletes),
             "reinsert": ([], [(BASE_PK + 1, 5.0, 5.0, 7.0)], [])}
    m, i, d = mixes[mix]
    if mix == "reinsert":  # an insert at a pk deleted by the previous commit
        _commit_in_both(paths, "synth", lambda name: _point_edits(name, [], [], [BASE_PK + 1]))
    got = _commit_in_both(paths, "synth", lambda name: _point_edits(name, m, i, d))
    assert got["k"] == got["p"]
    assert got["p"][2] is not None
    repo = TRepo(paths["p"])
    block = tsidecar.load_block(repo, repo.structure("HEAD").datasets["synth"])
    assert block.envelopes is not None and block.vertex_column() is not None


def test_imported_layer_commit_oids_match(bases, tmp_path):
    """kart_tpu's imported GPKG layer: inserts, updates and deletes give
    the same commit and tree oids, and the same derived sidecar (or none)
    as kart_tpu."""
    paths = _copies(bases["imported"], tmp_path)

    def edits(name):
        geom = PACKAGES[name][2]
        return dict(
            inserts=[{"fid": 99, "geom": _point(geom, 170.5, -45.0), "name": "new", "rating": 2.5}],
            updates=[{"fid": 2, "geom": None, "name": "renamed", "rating": None}],
            deletes=[7, 8])

    got = _commit_in_both(paths, "points", edits)
    assert got["k"] == got["p"]


def test_explicit_author_and_committer(bases, tmp_path):
    """``commit_diff`` with an author and a committer given: the same
    commit oid."""
    paths = _copies(bases["imported"], tmp_path)
    oids = []
    for name, path in paths.items():
        repo_cls, structs, _, _ = PACKAGES[name]
        sig_cls = JSignature if name == "k" else TSignature
        repo = repo_cls(path)
        rs = repo.structure("HEAD")
        old = rs.datasets["points"].get_feature([4])
        new = {**old, "name": "signed"}
        diff = _feature_diff(structs, "points", [structs.Delta.update(
            structs.KeyValue((4, old)), structs.KeyValue((4, new)))])
        oids.append(rs.commit_diff(
            diff, "signed edit", author=sig_cls("Ann Author", "ann@example.com", 1600000000, -300),
            committer=sig_cls("Cy Committer", "cy@example.com", 1600000500, 60)))
    assert oids[0] == oids[1]


def _feature_diff(structs, ds_path, deltas, meta=None):
    ds_diff = structs.DatasetDiff()
    if meta is not None:
        ds_diff["meta"] = structs.DeltaDiff(meta)
    if deltas is not None:
        ds_diff["feature"] = structs.DeltaDiff(deltas)
    repo_diff = structs.RepoDiff()
    repo_diff[ds_path] = ds_diff
    return repo_diff


def test_hash_keyed_dataset_derives_no_sidecar(bases, tmp_path):
    """A hash-keyed dataset: the same oids, and no sidecar derived for the
    new feature tree by either package."""
    paths = _copies(bases["text"], tmp_path)

    def edits(name):
        repo = PACKAGES[name][0](paths[name])
        ds = repo.structure("HEAD").datasets["synth"]
        code = next(iter(ds.feature_index()[0]))
        old = ds.get_feature(ds.decode_path_to_pks(code))
        return dict(updates=[{**old, "rating": -1.0}],
                    inserts=[{"code": "GANEW0000001", "rating": 4.0}])

    got = _commit_in_both(paths, "synth", edits)
    assert got["k"] == got["p"] and got["p"][2] is None


def test_meta_and_feature_change_derives_no_sidecar(bases, tmp_path):
    """A commit that changes the title and a feature: the same oids, and
    no derived sidecar (the meta may have changed the encoding)."""
    paths = _copies(bases["points"], tmp_path)
    out = []
    for name, path in paths.items():
        repo_cls, structs, geom, _ = PACKAGES[name]
        repo = repo_cls(path)
        rs = repo.structure("HEAD")
        ds = rs.datasets["synth"]
        old = ds.get_feature([BASE_PK + 5])
        title = ds.get_meta_item("title")
        diff = _feature_diff(
            structs, "synth",
            [structs.Delta.update(structs.KeyValue((BASE_PK + 5, old)),
                                  structs.KeyValue((BASE_PK + 5, {**old, "rating": 0.25})))],
            meta=[structs.Delta.update(structs.KeyValue(("title", title)),
                                       structs.KeyValue(("title", "A new title")))])
        oid = rs.commit_diff(diff, "meta and feature")
        out.append((oid, _sidecar_bytes(path, repo, "synth")))
    assert out[0] == out[1] and out[1][1] is None


def test_parent_without_sidecar_derives_none(bases, tmp_path):
    """With the parent's sidecar gone there is nothing to derive from: the
    same oids and no sidecar in either package."""
    paths = _copies(bases["points"], tmp_path)
    for path in paths.values():
        shutil.rmtree(os.path.join(path, ".kart", "columnar"))
    got = _commit_in_both(paths, "synth", lambda name: _point_edits(
        name, [(BASE_PK + 3, 1.0, 2.0, 3.0)], [], []))
    assert got["k"] == got["p"] and got["p"][2] is None


def test_failed_derivation_logs_and_commits(bases, tmp_path, monkeypatch, caplog):
    """A derivation that raises: the commit lands with kart_tpu's oid, no
    sidecar is written, and kart_tpu's warning is logged."""
    paths = _copies(bases["points"], tmp_path)

    def broken(*args, **kwargs):
        raise OSError("disk full")

    import kart_tpu.diff.sidecar as jsidecar

    monkeypatch.setattr(jsidecar, "update_sidecar_for_commit", broken)
    monkeypatch.setattr(tsidecar, "update_sidecar_for_commit", broken)
    with caplog.at_level(logging.WARNING):
        got = _commit_in_both(paths, "synth", lambda name: _point_edits(
            name, [(BASE_PK + 3, 1.0, 2.0, 3.0)], [], []))
    assert got["k"] == got["p"] and got["p"][2] is None
    messages = [(r.name, r.getMessage()) for r in caplog.records if r.levelno == logging.WARNING]
    assert ("kart_tpu.core.structure", "columnar sidecar update failed (cache only)") in messages
    assert ("kart_tpu_torch.core.structure",
            "columnar sidecar update failed (cache only)") in messages


def test_v2_table_commit_matches(bases, tmp_path):
    """A V2 table (``.sno-dataset``, legacy hashed paths): an insert, an
    update and a delete give kart_tpu's oids."""
    paths = _copies(bases["v2"], tmp_path)

    def edits(name):
        geom = PACKAGES[name][2]
        repo = PACKAGES[name][0](paths[name])
        old = repo.structure("HEAD").datasets["mytable"].get_feature([2])
        return dict(inserts=[{"fid": 50, "name": "fifty", "rating": 1.0,
                              "geom": _point(geom, 3.0, 4.0)}],
                    updates=[{**old, "name": "two"}], deletes=[3])

    got = _commit_in_both(paths, "mytable", edits)
    assert got["k"] == got["p"]


# --- schema violations and conflicts -------------------------------------------

TYPED_COLUMNS = [
    {"id": "c0", "name": "fid", "dataType": "integer", "primaryKeyIndex": 0, "size": 64},
    {"id": "c1", "name": "small", "dataType": "integer", "size": 8},
    {"id": "c2", "name": "code", "dataType": "text", "length": 5},
    {"id": "c3", "name": "raw", "dataType": "blob", "length": 3},
    {"id": "c4", "name": "day", "dataType": "date"},
    {"id": "c5", "name": "clock", "dataType": "time"},
    {"id": "c6", "name": "stamp", "dataType": "timestamp"},
    {"id": "c7", "name": "span", "dataType": "interval"},
    {"id": "c8", "name": "flag", "dataType": "boolean"},
    {"id": "c9", "name": "ratio", "dataType": "float"},
    {"id": "c10", "name": "amount", "dataType": "numeric"},
    {"id": "c11", "name": "shape", "dataType": "geometry", "geometryType": "POINT"},
]

GOOD_ROW = {"fid": 1, "small": 5, "code": "abc", "raw": b"ab", "day": "2024-01-02",
            "clock": "10:11:12.5Z", "stamp": "2024-01-02T03:04:05Z", "span": "P1DT2H",
            "flag": True, "ratio": 2, "amount": "1.50", "shape": None}

VIOLATIONS = {
    "int-overflow": {"small": 128},
    "int-underflow": {"small": -129},
    "int-type": {"small": 1.5},
    "bool-as-int": {"small": True},
    "text-long": {"code": "abcdef"},
    "text-very-long": {"code": "x" * 150},
    "blob-long": {"raw": b"abcd"},
    "blob-very-long": {"raw": bytes(range(200))},
    "date": {"day": "2024-1-2"},
    "time": {"clock": "10:11"},
    "timestamp": {"stamp": "2024-01-02 03:04:05"},
    "interval": {"span": "1 day"},
    "bool-type": {"flag": 1},
    "float-type": {"ratio": "2.0"},
    "numeric-type": {"amount": 1.5},
    "geometry-type": {"shape": b"not a geometry"},
    "several": {"small": 300, "code": "toolong", "day": "x"},
}


def _new_dataset_diff(name, structs, rows):
    schema_delta = structs.Delta.insert(structs.KeyValue(("schema.json", TYPED_COLUMNS)))
    deltas = [structs.Delta.insert(structs.KeyValue((row["fid"], row))) for row in rows]
    return _feature_diff(structs, "typed", deltas, meta=[schema_delta])


def _outcome(fn):
    try:
        return ("ok", fn())
    except (JInvalidOperation, TInvalidOperation) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("case", list(VIOLATIONS))
def test_schema_violation_texts(bases, tmp_path, case):
    """A new dataset's rows against its schema.json: kart_tpu's
    SchemaViolation text (one example a column), nothing committed."""
    paths = _copies(bases["imported"], tmp_path)
    outs = []
    for name, path in paths.items():
        repo_cls, structs, _, _ = PACKAGES[name]
        repo = repo_cls(path)
        head = repo.head_commit_oid
        rows = [GOOD_ROW, {**GOOD_ROW, "fid": 2, **VIOLATIONS[case]},
                {**GOOD_ROW, "fid": 3, **VIOLATIONS[case]}]
        outs.append(_outcome(lambda: repo.structure("HEAD").commit_diff(
            _new_dataset_diff(name, structs, rows), "typed rows")))
        assert repo.head_commit_oid == head
    assert outs[0] == outs[1] and outs[1][0] == "SchemaViolation"


def test_valid_new_dataset_commits(bases, tmp_path):
    """The same typed dataset with valid rows: a new dataset (schema,
    legend and path structure written) with kart_tpu's oids."""
    paths = _copies(bases["imported"], tmp_path)
    outs = []
    for name, path in paths.items():
        repo_cls, structs, geom, _ = PACKAGES[name]
        repo = repo_cls(path)
        rows = [GOOD_ROW, {**GOOD_ROW, "fid": 2, "shape": _point(geom, 1.0, 2.0), "flag": False}]
        outs.append(_outcome(lambda: repo.structure("HEAD").commit_diff(
            _new_dataset_diff(name, structs, rows), "typed rows")))
    assert outs[0] == outs[1] and outs[1][0] == "ok"


def _conflicts(structs, ds, geom):
    """Diffs that must not apply to the imported layer, by name."""
    kv, delta = structs.KeyValue, structs.Delta
    f2 = ds.get_feature([2])
    title = ds.get_meta_item("title")
    return {
        "update-stale": [delta.update(kv((2, {**f2, "name": "stale"})), kv((2, f2)))],
        "update-missing": [delta.update(kv((77, {**f2, "fid": 77})), kv((77, f2)))],
        "delete-stale": [delta.delete(kv((2, {**f2, "rating": 123.0})))],
        "insert-exists": [delta.insert(kv((2, f2)))],
        "meta-stale": ("meta", [delta.update(kv(("title", "not the title")),
                                             kv(("title", "x")))]),
        "meta-insert-exists": ("meta", [delta.insert(kv(("title", "x")))]),
        "schema-delete": ("meta", [delta.delete(kv(("schema.json",
                                                    ds.get_meta_item("schema.json"))))]),
        "meta-ok": ("meta", [delta.update(kv(("title", title)), kv(("title", "retitled")))]),
    }


@pytest.mark.parametrize("case", ["update-stale", "update-missing", "delete-stale",
                                  "insert-exists", "meta-stale", "meta-insert-exists",
                                  "schema-delete", "meta-ok"])
def test_conflict_texts(bases, tmp_path, case):
    """Old values that do not match the revision: kart_tpu's
    PatchApplyError text; a matching meta update commits the same oid."""
    paths = _copies(bases["imported"], tmp_path)
    outs = []
    for name, path in paths.items():
        repo_cls, structs, geom, _ = PACKAGES[name]
        repo = repo_cls(path)
        rs = repo.structure("HEAD")
        change = _conflicts(structs, rs.datasets["points"], geom)[case]
        diff = (_feature_diff(structs, "points", None, meta=change[1])
                if isinstance(change, tuple) else _feature_diff(structs, "points", change))
        outs.append(_outcome(lambda: rs.commit_diff(diff, "conflict")))
    assert outs[0] == outs[1]
    assert outs[1][0] == ("ok" if case == "meta-ok" else "PatchApplyError")


def test_no_changes_to_commit(bases, tmp_path):
    """A diff that leaves the tree as it was: kart_tpu's refusal, and with
    ``allow_empty`` the same empty commit."""
    paths = _copies(bases["imported"], tmp_path)
    outs = []
    for name, path in paths.items():
        repo_cls, structs, _, _ = PACKAGES[name]
        repo = repo_cls(path)
        rs = repo.structure("HEAD")
        f2 = rs.datasets["points"].get_feature([2])
        diff = _feature_diff(structs, "points", [structs.Delta.update(
            structs.KeyValue((2, f2)), structs.KeyValue((2, dict(f2))))])
        outs.append((_outcome(lambda: rs.commit_diff(diff, "same")),
                     _outcome(lambda: rs.commit_diff(diff, "same", allow_empty=True))))
    assert outs[0] == outs[1] and outs[1][0][0] == "InvalidOperation"


# --- the property ------------------------------------------------------------------

N_POINTS = 400

pk_sets = st.lists(st.integers(0, N_POINTS - 1), max_size=12, unique=True)
coords = st.tuples(st.floats(-180, 180), st.floats(-90, 90))


@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(moved=pk_sets, deleted=pk_sets, n_new=st.integers(0, 6),
       where=st.lists(coords, min_size=12, max_size=12))
def test_random_edit_mixes_match(bases, tmp_path_factory, moved, deleted, n_new, where):
    """Random moves, deletes and inserts of the point layer: the same tree
    and commit oids and derived sidecar bytes in both packages."""
    deleted = [d for d in deleted if d not in moved]
    moves = [(BASE_PK + pk, *where[i % 12], float(i)) for i, pk in enumerate(moved)]
    inserts = [(BASE_PK + N_POINTS + i, *where[-1 - i], -float(i)) for i in range(n_new)]
    if not (moves or inserts or deleted):
        return
    paths = _copies(bases["points"], tmp_path_factory.mktemp("prop"))
    got = _commit_in_both(paths, "synth", lambda name: _point_edits(
        name, moves, inserts, [BASE_PK + d for d in deleted]))
    assert got["k"] == got["p"] and got["p"][2] is not None
