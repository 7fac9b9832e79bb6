"""The port's server-database adapters and working copies (PostGIS, MySQL,
SQL Server) against kart_tpu's, on the CPU. No server or driver exists
here, so each package gets its own recording server (``chip_smoke.py``'s
``RecordingServer``, installed under ``sys.modules`` as the driver): it
records every statement and acts on it, so a checkout's tables hold their
rows and ``information_schema`` answers from the CREATE TABLE statements.

Held byte for byte (no tolerance): every V2 type through each adapter (SQL
types both ways, column specs, value conversion, placeholders, DDL, triggers,
upserts, the roundtrip policy), the adapters' SQL against
``tests/golden/*_wc.sql`` (read, never written) and the dialect checker,
EWKB, and for every working-copy command the stdout, stderr, exit code,
commit and the whole statement sequence on each dialect; a non-force reset
classifies through ``get_dataset_diff`` on the working copy's device."""

import ast
import copy
import datetime
import decimal
import os
import sys

import pytest

import chip_smoke
import test_workingcopy_golden_sql as golden
from chip_smoke import RecordingServer, drivers
from helpers import create_points_gpkg
from kart_tpu.adapters import base as jbase
from kart_tpu.adapters.mysql import MySqlAdapter as JMySql
from kart_tpu.adapters.postgis import PostgisAdapter as JPostgis
from kart_tpu.adapters.sqlserver import SqlServerAdapter as JSqlServer
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.geometry import Geometry as JGeometry
from kart_tpu.models.schema import ColumnSchema as JColumn
from kart_tpu.models.schema import Schema as JSchema
from kart_tpu.workingcopy import get_working_copy as j_get_working_copy
from kart_tpu_torch.adapters import base as tbase
from kart_tpu_torch.adapters.mysql import MySqlAdapter as TMySql
from kart_tpu_torch.adapters.postgis import PostgisAdapter as TPostgis
from kart_tpu_torch.adapters.sqlserver import SqlServerAdapter as TSqlServer
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.geometry import Geometry as TGeometry
from kart_tpu_torch.models.schema import ColumnSchema as TColumn
from kart_tpu_torch.models.schema import Schema as TSchema
from kart_tpu_torch.workingcopy import get_working_copy as t_get_working_copy
from sql_dialect_check import MSSQL, MYSQL, PG, check_golden_file, check_sql
from test_torch_workingcopy import USER, kart, masked, port

DATE = "1700000000 +0000"
ADAPTERS = {"postgis": (JPostgis, TPostgis), "mysql": (JMySql, TMySql),
            "sqlserver": (JSqlServer, TSqlServer)}
DIALECT_CHECK = {"postgis": PG, "mysql": MYSQL, "sqlserver": MSSQL}
URLS = {"postgis": "postgresql://db.example.com/gis/wcschema",
        "mysql": "mysql://db.example.com/wcdb",
        "sqlserver": "mssql://db.example.com/gis/wcschema"}


@pytest.fixture(autouse=True)
def _pinned_dates(monkeypatch):
    monkeypatch.setenv("GIT_AUTHOR_DATE", DATE)
    monkeypatch.setenv("GIT_COMMITTER_DATE", DATE)


@pytest.fixture(autouse=True)
def _no_driver_left():
    """A test leaves no driver module behind for the next (the workers are
    shared between files)."""
    yield
    left = [m for m in ("psycopg2", "pymysql", "pymysql.cursors", "pyodbc", "MySQLdb")
            if m in sys.modules]
    assert not left, left


# --- every V2 type through each adapter ----------------------------------------

#: (name, data type, pk index, extra type info): every V2 type and width
COLUMNS = [
    ("fid", "integer", 0, {"size": 64}),
    ("geom", "geometry", None, {"geometryType": "POINT", "geometryCRS": "EPSG:4326"}),
    ("shape", "geometry", None, {"geometryType": "MULTIPOLYGON Z"}),
    ("any_geom", "geometry", None, {}),
    ("flag", "boolean", None, {}),
    ("payload", "blob", None, {}),
    ("short_blob", "blob", None, {"length": 64}),
    ("born", "date", None, {}),
    ("ratio32", "float", None, {"size": 32}),
    ("ratio64", "float", None, {"size": 64}),
    ("ratio0", "float", None, {}),
    ("tiny", "integer", None, {"size": 8}),
    ("small", "integer", None, {"size": 16}),
    ("med", "integer", None, {"size": 32}),
    ("plain_int", "integer", None, {}),
    ("amount", "numeric", None, {"precision": 10, "scale": 2}),
    ("whole", "numeric", None, {"precision": 7}),
    ("any_num", "numeric", None, {}),
    ("name", "text", None, {}),
    ("code", "text", None, {"length": 40}),
    ("huge", "text", None, {"length": 70000}),
    ("at_time", "time", None, {}),
    ("seen_utc", "timestamp", None, {"timezone": "UTC"}),
    ("seen_naive", "timestamp", None, {}),
    ("span", "interval", None, {}),
]


def _cols(pkg):
    cls = JColumn if pkg == "j" else TColumn
    return [cls(f"00000000-0000-4000-8000-{i:012d}", n, t, pk, dict(e))
            for i, (n, t, pk, e) in enumerate(COLUMNS)]


def _both(dialect):
    j, t = ADAPTERS[dialect]
    return j, t, _cols("j"), _cols("t")


def _norm(value):
    """A value of either package in a comparable form (geometries as bytes)."""
    if isinstance(value, (JGeometry, TGeometry)):
        return ("geometry", bytes(value))
    if isinstance(value, (list, tuple)):
        return type(value).__name__, [_norm(v) for v in value]
    return value


@pytest.mark.parametrize("dialect", sorted(ADAPTERS))
def test_v2_types_to_sql(dialect):
    j, t, jcols, tcols = _both(dialect)
    for jc, tc in zip(jcols, tcols):
        for crs_id in (None, 0, 4326, 2193):
            assert (t.v2_type_to_sql_type(tc, crs_id=crs_id)
                    == j.v2_type_to_sql_type(jc, crs_id=crs_id)), (jc.name, crs_id)
            for has_int_pk in (False, True):
                assert (t.v2_column_schema_to_sql_spec(tc, has_int_pk=has_int_pk, crs_id=crs_id)
                        == j.v2_column_schema_to_sql_spec(jc, has_int_pk=has_int_pk,
                                                          crs_id=crs_id)), jc.name
    for crs_id in (None, 4326):
        assert (t.v2_schema_to_sql_spec(TSchema(tcols), crs_id=crs_id)
                == j.v2_schema_to_sql_spec(JSchema(jcols), crs_id=crs_id))


SQL_TYPES = ["BOOLEAN", "BIT", "SMALLINT", "INTEGER", "INT", "BIGINT", "TINYINT", "REAL",
             "FLOAT", "DOUBLE", "DOUBLE PRECISION", "BYTEA", "BLOB", "LONGBLOB", "MEDIUMBLOB",
             "VARBINARY(16)", "VARBINARY(max)", "CHARACTER VARYING", "VARCHAR(40)",
             "NVARCHAR(max)", "NVARCHAR(12)", "NCHAR(3)", "CHAR", "TEXT", "LONGTEXT",
             "TINYTEXT", "NTEXT", "DATE", "TIME", "TIMETZ", "TIMESTAMP", "TIMESTAMPTZ",
             "DATETIME", "DATETIME2", "DATETIMEOFFSET", "SMALLDATETIME", "INTERVAL",
             "NUMERIC", "NUMERIC(10,2)", "NUMERIC(7)", "DECIMAL(5, 1)", "GEOMETRY",
             "GEOGRAPHY", "POINT", "MULTIPOLYGON", "GEOMETRYCOLLECTION", "JSONB", "money",
             " varchar ( 8 ) ", "", None]


@pytest.mark.parametrize("dialect", sorted(ADAPTERS))
def test_sql_types_to_v2(dialect):
    j, t = ADAPTERS[dialect]
    for sql_type in SQL_TYPES:
        assert t.sql_type_to_v2(sql_type) == j.sql_type_to_v2(sql_type), sql_type


def _samples():
    """(column name, value of kart_tpu's kind, the same of the port's kind)."""
    jg = JGeometry.from_wkt("POINT (174.5 -41.25)")
    tg = TGeometry.from_wkt("POINT (174.5 -41.25)")
    jp = JGeometry.from_wkt("MULTIPOLYGON Z (((0 0 1,0 1 2,1 1 3,0 0 1)))")
    tp = TGeometry.from_wkt("MULTIPOLYGON Z (((0 0 1,0 1 2,1 1 3,0 0 1)))")
    utc = datetime.timezone.utc
    plus = datetime.timezone(datetime.timedelta(hours=12))
    out = [("geom", jg, tg), ("shape", jp, tp), ("any_geom", None, None)]
    for name, v in [("flag", True), ("flag", False), ("payload", b"\x00\xff"),
                    ("short_blob", memoryview(b"ab")), ("born", "2020-02-29"),
                    ("ratio32", 1.5), ("ratio64", -2.25), ("tiny", 7), ("small", -300),
                    ("med", 70000), ("plain_int", 0), ("amount", "12.50"), ("whole", "9"),
                    ("any_num", "-0.001"), ("name", "x'y\"z"), ("code", ""), ("huge", "é"),
                    ("at_time", "12:34:56"), ("seen_utc", "2020-01-02T03:04:05Z"),
                    ("seen_naive", "2020-01-02T03:04:05"), ("span", "P1DT2H")]:
        out.append((name, v, v))
    raw = [("geom", jg.with_crs_id(4326).to_ewkb()), ("geom", jg.to_wkb()),
           ("geom", memoryview(jg.with_crs_id(4326).to_ewkb())),
           ("geom", jg.with_crs_id(2193).to_hex_ewkb()), ("shape", jp.to_wkb()),
           ("flag", b"\x01"), ("flag", b"\x00"), ("flag", b""), ("flag", 1), ("flag", 0),
           ("payload", memoryview(b"xyz")), ("born", datetime.date(2001, 2, 3)),
           ("at_time", datetime.time(4, 5, 6)),
           ("amount", decimal.Decimal("3.10")), ("whole", 12),
           ("seen_utc", datetime.datetime(2020, 1, 2, 3, 4, 5, tzinfo=utc)),
           ("seen_utc", datetime.datetime(2020, 1, 2, 3, 4, 5, 600, tzinfo=plus)),
           ("seen_utc", datetime.datetime(2020, 1, 2, 3, 4, 5)),
           ("seen_utc", "2020-01-02 03:04:05+00:00"), ("seen_utc", "2020-01-02 03:04:05+0530"),
           ("seen_utc", "2020-01-02 03:04:05-0000"), ("seen_utc", "2020-01-02 03:04:05"),
           ("seen_naive", datetime.datetime(2020, 1, 2, 3, 4, 5)),
           ("seen_naive", datetime.datetime(2020, 1, 2, 3, 4, 5, tzinfo=plus)),
           ("seen_naive", "2020-01-02 03:04:05+13:00"), ("seen_naive", "garbage+01:00"),
           ("span", datetime.timedelta(days=1, hours=2, minutes=3, seconds=4)),
           ("span", datetime.timedelta(seconds=1, microseconds=500000)),
           ("span", datetime.timedelta(0)), ("span", datetime.timedelta(hours=3)),
           ("span", datetime.timedelta(days=-1, seconds=5)), ("span", "P3D"),
           ("tiny", None), ("name", None)]
    return out, raw


@pytest.mark.parametrize("dialect", sorted(ADAPTERS))
def test_values_both_ways(dialect):
    j, t, jcols, tcols = _both(dialect)
    jc = {c.name: c for c in jcols}
    tc = {c.name: c for c in tcols}
    samples, raw = _samples()
    for name, jv, tv in samples:
        for crs_id in (0, 4326, 2193):
            jw = j.value_from_v2(jv, jc[name], crs_id=crs_id)
            tw = t.value_from_v2(tv, tc[name], crs_id=crs_id)
            assert _norm(tw) == _norm(jw), (name, jv, crs_id)
            if jw is not None and not isinstance(jw, memoryview):
                assert _norm(t.value_to_v2(tw, tc[name])) == _norm(j.value_to_v2(jw, jc[name]))
    for name, v in raw:
        try:
            want = _norm(j.value_to_v2(v, jc[name]))
        except Exception as e:  # the same failure, by type
            with pytest.raises(type(e)):
                t.value_to_v2(v, tc[name])
            continue
        assert _norm(t.value_to_v2(v, tc[name])) == want, (name, v)


@pytest.mark.parametrize("dialect", sorted(ADAPTERS))
def test_placeholders_ddl_and_upserts(dialect):
    j, t, jcols, tcols = _both(dialect)
    for jc, tc in zip(jcols, tcols):
        for crs_id in (0, 4326):
            assert t.insert_placeholder(tc, crs_id) == j.insert_placeholder(jc, crs_id)
        assert t.select_expression(tc) == j.select_expression(jc)
    for schema in ("kartwc", "odd'schema\"`]"):
        for table in ("wide_table", "o'dd \"tbl`]"):
            assert t.base_ddl(schema) == j.base_ddl(schema)
            for method in ("create_trigger_sql", "resume_trigger_sql"):
                assert (getattr(t, method)(schema, table, "fid")
                        == getattr(j, method)(schema, table, "fid"))
            for method in ("drop_trigger_sql", "suspend_trigger_sql"):
                assert getattr(t, method)(schema, table) == getattr(j, method)(schema, table)
            assert t.quote_table(table, schema) == j.quote_table(table, schema)
            assert t.quote_table(table) == j.quote_table(table)
            for crs_id in (0, 4326):
                names = [c.name for c in jcols]
                assert (t.upsert_sql(schema, table, names, ["fid"], crs_id=crs_id,
                                     schema=TSchema(tcols))
                        == j.upsert_sql(schema, table, names, ["fid"], crs_id=crs_id,
                                        schema=JSchema(jcols)))
                assert (t.upsert_sql(schema, table, ["fid"], ["fid"], crs_id=crs_id)
                        == j.upsert_sql(schema, table, ["fid"], ["fid"], crs_id=crs_id))
    for args in ((4326, "EPSG", 4326, "GEOGCS[...]"), (200001, "NONE", 0, "PROJCS['x']")):
        assert t.register_crs_sql(*args) == j.register_crs_sql(*args)
    assert t.string_literal("it's") == j.string_literal("it's")
    assert (t.KART_STATE, t.KART_TRACK) == (j.KART_STATE, j.KART_TRACK) \
        == (tbase.KART_STATE, tbase.KART_TRACK)


@pytest.mark.parametrize("dialect", sorted(ADAPTERS))
def test_roundtrip_alignment(dialect):
    """``try_align_schema_col`` on every pair of column dicts: the same
    verdict and the same patched column."""
    j, t, jcols, _ = _both(dialect)
    dicts = JSchema(jcols).to_column_dicts()
    extra = [{"id": "x", "name": "n", "dataType": "integer", "size": 16},
             {"id": "x", "name": "n", "dataType": "text", "length": 8},
             {"id": "x", "name": "n", "dataType": "text"}]
    for old in dicts + extra:
        for new in dicts + extra:
            jn, tn = dict(new), dict(new)
            assert (t.try_align_schema_col(dict(old), tn)
                    == j.try_align_schema_col(dict(old), jn)) and tn == jn, (old, new)


@pytest.mark.parametrize("dialect", sorted(ADAPTERS))
def test_golden_sql(dialect, monkeypatch):
    """The port's adapters emit ``tests/golden/<dialect>_wc.sql`` exactly,
    and every statement there passes the dialect checker."""
    port_schema = TSchema.from_column_dicts(golden.WIDE_SCHEMA.to_column_dicts())
    monkeypatch.setattr(golden, "WIDE_SCHEMA", port_schema)
    got = golden.emit_dialect_sql(ADAPTERS[dialect][1])
    with open(os.path.join(golden.GOLDEN_DIR, f"{dialect}_wc.sql")) as f:
        want = f.read()
    assert got == want
    check_golden_file(got, DIALECT_CHECK[dialect])


@pytest.mark.parametrize("wkt", ["POINT (1 2)", "POINT Z (1 2 3)", "POINT EMPTY",
                                 "LINESTRING M (0 0 1,1 1 2)", "POLYGON ((0 0,1 0,1 1,0 0))",
                                 "MULTIPOINT ZM ((1 2 3 4),(5 6 7 8))",
                                 "GEOMETRYCOLLECTION (POINT (1 2),LINESTRING (0 0,1 1))"])
@pytest.mark.parametrize("srid", [0, 4326, 2193, -1])
def test_ewkb_round_trips(wkt, srid):
    jg, tg = JGeometry.from_wkt(wkt, crs_id=srid), TGeometry.from_wkt(wkt, crs_id=srid)
    assert bytes(tg) == bytes(jg)
    assert tg.to_ewkb() == jg.to_ewkb() and tg.to_hex_ewkb() == jg.to_hex_ewkb()
    for raw in (jg.to_ewkb(), jg.to_wkb()):
        assert bytes(TGeometry.from_ewkb(raw)) == bytes(JGeometry.from_ewkb(raw))
    hx = jg.to_hex_ewkb()
    assert bytes(TGeometry.from_hex_ewkb(hx)) == bytes(JGeometry.from_hex_ewkb(hx))
    assert bytes(TGeometry.from_ewkb(tg.to_ewkb())) == bytes(tg)
    assert TGeometry.from_ewkb(b"") is None and TGeometry.from_hex_ewkb("") is None


# --- URLs and the driver gate ----------------------------------------------------

LOCATIONS = ["postgresql://h/db/s", "postgresql://u:p%40ss@h:5433/db/s", "postgresql://h/db",
             "postgresql://h/db/s/extra", "mysql://h/db", "mysql://u@h:3307/db",
             "mysql://h/db/s", "mssql://h/db/s", "mssql://u:pw@h:1434/db/s", "mssql://h/db",
             "postgresql:///db/s"]


@pytest.mark.parametrize("location", LOCATIONS)
def test_locations(tmp_path, location):
    """URL parsing, its errors and the password-free location, as kart_tpu."""
    results = []
    for get, repo_cls, name in ((j_get_working_copy, JRepo, "k"),
                                (t_get_working_copy, TRepo, "p")):
        repo = repo_cls.init_repository(str(tmp_path / name))
        repo.config.set_many({"kart.workingcopy.location": location})
        try:
            wc = get(repo, allow_uncreated=True)
            results.append(("ok", str(wc), wc.clean_location, wc.host, wc.port, wc.db_name,
                            wc.db_schema, wc.username, wc.password))
        except Exception as e:
            results.append((type(e).__name__, str(e)))
    assert results[1] == results[0]


@pytest.mark.parametrize("dialect", sorted(ADAPTERS))
def test_missing_driver_text(tmp_path, dialect):
    """Without the driver every package says the same and writes nothing."""
    results = []
    for run, repo_cls, name in ((kart, JRepo, "k"), (port, TRepo, "p")):
        repo = str(tmp_path / name / "repo")
        run(["init", repo, "--workingcopy-location", URLS[dialect]])
        repo_cls(repo).config.set_many(USER)
        with drivers(None, dialect):
            results.append([masked(run(["-C", repo, *argv]), repo) for argv in
                            (["status"], ["create-workingcopy"], ["diff"])])
    assert results[1] == results[0]
    assert all(r[0] == 40 for r in results[1])


def test_drivers_imported_only_where_they_connect():
    """No module of the port imports a database driver at module level."""
    root = os.path.join(os.path.dirname(os.path.abspath(chip_smoke.__file__)), "kart_tpu_torch")
    drivers_ = {"psycopg2", "pymysql", "pyodbc", "MySQLdb"}
    for d, _, names in os.walk(root):
        for n in names:
            if not n.endswith(".py"):
                continue
            with open(os.path.join(d, n)) as f:
                tree = ast.parse(f.read())
            for node in tree.body:
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                        [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                assert not {m.split(".")[0] for m in mods} & drivers_, (n, mods)


# --- every working-copy command on the recording servers -----------------------------

COMMANDS = [
    ["status"], ["status", "-o", "json"], ["diff"], ["diff", "-o", "json"],
    ["commit", "-m", "x"], ["checkout", "-b", "b"], ["restore"], ["restore", "points"],
    ["reset", "HEAD"], ["reset", "--discard-changes", "HEAD^"], ["create-workingcopy"],
    ["create-workingcopy", "--delete-existing"], ["merge", "theirs"],
    ["meta", "set", "points", "title=x"], ["commit-files", "-m", "x", "a=b"],
    ["import", "--replace-existing", "{points}"], ["switch", "-c", "s", "HEAD^"],
    ["switch", "theirs"], ["branch"],
]


@pytest.fixture(scope="module")
def points(tmp_path_factory):
    return create_points_gpkg(str(tmp_path_factory.mktemp("src") / "points.gpkg"), n=30)


def _server_pair(tmp_path, dialect, points):
    """Each package's repository with ``points`` imported twice into a
    working copy on its own recording server, a branch ``theirs`` and one
    row edited by a client. -> [(runner, repo, server)]."""
    out = []
    for run, repo_cls, name in ((kart, JRepo, "k"), (port, TRepo, "p")):
        repo = str(tmp_path / name / "repo")
        server = RecordingServer(dialect)
        with drivers(server):
            assert run(["init", repo, "--workingcopy-location", URLS[dialect]])[0] == 0
            repo_cls(repo).config.set_many(USER)
            assert run(["-C", repo, "import", points])[0] == 0
            assert run(["-C", repo, "import", points, "--replace-existing", "-m", "again"])[0] == 0
        r = repo_cls(repo)
        r.create_commit("refs/heads/theirs", r.head_tree_oid, "ahead", [r.head_commit_oid])
        t = server.table("points")
        row = dict(zip([c for c, _ in t.columns], next(iter(t.rows.values()))))
        row["name"] = "edited by a client"
        server.client_upsert("points", row)
        server.client_delete("points", 7)
        out.append((run, repo, server))
    return out


@pytest.mark.parametrize("argv", COMMANDS, ids=lambda a: " ".join(a))
@pytest.mark.parametrize("dialect", sorted(ADAPTERS))
def test_command_statements(tmp_path, dialect, argv, points):
    """The command's stdout, stderr, exit code, commit, tables and every
    statement it sends equal kart_tpu's; each statement passes the dialect
    checker."""
    got = []
    for run, repo, server in _server_pair(tmp_path, dialect, points):
        n0 = len(server.statements)
        with drivers(server):
            res = masked(run(["-C", repo, *[a.format(points=points) for a in argv]]), repo)
        head = (JRepo if run is kart else TRepo)(repo).head_commit_oid
        got.append((res, head, server.statements[n0:], server.digest()))
    assert got[1] == got[0]
    for sql, _ in got[1][2]:
        check_sql(sql.strip().rstrip(";") + ";", DIALECT_CHECK[dialect])


@pytest.mark.parametrize("dialect", sorted(ADAPTERS))
def test_edit_loop_on_a_server(tmp_path, dialect, points):
    """A sequence of commands on one working copy, edits between them."""
    pair = _server_pair(tmp_path, dialect, points)
    steps = [["status"], ["commit", "-m", "client edits"], ["switch", "-c", "side", "HEAD^"],
             "edit", ["commit", "-m", "side"], ["switch", "main"], ["merge", "side"],
             ["log", "-o", "json"], ["status"], "delete", ["restore", "points"], ["status"]]
    results = []
    for run, repo, server in pair:
        out = []
        for step in steps:
            if step == "edit":
                t = server.table("points")
                row = dict(zip([c for c, _ in t.columns], t.rows[(3,)]))
                row["name"] = "side edit"
                server.client_upsert("points", row)
                continue
            if step == "delete":
                server.client_delete("points", 11)
                continue
            with drivers(server):
                out.append(masked(run(["-C", repo, *step]), repo))
        results.append((out, server.statements, server.digest()))
    assert results[1] == results[0]
    assert results[1][0][-1][0] == 0 and "working copy clean" in results[1][0][-1][1]


@pytest.mark.parametrize("dialect", sorted(ADAPTERS))
def test_non_force_reset_classifies_on_the_wc_device(tmp_path, dialect, points, monkeypatch):
    """A non-force reset passes the working copy's device to
    ``get_dataset_diff`` (the card's K1 by default) and applies the diff
    as upserts and deletes with the triggers suspended."""
    from kart_tpu_torch.diff import engine

    run, repo, server = _server_pair(tmp_path, dialect, points)[1]
    with drivers(server):
        # the edits (and, on PostGIS and MySQL, the CRS text the server gives back)
        assert run(["-C", repo, "commit", "-m", "edits"])[0] == 0
        t = server.table("points")
        row = dict(zip([c for c, _ in t.columns], t.rows[(3,)]))
        row["name"] = "renamed"
        server.client_upsert("points", row)
        server.client_delete("points", 4)
        assert run(["-C", repo, "commit", "-m", "feature edits"])[0] == 0
    seen = []
    real = engine.get_dataset_diff

    def spy(*args, **kwargs):
        seen.append(kwargs.get("device"))
        return real(*args, **kwargs)

    monkeypatch.setattr(engine, "get_dataset_diff", spy)
    r = TRepo(repo)
    with drivers(server):
        wc = t_get_working_copy(r, device="cpu")
        wc.reset(r.structure("HEAD^"))
    assert seen == ["cpu"]
    applied = [" ".join(s.split()) for s, _ in server.statements]
    tbl = ADAPTERS[dialect][1].quote_table("points", wc.db_schema)
    # the update and the delete undone: two upserts, no table rewritten
    n0 = len(applied) - next(i for i, s in enumerate(reversed(applied))
                             if "_kart_state" in s and s.startswith("SELECT value"))
    assert sum(s.startswith(f"{chip_smoke.UPSERTS[dialect]} {tbl}") for s in applied[n0:]) == 2
    assert not any(s.startswith(("CREATE TABLE", "DROP TABLE")) for s in applied[n0:])
    with drivers(server):
        assert wc.get_db_tree() == r.structure("HEAD^").tree_oid
