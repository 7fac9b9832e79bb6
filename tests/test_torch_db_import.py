"""The port's PostgreSQL, MySQL and SQL Server import sources against
kart_tpu's, on the CPU. No server or driver exists here: each package gets
its own copy of one recording server (``chip_smoke.py``'s
``RecordingServer`` as the driver module) holding the same tables, written
through the dialect's own CREATE TABLE and INSERT statements. Held with no
tolerance: spec parsing, the tables listed, schemas (column ids, pk order,
CRS), features, the statements each package sends, the CLI's commits and
output, the ``fetchmany`` batching, MySQL's buffered-cursor fallback, and
the error of a missing driver."""

import copy
import sys

import pytest

import kart_tpu.importer.mysql as jmysql
import kart_tpu.importer.sqlserver as jsqlserver
import kart_tpu_torch.importer.mysql as tmysql
import kart_tpu_torch.importer.sqlserver as tsqlserver
from chip_smoke import RecordingServer, drivers
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.core.repo import NotFound as JNotFound
from kart_tpu.geometry import Geometry as JGeometry
from kart_tpu.importer import ImportSource as JSource
from kart_tpu.importer import ImportSourceError as JImportSourceError
from kart_tpu_torch.adapters.mysql import MySqlAdapter
from kart_tpu_torch.adapters.postgis import PostgisAdapter
from kart_tpu_torch.adapters.sqlserver import SqlServerAdapter
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.core.repo import NotFound as TNotFound
from kart_tpu_torch.crs import make_crs
from kart_tpu_torch.geometry import Geometry as TGeometry
from kart_tpu_torch.importer import ImportSource as TSource
from kart_tpu_torch.importer import ImportSourceError as TImportSourceError
from kart_tpu_torch.models.schema import ColumnSchema, Schema
from test_torch_workingcopy import USER, kart, masked, port

DATE = "1700000000 +0000"
ADAPTERS = {"postgis": PostgisAdapter, "mysql": MySqlAdapter, "sqlserver": SqlServerAdapter}
#: the server's schema (a database on MySQL) that holds the tables
DB = {"postgis": "public", "mysql": "gisdb", "sqlserver": "dbo"}
BASE = {"postgis": "postgresql://db.example.com/gisdb", "mysql": "mysql://db.example.com/gisdb",
        "sqlserver": "mssql://db.example.com/gisdb"}


def spec(dialect, table=None):
    """The source spec of ``table`` (all tables with a primary key when None)."""
    base = BASE[dialect] + ("" if dialect == "mysql" else f"/{DB[dialect]}")
    return base if table is None else f"{base}/{table}"


@pytest.fixture(autouse=True)
def _pinned_dates(monkeypatch):
    monkeypatch.setenv("GIT_AUTHOR_DATE", DATE)
    monkeypatch.setenv("GIT_COMMITTER_DATE", DATE)


def _col(name, data_type, pk_index=None, **extra):
    return ColumnSchema(ColumnSchema.new_id(), name, data_type, pk_index, extra)


#: the server's tables: {name: (columns, rows of V2 values)}
def _tables(n=25):
    pts = [_col("fid", "integer", 0, size=64),
           _col("geom", "geometry", geometryType="POINT", geometryCRS="EPSG:4326"),
           _col("name", "text", length=30), _col("rating", "float", size=64)]
    pt_rows = [{"fid": i, "geom": None if i % 7 == 0 else
                TGeometry.from_wkt(f"POINT ({i / 3} {-i / 5})"),
                "name": None if i % 5 == 0 else f"n{i}", "rating": i * 0.25}
               for i in range(1, n + 1)]
    attrs = [_col("id", "integer", 0, size=32), _col("flag", "boolean"),
             _col("payload", "blob"), _col("born", "date"), _col("ratio", "float", size=32),
             _col("small", "integer", size=16), _col("amount", "numeric", precision=10, scale=2),
             _col("note", "text"), _col("at", "time"), _col("seen", "timestamp")]
    attr_rows = [{"id": i, "flag": i % 2 == 0, "payload": bytes([i, 255 - i]),
                  "born": f"2020-01-{i % 28 + 1:02d}", "ratio": 0.5 * i, "small": -i,
                  "amount": f"{i}.{i % 100:02d}", "note": f"row {i}", "at": "12:00:01",
                  "seen": f"2021-02-03T04:05:{i % 60:02d}"} for i in range(1, n + 1)]
    # a composite pk declared (b, a): the key's order is not the columns'
    comp = [_col("a", "integer", 1, size=64), _col("b", "text", 0, length=8),
            _col("v", "integer", size=64)]
    comp_rows = [{"a": i % 3, "b": f"k{i}", "v": i} for i in range(n)]
    nokey = [_col("x", "integer", size=64)]
    return {"points": (pts, pt_rows), "attrs": (attrs, attr_rows),
            "composite": (comp, comp_rows), "nokey": (nokey, [{"x": 1}])}


def _server(dialect, n=25):
    """A recording server holding :func:`_tables`, written as a client
    would: the dialect's CREATE TABLE and INSERT statements."""
    server = RecordingServer(dialect)
    adapter = ADAPTERS[dialect]
    cur = server.connect().cursor()
    cur.execute(f"CREATE SCHEMA IF NOT EXISTS {adapter.quote(DB[dialect])}")
    for name, (cols, rows) in _tables(n).items():
        schema = Schema(cols)
        tbl = adapter.quote_table(name, DB[dialect])
        cur.execute(f"CREATE TABLE {tbl} ({adapter.v2_schema_to_sql_spec(schema, crs_id=4326)})")
        names = ", ".join(adapter.quote(c.name) for c in cols)
        marks = ", ".join(adapter.insert_placeholder(c, 4326) for c in cols)
        cur.executemany(f"INSERT INTO {tbl} ({names}) VALUES ({marks})",
                        [tuple(adapter.value_from_v2(r[c.name], c, crs_id=4326) for c in cols)
                         for r in rows])
    if dialect == "postgis":
        cur.execute("INSERT INTO public.spatial_ref_sys (srid, auth_name, auth_srid, srtext) "
                    "VALUES (%s, %s, %s, %s) ON CONFLICT (srid) DO NOTHING",
                    (4326, "EPSG", 4326, make_crs("EPSG:4326").wkt))
    server.statements.clear()
    server.many_rows.clear()
    return server


def _norm(value):
    if isinstance(value, (JGeometry, TGeometry)):
        return ("geometry", bytes(value))
    return value


def _read(source_cls, spec_, server):
    """Open ``spec_`` with a package's ImportSource.open -> what a caller
    sees of each source, or the error; and the statements sent."""
    n0 = len(server.statements)
    try:
        with drivers(server):
            out = []
            for src in source_cls.open(spec_):
                out.append((src.dest_path, src.schema.to_column_dicts(), src.crs_definitions(),
                            [{k: _norm(v) for k, v in f.items()} for f in src.features()]))
    except Exception as e:
        out = (type(e).__name__, str(e))
    return out, server.statements[n0:]


@pytest.mark.parametrize("dialect", sorted(ADAPTERS))
@pytest.mark.parametrize("table", [None, "points", "attrs", "composite", "missing"])
def test_sources(dialect, table):
    """Schemas, CRS definitions, features and the statements sent."""
    server = _server(dialect)
    want = _read(JSource, spec(dialect, table), copy.deepcopy(server))
    got = _read(TSource, spec(dialect, table), server)
    assert got == want
    if table in (None, "points", "attrs", "composite"):
        assert got[0] and isinstance(got[0], list)


@pytest.mark.parametrize("spec_", [
    "postgresql://h/db", "postgresql://h:5433/db/s/t", "postgres://u:p%40ss@h/db/s",
    "postgresql://h/db/s%2Fx/t%20y", "postgresql://h", "mysql://h/db", "mysql://u:pw@h:3307/db/t",
    "mysql://h", "mssql://h/db", "mssql://h,1/db/s/t", "sqlserver://u@h:1434/db/s/t", "mssql://h",
])
def test_spec_parsing(spec_):
    out = []
    for mods in ((jmysql, jsqlserver), (tmysql, tsqlserver)):
        import importlib
        pkg = mods[0].__name__.split(".")[0]
        pg = importlib.import_module(f"{pkg}.importer.postgres")
        cls = {"postgresql": pg.PostgresImportSource, "postgres": pg.PostgresImportSource,
               "mysql": mods[0].MySqlImportSource, "mssql": mods[1].SqlServerImportSource,
               "sqlserver": mods[1].SqlServerImportSource}[spec_.split(":")[0]]
        try:
            out.append(cls.parse_spec(spec_))
        except (JImportSourceError, TImportSourceError) as e:
            out.append(("error", str(e)))
    assert out[1] == out[0]


@pytest.mark.parametrize("dialect", sorted(ADAPTERS))
@pytest.mark.parametrize("table", [None, "points"])
def test_missing_driver(dialect, table):
    """kart_tpu's NotFound and text; no fallback."""
    out = []
    for source_cls in (JSource, TSource):
        with drivers(None, dialect):
            with pytest.raises((JNotFound, TNotFound)) as e:
                for src in source_cls.open(spec(dialect, table)):
                    src.schema
        out.append(str(e.value))
    assert out[1] == out[0]


@pytest.mark.parametrize("dialect", sorted(ADAPTERS))
def test_fetchmany_batches(dialect, monkeypatch):
    """Rows come in ``BATCH_SIZE`` batches: the same fetches in each."""
    import kart_tpu.importer.postgres as jpg

    import kart_tpu_torch.importer.postgres as tpg

    for mod in (jpg, jmysql, jsqlserver, tpg, tmysql, tsqlserver):
        monkeypatch.setattr(mod, "BATCH_SIZE", 4)
    if dialect == "postgis":  # a named cursor streams by its itersize
        from kart_tpu_torch.importer import postgres  # noqa: F401
    fetches = []
    for source_cls in (JSource, TSource):
        server = _server(dialect)
        with drivers(server):
            (src,) = source_cls.open(spec(dialect, "points"))
            rows = list(src.features())
        fetches.append((server.fetches, len(rows)))
    assert fetches[1] == fetches[0] and fetches[1][0] >= 2


def test_mysql_buffered_cursor_fallback():
    """Without ``pymysql.cursors.SSCursor`` MySQL reads through a buffered
    cursor, in both packages alike."""
    out = []
    for source_cls in (JSource, TSource):
        server = _server("mysql")
        with drivers(server):
            del sys.modules["pymysql.cursors"]
            (src,) = source_cls.open(spec("mysql", "attrs"))
            out.append([{k: _norm(v) for k, v in f.items()} for f in src.features()])
            sys.modules["pymysql.cursors"] = server
        out.append(server.statements)
    assert out[2:] == out[:2]


@pytest.fixture(autouse=True)
def _one_import_worker(monkeypatch):
    """Both packages' importers read the worker count from the
    environment, and ask a server source for ``count(*)`` once more when
    it allows several: pinned, so that the router's statements do not
    depend on this machine's cores."""
    monkeypatch.setenv("KART_IMPORT_WORKERS", "1")


def _sent(server):
    """The statements sent, the router's ``SELECT count(*)`` (its
    ``source.feature_count``) included."""
    return list(server.statements)


def _pair(tmp_path, dialect):
    """Each package's repository and its own copy of the server."""
    server = _server(dialect)
    out = []
    for run, repo_cls, name, srv in ((kart, JRepo, "k", copy.deepcopy(server)),
                                     (port, TRepo, "p", server)):
        repo = str(tmp_path / name / "repo")
        assert run(["init", repo])[0] == 0
        repo_cls(repo).config.set_many(USER)
        out.append((run, repo, srv))
    return out


@pytest.mark.parametrize("argv", [
    # a GPKG working copy holds no composite pk: those imports skip the checkout
    ["import", "{spec}/points"], ["import", "{spec}", "--no-checkout"], ["import", "{spec}/attrs"],
    ["import", "{spec}/composite", "--no-checkout"],
    ["import", "{spec}/points", "--dest-path", "a/b"],
    ["import", "{spec}", "--list"], ["import", "{spec}", "--list", "-o", "json"],
    ["import", "{spec}/points", "--primary-key", "rating"], ["import", "{spec}/nokey"],
    ["import", "{spec}/points", "--table", "attrs"],
], ids=lambda a: " ".join(a))
@pytest.mark.parametrize("dialect", sorted(ADAPTERS))
def test_import_cli(tmp_path, dialect, argv):
    """``kart import`` from a server: commits, output, working copy and the
    statements, as kart_tpu's."""
    got = []
    base = spec(dialect)
    for run, repo, server in _pair(tmp_path, dialect):
        with drivers(server):
            res = masked(run(["-C", repo, *[a.format(spec=base) for a in argv]]), repo)
        head = (JRepo if run is kart else TRepo)(repo).head_commit_oid
        got.append((res, head, _sent(server)))
    assert got[1] == got[0]


@pytest.mark.parametrize("dialect", sorted(ADAPTERS))
def test_init_import_and_replace(tmp_path, dialect):
    """``init --import``, a client's edit of the table, ``import
    --replace-existing``, then the diff: as kart_tpu."""
    server = _server(dialect)
    src = spec(dialect, "points")
    results = []
    for run, name, srv in ((kart, "k", copy.deepcopy(server)), (port, "p", server)):
        repo = str(tmp_path / name / "repo")
        out = []
        with drivers(srv):
            out.append(masked(run(["init", "--import", src, repo]), repo))
            adapter = ADAPTERS[dialect]
            t = srv.table("points")
            row = dict(zip([c for c, _ in t.columns], t.rows[(3,)]))
            row["name"] = "edited"
            srv.client_upsert("points", row)
            srv.client_delete("points", 4)
            cols = _tables()["points"][0]
            srv.client_upsert("points", {c.name: adapter.value_from_v2(v, c, crs_id=4326)
                                         for c, v in zip(cols, (99, None, "new", 1.5))})
            out.append(masked(run(["-C", repo, "import", "--replace-existing", src]), repo))
            out.append(masked(run(["-C", repo, "diff", "HEAD^...HEAD", "-o", "json"]), repo))
            out.append(masked(run(["-C", repo, "log", "-o", "json"]), repo))
        results.append(out)
    assert results[1] == results[0]
    assert '"edited"' in results[1][2][1]
