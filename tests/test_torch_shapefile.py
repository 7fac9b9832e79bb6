"""The port's Shapefile and zipped-Shapefile import sources against
kart_tpu's, on the CPU: fixtures built as ``tests/test_shapefile.py``
builds them (and with every shape type, Z and M variant, null shapes and
dBase field kind), the seeded layers of ``kart_tpu_torch.synth_sources``,
and the imports through both CLIs. Held with no tolerance: shapes, schemas
(column ids), features and their WKB, errors, commits, output and the
working copy's rows."""

import gc
import os
import struct
import zipfile

import pytest

from kart_tpu.importer import ImportSource as JSource
from kart_tpu.importer.shapefile import DbfReader as JDbf
from kart_tpu.importer.shapefile import ShpReader as JShp
from kart_tpu_torch import synth_sources
from kart_tpu_torch.importer import ImportSource as TSource
from kart_tpu_torch.importer.shapefile import DbfReader as TDbf
from kart_tpu_torch.importer.shapefile import ShpReader as TShp
from test_shapefile import WGS84_WKT, write_dbf, write_point_shp, write_polygon_shp
from test_torch_workingcopy import Pair, kart, masked, port

DATE = "1700000000 +0000"


@pytest.fixture(autouse=True)
def _pinned_dates(monkeypatch):
    monkeypatch.setenv("GIT_AUTHOR_DATE", DATE)
    monkeypatch.setenv("GIT_COMMITTER_DATE", DATE)


# --- fixtures: raw records of every shape type -------------------------------

def _write_shp(path, shape_type, contents):
    records = b"".join(struct.pack(">2i", i, len(c) // 2) + c
                       for i, c in enumerate(contents, 1))
    head = struct.pack(">7i", 9994, 0, 0, 0, 0, 0, 50 + len(records) // 2)
    head += struct.pack("<2i8d", 1000, shape_type, 0, 0, 10, 10, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(head + records)
    return str(path)


def _range(values):
    return struct.pack("<2d", min(values), max(values)) if values else struct.pack("<2d", 0, 0)


def _parts_record(stype, parts, z=None, m=None):
    """PolyLine/Polygon (+Z/M) record: parts [[(x, y)]], z/m per point."""
    pts = [p for part in parts for p in part]
    out = struct.pack("<i4d2i", stype, 0, 0, 10, 10, len(parts), len(pts))
    start = 0
    for part in parts:
        out += struct.pack("<i", start)
        start += len(part)
    out += b"".join(struct.pack("<2d", *p) for p in pts)
    for extra in (z, m):
        if extra is not None:
            out += _range(extra) + struct.pack(f"<{len(extra)}d", *extra)
    return out


def _multipoint_record(stype, pts, z=None, m=None):
    out = struct.pack("<i4di", stype, 0, 0, 10, 10, len(pts))
    out += b"".join(struct.pack("<2d", *p) for p in pts)
    for extra in (z, m):
        if extra is not None:
            out += _range(extra) + struct.pack(f"<{len(extra)}d", *extra)
    return out


CW = [(0, 0), (0, 10), (10, 10), (10, 0), (0, 0)]
HOLE = [(2, 2), (4, 2), (4, 4), (2, 4), (2, 2)]
CW2 = [(20, 20), (20, 30), (30, 30), (30, 20), (20, 20)]
HOLE2 = [(22, 22), (24, 22), (24, 24), (22, 24), (22, 22)]
NULL = struct.pack("<i", 0)

SHAPES = {
    "point": (1, [struct.pack("<i2d", 1, 1.5, -2.5), NULL, struct.pack("<i2d", 1, 3, 4)]),
    "point_z": (11, [struct.pack("<i4d", 11, 1, 2, 3, 4), struct.pack("<i3d", 11, 5, 6, 7)]),
    "point_m": (21, [struct.pack("<i3d", 21, 1, 2, 9), struct.pack("<i3d", 21, 5, 6, -1)]),
    # a PointM record cut before its M: kart_tpu's writer refuses the point
    "point_m_short": (21, [struct.pack("<i2d", 21, 5, 6)]),
    "polyline": (3, [_parts_record(3, [[(0, 0), (1, 1)], [(2, 2), (3, 1), (4, 4)]]),
                     _parts_record(3, [[(0, 0), (1, 2)], []]), NULL]),
    "polyline_z": (13, [_parts_record(13, [[(0, 0), (1, 1)], [(2, 2), (3, 3)]],
                                      z=[1, 2, 3, 4], m=[5, 6, 7, 8])]),
    "polyline_m": (23, [_parts_record(23, [[(0, 0), (1, 1), (2, 0)]], m=[0.5, 1.5, 2.5]),
                        _parts_record(23, [[(0, 0), (1, 1)]])]),
    "polygon": (5, [_parts_record(5, [CW, HOLE]), _parts_record(5, [CW, CW2]),
                    _parts_record(5, [CW, CW2, HOLE2, HOLE]), _parts_record(5, [HOLE]),
                    _parts_record(5, [CW, [(0, 0), (1, 1), (0, 0)]]), NULL,
                    _parts_record(5, [CW2, CW, HOLE])]),
    "polygon_z": (15, [_parts_record(15, [CW, HOLE], z=list(range(10)), m=list(range(10)))]),
    "polygon_m": (25, [_parts_record(25, [CW], m=[1, 2, 3, 4, 5])]),
    "multipoint": (8, [_multipoint_record(8, [(1, 2), (3, 4)]), NULL]),
    "multipoint_z": (18, [_multipoint_record(18, [(1, 2), (3, 4)], z=[5, 6], m=[7, 8]),
                          _multipoint_record(18, [(1, 2)], z=[5])]),
    "multipoint_m": (28, [_multipoint_record(28, [(1, 2), (3, 4)], m=[7, 8])]),
    "empty": (1, []),
}


def _same_reader(path):
    """Both ShpReaders give the same type, header fields and shapes."""
    out = []
    for cls in (JShp, TShp):
        try:
            r = cls(path)
            out.append((r.shape_type, r.has_z, r.has_m, r.geometry_type_name(), list(r)))
        except Exception as e:
            out.append((type(e).__name__, str(e)))
    assert out[1] == out[0]
    return out[1]


def _same_source(path, **kw):
    """Both packages' ImportSource.open: dest path, schema, CRS and features
    (geometry bytes); or the same error."""
    out = []
    for cls in (JSource, TSource):
        try:
            (src,) = cls.open(path, **kw)
            out.append((src.dest_path, src.schema.to_column_dicts(), src.crs_definitions(),
                        src.meta_items(),
                        [{k: (bytes(v) if hasattr(v, "to_wkb") else v) for k, v in f.items()}
                         for f in src.features()]))
        except Exception as e:
            out.append((type(e).__name__, str(e)))
    assert out[1] == out[0]
    return out[1]


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_shapes(tmp_path, name):
    stype, contents = SHAPES[name]
    path = _write_shp(tmp_path / f"{name}.shp", stype, contents)
    got = _same_reader(path)
    assert len(got[-1]) == len(contents)
    write_dbf(tmp_path / f"{name}.dbf", [("n", "N", 4, 0)],
              [{"n": i} for i in range(len(contents))])
    got = _same_source(path)
    if name != "point_m_short":
        assert [f["n"] for f in got[-1]] == list(range(len(contents)))


@pytest.mark.parametrize("name", ["bad_magic", "too_short", "multipatch", "no_dbf",
                                  "upper_case_siblings", "dbf_too_short", "bad_prj"])
def test_files(tmp_path, name):
    path = str(tmp_path / "f.shp")
    write_point_shp(path, [(1.0, 2.0), (3.0, 4.0)])
    write_dbf(tmp_path / "f.dbf", [("name", "C", 5, 0)], [{"name": "a"}, {"name": "b"}])
    if name == "bad_magic":
        with open(path, "wb") as f:
            f.write(b"\x00" * 200)
    elif name == "too_short":
        with open(path, "wb") as f:
            f.write(b"\x00" * 20)
    elif name == "multipatch":
        _write_shp(path, 31, [struct.pack("<i", 31)])
    elif name == "no_dbf":
        os.remove(tmp_path / "f.dbf")
    elif name == "upper_case_siblings":
        os.rename(tmp_path / "f.dbf", tmp_path / "f.DBF")
        (tmp_path / "f.PRJ").write_text(WGS84_WKT)
    elif name == "dbf_too_short":
        (tmp_path / "f.dbf").write_bytes(b"\x03")
    elif name == "bad_prj":
        (tmp_path / "f.prj").write_text("not a CRS")
    _same_source(path)


DBF_FIELDS = [("name", "C", 10, 0), ("count", "N", 6, 0), ("price", "N", 9, 2),
              ("ratio", "F", 12, 0), ("ok", "L", 1, 0), ("day", "D", 8, 0),
              ("memo", "M", 10, 0), ("odd", "X", 4, 0)]
DBF_ROWS = [
    {"name": "alpha", "count": 12, "price": "3.50", "ratio": 0.25, "ok": True,
     "day": "1999-12-31", "memo": "m", "odd": "zz"},
    {"name": None, "count": None, "price": None, "ratio": None, "ok": None, "day": None},
    {"name": "é", "count": -4, "price": "-0.01", "ratio": -1e10, "ok": False,
     "day": "2020-02-30", "odd": ""},
    {"name": "  pad  ", "count": "12x", "price": "abc", "ratio": "1e400", "ok": "?",
     "day": "2020133"},
]


@pytest.mark.parametrize("deleted", [(), (1,), (0, 3)])
def test_dbf(tmp_path, deleted):
    """Every dBase kind, blanks, garbage, ``*``-filled numbers and deleted
    records (the feature skipped, the others keep their FIDs)."""
    base = tmp_path / "t"
    write_point_shp(base.with_suffix(".shp"), [(i, i) for i in range(len(DBF_ROWS))])
    write_dbf(base.with_suffix(".dbf"), DBF_FIELDS, DBF_ROWS)
    data = bytearray(base.with_suffix(".dbf").read_bytes())
    header, record = struct.unpack("<HH", data[8:12])
    for i in deleted:
        data[header + record * i] = ord("*")
    count_at = header + 1 + 10
    data[count_at + 3 * record: count_at + 3 * record + 6] = b"******"
    base.with_suffix(".dbf").write_bytes(bytes(data))
    out = []
    for cls in (JDbf, TDbf):
        r = cls(str(base.with_suffix(".dbf")))
        out.append((r.fields, r.v2_columns(), list(r.records())))
    assert out[1] == out[0]
    feats = _same_source(str(base.with_suffix(".shp")))[-1]
    assert [f["FID"] for f in feats] == [i + 1 for i in range(len(DBF_ROWS)) if i not in deleted]


def test_seeded_layers(tmp_path):
    layer = synth_sources.point_layer(400, 3)
    shp = synth_sources.write_point_shapefile(str(tmp_path / "points"), layer)
    feats = _same_source(shp)[-1]
    assert len(feats) == 400 - sum(layer["deleted"])
    poly = synth_sources.write_polygon_shapefile(str(tmp_path / "polygons"), 120, 4)
    assert len(_same_source(poly)[-1]) == 120
    edited, edits = synth_sources.edited_point_layer(layer, 5, moved=0.05, deleted=0.02,
                                                     inserted=0.02)
    synth_sources.write_point_shapefile(str(tmp_path / "points"), edited)
    assert len(_same_source(shp)[-1]) == len(feats) - len(edits["deleted"]) \
        + len(edits["inserted"])


# --- zipped Shapefiles -------------------------------------------------------------

def _zip(path, members):
    with zipfile.ZipFile(path, "w") as zf:
        for name, data in members.items():
            zf.writestr(name, data)
    return str(path)


@pytest.fixture
def shp_files(tmp_path):
    base = tmp_path / "src" / "roads"
    os.makedirs(base.parent)
    write_point_shp(base.with_suffix(".shp"), [(1.0, 2.0), (3.5, -4.5)])
    write_dbf(base.with_suffix(".dbf"), [("name", "C", 8, 0)], [{"name": "a"}, {"name": "b"}])
    base.with_suffix(".prj").write_text(WGS84_WKT)
    return {ext: (base.with_suffix(ext)).read_bytes() for ext in (".shp", ".dbf", ".prj")}


@pytest.mark.parametrize("case", ["flat", "folder", "macosx", "two_shp", "no_shp",
                                  "not_a_zip", "other_stem"])
def test_zipped(tmp_path, shp_files, case):
    members = {f"roads{ext}": data for ext, data in shp_files.items()}
    if case == "folder":
        members = {f"data/v1/roads{ext}": data for ext, data in shp_files.items()}
    elif case == "macosx":
        members["__MACOSX/._roads.shp"] = b"\x00\x05\x16\x07"
    elif case == "two_shp":
        members["other.shp"] = shp_files[".shp"]
    elif case == "no_shp":
        del members["roads.shp"]
    elif case == "other_stem":
        members["roads2.dbf"] = b"junk"
    path = str(tmp_path / "layer.zip")
    if case == "not_a_zip":
        with open(path, "wb") as f:
            f.write(b"PK not really")
    else:
        _zip(path, members)
    got = _same_source(path)
    if case in ("flat", "folder", "macosx", "other_stem"):
        assert got[0] == "layer" and len(got[-1]) == 2


def test_zip_extraction_is_removed_with_the_source(tmp_path, shp_files):
    path = _zip(tmp_path / "layer.zip", {f"roads{e}": d for e, d in shp_files.items()})
    (src,) = TSource.open(path)
    where = src._tmpdir.name
    assert os.path.isdir(where) and list(src.features())
    del src
    gc.collect()
    assert not os.path.exists(where)


# --- through both CLIs ------------------------------------------------------------

def test_imports_through_the_cli(tmp_path, shp_files):
    src = tmp_path / "src"
    zipped = _zip(tmp_path / "src" / "roads_zip.zip",
                  {f"in/roads{e}": d for e, d in shp_files.items()})
    polygons = str(src / "polygons.shp")
    write_polygon_shp(polygons, [[CW, HOLE], [CW2]])
    write_dbf(src / "polygons.dbf", [("kind", "C", 4, 0)], [{"kind": "a"}, {"kind": None}])
    bare = str(src / "noprj.shp")
    write_point_shp(bare, [(5.0, 6.0)])
    pair = Pair(tmp_path, [])
    pair.run(["import", str(src / "roads.shp")], code=0)
    pair.run(["import", zipped, polygons], code=0)
    pair.run(["import", bare, "--crs", "EPSG:2193"], code=0)
    pair.run(["import", str(src / "roads.shp"), "--dest-path", "again", "--primary-key", "name"],
             code=0)
    write_point_shp(src / "roads.shp", [(1.0, 2.5), (3.5, -4.5), (7.0, 7.0)])
    write_dbf(src / "roads.dbf", [("name", "C", 8, 0)],
              [{"name": "a2"}, {"name": "b"}, {"name": "c"}])
    pair.run(["import", str(src / "roads.shp"), "--replace-existing"], code=0)
    pair.run(["diff", "HEAD^...HEAD", "-o", "json"], code=0)
    pair.run(["import", str(src / "missing.shp")])
    pair.run(["import", str(tmp_path / "nothing.zip")])
    pair.run(["log", "-o", "json"], code=0)


def test_init_import(tmp_path):
    layer = synth_sources.point_layer(300, 9)
    os.makedirs(tmp_path / "src")
    shp = synth_sources.write_point_shapefile(str(tmp_path / "src" / "points"), layer)
    got = []
    for run, name in ((kart, "k"), (port, "p")):
        repo = str(tmp_path / name / "repo")
        got.append([masked(run(["init", "--import", shp, repo]), repo),
                    masked(run(["-C", repo, "log", "-o", "json"]), repo)])
    assert got[1] == got[0] and got[1][0][0] == 0
