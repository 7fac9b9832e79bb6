"""The port's FlatGeobuf import source against kart_tpu's, on the CPU:
files built with ``tests/test_flatgeobuf.py``'s flatbuffers writer (every
geometry type, parts and ``ends``, Z and M, every property type, the packed
R-tree, CRS by code and by WKT, a primary-key column, name collisions) and
with ``kart_tpu_torch.synth_sources``, and the imports through both CLIs.
Held with no tolerance: schemas (column ids), CRS definitions, features
and their WKB, errors, commits, output and the working copy's rows."""

import struct

import pytest

from kart_tpu.importer.flatgeobuf import packed_rtree_size as j_rtree_size
from kart_tpu_torch import synth_sources
from kart_tpu_torch.importer.flatgeobuf import FlatGeobufImportSource
from kart_tpu_torch.importer.flatgeobuf import packed_rtree_size as t_rtree_size
from test_flatgeobuf import (
    column,
    point,
    props,
    string_,
    table_vector_,
    vector_,
    write_fgb,
)
from test_torch_shapefile import _same_source
from test_torch_workingcopy import Pair

DATE = "1700000000 +0000"


@pytest.fixture(autouse=True)
def _pinned_dates(monkeypatch):
    monkeypatch.setenv("GIT_AUTHOR_DATE", DATE)
    monkeypatch.setenv("GIT_COMMITTER_DATE", DATE)


def _geom(gtype, xy, ends=None, z=None, m=None, parts=None):
    fields = {6: ("i", "<B", gtype)}
    if xy is not None:
        fields[1] = ("o", vector_("<d", xy))
    if ends:
        fields[0] = ("o", vector_("<I", ends))
    if z is not None:
        fields[2] = ("o", vector_("<d", z))
    if m is not None:
        fields[3] = ("o", vector_("<d", m))
    if parts:
        fields[7] = ("o", table_vector_(parts))
    return fields


RING = [0.0, 0.0, 4.0, 0.0, 4.0, 4.0, 0.0, 0.0]
HOLE = [1.0, 1.0, 2.0, 1.0, 2.0, 2.0, 1.0, 1.0]
RING2 = [10.0, 10.0, 12.0, 10.0, 12.0, 12.0, 10.0, 10.0]
EVERY_TYPE = [column(f"c{t}", t) for t in range(15)]
EVERY_VALUE = props([(0, 0, -5), (1, 1, 250), (2, 2, 1), (3, 3, -300), (4, 4, 60000),
                     (5, 5, -70000), (6, 6, 4000000000), (7, 7, -2**40), (8, 8, 2**63),
                     (9, 9, 1.5), (10, 10, -0.1), (11, 11, "tē"), (12, 12, '{"a": 1}'),
                     (13, 13, "2020-01-02T03:04:05Z"), (14, 14, b"\x00\x01")])
EPSG = {0: ("o", string_("EPSG")), 1: ("i", "<i", 4326)}

CASES = {
    "points": dict(name="buildings", columns=[column("name", 11), column("height", 10)],
                   features=[(point(174.78, -41.29), props([(0, 11, "te aro"), (1, 10, 12.5)])),
                             (None, props([(0, 11, "no geom")])), (point(1, 2), b"")]),
    "every_property_type": dict(columns=EVERY_TYPE,
                                features=[(point(0, 0), EVERY_VALUE), (point(1, 1), b"")]),
    "primary_key": dict(columns=[column("code", 7, primary_key=True), column("label", 11)],
                        features=[(point(1, 2), props([(0, 7, 42), (1, 11, "a")])),
                                  (point(3, 4), props([(0, 7, 43), (1, 11, "b")]))]),
    "two_primary_keys": dict(columns=[column("a", 7, primary_key=True),
                                      column("b", 7, primary_key=True)],
                             features=[(point(1, 2), props([(0, 7, 1), (1, 7, 2)]))]),
    "indexed": dict(columns=[column("n", 5)], index_node_size=16,
                    features=[(point(10 + i, 20), props([(0, 5, i)])) for i in range(40)]),
    "indexed_node_2": dict(index_node_size=2, features=[(point(i, i), b"") for i in range(9)]),
    "crs_code": dict(crs=EPSG, features=[(point(0, 0), b"")]),
    "crs_wkt": dict(crs={0: ("o", string_("EPSG")), 1: ("i", "<i", 2193),
                         4: ("o", string_('PROJCS["x",GEOGCS["y"]]'))},
                    features=[(point(0, 0), b"")]),
    "crs_unknown_code": dict(crs={0: ("o", string_("EPSG")), 1: ("i", "<i", 999999)},
                             features=[(point(0, 0), b"")]),
    "crs_other_org": dict(crs={0: ("o", string_("ESRI")), 1: ("i", "<i", 102100)},
                          features=[(point(0, 0), b"")]),
    "linestring_ends": dict(geometry_type=2, features=[
        (_geom(2, [0.0, 0.0, 1.0, 1.0, 2.0, 0.0], ends=[3]), b"")]),
    "polygon_with_hole": dict(geometry_type=3, features=[
        (_geom(3, RING + HOLE, ends=[4, 8]), b""), (_geom(3, RING), b"")]),
    "multipolygon_parts": dict(geometry_type=6, features=[
        (_geom(6, None, parts=[_geom(3, RING + HOLE, ends=[4, 8]), _geom(3, RING2)]), b"")]),
    "multilinestring_flat": dict(geometry_type=5, features=[
        (_geom(5, [0.0, 0.0, 1.0, 1.0, 5.0, 5.0, 6.0, 6.0], ends=[2, 4]), b"")]),
    "multilinestring_parts": dict(geometry_type=5, features=[
        (_geom(5, None, parts=[_geom(2, [0.0, 0.0, 1.0, 1.0]),
                               _geom(2, [2.0, 2.0, 3.0, 3.0])]), b"")]),
    "multipoint_flat": dict(geometry_type=4, features=[(_geom(4, [1.0, 2.0, 3.0, 4.0]), b"")]),
    "collection": dict(geometry_type=7, features=[
        (_geom(7, None, parts=[_geom(1, [1.0, 2.0]), _geom(2, [0.0, 0.0, 1.0, 1.0])]), b"")]),
    "multipolygon_without_parts": dict(geometry_type=6, features=[(_geom(6, RING), b"")]),
    "unknown_geometry_type": dict(geometry_type=0, columns=[column("n", 5)],
                                  features=[(point(7, 8), props([(0, 5, 1)])),
                                            (_geom(2, [0.0, 0.0, 1.0, 1.0]), b"")]),
    "bad_geometry_type": dict(features=[(_geom(42, [0.0, 0.0]), b"")]),
    "z": dict(has_z=True, features=[(_geom(1, [1.0, 2.0], z=[9.5], m=[4.25]), b""),
                                    (_geom(1, [3.0, 4.0]), b"")]),
    "polygon_z": dict(geometry_type=3, has_z=True, features=[
        (_geom(3, RING, z=[1.0, 2.0, 3.0, 4.0]), b"")]),
    "fid_and_geom_collisions": dict(columns=[column("FID", 5), column("geom", 11),
                                             column("FID_1", 5)],
                                    features=[(point(0, 0), props([(0, 5, 99), (1, 11, "g")]))]),
    "empty": dict(features=[]),
    "count_zero_in_header": dict(features_count=0, features=[(point(5, 6), b"")]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sources(tmp_path, name):
    path = write_fgb(tmp_path / f"{name}.fgb", **CASES[name])
    _same_source(path)


@pytest.mark.parametrize("raw", [b"not a flatgeobuf", b"fgb\x03fgb\x01",
                                 b"fgb\x02fgb\x00" + b"\x00" * 8])
def test_bad_files(tmp_path, raw):
    path = tmp_path / "junk.fgb"
    path.write_bytes(raw)
    _same_source(str(path))


def test_patch_level_byte(tmp_path):
    path = write_fgb(tmp_path / "p.fgb", features=[(point(5, 6), b"")])
    raw = bytearray(open(path, "rb").read())
    raw[7] = 0x01
    open(path, "wb").write(bytes(raw))
    _same_source(path)


@pytest.mark.parametrize("n", [0, 1, 2, 15, 16, 17, 255, 1000, 65537])
@pytest.mark.parametrize("node", [0, 1, 2, 16, 64])
def test_packed_rtree_size(n, node):
    assert t_rtree_size(n, node) == j_rtree_size(n, node)


def test_seeded_layer_with_and_without_its_index(tmp_path):
    layer = synth_sources.point_layer(500, 7)
    indexed = synth_sources.write_point_flatgeobuf(str(tmp_path / "a.fgb"), layer,
                                                   index_node_size=16)
    plain = synth_sources.write_point_flatgeobuf(str(tmp_path / "b.fgb"), layer)
    got = _same_source(indexed)
    assert len(got[-1]) == 500 - sum(layer["deleted"])
    assert _same_source(plain)[-1] == got[-1]
    assert (list(FlatGeobufImportSource(indexed).features())
            == list(FlatGeobufImportSource(plain).features()))


def test_imports_through_the_cli(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    layer = synth_sources.point_layer(200, 8)
    fgb = synth_sources.write_point_flatgeobuf(str(src / "pts.fgb"), layer, name="pts",
                                               index_node_size=16)
    shapes = write_fgb(src / "shapes.fgb", name="shapes", geometry_type=6, crs=EPSG,
                       columns=[column("code", 7, primary_key=True)],
                       features=[(_geom(6, None, parts=[_geom(3, RING + HOLE, ends=[4, 8])]),
                                  props([(0, 7, i)])) for i in range(1, 4)])
    pair = Pair(tmp_path, [])
    pair.run(["import", fgb], code=0)
    pair.run(["import", shapes, "--dest-path", "nested/shapes"], code=0)
    edited, _ = synth_sources.edited_point_layer(layer, 9, moved=0.05, deleted=0.02,
                                                 inserted=0.02)
    synth_sources.write_point_flatgeobuf(fgb, edited, name="pts")
    pair.run(["import", fgb, "--replace-existing"], code=0)
    pair.run(["diff", "HEAD^...HEAD", "-o", "json"], code=0)
    pair.run(["status", "-o", "json"], code=0)
    pair.run(["import", str(src / "missing.fgb")])
