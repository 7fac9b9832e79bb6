"""GeoJSON in the port's ``geometry`` against kart_tpu's: ``to_geojson``,
``to_coords`` and ``geojson_to_geometry`` over every geometry type, with
Z, M, ZM and empty geometries (hypothesis), give the same JSON and the
same GeoPackage bytes; reprojection (``diff.output.reproject_geometry``)
gives the same bytes too."""

import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from kart_tpu import geometry as jgeom
from kart_tpu.crs import Transform as JTransform
from kart_tpu.diff.output import reproject_geometry as jreproject
from kart_tpu_torch import geometry as tgeom
from kart_tpu_torch.crs import Transform as TTransform
from kart_tpu_torch.diff.output import reproject_geometry as treproject

coord = st.floats(min_value=-1e6, max_value=1e6, allow_nan=False, allow_infinity=False)


def _pt(dim):
    return st.tuples(*([coord] * dim))


@st.composite
def geom_values(draw, depth=0):
    """kart_tpu GeomValues of every type (a collection nests one level)."""
    has_z, has_m = draw(st.booleans()), draw(st.booleans())
    dim = 2 + has_z + has_m
    kinds = ["Point", "LineString", "Polygon", "MultiPoint", "MultiLineString", "MultiPolygon"]
    if depth == 0:
        kinds.append("GeometryCollection")
    kind = draw(st.sampled_from(kinds))
    v = jgeom._geom_value

    def ring():
        return draw(st.lists(_pt(dim), max_size=5))

    if kind == "Point":
        return v(kind, has_z, has_m, draw(st.one_of(st.none(), _pt(dim))))
    if kind == "LineString":
        return v(kind, has_z, has_m, ring())
    if kind == "Polygon":
        return v(kind, has_z, has_m, [ring() for _ in range(draw(st.integers(0, 2)))])
    if kind == "MultiPoint":
        return v(kind, has_z, has_m, [v("Point", has_z, has_m, draw(_pt(dim)))
                                      for _ in range(draw(st.integers(0, 3)))])
    if kind == "MultiLineString":
        return v(kind, has_z, has_m, [v("LineString", has_z, has_m, ring())
                                      for _ in range(draw(st.integers(0, 3)))])
    if kind == "MultiPolygon":
        return v(kind, has_z, has_m, [
            v("Polygon", has_z, has_m, [ring() for _ in range(draw(st.integers(0, 2)))])
            for _ in range(draw(st.integers(0, 2)))])
    children = []
    for _ in range(draw(st.integers(0, 3))):
        child = draw(geom_values(depth=1))
        children.append(v(child[0], has_z, has_m, _with_dim(child, has_z, has_m)))
    return v(kind, has_z, has_m, children)


def _with_dim(value, has_z, has_m):
    """A child's payload re-cut to the collection's dimensions."""
    dim = 2 + has_z + has_m

    def fix(p):
        return tuple(p[:dim]) + (0.0,) * (dim - len(p))

    name, _, _, payload = value
    base = value.base_type
    if base == 1:
        return None if payload is None else fix(payload)
    if base == 2:
        return [fix(p) for p in payload]
    if base == 3:
        return [[fix(p) for p in r] for r in payload]
    return [jgeom._geom_value(c[0], has_z, has_m, _with_dim(c, has_z, has_m)) for c in payload]


def _both(value):
    wkb = jgeom.write_wkb(value)
    return jgeom.Geometry.from_wkb(wkb), tgeom.Geometry.from_wkb(wkb)


@settings(max_examples=300, deadline=None)
@given(geom_values())
def test_to_geojson_and_back_match_kart_tpu(value):
    wkb = jgeom.write_wkb(value)
    try:
        jg = jgeom.Geometry.from_wkb(wkb)
    except ValueError as e:  # parts with no point at all: no envelope
        with pytest.raises(type(e)):
            tgeom.Geometry.from_wkb(wkb)
        return
    tg = tgeom.Geometry.from_wkb(wkb)
    assert bytes(tg) == bytes(jg)
    gj = tg.to_geojson()
    assert json.dumps(gj) == json.dumps(jg.to_geojson())
    assert tuple(tg.to_coords()) == tuple(jg.to_coords())
    for obj in (gj, json.dumps(gj)):
        assert _built(tgeom, obj) == _built(jgeom, obj)
    assert _built(tgeom, gj, 4326) == _built(jgeom, gj, 4326)


def _built(mod, obj, crs_id=0):
    """geojson_to_geometry's bytes, or the error it raises: both packages
    refuse alike a geometry with parts but no point (no envelope) and one
    whose first ring is empty (its Z is read from that ring)."""
    try:
        return bytes(mod.geojson_to_geometry(obj, crs_id=crs_id))
    except (ValueError, IndexError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("wkt", [
    "POINT EMPTY", "POINT Z (1 2 3)", "POINT M (1 2 4)", "POINT ZM (1 2 3 4)",
    "LINESTRING EMPTY", "LINESTRING ZM (0 0 1 2,1 1 3 4)", "POLYGON EMPTY",
    "POLYGON Z ((0 0 1,1 0 1,1 1 1,0 0 1))", "MULTIPOINT M ((1 2 3),(4 5 6))",
    "MULTILINESTRING EMPTY", "MULTIPOLYGON Z (((0 0 0,1 0 0,1 1 0,0 0 0)))",
    "GEOMETRYCOLLECTION EMPTY", "GEOMETRYCOLLECTION (POINT (1 2),LINESTRING (0 0,1 1))",
])
def test_named_geometries_match_kart_tpu(wkt):
    jg, tg = jgeom.Geometry.from_wkt(wkt), tgeom.Geometry.from_wkt(wkt)
    assert bytes(tg) == bytes(jg)
    assert tg.to_geojson() == jg.to_geojson()
    assert bytes(tgeom.geojson_to_geometry(tg.to_geojson())) == bytes(
        jgeom.geojson_to_geometry(jg.to_geojson()))


def test_unsupported_geojson_type_raises_like_kart_tpu():
    for mod in (jgeom, tgeom):
        with pytest.raises(mod.GeometryError, match="Unsupported GeoJSON geometry type"):
            mod.geojson_to_geometry({"type": "Circle", "coordinates": [0, 0]})


lonlat = st.tuples(st.floats(-179, 179), st.floats(-85, 85))


@settings(max_examples=100, deadline=None)
@given(st.lists(lonlat, min_size=1, max_size=6), st.sampled_from(["EPSG:4277", "EPSG:4167"]),
       st.sampled_from(["Point", "LineString", "MultiPoint", "Polygon"]))
def test_reprojection_matches_kart_tpu(points, target, kind):
    v = jgeom._geom_value
    if kind == "Point":
        value = v(kind, False, False, points[0])
    elif kind == "LineString":
        value = v(kind, False, False, points)
    elif kind == "MultiPoint":
        value = v(kind, False, False, [v("Point", False, False, p) for p in points])
    else:
        value = v(kind, False, False, [points + [points[0]]])
    jg, tg = _both(value)
    got = treproject(tg, TTransform("EPSG:4326", target))
    want = jreproject(jg, JTransform("EPSG:4326", target))
    assert bytes(got) == bytes(want)
