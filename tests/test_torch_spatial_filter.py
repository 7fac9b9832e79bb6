"""The client half of the spatial filter, held to kart_tpu with zero
tolerance: CRSes and their transforms (geographic and projected), WKT and hex-WKB
geometries and their envelopes, filter specs, and the exact match verdicts
of ``SpatialFilter``; plus the write half of the sidecar's vertex column
(the KTB2 stream codec and ``encode_vertex_column``), byte for byte.

Cases are made from seeds with numpy, and with hypothesis."""

import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from kart_tpu import crs as jcrs
from kart_tpu import epsg as jepsg
from kart_tpu import geom as jgeom
from kart_tpu import geometry as jgeometry
from kart_tpu import spatial_filter as jsf
from kart_tpu.tiles import streams as jstreams
from kart_tpu_torch import crs as tcrs
from kart_tpu_torch import epsg as tepsg
from kart_tpu_torch import geom as tgeom
from kart_tpu_torch import geometry as tgeometry
from kart_tpu_torch import spatial_filter as tsf
from kart_tpu_torch.tiles import streams as tstreams

GEOGRAPHIC_CODES = sorted(tepsg.GEOGRAPHIC)
PROJECTED_CODES = [2193, 3857, 27700, 32633, 32760, 25832, 7855]


def _outcome(fn, *args, **kwargs):
    """-> ("ok", value) or ("error", type name, message)."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # the type and message are what is compared
        return ("error", type(e).__name__, str(e))


# -- CRSes -------------------------------------------------------------------


def test_geographic_registry_matches():
    assert tepsg.GEOGRAPHIC == jepsg.GEOGRAPHIC
    assert tepsg.ELLIPSOIDS == jepsg.ELLIPSOIDS
    assert tepsg.PROJECTED == jepsg.PROJECTED
    assert tepsg.UTM_FAMILIES == jepsg.UTM_FAMILIES
    assert tepsg.registry_summary() == jepsg.registry_summary()


def _crs_facts(crs):
    return (crs.wkt, crs.is_geographic, crs.is_projected, crs.name, crs.authority, crs.code,
            crs.semi_major, crs.inv_flattening, crs.towgs84, crs.datum_name,
            crs.identifier_str, crs.identifier_int, tcrs.normalise_wkt(crs.wkt))


@pytest.mark.parametrize("code", GEOGRAPHIC_CODES)
def test_make_crs_epsg_geographic(code):
    assert tepsg.epsg_wkt(code) == jepsg.epsg_wkt(code)
    assert tepsg.geographic_wkt(code) == jepsg.geographic_wkt(code)
    t, j = tcrs.make_crs(f"EPSG:{code}"), jcrs.make_crs(f"epsg:{code}")
    assert t.is_geographic
    assert _crs_facts(t) == _crs_facts(j)
    assert tcrs.normalise_wkt(t.wkt) == jcrs.normalise_wkt(j.wkt)


def test_crs_equality_matrix():
    codes = GEOGRAPHIC_CODES
    t = [tcrs.make_crs(f"EPSG:{c}") for c in codes]
    j = [jcrs.make_crs(f"EPSG:{c}") for c in codes]
    for a in range(len(codes)):
        for b in range(len(codes)):
            assert (t[a] == t[b]) == (j[a] == j[b]), (codes[a], codes[b])
    # the three spellings of WGS 84, as kart_tpu sees them
    for wkt in (tepsg.epsg_wkt(4326), tsf.EPSG_4326_WKT, tcrs.WGS84_WKT):
        assert tsf.EPSG_4326_WKT == jsf.EPSG_4326_WKT
        tw, jw = tcrs.CRS(wkt), jcrs.CRS(wkt)
        assert (tcrs.make_crs("EPSG:4326") == tw) == (jcrs.make_crs("EPSG:4326") == jw)
    assert tcrs.make_crs("EPSG:4326") == tcrs.CRS(tepsg.epsg_wkt(4326))
    assert tcrs.make_crs("EPSG:4326") != tcrs.CRS(tsf.EPSG_4326_WKT)


RAW_WKT = [
    tcrs.WGS84_WKT,
    tcrs.NZGD2000_WKT,
    tcrs.WGS84_WKT.replace(",", ", ").replace("[", " [ "),
    'GEOGCS["no authority",DATUM["D",SPHEROID["S",6378137,298.257223563]],'
    'PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433]]',
    'GEOGCRS["WGS 84",DATUM["World Geodetic System 1984",ELLIPSOID["WGS 84",6378137,'
    '298.257223563]],CS[ellipsoidal,2],AXIS["latitude",north],AXIS["longitude",east],'
    'ANGLEUNIT["degree",0.0174532925199433],ID["EPSG",4326]]',
    'GEOGCS["sphere",DATUM["S",SPHEROID["S",6371000,0]],PRIMEM["Greenwich",0],'
    'UNIT["degree",0.0174532925199433],AUTHORITY["EPSG","4035"]]',
    jepsg.epsg_wkt(2193),
    jepsg.epsg_wkt(32760),
]


@pytest.mark.parametrize("i", range(len(RAW_WKT)))
def test_raw_wkt_crs(i):
    wkt = RAW_WKT[i]
    t, j = tcrs.make_crs(wkt), jcrs.make_crs(wkt)
    assert _crs_facts(t) == _crs_facts(j)
    assert t.projection == j.projection
    assert tcrs.get_identifier_str(wkt) == jcrs.get_identifier_str(wkt)
    assert tcrs.get_identifier_int(wkt) == jcrs.get_identifier_int(wkt)
    assert tcrs.get_authority(wkt) == jcrs.get_authority(wkt)
    for other in RAW_WKT:
        assert (t == tcrs.CRS(other)) == (j == jcrs.CRS(other))


@pytest.mark.parametrize("spec", ["EPSG:999999", "EPSG:1", "", "   ", "nonsense", "GEOGCS["])
def test_make_crs_errors_match(spec):
    t, j = _outcome(tcrs.make_crs, spec), _outcome(jcrs.make_crs, spec)
    if j[0] == "ok":
        assert t[0] == "ok" and _crs_facts(t[1]) == _crs_facts(j[1])
    else:
        assert t == j


@pytest.mark.parametrize("code", PROJECTED_CODES)
def test_projected_codes_not_ported(code):
    """A projected registry code: the same WKT and CRS facts as kart_tpu,
    and bit-identical transforms both ways between it and EPSG:4326 (the
    name is kept from when the port refused these codes)."""
    t, j = tcrs.make_crs(f"EPSG:{code}"), jcrs.make_crs(f"EPSG:{code}")
    assert t.is_projected and t.wkt == j.wkt
    assert tepsg.epsg_wkt(code) == jepsg.epsg_wkt(code)
    # 2193 and 3857 resolve to the curated WKTs before the registry
    assert (t.wkt == tepsg.epsg_wkt(code)) == (code not in (2193, 3857))
    assert _crs_facts(t) == _crs_facts(j)
    assert (t.projection, t.params) == (j.projection, j.params)
    geo_t, geo_j = tcrs.make_crs("EPSG:4326"), jcrs.make_crs("EPSG:4326")
    rng = np.random.default_rng(code)
    lon = rng.uniform(-180, 180, 400)
    lat = rng.uniform(-80, 80, 400)
    fwd_t, fwd_j = tcrs.Transform(geo_t, t), jcrs.Transform(geo_j, j)
    xs, ys = fwd_j.transform(lon, lat)
    for a, b in zip(fwd_t.transform(lon, lat), (xs, ys)):
        assert a.tobytes() == b.tobytes()
    finite = np.isfinite(xs) & np.isfinite(ys)
    inv_t, inv_j = tcrs.Transform(t, geo_t), jcrs.Transform(j, geo_j)
    for a, b in zip(inv_t.transform(xs[finite], ys[finite]),
                    inv_j.transform(xs[finite], ys[finite])):
        assert a.tobytes() == b.tobytes()


PAIRS = [(4326, 4167), (4167, 4326), (4326, 4272), (4272, 4326), (4277, 4326), (4267, 4230),
         (4322, 4301), (4326, 4326), (4283, 7844), (4202, 4618)]


@pytest.mark.parametrize("src,dst", PAIRS)
def test_geographic_transforms_bit_identical(src, dst):
    rng = np.random.default_rng(src * 7 + dst)
    xs = rng.uniform(-180, 180, 500)
    ys = rng.uniform(-89, 89, 500)
    t = tcrs.Transform(tcrs.make_crs(f"EPSG:{src}"), tcrs.make_crs(f"EPSG:{dst}"))
    j = jcrs.Transform(jcrs.make_crs(f"EPSG:{src}"), jcrs.make_crs(f"EPSG:{dst}"))
    assert t.is_identity == j.is_identity
    for a, b in zip(t.transform(xs, ys), j.transform(xs, ys)):
        assert np.array_equal(a, b)
    env = (float(xs.min()), float(xs.max()), float(ys.min()), float(ys.max()))
    assert t.transform_envelope(env) == j.transform_envelope(env)


# -- geometries --------------------------------------------------------------

WKT_CASES = [
    "POINT (1 2)",
    "POINT(-179.5 89.25)",
    "POINT Z (1 2 3)",
    "POINT (1 2 3)",
    "POINT M (1 2 4)",
    "POINT ZM (1 2 3 4)",
    "POINT EMPTY",
    "LINESTRING (0 0, 10 10, 20 -5)",
    "LINESTRING EMPTY",
    "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0))",
    "POLYGON ((-50 -50, 50 -50, 50 50, -50 50, -50 -50), (-20 -20, 20 -20, 20 20, -20 20, -20 -20))",
    "POLYGON Z ((0 0 1, 10 0 2, 10 10 3, 0 0 1))",
    "POLYGON EMPTY",
    "MULTIPOINT (1 2, 3 4)",
    "MULTIPOINT ((1 2), (3 4))",
    "MULTILINESTRING ((0 0, 1 1), (2 2, 3 3, 4 5))",
    "MULTIPOLYGON (((0 0, 1 0, 1 1, 0 0)), ((5 5, 6 5, 6 6, 5 5), (5.2 5.1, 5.8 5.1, 5.8 5.5, 5.2 5.1)))",
    "MULTIPOLYGON EMPTY",
    "GEOMETRYCOLLECTION (POINT (1 2), LINESTRING (0 0, 3 3), POLYGON ((0 0, 1 0, 1 1, 0 0)))",
    "GEOMETRYCOLLECTION EMPTY",
    "  polygon((0 0,1e2 0,1E2 -1.5e1,0 0))  ",
]

BAD_INPUT = [
    "", "   ", "POINT(1 2", "FOO(1 2)", "zz", "0101", "POLYGON((0 0,1 1)", "POINT()",
    "MULTIPOLYGON(((0 0,1 0,1 1,0 0))", "LINESTRING(1 2,3 4)", "POINT(1 2)", "POLYGON EMPTY",
    "GEOMETRYCOLLECTION(POINT(1 2))", "0000000001", "01030000000100000004000000",
    "POINT(1 a)", "POINT(1 2) trailing", "010100000000000000000000f03f",
]


@pytest.mark.parametrize("i", range(len(WKT_CASES)))
def test_wkt_round_trip_and_envelope(i):
    wkt = WKT_CASES[i]
    t, j = tgeometry.Geometry.from_wkt(wkt), jgeometry.Geometry.from_wkt(wkt)
    assert bytes(t) == bytes(j)
    assert tgeometry.parse_wkt(wkt) == jgeometry.parse_wkt(wkt)
    assert t.to_wkt() == j.to_wkt()
    assert tgeometry.write_wkt(tgeometry.parse_wkt(wkt)) == jgeometry.write_wkt(
        jgeometry.parse_wkt(wkt))
    for only_xy in (True, False):
        assert t.envelope(only_xy) == j.envelope(only_xy)
    assert (t.geometry_type, t.geometry_type_name, t.is_empty) == (
        j.geometry_type, j.geometry_type_name, j.is_empty)
    hex_wkb = j.to_hex_wkb()
    assert bytes(tgeometry.Geometry.from_hex_wkb(hex_wkb)) == bytes(
        jgeometry.Geometry.from_hex_wkb(hex_wkb))
    assert tgeometry.wkb_envelope(j.to_wkb()) == jgeometry.wkb_envelope(j.to_wkb())
    for text in (wkt, hex_wkb, hex_wkb.lower()):
        for kwargs in ({}, {"allow_empty": True},
                       {"allowed_types": (tgeometry.POLYGON, tgeometry.MULTIPOLYGON)}):
            got = _outcome(tgeometry.Geometry.from_string, text, **kwargs)
            want = _outcome(jgeometry.Geometry.from_string, text, **kwargs)
            assert got[:1] == want[:1]
            assert (bytes(got[1]) == bytes(want[1])) if got[0] == "ok" else got == want


@pytest.mark.parametrize("text", BAD_INPUT)
def test_malformed_geometry_same_error(text):
    for kwargs in ({}, {"allowed_types": (tgeometry.POLYGON, tgeometry.MULTIPOLYGON)}):
        got = _outcome(tgeometry.Geometry.from_string, text, **kwargs)
        want = _outcome(jgeometry.Geometry.from_string, text, **kwargs)
        if want[0] == "ok":
            assert got[0] == "ok" and bytes(got[1]) == bytes(want[1])
        else:
            assert got == want


def _gpkg_with_envelope(wkb, env):
    """GeoPackage bytes with an explicit XY envelope header (which may wrap
    the anti-meridian: min-x > max-x)."""
    return b"GP\x00\x03" + struct.pack("<i", 4326) + struct.pack("<4d", *env) + wkb


def _rand_coords(rng, n, grid):
    if grid:
        return rng.integers(-16, 17, size=(n, 2)).astype(np.float64) * 5.0
    return rng.uniform(-80, 80, size=(n, 2))


def _fmt(pts):
    return ", ".join(f"{float(x)!r} {float(y)!r}" for x, y in pts)


def _random_wkt(rng):
    """A random point, line, polygon (maybe with a hole), multi geometry or
    collection; half of them on a 5-degree grid, where vertices and edges
    fall on the filters' boundaries."""
    grid = bool(rng.integers(2))
    kind = int(rng.integers(6))
    if kind == 0:
        return f"POINT ({_fmt(_rand_coords(rng, 1, grid))})"
    if kind == 1:
        return f"LINESTRING ({_fmt(_rand_coords(rng, int(rng.integers(2, 6)), grid))})"
    if kind in (2, 3):
        cx, cy = _rand_coords(rng, 1, grid)[0]
        r = float(rng.choice([2.5, 5.0, 20.0, 45.0, 150.0]))
        outer = [(cx - r, cy - r), (cx + r, cy - r), (cx + r, cy + r), (cx - r, cy + r),
                 (cx - r, cy - r)]
        rings = [f"({_fmt(outer)})"]
        if kind == 3:
            h = r / 2
            rings.append(f"({_fmt([(cx - h, cy - h), (cx + h, cy - h), (cx, cy + h), (cx - h, cy - h)])})")
        return f"POLYGON ({', '.join(rings)})"
    if kind == 4:
        pts = _rand_coords(rng, int(rng.integers(1, 4)), grid)
        return f"MULTIPOINT ({_fmt(pts)})"
    return (f"GEOMETRYCOLLECTION (POINT ({_fmt(_rand_coords(rng, 1, grid))}), "
            f"LINESTRING ({_fmt(_rand_coords(rng, 2, grid))}))")


def test_random_geometries_match():
    rng = np.random.default_rng(11)
    for _ in range(300):
        wkt = _random_wkt(rng)
        t, j = tgeometry.Geometry.from_wkt(wkt), jgeometry.Geometry.from_wkt(wkt)
        assert bytes(t) == bytes(j), wkt
        assert t.envelope() == j.envelope() and t.to_wkt() == j.to_wkt(), wkt


# -- filter specs ------------------------------------------------------------

FILTERS = {
    "rect": "EPSG:4326;POLYGON((-60 -30,60 -30,60 30,-60 30,-60 -30))",
    "pentagon": "EPSG:4326;POLYGON((0 -40,40 -10,25 35,-25 35,-40 -10,0 -40))",
    "holed": "EPSG:4326;POLYGON((-50 -50,50 -50,50 50,-50 50,-50 -50),"
             "(-20 -20,20 -20,20 20,-20 20,-20 -20))",
    "multi": "EPSG:4326;MULTIPOLYGON(((-170 -10,-150 -10,-150 10,-170 10,-170 -10)),"
             "((150 -10,170 -10,170 10,150 10,150 -10)))",
    "nzgd2000": "EPSG:4167;POLYGON((165 -48,179 -48,179 -34,165 -34,165 -48))",
    "hexwkb": "EPSG:4326;" + jgeometry.Geometry.from_wkt(
        "POLYGON((10 10,30 10,30 30,10 30,10 10))").to_hex_wkb(),
}

BAD_SPECS = [
    "POLYGON((0 0,1 0,1 1,0 0))",
    "EPSG:4326;LINESTRING(0 0,1 1)",
    "EPSG:4326;POLYGON((0 0,1 0",
    "EPSG:4326;POLYGON EMPTY",
    "EPSG:999999;POLYGON((0 0,1 0,1 1,0 0))",
    "@/nonexistent/filter.txt",
]


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_spec_envelopes_and_config(name):
    t = tsf.ResolvedSpatialFilterSpec.from_spec_string(FILTERS[name])
    j = jsf.ResolvedSpatialFilterSpec.from_spec_string(FILTERS[name])
    assert not t.match_all
    assert bytes(t.geometry) == bytes(j.geometry)
    assert t.envelope_native == j.envelope_native
    assert t.envelope_wsen_4326 == j.envelope_wsen_4326
    assert t.config_items() == j.config_items()
    assert t.crs == tcrs.make_crs(t.crs_spec)


@pytest.mark.parametrize("text", BAD_SPECS)
def test_bad_spec_same_error(text):
    got = _outcome(tsf.ResolvedSpatialFilterSpec.from_spec_string, text)
    want = _outcome(jsf.ResolvedSpatialFilterSpec.from_spec_string, text)
    assert got[0] == want[0] == "error"
    assert got == want


@pytest.mark.parametrize("text", [None, "", "none"])
def test_match_all_spec(text):
    assert tsf.ResolvedSpatialFilterSpec.from_spec_string(text).match_all
    assert tsf.ResolvedSpatialFilterSpec.from_spec_string(text).resolve_for_dataset(None) is (
        tsf.SpatialFilter.MATCH_ALL)


@pytest.mark.parametrize("code", [2193, 3857])
def test_projected_filter_crs_not_ported(code):
    """A filter in a projected CRS resolves as in kart_tpu: the same
    geometry, native and EPSG:4326 envelopes, wire argument and config (the
    name is kept from when the port refused it)."""
    text = f"EPSG:{code};POLYGON((1000 1000,2000 1000,2000 2000,1000 2000,1000 1000))"
    t = tsf.ResolvedSpatialFilterSpec.from_spec_string(text)
    j = jsf.ResolvedSpatialFilterSpec.from_spec_string(text)
    assert not t.match_all and t.crs.is_projected
    assert bytes(t.geometry) == bytes(j.geometry)
    assert t.envelope_native == j.envelope_native
    assert t.envelope_wsen_4326 == j.envelope_wsen_4326
    assert t.filter_arg == j.filter_arg
    assert t.config_items() == j.config_items()
    assert t.crs == tcrs.make_crs(t.crs_spec)


# -- match verdicts ----------------------------------------------------------


class _Dataset:
    """What SpatialFilter.for_dataset reads of a dataset."""

    def __init__(self, crs_wkt, geom_column="geom"):
        self.path = "ds"
        self.geom_column_name = geom_column
        self._crs_wkt = crs_wkt

    def crs_identifiers(self):
        return ["EPSG:x"] if self._crs_wkt else []

    def get_crs_definition(self, identifier=None):
        return self._crs_wkt


DATASET_CRSES = [4326, 4167, 4272, None]


def _filters(name, ds_code):
    wkt = jepsg.epsg_wkt(ds_code) if ds_code else None
    t = tsf.ResolvedSpatialFilterSpec.from_spec_string(FILTERS[name]).resolve_for_dataset(
        _Dataset(wkt))
    j = jsf.ResolvedSpatialFilterSpec.from_spec_string(FILTERS[name]).resolve_for_dataset(
        _Dataset(wkt))
    assert t.rect == j.rect
    assert (t.polygon_parts is None) == (j.polygon_parts is None)
    for (to, th), (jo, jh) in zip(t.polygon_parts or (), j.polygon_parts or ()):
        assert np.array_equal(to, jo) and len(th) == len(jh)
        assert all(np.array_equal(a, b) for a, b in zip(th, jh))
    return t, j


def _same_verdict(t, j, geom_bytes):
    tg = None if geom_bytes is None else tgeometry.Geometry(geom_bytes)
    jg = None if geom_bytes is None else jgeometry.Geometry(geom_bytes)
    got, want = t.match_geometry(tg), j.match_geometry(jg)
    assert got.value == want.value, geom_bytes
    return got.value


@pytest.mark.parametrize("ds_code", DATASET_CRSES)
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_match_geometry_generated(name, ds_code):
    t, j = _filters(name, ds_code)
    rng = np.random.default_rng([sorted(FILTERS).index(name), ds_code or 0])
    seen = set()
    for _ in range(150):
        g = jgeometry.Geometry.from_wkt(_random_wkt(rng))
        seen.add(_same_verdict(t, j, bytes(g)))
    for special in (None, "POINT EMPTY", "POLYGON EMPTY", "GEOMETRYCOLLECTION EMPTY"):
        g = None if special is None else bytes(jgeometry.Geometry.from_wkt(special))
        assert _same_verdict(t, j, g) == "matched"
    assert {"matched", "not-matched"} <= seen or ds_code is None or name == "nzgd2000"


def _filter_boundary_points(name):
    """Every vertex of the filter, the midpoint of every edge, and points a
    hair inside and outside of each."""
    geom = jsf.ResolvedSpatialFilterSpec.from_spec_string(FILTERS[name]).geometry
    parts = jsf._polygon_parts(geom)
    pts = []
    for outer, holes in parts:
        for ring in (outer, *holes):
            mids = (ring[:-1] + ring[1:]) / 2
            for p in np.concatenate([ring, mids]):
                for d in (0.0, 1e-9, -1e-9, 1e-12):
                    pts.append((p[0] + d, p[1] + d))
    return pts


@pytest.mark.parametrize("name", ["rect", "pentagon", "holed", "multi"])
def test_match_on_the_filter_boundary(name):
    t, j = _filters(name, 4326)
    verdicts = []
    for x, y in _filter_boundary_points(name):
        wkb = struct.pack("<BIdd", 1, 1, x, y)
        verdicts.append(_same_verdict(t, j, bytes(jgeometry.Geometry.from_wkb(wkb))))
        line = f"LINESTRING ({_fmt([(x, y), (x + 100, y + 100)])})"
        _same_verdict(t, j, bytes(jgeometry.Geometry.from_wkt(line)))
    assert "matched" in verdicts


ANTI_MERIDIAN_ENVS = [(170.0, -170.0, -5.0, 5.0), (179.0, -179.0, 50.0, 60.0),
                      (-10.0, 10.0, -5.0, 5.0), (175.0, 178.0, -1.0, 1.0)]


@pytest.mark.parametrize("rect", [(150.0, -150.0, -20.0, 20.0), (-60.0, 60.0, -30.0, 30.0),
                                  (160.0, 170.0, -10.0, 10.0)])
def test_anti_meridian_envelopes(rect):
    """Stored envelopes that wrap the anti-meridian, against rect filters
    that do and do not wrap it (the envelope-only branch) and against the
    polygon filters."""
    wkb = bytes(jgeometry.Geometry.from_wkt("LINESTRING (175 0, 185 1)").to_wkb())
    t = tsf.SpatialFilter(rect, "geom", None)
    j = jsf.SpatialFilter(rect, "geom", None)
    for env in ANTI_MERIDIAN_ENVS:
        data = _gpkg_with_envelope(wkb, env)
        assert tgeometry.Geometry(data).envelope() == jgeometry.Geometry(data).envelope()
        _same_verdict(t, j, data)
        for name in ("multi", "rect"):
            tf, jf = _filters(name, 4326)
            _same_verdict(tf, jf, data)


@settings(max_examples=200, deadline=None, derandomize=True)
@given(
    st.sampled_from(["rect", "pentagon", "holed", "multi"]),
    st.lists(st.tuples(st.floats(-200, 200), st.floats(-95, 95)), min_size=1, max_size=5),
)
def test_match_geometry_hypothesis(name, pts):
    t, j = _filters(name, 4326)
    kinds = ["MULTIPOINT (" + _fmt(pts) + ")"]
    if len(pts) >= 2:
        kinds.append("LINESTRING (" + _fmt(pts) + ")")
    if len(pts) >= 3:
        kinds.append("POLYGON ((" + _fmt(pts + [pts[0]]) + "))")
    for wkt in kinds:
        _same_verdict(t, j, bytes(jgeometry.Geometry.from_wkt(wkt)))


def test_non_spatial_dataset_matches_all():
    spec = tsf.ResolvedSpatialFilterSpec.from_spec_string(FILTERS["rect"])
    assert spec.resolve_for_dataset(_Dataset(None, geom_column=None)) is (
        tsf.SpatialFilter.MATCH_ALL)


# -- the vertex column's write half -------------------------------------------


def _columns(rng):
    n = 400
    return {
        "constant": np.full(n, 7, np.int64),
        "runs": np.repeat(rng.integers(-5, 5, 20), 20),
        "small": rng.integers(0, 9, n),
        "sorted": np.cumsum(rng.integers(0, 1000, n)),
        "wide": rng.integers(-(1 << 62), 1 << 62, n),
        "deltas": np.arange(n, dtype=np.int64) * 5 + rng.integers(0, 3, n),
        "one": np.asarray([12345], np.int64),
        "empty": np.zeros(0, np.int64),
        "coords": rng.integers(-18_000_000, 18_000_000, n),
    }


@pytest.mark.parametrize("col", sorted(_columns(np.random.default_rng(0))))
def test_encode_stream_matches(col):
    v = _columns(np.random.default_rng(3))[col]
    assert np.array_equal(tstreams.zigzag(v), jstreams.zigzag(v))
    codes = tstreams.zigzag(v)
    assert tstreams.varint_encode(codes) == jstreams.varint_encode(codes)
    for dtype in ("i8", "i4"):
        if dtype == "i4" and col == "wide":
            continue
        assert tstreams.encode_stream(v, dtype) == jstreams.encode_stream(v, dtype)
        for enc in range(5):
            assert tstreams.encode_stream(v, dtype, force=enc) == jstreams.encode_stream(
                v, dtype, force=enc)
    if len(v):
        w = tstreams.bit_width(np.uint64(int(v.max()) - int(v.min())))
        assert w == jstreams.bit_width(np.uint64(int(v.max()) - int(v.min())))
        off = (v - v.min()).astype(np.uint64)
        assert tstreams.bitpack(off, w) == jstreams.bitpack(off, w)


@pytest.mark.parametrize("n", [0, 1, 37, 5000])
def test_vertex_column_matches(n):
    rng = np.random.default_rng(n)
    lon = rng.uniform(-190, 190, n)
    lat = rng.uniform(-95, 95, n)
    env = np.stack([lon, lat, lon + rng.uniform(-1, 3, n), lat + rng.uniform(0, 2, n)], axis=1)
    if n:
        env[0] = np.nan  # not finite: a kind-0 row
    env = env.astype(np.float32)
    t, j = tgeom.boxes_vertex_column(env), jgeom.boxes_vertex_column(env)
    for attr in ("kinds", "feat_offsets", "ring_offsets", "x", "y"):
        assert np.array_equal(getattr(t, attr), getattr(j, attr)), attr
    assert tgeom.encode_vertex_column(t) == jgeom.encode_vertex_column(j)
    order = rng.permutation(n)
    tt, jt = t.take(order), j.take(order)
    assert tgeom.encode_vertex_column(tt) == jgeom.encode_vertex_column(jt)
    assert tgeom.encode_vertex_column(tgeom.VertexColumn.empty(n)) == (
        jgeom.encode_vertex_column(jgeom.VertexColumn.empty(n)))
