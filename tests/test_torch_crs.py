"""The port's transform engine held to kart_tpu's bit for bit: every
projection of ``_PROJ_IMPLS`` forward and inverse on seeded grids with
NaN, infinite, polar, anti-meridian and out-of-domain rows; kart_tpu's own
known points; every projected registry code and each UTM family's first
and last code; NTv2 grids that the tests write (both endiannesses, nested
subgrids listed child first, grid + Helmert both ways, the
``KART_NTV2_GRID_DIR`` scan); and a projection the engine lacks, which
fails open with kart_tpu's warning.

Bits are compared through ``.view(np.uint64)`` with NaN positions held
equal. Every test that registers a grid or sets ``KART_NTV2_GRID_DIR``
clears both packages' registries (``--dist loadfile`` shares worker
processes with kart_tpu's own tests)."""

import logging
import struct

import numpy as np
import pytest

from kart_tpu import crs as jcrs
from kart_tpu import epsg as jepsg
from kart_tpu import gridshift as jgrid
from kart_tpu import spatial_filter as jsf
from kart_tpu_torch import crs as tcrs
from kart_tpu_torch import epsg as tepsg
from kart_tpu_torch import gridshift as tgrid
from kart_tpu_torch import spatial_filter as tsf


def _same_bits(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    nan = np.isnan(a)
    assert np.array_equal(nan, np.isnan(b))
    assert np.array_equal(a[~nan].view(np.uint64), b[~nan].view(np.uint64))


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # the type and message are what is compared
        return ("error", type(e).__name__, str(e))


# -- every projection method ---------------------------------------------------

#: _PROJ_IMPLS key -> (geographic code, parameters, (lon, lat) centre):
#: parameters of a registry CRS of the family, or a textbook example's
_FAMILY = {
    "tm": (4167, {"latitude_of_origin": 0, "central_meridian": 173, "scale_factor": 0.9996,
                  "false_easting": 1600000, "false_northing": 10000000}, (173.0, -41.0)),
    "webmerc": (4326, {"central_meridian": 0, "scale_factor": 1, "false_easting": 0,
                       "false_northing": 0}, (0.0, 0.0)),
    "merc1": (4326, {"central_meridian": 10, "scale_factor": 0.997, "false_easting": 3900000,
                     "false_northing": 900000}, (10.0, 20.0)),
    "merc2": (4326, {"standard_parallel_1": 42, "central_meridian": 51,
                     "false_easting": 0, "false_northing": 0}, (51.0, 45.0)),
    "lcc2": (4171, {"standard_parallel_1": 49, "standard_parallel_2": 44,
                    "latitude_of_origin": 46.5, "central_meridian": 3,
                    "false_easting": 700000, "false_northing": 6600000}, (3.0, 46.5)),
    "lcc1": (4267, {"latitude_of_origin": 18, "central_meridian": -77, "scale_factor": 1,
                    "false_easting": 250000, "false_northing": 150000}, (-77.0, 18.0)),
    "albers": (4283, {"standard_parallel_1": -18, "standard_parallel_2": -36,
                      "latitude_of_center": 0, "longitude_of_center": 132,
                      "false_easting": 0, "false_northing": 0}, (132.0, -27.0)),
    "polar_a_north": (4326, {"latitude_of_origin": 90, "central_meridian": 0,
                             "scale_factor": 0.994, "false_easting": 2000000,
                             "false_northing": 2000000}, (0.0, 80.0)),
    "polar_a_south": (4326, {"latitude_of_origin": -90, "central_meridian": 0,
                             "scale_factor": 0.994, "false_easting": 2000000,
                             "false_northing": 2000000}, (0.0, -80.0)),
    "polar_b_south": (4326, {"standard_parallel_1": -71, "central_meridian": 0,
                             "false_easting": 0, "false_northing": 0}, (0.0, -80.0)),
    "polar_b_north": (4326, {"standard_parallel_1": 70, "central_meridian": -45,
                             "false_easting": 0, "false_northing": 0}, (-45.0, 78.0)),
    "sterea": (4289, {"latitude_of_origin": 52.15616055555555,
                      "central_meridian": 5.38763888888889, "scale_factor": 0.9999079,
                      "false_easting": 155000, "false_northing": 463000}, (5.4, 52.2)),
    "laea": (4258, {"latitude_of_center": 52, "longitude_of_center": 10,
                    "false_easting": 4321000, "false_northing": 3210000}, (10.0, 52.0)),
    "cea": (4326, {"standard_parallel_1": 30, "central_meridian": 0, "false_easting": 0,
                   "false_northing": 0}, (0.0, 0.0)),
    "somerc": (4150, {"latitude_of_center": 46.952405555555565,
                      "longitude_of_center": 7.439583333333333, "azimuth": 90,
                      "rectified_grid_angle": 90, "scale_factor": 1,
                      "false_easting": 2600000, "false_northing": 1200000}, (8.2, 46.8)),
    "hom_a": (4742, {"latitude_of_center": 4, "longitude_of_center": 102.25,
                     "azimuth": 323.0257964666666, "rectified_grid_angle": 323.1301023611111,
                     "scale_factor": 0.99984, "false_easting": 804671,
                     "false_northing": 0}, (102.0, 4.0)),
    "hom_b": (4298, {"latitude_of_center": 4, "longitude_of_center": 115,
                     "azimuth": 53.31582047222222, "rectified_grid_angle": 53.13010236111111,
                     "scale_factor": 0.99984, "false_easting": 590476.87,
                     "false_northing": 442857.65}, (115.2, 4.8)),
    "krovak": (4156, {"latitude_of_center": 49.5, "longitude_of_center": 24.833333333333332,
                      "azimuth": 30.288139722222223, "pseudo_standard_parallel_1": 78.5,
                      "scale_factor": 0.9999, "false_easting": 0, "false_northing": 0},
               (15.0, 49.8)),
}

_METHOD_FAMILY = {
    "lambert_azimuthal_equal_area": "laea",
    "hotine_oblique_mercator": "hom_a",
    "hotine_oblique_mercator_azimuth_center": "hom_b",
    "krovak": "krovak",
    "swiss_oblique_cylindrical": "somerc",
    "swiss_oblique_mercator": "somerc",
    "cylindrical_equal_area": "cea",
    "lambert_cylindrical_equal_area": "cea",
    "lambert_cylindrical_equal_area_spherical": "cea",
    "transverse_mercator": "tm",
    "mercator_1sp": "merc1",
    "mercator_2sp": "merc2",
    "mercator": "merc2",
    "mercator_auxiliary_sphere": "webmerc",
    "popular_visualisation_pseudo_mercator": "webmerc",
    "lambert_conformal_conic_2sp": "lcc2",
    "lambert_conformal_conic_1sp": "lcc1",
    "lambert_conformal_conic": "lcc2",
    "albers_conic_equal_area": "albers",
    "albers": "albers",
    "polar_stereographic": "polar_a_north",
    "polar_stereographic_variant_a": "polar_a_south",
    "polar_stereographic_variant_b": "polar_b_south",
    "oblique_stereographic": "sterea",
    "double_stereographic": "sterea",
    "stereographic_north_pole": "polar_b_north",
    "stereographic_south_pole": "polar_a_south",
}

#: more cases of one method: the Swiss form of HOM B, Krovak's Ferro
#: longitude, a Web Mercator told by its EXTENSION
_EXTRA = {
    "hom_b_swiss": ("hotine_oblique_mercator_azimuth_center", "somerc"),
    "krovak_ferro": ("krovak", "krovak"),
    "merc1_web_by_extension": ("mercator_1sp", "webmerc"),
}


def _method_wkt(method, family, name="test"):
    geog, params, _centre = _FAMILY[family]
    params = dict(params)
    if name == "krovak_ferro":
        params["longitude_of_center"] = 42.5
    wkt = jepsg._projected_wkt(990000, f"{name} {method}", geog, method, params)
    if name == "merc1_web_by_extension":
        wkt = wkt.replace(',AUTHORITY["EPSG","990000"]]',
                          ',EXTENSION["PROJ4","+proj=merc +nadgrids=@null"]]')
    return wkt


def _cases():
    out = {m: (m, f) for m, f in _METHOD_FAMILY.items()}
    out.update(_EXTRA)
    return out


CASES = _cases()


def test_every_method_has_a_case():
    assert set(_METHOD_FAMILY) == set(jcrs._PROJ_IMPLS) == set(tcrs._PROJ_IMPLS)


def _probe_lonlat(centre, seed):
    """A seeded grid around ``centre`` and across the globe, with NaN,
    +-inf, the poles, +-180 and out-of-domain rows."""
    rng = np.random.default_rng(seed)
    cx, cy = centre
    lon = np.concatenate([
        cx + rng.uniform(-4, 4, 300),
        rng.uniform(-180, 180, 200),
        [np.nan, 0.0, np.inf, -np.inf, 180.0, -180.0, cx, cx, 400.0, -720.0, cx, cx],
    ])
    lat = np.concatenate([
        np.clip(cy + rng.uniform(-4, 4, 300), -90, 90),
        rng.uniform(-89.9, 89.9, 200),
        [0.0, np.nan, 0.0, 10.0, cy, cy, 90.0, -90.0, cy, cy, 95.0, -1e6],
    ])
    return lon, lat


@pytest.mark.parametrize("name", sorted(CASES))
def test_method_forward_and_inverse_bit_identical(name):
    method, family = CASES[name]
    wkt = _method_wkt(method, family, name)
    t, j = tcrs.CRS(wkt), jcrs.CRS(wkt)
    assert (t.projection, t.params, t.is_projected) == (j.projection, j.params, j.is_projected)
    lon, lat = _probe_lonlat(_FAMILY[family][2], sorted(CASES).index(name))
    fwd_t = _outcome(tcrs._PROJ_IMPLS[t.projection.lower()][0], t, lon, lat)
    with np.errstate(all="ignore"):
        fwd_j = _outcome(jcrs._PROJ_IMPLS[j.projection.lower()][0], j, lon, lat)
    assert fwd_t[0] == fwd_j[0]
    if fwd_j[0] == "error":
        assert fwd_t == fwd_j
        return
    for a, b in zip(fwd_t[1], fwd_j[1]):
        _same_bits(a, b)
    xs, ys = (np.asarray(v, np.float64) for v in fwd_j[1])
    rng = np.random.default_rng(7)
    finite = np.isfinite(xs) & np.isfinite(ys)
    xs = np.concatenate([xs, [np.nan, 0.0, np.inf, 1e12, -1e12],
                         xs[finite][:50] + rng.uniform(-1e6, 1e6, min(50, finite.sum()))])
    ys = np.concatenate([ys, [0.0, np.nan, 0.0, -1e12, 1e12],
                         ys[finite][:50] + rng.uniform(-1e6, 1e6, min(50, finite.sum()))])
    inv_t = _outcome(tcrs._PROJ_IMPLS[t.projection.lower()][1], t, xs, ys)
    with np.errstate(all="ignore"):
        inv_j = _outcome(jcrs._PROJ_IMPLS[j.projection.lower()][1], j, xs, ys)
    assert inv_t[0] == inv_j[0]
    if inv_j[0] == "error":
        assert inv_t == inv_j
        return
    for a, b in zip(inv_t[1], inv_j[1]):
        _same_bits(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_method_through_transform_and_envelope(name):
    """The same through ``Transform`` from and to EPSG:4326 (the datum
    shift in between) and ``transform_envelope``."""
    method, family = CASES[name]
    wkt = _method_wkt(method, family, name)
    cx, cy = _FAMILY[family][2]
    rng = np.random.default_rng(len(name))
    lon = cx + rng.uniform(-2, 2, 200)
    lat = np.clip(cy + rng.uniform(-2, 2, 200), -89.9, 89.9)
    for src, dst in (("EPSG:4326", wkt), (wkt, "EPSG:4326")):
        tt, jt = tcrs.Transform(src, dst), jcrs.Transform(src, dst)
        assert tt.is_identity == jt.is_identity
        if src == wkt:
            with np.errstate(all="ignore"):
                xs, ys = jcrs.Transform("EPSG:4326", wkt).transform(lon, lat)
        else:
            xs, ys = lon, lat
        got = _outcome(tt.transform, xs, ys)
        with np.errstate(all="ignore"):
            want = _outcome(jt.transform, xs, ys)
        assert got[0] == want[0]
        if want[0] == "error":
            assert got == want
            continue
        for a, b in zip(got[1], want[1]):
            _same_bits(a, b)
        fin = np.isfinite(xs) & np.isfinite(ys)
        env = (float(xs[fin].min()), float(xs[fin].max()), float(ys[fin].min()),
               float(ys[fin].max()))
        with np.errstate(all="ignore"):
            assert _outcome(tt.transform_envelope, env) == _outcome(jt.transform_envelope, env)


# -- kart_tpu's known points -------------------------------------------------

LCC_2SP_CLARKE = (
    'PROJCS["test LCC",GEOGCS["NAD27",DATUM["North_American_Datum_1927",'
    'SPHEROID["Clarke 1866",6378206.4,294.978698213898]],'
    'PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433]],'
    'PROJECTION["Lambert_Conformal_Conic_2SP"],'
    'PARAMETER["standard_parallel_1",33],PARAMETER["standard_parallel_2",45],'
    'PARAMETER["latitude_of_origin",23],PARAMETER["central_meridian",-96],'
    'PARAMETER["false_easting",0],PARAMETER["false_northing",0],UNIT["metre",1]]'
)
NAD27_GEO = (
    'GEOGCS["NAD27",DATUM["North_American_Datum_1927",'
    'SPHEROID["Clarke 1866",6378206.4,294.978698213898]],'
    'PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433]]'
)
RGF93_GEO = (
    'GEOGCS["RGF93",DATUM["Reseau_Geodesique_Francais_1993",'
    'SPHEROID["GRS 1980",6378137,298.257222101]],PRIMEM["Greenwich",0],'
    'UNIT["degree",0.0174532925199433]]'
)
LAMBERT_93 = (
    'PROJCS["RGF93 / Lambert-93",' + RGF93_GEO + ','
    'PROJECTION["Lambert_Conformal_Conic_2SP"],'
    'PARAMETER["standard_parallel_1",49],PARAMETER["standard_parallel_2",44],'
    'PARAMETER["latitude_of_origin",46.5],PARAMETER["central_meridian",3],'
    'PARAMETER["false_easting",700000],PARAMETER["false_northing",6600000],'
    'UNIT["metre",1],AUTHORITY["EPSG","2154"]]'
)

#: (name, src, dst, lons, lats): kart_tpu's tests/test_crs.py points
KNOWN = [
    ("nztm_origin", "EPSG:4326", "EPSG:2193", [173.0], [0.0]),
    ("nztm_wellington", "EPSG:4326", "EPSG:2193", [174.7772239], [-41.2887639]),
    ("nztm_inverse", "EPSG:2193", "EPSG:4326", [1500000, 1700000], [5300000, 5500000]),
    ("web_mercator", "EPSG:4326", "EPSG:3857", [1.0, 180.0, -180.0], [0.0, 85.0511, -89.9]),
    ("utm_60s", "EPSG:4326", "EPSG:32760", [177.0, 179.99, -179.99], [0.0, -45.0, -45.0]),
    ("snyder_lcc", NAD27_GEO, LCC_2SP_CLARKE, [-75.0], [35.0]),
    ("lambert93_paris", RGF93_GEO, LAMBERT_93, [2.3522], [48.8566]),
    ("krovak_gn7_2", "EPSG:4326", "EPSG:5514", [16 + 50 / 60 + 59.1790 / 3600],
     [50 + 12 / 60 + 32.4416 / 3600]),
    ("krovak_prague", "EPSG:4326", "EPSG:5514", [14.42], [50.088]),
    ("swiss_lv95", "EPSG:4326", "EPSG:2056", [8.2, 7.439583333333333], [46.8, 46.95240555]),
    ("swiss_lv03", "EPSG:4326", "EPSG:21781", [8.2], [46.8]),
    ("hom_rso_borneo", "EPSG:4326", "EPSG:29873", [115.2], [4.8]),
    ("hom_rso_malaya", "EPSG:4326", "EPSG:3375", [102.0], [4.0]),
    ("ups_north", "EPSG:4326", "EPSG:32661", [44.0, 0.0], [73.0, 90.0]),
    ("antarctic_polar", "EPSG:4326", "EPSG:3031", [70.0, 0.0], [-71.0, -90.0]),
    ("rd_new", "EPSG:4326", "EPSG:28992", [6.0], [53.0]),
    ("laea_europe", "EPSG:4326", "EPSG:3035", [10.0], [52.0]),
    ("ease_grid", "EPSG:4326", "EPSG:6933", [10.0, 0.0], [45.0, 90.0]),
]


@pytest.mark.parametrize("case", KNOWN, ids=[k[0] for k in KNOWN])
def test_known_points_bit_identical(case):
    _name, src, dst, lons, lats = case
    lons, lats = np.asarray(lons, np.float64), np.asarray(lats, np.float64)
    got = tcrs.Transform(src, dst).transform(lons, lats)
    want = jcrs.Transform(src, dst).transform(lons, lats)
    for a, b in zip(got, want):
        _same_bits(a, b)
    back_t = tcrs.Transform(dst, src).transform(*want)
    back_j = jcrs.Transform(dst, src).transform(*want)
    for a, b in zip(back_t, back_j):
        _same_bits(a, b)


# -- the registry ------------------------------------------------------------

REGISTRY_CODES = sorted(jepsg.PROJECTED) + sorted(
    {c for (lo, hi), *_ in jepsg.UTM_FAMILIES for c in (lo, hi)})


def test_registry_tables_equal():
    assert tepsg.PROJECTED == jepsg.PROJECTED
    assert tepsg.UTM_FAMILIES == jepsg.UTM_FAMILIES
    assert tepsg.GEOGRAPHIC == jepsg.GEOGRAPHIC
    assert tepsg.registry_summary() == jepsg.registry_summary()
    for code in (tcrs.WEB_MERCATOR_WKT, tcrs.NZTM_WKT, tcrs.WGS84_WKT, tcrs.NZGD2000_WKT):
        assert code in (jcrs.WEB_MERCATOR_WKT, jcrs.NZTM_WKT, jcrs.WGS84_WKT, jcrs.NZGD2000_WKT)
    assert tcrs._WELL_KNOWN == jcrs._WELL_KNOWN


@pytest.mark.parametrize("code", REGISTRY_CODES)
def test_registry_code_resolves_and_transforms_bit_identical(code):
    assert tepsg.epsg_wkt(code) == jepsg.epsg_wkt(code)
    t, j = tcrs.make_crs(f"EPSG:{code}"), jcrs.make_crs(f"EPSG:{code}")
    assert (t.wkt, t.identifier_str, t.identifier_int, t.projection, t.params, t.towgs84,
            t.datum_name) == (j.wkt, j.identifier_str, j.identifier_int, j.projection,
                              j.params, j.towgs84, j.datum_name)
    assert tcrs.normalise_wkt(t.wkt) == jcrs.normalise_wkt(j.wkt)
    rng = np.random.default_rng(code)
    lon0 = t.params.get("central_meridian", t.params.get("longitude_of_center", 0.0))
    lat0 = t.params.get("latitude_of_origin", t.params.get("latitude_of_center", 45.0))
    lon = np.concatenate([lon0 + rng.uniform(-3, 3, 100), [np.nan, 180.0, -180.0]])
    lat = np.concatenate([np.clip(lat0 + rng.uniform(-3, 3, 100), -89.5, 89.5),
                          [0.0, 0.0, 0.0]])
    with np.errstate(all="ignore"):
        xs, ys = jcrs.Transform("EPSG:4326", f"EPSG:{code}").transform(lon, lat)
    for src, dst, px, py in (("EPSG:4326", f"EPSG:{code}", lon, lat),
                             (f"EPSG:{code}", "EPSG:4326", xs, ys)):
        with np.errstate(all="ignore"):
            want = jcrs.Transform(src, dst).transform(px, py)
        got = tcrs.Transform(src, dst).transform(px, py)
        for a, b in zip(got, want):
            _same_bits(a, b)


def test_unknown_codes_and_errors_match():
    for spec in ("EPSG:32600", "EPSG:32761", "EPSG:7845", "EPSG:999999", "EPSG:0"):
        got, want = _outcome(tcrs.make_crs, spec), _outcome(jcrs.make_crs, spec)
        assert got[0] == want[0]
        assert (got[1].wkt == want[1].wkt) if got[0] == "ok" else got == want


# -- an unsupported projection fails open ---------------------------------------

ROBINSON = (
    'PROJCS["World_Robinson",GEOGCS["WGS 84",DATUM["WGS_1984",'
    'SPHEROID["WGS 84",6378137,298.257223563]],PRIMEM["Greenwich",0],'
    'UNIT["degree",0.0174532925199433]],PROJECTION["Robinson"],'
    'PARAMETER["central_meridian",0],PARAMETER["false_easting",0],'
    'PARAMETER["false_northing",0],UNIT["metre",1]]'
)


class _Dataset:
    path = "ds"
    geom_column_name = "geom"

    def __init__(self, wkt):
        self._wkt = wkt

    def crs_identifiers(self):
        return ["x"]

    def get_crs_definition(self, identifier=None):
        return self._wkt


def test_unsupported_projection_fails_open_with_kart_tpu_s_warning(caplog):
    spec_text = "EPSG:4326;POLYGON((0 0,10 0,10 10,0 10,0 0))"
    for flt in (spec_text, f"{ROBINSON};POLYGON((0 0,1000 0,1000 1000,0 1000,0 0))"):
        outcomes = []
        for sf, logger in ((tsf, "kart_tpu_torch.spatial_filter"),
                           (jsf, "kart_tpu.spatial_filter")):
            caplog.clear()
            crs_text, _, geom = flt.rpartition(";")
            ds = _Dataset(ROBINSON if flt == spec_text else jcrs.WGS84_WKT)
            with caplog.at_level(logging.WARNING, logger=logger):
                got = sf.ResolvedSpatialFilterSpec(crs_text, geom).resolve_for_dataset(ds)
            outcomes.append((got.match_all, [r.getMessage() for r in caplog.records
                                             if r.name == logger]))
        assert outcomes[0] == outcomes[1]
        assert outcomes[0][0] is True and "cannot be transformed" in outcomes[0][1][0]
    # the transform itself raises kart_tpu's CrsError, and only when used
    for mod in (tcrs, jcrs):
        t = mod.Transform("EPSG:4326", ROBINSON)
        with pytest.raises(mod.CrsError, match="'Robinson' is not supported"):
            t.transform([0.0], [0.0])


# -- NTv2 grids --------------------------------------------------------------


def _rec(endian, name, value, kind):
    out = name.ljust(8).encode()
    if kind == "i":
        return out + struct.pack(endian + "i", value) + b"\0\0\0\0"
    if kind == "d":
        return out + struct.pack(endian + "d", value)
    return out + value.ljust(8).encode()[:8]


def _subgrid(endian, name, parent, s_lat, n_lat, e_long, w_long, inc, seed):
    """One subgrid's header and nodes: bounds in degrees (longitudes
    positive west), seeded shifts in seconds."""
    rows = int(round((n_lat - s_lat) / inc)) + 1
    cols = int(round((w_long - e_long) / inc)) + 1
    head = b"".join([
        _rec(endian, "SUB_NAME", name, "s"), _rec(endian, "PARENT", parent, "s"),
        _rec(endian, "CREATED", "20260101", "s"), _rec(endian, "UPDATED", "20260101", "s"),
        _rec(endian, "S_LAT", s_lat * 3600.0, "d"), _rec(endian, "N_LAT", n_lat * 3600.0, "d"),
        _rec(endian, "E_LONG", e_long * 3600.0, "d"),
        _rec(endian, "W_LONG", w_long * 3600.0, "d"),
        _rec(endian, "LAT_INC", inc * 3600.0, "d"), _rec(endian, "LONG_INC", inc * 3600.0, "d"),
        _rec(endian, "GS_COUNT", rows * cols, "i"),
    ])
    nodes = np.random.default_rng(seed).uniform(-3, 3, (rows * cols, 4)).astype(endian + "f4")
    return head + nodes.tobytes()


def _write_gsb(path, endian="<", system="TESTDATM", nested=False):
    """An NTv2 file over lat 40..44N, lon 72..78W; ``nested`` adds a finer
    child subgrid listed before its parent."""
    subs = [_subgrid(endian, "PARENT", "NONE", 40, 44, 72, 78, 0.5, 1)]
    if nested:
        subs.insert(0, _subgrid(endian, "CHILD", "PARENT", 41, 42, 74, 75, 0.125, 2))
    head = b"".join([
        _rec(endian, "NUM_OREC", 11, "i"), _rec(endian, "NUM_SREC", 11, "i"),
        _rec(endian, "NUM_FILE", len(subs), "i"), _rec(endian, "GS_TYPE", "SECONDS", "s"),
        _rec(endian, "VERSION", "NTv2.0", "s"), _rec(endian, "SYSTEM_F", system, "s"),
        _rec(endian, "SYSTEM_T", "WGS84", "s"), _rec(endian, "MAJOR_F", 6378137.0, "d"),
        _rec(endian, "MINOR_F", 6356752.314, "d"), _rec(endian, "MAJOR_T", 6378137.0, "d"),
        _rec(endian, "MINOR_T", 6356752.314, "d"),
    ])
    with open(path, "wb") as f:
        f.write(head + b"".join(subs))
    return str(path)


@pytest.fixture
def no_grids(monkeypatch):
    """Both registries empty before and after, and no grid directory."""
    monkeypatch.delenv("KART_NTV2_GRID_DIR", raising=False)
    tgrid.clear_grids()
    jgrid.clear_grids()
    yield
    tgrid.clear_grids()
    jgrid.clear_grids()


GRID_DATUM_WKT = jcrs.WGS84_WKT.replace("WGS_1984", "TESTDATM").replace(
    'GEOGCS["WGS 84"', 'GEOGCS["Test Datum"')
HELMERT_WKT = (
    'GEOGCS["shifted",DATUM["Shifted_Datum",SPHEROID["Bessel 1841",6377397.155,299.1528128],'
    'TOWGS84[565.417,50.3319,465.552,-0.398957,0.343988,-1.8774,4.0725]],'
    'PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433]]'
)


def _grid_points(seed):
    rng = np.random.default_rng(seed)
    lon = np.concatenate([rng.uniform(-79, -71, 300), [-74.5, -75.0, -72.0, 10.0, np.nan]])
    lat = np.concatenate([rng.uniform(39, 45, 300), [41.5, 42.0, 44.0, 0.0, 41.0]])
    return lon, lat


@pytest.mark.parametrize("endian", ["<", ">"])
@pytest.mark.parametrize("nested", [False, True], ids=["flat", "nested"])
def test_ntv2_grid_parse_and_shift_bit_identical(tmp_path, no_grids, endian, nested):
    path = _write_gsb(tmp_path / "g.gsb", endian, nested=nested)
    t, j = tgrid.NTv2Grid.open(path), jgrid.NTv2Grid.open(path)
    assert (t.system_from, t.system_to) == (j.system_from, j.system_to)
    assert [s.name for s in t.subgrids] == [s.name for s in j.subgrids]
    assert [s.name for s in t.subgrids][-1] == ("CHILD" if nested else "PARENT")
    lon, lat = _grid_points(len(endian) + nested)
    for inverse in (False, True):
        for a, b in zip(t.shift(lon, lat, inverse=inverse), j.shift(lon, lat, inverse=inverse)):
            _same_bits(a, b)


@pytest.mark.parametrize("direction", ["grid_to_helmert", "helmert_to_grid", "grid_to_wgs84",
                                       "wgs84_to_grid", "grid_to_projected"])
def test_ntv2_grid_composes_with_helmert_bit_identical(tmp_path, no_grids, direction):
    path = _write_gsb(tmp_path / "g.gsb", nested=True)
    tgrid.register_grid("TESTDATM", tgrid.NTv2Grid.open(path))
    jgrid.register_grid("TESTDATM", jgrid.NTv2Grid.open(path))
    src, dst = {
        "grid_to_helmert": (GRID_DATUM_WKT, HELMERT_WKT),
        "helmert_to_grid": (HELMERT_WKT, GRID_DATUM_WKT),
        "grid_to_wgs84": (GRID_DATUM_WKT, jcrs.WGS84_WKT),
        "wgs84_to_grid": (jcrs.WGS84_WKT, GRID_DATUM_WKT),
        "grid_to_projected": (GRID_DATUM_WKT, "EPSG:32618"),
    }[direction]
    lon, lat = _grid_points(3)
    got = tcrs.Transform(src, dst).transform(lon, lat)
    want = jcrs.Transform(src, dst).transform(lon, lat)
    for a, b in zip(got, want):
        _same_bits(a, b)
    # the grid takes part: without it the result differs
    tgrid.clear_grids()
    plain = tcrs.Transform(src, dst).transform(lon, lat)
    assert not np.array_equal(plain[1][:300], got[1][:300])


def test_ntv2_env_dir_scan(tmp_path, no_grids, monkeypatch):
    """``KART_NTV2_GRID_DIR`` is read by both packages, each into its own
    registry: grids by SYSTEM_F and by file stem, a corrupt file skipped."""
    _write_gsb(tmp_path / "aliasdatum.gsb", ">", system="TESTDATM")
    (tmp_path / "bad.gsb").write_bytes(b"NUM_OREC" + b"\x0b\x00\x00\x00junk")
    monkeypatch.setenv("KART_NTV2_GRID_DIR", str(tmp_path))
    for mod in (tgrid, jgrid):
        assert mod.grid_for_datum("TESTDATM") is not None
        assert mod.grid_for_datum("alias_datum") is not None  # the stem, normalised
        assert mod.grid_for_datum("other") is None
    assert tgrid.grid_for_datum("TESTDATM") is not jgrid.grid_for_datum("TESTDATM")
    lon, lat = _grid_points(5)
    got = tcrs.Transform(GRID_DATUM_WKT, "EPSG:3857").transform(lon, lat)
    want = jcrs.Transform(GRID_DATUM_WKT, "EPSG:3857").transform(lon, lat)
    for a, b in zip(got, want):
        _same_bits(a, b)


def test_ntv2_errors_match(tmp_path, no_grids):
    good = _write_gsb(tmp_path / "g.gsb")
    data = open(good, "rb").read()
    cases = {
        "short": data[:100],
        "minutes": data[:56] + b"MINUTES " + data[64:],
        "truncated": data[:-40],
        "not_ntv2": b"X" * 8 + data[8:],
    }
    for name, blob in cases.items():
        p = tmp_path / f"{name}.gsb"
        p.write_bytes(blob)
        got = _outcome(tgrid.NTv2Grid.open, str(p))
        want = _outcome(jgrid.NTv2Grid.open, str(p))
        assert got[0] == want[0] == "error" and got[2] == want[2], name
