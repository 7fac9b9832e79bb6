"""The built-in EPSG registry: ``make_crs("EPSG:n")`` without a PROJ
database.

Counterpart of kart_tpu's ``epsg.py``, a copy of its tables: ellipsoids,
geographic CRSes (datum and TOWGS84 Helmert), individually listed
projected CRSes and families of projected CRSes computed from the code
(UTM zones for several datums). Every entry expands to the same WKT1
string as in kart_tpu, read by the same parser and transform engine
(:mod:`kart_tpu_torch.crs`) as a user's WKT. A code in no table gives
None, and the caller's error lists the coverage (:func:`registry_summary`).
The projections listed are exactly the ones ``crs._PROJ_IMPLS`` runs.
"""

# -- ellipsoids: EPSG code -> (name, semi-major a, inverse flattening) ------

ELLIPSOIDS = {
    7030: ("WGS 84", 6378137.0, 298.257223563),
    7019: ("GRS 1980", 6378137.0, 298.257222101),
    7001: ("Airy 1830", 6377563.396, 299.3249646),
    7004: ("Bessel 1841", 6377397.155, 299.1528128),
    7008: ("Clarke 1866", 6378206.4, 294.978698213898),
    7011: ("Clarke 1880 (IGN)", 6378249.2, 293.4660212936269),
    7022: ("International 1924", 6378388.0, 297.0),
    7024: ("Krassowsky 1940", 6378245.0, 298.3),
    7043: ("WGS 72", 6378135.0, 298.26),
    7050: ("GRS 1967 Modified", 6378160.0, 298.25),
    7016: ("Everest 1830 (1967 Definition)", 6377298.556, 300.8017),
    1024: ("CGCS2000", 6378137.0, 298.257222101),
}

# -- geographic CRSes: EPSG code ->
#    (name, datum name, datum code, ellipsoid code, towgs84|None) ----------

GEOGRAPHIC = {
    4326: ("WGS 84", "WGS_1984", 6326, 7030, None),
    4322: ("WGS 72", "WGS_1972", 6322, 7043, (0, 0, 4.5, 0, 0, 0.554, 0.2263)),
    4258: ("ETRS89", "European_Terrestrial_Reference_System_1989", 6258, 7019, (0, 0, 0)),
    4269: ("NAD83", "North_American_Datum_1983", 6269, 7019, (0, 0, 0)),
    4267: ("NAD27", "North_American_Datum_1927", 6267, 7008, (-8, 160, 176)),
    4283: ("GDA94", "Geocentric_Datum_of_Australia_1994", 6283, 7019, (0, 0, 0)),
    7844: ("GDA2020", "Geocentric_Datum_of_Australia_2020", 1168, 7019, (0, 0, 0)),
    4167: ("NZGD2000", "New_Zealand_Geodetic_Datum_2000", 6167, 7019, (0, 0, 0)),
    4272: (
        "NZGD49",
        "New_Zealand_Geodetic_Datum_1949",
        6272,
        7022,
        (59.47, -5.04, 187.44, 0.47, -0.1, 1.024, -4.5993),
    ),
    4277: (
        "OSGB 1936",
        "OSGB_1936",
        6277,
        7001,
        (446.448, -125.157, 542.06, 0.15, 0.247, 0.842, -20.489),
    ),
    4171: ("RGF93", "Reseau_Geodesique_Francais_1993", 6171, 7019, (0, 0, 0)),
    4230: ("ED50", "European_Datum_1950", 6230, 7022, (-87, -98, -121)),
    4301: ("Tokyo", "Tokyo", 6301, 7004, (-146.414, 507.337, 680.507)),
    4612: ("JGD2000", "Japanese_Geodetic_Datum_2000", 6612, 7019, (0, 0, 0)),
    6668: ("JGD2011", "Japanese_Geodetic_Datum_2011", 1128, 7019, (0, 0, 0)),
    4490: ("China Geodetic Coordinate System 2000", "China_2000", 1043, 1024, None),
    4674: ("SIRGAS 2000", "Sistema_de_Referencia_Geocentrico_para_las_AmericaS_2000", 6674, 7019, (0, 0, 0)),
    4618: ("SAD69", "South_American_Datum_1969", 6618, 7050, (-57, 1, -41)),
    4202: (
        "AGD66",
        "Australian_Geodetic_Datum_1966",
        6202,
        7003,
        (-117.808, -51.536, 137.784, 0.303, 0.446, 0.234, -0.29),
    ),
    4203: (
        "AGD84",
        "Australian_Geodetic_Datum_1984",
        6203,
        7003,
        (-117.763, -51.51, 139.061, -0.292, -0.443, -0.277, -0.191),
    ),
    4312: (
        "MGI",
        "Militar_Geographische_Institut",
        6312,
        7004,
        (577.326, 90.129, 463.919, 5.137, 1.474, 5.297, 2.4232),
    ),
}
# Australian National Spheroid, used by AGD66/84 only
ELLIPSOIDS[7003] = ("Australian National Spheroid", 6378160.0, 298.25)

# -- individually-listed projected CRSes: EPSG code ->
#    (name, geographic code, projection method, {parameter: value}) --------
# Methods are the WKT1 names kart_tpu_torch.crs._PROJ_IMPLS dispatches on.

PROJECTED = {
    3857: (
        "WGS 84 / Pseudo-Mercator",
        4326,
        "Popular_Visualisation_Pseudo_Mercator",
        {"central_meridian": 0, "scale_factor": 1, "false_easting": 0, "false_northing": 0},
    ),
    2193: (
        "NZGD2000 / New Zealand Transverse Mercator 2000",
        4167,
        "Transverse_Mercator",
        {
            "latitude_of_origin": 0,
            "central_meridian": 173,
            "scale_factor": 0.9996,
            "false_easting": 1600000,
            "false_northing": 10000000,
        },
    ),
    27700: (
        "OSGB 1936 / British National Grid",
        4277,
        "Transverse_Mercator",
        {
            "latitude_of_origin": 49,
            "central_meridian": -2,
            "scale_factor": 0.9996012717,
            "false_easting": 400000,
            "false_northing": -100000,
        },
    ),
    2154: (
        "RGF93 / Lambert-93",
        4171,
        "Lambert_Conformal_Conic_2SP",
        {
            "standard_parallel_1": 49,
            "standard_parallel_2": 44,
            "latitude_of_origin": 46.5,
            "central_meridian": 3,
            "false_easting": 700000,
            "false_northing": 6600000,
        },
    ),
    31370: (
        "Belge 1972 / Belgian Lambert 72",
        4313,
        "Lambert_Conformal_Conic_2SP",
        {
            "standard_parallel_1": 51.16666723333333,
            "standard_parallel_2": 49.8333339,
            "latitude_of_origin": 90,
            "central_meridian": 4.367486666666666,
            "false_easting": 150000.013,
            "false_northing": 5400088.438,
        },
    ),
    28992: (
        "Amersfoort / RD New",
        4289,
        "Oblique_Stereographic",
        {
            "latitude_of_origin": 52.15616055555555,
            "central_meridian": 5.38763888888889,
            "scale_factor": 0.9999079,
            "false_easting": 155000,
            "false_northing": 463000,
        },
    ),
    3577: (
        "GDA94 / Australian Albers",
        4283,
        "Albers_Conic_Equal_Area",
        {
            "standard_parallel_1": -18,
            "standard_parallel_2": -36,
            "latitude_of_center": 0,
            "longitude_of_center": 132,
            "false_easting": 0,
            "false_northing": 0,
        },
    ),
    3112: (
        "GDA94 / Geoscience Australia Lambert",
        4283,
        "Lambert_Conformal_Conic_2SP",
        {
            "standard_parallel_1": -18,
            "standard_parallel_2": -36,
            "latitude_of_origin": 0,
            "central_meridian": 134,
            "false_easting": 0,
            "false_northing": 0,
        },
    ),
    5070: (
        "NAD83 / Conus Albers",
        4269,
        "Albers_Conic_Equal_Area",
        {
            "standard_parallel_1": 29.5,
            "standard_parallel_2": 45.5,
            "latitude_of_center": 23,
            "longitude_of_center": -96,
            "false_easting": 0,
            "false_northing": 0,
        },
    ),
    3005: (
        "NAD83 / BC Albers",
        4269,
        "Albers_Conic_Equal_Area",
        {
            "standard_parallel_1": 50,
            "standard_parallel_2": 58.5,
            "latitude_of_center": 45,
            "longitude_of_center": -126,
            "false_easting": 1000000,
            "false_northing": 0,
        },
    ),
    3347: (
        "NAD83 / Statistics Canada Lambert",
        4269,
        "Lambert_Conformal_Conic_2SP",
        {
            "standard_parallel_1": 49,
            "standard_parallel_2": 77,
            "latitude_of_origin": 63.390675,
            "central_meridian": -91.86666666666666,
            "false_easting": 6200000,
            "false_northing": 3000000,
        },
    ),
    3031: (
        "WGS 84 / Antarctic Polar Stereographic",
        4326,
        "Polar_Stereographic_Variant_B",
        {
            "standard_parallel_1": -71,
            "central_meridian": 0,
            "false_easting": 0,
            "false_northing": 0,
        },
    ),
    3413: (
        "WGS 84 / NSIDC Sea Ice Polar Stereographic North",
        4326,
        "Polar_Stereographic_Variant_B",
        {
            "standard_parallel_1": 70,
            "central_meridian": -45,
            "false_easting": 0,
            "false_northing": 0,
        },
    ),
    32661: (
        "WGS 84 / UPS North (N,E)",
        4326,
        "Polar_Stereographic",
        {
            "latitude_of_origin": 90,
            "central_meridian": 0,
            "scale_factor": 0.994,
            "false_easting": 2000000,
            "false_northing": 2000000,
        },
    ),
    32761: (
        "WGS 84 / UPS South (N,E)",
        4326,
        "Polar_Stereographic",
        {
            "latitude_of_origin": -90,
            "central_meridian": 0,
            "scale_factor": 0.994,
            "false_easting": 2000000,
            "false_northing": 2000000,
        },
    ),
    2056: (
        "CH1903+ / LV95",
        4150,
        "Hotine_Oblique_Mercator_Azimuth_Center",
        {
            "latitude_of_center": 46.952405555555565,
            "longitude_of_center": 7.439583333333333,
            "azimuth": 90,
            "rectified_grid_angle": 90,
            "scale_factor": 1,
            "false_easting": 2600000,
            "false_northing": 1200000,
        },
    ),
    21781: (
        "CH1903 / LV03",
        4149,
        "Hotine_Oblique_Mercator_Azimuth_Center",
        {
            "latitude_of_center": 46.952405555555565,
            "longitude_of_center": 7.439583333333333,
            "azimuth": 90,
            "rectified_grid_angle": 90,
            "scale_factor": 1,
            "false_easting": 600000,
            "false_northing": 200000,
        },
    ),
    6933: (
        "WGS 84 / NSIDC EASE-Grid 2.0 Global",
        4326,
        "Lambert_Cylindrical_Equal_Area",
        {
            "standard_parallel_1": 30,
            "central_meridian": 0,
            "false_easting": 0,
            "false_northing": 0,
        },
    ),
    3035: (
        "ETRS89-extended / LAEA Europe",
        4258,
        "Lambert_Azimuthal_Equal_Area",
        {
            "latitude_of_center": 52,
            "longitude_of_center": 10,
            "false_easting": 4321000,
            "false_northing": 3210000,
        },
    ),
    2180: (
        "ETRS89 / Poland CS92",
        4258,
        "Transverse_Mercator",
        {
            "latitude_of_origin": 0,
            "central_meridian": 19,
            "scale_factor": 0.9993,
            "false_easting": 500000,
            "false_northing": -5300000,
        },
    ),
    5514: (
        "S-JTSK / Krovak East North",
        4156,
        "Krovak",
        {
            "latitude_of_center": 49.5,
            "longitude_of_center": 24.833333333333332,
            "azimuth": 30.288139722222223,
            "pseudo_standard_parallel_1": 78.5,
            "scale_factor": 0.9999,
            "false_easting": 0,
            "false_northing": 0,
        },
    ),
    29873: (
        "Timbalai 1948 / RSO Borneo (m)",
        4298,
        "Hotine_Oblique_Mercator_Azimuth_Center",
        {
            "latitude_of_center": 4,
            "longitude_of_center": 115,
            "azimuth": 53.31582047222222,
            "rectified_grid_angle": 53.13010236111111,
            "scale_factor": 0.99984,
            "false_easting": 590476.87,
            "false_northing": 442857.65,
        },
    ),
    3375: (
        "GDM2000 / Peninsula RSO",
        4742,
        "Hotine_Oblique_Mercator",
        {
            "latitude_of_center": 4,
            "longitude_of_center": 102.25,
            "azimuth": 323.0257964666666,
            "rectified_grid_angle": 323.1301023611111,
            "scale_factor": 0.99984,
            "false_easting": 804671,
            "false_northing": 0,
        },
    ),
}
# aliases resolving to the same definition
PROJECTED[3785] = PROJECTED[3857]  # deprecated Popular Visualisation CRS
PROJECTED[900913] = PROJECTED[3857]  # the original "google" code
# geographic CRSes referenced only by the singles above
GEOGRAPHIC[4313] = (
    "Belge 1972",
    "Reseau_National_Belge_1972",
    6313,
    7022,
    (-106.8686, 52.2978, -103.7239, 0.3366, -0.457, 1.8422, -1.2747),
)
GEOGRAPHIC[4289] = (
    "Amersfoort",
    "Amersfoort",
    6289,
    7004,
    (565.417, 50.3319, 465.552, -0.398957, 0.343988, -1.8774, 4.0725),
)
GEOGRAPHIC[4150] = (
    "CH1903+",
    "CH1903+",
    6150,
    7004,
    (674.374, 15.056, 405.346),
)
GEOGRAPHIC[4149] = (
    "CH1903",
    "CH1903",
    6149,
    7004,
    (674.4, 15.1, 405.3),
)
GEOGRAPHIC[4156] = (
    "S-JTSK",
    "System_Jednotne_Trigonometricke_Site_Katastralni",
    6156,
    7004,
    (589, 76, 480),
)
GEOGRAPHIC[4298] = (
    "Timbalai 1948",
    "Timbalai_1948",
    6298,
    7016,
    (-679, 669, -48),
)
GEOGRAPHIC[4742] = (
    "GDM2000",
    "Geodetic_Datum_of_Malaysia_2000",
    6742,
    7019,
    (0, 0, 0),
)

# -- UTM families: (low, high) code range ->
#    (geographic code, zone offset, south?) — zone = code - offset ---------

UTM_FAMILIES = [
    ((32601, 32660), 4326, 32600, False),  # WGS 84 north
    ((32701, 32760), 4326, 32700, True),  # WGS 84 south
    ((25828, 25838), 4258, 25800, False),  # ETRS89
    ((26901, 26923), 4269, 26900, False),  # NAD83
    ((26701, 26722), 4267, 26700, False),  # NAD27 (Clarke 1866)
    ((23028, 23038), 4230, 23000, False),  # ED50 (International 1924)
    ((28348, 28358), 4283, 28300, True),  # GDA94 / MGA
    ((7846, 7859), 7844, 7800, True),  # GDA2020 / MGA
]


def _fmt(v):
    """Float -> shortest exact WKT literal."""
    if isinstance(v, int) or (isinstance(v, float) and v == int(v)):
        return str(int(v))
    return repr(float(v))


def geographic_wkt(code):
    """EPSG geographic code -> WKT1 string, or None when unlisted."""
    entry = GEOGRAPHIC.get(code)
    if entry is None:
        return None
    name, datum, datum_code, ell_code, towgs84 = entry
    ell_name, a, invf = ELLIPSOIDS[ell_code]
    tw = ""
    if towgs84 is not None:
        vals = tuple(towgs84) + (0,) * (7 - len(towgs84))
        tw = f",TOWGS84[{','.join(_fmt(v) for v in vals)}]"
    return (
        f'GEOGCS["{name}",DATUM["{datum}",'
        f'SPHEROID["{ell_name}",{_fmt(a)},{_fmt(invf)},'
        f'AUTHORITY["EPSG","{ell_code}"]]{tw},'
        f'AUTHORITY["EPSG","{datum_code}"]],'
        f'PRIMEM["Greenwich",0,AUTHORITY["EPSG","8901"]],'
        f'UNIT["degree",0.0174532925199433,AUTHORITY["EPSG","9122"]],'
        f'AUTHORITY["EPSG","{code}"]]'
    )


def _projected_wkt(code, name, geog_code, method, params):
    geog = geographic_wkt(geog_code)
    if geog is None:
        return None
    param_wkt = "".join(
        f'PARAMETER["{k}",{_fmt(v)}],' for k, v in params.items()
    )
    return (
        f'PROJCS["{name}",{geog},PROJECTION["{method}"],{param_wkt}'
        f'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
        f'AUTHORITY["EPSG","{code}"]]'
    )


def _utm_family_wkt(code):
    for (lo, hi), geog_code, offset, south in UTM_FAMILIES:
        if lo <= code <= hi:
            zone = code - offset
            geog_name = GEOGRAPHIC[geog_code][0]
            return _projected_wkt(
                code,
                f"{geog_name} / UTM zone {zone}{'S' if south else 'N'}",
                geog_code,
                "Transverse_Mercator",
                {
                    "latitude_of_origin": 0,
                    "central_meridian": -183 + 6 * zone,
                    "scale_factor": 0.9996,
                    "false_easting": 500000,
                    "false_northing": 10000000 if south else 0,
                },
            )
    return None


def epsg_wkt(code):
    """EPSG code -> WKT1 string, or None when not in the registry."""
    got = geographic_wkt(code)
    if got is not None:
        return got
    entry = PROJECTED.get(code)
    if entry is not None:
        return _projected_wkt(code, *entry)
    return _utm_family_wkt(code)


def registry_summary():
    """Human-readable coverage list for the unknown-code error message."""
    geo = ",".join(str(c) for c in sorted(GEOGRAPHIC))
    proj = ",".join(str(c) for c in sorted(set(PROJECTED)))
    fams = "; ".join(
        f"{lo}-{hi} ({GEOGRAPHIC[g][0]} UTM)" for (lo, hi), g, _, _ in UTM_FAMILIES
    )
    return (
        f"geographic: {geo}; projected: {proj}; UTM families: {fams}"
    )
