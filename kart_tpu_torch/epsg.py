"""The built-in EPSG registry: ``make_crs("EPSG:n")`` without a PROJ
database.

Counterpart of kart_tpu's ``epsg.py`` for its geographic codes: the same
ellipsoid and geographic tables, expanded to the same WKT1 strings by
:func:`geographic_wkt`. The registry's projected codes (its individually
listed CRSes and its UTM families) are known here by code only: the
projections are not ported yet, so :func:`epsg_wkt` raises
``NotYetImplemented`` for them instead of returning a CRS the transforms
could not use. A code in neither list gives None, and the caller's error
lists the coverage (:func:`registry_summary`), as kart_tpu's does.
"""

from kart_tpu_torch.core.repo import NotYetImplemented

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
    7003: ("Australian National Spheroid", 6378160.0, 298.25),
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
    4272: ("NZGD49", "New_Zealand_Geodetic_Datum_1949", 6272, 7022,
           (59.47, -5.04, 187.44, 0.47, -0.1, 1.024, -4.5993)),
    4277: ("OSGB 1936", "OSGB_1936", 6277, 7001,
           (446.448, -125.157, 542.06, 0.15, 0.247, 0.842, -20.489)),
    4171: ("RGF93", "Reseau_Geodesique_Francais_1993", 6171, 7019, (0, 0, 0)),
    4230: ("ED50", "European_Datum_1950", 6230, 7022, (-87, -98, -121)),
    4301: ("Tokyo", "Tokyo", 6301, 7004, (-146.414, 507.337, 680.507)),
    4612: ("JGD2000", "Japanese_Geodetic_Datum_2000", 6612, 7019, (0, 0, 0)),
    6668: ("JGD2011", "Japanese_Geodetic_Datum_2011", 1128, 7019, (0, 0, 0)),
    4490: ("China Geodetic Coordinate System 2000", "China_2000", 1043, 1024, None),
    4674: ("SIRGAS 2000", "Sistema_de_Referencia_Geocentrico_para_las_AmericaS_2000",
           6674, 7019, (0, 0, 0)),
    4618: ("SAD69", "South_American_Datum_1969", 6618, 7050, (-57, 1, -41)),
    4202: ("AGD66", "Australian_Geodetic_Datum_1966", 6202, 7003,
           (-117.808, -51.536, 137.784, 0.303, 0.446, 0.234, -0.29)),
    4203: ("AGD84", "Australian_Geodetic_Datum_1984", 6203, 7003,
           (-117.763, -51.51, 139.061, -0.292, -0.443, -0.277, -0.191)),
    4312: ("MGI", "Militar_Geographische_Institut", 6312, 7004,
           (577.326, 90.129, 463.919, 5.137, 1.474, 5.297, 2.4232)),
    # the geographic bases of the registry's projected CRSes
    4313: ("Belge 1972", "Reseau_National_Belge_1972", 6313, 7022,
           (-106.8686, 52.2978, -103.7239, 0.3366, -0.457, 1.8422, -1.2747)),
    4289: ("Amersfoort", "Amersfoort", 6289, 7004,
           (565.417, 50.3319, 465.552, -0.398957, 0.343988, -1.8774, 4.0725)),
    4150: ("CH1903+", "CH1903+", 6150, 7004, (674.374, 15.056, 405.346)),
    4149: ("CH1903", "CH1903", 6149, 7004, (674.4, 15.1, 405.3)),
    4156: ("S-JTSK", "System_Jednotne_Trigonometricke_Site_Katastralni", 6156, 7004,
           (589, 76, 480)),
    4298: ("Timbalai 1948", "Timbalai_1948", 6298, 7016, (-679, 669, -48)),
    4742: ("GDM2000", "Geodetic_Datum_of_Malaysia_2000", 6742, 7019, (0, 0, 0)),
}

#: kart_tpu's individually listed projected CRSes (and their aliases 3785
#: and 900913 of 3857), known by code only
PROJECTED = frozenset({
    3857, 3785, 900913, 2193, 27700, 2154, 31370, 28992, 3577, 3112, 5070, 3005,
    3347, 3031, 3413, 32661, 32761, 2056, 21781, 6933, 3035, 2180, 5514, 29873, 3375,
})

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


def is_projected_code(code):
    """True for a projected code of the registry (listed or UTM family)."""
    return code in PROJECTED or any(lo <= code <= hi for (lo, hi), *_ in UTM_FAMILIES)


def epsg_wkt(code):
    """EPSG code -> WKT1 string for a geographic code, None when the code is
    not in the registry; a projected code raises NotYetImplemented."""
    got = geographic_wkt(code)
    if got is not None:
        return got
    if is_projected_code(code):
        raise NotYetImplemented(
            f"EPSG:{code} is a projected CRS; projections are not ported yet"
        )
    return None


def registry_summary():
    """Human-readable coverage list for the unknown-code error message."""
    geo = ",".join(str(c) for c in sorted(GEOGRAPHIC))
    proj = ",".join(str(c) for c in sorted(PROJECTED))
    fams = "; ".join(
        f"{lo}-{hi} ({GEOGRAPHIC[g][0]} UTM)" for (lo, hi), g, _, _ in UTM_FAMILIES
    )
    return f"geographic: {geo}; projected: {proj}; UTM families: {fams}"
