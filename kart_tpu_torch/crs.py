"""Coordinate reference systems, PROJ-free: a WKT parser that finds
authority identifiers and parameters, CRS equality by normalised WKT, and
vectorized numpy transforms between any two CRSes of the built-in engine.

Counterpart of kart_tpu's ``crs.py``, kept as a copy in kart_tpu's order of
floating-point operations so that every transform gives the same bits:
``WktNode``, ``parse_wkt_crs``, ``normalise_wkt``, the identifier helpers,
``make_crs`` (WKT and ``EPSG:n``: the curated WKTs first, then the
registry of :mod:`kart_tpu_torch.epsg`), ``CRS`` and ``Transform``. The
projections are ``_PROJ_IMPLS`` (transverse Mercator, Web Mercator,
Mercator 1SP/2SP, Lambert conformal conic 1SP/2SP, Albers, polar and
oblique stereographic, Lambert azimuthal equal area, cylindrical equal
area, Swiss oblique Mercator, Hotine oblique Mercator A/B and Krovak). The
datum shift goes through WGS84: an NTv2 grid registered with
:mod:`kart_tpu_torch.gridshift` (or found in ``$KART_NTV2_GRID_DIR``) wins
over the CRS's TOWGS84 7-parameter Helmert, and a CRS with neither is
taken as WGS84-equivalent. A projection the engine lacks parses, and its
transform raises :class:`CrsError` when it is used.

All of it is host numpy f64, as in kart_tpu: the card has no share in it.
"""

import math
import re

import numpy as np


class CrsError(ValueError):
    pass


# ---------------------------------------------------------------------------
# WKT node parsing — WKT1 and WKT2 both have the shape NAME[arg, arg, ...]
# ---------------------------------------------------------------------------


class WktNode:
    __slots__ = ("keyword", "args")

    def __init__(self, keyword, args):
        self.keyword = keyword
        self.args = args

    def find(self, *keywords, recursive=True):
        """First descendant node with one of the given keywords (case-insensitive)."""
        kws = {k.upper() for k in keywords}
        for a in self.args:
            if isinstance(a, WktNode):
                if a.keyword.upper() in kws:
                    return a
                if recursive:
                    found = a.find(*keywords)
                    if found is not None:
                        return found
        return None

    def find_all(self, *keywords):
        kws = {k.upper() for k in keywords}
        out = []
        for a in self.args:
            if isinstance(a, WktNode):
                if a.keyword.upper() in kws:
                    out.append(a)
                out.extend(a.find_all(*keywords))
        return out

    def str_args(self):
        return [a for a in self.args if isinstance(a, str)]

    def num_args(self):
        return [a for a in self.args if isinstance(a, (int, float))]

    def __repr__(self):
        return f"WktNode({self.keyword}, {self.args!r})"


_WKT_TOKENS = re.compile(
    r"""\s*(
        "(?:[^"]|"")*"          # quoted string
      | [A-Za-z_][A-Za-z0-9_]*  # keyword
      | [-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?  # number
      | [\[\](),]
    )""",
    re.VERBOSE,
)


def parse_wkt_crs(wkt):
    """WKT string -> WktNode tree. Accepts WKT1 and WKT2 ('[' or '(')."""
    tokens = _WKT_TOKENS.findall(wkt)
    if not tokens:
        raise CrsError("Empty CRS definition")
    node, pos = _parse_node(tokens, 0)
    return node


def _parse_node(tokens, pos):
    keyword = tokens[pos]
    pos += 1
    if pos >= len(tokens) or tokens[pos] not in "[(":
        return keyword, pos
    pos += 1
    args = []
    while tokens[pos] not in ")]":
        tok = tokens[pos]
        if tok == ",":
            pos += 1
            continue
        if tok.startswith('"'):
            args.append(tok[1:-1].replace('""', '"'))
            pos += 1
        elif re.fullmatch(r"[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?", tok):
            num = float(tok)
            args.append(int(num) if num == int(num) and "." not in tok else num)
            pos += 1
        else:
            child, pos = _parse_node(tokens, pos)
            if isinstance(child, WktNode):
                args.append(child)
            else:
                args.append(child)  # bare keyword (e.g. AXIS direction NORTH)
    return WktNode(keyword, args), pos + 1


def _write_node(node, indent=0, pretty=True):
    if not isinstance(node, WktNode):
        if isinstance(node, str):
            escaped = node.replace('"', '""')
            return f'"{escaped}"'
        if isinstance(node, float) and node == int(node):
            return str(node)
        return repr(node) if isinstance(node, float) else str(node)
    parts = [_write_node(a, indent + 1, pretty) for a in node.args]
    if pretty and any(isinstance(a, WktNode) for a in node.args):
        pad = "    " * (indent + 1)
        inner = (",\n" + pad).join(parts)
        return f"{node.keyword}[\n{pad}{inner}]"
    return f"{node.keyword}[{', '.join(parts)}]"


def normalise_wkt(wkt):
    """Canonical whitespace/indentation form (reference: crs_util.py uses a
    pygments lexer for the same purpose)."""
    if not wkt or not wkt.strip():
        return wkt
    try:
        return _write_node(parse_wkt_crs(wkt)) + "\n"
    except Exception:
        return wkt


# ---------------------------------------------------------------------------
# Authority identifiers & naming
# ---------------------------------------------------------------------------


def get_authority(wkt_or_node):
    """-> (authority_name, code) from the outermost AUTHORITY/ID node, or
    (None, None)."""
    node = (
        wkt_or_node
        if isinstance(wkt_or_node, WktNode)
        else parse_wkt_crs(wkt_or_node)
    )
    # The *last* top-level AUTHORITY node identifies the whole CRS in WKT1;
    # nested ones identify datums/units. Search direct children first.
    direct = [
        a
        for a in node.args
        if isinstance(a, WktNode) and a.keyword.upper() in ("AUTHORITY", "ID")
    ]
    found = direct[-1] if direct else node.find("AUTHORITY", "ID")
    if found is None:
        return None, None
    sargs = found.str_args() + [str(a) for a in found.num_args()]
    if len(sargs) >= 2:
        return sargs[0], sargs[1]
    return None, None


# Reserved code range for CRS with no real authority id
# (reference: crs_util.py:151-153).
MIN_CUSTOM_ID = 200000
MAX_CUSTOM_ID = 209199
_CUSTOM_RANGE = MAX_CUSTOM_ID - MIN_CUSTOM_ID + 1


def _generate_identifier_int(crs):
    """Stable custom code in [MIN_CUSTOM_ID, MAX_CUSTOM_ID], hashed from the
    normalised WKT so whitespace variants agree (reference: crs_util.py:156-176)."""
    from kart_tpu_torch.core.serialise import uint32hash

    text = crs if isinstance(crs, str) else _write_node(crs)
    return MIN_CUSTOM_ID + uint32hash(normalise_wkt(text)) % _CUSTOM_RANGE


def get_identifier_str(crs):
    """Authority string like ``EPSG:4326``, or ``CUSTOM:<code>`` for CRS
    without an authority. The custom code matches get_identifier_int
    (reference: crs_util.py:102-110)."""
    auth, code = get_authority(crs)
    if auth and code:
        return f"{auth}:{code}"
    return f"CUSTOM:{_generate_identifier_int(crs)}"


def get_identifier_int(crs):
    """Integer id for srs_id fields: the authority code when known, else the
    same stable custom code as get_identifier_str."""
    auth, code = get_authority(crs)
    if code is not None and str(code).isdigit():
        return int(code)
    return _generate_identifier_int(crs)


def parse_name(crs):
    node = crs if isinstance(crs, WktNode) else parse_wkt_crs(crs)
    sargs = node.str_args()
    return sargs[0] if sargs else None


# ---------------------------------------------------------------------------
# Well-known CRS definitions (no PROJ database available)
# ---------------------------------------------------------------------------

WGS84_WKT = (
    'GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",6378137,298.257223563,'
    'AUTHORITY["EPSG","7030"]],AUTHORITY["EPSG","6326"]],'
    'PRIMEM["Greenwich",0,AUTHORITY["EPSG","8901"]],'
    'UNIT["degree",0.0174532925199433,AUTHORITY["EPSG","9122"]],'
    'AUTHORITY["EPSG","4326"]]'
)

WEB_MERCATOR_WKT = (
    'PROJCS["WGS 84 / Pseudo-Mercator",GEOGCS["WGS 84",DATUM["WGS_1984",'
    'SPHEROID["WGS 84",6378137,298.257223563,AUTHORITY["EPSG","7030"]],'
    'AUTHORITY["EPSG","6326"]],PRIMEM["Greenwich",0,AUTHORITY["EPSG","8901"]],'
    'UNIT["degree",0.0174532925199433,AUTHORITY["EPSG","9122"]],'
    'AUTHORITY["EPSG","4326"]],PROJECTION["Mercator_1SP"],'
    'PARAMETER["central_meridian",0],PARAMETER["scale_factor",1],'
    'PARAMETER["false_easting",0],PARAMETER["false_northing",0],'
    'UNIT["metre",1,AUTHORITY["EPSG","9001"]],AUTHORITY["EPSG","3857"]]'
)

NZTM_WKT = (
    'PROJCS["NZGD2000 / New Zealand Transverse Mercator 2000",'
    'GEOGCS["NZGD2000",DATUM["New_Zealand_Geodetic_Datum_2000",'
    'SPHEROID["GRS 1980",6378137,298.257222101,AUTHORITY["EPSG","7019"]],'
    'AUTHORITY["EPSG","6167"]],PRIMEM["Greenwich",0,AUTHORITY["EPSG","8901"]],'
    'UNIT["degree",0.0174532925199433,AUTHORITY["EPSG","9122"]],'
    'AUTHORITY["EPSG","4167"]],PROJECTION["Transverse_Mercator"],'
    'PARAMETER["latitude_of_origin",0],PARAMETER["central_meridian",173],'
    'PARAMETER["scale_factor",0.9996],PARAMETER["false_easting",1600000],'
    'PARAMETER["false_northing",10000000],UNIT["metre",1,'
    'AUTHORITY["EPSG","9001"]],AUTHORITY["EPSG","2193"]]'
)

NZGD2000_WKT = (
    'GEOGCS["NZGD2000",DATUM["New_Zealand_Geodetic_Datum_2000",'
    'SPHEROID["GRS 1980",6378137,298.257222101,AUTHORITY["EPSG","7019"]],'
    'AUTHORITY["EPSG","6167"]],PRIMEM["Greenwich",0,AUTHORITY["EPSG","8901"]],'
    'UNIT["degree",0.0174532925199433,AUTHORITY["EPSG","9122"]],'
    'AUTHORITY["EPSG","4167"]]'
)

_WELL_KNOWN = {
    4326: WGS84_WKT,
    3857: WEB_MERCATOR_WKT,
    2193: NZTM_WKT,
    4167: NZGD2000_WKT,
}


def make_crs(user_input):
    """User input (WKT, 'EPSG:n') -> CRS object (reference: crs_util.py:17-32).

    Bare EPSG codes resolve first against the curated WKT strings above,
    then the built-in parameter registry (kart_tpu_torch/epsg.py: common
    geographic + projected CRSes and whole UTM families, synthesized to
    WKT1). Codes outside the registry raise a CrsError that lists the
    coverage — the reference resolves these via OSR/PROJ's database, which
    this build deliberately doesn't carry."""
    if isinstance(user_input, CRS):
        return user_input
    text = user_input.strip()
    m = re.fullmatch(r"(?i)EPSG:(\d+)", text)
    if m:
        code = int(m.group(1))
        if code in _WELL_KNOWN:
            return CRS(_WELL_KNOWN[code])
        from kart_tpu_torch import epsg

        wkt = epsg.epsg_wkt(code)
        if wkt is not None:
            return CRS(wkt)
        raise CrsError(
            f"EPSG:{code} is not in the built-in CRS registry (this build "
            f"carries no PROJ database); supply the full WKT definition "
            f"instead. Built-in coverage — {epsg.registry_summary()}"
        )
    return CRS(text)


class CRS:
    """A parsed CRS: enough structure to identify it and to run the built-in
    transforms. Unknown projections parse fine but refuse to transform."""

    def __init__(self, wkt):
        self.wkt = wkt
        self.node = parse_wkt_crs(wkt)
        kw = self.node.keyword.upper()
        self.is_geographic = kw in ("GEOGCS", "GEOGCRS", "GEODCRS")
        self.is_projected = kw in ("PROJCS", "PROJCRS")
        self.name = parse_name(self.node)
        self.authority, self.code = get_authority(self.node)

        sph = self.node.find("SPHEROID", "ELLIPSOID")
        if sph is not None:
            nums = sph.num_args()
            self.semi_major = float(nums[0]) if nums else 6378137.0
            inv_f = float(nums[1]) if len(nums) > 1 else 298.257223563
            self.inv_flattening = inv_f
        else:
            self.semi_major, self.inv_flattening = 6378137.0, 298.257223563

        self.projection = None
        self.params = {}
        if self.is_projected:
            proj = self.node.find("PROJECTION")
            if proj is not None:
                sargs = proj.str_args()
                self.projection = sargs[0] if sargs else None
            for p in self.node.find_all("PARAMETER"):
                sargs = p.str_args()
                nums = p.num_args()
                if sargs and nums:
                    self.params[sargs[0].lower()] = float(nums[0])
            # Web-mercator WKT1 exports commonly claim Mercator_1SP but the
            # method is the *spherical* pseudo-mercator. Recognise it by
            # authority code, CRS name, or a PROJ4 EXTENSION forcing the
            # sphere (+b == +a / +nadgrids=@null)
            if (self.projection or "").lower() == "mercator_1sp":
                ext = self.node.find("EXTENSION")
                ext_text = " ".join(ext.str_args()) if ext is not None else ""
                is_web_mercator = (
                    str(self.code) in ("3857", "3785", "900913", "102100", "102113")
                    or "pseudo-mercator" in (self.name or "").lower()
                    or "+nadgrids=@null" in ext_text
                    or "+b=6378137" in ext_text
                )
                if is_web_mercator:
                    self.projection = "popular_visualisation_pseudo_mercator"

        # datum shift to WGS84 (WKT1 TOWGS84): 3- or 7-parameter Helmert,
        # (dx, dy, dz[, rx, ry, rz, scale_ppm]); None = datum treated as
        # WGS84-equivalent (the pre-round-2 behavior, within ~1m for modern
        # datums)
        self.towgs84 = None
        tw = self.node.find("TOWGS84")
        if tw is not None:
            nums = [float(v) for v in tw.num_args()]
            if len(nums) >= 3:
                self.towgs84 = tuple((nums + [0.0] * 7)[:7])
        datum = self.node.find("DATUM")
        self.datum_name = (
            datum.str_args()[0] if datum is not None and datum.str_args() else None
        )

    @property
    def identifier_str(self):
        return get_identifier_str(self.node)

    @property
    def identifier_int(self):
        return get_identifier_int(self.node)

    def __eq__(self, other):
        return isinstance(other, CRS) and normalise_wkt(self.wkt) == normalise_wkt(
            other.wkt
        )

    def __hash__(self):
        return hash(normalise_wkt(self.wkt))

    def __repr__(self):
        return f"CRS({self.identifier_str} {self.name!r})"


# ---------------------------------------------------------------------------
# Transforms (vectorized numpy)
# ---------------------------------------------------------------------------


def _tm_constants(a, inv_f):
    f = 1.0 / inv_f
    e2 = f * (2 - f)
    n = f / (2 - f)
    # series coefficients for the Krueger transverse mercator (order n^4)
    A = a / (1 + n) * (1 + n**2 / 4 + n**4 / 64)
    alpha = np.array(
        [
            n / 2 - 2 * n**2 / 3 + 5 * n**3 / 16 + 41 * n**4 / 180,
            13 * n**2 / 48 - 3 * n**3 / 5 + 557 * n**4 / 1440,
            61 * n**3 / 240 - 103 * n**4 / 140,
            49561 * n**4 / 161280,
        ]
    )
    beta = np.array(
        [
            n / 2 - 2 * n**2 / 3 + 37 * n**3 / 96 - 1 * n**4 / 360,
            1 * n**2 / 48 + 1 * n**3 / 15 - 437 * n**4 / 1440,
            17 * n**3 / 480 - 37 * n**4 / 840,
            4397 * n**4 / 161280,
        ]
    )
    delta = np.array(
        [
            2 * n - 2 * n**2 / 3 - 2 * n**3 + 116 * n**4 / 45,
            7 * n**2 / 3 - 8 * n**3 / 5 - 227 * n**4 / 45,
            56 * n**3 / 15 - 136 * n**4 / 35,
            4279 * n**4 / 630,
        ]
    )
    return e2, A, alpha, beta, delta


def _tm_forward(crs, lon_deg, lat_deg):
    a, inv_f = crs.semi_major, crs.inv_flattening
    e2, A, alpha, _, _ = _tm_constants(a, inv_f)
    e = math.sqrt(e2)
    k0 = crs.params.get("scale_factor", 1.0)
    lat0 = math.radians(crs.params.get("latitude_of_origin", 0.0))
    lon0 = math.radians(crs.params.get("central_meridian", 0.0))
    fe = crs.params.get("false_easting", 0.0)
    fn = crs.params.get("false_northing", 0.0)

    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))

    # conformal latitude
    t = np.sinh(
        np.arctanh(np.sin(lat)) - e * np.arctanh(e * np.sin(lat))
    )
    xi_p = np.arctan2(t, np.cos(lon - lon0))
    eta_p = np.arctanh(np.sin(lon - lon0) / np.sqrt(1 + t**2))

    j = np.arange(1, 5)
    xi = xi_p + np.sum(
        alpha[None, :]
        * np.sin(2 * j[None, :] * xi_p[..., None])
        * np.cosh(2 * j[None, :] * eta_p[..., None]),
        axis=-1,
    )
    eta = eta_p + np.sum(
        alpha[None, :]
        * np.cos(2 * j[None, :] * xi_p[..., None])
        * np.sinh(2 * j[None, :] * eta_p[..., None]),
        axis=-1,
    )

    # meridian distance from equator to lat0
    if lat0 != 0.0:
        t0 = math.sinh(
            math.atanh(math.sin(lat0)) - e * math.atanh(e * math.sin(lat0))
        )
        xi0 = math.atan2(t0, 1.0)
        m0 = A * (
            xi0
            + float(np.sum(alpha * np.sin(2 * np.arange(1, 5) * xi0)))
        )
    else:
        m0 = 0.0

    x = fe + k0 * A * eta
    y = fn + k0 * (A * xi - m0)
    return x, y


def _tm_inverse(crs, x, y):
    a, inv_f = crs.semi_major, crs.inv_flattening
    e2, A, alpha, beta, delta = _tm_constants(a, inv_f)
    e = math.sqrt(e2)
    k0 = crs.params.get("scale_factor", 1.0)
    lat0 = math.radians(crs.params.get("latitude_of_origin", 0.0))
    lon0 = math.radians(crs.params.get("central_meridian", 0.0))
    fe = crs.params.get("false_easting", 0.0)
    fn = crs.params.get("false_northing", 0.0)

    if lat0 != 0.0:
        t0 = math.sinh(
            math.atanh(math.sin(lat0)) - e * math.atanh(e * math.sin(lat0))
        )
        xi0 = math.atan2(t0, 1.0)
        m0 = A * (xi0 + float(np.sum(alpha * np.sin(2 * np.arange(1, 5) * xi0))))
    else:
        m0 = 0.0

    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    xi = (y - fn + k0 * m0) / (k0 * A)
    eta = (x - fe) / (k0 * A)

    j = np.arange(1, 5)
    xi_p = xi - np.sum(
        beta[None, :]
        * np.sin(2 * j[None, :] * xi[..., None])
        * np.cosh(2 * j[None, :] * eta[..., None]),
        axis=-1,
    )
    eta_p = eta - np.sum(
        beta[None, :]
        * np.cos(2 * j[None, :] * xi[..., None])
        * np.sinh(2 * j[None, :] * eta[..., None]),
        axis=-1,
    )
    chi = np.arcsin(np.sin(xi_p) / np.cosh(eta_p))
    lat = chi + np.sum(
        delta[None, :] * np.sin(2 * j[None, :] * chi[..., None]), axis=-1
    )
    lon = lon0 + np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    return np.degrees(lon), np.degrees(lat)


def _webmerc_forward(crs, lon_deg, lat_deg):
    """Spherical (web) mercator — EPSG 1024, used by 3857."""
    a = crs.semi_major
    lon0 = math.radians(crs.params.get("central_meridian", 0.0))
    fe = crs.params.get("false_easting", 0.0)
    fn = crs.params.get("false_northing", 0.0)
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64)) - lon0
    lat = np.radians(np.clip(np.asarray(lat_deg, dtype=np.float64), -89.9999, 89.9999))
    return fe + a * lon, fn + a * np.log(np.tan(np.pi / 4 + lat / 2))


def _webmerc_inverse(crs, x, y):
    a = crs.semi_major
    lon0 = crs.params.get("central_meridian", 0.0)
    fe = crs.params.get("false_easting", 0.0)
    fn = crs.params.get("false_northing", 0.0)
    lon = lon0 + np.degrees((np.asarray(x, dtype=np.float64) - fe) / a)
    lat = np.degrees(
        2 * np.arctan(np.exp((np.asarray(y, dtype=np.float64) - fn) / a)) - np.pi / 2
    )
    return lon, lat


def _mercator_k0(crs):
    """1SP: explicit scale factor. 2SP: k0 = m(standard_parallel_1)."""
    if "standard_parallel_1" in crs.params:
        sp1 = math.radians(crs.params["standard_parallel_1"])
        e2 = _e2_of(crs)
        return math.cos(sp1) / math.sqrt(1 - e2 * math.sin(sp1) ** 2)
    return crs.params.get("scale_factor", 1.0)


def _mercator_forward(crs, lon_deg, lat_deg):
    """Ellipsoidal Mercator (EPSG 9804 1SP / 9805 2SP) — e.g. EPSG:3832
    PDC Mercator (central_meridian 150) and EPSG:3994."""
    a = crs.semi_major
    e = math.sqrt(_e2_of(crs))
    k0 = _mercator_k0(crs)
    lon0 = math.radians(crs.params.get("central_meridian", 0.0))
    fe = crs.params.get("false_easting", 0.0)
    fn = crs.params.get("false_northing", 0.0)
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64)) - lon0
    lat = np.radians(np.clip(np.asarray(lat_deg, dtype=np.float64), -89.9999, 89.9999))
    sin_lat = np.sin(lat)
    x = fe + a * k0 * lon
    y = fn + a * k0 * np.log(
        np.tan(np.pi / 4 + lat / 2)
        * ((1 - e * sin_lat) / (1 + e * sin_lat)) ** (e / 2)
    )
    return x, y


def _mercator_inverse(crs, x, y):
    a = crs.semi_major
    e = math.sqrt(_e2_of(crs))
    k0 = _mercator_k0(crs)
    lon0 = crs.params.get("central_meridian", 0.0)
    fe = crs.params.get("false_easting", 0.0)
    fn = crs.params.get("false_northing", 0.0)
    lon = lon0 + np.degrees((np.asarray(x, dtype=np.float64) - fe) / (a * k0))
    t = np.exp(-(np.asarray(y, dtype=np.float64) - fn) / (a * k0))
    lat = np.pi / 2 - 2 * np.arctan(t)
    for _ in range(6):
        sin_lat = np.sin(lat)
        lat = np.pi / 2 - 2 * np.arctan(
            t * ((1 - e * sin_lat) / (1 + e * sin_lat)) ** (e / 2)
        )
    return lon, np.degrees(lat)


def _lcc_setup(crs):
    """Shared constants for Lambert Conformal Conic (Snyder 1987, §15;
    EPSG methods 9801 1SP / 9802 2SP). 1SP is the 2SP degenerate case with
    both standard parallels at latitude_of_origin and k0 applied."""
    a = crs.semi_major
    e2 = _e2_of(crs)  # treats inv_flattening == 0 as a sphere (e2 = 0)
    e = math.sqrt(e2)

    def m(phi):
        return math.cos(phi) / math.sqrt(1 - e2 * math.sin(phi) ** 2)

    def t(phi):
        return math.tan(math.pi / 4 - phi / 2) / (
            (1 - e * math.sin(phi)) / (1 + e * math.sin(phi))
        ) ** (e / 2)

    p = crs.params
    lat0 = math.radians(p.get("latitude_of_origin", 0.0))
    lon0 = math.radians(p.get("central_meridian", 0.0))
    fe = p.get("false_easting", 0.0)
    fn = p.get("false_northing", 0.0)
    sp1 = math.radians(p.get("standard_parallel_1", math.degrees(lat0)))
    sp2 = math.radians(p.get("standard_parallel_2", math.degrees(sp1)))
    k0 = p.get("scale_factor", 1.0)

    if abs(sp1 - sp2) > 1e-12:
        n = (math.log(m(sp1)) - math.log(m(sp2))) / (
            math.log(t(sp1)) - math.log(t(sp2))
        )
    else:
        n = math.sin(sp1)
    F = m(sp1) / (n * t(sp1) ** n)
    rho0 = a * k0 * F * t(lat0) ** n
    return a, e, n, F * k0, rho0, lat0, lon0, fe, fn


def _lcc_forward(crs, lon_deg, lat_deg):
    a, e, n, Fk, rho0, lat0, lon0, fe, fn = _lcc_setup(crs)
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    lat = np.radians(
        np.clip(np.asarray(lat_deg, dtype=np.float64), -89.9999, 89.9999)
    )
    t = np.tan(np.pi / 4 - lat / 2) / (
        (1 - e * np.sin(lat)) / (1 + e * np.sin(lat))
    ) ** (e / 2)
    # southern-hemisphere cones have n, F (and so rho) negative — the
    # standard formulas handle that with no special-casing (Snyder p.107)
    rho = a * Fk * t**n
    theta = n * (lon - lon0)
    x = fe + rho * np.sin(theta)
    y = fn + rho0 - rho * np.cos(theta)
    return x, y


def _lcc_inverse(crs, x, y):
    a, e, n, Fk, rho0, lat0, lon0, fe, fn = _lcc_setup(crs)
    x = np.asarray(x, dtype=np.float64) - fe
    y = rho0 - (np.asarray(y, dtype=np.float64) - fn)
    rho = np.sign(n) * np.sqrt(x**2 + y**2)
    theta = np.arctan2(np.sign(n) * x, np.sign(n) * y)
    with np.errstate(divide="ignore", invalid="ignore"):
        tp = (rho / (a * Fk)) ** (1.0 / n)
    # iterate the conformal-latitude inversion (converges in a few rounds)
    phi = np.pi / 2 - 2 * np.arctan(tp)
    for _ in range(8):
        phi = np.pi / 2 - 2 * np.arctan(
            tp * ((1 - e * np.sin(phi)) / (1 + e * np.sin(phi))) ** (e / 2)
        )
    lon = theta / n + lon0
    return np.degrees(lon), np.degrees(phi)


def _q_of(e, e2, sin_lat):
    """Snyder's authalic q (3-12); works on scalars and arrays."""
    if e == 0:
        return 2 * sin_lat
    return (1 - e2) * (
        sin_lat / (1 - e2 * sin_lat**2)
        - (1 / (2 * e)) * np.log((1 - e * sin_lat) / (1 + e * sin_lat))
    )


def _albers_setup(crs):
    """Albers Equal-Area Conic constants (Snyder 1987 §14; EPSG 9822)."""
    a = crs.semi_major
    e2 = _e2_of(crs)
    e = math.sqrt(e2)

    def m(phi):
        return math.cos(phi) / math.sqrt(1 - e2 * math.sin(phi) ** 2)

    def q(phi):
        return float(_q_of(e, e2, math.sin(phi)))

    p = crs.params
    lat0 = math.radians(p.get("latitude_of_origin", p.get("latitude_of_center", 0.0)))
    lon0 = math.radians(p.get("central_meridian", p.get("longitude_of_center", 0.0)))
    fe = p.get("false_easting", 0.0)
    fn = p.get("false_northing", 0.0)
    sp1 = math.radians(p.get("standard_parallel_1", math.degrees(lat0)))
    sp2 = math.radians(p.get("standard_parallel_2", math.degrees(sp1)))

    if abs(sp1 - sp2) > 1e-12:
        n = (m(sp1) ** 2 - m(sp2) ** 2) / (q(sp2) - q(sp1))
    else:
        n = math.sin(sp1)
    C = m(sp1) ** 2 + n * q(sp1)
    rho0 = a * math.sqrt(max(C - n * q(lat0), 0.0)) / n
    return a, e, e2, n, C, rho0, lon0, fe, fn


def _albers_forward(crs, lon_deg, lat_deg):
    a, e, e2, n, C, rho0, lon0, fe, fn = _albers_setup(crs)
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    q = _q_of(e, e2, np.sin(lat))
    rho = a * np.sqrt(np.maximum(C - n * q, 0.0)) / n
    theta = n * (lon - lon0)
    x = fe + rho * np.sin(theta)
    y = fn + rho0 - rho * np.cos(theta)
    return x, y


def _albers_inverse(crs, x, y):
    a, e, e2, n, C, rho0, lon0, fe, fn = _albers_setup(crs)
    x = np.asarray(x, dtype=np.float64) - fe
    y = rho0 - (np.asarray(y, dtype=np.float64) - fn)
    rho = np.sign(n) * np.sqrt(x**2 + y**2)
    theta = np.arctan2(np.sign(n) * x, np.sign(n) * y)
    q = (C - (rho * n / a) ** 2) / n
    if e == 0:
        phi = np.arcsin(np.clip(q / 2, -1.0, 1.0))
    else:
        # iterate Snyder (3-16); q at the pole is qp = q(pi/2)
        qp = _q_of(e, e2, 1.0)
        phi = np.arcsin(np.clip(q / 2, -1.0, 1.0))
        for _ in range(8):
            s = np.sin(phi)
            # Snyder (3-16): the bracket is (q - q(phi)) / (1 - e2)
            phi = phi + (1 - e2 * s**2) ** 2 / (2 * np.cos(phi)) * (
                (q - _q_of(e, e2, s)) / (1 - e2)
            )
        # exactly-polar q would divide by cos(phi)=0 above; clamp handles it
        phi = np.where(np.abs(q) >= np.abs(qp) - 1e-12, np.sign(q) * np.pi / 2, phi)
    lon = lon0 + theta / n
    return np.degrees(lon), np.degrees(phi)


def _polar_stereo_setup(crs):
    """Polar Stereographic (Snyder 1987 §21; EPSG 9810 variant A via
    scale_factor at the pole, 9829 variant B via a standard parallel)."""
    a = crs.semi_major
    e2 = _e2_of(crs)
    e = math.sqrt(e2)
    p = crs.params
    lat0 = p.get("latitude_of_origin", p.get("standard_parallel_1", 90.0))
    south = lat0 < 0
    lon0 = math.radians(p.get("central_meridian", p.get("longitude_of_origin", 0.0)))
    fe = p.get("false_easting", 0.0)
    fn = p.get("false_northing", 0.0)
    k0 = p.get("scale_factor", 1.0)

    def t_of(phi):
        return math.tan(math.pi / 4 - phi / 2) / (
            (1 - e * math.sin(phi)) / (1 + e * math.sin(phi))
        ) ** (e / 2)

    if abs(abs(lat0) - 90.0) > 1e-9:
        # variant B: the scale is set by the standard parallel
        phi_f = math.radians(abs(lat0))
        m_f = math.cos(phi_f) / math.sqrt(1 - e2 * math.sin(phi_f) ** 2)
        rho_factor = a * m_f / t_of(phi_f)
    else:
        rho_factor = (
            2 * a * k0 / math.sqrt((1 + e) ** (1 + e) * (1 - e) ** (1 - e))
        )
    return a, e, south, lon0, fe, fn, rho_factor


def _polar_stereo_forward(crs, lon_deg, lat_deg):
    a, e, south, lon0, fe, fn, rho_factor = _polar_stereo_setup(crs)
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    if south:
        lat = -lat
        lon = -(lon - lon0)
    else:
        lon = lon - lon0
    t = np.tan(np.pi / 4 - lat / 2) / (
        (1 - e * np.sin(lat)) / (1 + e * np.sin(lat))
    ) ** (e / 2)
    rho = rho_factor * t
    x = rho * np.sin(lon)
    y = -rho * np.cos(lon)
    if south:
        x, y = -x, -y
    return fe + x, fn + y


def _polar_stereo_inverse(crs, x, y):
    a, e, south, lon0, fe, fn, rho_factor = _polar_stereo_setup(crs)
    x = np.asarray(x, dtype=np.float64) - fe
    y = np.asarray(y, dtype=np.float64) - fn
    if south:
        x, y = -x, -y
    rho = np.sqrt(x**2 + y**2)
    t = rho / rho_factor
    phi = np.pi / 2 - 2 * np.arctan(t)
    for _ in range(8):
        phi = np.pi / 2 - 2 * np.arctan(
            t * ((1 - e * np.sin(phi)) / (1 + e * np.sin(phi))) ** (e / 2)
        )
    lon = np.arctan2(x, -y)
    if south:
        phi = -phi
        lon = lon0 - lon
    else:
        lon = lon0 + lon
    return np.degrees(lon), np.degrees(phi)


def _oblique_stereo_setup(crs):
    """Oblique (double) Stereographic — EPSG 9809, the RD New / Amersfoort
    method: conformal-sphere projection of the conformal latitude (EPSG
    Guidance Note 7-2 §3.2.2.1)."""
    a = crs.semi_major
    e2 = _e2_of(crs)
    e = math.sqrt(e2)
    p = crs.params
    phi0 = math.radians(p.get("latitude_of_origin", 0.0))
    lam0 = math.radians(p.get("central_meridian", 0.0))
    fe = p.get("false_easting", 0.0)
    fn = p.get("false_northing", 0.0)
    k0 = p.get("scale_factor", 1.0)

    s0 = math.sin(phi0)
    rho0 = a * (1 - e2) / (1 - e2 * s0 * s0) ** 1.5
    nu0 = a / math.sqrt(1 - e2 * s0 * s0)
    R = math.sqrt(rho0 * nu0)
    n = math.sqrt(1 + e2 * math.cos(phi0) ** 4 / (1 - e2))

    S1 = (1 + s0) / (1 - s0)
    S2 = (1 - e * s0) / (1 + e * s0)
    w1 = (S1 * S2**e) ** n
    sin_chi00 = (w1 - 1) / (w1 + 1)
    c = (n + s0) * (1 - sin_chi00) / ((n - s0) * (1 + sin_chi00))
    w2 = c * w1
    chi0 = math.asin((w2 - 1) / (w2 + 1))
    return e, n, c, R, k0, chi0, phi0, lam0, fe, fn


def _oblique_stereo_forward(crs, lon_deg, lat_deg):
    e, n, c, R, k0, chi0, phi0, lam0, fe, fn = _oblique_stereo_setup(crs)
    lam = np.radians(np.asarray(lon_deg, dtype=np.float64))
    # exact poles make (1+sin)/(1-sin) blow up; same clamp as mercator/lcc
    phi = np.radians(
        np.clip(np.asarray(lat_deg, dtype=np.float64), -89.9999, 89.9999)
    )
    s = np.sin(phi)
    Sa = (1 + s) / (1 - s)
    Sb = (1 - e * s) / (1 + e * s)
    w = c * (Sa * Sb**e) ** n
    chi = np.arcsin((w - 1) / (w + 1))
    dlam = n * (lam - lam0)
    B = 1 + np.sin(chi) * np.sin(chi0) + np.cos(chi) * np.cos(chi0) * np.cos(dlam)
    x = fe + 2 * R * k0 * np.cos(chi) * np.sin(dlam) / B
    y = fn + 2 * R * k0 * (
        np.sin(chi) * np.cos(chi0) - np.cos(chi) * np.sin(chi0) * np.cos(dlam)
    ) / B
    return x, y


def _oblique_stereo_inverse(crs, x, y):
    e, n, c, R, k0, chi0, phi0, lam0, fe, fn = _oblique_stereo_setup(crs)
    xp = np.asarray(x, dtype=np.float64) - fe
    yp = np.asarray(y, dtype=np.float64) - fn
    g = 2 * R * k0 * math.tan(math.pi / 4 - chi0 / 2)
    h = 4 * R * k0 * math.tan(chi0) + g
    i = np.arctan2(xp, h + yp)
    j = np.arctan2(xp, g - yp) - i
    chi = chi0 + 2 * np.arctan((yp - xp * np.tan(j / 2)) / (2 * R * k0))
    dlam = j + 2 * i
    lam = dlam / n + lam0
    # isometric latitude of the conformal sphere -> ellipsoidal latitude
    psi = 0.5 * np.log((1 + np.sin(chi)) / (c * (1 - np.sin(chi)))) / n
    phi = 2 * np.arctan(np.exp(psi)) - np.pi / 2
    for _ in range(8):
        s = np.sin(phi)
        psi_i = np.log(
            np.tan(phi / 2 + np.pi / 4) * ((1 - e * s) / (1 + e * s)) ** (e / 2)
        )
        phi = phi - (psi_i - psi) * np.cos(phi) * (1 - e**2 * s**2) / (1 - e**2)
    return np.degrees(lam), np.degrees(phi)


def _laea_setup(crs):
    """Lambert Azimuthal Equal Area, oblique/equatorial aspect (EPSG method
    9820, Guidance Note 7-2 §3.2.2; Snyder 1987 §24). The polar aspect
    (|lat0| = 90) has a different formula set and is refused loudly."""
    a = crs.semi_major
    e2 = _e2_of(crs)
    e = math.sqrt(e2)
    p = crs.params
    lat0 = math.radians(p.get("latitude_of_origin", p.get("latitude_of_center", 0.0)))
    lon0 = math.radians(p.get("central_meridian", p.get("longitude_of_center", 0.0)))
    fe = p.get("false_easting", 0.0)
    fn = p.get("false_northing", 0.0)
    if abs(abs(lat0) - math.pi / 2) < 1e-9:
        raise CrsError(
            "Polar-aspect Lambert Azimuthal Equal Area is not supported by "
            "the built-in transform engine"
        )
    qp = float(_q_of(e, e2, 1.0))
    q0 = float(_q_of(e, e2, math.sin(lat0)))
    beta0 = math.asin(q0 / qp)
    rq = a * math.sqrt(qp / 2.0)
    d = (
        a
        * (math.cos(lat0) / math.sqrt(1 - e2 * math.sin(lat0) ** 2))
        / (rq * math.cos(beta0))
    )
    return a, e, e2, qp, beta0, rq, d, lon0, fe, fn


def _laea_forward(crs, lon_deg, lat_deg):
    a, e, e2, qp, beta0, rq, d, lon0, fe, fn = _laea_setup(crs)
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    lat = np.radians(
        np.clip(np.asarray(lat_deg, dtype=np.float64), -89.9999, 89.9999)
    )
    q = _q_of(e, e2, np.sin(lat))
    beta = np.arcsin(np.clip(q / qp, -1.0, 1.0))
    dlon = lon - lon0
    denom = 1.0 + math.sin(beta0) * np.sin(beta) + math.cos(beta0) * np.cos(
        beta
    ) * np.cos(dlon)
    b = rq * np.sqrt(2.0 / np.maximum(denom, 1e-12))
    x = fe + (b * d) * np.cos(beta) * np.sin(dlon)
    y = fn + (b / d) * (
        math.cos(beta0) * np.sin(beta)
        - math.sin(beta0) * np.cos(beta) * np.cos(dlon)
    )
    return x, y


def _laea_inverse(crs, x, y):
    a, e, e2, qp, beta0, rq, d, lon0, fe, fn = _laea_setup(crs)
    xs = (np.asarray(x, dtype=np.float64) - fe) / d
    ys = (np.asarray(y, dtype=np.float64) - fn) * d
    rho = np.sqrt(xs**2 + ys**2)
    c = 2.0 * np.arcsin(np.clip(rho / (2.0 * rq), -1.0, 1.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        beta_p = np.arcsin(
            np.clip(
                np.cos(c) * math.sin(beta0)
                + np.where(rho == 0, 0.0, ys * np.sin(c) * math.cos(beta0) / rho),
                -1.0,
                1.0,
            )
        )
    # EPSG GN7-2: atan2((E-FE) sinC, D rho cosB0 cosC - D^2 (N-FN) sinB0 sinC)
    # with xs = (E-FE)/D and ys = D (N-FN), both args divide by D:
    lon = lon0 + np.arctan2(
        xs * np.sin(c),
        rho * math.cos(beta0) * np.cos(c)
        - ys * math.sin(beta0) * np.sin(c),
    )
    # authalic -> geodetic latitude series (Snyder 3-18)
    e4 = e2 * e2
    e6 = e4 * e2
    phi = (
        beta_p
        + (e2 / 3 + 31 * e4 / 180 + 517 * e6 / 5040) * np.sin(2 * beta_p)
        + (23 * e4 / 360 + 251 * e6 / 3780) * np.sin(4 * beta_p)
        + (761 * e6 / 45360) * np.sin(6 * beta_p)
    )
    phi = np.where(rho == 0, _lat0_of(crs), phi)
    lon = np.where(rho == 0, lon0, lon)
    return np.degrees(lon), np.degrees(phi)


def _lat0_of(crs):
    p = crs.params
    return math.radians(
        p.get("latitude_of_origin", p.get("latitude_of_center", 0.0))
    )


def _cea_setup(crs):
    """Lambert Cylindrical Equal Area (EPSG method 9835; Snyder 1987 §10,
    ellipsoidal, normal aspect with a standard parallel)."""
    a = crs.semi_major
    e2 = _e2_of(crs)
    e = math.sqrt(e2)
    p = crs.params
    lat_ts = math.radians(
        p.get("standard_parallel_1", p.get("latitude_of_origin", 0.0))
    )
    lon0 = math.radians(p.get("central_meridian", p.get("longitude_of_center", 0.0)))
    fe = p.get("false_easting", 0.0)
    fn = p.get("false_northing", 0.0)
    k0 = math.cos(lat_ts) / math.sqrt(1 - e2 * math.sin(lat_ts) ** 2)
    qp = float(_q_of(e, e2, 1.0))
    return a, e, e2, qp, k0, lon0, fe, fn


def _cea_forward(crs, lon_deg, lat_deg):
    a, e, e2, qp, k0, lon0, fe, fn = _cea_setup(crs)
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    lat = np.radians(
        np.clip(np.asarray(lat_deg, dtype=np.float64), -89.9999, 89.9999)
    )
    q = _q_of(e, e2, np.sin(lat))
    x = fe + a * k0 * (lon - lon0)
    y = fn + a * q / (2.0 * k0)
    return x, y


def _cea_inverse(crs, x, y):
    a, e, e2, qp, k0, lon0, fe, fn = _cea_setup(crs)
    xs = np.asarray(x, dtype=np.float64) - fe
    ys = np.asarray(y, dtype=np.float64) - fn
    lon = lon0 + xs / (a * k0)
    beta = np.arcsin(np.clip(2.0 * ys * k0 / (a * qp), -1.0, 1.0))
    e4 = e2 * e2
    e6 = e4 * e2
    phi = (
        beta
        + (e2 / 3 + 31 * e4 / 180 + 517 * e6 / 5040) * np.sin(2 * beta)
        + (23 * e4 / 360 + 251 * e6 / 3780) * np.sin(4 * beta)
        + (761 * e6 / 45360) * np.sin(6 * beta)
    )
    return np.degrees(lon), np.degrees(phi)


def _somerc_setup(crs):
    """Swiss Oblique Mercator (EPSG method 9814, PROJ ``somerc``): the
    double projection ellipsoid -> conformal sphere -> oblique equatorial
    Mercator used by CH1903 / CH1903+ (LV03/LV95). Constants per the
    swisstopo projection formulae."""
    a = crs.semi_major
    e2 = _e2_of(crs)
    e = math.sqrt(e2)
    p = crs.params
    # the Swiss double projection equals Hotine Oblique Mercator
    # (azimuth-center variant) only for azimuth = rectified angle = 90°
    # (how CH1903 WKT1 is exported); a general-azimuth HOM (Malaysia RSO,
    # Alaska zone 1) is a different construction — refuse loudly
    for angle in ("azimuth", "rectified_grid_angle"):
        if angle in p and abs(p[angle] - 90.0) > 1e-6:
            raise CrsError(
                f"Hotine Oblique Mercator with {angle}={p[angle]} is not "
                f"supported by the built-in transform engine (only the "
                f"Swiss azimuth=90 form)"
            )
    lat0 = math.radians(p.get("latitude_of_origin", p.get("latitude_of_center", 0.0)))
    lon0 = math.radians(p.get("central_meridian", p.get("longitude_of_center", 0.0)))
    k0 = p.get("scale_factor", 1.0)
    fe = p.get("false_easting", 0.0)
    fn = p.get("false_northing", 0.0)
    s0 = math.sin(lat0)
    alpha = math.sqrt(1 + e2 * math.cos(lat0) ** 4 / (1 - e2))
    r = a * k0 * math.sqrt(1 - e2) / (1 - e2 * s0 * s0)
    b0 = math.asin(s0 / alpha)
    big_k = (
        math.log(math.tan(math.pi / 4 + b0 / 2))
        - alpha
        * (
            math.log(math.tan(math.pi / 4 + lat0 / 2))
            - (e / 2) * math.log((1 + e * s0) / (1 - e * s0))
        )
    )
    return e, alpha, r, b0, big_k, lon0, fe, fn


def _somerc_forward(crs, lon_deg, lat_deg):
    e, alpha, r, b0, big_k, lon0, fe, fn = _somerc_setup(crs)
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    lat = np.radians(
        np.clip(np.asarray(lat_deg, dtype=np.float64), -89.9999, 89.9999)
    )
    s = np.sin(lat)
    big_s = (
        alpha
        * (
            np.log(np.tan(np.pi / 4 + lat / 2))
            - (e / 2) * np.log((1 + e * s) / (1 - e * s))
        )
        + big_k
    )
    b = 2 * (np.arctan(np.exp(big_s)) - np.pi / 4)
    ell = alpha * (lon - lon0)
    b_bar = np.arcsin(
        np.clip(
            np.cos(b0) * np.sin(b) - np.sin(b0) * np.cos(b) * np.cos(ell),
            -1.0,
            1.0,
        )
    )
    l_bar = np.arctan2(
        np.cos(b) * np.sin(ell),
        np.sin(b0) * np.sin(b) + np.cos(b0) * np.cos(b) * np.cos(ell),
    )
    y = r * l_bar
    x = (r / 2) * np.log((1 + np.sin(b_bar)) / (1 - np.sin(b_bar)))
    return fe + y, fn + x


def _somerc_inverse(crs, x, y):
    e, alpha, r, b0, big_k, lon0, fe, fn = _somerc_setup(crs)
    yy = np.asarray(x, dtype=np.float64) - fe  # easting axis
    xx = np.asarray(y, dtype=np.float64) - fn  # northing axis
    l_bar = yy / r
    b_bar = 2 * (np.arctan(np.exp(xx / r)) - np.pi / 4)
    b = np.arcsin(
        np.clip(
            np.cos(b0) * np.sin(b_bar) + np.sin(b0) * np.cos(b_bar) * np.cos(l_bar),
            -1.0,
            1.0,
        )
    )
    ell = np.arctan2(
        np.cos(b_bar) * np.sin(l_bar),
        -np.sin(b0) * np.sin(b_bar) + np.cos(b0) * np.cos(b_bar) * np.cos(l_bar),
    )
    lon = lon0 + ell / alpha
    # sphere -> ellipsoid latitude: fixed-point on the conformal relation
    lat = b.copy()
    for _ in range(8):
        s = np.sin(lat)
        big_s = (
            np.log(np.tan(np.pi / 4 + b / 2)) - big_k
        ) / alpha + e * np.log(np.tan(np.pi / 4 + np.arcsin(e * s) / 2))
        lat = 2 * np.arctan(np.exp(big_s)) - np.pi / 2
    return np.degrees(lon), np.degrees(lat)


def _hom_setup(crs, variant_b):
    """Hotine Oblique Mercator (EPSG method 9812 variant A / 9815 variant
    B): constants per EPSG Guidance Note 7-2. Variant B references
    false coordinates to the projection centre (Ec, Nc); variant A to the
    natural origin (intersection of the aposphere equator and centre
    line)."""
    a = crs.semi_major
    e2 = _e2_of(crs)
    e = math.sqrt(e2)
    p = crs.params
    phic = math.radians(
        p.get("latitude_of_center", p.get("latitude_of_origin", 0.0))
    )
    lonc = math.radians(
        p.get("longitude_of_center", p.get("central_meridian", 0.0))
    )
    alphac = math.radians(p.get("azimuth", 90.0))
    gammac = math.radians(p.get("rectified_grid_angle", p.get("azimuth", 90.0)))
    kc = p.get("scale_factor", 1.0)
    fe = p.get("false_easting", 0.0)
    fn = p.get("false_northing", 0.0)
    sc = math.sin(phic)
    big_b = math.sqrt(1 + e2 * math.cos(phic) ** 4 / (1 - e2))
    big_a = a * big_b * kc * math.sqrt(1 - e2) / (1 - e2 * sc * sc)
    t0 = math.tan(math.pi / 4 - phic / 2) / (
        (1 - e * sc) / (1 + e * sc)
    ) ** (e / 2)
    big_d = big_b * math.sqrt(1 - e2) / (
        math.cos(phic) * math.sqrt(1 - e2 * sc * sc)
    )
    d2 = max(big_d * big_d, 1.0)
    sign = 1.0 if phic >= 0 else -1.0
    big_f = big_d + math.sqrt(d2 - 1) * sign
    big_h = big_f * t0**big_b
    big_g = (big_f - 1 / big_f) / 2
    gamma0 = math.asin(min(1.0, max(-1.0, math.sin(alphac) / big_d)))
    lon0 = lonc - math.asin(
        min(1.0, max(-1.0, big_g * math.tan(gamma0)))
    ) / big_b
    uc = 0.0
    if variant_b:
        if abs(abs(alphac) - math.pi / 2) < 1e-12:
            uc = big_a * (lonc - lon0)
        else:
            uc = (big_a / big_b) * math.atan2(
                math.sqrt(d2 - 1), math.cos(alphac)
            ) * sign
    return e, e2, big_a, big_b, big_h, gamma0, gammac, lon0, uc, fe, fn, sign


def _hom_forward(crs, lon_deg, lat_deg, variant_b):
    e, e2, A, B, H, g0, gc, lon0, uc, fe, fn, sign = _hom_setup(crs, variant_b)
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    lat = np.radians(
        np.clip(np.asarray(lat_deg, dtype=np.float64), -89.9999, 89.9999)
    )
    s = np.sin(lat)
    t = np.tan(np.pi / 4 - lat / 2) / ((1 - e * s) / (1 + e * s)) ** (e / 2)
    Q = H / t**B
    S = (Q - 1 / Q) / 2
    T = (Q + 1 / Q) / 2
    dlon = B * (lon - lon0)
    V = np.sin(dlon)
    U = (-V * np.cos(g0) + S * np.sin(g0)) / T
    v = A * np.log((1 - U) / (1 + U)) / (2 * B)
    u = A * np.arctan2(S * np.cos(g0) + V * np.sin(g0), np.cos(dlon)) / B
    if variant_b:
        u = u - abs(uc) * sign
    easting = v * math.cos(gc) + u * math.sin(gc) + fe
    northing = u * math.cos(gc) - v * math.sin(gc) + fn
    return easting, northing


def _hom_inverse(crs, x, y, variant_b):
    e, e2, A, B, H, g0, gc, lon0, uc, fe, fn, sign = _hom_setup(crs, variant_b)
    de = np.asarray(x, dtype=np.float64) - fe
    dn = np.asarray(y, dtype=np.float64) - fn
    v = de * math.cos(gc) - dn * math.sin(gc)
    u = dn * math.cos(gc) + de * math.sin(gc)
    if variant_b:
        u = u + abs(uc) * sign
    Q = np.exp(-B * v / A)
    S = (Q - 1 / Q) / 2
    T = (Q + 1 / Q) / 2
    V = np.sin(B * u / A)
    U = (V * np.cos(g0) + S * np.sin(g0)) / T
    t = (H / np.sqrt((1 + U) / (1 - U))) ** (1 / B)
    chi = np.pi / 2 - 2 * np.arctan(t)
    e4 = e2 * e2
    e6 = e4 * e2
    e8 = e6 * e2
    lat = (
        chi
        + np.sin(2 * chi) * (e2 / 2 + 5 * e4 / 24 + e6 / 12 + 13 * e8 / 360)
        + np.sin(4 * chi) * (7 * e4 / 48 + 29 * e6 / 240 + 811 * e8 / 11520)
        + np.sin(6 * chi) * (7 * e6 / 120 + 81 * e8 / 1120)
        + np.sin(8 * chi) * (4279 * e8 / 161280)
    )
    lon = lon0 - np.arctan2(
        S * np.cos(g0) - V * np.sin(g0), np.cos(B * u / A)
    ) / B
    return np.degrees(lon), np.degrees(lat)


def _hom_a_forward(crs, lon_deg, lat_deg):
    return _hom_forward(crs, lon_deg, lat_deg, False)


def _hom_a_inverse(crs, x, y):
    return _hom_inverse(crs, x, y, False)


def _is_swiss_case(crs):
    # azimuth = rectified angle = 90 is the Swiss double-projection special
    # case with its own proven implementation (swisstopo formulae); any
    # other combination takes the general EPSG 9815 path
    p = crs.params
    return (
        abs(p.get("azimuth", 90.0) - 90.0) < 1e-9
        and abs(p.get("rectified_grid_angle", 90.0) - 90.0) < 1e-9
    )


def _hom_b_forward(crs, lon_deg, lat_deg):
    if _is_swiss_case(crs):
        return _somerc_forward(crs, lon_deg, lat_deg)
    return _hom_forward(crs, lon_deg, lat_deg, True)


def _hom_b_inverse(crs, x, y):
    if _is_swiss_case(crs):
        return _somerc_inverse(crs, x, y)
    return _hom_inverse(crs, x, y, True)


_FERRO_OFFSET_DEG = 17 + 40 / 60  # Ferro meridian: 17°40' west of Greenwich


def _krovak_setup(crs):
    """Krovak oblique conformal conic (EPSG method 9819) — S-JTSK, the
    Czech/Slovak national projection. Constants per EPSG Guidance Note 7-2.

    The EPSG 'longitude of origin' is 42°30' east of Ferro = 24°50' east of
    Greenwich; Greenwich-primed WKT1 (GDAL style, EPSG 5514) carries 24.8333
    and needs no shift. A longitude_of_center above 30° (a Ferro-referenced
    42.5 carried verbatim) is shifted by the Ferro offset — no real Krovak
    origin is east of 25°E Greenwich. NOTE: input/output grid coordinates
    are always in the 'Krovak East North' (EPSG 5514) axis convention
    (east = -westing, north = -southing); positive-southing/westing data
    (EPSG 2065 convention) must be negated by the caller."""
    a = crs.semi_major
    e2 = _e2_of(crs)
    e = math.sqrt(e2)
    p = crs.params
    phic = math.radians(
        p.get("latitude_of_center", p.get("latitude_of_origin", 49.5))
    )
    lon0_deg = p.get(
        "longitude_of_center", p.get("central_meridian", 24 + 50 / 60)
    )
    if lon0_deg > 30.0:
        lon0_deg -= _FERRO_OFFSET_DEG
    lon0 = math.radians(lon0_deg)
    alphac = math.radians(p.get("azimuth", 30.28813972222222))
    phip = math.radians(p.get("pseudo_standard_parallel_1", 78.5))
    kp = p.get("scale_factor", 0.9999)
    fe = p.get("false_easting", 0.0)
    fn = p.get("false_northing", 0.0)
    sc = math.sin(phic)
    big_a = a * math.sqrt(1 - e2) / (1 - e2 * sc * sc)
    big_b = math.sqrt(1 + e2 * math.cos(phic) ** 4 / (1 - e2))
    gamma0 = math.asin(sc / big_b)
    t0 = (
        math.tan(math.pi / 4 + gamma0 / 2)
        * ((1 + e * sc) / (1 - e * sc)) ** (e * big_b / 2)
        / math.tan(math.pi / 4 + phic / 2) ** big_b
    )
    n = math.sin(phip)
    r0 = kp * big_a / math.tan(phip)
    return e, big_b, t0, n, r0, alphac, phip, lon0, fe, fn


def _krovak_forward(crs, lon_deg, lat_deg):
    e, B, t0, n, r0, ac, phip, lon0, fe, fn = _krovak_setup(crs)
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    lat = np.radians(
        np.clip(np.asarray(lat_deg, dtype=np.float64), -89.9999, 89.9999)
    )
    s = np.sin(lat)
    U = 2 * (
        np.arctan(
            t0
            * np.tan(lat / 2 + np.pi / 4) ** B
            / ((1 + e * s) / (1 - e * s)) ** (e * B / 2)
        )
        - np.pi / 4
    )
    V = B * (lon0 - lon)
    T = np.arcsin(
        np.clip(
            np.cos(ac) * np.sin(U) + np.sin(ac) * np.cos(U) * np.cos(V),
            -1.0,
            1.0,
        )
    )
    D = np.arcsin(np.clip(np.cos(U) * np.sin(V) / np.cos(T), -1.0, 1.0))
    theta = n * D
    r = (
        r0
        * math.tan(math.pi / 4 + phip / 2) ** n
        / np.tan(T / 2 + np.pi / 4) ** n
    )
    southing = r * np.cos(theta) + fn
    westing = r * np.sin(theta) + fe
    # 'Krovak East North' (EPSG 5514) axes: east = -westing, north = -southing
    return -westing, -southing


def _krovak_inverse(crs, x, y):
    e, B, t0, n, r0, ac, phip, lon0, fe, fn = _krovak_setup(crs)
    westing = -np.asarray(x, dtype=np.float64) - fe
    southing = -np.asarray(y, dtype=np.float64) - fn
    r = np.sqrt(southing**2 + westing**2)
    theta = np.arctan2(westing, southing)
    D = theta / n
    T = 2 * (
        np.arctan(
            (r0 / r) ** (1 / n) * math.tan(math.pi / 4 + phip / 2)
        )
        - np.pi / 4
    )
    U = np.arcsin(
        np.clip(
            np.cos(ac) * np.sin(T) - np.sin(ac) * np.cos(T) * np.cos(D),
            -1.0,
            1.0,
        )
    )
    V = np.arcsin(np.clip(np.cos(T) * np.sin(D) / np.cos(U), -1.0, 1.0))
    lon = lon0 - V / B
    # ellipsoid latitude: fixed-point on the conformal relation
    lat = U.copy()
    for _ in range(8):
        s = np.sin(lat)
        lat = 2 * (
            np.arctan(
                t0 ** (-1 / B)
                * np.tan(U / 2 + np.pi / 4) ** (1 / B)
                * ((1 + e * s) / (1 - e * s)) ** (e / 2)
            )
            - np.pi / 4
        )
    return np.degrees(lon), np.degrees(lat)


_PROJ_IMPLS = {
    "lambert_azimuthal_equal_area": (_laea_forward, _laea_inverse),
    "hotine_oblique_mercator": (_hom_a_forward, _hom_a_inverse),
    "hotine_oblique_mercator_azimuth_center": (_hom_b_forward, _hom_b_inverse),
    "krovak": (_krovak_forward, _krovak_inverse),
    "swiss_oblique_cylindrical": (_somerc_forward, _somerc_inverse),
    "swiss_oblique_mercator": (_somerc_forward, _somerc_inverse),
    "cylindrical_equal_area": (_cea_forward, _cea_inverse),
    "lambert_cylindrical_equal_area": (_cea_forward, _cea_inverse),
    "lambert_cylindrical_equal_area_spherical": (_cea_forward, _cea_inverse),
    "transverse_mercator": (_tm_forward, _tm_inverse),
    "mercator_1sp": (_mercator_forward, _mercator_inverse),
    "mercator_2sp": (_mercator_forward, _mercator_inverse),
    "mercator": (_mercator_forward, _mercator_inverse),
    "mercator_auxiliary_sphere": (_webmerc_forward, _webmerc_inverse),
    "popular_visualisation_pseudo_mercator": (_webmerc_forward, _webmerc_inverse),
    "lambert_conformal_conic_2sp": (_lcc_forward, _lcc_inverse),
    "lambert_conformal_conic_1sp": (_lcc_forward, _lcc_inverse),
    "lambert_conformal_conic": (_lcc_forward, _lcc_inverse),
    "albers_conic_equal_area": (_albers_forward, _albers_inverse),
    "albers": (_albers_forward, _albers_inverse),
    "polar_stereographic": (_polar_stereo_forward, _polar_stereo_inverse),
    "polar_stereographic_variant_a": (_polar_stereo_forward, _polar_stereo_inverse),
    "polar_stereographic_variant_b": (_polar_stereo_forward, _polar_stereo_inverse),
    "oblique_stereographic": (_oblique_stereo_forward, _oblique_stereo_inverse),
    "double_stereographic": (_oblique_stereo_forward, _oblique_stereo_inverse),
    "stereographic_north_pole": (_polar_stereo_forward, _polar_stereo_inverse),
    "stereographic_south_pole": (_polar_stereo_forward, _polar_stereo_inverse),
}


# -- datum shifts (7-parameter Helmert via geocentric coordinates) ----------


def _geodetic_to_geocentric(a, e2, lon_deg, lat_deg):
    lon = np.radians(lon_deg)
    lat = np.radians(lat_deg)
    sin_lat = np.sin(lat)
    nu = a / np.sqrt(1 - e2 * sin_lat**2)
    x = nu * np.cos(lat) * np.cos(lon)
    y = nu * np.cos(lat) * np.sin(lon)
    z = nu * (1 - e2) * sin_lat
    return x, y, z


def _geocentric_to_geodetic(a, e2, x, y, z):
    lon = np.arctan2(y, x)
    p = np.sqrt(x**2 + y**2)
    # iterate latitude (converges to sub-mm in a few rounds)
    lat = np.arctan2(z, p * (1 - e2))
    for _ in range(6):
        sin_lat = np.sin(lat)
        nu = a / np.sqrt(1 - e2 * sin_lat**2)
        lat = np.arctan2(z + e2 * nu * sin_lat, p)
    return np.degrees(lon), np.degrees(lat)


def _helmert(params, x, y, z, inverse=False):
    """Position-vector 7-parameter transformation (EPSG 9606): rotations in
    arc-seconds, scale in ppm. The method is sign-reversible: the inverse
    applies the negated parameters (error ~ rotation², negligible at
    arc-second scale)."""
    if inverse:
        params = tuple(-v for v in params)
    dx, dy, dz, rx, ry, rz, s_ppm = params
    arc = math.pi / (180.0 * 3600.0)
    rx, ry, rz = rx * arc, ry * arc, rz * arc
    m = 1.0 + s_ppm * 1e-6
    nx = dx + m * (x - rz * y + ry * z)
    ny = dy + m * (rz * x + y - rx * z)
    nz = dz + m * (-ry * x + rx * y + z)
    return nx, ny, nz


_NULL_SHIFT = (0.0,) * 7


def _e2_of(crs):
    """Ellipsoid eccentricity²; inv_flattening == 0 encodes a sphere."""
    if not crs.inv_flattening:
        return 0.0
    f = 1.0 / crs.inv_flattening
    return f * (2 - f)


_WGS84_A = 6378137.0
_WGS84_E2 = (1.0 / 298.257223563) * (2 - 1.0 / 298.257223563)


def _datum_shift(src, dst, lon, lat):
    """Geographic coordinates on src datum -> dst datum via WGS84, using the
    CRSes' TOWGS84 parameters. No-op when the declared shifts are equal
    (same datum under any name spelling, or both WGS84-equivalent).

    NTv2 grids registered via kart_tpu_torch.gridshift (or $KART_NTV2_GRID_DIR)
    take precedence over Helmert parameters for their datum — PROJ's own
    priority — and compose with the other side's Helmert (grid src ->
    WGS84 -> Helmert dst and vice versa). A datum that appears under more
    than one spelling should be registered under every alias, or the
    same-datum no-op can't recognise it."""
    if src.datum_name is not None and src.datum_name == dst.datum_name:
        return lon, lat
    from kart_tpu_torch import gridshift

    src_grid = gridshift.grid_for_datum(src.datum_name)
    dst_grid = gridshift.grid_for_datum(dst.datum_name)
    src_tw = src.towgs84 if src.towgs84 != _NULL_SHIFT else None
    dst_tw = dst.towgs84 if dst.towgs84 != _NULL_SHIFT else None

    if src_grid is None and dst_grid is None:
        if src_tw == dst_tw:  # includes None == None
            return lon, lat
        x, y, z = _geodetic_to_geocentric(src.semi_major, _e2_of(src), lon, lat)
        if src_tw is not None:
            x, y, z = _helmert(src_tw, x, y, z)
        if dst_tw is not None:
            x, y, z = _helmert(dst_tw, x, y, z, inverse=True)
        return _geocentric_to_geodetic(dst.semi_major, _e2_of(dst), x, y, z)

    if src_grid is not None and src_grid is dst_grid:
        return lon, lat  # same datum registered under both spellings

    # to WGS84
    if src_grid is not None:
        lon, lat = src_grid.shift(lon, lat)
    elif src_tw is not None:
        x, y, z = _geodetic_to_geocentric(src.semi_major, _e2_of(src), lon, lat)
        x, y, z = _helmert(src_tw, x, y, z)
        lon, lat = _geocentric_to_geodetic(_WGS84_A, _WGS84_E2, x, y, z)
    # from WGS84
    if dst_grid is not None:
        lon, lat = dst_grid.shift(lon, lat, inverse=True)
    elif dst_tw is not None:
        x, y, z = _geodetic_to_geocentric(_WGS84_A, _WGS84_E2, lon, lat)
        x, y, z = _helmert(dst_tw, x, y, z, inverse=True)
        lon, lat = _geocentric_to_geodetic(dst.semi_major, _e2_of(dst), x, y, z)
    return lon, lat


class Transform:
    """Vectorized coordinate transform between two CRS. Datum shifts are
    applied when either side declares TOWGS84 (7-parameter Helmert, EPSG
    9606); datums without one are treated as WGS84-equivalent (within ~1m
    for modern datums — the envelope index pads by a buffer anyway)."""

    def __init__(self, src, dst):
        self.src = make_crs(src) if not isinstance(src, CRS) else src
        self.dst = make_crs(dst) if not isinstance(dst, CRS) else dst
        self.is_identity = normalise_wkt(self.src.wkt) == normalise_wkt(self.dst.wkt)

    def _impl(self, crs):
        if crs.is_geographic:
            return None
        name = (crs.projection or "").lower()
        impl = _PROJ_IMPLS.get(name)
        if impl is None:
            raise CrsError(
                f"Projection {crs.projection!r} is not supported by the built-in "
                f"transform engine"
            )
        return impl

    def transform(self, xs, ys):
        """(xs, ys) arrays in src CRS -> (xs, ys) in dst CRS."""
        xs = np.asarray(xs, dtype=np.float64)
        ys = np.asarray(ys, dtype=np.float64)
        if self.is_identity:
            return xs, ys
        src_impl = self._impl(self.src)
        dst_impl = self._impl(self.dst)
        if src_impl is not None:
            xs, ys = src_impl[1](self.src, xs, ys)  # -> lon/lat
        xs, ys = _datum_shift(self.src, self.dst, xs, ys)
        if dst_impl is not None:
            xs, ys = dst_impl[0](self.dst, xs, ys)  # lon/lat -> projected
        return xs, ys

    def transform_envelope(self, env, densify=5):
        """(min-x, max-x, min-y, max-y) -> transformed envelope, densifying
        each edge so curvature is captured (reference:
        spatial_filter/index.py transforms envelopes the same way)."""
        x0, x1, y0, y1 = env
        t = np.linspace(0.0, 1.0, densify)
        xs = np.concatenate(
            [x0 + (x1 - x0) * t, np.full(densify, x1), x1 + (x0 - x1) * t, np.full(densify, x0)]
        )
        ys = np.concatenate(
            [np.full(densify, y0), y0 + (y1 - y0) * t, np.full(densify, y1), y1 + (y0 - y1) * t]
        )
        tx, ty = self.transform(xs, ys)
        return (float(tx.min()), float(tx.max()), float(ty.min()), float(ty.max()))
