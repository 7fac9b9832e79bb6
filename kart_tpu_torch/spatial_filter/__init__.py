"""Spatial filtering: work with just the features inside an area of
interest.

Client side: a filter spec, ``<crs>;<geometry>`` (from a string, a file or
the repo config a filtered clone writes), resolved into one
:class:`SpatialFilter` per dataset with the filter polygon transformed into
the dataset's CRS once. A filter matches a feature in two stages: the
envelope fast path, then an exact intersection of the real geometry with
the filter's polygons (every part, every hole) for the residue. Match
results are tri-state: a feature whose blob is promised cannot be tested
locally. Counterpart of the client half of kart_tpu's
``spatial_filter/__init__.py`` (``MatchResult``,
``ResolvedSpatialFilterSpec``, ``SpatialFilter`` and the polygon helpers),
numpy f64 in kart_tpu's operation order so that the verdicts are the same
bits. Filter and dataset CRSes may be geographic or projected: a filter
that cannot be transformed into a dataset's CRS (a projection the engine
lacks) is logged and not applied to that dataset, as in kart_tpu.

Server side: :func:`blob_filter_for_spec`, the blob filter of a spatially
filtered clone. Its pre-pass is one batch bbox test of every indexed
feature envelope against the filter rect (K3, :func:`envelope_prepass`);
a blob the index lacks is decoded and its envelope moved to EPSG:4326
(:class:`_DatasetEnvelopeDecoder`).
"""

import logging
import os
from enum import Enum

import numpy as np

from kart_tpu_torch.core.odb import ObjectPromised
from kart_tpu_torch.core.repo import KartConfigKeys
from kart_tpu_torch.core.serialise import msg_unpack
from kart_tpu_torch.crs import CRS, Transform, make_crs
from kart_tpu_torch.geometry import MULTIPOLYGON, POLYGON, Geometry, parse_wkb
from kart_tpu_torch.ops.bbox import bbox_intersects
from kart_tpu_torch.runtime import resolve_device
from kart_tpu_torch.spatial_filter.index import EnvelopeIndexReader, db_path, wrap_lon

L = logging.getLogger("kart_tpu_torch.spatial_filter")

#: widens the rect by more than f32 ulp at +-360 (2.2e-5 deg) but less than
#: the codec's outward-rounded granularity (360/2^20 = 3.4e-4 deg): a
#: borderline feature ships (fail open) instead of being withheld
PREPASS_PAD = 1e-4

EPSG_4326_WKT = """GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",6378137,298.257223563,AUTHORITY["EPSG","7030"]],AUTHORITY["EPSG","6326"]],PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433],AUTHORITY["EPSG","4326"]]"""


class SpatialFilterError(ValueError):
    """A malformed filter spec or rectangle."""


class MatchResult(Enum):
    MATCHED = "matched"
    NOT_MATCHED = "not-matched"
    PROMISED = "promised"  # cannot tell: the geometry's blob is not present


def _transform_ring(t, ring):
    rx, ry = t.transform(ring[:, 0], ring[:, 1])
    return np.stack([rx, ry], axis=1)


def _rect_overlaps(env, rect):
    """(min-x, max-x, min-y, max-y) vs (w, e, s, n) rect, anti-meridian
    aware on the x axis."""
    x0, x1, y0, y1 = env
    w, e, s, n = rect
    if y1 < s or y0 > n:
        return False
    if e >= w:  # a normal range
        if x1 >= x0:
            return x0 <= e and w <= x1
        return x0 <= e or w <= x1  # the envelope crosses the anti-meridian
    if x1 >= x0:  # the rect crosses it
        return x0 <= e or w <= x1
    return True  # both cross: they share the anti-meridian


class ResolvedSpatialFilterSpec:
    """A parsed, usable filter: CRS + polygon geometry."""

    def __init__(self, crs_spec, geometry, *, match_all=False):
        self.match_all = match_all
        if match_all:
            self.crs_spec = self.geometry = self.crs = None
            return
        self.crs_spec = crs_spec
        self.crs = make_crs(crs_spec)
        if isinstance(geometry, Geometry):
            self.geometry = geometry
        else:
            self.geometry = Geometry.from_string(geometry, allowed_types=(POLYGON, MULTIPOLYGON))

    @classmethod
    def from_spec_string(cls, text):
        """``<crs>;<geometry>`` where the geometry is WKT or hex WKB, or the
        contents of a file via ``@filename``."""
        if text in (None, "", "none"):
            return cls(None, None, match_all=True)
        if text.startswith("@"):
            path = text[1:]
            if not os.path.exists(path):
                raise SpatialFilterError(f"No such file: {path}")
            with open(path) as f:
                text = f.read().strip()
        crs_spec, sep, geom_text = text.partition(";")
        if not sep:
            raise SpatialFilterError(
                "Spatial filter must be in the form <crs>;<geometry> "
                "(e.g. 'EPSG:4326;POLYGON((...))')"
            )
        return cls(crs_spec.strip(), geom_text.strip())

    @classmethod
    def from_repo_config(cls, repo):
        geom = repo.config.get(KartConfigKeys.KART_SPATIALFILTER_GEOMETRY)
        crs = repo.config.get(KartConfigKeys.KART_SPATIALFILTER_CRS)
        if not geom or not crs:
            return cls(None, None, match_all=True)
        return cls(crs, geom)

    @property
    def envelope_native(self):
        """(min-x, max-x, min-y, max-y) in the filter's own CRS."""
        return self.geometry.envelope()

    @property
    def envelope_wsen_4326(self):
        """(w, s, e, n) in EPSG:4326, the form the envelope prefilter, the
        envelope index and the wire filter argument take."""
        env = self.envelope_native
        if not self.crs.is_geographic:
            env = Transform(self.crs, make_crs(EPSG_4326_WKT)).transform_envelope(env)
        x0, x1, y0, y1 = env
        return (x0, y0, x1, y1)

    @property
    def filter_arg(self):
        """The ``extension:spatial=`` argument: ``w,s,e,n`` in EPSG:4326."""
        return ",".join(f"{v:.7f}" for v in self.envelope_wsen_4326)

    def config_items(self):
        return {
            KartConfigKeys.KART_SPATIALFILTER_GEOMETRY: self.geometry.to_wkt(),
            KartConfigKeys.KART_SPATIALFILTER_CRS: self.crs_spec,
        }

    def resolve_for_dataset(self, dataset):
        """-> SpatialFilter in the dataset's CRS."""
        if self.match_all:
            return SpatialFilter.MATCH_ALL
        return SpatialFilter.for_dataset(self, dataset)


class SpatialFilter:
    """A filter ready to test one dataset's features: the filter envelope
    and its polygon parts, in the dataset's CRS."""

    MATCH_ALL = None  # set below

    def __init__(self, rect_wesn=None, geom_column_name=None, polygon_parts=None):
        self.match_all = rect_wesn is None
        self.rect = rect_wesn  # (w, e, s, n) in the dataset's CRS
        self.geom_column_name = geom_column_name
        self.polygon_parts = polygon_parts  # [(outer, [holes]), ...]
        self._rect_parts = None  # the rect as a polygon part, built on use

    @classmethod
    def for_dataset(cls, spec, dataset):
        geom_col = dataset.geom_column_name
        if geom_col is None:
            return cls.MATCH_ALL  # a non-spatial dataset: everything matches
        x0, x1, y0, y1 = spec.envelope_native
        parts = _polygon_parts(spec.geometry)
        ds_crs_wkt = None
        try:
            ids = dataset.crs_identifiers()
            if ids:
                ds_crs_wkt = dataset.get_crs_definition(ids[0])
        except Exception:  # kart_tpu's policy: an unreadable CRS is no CRS
            ds_crs_wkt = None
        if ds_crs_wkt:
            ds_crs = CRS(ds_crs_wkt)
            if ds_crs != spec.crs:
                try:
                    t = Transform(spec.crs, ds_crs)
                    x0, x1, y0, y1 = t.transform_envelope((x0, x1, y0, y1))
                    if parts is not None:
                        parts = [
                            (_transform_ring(t, outer), [_transform_ring(t, h) for h in holes])
                            for outer, holes in parts
                        ]
                except Exception as e:  # kart_tpu fails open, never silently
                    L.warning(
                        "Spatial filter cannot be transformed into the CRS of "
                        "dataset %r (%s); the filter will not be applied to "
                        "this dataset.", dataset.path, e,
                    )
                    return cls.MATCH_ALL
        return cls((x0, x1, y0, y1), geom_col, parts)

    def matches(self, feature):
        """True when ``feature`` matches; a promised geometry raises
        ObjectPromised."""
        result = self.match_result(feature)
        if result is MatchResult.PROMISED:
            raise ObjectPromised("<feature geometry>")
        return result is MatchResult.MATCHED

    def match_result(self, feature) -> MatchResult:
        if self.match_all:
            return MatchResult.MATCHED
        try:
            geom = feature.get(self.geom_column_name)
        except ObjectPromised:
            return MatchResult.PROMISED
        return self.match_geometry(geom)

    def match_geometry(self, geom) -> MatchResult:
        """The envelope fast path, then the real geometry against the
        filter polygons for the residue (GEOS Intersects semantics): a
        feature whose envelope clips the filter but whose geometry does not
        is NOT_MATCHED."""
        if geom is None:
            return MatchResult.MATCHED  # a NULL geometry always matches
        env = Geometry.of(geom).envelope()
        if env is None:
            return MatchResult.MATCHED  # an empty geometry
        if not _rect_overlaps(env, self.rect):
            return MatchResult.NOT_MATCHED
        filter_parts = self.polygon_parts
        if filter_parts is None:
            # a rectangular filter: envelope inside => geometry inside
            x0, x1, y0, y1 = env
            w, e, s, n = self.rect
            if w <= x0 and x1 <= e and s <= y0 and y1 <= n:
                return MatchResult.MATCHED
            filter_parts = self._rect_as_parts()
        else:
            rel = _polygon_set_env_relation(filter_parts, env)
            if rel == "disjoint":
                return MatchResult.NOT_MATCHED
            if rel == "contains":
                return MatchResult.MATCHED
        feat = _feature_geom_parts(geom)
        if feat is None:
            return MatchResult.MATCHED  # unparseable: fail open
        if _geom_intersects_polygon_set(feat, filter_parts):
            return MatchResult.MATCHED
        return MatchResult.NOT_MATCHED

    def _rect_as_parts(self):
        if self._rect_parts is None:
            w, e, s, n = self.rect
            ring = np.array([(w, s), (e, s), (e, n), (w, n), (w, s)], dtype=np.float64)
            self._rect_parts = [(ring, [])]
        return self._rect_parts


SpatialFilter.MATCH_ALL = SpatialFilter()


def _polygon_parts(geometry):
    """Polygon/MultiPolygon -> [(outer ring, [hole rings])] with each ring
    an (N, 2) float64 array, or None when the geometry is no polygon."""
    try:
        value = parse_wkb(Geometry.of(geometry).to_wkb())
    except Exception:  # kart_tpu's policy: unparseable is no polygon
        return None
    name = value[0]
    if name == "Polygon":
        polys = [value]
    elif name == "MultiPolygon":
        polys = value.payload or []
    else:
        return None
    parts = []
    for poly in polys:
        rings = [
            np.asarray(ring, dtype=np.float64)[:, :2]
            for ring in (poly.payload or []) if len(ring) >= 3
        ]
        if rings:
            parts.append((rings[0], rings[1:]))
    return parts or None


def _polygon_set_env_relation(parts, env):
    """Filter polygon set vs feature envelope: "disjoint", "contains" (one
    part covers the whole rect) or "partial" (the residue test decides)."""
    x0, x1, y0, y1 = env
    any_hit = False
    for outer, holes in parts:
        crossing = False
        for ring in (outer, *holes):
            xs, ys = ring[:, 0], ring[:, 1]
            if np.any(_segment_hits_rect(xs, ys, np.roll(xs, -1), np.roll(ys, -1),
                                         x0, x1, y0, y1)):
                crossing = True
                break
        if crossing:
            any_hit = True
            continue  # a boundary passes through the rect
        if _point_in_ring(outer, x0, y0) and not any(
            _point_in_ring(hole, x0, y0) for hole in holes
        ):
            # no boundary inside the rect and one corner interior: the whole
            # rect is interior to this part
            return "contains"
    if not any_hit:
        return "disjoint"
    return "partial"


def _point_in_polygon_set(parts, px, py):
    """Containment in a (multi)polygon with holes."""
    for outer, holes in parts:
        if _point_in_ring(outer, px, py) and not any(_point_in_ring(h, px, py) for h in holes):
            return True
    return False


def _feature_geom_parts(geom):
    """Feature geometry -> {"points": (p, 2), "lines": [(n, 2)], "polys":
    [(outer, [holes])]} over every part of any WKB type, or None when it
    does not parse."""
    try:
        value = parse_wkb(Geometry.of(geom).to_wkb())
    except Exception:  # kart_tpu's policy: fail open on what does not parse
        return None
    points, lines, polys = [], [], []

    def walk(v):
        name, payload = v[0], v.payload
        if payload is None:
            return
        if name == "Point":
            points.append(payload[:2])
        elif name == "LineString":
            if len(payload) >= 2:
                lines.append(np.asarray(payload, dtype=np.float64)[:, :2])
        elif name == "Polygon":
            rings = [np.asarray(r, dtype=np.float64)[:, :2] for r in payload if len(r) >= 3]
            if rings:
                polys.append((rings[0], rings[1:]))
        elif name in ("MultiPoint", "MultiLineString", "MultiPolygon", "GeometryCollection"):
            for child in payload:
                walk(child)

    walk(value)
    return {
        "points": np.asarray(points, dtype=np.float64).reshape(-1, 2),
        "lines": lines,
        "polys": polys,
    }


def _segments_cross(a0, a1, b0, b1, chunk=1024):
    """Does any segment of set A touch or cross any of set B (touching
    counts)? a0/a1: (na, 2); b0/b1: (nb, 2). Orientation tests, chunked over
    A to bound the (na, nb) broadcast."""

    def cross(ox, oy, ax, ay, bx, by):
        return (ax - ox) * (by - oy) - (ay - oy) * (bx - ox)

    for lo in range(0, len(a0), chunk):
        p0 = a0[lo : lo + chunk][:, None, :]
        p1 = a1[lo : lo + chunk][:, None, :]
        q0 = b0[None, :, :]
        q1 = b1[None, :, :]
        d1 = cross(p0[..., 0], p0[..., 1], p1[..., 0], p1[..., 1], q0[..., 0], q0[..., 1])
        d2 = cross(p0[..., 0], p0[..., 1], p1[..., 0], p1[..., 1], q1[..., 0], q1[..., 1])
        d3 = cross(q0[..., 0], q0[..., 1], q1[..., 0], q1[..., 1], p0[..., 0], p0[..., 1])
        d4 = cross(q0[..., 0], q0[..., 1], q1[..., 0], q1[..., 1], p1[..., 0], p1[..., 1])
        proper = ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0))
        if np.any(proper):
            return True
        # touching or collinear overlap: an endpoint of one lies on the other
        if np.any(
            (d1 == 0) & _on_segment(p0, p1, q0)
            | (d2 == 0) & _on_segment(p0, p1, q1)
            | (d3 == 0) & _on_segment(q0, q1, p0)
            | (d4 == 0) & _on_segment(q0, q1, p1)
        ):
            return True
    return False


def _on_segment(s0, s1, p):
    """p collinear with segment (s0, s1): is it within the segment's bbox?"""
    return (
        (p[..., 0] >= np.minimum(s0[..., 0], s1[..., 0]))
        & (p[..., 0] <= np.maximum(s0[..., 0], s1[..., 0]))
        & (p[..., 1] >= np.minimum(s0[..., 1], s1[..., 1]))
        & (p[..., 1] <= np.maximum(s0[..., 1], s1[..., 1]))
    )


def _filter_ring_segs(parts):
    rings = []
    for outer, holes in parts:
        rings.append(outer)
        rings.extend(holes)
    return np.concatenate(rings), np.concatenate([np.roll(r, -1, axis=0) for r in rings])


def _geom_intersects_polygon_set(feat, parts):
    """Intersects(filter polygon set, feature geometry) over the parsed
    feature parts."""
    pts = feat["points"]
    for i in range(len(pts)):
        if _point_in_polygon_set(parts, pts[i, 0], pts[i, 1]):
            return True
    if len(pts):
        # a point exactly on a filter edge intersects it
        fa, fb = _filter_ring_segs(parts)
        p = pts[:, None, :]
        d = (fb[None, :, 0] - fa[None, :, 0]) * (p[..., 1] - fa[None, :, 1]) - (
            fb[None, :, 1] - fa[None, :, 1]
        ) * (p[..., 0] - fa[None, :, 0])
        if np.any((d == 0) & _on_segment(fa[None, :, :], fb[None, :, :], p)):
            return True
    if not feat["lines"] and not feat["polys"]:
        return False
    fa, fb = _filter_ring_segs(parts)
    for line in feat["lines"]:
        if len(line) > 1 and _segments_cross(line[:-1], line[1:], fa, fb):
            return True
        # no boundary crossing: the line is wholly inside or outside
        if _point_in_polygon_set(parts, line[0, 0], line[0, 1]):
            return True
    for outer, holes in feat["polys"]:
        for ring in (outer, *holes):
            if _segments_cross(ring, np.roll(ring, -1, axis=0), fa, fb):
                return True
        # no crossing: disjoint, the feature inside the filter, or the
        # filter inside the feature (maybe inside one of its holes)
        if _point_in_polygon_set(parts, outer[0, 0], outer[0, 1]):
            return True
        for fouter, _fholes in parts:
            fx, fy = fouter[0, 0], fouter[0, 1]
            if _point_in_ring(outer, fx, fy) and not any(
                _point_in_ring(h, fx, fy) for h in holes
            ):
                return True
    return False


def _point_in_ring(ring, px, py):
    xs, ys = ring[:, 0], ring[:, 1]
    xj, yj = np.roll(xs, 1), np.roll(ys, 1)
    crossing = ((ys > py) != (yj > py)) & (
        px < (xj - xs) * (py - ys) / np.where(yj == ys, np.inf, yj - ys) + xs
    )
    return bool(np.sum(crossing) % 2)


def _segment_hits_rect(ax, ay, bx, by, x0, x1, y0, y1):
    """Vectorized Liang-Barsky clip: exact segment-vs-rect intersection."""
    dx, dy = bx - ax, by - ay
    t0 = np.zeros_like(ax, dtype=np.float64)
    t1 = np.ones_like(ax, dtype=np.float64)
    hit = np.ones_like(ax, dtype=bool)
    for p, q in ((-dx, ax - x0), (dx, x1 - ax), (-dy, ay - y0), (dy, y1 - ay)):
        parallel_out = (p == 0) & (q < 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(p != 0, q / np.where(p == 0, 1.0, p), 0.0)
        t0 = np.where(p < 0, np.maximum(t0, t), t0)
        t1 = np.where(p > 0, np.minimum(t1, t), t1)
        hit &= ~parallel_out
    return hit & (t0 <= t1)


# -- server side: the filtered clone's envelope pre-pass (K3) ----------------


def parse_wsen(wsen):
    """"w,s,e,n" string or 4-sequence -> 4 floats."""
    if isinstance(wsen, str):
        parts = [float(p) for p in wsen.split(",")]
        if len(parts) != 4:
            raise SpatialFilterError(f"Bad spatial filter rect: {wsen!r}")
        return tuple(parts)
    w, s, e, n = wsen
    return float(w), float(s), float(e), float(n)


def envelope_prepass(gitdir, wsen, device=None):
    """-> (matched_oids, rejected_oids): sets of blob oid hexes whose indexed
    envelope does / does not intersect the (padded) rect, or (None, None)
    when the repo at ``gitdir`` has no envelope index or it is empty. Blobs
    in neither set are not indexed (the caller decodes them). The envelope
    columns stay resident on the device under the key ("envidx", index
    path, mtime_ns)."""
    device = resolve_device(device)
    w, s, e, n = parse_wsen(wsen)
    reader = EnvelopeIndexReader.open(gitdir)
    if reader is None:
        return None, None
    with reader:
        oids, env = reader.all_envelopes()
    if not oids:
        return None, None
    path = db_path(gitdir)
    try:
        key = ("envidx", path, os.stat(path).st_mtime_ns)
    except OSError:
        key = None
    pad = PREPASS_PAD
    hits = bbox_intersects(
        env, (w - pad, s - pad, e + pad, n + pad), cache_key=key, device=device
    ).cpu().numpy()
    matched = {o for o, h in zip(oids, hits) if h}
    rejected = {o for o, h in zip(oids, hits) if not h}
    return matched, rejected


def blob_filter_for_spec(src_repo, wsen_arg, device=None):
    """-> callable(path, oid) -> bool, the blob filter of a spatially
    filtered clone of ``src_repo`` by ``wsen_arg`` ("w,s,e,n" or a
    4-sequence, EPSG:4326). A feature blob whose envelope misses the rect is
    vetoed (left promised on the client); every other blob ships, and so
    does one with no envelope (fail open).

    With an envelope index, every indexed envelope is tested at once by K3
    on ``device`` (None: the card; see :func:`envelope_prepass`), with the
    columns resident across filters; a blob the index lacks is decoded and
    its envelope moved to EPSG:4326 (:class:`_DatasetEnvelopeDecoder`)."""
    w, s, e, n = parse_wsen(wsen_arg)
    matched_oids, rejected_oids = envelope_prepass(src_repo.gitdir, (w, s, e, n), device)
    decoder = _DatasetEnvelopeDecoder(src_repo)

    def blob_filter(path, oid):
        ds_feature = _split_feature_path(path)
        if ds_feature is None:
            return True  # a meta or other non-feature blob always ships
        if matched_oids is not None:
            if oid in matched_oids:
                return True
            if oid in rejected_oids:
                return False
        env_4326 = decoder.envelope_4326(ds_feature[0], oid)
        if env_4326 is None:
            return True  # no geometry, or not decodable: fail open
        return _rect_overlaps(env_4326, (w, e, s, n))

    return blob_filter


def _split_feature_path(path):
    """'<ds>/.table-dataset/feature/ab/cd' -> (ds_path, rel) or None."""
    for dirname in (".table-dataset", ".sno-dataset"):
        marker = f"/{dirname}/feature/"
        idx = path.find(marker)
        if idx >= 0:
            return path[:idx], path[idx + len(marker):]
    return None


class _DatasetEnvelopeDecoder:
    """A feature blob's envelope in EPSG:4326, decoded on the fly, with
    each dataset's transform (of HEAD's dataset at that path) built once."""

    def __init__(self, repo):
        self.repo = repo
        self._cache = {}

    def _dataset_transform(self, ds_path):
        """-> a Transform, "identity", or None (no such spatial dataset, or
        an unusable CRS: its blobs fail open)."""
        if ds_path in self._cache:
            return self._cache[ds_path]
        transform = None
        try:
            ds = self.repo.structure("HEAD").datasets.get(ds_path)
            if ds is not None and ds.geom_column_name is not None:
                ids = ds.crs_identifiers()
                crs_wkt = ds.get_crs_definition(ids[0]) if ids else None
                transform = "identity"
                if crs_wkt:
                    ds_crs = CRS(crs_wkt)
                    if not ds_crs.is_geographic:
                        transform = Transform(ds_crs, make_crs(EPSG_4326_WKT))
        except Exception:  # kart_tpu's policy: fail open
            transform = None
        self._cache[ds_path] = transform
        return transform

    def envelope_4326(self, ds_path, oid):
        """-> (min-x, max-x, min-y, max-y) in EPSG:4326, cyclic (x0 > x1)
        where it crosses the anti-meridian, or None."""
        transform = self._dataset_transform(ds_path)
        if transform is None:
            return None
        try:
            _, values = msg_unpack(self.repo.odb.read_blob(oid))
            geom = next((v for v in values if isinstance(v, Geometry)), None)
            env = None if geom is None else geom.envelope()
            if env is None or transform == "identity":
                return env
            x0, x1, y0, y1 = transform.transform_envelope(env)
            return (float(wrap_lon(x0)), float(wrap_lon(x1)), y0, y1)
        except Exception:  # kart_tpu's policy: fail open
            return None
