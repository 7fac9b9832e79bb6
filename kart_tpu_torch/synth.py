"""Synthetic repositories at benchmark scale: a real repository (packs,
Merkle feature trees, commits, refs, columnar sidecars) built straight
from generated (pk, oid) columns.

Counterpart of kart_tpu's ``synth.py`` ``synth_repo`` for ``blobs="real"``
(every feature blob written), ``blobs="changed"`` (real blobs for the
edited rows only, in both revisions; every other blob oid is in the trees
and sidecars but its object is absent), ``blobs="promised"`` (no blob at
all: random oids, for paths that read only oids, such as the merge's
classify), and of ``spatial=True`` with
``blobs="changed"``: a point layer (``SYNTH_SPATIAL_SCHEMA``, EPSG:4326)
whose sidecars carry the envelope column (:func:`synth_envelopes`) and the
vertex column of each envelope's box. Given the same arguments, commit
dates (``GIT_AUTHOR_DATE``/``GIT_COMMITTER_DATE``) and seed, it writes the
same commits and byte-identical sidecars as kart_tpu. The polygon
repository is not ported.

``spatial=True`` with ``blobs="real"`` has no kart_tpu counterpart (its
spatial synth writes promised or changed blobs only): the same point layer
with every feature blob written, each point at its envelope's south-west
corner as in the changed blobs, for what decodes every blob (the envelope
index writer, the blob filter). Nor has ``crs``: the point layer's
geometries in another CRS of the registry (``EPSG:2193``, say), each point
moved there from EPSG:4326, while the sidecars keep their EPSG:4326
envelopes.

:func:`synth_shapes` (seeded stars with holes, points and polylines as a
vertex column) has no kart_tpu counterpart either: it feeds the exact
refine's checks. ``pk="text"`` has no kart_tpu counterpart: a hash-keyed layer whose pk is
a G-NAF-shaped address id (:func:`gnaf_ids`), its feature tree laid out by
the hashed path encoder and its sidecars keyed by the filename hashes with
their paths, every object as kart_tpu's encoders would write it. Nor has
:func:`commit_point_edits`: a further commit of a point layer that moves,
inserts and deletes rows, with real blobs for the rows it writes and no
sidecar (a history as it arrives by a push, for the changed-block CDC).
"""

import hashlib
import struct

import numpy as np

from kart_tpu_torch.core.feature_tree import (
    emit_feature_tree,
    plan_feature_tree,
    plan_int_feature_tree,
)
from kart_tpu_torch.core.objects import MODE_TREE
from kart_tpu_torch.core.repo import KartRepo
from kart_tpu_torch.core.tree_builder import TreeBuilder
from kart_tpu_torch.diff import sidecar
from kart_tpu_torch.crs import Transform, make_crs
from kart_tpu_torch.epsg import epsg_wkt
from kart_tpu_torch.geom import (
    COORD_SCALE,
    KIND_LINE,
    KIND_POINT,
    KIND_POLY,
    WORLD_X,
    WORLD_Y,
    VertexColumn,
    boxes_vertex_column,
)
from kart_tpu_torch.geometry import Geometry
from kart_tpu_torch.models.dataset import Dataset3
from kart_tpu_torch.models.paths import B64_ALPHABET, PathEncoder, b64_batch
from kart_tpu_torch.models.schema import ColumnSchema, Schema

_FID = ColumnSchema(id="a1b2c3d4-0001-4000-8000-000000000001", name="fid",
                    data_type="integer", pk_index=0, extra_type_info={"size": 64})
_RATING = ColumnSchema(id="a1b2c3d4-0002-4000-8000-000000000002", name="rating",
                       data_type="float", pk_index=None, extra_type_info={"size": 64})
SYNTH_SCHEMA = Schema([_FID, _RATING])
SYNTH_TEXT_SCHEMA = Schema([
    ColumnSchema(id="a1b2c3d4-0005-4000-8000-000000000005", name="code", data_type="text",
                 pk_index=0, extra_type_info={"length": 15}),
    _RATING,
])
SYNTH_SPATIAL_SCHEMA = Schema([
    _FID,
    ColumnSchema(id="a1b2c3d4-0004-4000-8000-000000000004", name="geom",
                 data_type="geometry", pk_index=None,
                 extra_type_info={"geometryType": "POINT", "geometryCRS": "EPSG:4326"}),
    _RATING,
])


def synth_envelopes(pks, span=None, base=None):
    """Deterministic per-pk wsen EPSG:4326 envelopes (float32 (N, 4)):
    consecutive pks sweep longitude inside a latitude band, bands stack
    south to north, with a golden-ratio latitude jitter in each band, so a
    rectangle selects about its share of the globe. ``span``/``base``
    describe the whole pk range (default: inferred from ``pks``)."""
    pks = np.asarray(pks, dtype=np.int64)
    if not len(pks):
        return np.empty((0, 4), dtype=np.float32)
    if base is None:
        base = int(pks.min())
    idx = (pks - base).astype(np.float64)
    if span is None:
        span = float(idx.max()) + 1.0
    span = max(float(span), 1.0)
    n_bands = max(1, int(round((span / 4096.0) ** 0.5)))
    rows_per_band = span / n_bands
    band = np.minimum(np.floor(idx / rows_per_band), n_bands - 1)
    lon = -180.0 + 360.0 * (idx - band * rows_per_band) / rows_per_band
    band_h = 170.0 / n_bands
    jitter = (np.mod(idx * 0.6180339887498949, 1.0) - 0.5) * (band_h * 0.9)
    lat = -85.0 + band_h * (band + 0.5) + jitter
    out = np.empty((len(pks), 4), dtype=np.float32)
    out[:, 0] = lon
    out[:, 1] = lat
    out[:, 2] = lon + 0.001
    out[:, 3] = lat + 0.001
    return out


def synth_shapes(n, seed=0, center=(0.0, 0.0), span=10.0, max_segments=256):
    """n seeded shapes in a ``span``-degree square around ``center`` as a
    VertexColumn: star polygons of 4 to ``max_segments`` edges (closed
    rings, a third with a star hole), multipoints, single points and
    polylines; one shape in a hundred is stretched past the world's edge
    and clipped to it, so its vertices sit at +-WORLD_X or +-WORLD_Y."""
    rng = np.random.default_rng(seed)
    kinds = rng.choice([KIND_POLY, KIND_POLY, KIND_POINT, KIND_LINE], size=n).astype(np.uint8)
    ring_counts, xs, ys = [], [], []

    def ring(cx, cy, k, r, closed):
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        rad = r * np.where(np.arange(k) % 2 == 0, 1.0, rng.uniform(0.3, 0.7))
        x, y = cx + rad * np.cos(ang), cy + rad * np.sin(ang)
        if closed:
            x, y = np.append(x, x[0]), np.append(y, y[0])
        return x, y

    for i in range(n):
        cx, cy = (np.asarray(center) + rng.uniform(-span / 2, span / 2, 2))
        r = rng.uniform(0.05, span / 4)
        if rng.random() < 0.01:
            r *= 1e3  # crosses the world's edge, clipped below
        kind, rings = kinds[i], []
        if kind == KIND_POLY:
            rings.append(ring(cx, cy, int(rng.integers(4, max_segments + 1)), r, True))
            if rng.random() < 1 / 3:
                rings.append(ring(cx, cy, int(rng.integers(4, 16)), r / 4, True))
        elif kind == KIND_LINE:
            rings.append(ring(cx, cy, int(rng.integers(2, max_segments + 1)), r, False))
        else:
            for _ in range(int(rng.integers(1, 4))):
                px, py = cx + rng.uniform(-r, r), cy + rng.uniform(-r, r)
                rings.append((np.asarray([px]), np.asarray([py])))
        ring_counts.append(len(rings))
        for x, y in rings:
            xs.append(np.clip(np.rint(x * COORD_SCALE), -WORLD_X, WORLD_X).astype(np.int32))
            ys.append(np.clip(np.rint(y * COORD_SCALE), -WORLD_Y, WORLD_Y).astype(np.int32))
    vert_counts = np.asarray([len(x) for x in xs], dtype=np.int64)
    return VertexColumn(
        kinds,
        np.concatenate(([0], np.cumsum(np.asarray(ring_counts, np.int64)))),
        np.concatenate(([0], np.cumsum(vert_counts))),
        np.concatenate(xs),
        np.concatenate(ys),
    )


#: the states of G-NAF's ``ADDRESS_DETAIL_PID`` prefixes (``GA`` + state)
_GNAF_STATES = ("NSW", "VIC", "QLD", "SA", "WA", "TAS", "NT", "ACT")


def gnaf_ids(rows):
    """Row numbers -> G-NAF-shaped address ids: ``GA`` + a state + ten
    digits, 14 or 15 characters (``GANSW0704100000``, ``GASA0704100003``),
    one id a row, none repeated."""
    return [f"GA{_GNAF_STATES[r % 8]}{704100000 + r:010d}" for r in np.asarray(rows).tolist()]


class HashedColumns:
    """A hash-keyed layer's columns for :data:`SYNTH_TEXT_SCHEMA` ids under
    the general hashed encoder, computed in bulk: each row's filename
    (``b64``, its ``b64_len``), leaf tree index (``leaf_ids``, the leading
    24 bits of the sha256 of the packed pk), sidecar key (``keys``, from the
    sha256 of the filename) and its path under ``feature/`` as a
    fixed-width ascii matrix (``paths``)."""

    def __init__(self, ids):
        n = len(ids)
        raw = np.array([c.encode() for c in ids], dtype="S15").view(np.uint8).reshape(n, 15)
        lengths = np.fromiter(map(len, ids), dtype=np.int64, count=n)
        packed = np.zeros((n, 17), dtype=np.uint8)
        packed[:, 0] = 0x91  # fixarray(1)
        packed[:, 1] = 0xA0 | lengths  # fixstr
        packed[:, 2:] = raw
        self.b64, self.b64_len = b64_batch(packed, lengths + 2)
        width = int(self.b64_len.max()) if n else 0
        if n and not (self.b64_len == width).all():
            raise ValueError("synthetic ids must pack to filenames of one width")
        sha = hashlib.sha256
        rows, names = packed.tobytes(), self.b64[:, :width].tobytes()
        heads = np.frombuffer(b"".join([sha(rows[i * 17 : i * 17 + 2 + int(k)]).digest()[:3]
                                        for i, k in enumerate(lengths.tolist())]),
                              dtype=np.uint8).reshape(n, 3)
        tails = np.frombuffer(b"".join([sha(names[i * width : (i + 1) * width]).digest()[:8]
                                        for i in range(n)]), dtype=np.uint8).reshape(n, 8)
        h = heads.astype(np.int64)
        self.leaf_ids = (h[:, 0] << 16) | (h[:, 1] << 8) | h[:, 2]
        self.keys = (np.ascontiguousarray(tails).view(">u8").ravel()
                     >> np.uint64(1)).astype(np.int64)
        alpha = np.frombuffer(B64_ALPHABET.encode("ascii"), dtype=np.uint8)
        self.paths = np.empty((n, 8 + width), dtype=np.uint8)
        for level in range(4):
            self.paths[:, 2 * level] = alpha[(self.leaf_ids >> (18 - 6 * level)) & 63]
            self.paths[:, 2 * level + 1] = ord("/")
        self.paths[:, 8:] = self.b64[:, :width]

    def plan(self):
        return plan_feature_tree(self.leaf_ids, self.b64, self.b64_len,
                                 PathEncoder.GENERAL_ENCODER)


def _random_oids(n, seed):
    """``n`` deterministic pseudo-random blob oids, (n, 20) uint8."""
    return np.random.default_rng(seed).integers(0, 256, size=(n, 20), dtype=np.uint8)


def _changed_row_oids(odb, sel_pks, ratings, schema, geom_xy=None, batch=200_000):
    """Write real feature blobs for a selection of rows; -> (n, 20) uint8
    oids. ``geom_xy``: the (lon, lat) columns of a spatial schema's points."""
    out = np.empty((len(sel_pks), 20), dtype=np.uint8)
    encode = schema.encode_feature_blob
    for i in range(0, len(sel_pks), batch):
        sl = slice(i, min(i + batch, len(sel_pks)))
        if geom_xy is None:
            contents = [encode({"fid": pk, "rating": r})[1]
                        for pk, r in zip(sel_pks[sl].tolist(), ratings[sl].tolist())]
        else:
            xs, ys = geom_xy
            contents = [
                encode({"fid": pk, "geom": Geometry.from_wkb(struct.pack("<BIdd", 1, 1, x, y)),
                        "rating": r})[1]
                for pk, r, x, y in zip(sel_pks[sl].tolist(), ratings[sl].tolist(),
                                       xs[sl].tolist(), ys[sl].tolist())
            ]
        out[sl] = odb.write_blobs_raw(contents)
    return out


def synth_repo(path, n, *, edit_frac=0.01, seed=0, blobs="changed", ds_path="synth",
               spatial=False, pk="int", crs="EPSG:4326"):
    """Create a repo at ``path`` with one dataset of ``n`` features and two
    commits: the base import and an ``edit_frac`` rating rewrite.
    ``spatial=True`` (with ``blobs="changed"`` or ``"real"``) makes it a point
    layer whose sidecars carry envelope and vertex columns; ``pk="text"`` a hash-keyed
    layer of G-NAF-shaped ids (:data:`SYNTH_TEXT_SCHEMA`); ``crs`` the
    point layer's CRS (its points moved there from EPSG:4326).
    -> (repo, {"base_commit", "edit_commit", "n", "n_edits"})."""
    if blobs not in ("real", "changed", "promised"):
        raise ValueError(f"blobs={blobs!r}: use 'real', 'changed' or 'promised'")
    if spatial and blobs == "promised":
        raise ValueError("spatial synth repos take blobs='changed' or 'real'")
    if pk not in ("int", "text") or (spatial and pk != "int"):
        raise ValueError(f"pk={pk!r}: use 'int', or 'text' without spatial")
    repo = KartRepo.init_repository(path)
    repo.config.set_many({"user.name": "Synth", "user.email": "synth@example.com"})
    odb = repo.odb
    base = 1 << 24  # keeps every filename the same width (uint32 msgpack)
    pks = np.arange(base, base + n, dtype=np.int64)

    schema, crs_defs, envelopes, vertices = SYNTH_SCHEMA, None, None, None
    encoder, hashed = PathEncoder.INT_PK_ENCODER, None
    to_crs = None
    if spatial:
        schema = SYNTH_SPATIAL_SCHEMA
        crs_defs = {"EPSG:4326": epsg_wkt(4326)}
        if crs != "EPSG:4326":
            geom_col = schema.columns[1]
            schema = Schema([schema.columns[0], ColumnSchema(
                id=geom_col.id, name=geom_col.name, data_type=geom_col.data_type,
                extra_type_info={**geom_col.extra_type_info, "geometryCRS": crs},
            ), schema.columns[2]])
            crs_defs = {crs: make_crs(crs).wkt}
            to_crs = Transform("EPSG:4326", crs)
        envelopes = synth_envelopes(pks)
        # each synthetic feature's vertex geometry is its envelope's box
        vertices = boxes_vertex_column(envelopes)
    if pk == "text":
        schema, encoder = SYNTH_TEXT_SCHEMA, PathEncoder.GENERAL_ENCODER
        ids = gnaf_ids(np.arange(n))
        hashed = HashedColumns(ids)

    def blob_rows(sel, ratings):
        """Real blobs of rows ``sel``; a point layer's points sit at their
        envelopes' south-west corners."""
        geom_xy = None
        if envelopes is not None:
            geom_xy = (envelopes[sel, 0].astype(np.float64),
                       envelopes[sel, 1].astype(np.float64))
            if to_crs is not None:
                geom_xy = to_crs.transform(*geom_xy)
        if hashed is not None:
            encode = schema.encode_feature_blob
            return odb.write_blobs_raw([encode({"code": ids[r], "rating": v})[1]
                                        for r, v in zip(sel.tolist(), ratings.tolist())])
        return _changed_row_oids(odb, pks[sel], ratings, schema, geom_xy)

    rows = np.arange(n)
    if blobs == "real":
        with odb.bulk_pack(level=0):
            oids1 = blob_rows(rows, pks / 2.0)
    else:
        oids1 = _random_oids(n, seed)

    n_edits = max(1, int(n * edit_frac)) if edit_frac else 0
    rng = np.random.default_rng(seed + 1)
    edit_rows = rng.choice(n, size=n_edits, replace=False) if n_edits else np.zeros(0, np.int64)
    oids2 = oids1.copy()
    if n_edits:
        sel = pks[edit_rows]
        if blobs == "real":
            with odb.bulk_pack(level=0):
                oids2[edit_rows] = blob_rows(edit_rows, sel.astype(np.float64))
        elif blobs == "promised":
            oids2[edit_rows] = _random_oids(n_edits, seed + 2)
        else:
            with odb.bulk_pack(level=0):
                oids1[edit_rows] = blob_rows(edit_rows, sel / 2.0)
                oids2[edit_rows] = blob_rows(edit_rows, sel.astype(np.float64))

    plan = plan_int_feature_tree(pks) if hashed is None else hashed.plan()
    keys, paths = (pks, None) if hashed is None else (hashed.keys, hashed.paths)
    commits = []
    prev = None
    for oids_u8, message in ((oids1, "synth import"), (oids2, "synth edits")):
        with odb.bulk_pack(level=0):
            ftree, leaf_oids = emit_feature_tree(odb, plan, oids_u8, prev=prev)
            prev = (leaf_oids, edit_rows)
            tb = TreeBuilder(odb, repo.head_tree_oid if commits else None)
            for blob_path, data in Dataset3.new_dataset_meta_blobs(
                ds_path, schema, title="synthetic benchmark layer", crs_defs=crs_defs,
                path_encoder=encoder,
            ):
                tb.insert(blob_path, odb.write_blob(data))
            tb.insert(f"{ds_path}/{Dataset3.DATASET_DIRNAME}/feature", ftree, mode=MODE_TREE)
            root = tb.flush()
        commits.append(repo.create_commit("HEAD", root, message, commits[-1:]))
        sidecar.save_sidecar(repo, ftree, keys, oids_u8, envelopes=envelopes, vertices=vertices,
                             paths=paths)
    return repo, {"base_commit": commits[0], "edit_commit": commits[1], "n": n,
                  "n_edits": n_edits}


def commit_point_edits(repo, *, moves=None, inserts=None, deletes=(), message="edit points",
                       ref="HEAD", ds_path="synth"):
    """Commit edits of a :data:`SYNTH_SPATIAL_SCHEMA` point layer on top of
    ``ref``: ``moves`` and ``inserts``, each ``(pks, lon, lat)`` columns or
    None, are written as real blobs with their points there (rating: the
    pk), and the pks ``deletes`` are removed. Only the feature tree's
    touched paths are rewritten, and no sidecar is written. -> the commit
    oid."""
    odb = repo.odb
    parent, _ = repo.resolve_refish(ref)
    encoder = PathEncoder.INT_PK_ENCODER
    root = f"{ds_path}/{Dataset3.DATASET_DIRNAME}/feature/"
    with odb.bulk_pack(level=0):
        tb = TreeBuilder(odb, odb.read_commit(parent).tree)
        for rows in (moves, inserts):
            if rows is None:
                continue
            pks, lon, lat = (np.asarray(c) for c in rows)
            pks = pks.astype(np.int64)
            oids = _changed_row_oids(odb, pks, pks.astype(np.float64), SYNTH_SPATIAL_SCHEMA,
                                     (lon.astype(np.float64), lat.astype(np.float64)))
            for pk, oid in zip(pks.tolist(), oids):
                tb.insert(root + encoder.encode_pks_to_path((pk,)), bytes(oid).hex())
        for pk in np.asarray(deletes, dtype=np.int64).tolist():
            tb.remove(root + encoder.encode_pks_to_path((pk,)))
        tree = tb.flush()
    return repo.create_commit(ref, tree, message, [parent])
