"""Seeded import sources, for exercising the importers at a real layer's
size: a point Shapefile (``.shp``, ``.shx``, ``.dbf``, ``.prj``) with C, N
(integer and decimal), F, L and D fields, some nulls and some records
marked deleted, its edited rewrite, a polygon Shapefile with holes,
multipart shapes and null shapes, a ``.zip`` of a Shapefile, and the same
points as a FlatGeobuf with or without its packed R-tree.

The writers are small and plain: records are laid out with ``struct`` and
numpy, and the FlatGeobuf flatbuffers are written with forward offsets (a
legal layout that readers walk through the vtables like the usual
back-to-front one). :func:`point_layer` gives the rows themselves, so a
check can hold an import to them.
"""

import os
import struct
import zipfile

import numpy as np

from kart_tpu_torch.epsg import epsg_wkt
from kart_tpu_torch.importer.flatgeobuf import packed_rtree_size

#: the point layer's dBase fields: (name, type, length, decimals)
POINT_FIELDS = (("name", "C", 24, 0), ("pop", "N", 10, 0), ("area", "N", 12, 3),
                ("ratio", "F", 19, 0), ("capital", "L", 1, 0), ("founded", "D", 8, 0))
#: FlatGeobuf column types of the same fields (String, Long, Double, Double,
#: Bool, String): a FlatGeobuf has no decimal or date type
FGB_TYPES = {"name": 11, "pop": 7, "area": 10, "ratio": 10, "capital": 2, "founded": 11}

SHP_POINT, SHP_POLYGON = 1, 5


def point_layer(n, seed=0):
    """``n`` point records from ``seed``: {"x", "y", "deleted", field: values}
    (None a null; ``area`` a decimal string; ``founded`` an ISO date)."""
    rng = np.random.default_rng(seed)
    layer = {"x": np.round(rng.uniform(-179.9, 179.9, n), 6).tolist(),
             "y": np.round(rng.uniform(-84.9, 84.9, n), 6).tolist(),
             "deleted": (rng.random(n) < 0.002).tolist()}
    null = lambda p: (rng.random(n) < p).tolist()
    pops = rng.integers(0, 10**8, n).tolist()
    areas = rng.integers(0, 10**8, n).tolist()
    ratios = rng.standard_normal(n).tolist()
    days = rng.integers(0, 60_000, n).tolist()
    flags = (rng.random(n) < 0.5).tolist()
    base = np.datetime64("1850-01-01")
    layer["name"] = [None if z else f"place {i} {'x' * (i % 7)}"
                     for i, z in enumerate(null(0.02))]
    layer["pop"] = [None if z else v for v, z in zip(pops, null(0.03))]
    layer["area"] = [None if z else f"{v // 1000}.{v % 1000:03d}" for v, z in zip(areas, null(0.03))]
    layer["ratio"] = [None if z else float(f"{v:.9g}") for v, z in zip(ratios, null(0.03))]
    layer["capital"] = [None if z else f for f, z in zip(flags, null(0.05))]
    layer["founded"] = [None if z else str(base + d) for d, z in zip(days, null(0.05))]
    return layer


def edited_point_layer(layer, seed=1, moved=0.01, deleted=0.001, inserted=0.001):
    """A copy of ``layer`` with a fraction of its live records moved (and
    renamed), deleted (marked so: the FID is the record number) and
    inserted after the last. -> (layer, {"moved", "deleted", "inserted"}
    FIDs)."""
    rng = np.random.default_rng(seed)
    out = {k: list(v) for k, v in layer.items()}
    n = len(out["x"])
    live = [i for i in range(n) if not out["deleted"][i]]
    picks = rng.permutation(live)
    n_move, n_del = int(len(live) * moved), int(len(live) * deleted)
    moves, dels = sorted(picks[:n_move].tolist()), sorted(picks[n_move:n_move + n_del].tolist())
    for i in moves:
        out["x"][i] = round(out["x"][i] * 0.5 + 0.01, 6)
        out["y"][i] = round(out["y"][i] * 0.5 - 0.01, 6)
        out["name"][i] = f"moved {i}"
    for i in dels:
        out["deleted"][i] = True
    extra = point_layer(max(1, int(len(live) * inserted)), seed + 1000)
    for k in out:
        out[k] += extra[k]
    fids = lambda idx: [i + 1 for i in idx]
    return out, {"moved": fids(moves), "deleted": fids(dels),
                 "inserted": list(range(n + 1, len(out["x"]) + 1))}


def _shp_header(shape_type, file_bytes, bbox):
    h = struct.pack(">7i", 9994, 0, 0, 0, 0, 0, file_bytes // 2)
    return h + struct.pack("<2i4d4d", 1000, shape_type, *bbox, 0, 0, 0, 0)


def _write_shp_shx(base, shape_type, contents, bbox):
    """Records' contents (bytes) -> ``base``.shp and its ``.shx`` index."""
    offsets, body, pos = [], bytearray(), 100
    for i, content in enumerate(contents, 1):
        offsets.append((pos // 2, len(content) // 2))
        body += struct.pack(">2i", i, len(content) // 2) + content
        pos += 8 + len(content)
    with open(base + ".shp", "wb") as f:
        f.write(_shp_header(shape_type, 100 + len(body), bbox) + body)
    with open(base + ".shx", "wb") as f:
        f.write(_shp_header(shape_type, 100 + 8 * len(offsets), bbox))
        f.write(b"".join(struct.pack(">2i", o, c) for o, c in offsets))


def _dbf_cell(value, type_char, length):
    if value is None:
        return b" " * length
    if type_char == "C":
        return str(value).encode("latin-1")[:length].ljust(length)
    if type_char in ("N", "F"):
        return str(value).encode()[:length].rjust(length)
    if type_char == "L":
        return b"T" if value else b"F"
    return value.replace("-", "").encode()  # D: YYYYMMDD


def write_dbf(path, fields, rows, deleted):
    """fields: [(name, type, length, decimals)]; rows: {name: values}."""
    n = len(deleted)
    record_size = 1 + sum(f[2] for f in fields)
    head = struct.pack("<4BIHH20x", 3, 124, 1, 1, n, 32 + 32 * len(fields) + 1, record_size)
    for name, type_char, length, decimals in fields:
        head += (name.encode()[:11].ljust(11, b"\x00") + type_char.encode() + b"\x00" * 4
                 + bytes([length, decimals]) + b"\x00" * 14)
    body = bytearray()
    columns = [(rows[f[0]], f[1], f[2]) for f in fields]
    for i in range(n):
        body += b"*" if deleted[i] else b" "
        for values, type_char, length in columns:
            body += _dbf_cell(values[i], type_char, length)
    with open(path, "wb") as f:
        f.write(head + b"\r" + bytes(body) + b"\x1a")


def write_point_shapefile(base, layer, crs="EPSG:4326"):
    """``layer`` -> ``base``.shp/.shx/.dbf/.prj. -> the .shp path."""
    xy = np.column_stack([layer["x"], layer["y"]]).astype("<f8")
    rec = np.empty(len(xy), dtype=[("type", "<i4"), ("xy", "<f8", (2,))])
    rec["type"], rec["xy"] = SHP_POINT, xy
    contents = [r.tobytes() for r in rec]
    bbox = (xy[:, 0].min(), xy[:, 1].min(), xy[:, 0].max(), xy[:, 1].max()) if len(xy) else (0,) * 4
    _write_shp_shx(base, SHP_POINT, contents, bbox)
    write_dbf(base + ".dbf", POINT_FIELDS, layer, layer["deleted"])
    if crs:
        with open(base + ".prj", "w") as f:
            f.write(epsg_wkt(int(crs.split(":")[1])))
    return base + ".shp"


def _square(cx, cy, r, clockwise):
    ring = [(cx - r, cy - r), (cx - r, cy + r), (cx + r, cy + r), (cx + r, cy - r),
            (cx - r, cy - r)]
    return ring if clockwise else ring[::-1]


def write_polygon_shapefile(base, n, seed=0, crs="EPSG:4326"):
    """``n`` polygon records from ``seed``: square shells (clockwise), a hole
    (counter-clockwise) in every third, a second shell in every fifth, a
    null shape every 97th; ``id`` and ``kind`` fields. -> the .shp path."""
    rng = np.random.default_rng(seed)
    cx, cy = rng.uniform(-170, 170, n), rng.uniform(-80, 80, n)
    size = rng.uniform(0.01, 1.0, n)
    contents, kinds = [], []
    for i in range(n):
        if i % 97 == 96:
            contents.append(struct.pack("<i", 0))
            kinds.append(None)
            continue
        rings = [_square(cx[i], cy[i], size[i], True)]
        if i % 3 == 0:
            rings.append(_square(cx[i], cy[i], size[i] / 3, False))
        if i % 5 == 0:
            rings.append(_square(cx[i] + 3 * size[i], cy[i], size[i] / 2, True))
        pts = np.array([p for r in rings for p in r], dtype="<f8")
        starts = np.cumsum([0] + [len(r) for r in rings[:-1]]).astype("<i4")
        contents.append(struct.pack("<i4d2i", SHP_POLYGON, pts[:, 0].min(), pts[:, 1].min(),
                                    pts[:, 0].max(), pts[:, 1].max(), len(rings), len(pts))
                        + starts.tobytes() + pts.tobytes())
        kinds.append("holed" if i % 3 == 0 else "multi" if i % 5 == 0 else "plain")
    _write_shp_shx(base, SHP_POLYGON, contents, (-180, -90, 180, 90))
    write_dbf(base + ".dbf", (("id", "N", 9, 0), ("kind", "C", 8, 0)),
              {"id": list(range(1, n + 1)), "kind": kinds}, [False] * n)
    if crs:
        with open(base + ".prj", "w") as f:
            f.write(epsg_wkt(int(crs.split(":")[1])))
    return base + ".shp"


def zip_shapefile(shp_path, zip_path, folder="data/"):
    """The Shapefile's files into ``zip_path`` under ``folder``, beside a
    ``__MACOSX/`` resource entry. -> ``zip_path``."""
    base = os.path.splitext(shp_path)[0]
    stem = os.path.basename(base)
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for ext in (".shp", ".shx", ".dbf", ".prj"):
            if os.path.exists(base + ext):
                zf.write(base + ext, folder + stem + ext)
        zf.writestr(f"__MACOSX/{folder}._{stem}.shp", b"\x00\x05\x16\x07")
    return zip_path


# --- FlatGeobuf --------------------------------------------------------------

def _table(buf, fields):
    """Append a flatbuffers table: fields {slot: ("i", fmt, value) inline
    | ("o", writer) an offset to what ``writer(buf)`` appends after it}.
    -> the table's position."""
    nslots = max(fields) + 1 if fields else 0
    pos = len(buf)
    buf += b"\x00\x00\x00\x00"
    slots, patches = {}, []
    for fid in sorted(fields):
        entry = fields[fid]
        slots[fid] = len(buf) - pos
        if entry[0] == "i":
            buf += struct.pack(entry[1], entry[2])
        else:
            patches.append((len(buf), entry[1]))
            buf += b"\x00\x00\x00\x00"
    size = len(buf) - pos
    vt = len(buf)
    buf += struct.pack("<HH", 4 + 2 * nslots, size)
    buf += b"".join(struct.pack("<H", slots.get(f, 0)) for f in range(nslots))
    struct.pack_into("<i", buf, pos, pos - vt)
    for slot, writer in patches:
        struct.pack_into("<I", buf, slot, writer(buf) - slot)
    return pos


def _string(text):
    def writer(buf):
        pos = len(buf)
        raw = text.encode("utf-8")
        buf += struct.pack("<I", len(raw)) + raw + b"\x00"
        return pos
    return writer


def _vector(fmt, values):
    def writer(buf):
        pos = len(buf)
        buf += struct.pack("<I", len(values)) + struct.pack("<" + fmt * len(values), *values)
        return pos
    return writer


def _bytes(raw):
    def writer(buf):
        pos = len(buf)
        buf += struct.pack("<I", len(raw)) + raw
        return pos
    return writer


def _tables(field_dicts):
    def writer(buf):
        pos = len(buf)
        buf += struct.pack("<I", len(field_dicts)) + b"\x00" * 4 * len(field_dicts)
        for i, fields in enumerate(field_dicts):
            slot = pos + 4 + 4 * i
            struct.pack_into("<I", buf, slot, _table(buf, fields) - slot)
        return pos
    return writer


def _sub(fields):
    return lambda buf: _table(buf, fields)


def _root(fields):
    """A size-prefixed flatbuffer: [u32 size][u32 root offset][table...]."""
    inner = bytearray(b"\x00\x00\x00\x00")
    struct.pack_into("<I", inner, 0, _table(inner, fields))
    return struct.pack("<I", len(inner)) + bytes(inner)


_PROP_FMT = {2: "<B", 7: "<q", 10: "<d"}


def write_point_flatgeobuf(path, layer, name="points", crs_code=4326, index_node_size=0):
    """The live records of ``layer`` as a FlatGeobuf point layer named
    ``name``, its CRS an EPSG code, with a packed R-tree (its bytes, which
    readers skip) when ``index_node_size``. -> ``path``."""
    names = [f[0] for f in POINT_FIELDS]
    live = [i for i in range(len(layer["x"])) if not layer["deleted"][i]]
    header = {0: ("o", _string(name)), 2: ("i", "<B", 1),
              7: ("o", _tables([{0: ("o", _string(c)), 1: ("i", "<B", FGB_TYPES[c])}
                                for c in names])),
              8: ("i", "<Q", len(live)), 9: ("i", "<H", index_node_size),
              10: ("o", _sub({0: ("o", _string("EPSG")), 1: ("i", "<i", crs_code)}))}
    out = bytearray(b"fgb\x03fgb\x00") + _root(header)
    out += b"\xee" * packed_rtree_size(len(live), index_node_size)
    for i in live:
        props = bytearray()
        for ci, c in enumerate(names):
            v = layer[c][i]
            if v is None:
                continue
            t = FGB_TYPES[c]
            props += struct.pack("<H", ci)
            if t in _PROP_FMT:
                props += struct.pack(_PROP_FMT[t], float(v) if t == 10 else int(v))
            else:
                raw = str(v).encode("utf-8")
                props += struct.pack("<I", len(raw)) + raw
        geom = {1: ("o", _vector("d", [layer["x"][i], layer["y"][i]])), 6: ("i", "<B", 1)}
        out += _root({0: ("o", _sub(geom)), 1: ("o", _bytes(bytes(props)))})
    with open(path, "wb") as f:
        f.write(bytes(out))
    return path
