"""Host wall of the ``mvt`` and ``geom`` layer encoders against a straight
copy of kart_tpu's per-feature loops, on the tiles of one zoom of a
synthetic point layer (the layer ``chip_smoke.py``'s tile phases export).

The port's encoders (:func:`~kart_tpu_torch.tiles.encode.encode_mvt_layer`,
:func:`~kart_tpu_torch.tiles.encode.encode_geom_layer`) build every
feature's bytes in whole-array passes; kart_tpu's loop over the features
in Python. The copies below are kart_tpu's loops as they stand, on the
port's helpers. Both run on the same tiles and must give the same bytes.

    python -m kart_tpu_torch.tiles.encoder_bench [--rows 2000000] [--zoom 5]
        [--timed-rows 250000] [--seed 0]

Prints one JSON object: for each layer the tiles and rows encoded and the
seconds each encoder took.
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np

from kart_tpu_torch.geom import _gather_ranges
from kart_tpu_torch.tiles.clip import (
    _host_merc,
    project_vertices,
    quantize_from_merc,
    refine_rows,
    simplify_ring,
    simplify_tolerance,
)
from kart_tpu_torch.tiles.encode import (
    MVT_LINESTRING,
    MVT_POINT,
    MVT_POLYGON,
    _pb_bytes,
    _pb_varint,
    encode_geom_layer,
    encode_mvt_layer,
    max_features_limit,
)
from kart_tpu_torch.tiles.grid import DEFAULT_BUFFER, DEFAULT_EXTENT, tile_query_wsen
from kart_tpu_torch.tiles.streams import varint_encode, varint_lengths, zigzag

# --- kart_tpu's per-feature encoders, copied as they are ----------------------------------


def _mvt_geometries(boxes):
    b = np.asarray(boxes, dtype=np.int64).reshape(-1, 4)
    m = len(b)
    x0, y0, x1, y1 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    is_pt = (x0 == x1) & (y0 == y1)
    is_ln = ~is_pt & ((x0 == x1) | (y0 == y1))
    is_pg = ~is_pt & ~is_ln
    types = np.where(is_pt, MVT_POINT, np.where(is_ln, MVT_LINESTRING,
                                                MVT_POLYGON)).astype(np.uint8)
    geoms = [b""] * m
    zz = zigzag

    def _fill(mask, mat):
        idx = np.flatnonzero(mask)
        if not len(idx):
            return
        flat = mat.reshape(-1).astype(np.uint64)
        buf = varint_encode(flat)
        per = varint_lengths(flat).reshape(len(idx), -1).sum(axis=1)
        offs = np.concatenate(([0], np.cumsum(per)))
        for j, i in enumerate(idx):
            geoms[i] = buf[offs[j] : offs[j + 1]]

    if is_pt.any():
        k = int(is_pt.sum())
        mat = np.empty((k, 3), dtype=np.uint64)
        mat[:, 0] = 9
        mat[:, 1] = zz(x0[is_pt])
        mat[:, 2] = zz(y0[is_pt])
        _fill(is_pt, mat)
    if is_ln.any():
        k = int(is_ln.sum())
        mat = np.empty((k, 6), dtype=np.uint64)
        mat[:, 0] = 9
        mat[:, 1] = zz(x0[is_ln])
        mat[:, 2] = zz(y0[is_ln])
        mat[:, 3] = (1 << 3) | 2
        mat[:, 4] = zz(x1[is_ln] - x0[is_ln])
        mat[:, 5] = zz(y1[is_ln] - y0[is_ln])
        _fill(is_ln, mat)
    if is_pg.any():
        k = int(is_pg.sum())
        mat = np.empty((k, 11), dtype=np.uint64)
        mat[:, 0] = 9
        mat[:, 1] = zz(x0[is_pg])
        mat[:, 2] = zz(y0[is_pg])
        mat[:, 3] = (3 << 3) | 2
        mat[:, 4] = zz(x1[is_pg] - x0[is_pg])
        mat[:, 5] = zz(np.zeros(k, np.int64))
        mat[:, 6] = zz(np.zeros(k, np.int64))
        mat[:, 7] = zz(y1[is_pg] - y0[is_pg])
        mat[:, 8] = zz(x0[is_pg] - x1[is_pg])
        mat[:, 9] = zz(np.zeros(k, np.int64))
        mat[:, 10] = 15
        _fill(is_pg, mat)
    return types, geoms


def _mvt_layer_bytes(layer_name, keys, types, geoms, extent):
    keys = np.asarray(keys, dtype=np.int64)
    id_codes = keys.astype(np.uint64)
    id_buf = varint_encode(id_codes)
    id_lens = varint_lengths(id_codes)
    id_offs = np.concatenate(([0], np.cumsum(id_lens)))
    features = []
    for i in range(len(keys)):
        body = b"".join((
            b"\x08",
            id_buf[id_offs[i] : id_offs[i + 1]],
            _pb_varint(3, int(types[i])),
            _pb_bytes(4, geoms[i]),
        ))
        features.append(_pb_bytes(2, body))
    layer_body = b"".join((
        _pb_bytes(1, layer_name.encode()),
        b"".join(features),
        _pb_varint(5, extent),
        _pb_varint(15, 2),
    ))
    return _pb_bytes(3, layer_body)


def copy_encode_mvt_layer(layer_name, keys, boxes, extent=DEFAULT_EXTENT):
    types, geoms = _mvt_geometries(boxes)
    return _mvt_layer_bytes(layer_name, keys, types, geoms, extent)


def _clean_part(xs, ys, mvt_type, tol):
    if mvt_type == MVT_POLYGON and len(xs) > 1 and xs[0] == xs[-1] and ys[0] == ys[-1]:
        xs, ys = xs[:-1], ys[:-1]
    if len(xs) > 1:
        same = (xs[1:] == xs[:-1]) & (ys[1:] == ys[:-1])
        if same.any():
            keep = np.concatenate(([True], ~same))
            xs, ys = xs[keep], ys[keep]
    if mvt_type != MVT_POINT and tol > 0 and len(xs) > 2:
        keep = simplify_ring(xs, ys, tol)
        xs, ys = xs[keep], ys[keep]
    if mvt_type == MVT_POINT:
        return (xs, ys) if len(xs) else None
    if mvt_type == MVT_LINESTRING:
        return (xs, ys) if len(xs) >= 2 else None
    if len(xs) < 3:
        return None
    x = xs.astype(np.int64)
    y = ys.astype(np.int64)
    if int((x * np.roll(y, -1) - np.roll(x, -1) * y).sum()) == 0:
        return None
    return xs, ys


def _geom_commands(parts, mvt_type):
    zz = zigzag
    words = []
    if mvt_type == MVT_POINT:
        xs = np.concatenate([p[0] for p in parts]).astype(np.int64)
        ys = np.concatenate([p[1] for p in parts]).astype(np.int64)
        run = np.empty(1 + 2 * len(xs), dtype=np.uint64)
        run[0] = (len(xs) << 3) | 1
        run[1::2] = zz(np.diff(xs, prepend=0))
        run[2::2] = zz(np.diff(ys, prepend=0))
        words.append(run)
    else:
        cx = cy = 0
        for xs, ys in parts:
            xs = xs.astype(np.int64)
            ys = ys.astype(np.int64)
            dx = np.diff(xs, prepend=cx)
            dy = np.diff(ys, prepend=cy)
            n = len(xs)
            run = np.empty(4 + 2 * (n - 1), dtype=np.uint64)
            run[0] = 9
            run[1] = zz(dx[:1])[0]
            run[2] = zz(dy[:1])[0]
            run[3] = ((n - 1) << 3) | 2
            run[4::2] = zz(dx[1:])
            run[5::2] = zz(dy[1:])
            words.append(run)
            if mvt_type == MVT_POLYGON:
                words.append(np.array([15], dtype=np.uint64))
            cx, cy = int(xs[-1]), int(ys[-1])
    return bytes(varint_encode(np.concatenate(words)))


def copy_encode_geom_layer(layer_name, keys, col, rows, boxes, z, x, y, extent=DEFAULT_EXTENT,
                           buffer=DEFAULT_BUFFER):
    rows = np.asarray(rows, dtype=np.int64)
    m = len(rows)
    tol = simplify_tolerance()
    kinds = col.kinds[rows] if m else np.zeros(0, np.uint8)
    ring_idx, ring_counts = _gather_ranges(col.feat_offsets[rows], col.feat_offsets[rows + 1])
    vert_idx, vert_counts = _gather_ranges(col.ring_offsets[ring_idx],
                                           col.ring_offsets[ring_idx + 1])
    tx, ty = project_vertices(col.x[vert_idx], col.y[vert_idx], z, x, y, extent=extent,
                              buffer=buffer)
    ring_offs = np.concatenate(([0], np.cumsum(vert_counts)))
    feat_rings = np.concatenate(([0], np.cumsum(ring_counts)))
    types = np.zeros(m, dtype=np.uint8)
    geoms = [b""] * m
    fallback = []
    for j in range(m):
        mvt_type = int(kinds[j])
        parts = []
        if mvt_type:
            for r in range(int(feat_rings[j]), int(feat_rings[j + 1])):
                v0, v1 = int(ring_offs[r]), int(ring_offs[r + 1])
                part = _clean_part(tx[v0:v1], ty[v0:v1], mvt_type, tol)
                if part is not None:
                    parts.append(part)
        if not parts:
            fallback.append(j)
            continue
        types[j] = mvt_type
        geoms[j] = _geom_commands(parts, mvt_type)
    if fallback:
        fb = np.asarray(fallback, dtype=np.int64)
        fb_types, fb_geoms = _mvt_geometries(np.asarray(boxes)[fb])
        for t, g, j in zip(fb_types, fb_geoms, fb):
            types[j] = t
            geoms[j] = g
    return _mvt_layer_bytes(layer_name, keys, types, geoms, extent)


# --- the measurement ----------------------------------------------------------------------


def tile_inputs(source, z, timed_rows):
    """The zoom's tiles in address order, each as (x, y, rows, keys, boxes)
    quantized on the host, until ``timed_rows`` rows are gathered (tiles
    over the feature ceiling left out)."""
    from kart_tpu_torch.tiles.grid import tile_range_for_bbox
    from kart_tpu_torch.tiles.pyramid import dataset_bbox_wsen

    env_all = source.envelopes()
    limit = max_features_limit()
    x0, y0, x1, y1 = tile_range_for_bbox(z, dataset_bbox_wsen(source))
    out, total = [], 0
    for x in range(x0, x1 + 1):
        for y in range(y0, y1 + 1):
            rows, env = refine_rows(env_all, source.rows_for_bbox(tile_query_wsen(z, x, y))[0],
                                    z, x, y)
            if not len(rows) or (limit and len(rows) > limit):
                continue
            boxes = quantize_from_merc(env, _host_merc(env), z, x, y)
            keys = np.ascontiguousarray(source.block.keys[rows], dtype="<i8")
            out.append((x, y, rows, keys, boxes))
            total += len(rows)
            if total >= timed_rows:
                return out
    return out


def compare(source, z, timed_rows):
    """Both encoders of each layer over the same tiles: equal bytes, and
    -> {layer: {"tiles", "rows", "port_s", "copy_s"}}."""
    tiles = tile_inputs(source, z, timed_rows)
    col = source.vertices()
    name = source.ds_path
    encoders = {
        "mvt": (lambda t: encode_mvt_layer(name, t[3], t[4]),
                lambda t: copy_encode_mvt_layer(name, t[3], t[4])),
        "geom": (lambda t: encode_geom_layer(name, t[3], col, t[2], t[4], z, t[0], t[1]),
                 lambda t: copy_encode_geom_layer(name, t[3], col, t[2], t[4], z, t[0], t[1])),
    }
    result = {}
    for layer, (port, copy) in encoders.items():
        walls, outs = [], []
        for fn in (port, copy):
            t = time.perf_counter()
            outs.append([fn(tile) for tile in tiles])
            walls.append(time.perf_counter() - t)
        if outs[0] != outs[1]:
            raise SystemExit(f"the {layer} encoders differ")
        result[layer] = {"tiles": len(tiles), "rows": int(sum(len(t[2]) for t in tiles)),
                         "port_s": walls[0], "copy_s": walls[1]}
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--zoom", type=int, default=5)
    ap.add_argument("--timed-rows", type=int, default=250_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from kart_tpu_torch.synth import synth_repo
    from kart_tpu_torch.tiles.source import source_for

    with tempfile.TemporaryDirectory(prefix="kart_encoder_bench_") as tmp:
        repo, _ = synth_repo(os.path.join(tmp, "repo"), args.rows, seed=args.seed,
                             spatial=True)
        source = source_for(repo, repo.resolve_refish("HEAD")[0], "synth")
        result = compare(source, args.zoom, args.timed_rows)
    print(json.dumps({"layer_rows": args.rows, "zoom": args.zoom, "seed": args.seed,
                      "encoders": result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
