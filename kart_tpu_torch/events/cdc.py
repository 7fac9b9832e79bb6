"""Changed-block CDC: which tiles changed between two commits, from the
sidecar columns alone.

1. **Row delta**: both tips' sorted (key, oid) sidecar columns go through
   the diff's classify (kernel K1 on the card,
   :func:`kart_tpu_torch.ops.diff_kernel.classify_blocks`): a row changed
   when its key was inserted or deleted, or kept with another oid. No
   feature blob is read: the oid is the value's identity.
2. **Changed envelopes**: the changed rows' wsen rectangles, from the same
   sidecar envelope columns the tile encoder selects rows by.
3. **Tile cover**: each changed envelope maps, through the Web Mercator
   math of :mod:`kart_tpu_torch.tiles.grid`, to the tiles at each zoom
   whose membership rectangle it intersects.

For any layer set with ``geojson`` the dirty set is exactly the set of
tiles whose content (the layer bytes and the feature count; a payload's
header names its commit) differs between the two commits: membership is
a function of (keys, envelopes), a changed oid changes the geojson line,
and a changed envelope implies a changed oid. (``bin``-only payloads can
coincide across an attribute-only change: there the set is a superset.)
The cover reproduces :func:`kart_tpu_torch.ops.bbox.bbox_intersects_np`'s
closed, cyclic semantics: touching edges, the anti-meridian seam, the
polar extension of the edge rows and degenerate (n < s) rectangles.

A pushed tip arrives without a sidecar (sidecars are a local cache; packs
do not carry them), and building one walks the whole feature tree. So the
new tip's sidecar is derived in O(changed) from the old tip's
(:func:`ensure_derived_sidecar`): the tree delta skips every subtree
whose oid did not change, and only the added and changed features' blobs
are read, for their envelopes.

Counterpart of kart_tpu's ``events/cdc.py``, all of it, with the same
summaries and the same derived sidecar bytes. The public entry points
take ``device`` (``None``: the card, raising
:class:`~kart_tpu_torch.runtime.DeviceUnavailable` without one; ``"cpu"``:
the classify's plain version). kart_tpu's fault-injection hook and its
telemetry spans and counters are not ported: the port has neither the
event emitter nor telemetry.
"""

import re

import numpy as np

from kart_tpu_torch import runtime
from kart_tpu_torch.tiles.grid import merc_xy_cols

#: the zooms an event's dirty-tile set lists (a z+1 tile is dirty only if
#: its z parent is, so a client derives deeper ones)
DEFAULT_EVENT_ZOOMS = tuple(range(0, 9))

#: the most dirty tiles an event lists for a dataset: past it the event
#: carries the changed region's bbox only (``truncated``)
MAX_EVENT_TILES = 4096


def _normalise_lon(w, e):
    """Longitude columns -> (w', e', wraps) in the cyclic range semantics
    of :mod:`kart_tpu_torch.ops.bbox`: values folded into [-180, 180],
    ``wraps`` marking ranges across the anti-meridian (out-of-range inputs
    whose folded ends swap included). A full-width (>= 360 degrees) range
    comes back as (-180, 180, False)."""
    full = (e - w) >= 360.0
    wf = np.mod(w + 180.0, 360.0) - 180.0
    ef = np.mod(e + 180.0, 360.0) - 180.0
    # the fold maps +180 to -180: keep an exact east bound at the seam
    ef = np.where((ef == -180.0) & (e != w), 180.0, ef)
    wraps = (ef < wf) & ~full
    return np.where(full, -180.0, wf), np.where(full, 180.0, ef), wraps


def _merc_rows(lat):
    """Latitude degrees -> normalized mercator y (0 at the north clamp),
    +-inf clipped to the poles first (an infinite bound matches everything
    on its side of the closed compare)."""
    return merc_xy_cols(np.zeros_like(lat), np.clip(lat, -90.0, 90.0))[1]


def tile_cover_ranges(z, envelopes):
    """(M, 4) f64 wsen envelopes -> a list of inclusive tile ranges
    ``(x0, x1, y0, y1)`` (arrays), one per contiguous x-range: a wrapping
    envelope gives two, and one touching the seam also the column at the
    other edge. A range with ``y0 > y1`` (a degenerate rectangle) selects
    nothing. They are the tiles whose cover rectangles
    (:func:`kart_tpu_torch.tiles.grid.tile_cover_wsen`) each envelope
    intersects under :func:`~kart_tpu_torch.ops.bbox.bbox_intersects_np`."""
    env = np.asarray(envelopes, dtype=np.float64).reshape(-1, 4)
    n = 1 << z
    w, s, e, nl = env[:, 0], env[:, 1], env[:, 2], env[:, 3]
    # rows the scans place in no tile: NaN anywhere fails the closed
    # compares, and a non-finite longitude makes the cyclic math NaN
    keep = np.isfinite(w) & np.isfinite(e) & ~np.isnan(s) & ~np.isnan(nl)
    if not keep.all():
        env = env[keep]
        w, s, e, nl = env[:, 0], env[:, 1], env[:, 2], env[:, 3]
    if not len(env):
        return []
    w, e, wraps = _normalise_lon(w, e)

    # tile x covers [x/n*360-180, (x+1)/n*360-180], closed, so it meets
    # [w, e] iff ceil(fx_w)-1 <= x <= floor(fx_e)
    fx_w = (w + 180.0) / 360.0 * n
    fx_e = (e + 180.0) / 360.0 * n
    x0 = np.ceil(fx_w).astype(np.int64) - 1
    x1 = np.floor(fx_e).astype(np.int64)
    # mercator rows, the same algebra (y decreases with latitude). Clipping
    # the fractional row into [0, n] extends the edge rows to the poles: a
    # latitude at or past the clamp maps to y of about +-1e-17, and -1e-17
    # would floor to row -1 and lose a polar feature's tiles
    fy_n = np.clip(_merc_rows(nl) * n, 0.0, float(n))
    fy_s = np.clip(_merc_rows(s) * n, 0.0, float(n))
    y0 = np.minimum(np.maximum(np.ceil(fy_n).astype(np.int64) - 1, 0), n - 1)
    # y1 < y0 for a degenerate (n < s) rectangle: the empty selection, so
    # y1 is not raised to 0
    y1 = np.minimum(np.floor(fy_s).astype(np.int64), n - 1)

    ranges = []
    plain = ~wraps
    if plain.any():
        ranges.append((np.clip(x0[plain], 0, n - 1), np.clip(x1[plain], 0, n - 1),
                       y0[plain], y1[plain]))
        # 180 and -180 are one meridian: an envelope touching one edge
        # touches the tile column at the other
        seam_e = plain & (e == 180.0) & (w > -180.0)
        if seam_e.any():
            zeros = np.zeros(int(seam_e.sum()), dtype=np.int64)
            ranges.append((zeros, zeros, y0[seam_e], y1[seam_e]))
        seam_w = plain & (w == -180.0) & (e < 180.0)
        if seam_w.any():
            last = np.full(int(seam_w.sum()), n - 1, dtype=np.int64)
            ranges.append((last, last, y0[seam_w], y1[seam_w]))
    if wraps.any():
        # [w, 180] and [-180, e]
        xw = np.clip(x0[wraps], 0, n - 1)
        xe = np.clip(x1[wraps], 0, n - 1)
        ranges.append((xw, np.full(len(xw), n - 1, dtype=np.int64), y0[wraps], y1[wraps]))
        ranges.append((np.zeros(len(xe), dtype=np.int64), xe, y0[wraps], y1[wraps]))
    return ranges


def tiles_for_envelopes(z, envelopes, cap=None):
    """-> (sorted unique (k, 2) int64 ``[x, y]`` tiles at zoom ``z`` whose
    cover meets an envelope, k, capped). ``capped`` means the enumeration
    stopped past ``cap`` tiles: the list is incomplete, whatever k is
    (overlapping envelopes can de-duplicate below the cap while ranges
    were left out)."""
    n = 1 << z
    packed = []
    total = 0
    capped = False
    for x0, x1, y0, y1 in tile_cover_ranges(z, envelopes):
        nx = x1 - x0 + 1
        ny = y1 - y0 + 1
        valid = (nx > 0) & (ny > 0)
        if not valid.any():
            continue
        x0, nx, y0, ny = x0[valid], nx[valid], y0[valid], ny[valid]
        sizes = nx * ny
        for i in range(len(x0)):
            xs = np.arange(x0[i], x0[i] + nx[i], dtype=np.int64)
            ys = np.arange(y0[i], y0[i] + ny[i], dtype=np.int64)
            packed.append((xs[:, None] * n + ys[None, :]).ravel())
            total += int(sizes[i])
            if cap is not None and total > cap:
                capped = True
                break
        if capped:
            break
    if not packed:
        return np.zeros((0, 2), dtype=np.int64), 0, False
    uniq = np.unique(np.concatenate(packed))
    out = np.empty((len(uniq), 2), dtype=np.int64)
    out[:, 0] = uniq // n
    out[:, 1] = uniq % n
    return out, len(uniq), capped


def _source_or_none(repo, commit_oid, ds_path):
    from kart_tpu_torch.tiles.source import TileSourceError, source_for

    if commit_oid is None:
        return None
    try:
        return source_for(repo, commit_oid, ds_path)
    except TileSourceError:
        return None


# --- the O(changed) sidecar of a pushed tip ----------------------------------------------


class _DeltaUnavailable(Exception):
    """The tree delta cannot be computed (a shallow or partial history):
    the tile source builds the sidecar instead."""


#: one tree entry: ``<mode> <name>\0<20-byte sha>``
_TREE_ENTRY = re.compile(rb"(\d+) ([^\x00]*)\x00(.{20})", re.S)


def _tree_records(odb, oid):
    """A tree's entries as a set of raw ``(mode, name, sha)`` byte tuples,
    split at C speed: the delta compares whole records and decodes only
    those that differ."""
    from kart_tpu_torch.core.objects import ObjectFormatError

    if not oid:
        return set()
    obj_type, data = odb.read_raw(oid)
    records = _TREE_ENTRY.findall(data)
    if obj_type != "tree" or 22 * len(records) + sum(
            len(mode) + len(name) for mode, name, _ in records) != len(data):
        raise ObjectFormatError(f"{oid} is not a well-formed tree")
    return set(records)


def _tree_delta(odb, old_tree_oid, new_tree_oid):
    """-> (removed {path: oid}, added {path: oid}) of the blob leaves that
    differ between two feature trees, walking only subtrees whose oids
    differ (kart_tpu's walk: an entry whose oid is the same on both sides
    is skipped whatever its mode)."""
    from kart_tpu_torch.core.objects import MODE_TREE
    from kart_tpu_torch.core.odb import ObjectMissing

    removed, added = {}, {}
    stack = [(old_tree_oid, new_tree_oid, "")]
    while stack:
        old_oid, new_oid, prefix = stack.pop()
        if old_oid == new_oid:
            continue
        try:
            old_recs, new_recs = _tree_records(odb, old_oid), _tree_records(odb, new_oid)
        except (ObjectMissing, KeyError, ValueError):
            raise _DeltaUnavailable() from None
        old_entries = {name: (int(mode, 8) == MODE_TREE, sha.hex())
                       for mode, name, sha in old_recs - new_recs}
        new_entries = {name: (int(mode, 8) == MODE_TREE, sha.hex())
                       for mode, name, sha in new_recs - old_recs}
        for name in old_entries.keys() | new_entries.keys():
            o, n = old_entries.get(name), new_entries.get(name)
            path = f"{prefix}{name.decode('utf8')}"
            o_tree = o is not None and o[0]
            n_tree = n is not None and n[0]
            if o_tree or n_tree:
                stack.append((o[1] if o_tree else None, n[1] if n_tree else None, f"{path}/"))
                if o is not None and not o_tree:
                    removed[path] = o[1]
                if n is not None and not n_tree:
                    added[path] = n[1]
                continue
            if o is not None and n is not None and o[1] == n[1]:
                continue
            if o is not None:
                removed[path] = o[1]
            if n is not None:
                added[path] = n[1]
    return removed, added


def ensure_derived_sidecar(repo, old_ds, new_ds):
    """Make sure ``new_ds``'s feature tree has a sidecar, deriving it in
    O(changed) from ``old_ds``'s where it can (an int-pk dataset whose old
    sidecar exists). -> True when a sidecar exists afterwards without a
    walk of the whole tree here (otherwise the tile source's
    ``ensure_block`` builds one). The derived sidecar has an envelope
    column when the old one has, read from the added features' blobs, and
    no vertex column."""
    from kart_tpu_torch.diff import sidecar

    if new_ds is None or new_ds.feature_tree is None:
        return False
    if sidecar.has_sidecar(repo, new_ds):
        return True
    if old_ds is None or old_ds.feature_tree is None or old_ds.path_encoder.scheme != "int":
        return False
    old_block = sidecar.load_block(repo, old_ds, pad=False)
    if old_block is None:
        return False
    try:
        removed_paths, added_paths = _tree_delta(repo.odb, old_ds.feature_tree.oid,
                                                 new_ds.feature_tree.oid)
    except _DeltaUnavailable:
        return False
    decode = new_ds.decode_path_to_pks
    removed = {int(decode(p)[0]) for p in removed_paths}
    added = {}
    added_envs = {} if old_block.envelopes is not None else None
    geom_col = new_ds.geom_column_name
    if added_envs is not None and added_paths:
        paths = sorted(added_paths)
        oids = [added_paths[p] for p in paths]
        blobs = repo.odb.read_blobs_data_ordered([bytes.fromhex(o) for o in oids])
        for path, oid, blob in zip(paths, oids, blobs):
            pk = int(decode(path)[0])
            added[pk] = oid
            feature = new_ds.get_feature((pk,), data=blob)
            added_envs[pk] = sidecar._feature_envelope_wsen(feature, geom_col)
    else:
        added = {int(decode(p)[0]): oid for p, oid in added_paths.items()}
    sidecar.derive_sidecar(repo, old_block, new_ds.feature_tree.oid, removed, added, added_envs)
    return True


def changed_envelopes(old_source, new_source, device):
    """-> ((M, 4) f64 envelopes of the changed rows of both tips, counts)
    from one classify of the two sidecars' (key, oid) columns on
    ``device`` (a resolved torch.device). ``None`` on one side means the
    dataset appeared or went: every row of the other side changed, and no
    classify runs."""
    from kart_tpu_torch.ops.diff_kernel import changed_indices, classify_blocks, counts_dict

    if old_source is None and new_source is None:
        return np.zeros((0, 4), dtype=np.float64), {}
    if old_source is None or new_source is None:
        src = new_source if old_source is None else old_source
        envs = np.asarray(src.envelopes(), dtype=np.float64)
        return envs, {"inserts" if old_source is None else "deletes": src.block.count}
    old_class, new_class, counts = classify_blocks(old_source.block, new_source.block, device)
    old_idx, new_idx = changed_indices(old_class, new_class)
    parts = []
    if len(old_idx):
        parts.append(np.asarray(old_source.envelopes(), dtype=np.float64)[old_idx])
    if len(new_idx):
        parts.append(np.asarray(new_source.envelopes(), dtype=np.float64)[new_idx])
    envs = np.concatenate(parts) if parts else np.zeros((0, 4), dtype=np.float64)
    return envs, {k: v for k, v in counts_dict(counts).items() if v}


def _bbox_of(envelopes):
    """The union wsen of the changed envelopes (finite ones; a wrapping one
    widens it to every longitude): the rectangle a truncated event
    carries."""
    env = np.asarray(envelopes, dtype=np.float64).reshape(-1, 4)
    env = env[np.isfinite(env).all(axis=1)]
    if not len(env):
        return None
    wraps = (env[:, 2] < env[:, 0]).any()
    w = -180.0 if wraps else float(env[:, 0].min())
    e = 180.0 if wraps else float(env[:, 2].max())
    return [w, float(env[:, 1].min()), e, float(env[:, 3].max())]


def dirty_tiles(repo, old_oid, new_oid, *, zooms=DEFAULT_EVENT_ZOOMS, max_tiles=MAX_EVENT_TILES,
                device=None):
    """The CDC verb: -> the dirty-tile summary of each dataset between two
    commits of ``repo`` (either side ``None`` for a ref's creation or
    deletion):

        {ds_path: {"changed": {"inserts": i, "deletes": d, "updates": u},
                   "zooms": [z0, z1, ...],
                   "tiles": {"z": [[x, y], ...], ...} | None,
                   "tile_count": unique tiles over the zooms | None,
                   "bbox": [w, s, e, n] | None,
                   "truncated": bool}}

    ``tiles`` is None for a dataset with no tile space on either side (the
    subscriber invalidates it whole) and for a truncated event (invalidate
    by ``bbox``). Datasets whose feature trees are identical are left out.
    ``device``: where the classify runs (one K1 launch a changed dataset
    on the card)."""
    dev = runtime.resolve_device(device)
    summary = {}
    old_sets = _datasets_at(repo, old_oid)
    new_sets = _datasets_at(repo, new_oid)
    paths = set(old_sets.paths() if old_sets else ()) | set(
        new_sets.paths() if new_sets else ())
    for ds_path in sorted(paths):
        old_ds = old_sets.get(ds_path) if old_sets else None
        new_ds = new_sets.get(ds_path) if new_sets else None
        if _tree_oid(old_ds) == _tree_oid(new_ds):
            continue
        if new_ds is not None:
            ensure_derived_sidecar(repo, old_ds, new_ds)
        old_src = _source_or_none(repo, old_oid, ds_path)
        new_src = _source_or_none(repo, new_oid, ds_path)
        if old_src is None and new_src is None:
            summary[ds_path] = {"changed": None, "zooms": list(zooms), "tiles": None,
                                "tile_count": None, "bbox": None, "truncated": False}
            continue
        envs, counts = changed_envelopes(old_src, new_src, dev)
        entry = {"changed": counts, "zooms": list(zooms), "bbox": _bbox_of(envs),
                 "truncated": False}
        tiles = {}
        total = 0
        capped = False
        for z in zooms:
            addrs, k, capped = tiles_for_envelopes(z, envs, cap=max_tiles)
            tiles[str(z)] = addrs.tolist()
            total += k
            if capped or total > max_tiles:
                break
        if capped or total > max_tiles:
            entry.update(tiles=None, truncated=True, tile_count=None)
        else:
            entry.update(tiles=tiles, tile_count=total)
        summary[ds_path] = entry
    return summary


def _datasets_at(repo, commit_oid):
    from kart_tpu_torch.core.structure import RepoStructure

    if commit_oid is None:
        return None
    try:
        return RepoStructure(repo, commit_oid).datasets
    except (KeyError, ValueError):
        return None


def _tree_oid(ds):
    """A dataset's feature tree oid, or None: the O(1) test of whether it
    changed, made before any sidecar is read."""
    if ds is None or ds.feature_tree is None:
        return None
    return ds.feature_tree.oid
