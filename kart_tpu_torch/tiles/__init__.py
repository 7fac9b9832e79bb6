"""Vector tiles straight off the columnar store: ``kart export tiles``
writes a z/x/y pyramid of a dataset at any commit from its sidecar
columns, without a working copy.

* :mod:`.grid`    WebMercator XYZ tile and bbox math
* :mod:`.source`  the commit-pinned block reader and its row pruning
* :mod:`.clip`    the vectorized refine and quantize
* :mod:`.encode`  the payload and its layers (bin, ktb2, mvt, geom,
  geojson, props)
* :mod:`.pyramid` the batch export walker
* :mod:`.streams` the KTB2 int and byte-string streams (also the
  sidecar's vertex column codec)
* :mod:`.cache`   the commit-addressed payload cache of served tiles

and here the serving verb behind ``GET /api/v1/tiles/...``:
:func:`tile_request_key`, :func:`tile_etag` and :func:`serve_tile`, whose
encode projects the tile's rows on the server's device (one K7 launch a
cache fill on the card).

Counterpart of kart_tpu's ``tiles/``, byte for byte; the fleet's peer fill
of ``serve_tile`` is not ported.
"""

import importlib
import re
import time

#: the package's names, each from its module; loaded on first use, since
#: the vertex column codec (``kart_tpu_torch.geom``) imports
#: :mod:`.streams`, and the encoder imports ``kart_tpu_torch.geom``
_EXPORTS = {
    **dict.fromkeys(("DEFAULT_LAYERS", "DEFAULT_MAX_FEATURES", "KNOWN_LAYERS", "TileEncodeError",
                     "TileTooLarge", "decode_bin_layer", "decode_ktb2_layer", "decode_mvt_layer",
                     "decode_props_layer", "default_layers", "encode_tile", "normalise_layers",
                     "parse_payload"), "encode"),
    **dict.fromkeys(("DEFAULT_BUFFER", "DEFAULT_EXTENT", "TileAddressError", "tile_bounds_wsen",
                     "validate_tile"), "grid"),
    **dict.fromkeys(("TileDataUnavailable", "TileSource", "TileSourceError", "source_for"),
                    "source"),
    **dict.fromkeys(("etag_for", "tile_cache_for", "tile_key"), "cache"),
}


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


__all__ = [
    "DEFAULT_BUFFER",
    "DEFAULT_EXTENT",
    "DEFAULT_LAYERS",
    "DEFAULT_MAX_FEATURES",
    "KNOWN_LAYERS",
    "TileAddressError",
    "TileDataUnavailable",
    "TileEncodeError",
    "TileSource",
    "TileSourceError",
    "TileTooLarge",
    "decode_bin_layer",
    "decode_ktb2_layer",
    "decode_mvt_layer",
    "decode_props_layer",
    "default_layers",
    "encode_tile",
    "etag_for",
    "normalise_layers",
    "parse_payload",
    "resolve_tile_commit",
    "serve_tile",
    "source_for",
    "tile_bounds_wsen",
    "tile_cache_for",
    "tile_etag",
    "tile_key",
    "tile_request_key",
    "validate_tile",
]

_FULL_OID_RE = re.compile(r"[0-9a-f]{40}")


def resolve_tile_commit(repo, ref):
    """Pin a ref or refish to a commit oid: everything after this is keyed
    by the oid. A full 40-hex oid naming a commit object is taken as it is,
    without the revision grammar."""
    from kart_tpu_torch.core.odb import ObjectMissing
    from kart_tpu_torch.core.repo import NotFound
    from kart_tpu_torch.tiles.source import TileSourceError

    if _FULL_OID_RE.fullmatch(ref):
        try:
            if repo.odb.object_type(ref) == "commit":
                return ref
        except ObjectMissing:
            pass  # not an object here: the ref grammar decides
    try:
        oid, _ref = repo.resolve_refish(ref)
    except NotFound as e:
        raise TileSourceError(str(e))
    if oid is None:
        raise TileSourceError(f"Ref {ref!r} resolves to the empty revision")
    return oid


def tile_request_key(repo, ref, ds_path, z, x, y, *, layers=None, extent=None, buffer=None):
    """One tile request resolved to its cache identity without building
    anything: -> ``(key, etag, commit_oid, (z, x, y), layers)``, the recipe
    behind the served validator and the cache key."""
    from kart_tpu_torch.tiles.cache import etag_for, tile_key
    from kart_tpu_torch.tiles.encode import normalise_layers
    from kart_tpu_torch.tiles.grid import DEFAULT_BUFFER, DEFAULT_EXTENT, validate_tile

    extent = DEFAULT_EXTENT if extent is None else extent
    buffer = DEFAULT_BUFFER if buffer is None else buffer
    z, x, y = validate_tile(z, x, y)
    layers = normalise_layers(layers)
    commit_oid = resolve_tile_commit(repo, ref)
    key = tile_key(commit_oid, ds_path, z, x, y, layers, extent, buffer)
    return key, etag_for(key), commit_oid, (z, x, y), layers


def tile_etag(repo, ref, ds_path, z, x, y, *, layers=None, extent=None, buffer=None):
    """-> (strong validator, commit oid) of a tile request: a client that
    presents it is answered 304 before any source is built."""
    _key, etag, commit_oid, _zxy, _layers = tile_request_key(
        repo, ref, ds_path, z, x, y, layers=layers, extent=extent, buffer=buffer)
    return etag, commit_oid


def serve_tile(repo, ref, ds_path, z, x, y, *, layers=None, extent=None, buffer=None,
               max_features=None, commit_oid=None, device=None):
    """The tile-serving verb: resolve, look in the cache, encode on a miss.
    -> (payload bytes, etag, cached bool). A hit builds no source; a miss
    encodes with its projection on ``device`` (None: the card, one K7
    launch; ``"cpu"``: numpy), one fill a key however many requests wait on
    it. The bytes are kart_tpu's for the same request."""
    from kart_tpu_torch import telemetry as tm
    from kart_tpu_torch.tiles.cache import etag_for, tile_cache_for, tile_key
    from kart_tpu_torch.tiles.encode import encode_tile, normalise_layers
    from kart_tpu_torch.tiles.grid import DEFAULT_BUFFER, DEFAULT_EXTENT, validate_tile
    from kart_tpu_torch.tiles.source import source_for

    extent = DEFAULT_EXTENT if extent is None else extent
    buffer = DEFAULT_BUFFER if buffer is None else buffer
    z, x, y = validate_tile(z, x, y)
    layers = normalise_layers(layers)
    if commit_oid is None:
        commit_oid = resolve_tile_commit(repo, ref)
    key = tile_key(commit_oid, ds_path, z, x, y, layers, extent, buffer)
    etag = etag_for(key)

    cache = tile_cache_for(repo)
    token = None
    if cache is not None:
        mode, got = cache.lookup_or_begin(key)
        if mode == "hit":
            tm.annotate(tile_cache="hit")
            tm.incr("tiles.served")
            tm.incr("tiles.bytes_out", len(got))
            return got, etag, True
        token = got  # a fill token, or None (a wedged filler is bypassed)
    try:
        if cache is not None:
            tm.annotate(tile_cache="miss")
        t_fill = time.perf_counter()
        source = source_for(repo, commit_oid, ds_path)
        payload, _stats = encode_tile(source, z, x, y, layers=layers, extent=extent,
                                      buffer=buffer, max_features=max_features, device=device)
    except BaseException:
        if token is not None:
            token.abandon()
        raise
    if token is not None:
        token.publish(payload)
    if cache is not None:
        tm.observe("tiles.cache.fill_seconds", time.perf_counter() - t_fill)
    tm.incr("tiles.served")
    tm.incr("tiles.bytes_out", len(payload))
    return payload, etag, False
