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

Counterpart of kart_tpu's ``tiles/``, byte for byte. kart_tpu's tile
serving (``serve_tile``, ``tile_etag``, ``tile_request_key`` and the
payload cache of ``tiles/cache.py``) answers only its HTTP lane, which the
port leaves out with the rest of transport.
"""

import importlib
import re

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
    "normalise_layers",
    "parse_payload",
    "resolve_tile_commit",
    "source_for",
    "tile_bounds_wsen",
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
