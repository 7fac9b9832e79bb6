"""Output helpers of the diff writers: JSON styles, the output stream, a
feature's text, JSON and GeoJSON forms, and reprojection for ``--crs``.

Counterpart of kart_tpu's ``diff/output.py`` (``JSON_PARAMS``,
``ExtendedJsonEncoder``, ``geometry_transform_for_dataset``,
``resolve_output_path``, ``dump_json_output``, ``format_wkt_for_output``,
``feature_as_text``, ``feature_field_as_text``, ``feature_as_json``,
``feature_as_geojson``, ``reproject_geometry``).
"""

import json
import sys

import numpy as np

from kart_tpu_torch.crs import Transform, normalise_wkt
from kart_tpu_torch.geometry import Geometry, _build_gpkg, _geom_value

JSON_PARAMS = {
    "compact": {"separators": (",", ":")},
    "extracompact": {"separators": (",", ":")},
    "pretty": {"indent": 2},
}


class ExtendedJsonEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, Geometry):
            return obj.to_hex_wkb()
        if isinstance(obj, bytes):
            return obj.hex()
        return super().default(obj)


def geometry_transform_for_dataset(ds, target_crs):
    """Transform from a dataset's first CRS to ``target_crs``, or None when
    there is no target or the dataset declares no CRS. A target that does
    not resolve raises here, before any output; a projection the engine
    lacks raises when the first geometry is transformed, as in kart_tpu."""
    if target_crs is None or ds is None:
        return None
    ids = ds.crs_identifiers()
    if not ids:
        return None
    return Transform(ds.get_crs_definition(ids[0]), target_crs)


def resolve_output_path(output_path):
    """None/'-' -> stdout; a path -> the file opened for writing; a
    file-like object -> itself."""
    if output_path is None or output_path == "-":
        return sys.stdout
    if hasattr(output_path, "write"):
        return output_path
    return open(output_path, "w")


def dump_json_output(output, output_path, json_style="pretty"):
    fp = resolve_output_path(output_path)
    enc = ExtendedJsonEncoder(**JSON_PARAMS.get(json_style, JSON_PARAMS["pretty"]))
    for chunk in enc.iterencode(output):
        fp.write(chunk)
    fp.write("\n")
    if fp is not sys.stdout:
        fp.flush()
    return fp


def format_wkt_for_output(wkt):
    return normalise_wkt(wkt).rstrip("\n")


def feature_as_text(feature, prefix=""):
    return "\n".join(feature_field_as_text(feature, key, prefix)
                     for key in feature if not key.startswith("__"))


def feature_field_as_text(feature, key, prefix):
    value = feature[key]
    if isinstance(value, Geometry):
        name = value.geometry_type_name.upper()
        value = f"{name} EMPTY" if value.is_empty else f"{name}(...)"
    elif isinstance(value, bytes):
        value = "BLOB(...)"
    value = "␀" if value is None else value
    return f"{prefix}{key:>40} = {value}"


def feature_as_json(feature, pk_value=None, geometry_transform=None):
    """Feature dict -> JSON-ready dict: geometry as upper-hex WKB
    (reprojected by ``geometry_transform`` when given), bytes as hex."""
    out = {}
    for key, value in feature.items():
        if isinstance(value, Geometry):
            if geometry_transform is not None:
                value = reproject_geometry(value, geometry_transform, pk_value)
            value = value.to_hex_wkb()
        elif isinstance(value, bytes):
            value = value.hex()
        out[key] = value
    return out


def feature_as_geojson(feature, pk_value, change=None, geometry_transform=None):
    """Feature dict -> a GeoJSON Feature whose id is ``<change>::<pk>`` (or
    the pk alone)."""
    change_id = f"{change}::{pk_value}" if change else str(pk_value)
    result = {"type": "Feature", "geometry": None, "properties": {}, "id": change_id}
    for key, value in feature.items():
        if isinstance(value, Geometry):
            if geometry_transform is not None:
                value = reproject_geometry(value, geometry_transform, pk_value)
            result["geometry"] = value.to_geojson()
        elif isinstance(value, bytes):
            result["properties"][key] = value.hex()
        else:
            result["properties"][key] = value
    return result


def reproject_geometry(geom, transform, pk_value=None):
    """Every coordinate of ``geom`` through ``transform`` (a
    :class:`~kart_tpu_torch.crs.Transform`) -> a canonical-form Geometry."""

    def tx_points(points):
        if not points:
            return points
        txs, tys = transform.transform(np.array([p[0] for p in points]),
                                       np.array([p[1] for p in points]))
        return [(float(x), float(y)) + tuple(p[2:]) for x, y, p in zip(txs, tys, points)]

    def walk(value):
        name, has_z, has_m, payload = value
        base = value.base_type
        if base == 1:  # point
            if payload is None:
                return value
            return _geom_value(name, has_z, has_m, tx_points([payload])[0])
        if base == 2:  # linestring
            return _geom_value(name, has_z, has_m, tx_points(payload))
        if base == 3:  # polygon
            return _geom_value(name, has_z, has_m, [tx_points(r) for r in payload])
        return _geom_value(name, has_z, has_m, [walk(c) for c in payload])

    return _build_gpkg(walk(geom.to_coords()), crs_id=0)
