"""Output helpers of the diff writers: JSON styles, the output stream and
a feature's JSON form.

Counterpart of the JSON half of kart_tpu's ``diff/output.py``
(``JSON_PARAMS``, ``ExtendedJsonEncoder``, ``resolve_output_path``,
``dump_json_output``, ``feature_as_json``). Text and GeoJSON output and
reprojection are not ported.
"""

import json
import sys

from kart_tpu_torch.geometry import Geometry

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


def feature_as_json(feature):
    """Feature dict -> JSON-ready dict: geometry as upper-hex WKB, bytes as
    hex."""
    out = {}
    for key, value in feature.items():
        if isinstance(value, Geometry):
            value = value.to_hex_wkb()
        elif isinstance(value, bytes):
            value = value.hex()
        out[key] = value
    return out
