"""The server-side pre-pass of spatially filtered clones: one batch bbox
test of every indexed feature envelope against the filter rect (K3), the
batch half of kart_tpu's ``spatial_filter.blob_filter_for_spec``.
"""

import os

from kart_tpu_torch.ops.bbox import bbox_intersects
from kart_tpu_torch.runtime import resolve_device
from kart_tpu_torch.spatial_filter.index import EnvelopeIndexReader, db_path

#: widens the rect by more than f32 ulp at +-360 (2.2e-5 deg) but less than
#: the codec's outward-rounded granularity (360/2^20 = 3.4e-4 deg): a
#: borderline feature ships (fail open) instead of being withheld
PREPASS_PAD = 1e-4


class SpatialFilterError(ValueError):
    """A malformed filter rectangle."""


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
