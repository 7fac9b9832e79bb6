"""State carried across from kart_tpu objects without importing kart_tpu.

Sidecar files and envelope indexes are shared on disk and read as they
are (:mod:`kart_tpu_torch.diff.sidecar`,
:mod:`kart_tpu_torch.spatial_filter.index`); an in-memory kart_tpu
``FeatureBlock`` is converted here by duck typing.
"""

import numpy as np

from kart_tpu_torch.ops.blocks import FeatureBlock


def from_reference_block(obj):
    """A kart_tpu FeatureBlock (anything with ``keys``, ``oids``, ``count``
    and optional ``envelopes``/``env_blocks``/``paths``) -> this package's
    FeatureBlock sharing the same numpy arrays and path list."""
    keys = np.asarray(obj.keys)
    oids = np.asarray(obj.oids)
    if keys.dtype != np.int64 or oids.dtype != np.uint32 or oids.shape[1:] != (5,):
        raise TypeError(
            f"expected int64 keys and (n, 5) uint32 oids, got {keys.dtype} "
            f"and {oids.dtype} {oids.shape}"
        )
    envelopes = getattr(obj, "envelopes", None)
    env_blocks = getattr(obj, "env_blocks", None)
    return FeatureBlock(
        keys, oids, int(obj.count),
        envelopes=None if envelopes is None else np.asarray(envelopes),
        env_blocks=env_blocks,
        paths=getattr(obj, "paths", None),
    )
