"""The port's bbox test (K3's plain version, device="cpu") against kart_tpu's
Pallas kernel itself, run in interpret mode, and its XLA twin: zero
tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kart_tpu.ops.bbox import _bbox_kernel, bbox_intersects_jnp
from kart_tpu.ops.bbox import pad_envelopes as ref_pad_envelopes
from kart_tpu_torch import runtime
from kart_tpu_torch.ops.bbox import bbox_cyclic, bbox_intersects, pad_envelopes

QUERIES = [
    (10.5, -20.25, 60.75, 45.125),
    (170.0, -60.0, -170.0, 60.0),       # wraps the anti-meridian
    (-180.0, -90.0, 180.0, 90.0),       # full width
    (-179.99, -5.0, 179.99, 5.0),
    (90.0, 0.0, 89.0, 10.0),            # wraps almost all the way round
]


def _envelopes(seed, n=5000):
    rng = np.random.default_rng(seed)
    lon = rng.uniform(-180, 180, n)
    lat = rng.uniform(-90, 90, n)
    env = np.stack([lon, lat, lon + rng.uniform(0, 30, n), lat + rng.uniform(0, 3, n)], 1)
    wrap = rng.random(n) < 0.1
    env[wrap, 0] = rng.uniform(150, 180, wrap.sum())
    env[wrap, 2] = rng.uniform(-180, -150, wrap.sum())
    env[:8] = [
        (-180, -90, 180, 90), (-180, 0, 180, 1), (180, 0, -180, 1), (0, 0, 0, 0),
        (170, -60, -170, 60), (-170, 0, 170, 0), (179.5, 5, -179.5, 6), (360, 0, 361, 1),
    ]
    return env.astype(np.float32)


@pytest.fixture(scope="module")
def pl():
    """jax.experimental.pallas on the suite's CPU platform. Importing it
    registers TPU lowering rules, which needs the platform name "tpu" to be
    known; the suite's CPU insulation removed the TPU factory, so the name
    is declared for the import only (no backend is registered)."""
    from jax._src import xla_bridge

    added = "tpu" not in xla_bridge.known_platforms()
    if added:
        xla_bridge._nonexperimental_plugins.add("tpu")
    try:
        from jax.experimental import pallas
    finally:
        if added:
            xla_bridge._nonexperimental_plugins.discard("tpu")
    return pallas


def _pallas_interpret(pl, w, s, e, n, q):
    """P1 as kart_tpu defines it (_bbox_kernel), through pallas_call in
    interpret mode with (8, 128) blocks and the query as a (4,) block."""
    rows = len(w) // 128
    spec = pl.BlockSpec((8, 128), lambda i: (i, 0))
    with jax.enable_x64(False):
        out = pl.pallas_call(
            _bbox_kernel,
            grid=(rows // 8,),
            in_specs=[pl.BlockSpec((4,), lambda i: (0,)), spec, spec, spec, spec],
            out_specs=spec,
            out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.int8),
            interpret=True,
        )(jnp.asarray(q), *(jnp.asarray(c.reshape(rows, 128)) for c in (w, s, e, n)))
    return np.asarray(out).reshape(-1).astype(bool)


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_kernel_and_jnp(pl, query, seed):
    env = _envelopes(seed)
    w, s, e, n, count = pad_envelopes(env)
    ref_cols = ref_pad_envelopes(env)
    for mine, ref in zip((w, s, e, n, count), ref_cols):
        np.testing.assert_array_equal(mine, ref)
    q = np.asarray(query, dtype=np.float32)
    got = bbox_cyclic(*(torch.from_numpy(c) for c in (w, s, e, n)), q, count).numpy()
    pallas = _pallas_interpret(pl, w, s, e, n, q)
    assert not pallas[count:].any()  # latitude-91 padding never matches
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, np.asarray(bbox_intersects_jnp(w, s, e, n, q)))
    assert 0 < got.sum() <= count  # the full-width query matches all


def test_bbox_intersects_resident_cache_and_count_mask():
    env = _envelopes(3, n=3000)
    q = QUERIES[1]
    runtime.reset_stats()
    first = bbox_intersects(env, q, cache_key=("test", 1), device="cpu")
    second = bbox_intersects(env, q, cache_key=("test", 1), device="cpu")
    assert runtime.stats_snapshot()["bbox_uploads"] == 1
    assert first.shape == (3000,) and torch.equal(first, second)
    uncached = bbox_intersects(env, q, device="cpu")
    assert torch.equal(first, uncached)
    # rows past count are masked even where the padding would match
    cols = [torch.zeros(1024) for _ in range(4)]
    hit = bbox_cyclic(*cols, (-1, -1, 1, 1), count=10)
    assert hit[:10].all() and not hit[10:].any()
    assert bbox_intersects(np.zeros((0, 4)), q, device="cpu").shape == (0,)
