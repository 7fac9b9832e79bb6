"""The port's envelope prefilter (K2's plain version, device="cpu") against
kart_tpu's sharded f32 step and the native scan: zero tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kart_tpu import native
from kart_tpu.diff.backend import _bbox_hits_f32_step, _query_f32_thresholds
from kart_tpu_torch.diff.backend import (
    envelope_scan,
    envelope_scan_plain,
    query_f32_thresholds,
    select_backend,
)
from kart_tpu_torch.ops.blocks import FeatureBlock

NON_WRAPPING = [
    (-73.123456789, -33.3333333333, 151.2222222222, 61.7777777777),
    (0.0, 0.0, 10.0, 10.0),
    (-180.0, -90.0, 180.0, 90.0),
    (20.1, -50.00000001, 140.7, 30.3),
    (-0.3, -0.3, -0.3, -0.3),
]
WRAPPING = [
    (170.0, -60.0, -170.0, 60.0),
    (179.99999999, -89.9, -179.99999999, 89.9),
    (100.123456789, -10.1, 20.987654321, 45.5),
]


def _envelopes(seed, queries, n=20_000, non_finite=False):
    """Points, small boxes, wrapping boxes, rows sitting one f32 ulp either
    side of every query bound, and (optionally) NaN/inf rows."""
    rng = np.random.default_rng(seed)
    lon = rng.uniform(-180, 180, n)
    lat = rng.uniform(-90, 90, n)
    env = np.stack([lon, lat, lon, lat], axis=1)
    box = rng.random(n) < 0.2
    env[box, 2] += rng.uniform(0, 5, box.sum())
    env[box, 3] += rng.uniform(0, 5, box.sum())
    wrap = rng.random(n) < 0.02
    env[wrap, 0] = rng.uniform(170, 180, wrap.sum())
    env[wrap, 2] = rng.uniform(-180, -170, wrap.sum())
    env = env.astype(np.float32)
    edge = []
    for q in queries:
        for b in np.asarray(q, dtype=np.float32):
            for v in (np.nextafter(b, np.float32(-np.inf)), b, np.nextafter(b, np.float32(np.inf))):
                edge.append([v, v, v, v])
                edge.append([v - 1, v - 1, v, v])
                edge.append([v, v, v + 1, v + 1])
    env = np.concatenate([env, np.asarray(edge, dtype=np.float32)])
    if non_finite:
        bad = np.array(
            [[np.nan] * 4, [np.nan, 0, 1, 1], [0, np.nan, 1, 1], [0, 0, np.nan, 1],
             [0, 0, 1, np.nan], [-np.inf, -1, np.inf, 1], [0, -np.inf, 1, np.inf],
             [np.inf, 0, -np.inf, 1], [np.inf] * 4, [-np.inf] * 4],
            dtype=np.float32,
        )
        env = np.concatenate([env, bad])
    return np.ascontiguousarray(env)


@pytest.mark.parametrize("query", NON_WRAPPING + WRAPPING)
def test_thresholds_match(query):
    np.testing.assert_array_equal(
        query_f32_thresholds(query), _query_f32_thresholds(np.asarray(query))
    )


@pytest.mark.parametrize("query", NON_WRAPPING)
@pytest.mark.parametrize("non_finite", [False, True])
def test_non_wrapping_matches_jnp_step_and_native(query, non_finite):
    env = _envelopes(1, NON_WRAPPING, non_finite=non_finite)
    got = envelope_scan(torch.from_numpy(env), query).numpy()
    q = _query_f32_thresholds(np.asarray(query, dtype=np.float64))
    cols = [jnp.asarray(env[:, i]) for i in range(4)]
    step = np.asarray(_bbox_hits_f32_step(*cols, jnp.asarray(q)))
    # XLA's CPU backend flushes subnormal inputs to zero (the native scan,
    # the port and the card do not), so rows holding a subnormal value are
    # held to the native scan alone
    tiny = np.finfo(np.float32).tiny
    with np.errstate(invalid="ignore"):
        normal = ~((env != 0) & (np.abs(env) < tiny)).any(axis=1)
    assert (~normal).sum() < 20
    np.testing.assert_array_equal(got[normal], step[normal])
    np.testing.assert_array_equal(got, native.bbox_intersects_f32(env, query))
    assert 0 < got.sum() < len(got) or query == (-180.0, -90.0, 180.0, 90.0)


@pytest.mark.parametrize("query", WRAPPING)
@pytest.mark.parametrize("seed", [2, 3])
def test_wrapping_matches_native(query, seed):
    env = _envelopes(seed, WRAPPING)
    got = envelope_scan_plain(torch.from_numpy(env), query).numpy()
    np.testing.assert_array_equal(got, native.bbox_intersects_f32(env, query))
    assert 0 < got.sum() < len(got)


def test_backend_envelope_hits_counts_only_real_rows():
    env = _envelopes(4, NON_WRAPPING[:1], n=3000)
    keys = np.arange(len(env), dtype=np.int64)
    block = FeatureBlock.from_arrays(keys, np.zeros((len(env), 5), np.uint32))
    block.envelopes = env
    backend = select_backend("cpu")
    assert backend.name == "cpu_torch"
    hits = backend.envelope_hits(block, NON_WRAPPING[0]).numpy()
    np.testing.assert_array_equal(hits, native.bbox_intersects_f32(env, NON_WRAPPING[0]))


def test_envelope_scan_rejects_bad_layout():
    with pytest.raises(ValueError):
        envelope_scan(torch.zeros((4, 3)), (0, 0, 1, 1))
    with pytest.raises(ValueError):
        envelope_scan(torch.zeros((4, 4), dtype=torch.float64), (0, 0, 1, 1))
