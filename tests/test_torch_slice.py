"""The slice as a whole, on the CPU: the port reads the sidecars and the
envelope index kart_tpu wrote and must give kart_tpu's answers exactly."""

import inspect
import os
import sqlite3

import numpy as np
import pytest

from kart_tpu.diff import sidecar as ref_sidecar
from kart_tpu.diff.engine import get_dataset_feature_count_fast, get_feature_diff_columnar
from kart_tpu.ops.envelope_codec import EnvelopeCodec
from kart_tpu.spatial_filter import ResolvedSpatialFilterSpec, blob_filter_for_spec
from kart_tpu.spatial_filter.index import _SCHEMA
from kart_tpu_torch.diff.engine import classify_changed, feature_count, prefilter_rect
from kart_tpu_torch.diff.sidecar import (
    SidecarError,
    load_block_file,
    save_sidecar_file,
)
from kart_tpu_torch.interop import from_reference_block
from kart_tpu_torch.ops.diff_kernel import DELETE, INSERT, UPDATE
from kart_tpu_torch.spatial_filter import envelope_prepass
from kart_tpu_torch.spatial_filter.index import DB_NAME

FILTERS = [
    "EPSG:4326;POLYGON((-180 -85, 0 -85, 0 85, -180 85, -180 -85))",
    "EPSG:4326;POLYGON((20.123456 -50.5, 140.987654 -50.5, 140.987654 30.25, 20.123456 30.25, 20.123456 -50.5))",
    "EPSG:4326;POLYGON((-5 -5, 5 -5, 5 5, -5 5, -5 -5))",
]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from kart_tpu.synth import synth_repo

    repo, info = synth_repo(
        str(tmp_path_factory.mktemp("torchslice") / "repo"), 30_000, spatial=True
    )
    base_rs, target_rs = repo.structure("HEAD^"), repo.structure("HEAD")
    files = [
        ref_sidecar.sidecar_file(repo, rs.datasets["synth"].feature_tree.oid)
        for rs in (base_rs, target_rs)
    ]
    return repo, info, base_rs, target_rs, files


def test_feature_count_unfiltered(synth):
    repo, info, base_rs, target_rs, (f_old, f_new) = synth
    old, new = load_block_file(f_old), load_block_file(f_new)
    assert old.count == new.count == 30_000
    want = get_dataset_feature_count_fast(base_rs, target_rs, "synth")
    assert want == info["n_edits"]
    assert feature_count(old, new, device="cpu") == want


@pytest.mark.parametrize("spec_text", FILTERS)
def test_feature_count_filtered(synth, spec_text):
    repo, info, base_rs, target_rs, (f_old, f_new) = synth
    spec = ResolvedSpatialFilterSpec.from_spec_string(spec_text)
    want = get_dataset_feature_count_fast(
        base_rs, target_rs, "synth", spatial_filter_spec=spec
    )
    rect = prefilter_rect(spec.envelope_wsen_4326)
    got = feature_count(load_block_file(f_old), load_block_file(f_new), rect, device="cpu")
    assert got == want


def test_changed_rows_equal_columnar_deltas(synth):
    repo, info, base_rs, target_rs, (f_old, f_new) = synth
    base_ds, target_ds = base_rs.datasets["synth"], target_rs.datasets["synth"]
    ref_old = ref_sidecar.load_block(repo, base_ds, pad=False)
    ref_new = ref_sidecar.load_block(repo, target_ds, pad=False)
    deltas = get_feature_diff_columnar(base_ds, target_ds, blocks=(ref_old, ref_new))
    want = {d.key: d.type for d in deltas.values()}
    assert len(want) == info["n_edits"]

    names = {INSERT: "insert", UPDATE: "update", DELETE: "delete"}
    for old, new in (
        (load_block_file(f_old), load_block_file(f_new)),
        (from_reference_block(ref_old), from_reference_block(ref_new)),
    ):
        res = classify_changed(old, new, device="cpu")
        got = {}
        for i, h in zip(res.old_idx, res.old_hex):
            got[int(old.keys[i])] = names[int(res.old_class[i])]
            assert h == bytes(np.asarray(old.oids[i]).astype("<u4")).hex()
        for i in res.new_idx:
            got.setdefault(int(new.keys[i]), names[int(res.new_class[i])])
        assert got == want
        assert sum(res.counts.values()) == len(want)


class _GitdirOnly:
    def __init__(self, gitdir):
        self.gitdir = gitdir


@pytest.mark.parametrize("kind", ["envelopes", "no_envelopes", "empty"])
def test_save_sidecar_file_byte_identical(synth, tmp_path, kind):
    repo, info, base_rs, target_rs, (f_old, _) = synth
    blk = load_block_file(f_old)
    rng = np.random.default_rng(5)
    n = 0 if kind == "empty" else blk.count
    order = rng.permutation(n)
    keys = np.asarray(blk.keys[:n])[order]
    oids_u8 = np.asarray(blk.oids[:n]).view(np.uint8).reshape(n, 20)[order]
    env = None if kind == "no_envelopes" else np.asarray(blk.envelopes[:n])[order]
    ref_path = ref_sidecar._save_sidecar(
        _GitdirOnly(str(tmp_path)), "deadbeef", keys, oids_u8, None, env
    )
    mine = save_sidecar_file(str(tmp_path / "port.kcol"), keys, oids_u8, env)
    with open(ref_path, "rb") as a, open(mine, "rb") as b:
        assert a.read() == b.read()
    back = load_block_file(mine, pad=True)
    assert back.count == n and len(back.keys) >= max(n, 1)
    np.testing.assert_array_equal(back.keys[:n], np.sort(keys))


def test_load_block_file_rejects(tmp_path, synth):
    repo, info, base_rs, target_rs, (f_old, _) = synth
    hashed = tmp_path / "hashed.kcol"
    ref_sidecar._save_sidecar(
        _GitdirOnly(str(tmp_path)), "hashed", np.array([2, 1], np.int64),
        np.zeros((2, 20), np.uint8), ["a/b", "c/d"], None,
    )
    os.replace(tmp_path / "columnar" / "hashed.kcol", hashed)
    block = load_block_file(str(hashed))  # hash-keyed: read, paths in key order
    assert block.count == 2 and list(block.keys) == [1, 2]
    assert [block.paths[i] for i in range(2)] == ["c/d", "a/b"]
    cut = tmp_path / "hashed_short.kcol"
    cut.write_bytes(hashed.read_bytes()[:-1])  # the paths section cut short
    with pytest.raises(SidecarError):
        load_block_file(str(cut))
    truncated = tmp_path / "short.kcol"
    with open(f_old, "rb") as fh:
        truncated.write_bytes(fh.read()[:5000])
    with pytest.raises(SidecarError):
        load_block_file(str(truncated))
    junk = tmp_path / "junk.kcol"
    junk.write_bytes(b"not a sidecar at all")
    with pytest.raises(SidecarError):
        load_block_file(str(junk))


@pytest.fixture(scope="module")
def indexed_repo(synth):
    """The synth repo with an envelope index: random blob oids mapped to
    the synth envelopes plus anti-meridian-wrapping ones."""
    repo = synth[0]
    rng = np.random.default_rng(9)
    from kart_tpu.synth import synth_envelopes

    env = synth_envelopes(np.arange(5000, dtype=np.int64)).astype(np.float64)
    wrap = rng.random(len(env)) < 0.05
    env[wrap, 0] = rng.uniform(170, 180, wrap.sum())
    env[wrap, 2] = rng.uniform(-180, -170, wrap.sum())
    env[:, 1] = np.clip(env[:, 1], -90, 90)
    env[:, 3] = np.clip(env[:, 3], -90, 90)
    oids = rng.integers(0, 256, size=(len(env), 20), dtype=np.uint8)
    packed = EnvelopeCodec().encode_batch(env)
    con = sqlite3.connect(os.path.join(repo.gitdir, DB_NAME))
    try:
        con.executescript(_SCHEMA)
        con.executemany(
            "INSERT OR REPLACE INTO feature_envelopes VALUES (?, ?)",
            [(o.tobytes(), p.tobytes()) for o, p in zip(oids, packed)],
        )
        con.commit()
    finally:
        con.close()
    return repo


@pytest.mark.parametrize(
    "wsen", ["-30,-20,60,40", (170.0, -60.0, -170.0, 60.0), (-180, -90, 180, 90), "100.5,3.25,100.75,3.5"]
)
def test_envelope_prepass_matches_blob_filter(indexed_repo, monkeypatch, wsen):
    import kart_tpu.ops.bbox as ref_bbox

    # send kart_tpu down its f32 device route too (XLA-CPU here)
    monkeypatch.setattr(ref_bbox, "DEVICE_MIN_ENVELOPES", 0)
    monkeypatch.setattr(ref_bbox, "RESIDENT_MIN_ENVELOPES", 0)
    closure = inspect.getclosurevars(blob_filter_for_spec(indexed_repo, wsen)).nonlocals
    matched, rejected = envelope_prepass(indexed_repo.gitdir, wsen, device="cpu")
    assert matched == closure["matched_oids"]
    assert rejected == closure["rejected_oids"]
    assert len(matched) + len(rejected) == 5000


def test_envelope_prepass_without_index(tmp_path):
    assert envelope_prepass(str(tmp_path), "0,0,1,1", device="cpu") == (None, None)
