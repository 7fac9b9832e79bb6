"""Hash-keyed datasets' paths, keys and sidecars, held against kart_tpu on
seeded inputs: ``b64hash``/``hexhash``, the hashed and legacy path
encoders (round trips for text, unicode, composite, int and negative pks),
``encoder_for_schema``, ``hash_keys_for_paths`` bit for bit (keys 0 and
2^63 - 1 included, by a patched sha256), ``has_key_collisions``, and
hash-keyed sidecar files byte-identical in both directions."""

import hashlib

import numpy as np
import pytest

from kart_tpu.core import serialise as jser
from kart_tpu.diff import sidecar as jsidecar
from kart_tpu.models import paths as jpaths
from kart_tpu.models.schema import ColumnSchema as JColumn
from kart_tpu.models.schema import Schema as JSchema
from kart_tpu.ops import blocks as jblocks
from kart_tpu_torch.core import serialise as tser
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.diff import sidecar as tsidecar
from kart_tpu_torch.models import paths as tpaths
from kart_tpu_torch.models.schema import ColumnSchema as TColumn
from kart_tpu_torch.models.schema import Schema as TSchema
from kart_tpu_torch.ops import blocks as tblocks


def _random_bytes(seed, n=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(k), dtype=np.uint8).tobytes()
            for k in rng.integers(0, 90, size=n)]


@pytest.mark.parametrize("seed", range(4))
def test_hashes_match_kart_tpu(seed):
    for data in _random_bytes(seed):
        assert tser.b64hash(data) == jser.b64hash(data)
        assert tser.hexhash(data) == jser.hexhash(data)
        text = data.decode("latin-1")
        assert tser.b64hash(text, data) == jser.b64hash(text, data)


#: pk value tuples of every kind the hashed scheme holds
PKS = {
    "text": [("GANSW704100000",), ("GAVIC4200000019",), ("",), ("a b/c",)],
    "unicode": [("ünï☃",), ("日本語のキー",), ("\x00\x7f",), ("🙂" * 9,)],
    "composite": [(1, "a"), (-5, ""), (2**40, "ü", 3.5), ("x", None)],
    "int": [(0,), (1,), (2**31,), (2**63 - 1,)],
    "negative": [(-1,), (-33,), (-(2**31) - 1,), (-(2**63),)],
}
ENCODERS = ["GENERAL_ENCODER", "LEGACY_ENCODER"]


@pytest.mark.parametrize("encoder", ENCODERS)
@pytest.mark.parametrize("kind", list(PKS))
def test_hash_encoders_match_kart_tpu(kind, encoder):
    mine, ref = getattr(tpaths.PathEncoder, encoder), getattr(jpaths.PathEncoder, encoder)
    assert mine.to_dict() == ref.to_dict()
    for pks in PKS[kind]:
        path = mine.encode_pks_to_path(pks)
        assert path == ref.encode_pks_to_path(pks)
        assert mine.decode_path_to_pks(path) == ref.decode_path_to_pks(path) == tuple(pks)
        assert len(path.split("/")) == mine.levels + 1
    assert mine.expected_blobs_for_tree_samples(10, 64) == \
        ref.expected_blobs_for_tree_samples(10, 64)


def test_path_encoder_get_and_schema_choice():
    spec = {"scheme": "msgpack/hash", "branches": 16, "levels": 3, "encoding": "hex"}
    mine, ref = tpaths.PathEncoder.get(**spec), jpaths.PathEncoder.get(**spec)
    for pks in PKS["text"] + PKS["composite"]:
        assert mine.encode_pks_to_path(pks) == ref.encode_pks_to_path(pks)

    def schemas(pk_types):
        cols = [(f"c{i}", t, i) for i, t in enumerate(pk_types)] + [("v", "float", None)]
        return [S([C(id=f"id-{n}", name=n, data_type=t, pk_index=i) for n, t, i in cols])
                for S, C in ((TSchema, TColumn), (JSchema, JColumn))]

    for pk_types in (["integer"], ["text"], ["integer", "text"], ["float"], []):
        t_schema, j_schema = schemas(pk_types)
        assert tpaths.encoder_for_schema(t_schema).to_dict() == \
            jpaths.encoder_for_schema(j_schema).to_dict()


def _paths(seed, n):
    rng = np.random.default_rng(seed)
    enc = jpaths.PathEncoder.GENERAL_ENCODER
    codes = rng.integers(0, 10**9, size=n)
    return [enc.encode_pks_to_path((f"GA{'NSW' if c % 2 else 'VIC'}{c:010d}",)) for c in codes]


@pytest.mark.parametrize("seed,n", [(0, 0), (1, 1), (2, 1000), (3, 20_000)])
def test_hash_keys_match_kart_tpu(seed, n):
    paths = _paths(seed, n)
    mine, ref = tblocks.hash_keys_for_paths(paths), jblocks.hash_keys_for_paths(paths)
    assert mine.dtype == ref.dtype == np.int64
    np.testing.assert_array_equal(mine, ref)
    assert (mine >= 0).all()


def test_hash_keys_at_both_ends_of_the_range(monkeypatch):
    """sha256 patched so two filenames hash to all-zero and all-one bytes:
    the keys are 0 and 2^63 - 1 (the pad key's value) in both packages."""
    paths = _paths(4, 50)
    low, high = paths[7].rsplit("/", 1)[-1].encode(), paths[31].rsplit("/", 1)[-1].encode()
    real = hashlib.sha256

    class Fixed:
        def __init__(self, digest):
            self._digest = digest

        def digest(self):
            return self._digest

    def sha256(data=b""):
        if data == low:
            return Fixed(b"\x00" * 32)
        if data == high:
            return Fixed(b"\xff" * 32)
        return real(data)

    monkeypatch.setattr(hashlib, "sha256", sha256)
    mine, ref = tblocks.hash_keys_for_paths(paths), jblocks.hash_keys_for_paths(paths)
    np.testing.assert_array_equal(mine, ref)
    assert mine[7] == 0 and mine[31] == 2**63 - 1


@pytest.mark.parametrize("case", ["distinct", "adjacent_pair", "pad_key_pair", "one_row", "empty"])
def test_has_key_collisions_matches_kart_tpu(case):
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 2**63 - 1, size=300, dtype=np.int64)
    if case == "adjacent_pair":
        keys[17] = keys[200]
    elif case == "pad_key_pair":
        keys[3] = keys[4] = 2**63 - 1
    elif case == "one_row":
        keys = keys[:1]
    elif case == "empty":
        keys = keys[:0]
    oids = rng.integers(0, 2**32, size=(len(keys), 5), dtype=np.uint32)
    paths = [f"p{i}" for i in range(len(keys))]
    mine = tblocks.FeatureBlock.from_arrays(keys, oids, paths)
    ref = jblocks.FeatureBlock.from_arrays(keys, oids, paths)
    assert mine.has_key_collisions() == ref.has_key_collisions() == (case.endswith("pair"))
    np.testing.assert_array_equal(mine.keys, ref.keys)
    assert [mine.path_for_index(i) for i in range(mine.count)] == \
        [ref.path_for_index(i) for i in range(ref.count)]


class _GitdirOnly:
    def __init__(self, gitdir):
        self.gitdir = gitdir


def _columns(seed, n):
    rng = np.random.default_rng(seed)
    paths = _paths(seed, n)
    if n > 3:
        paths[1] = jpaths.PathEncoder.GENERAL_ENCODER.encode_pks_to_path(("ünï☃",))
    keys = jblocks.hash_keys_for_paths(paths)
    if n > 3:
        keys[0], keys[2] = 0, 2**63 - 1
    oids = rng.integers(0, 256, size=(n, 20), dtype=np.uint8)
    env = rng.uniform(-90, 90, size=(n, 4)).astype(np.float32)
    return keys, oids, paths, env


@pytest.mark.parametrize("n", [0, 1, 5000])
@pytest.mark.parametrize("envelopes", [False, True])
def test_hash_keyed_sidecar_files_byte_identical(tmp_path, n, envelopes):
    """The port writes kart_tpu's bytes for a hash-keyed sidecar (keys,
    oids, the paths section, envelopes), and each package reads the
    other's file: keys, oids and paths in key order."""
    keys, oids, paths, env = _columns(n, n)
    env = env if envelopes else None
    ref_file = jsidecar._save_sidecar(_GitdirOnly(str(tmp_path)), "ref", keys, oids, paths, env)
    port_file = tsidecar.save_sidecar_file(str(tmp_path / "port.kcol"), keys, oids, env,
                                           paths=paths)
    with open(ref_file, "rb") as a, open(port_file, "rb") as b:
        assert a.read() == b.read()
    order = np.argsort(keys, kind="stable")
    mine = tsidecar.load_block_file(ref_file)
    ref = jsidecar._load_block_from_mmap(np.memmap(port_file, dtype=np.uint8, mode="r"), None,
                                         False)
    for block in (mine, ref):
        assert block.count == n
        np.testing.assert_array_equal(block.keys[:n], keys[order])
        np.testing.assert_array_equal(np.asarray(block.oids[:n]).view(np.uint8).reshape(n, 20),
                                      oids[order])
        assert [block.paths[i] for i in range(n)] == [paths[i] for i in order]
    padded = tsidecar.load_block_file(port_file, pad=True)
    assert padded.count == n and len(padded.keys) >= max(n, 1)


def test_build_sidecar_matches_kart_tpu(tmp_path):
    """A text-pk dataset's sidecar built from its tree walk by each
    package: the same file, and the port's FeatureBlock from the tree walk
    equals the one it reads back."""
    from kart_tpu.core.repo import KartRepo as JRepo

    from test_torch_diff_cli import _hash_repo

    path, ds_path, _ = _hash_repo(str(tmp_path / "r"), "text")
    jrepo, trepo = JRepo(path), TRepo(path)
    ds_j = jrepo.structure("HEAD").datasets[ds_path]
    ds_t = trepo.structure("HEAD").datasets[ds_path]
    assert ds_t.feature_index()[1] is None
    ref_path = jsidecar.sidecar_file(jrepo, ds_j.feature_tree.oid)
    jsidecar.build_sidecar(jrepo, ds_j)
    with open(ref_path, "rb") as f:
        ref_bytes = f.read()
    block = tsidecar.build_sidecar(trepo, ds_t)
    with open(ref_path, "rb") as f:
        assert f.read() == ref_bytes
    walked = tblocks.FeatureBlock.from_dataset(ds_t, pad=False)
    np.testing.assert_array_equal(walked.keys, block.keys)
    np.testing.assert_array_equal(walked.oids, block.oids)
    assert walked.paths == [block.paths[i] for i in range(block.count)]
