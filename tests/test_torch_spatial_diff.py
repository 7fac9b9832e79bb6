"""The spatially filtered ``kart diff``: ``python -m kart_tpu_torch --device
cpu -C <repo> diff`` against kart_tpu's ``kart diff`` on repos whose config
holds a spatial filter, with zero tolerance (equal stdout and exit code),
on both routes: the columnar one (sidecars with envelope columns: the
envelope prefilter, then the classify on the survivors) and the tree walk
(repos imported without sidecars). Plus the spatial synthetic repo against
kart_tpu's: equal commits and byte-identical sidecars, the vertex column
included."""

import contextlib
import hashlib
import io
import os
import shutil

import numpy as np
import pytest
from click.testing import CliRunner

from helpers import edit_commit, make_imported_repo
from kart_tpu.cli import cli as kart_cli
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.diff import sidecar as jsidecar
from kart_tpu.geometry import Geometry
from kart_tpu.spatial_filter import ResolvedSpatialFilterSpec
from kart_tpu.synth import synth_repo as jsynth_repo
from kart_tpu_torch import synth as tsynth
from kart_tpu_torch.cli import main as port_main
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.diff import engine, sidecar

SYNTH_N = 30_000
DATE = "1700000000 +0000"

#: the synth's globe: ~12% inside the rect, a pentagon (so envelopes meet
#: the polygon partly), a polygon with a hole, and a rect around no edited
#: feature
SYNTH_FILTERS = {
    "rect": "EPSG:4326;POLYGON((-60 -30,60 -30,60 30,-60 30,-60 -30))",
    "pentagon": "EPSG:4326;POLYGON((0 -40,40 -10,25 35,-25 35,-40 -10,0 -40))",
    "holed": "EPSG:4326;POLYGON((-90 -60,90 -60,90 60,-90 60,-90 -60),"
             "(-30 -20,30 -20,30 20,-30 20,-30 -20))",
    "nothing": "EPSG:4326;POLYGON((-179.9 -84.9,-179.8 -84.9,-179.8 -84.8,-179.9 -84.8,"
               "-179.9 -84.9))",
}

#: the imported points sit at (100 + fid, -40 - fid / 10): fids 1..5 inside
POINT_FILTERS = {
    "rect": "EPSG:4326;POLYGON((100 -42,106 -42,106 -39,100 -39,100 -42))",
    "pentagon": "EPSG:4326;POLYGON((101 -42,106.5 -41,105 -39,102 -39,100.5 -40.5,101 -42))",
    "nzgd2000": "EPSG:4167;POLYGON((100 -42,106 -42,106 -39,100 -39,100 -42))",
    "nothing": "EPSG:4326;POLYGON((0 0,1 0,1 1,0 1,0 0))",
}

FORMATS = [
    ("-o", "json"),
    ("-o", "json", "--json-style", "compact"),
    ("-o", "json-lines"),
    ("-o", "feature-count"),
    ("-o", "quiet", "--exit-code"),
    ("-o", "json-lines", "--exit-code"),
    ("-o", "text"),
    ("-o", "geojson"),
    ("-o", "geojson", "--crs", "EPSG:4277"),
    ("-o", "json-lines", "--crs", "EPSG:4277"),
]


def _set_filter(path, spec_text):
    repo = JRepo(path)
    repo.config.set_many(ResolvedSpatialFilterSpec.from_spec_string(spec_text).config_items())


def _run_port(path, opts):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_main(["--device", "cpu", "-C", path, "diff", *opts])
    return rc, out.getvalue()


def _run_ref(path, opts):
    ref = CliRunner().invoke(kart_cli, ["-C", path, "diff", *opts])
    assert ref.exception is None or isinstance(ref.exception, SystemExit), ref.exception
    return ref.exit_code, ref.stdout


def _copy(src, dest):
    shutil.copytree(src, dest)
    return str(dest)


def _without_sidecars(src, dest):
    path = _copy(src, dest)
    shutil.rmtree(os.path.join(path, ".kart", "columnar"), ignore_errors=True)
    return path


@pytest.fixture(scope="module")
def synth_repos(tmp_path_factory):
    """The spatial synth (kart_tpu's) under each filter, with and without
    its sidecars."""
    base = tmp_path_factory.mktemp("spatialsynth")
    jsynth_repo(str(base / "synth"), SYNTH_N, blobs="changed", seed=5, spatial=True)
    out = {}
    for name, spec in SYNTH_FILTERS.items():
        out[(name, "columnar")] = _copy(base / "synth", base / f"{name}-col")
        out[(name, "tree")] = _without_sidecars(base / "synth", base / f"{name}-tree")
        for path in (out[(name, "columnar")], out[(name, "tree")]):
            _set_filter(path, spec)
    return out


@pytest.fixture()
def prefilter_calls(monkeypatch):
    """Record what the engine's envelope prefilter kept, call by call."""
    calls = []
    real = engine.spatial_prefilter_blocks

    def spy(old_block, new_block, rect, device=None):
        got = real(old_block, new_block, rect, device)
        calls.append(None if got is None else (old_block.count, got[0].count, got[1].count))
        return got

    monkeypatch.setattr(engine, "spatial_prefilter_blocks", spy)
    return calls


@pytest.mark.parametrize("route", ["columnar", "tree"])
@pytest.mark.parametrize("fmt", range(len(FORMATS)), ids=lambda i: "_".join(FORMATS[i][1:]))
@pytest.mark.parametrize("name", sorted(SYNTH_FILTERS))
def test_synth_filtered_diff_matches_kart_tpu(synth_repos, prefilter_calls, name, fmt, route):
    path = synth_repos[(name, route)]
    opts = [*FORMATS[fmt], "HEAD^...HEAD"]
    want = _run_ref(path, opts)
    got = _run_port(path, opts)
    assert got == want
    if route == "columnar":
        # one prefilter for the dataset, whose survivors are a strict
        # subset of its rows
        assert len(prefilter_calls) == 1
        rows, old_kept, new_kept = prefilter_calls[0]
        assert old_kept == new_kept < rows
        assert (old_kept == 0) == (name == "nothing")
    else:
        assert prefilter_calls == []
    if name == "nothing":
        assert got[0] == 0 and '"fid"' not in got[1]
    elif "quiet" not in opts:
        assert got[0] in (0, 1) and got[1].strip()


def test_synth_filter_narrows_the_diff(synth_repos):
    """The filtered json-lines holds fewer features than the unfiltered
    diff and more than none: the comparisons above are not trivial."""
    for name in ("rect", "pentagon", "holed"):
        rc, out = _run_port(synth_repos[(name, "columnar")],
                            ["-o", "json-lines", "HEAD^...HEAD"])
        n = out.count('"type":"feature"')
        assert rc == 0 and 0 < n < SYNTH_N // 100, name


@pytest.fixture(scope="module")
def synth_pair(tmp_path_factory):
    base = tmp_path_factory.mktemp("synthpair")
    with pytest.MonkeyPatch.context() as m:
        m.setenv("GIT_AUTHOR_DATE", DATE)
        m.setenv("GIT_COMMITTER_DATE", DATE)
        _, tinfo = tsynth.synth_repo(str(base / "port"), SYNTH_N, seed=3, blobs="changed",
                                     spatial=True)
        _, jinfo = jsynth_repo(str(base / "ref"), SYNTH_N, seed=3, blobs="changed",
                               spatial=True)
    return base, tinfo, jinfo


def test_spatial_synth_same_commits_and_sidecars(synth_pair):
    base, tinfo, jinfo = synth_pair
    assert tinfo == jinfo and tinfo["n_edits"] == SYNTH_N // 100
    tdir, jdir = (str(base / p / ".kart" / "columnar") for p in ("port", "ref"))
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names and len(names) == 2
    for name in names:
        with open(os.path.join(tdir, name), "rb") as a, open(os.path.join(jdir, name), "rb") as b:
            got, want = a.read(), b.read()
        assert hashlib.sha256(got).hexdigest() == hashlib.sha256(want).hexdigest(), name
        header = want[want.index(b"\n") + 1: want.index(b"\n", want.index(b"\n") + 1)]
        assert b'"geom_bytes"' in header  # the vertex column is in both
    jrepo, tport = JRepo(str(base / "port")), TRepo(str(base / "port"))
    for oid in jrepo.odb.iter_oids():
        assert jrepo.odb.read_raw(oid) == tport.odb.read_raw(oid)


def test_spatial_synth_sidecar_reads_back(synth_pair):
    """The port reads its own spatial sidecars (the vertex column skipped)
    into the envelopes kart_tpu's synth computes."""
    from kart_tpu.synth import synth_envelopes

    base, _tinfo, _jinfo = synth_pair
    trepo = TRepo(str(base / "port"))
    ds = trepo.structure("HEAD").datasets["synth"]
    block = sidecar.load_block(trepo, ds, pad=False)
    assert block.count == SYNTH_N
    assert np.array_equal(np.asarray(block.envelopes),
                          synth_envelopes(np.asarray(block.keys[:block.count])))


def test_spatial_synth_blobs_carry_points(synth_pair):
    base, _tinfo, _jinfo = synth_pair
    out = _run_port(str(base / "port"), ["-o", "json-lines", "HEAD^...HEAD"])[1]
    assert out == _run_ref(str(base / "ref"), ["-o", "json-lines", "HEAD^...HEAD"])[1]
    assert out.count('"geom":"0101000000') == 2 * (SYNTH_N // 100)


def test_spatial_synth_refuses_what_is_not_ported(tmp_path, synth_pair):
    """``spatial=True, blobs="real"`` (which kart_tpu's spatial synth does
    not write): every blob a point at its envelope's south-west corner, the
    same sidecars as the changed layer but for its oids, the edited rows'
    blobs equal to kart_tpu's changed layer's, and the same diff; the
    promised spatial layer is still refused (the name is kept from when the
    real layer was refused too)."""
    from kart_tpu_torch.core.serialise import msg_unpack

    with pytest.raises(ValueError):
        tsynth.synth_repo(str(tmp_path / "p"), 10, blobs="promised", spatial=True)
    base, _tinfo, jinfo = synth_pair
    with pytest.MonkeyPatch.context() as m:
        m.setenv("GIT_AUTHOR_DATE", DATE)
        m.setenv("GIT_COMMITTER_DATE", DATE)
        repo, info = tsynth.synth_repo(str(tmp_path / "real"), SYNTH_N, seed=3, blobs="real",
                                       spatial=True)
    assert info["n_edits"] == jinfo["n_edits"]
    changed = TRepo(str(base / "ref"))
    for rev in ("HEAD^", "HEAD"):
        ds = repo.structure(rev).datasets["synth"]
        block = sidecar.load_block(repo, ds, pad=False)
        ref_block = sidecar.load_block(changed, changed.structure(rev).datasets["synth"],
                                       pad=False)
        assert np.array_equal(np.asarray(block.envelopes), np.asarray(ref_block.envelopes))
        assert np.array_equal(np.asarray(block.keys[:block.count]),
                              np.asarray(ref_block.keys[:ref_block.count]))
        paths, oids = ds.feature_tree.blob_columns()
        env = np.asarray(block.envelopes)
        keys = np.asarray(block.keys[:block.count])
        rows = np.searchsorted(keys, [int(ds.decode_path_to_pks(p)[0]) for p in paths])
        for i in range(0, len(paths), 997):
            _, values = msg_unpack(repo.odb.read_blob(oids[i].tobytes().hex()))
            x0, x1, y0, y1 = values[0].envelope()
            assert (x0, y0) == (float(env[rows[i], 0]), float(env[rows[i], 1]))
    opts = ["-o", "json-lines", "HEAD^...HEAD"]
    assert _run_port(str(tmp_path / "real"), opts) == _run_ref(str(base / "ref"), opts)


# -- imported repos: the tree walk and the columnar route without and with
# -- envelope columns


def _edits_meta_and_outside(repo, ds_path):
    """One commit: a new title and an edit outside every filter."""
    from kart_tpu.diff.structs import DatasetDiff, Delta, DeltaDiff, KeyValue, RepoDiff

    structure = repo.structure("HEAD")
    ds = structure.datasets[ds_path]
    meta = DeltaDiff()
    meta.add_delta(Delta.update(KeyValue(("title", ds.meta_items()["title"])),
                                KeyValue(("title", "a new title"))))
    feature = DeltaDiff()
    old = ds.get_feature([8])
    feature.add_delta(Delta.update(KeyValue((8, old)), KeyValue((8, {**old, "name": "x"}))))
    ds_diff = DatasetDiff()
    ds_diff["meta"] = meta
    ds_diff["feature"] = feature
    repo_diff = RepoDiff()
    repo_diff[ds_path] = ds_diff
    return structure.commit_diff(repo_diff, "meta edit and an edit outside")


def _edits_mixed(repo, ds_path):
    ds = repo.datasets()[ds_path]
    moved = {**ds.get_feature([3]), "geom": Geometry.from_wkt("POINT (150 -20)")}
    moved_in = {**ds.get_feature([9]), "geom": Geometry.from_wkt("POINT (103.5 -40.5)")}
    edit_commit(
        repo, ds_path,
        inserts=[
            {"fid": 100, "geom": Geometry.from_wkt("POINT (160 10)"), "name": "far", "rating": 1.0},
            {"fid": 101, "geom": Geometry.from_wkt("POINT (102.5 -40.0)"), "name": "near",
             "rating": 1.0},
            {"fid": 102, "geom": None, "name": "null geometry", "rating": 2.0},
            {"fid": 103, "geom": Geometry.from_wkt("POINT EMPTY"), "name": "empty",
             "rating": 3.0},
            {"fid": 104, "geom": Geometry.from_wkt("POINT (106 -40)"), "name": "on the edge",
             "rating": 4.0},
            # on the rect's south, west and north edges, and a hair outside
            # the south one: inside the prefilter's padded rect, outside the
            # exact test
            {"fid": 105, "geom": Geometry.from_wkt("POINT (103 -42)"), "name": "south edge",
             "rating": 5.0},
            {"fid": 106, "geom": Geometry.from_wkt("POINT (100 -40.5)"), "name": "west edge",
             "rating": 6.0},
            {"fid": 107, "geom": Geometry.from_wkt("POINT (103 -39)"), "name": "north edge",
             "rating": 7.0},
            {"fid": 108, "geom": Geometry.from_wkt("POINT (103 -42.00005)"), "name": "just out",
             "rating": 8.0},
        ],
        updates=[
            {**ds.get_feature([2]), "name": "edited in"},
            {**ds.get_feature([8]), "name": "edited out"},
            moved,
            moved_in,
            {**ds.get_feature([4]), "geom": None},
        ],
        deletes=[5, 10],
        message="in, out, moved out, moved in, inserts in and out",
    )


def _edits_outside_only(repo, ds_path):
    ds = repo.datasets()[ds_path]
    edit_commit(repo, ds_path, updates=[{**ds.get_feature([8]), "name": "x"}],
                inserts=[{"fid": 100, "geom": Geometry.from_wkt("POINT (160 10)"),
                          "name": "far", "rating": 1.0}],
                deletes=[10], message="out-of-filter edits")


EDITS = {"mixed": _edits_mixed, "outside": _edits_outside_only,
         "meta_outside": _edits_meta_and_outside}


def _envelope_sidecars(path, ds_path):
    """Sidecars with envelope columns for both revisions, written by
    kart_tpu (its importer writes none for a repo this small)."""
    from kart_tpu.diff.sidecar import _feature_envelope_wsen

    repo = JRepo(path)
    for rev in ("HEAD", "HEAD^"):
        ds = repo.structure(rev).datasets[ds_path]
        _paths, pks, oids = ds.feature_index()
        envs = np.asarray([_feature_envelope_wsen(ds.get_feature([int(pk)]), "geom")
                           for pk in pks], dtype=np.float64)
        jsidecar.save_sidecar(repo, ds.feature_tree.oid, pks.astype(np.int64), oids,
                              envelopes=envs)
    return path


def _plain_sidecars(path, ds_path):
    repo = JRepo(path)
    for rev in ("HEAD", "HEAD^"):
        jsidecar.build_sidecar(repo, repo.structure(rev).datasets[ds_path])
    return path


@pytest.fixture(scope="module")
def point_repos(tmp_path_factory):
    """Each edit set on the three routes: tree walk, columnar without
    envelopes, columnar with envelopes."""
    out = {}
    for edits, make in EDITS.items():
        base = tmp_path_factory.mktemp(f"points-{edits}")
        repo, ds_path = make_imported_repo(base, n=12)
        make(repo, ds_path)
        src = str(repo.workdir)
        out[(edits, "tree")] = _without_sidecars(src, base / "tree")
        out[(edits, "plain")] = _plain_sidecars(_without_sidecars(src, base / "plain"), ds_path)
        out[(edits, "envelopes")] = _envelope_sidecars(
            _without_sidecars(src, base / "envelopes"), ds_path)
    for (edits, route), path in out.items():
        trepo = TRepo(path)
        ds = trepo.structure("HEAD").datasets["points"]
        assert sidecar.has_sidecar(trepo, ds) == (route != "tree")
    return out


POINT_CASES = [(e, r, f, v) for e in EDITS for r in ("tree", "plain", "envelopes")
               for f in sorted(POINT_FILTERS) for v in range(len(FORMATS))]


@pytest.mark.parametrize("case", POINT_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{'_'.join(FORMATS[c[3]][1:])}")
def test_points_filtered_diff_matches_kart_tpu(point_repos, prefilter_calls, case):
    edits, route, flt, fmt = case
    path = point_repos[(edits, route)]
    _set_filter(path, POINT_FILTERS[flt])
    opts = [*FORMATS[fmt], "HEAD^...HEAD"]
    want = _run_ref(path, opts)
    got = _run_port(path, opts)
    assert got == want
    if route == "envelopes":
        assert len(prefilter_calls) == 1 and prefilter_calls[0] is not None
    elif route == "plain":
        # no envelope column: the pair falls through to the value filter
        assert prefilter_calls and set(prefilter_calls) == {None}
    else:
        assert prefilter_calls == []
    if "--exit-code" in opts:
        # NULL and empty geometries match every filter; meta changes count
        # whatever the filter
        assert got[0] == (0 if edits == "outside" else 1)


def test_points_mixed_shows_either_side_matches(point_repos):
    """Under the rect: the edit inside, the feature moved out (its old
    side), the one moved in (its new side), the insert inside and those on
    its edges, the NULL and empty geometries and the delete inside; not the
    edit outside, the inserts outside or the delete outside."""
    import json

    path = point_repos[("mixed", "envelopes")]
    _set_filter(path, POINT_FILTERS["rect"])
    rc, out = _run_port(path, ["-o", "json", "HEAD^...HEAD"])
    feats = json.loads(out)["kart.diff/v1+hexwkb"]["points"]["feature"]
    fids = sorted((f.get("+") or f.get("-"))["fid"] for f in feats)
    assert rc == 0 and fids == [2, 3, 4, 5, 9, 101, 102, 103, 104, 105, 106, 107]


def _projected_rect(code):
    """POINT_FILTERS' rect around fids 1..5, its corners moved into
    EPSG:``code`` by kart_tpu."""
    from kart_tpu.crs import Transform, make_crs

    t = Transform(make_crs("EPSG:4326"), make_crs(f"EPSG:{code}"))
    xs, ys = t.transform([100.0, 106.0, 106.0, 100.0, 100.0], [-42.0, -42.0, -39.0, -39.0, -42.0])
    ring = ",".join(f"{float(x)!r} {float(y)!r}" for x, y in zip(xs, ys))
    return f"EPSG:{code};POLYGON(({ring}))"


@pytest.mark.parametrize("code", [2193, 3857])
@pytest.mark.parametrize("route", ["tree", "envelopes"])
def test_projected_filter_crs_is_not_yet_implemented(point_repos, prefilter_calls, code, route):
    """A filter in a projected CRS (one far from the points, one around
    fids 1..5): the port's stdout and exit code equal kart_tpu's for every
    format, on the tree walk and on the envelope prefilter (the name is kept
    from when the port refused such filters)."""
    path = point_repos[("mixed", route)]
    repo = JRepo(path)
    far = f"EPSG:{code};POLYGON((1000 1000,2000 1000,2000 2000,1000 2000,1000 1000))"
    for spec_text in (far, _projected_rect(code)):
        spec = ResolvedSpatialFilterSpec.from_spec_string(spec_text)
        repo.config.set_many(spec.config_items())
        outs = []
        for fmt in FORMATS:
            opts = [*fmt, "HEAD^...HEAD"]
            want = _run_ref(path, opts)
            got = _run_port(path, opts)
            assert got == want, (spec_text, fmt)
            outs.append(got[1])
        assert len(prefilter_calls) == (len(FORMATS) if route == "envelopes" else 0)
        prefilter_calls.clear()
    # around the points, fids 2..5 show where the far filter shows none of them
    assert '"fid":3' in outs[2]


def test_promised_blobs_under_a_filter_are_not_yet_implemented(tmp_path):
    """A filtered repository with a promisor remote (the name is kept from
    when the port refused it): every format's stdout and exit code equal
    kart_tpu's, on the repository with every blob present (nothing to
    fetch) and on a filtered clone of it made by each package, whose
    promised blobs the diff backfills from the promisor."""
    repo, ds_path = make_imported_repo(tmp_path, n=12)
    _edits_mixed(repo, ds_path)
    path = str(repo.workdir)
    spec = ResolvedSpatialFilterSpec.from_spec_string(POINT_FILTERS["rect"])
    for name in ("k", "p"):
        clone = ["clone", "--spatial-filter", POINT_FILTERS["rect"], "--no-checkout", path,
                 str(tmp_path / name)]
        if name == "k":
            assert CliRunner().invoke(kart_cli, clone).exit_code == 0
        else:
            assert port_main(["--device", "cpu", *clone]) == 0
    JRepo(path).config.set_many({**spec.config_items(), "remote.origin.url": "file:///nowhere",
                                 "remote.origin.promisor": "true"})
    for fmt in FORMATS:
        opts = [*fmt, "HEAD^...HEAD"]
        assert _run_port(path, opts) == _run_ref(path, opts), fmt
        want = _run_ref(str(tmp_path / "k"), opts)
        assert _run_port(str(tmp_path / "p"), opts) == want and want[0] in (0, 1), fmt
    # the clones now hold the blobs the diffs needed, and the same ones
    oids = [set(JRepo(str(tmp_path / name)).odb.iter_oids()) for name in ("k", "p")]
    assert oids[0] == oids[1] and oids[0] < set(JRepo(path).odb.iter_oids())
