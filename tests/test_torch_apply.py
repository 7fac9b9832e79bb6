"""``python -m kart_tpu_torch --device cpu -C <repo> apply ...`` against
kart_tpu's ``kart apply``: a patch that the port's ``create-patch`` wrote
(full and minimal) is applied by each package to its own copy of a
repository, onto a branch at the patched commit's parent (``--ref``) and
onto HEAD: the same stdout, stderr and exit code, the same commit oid
(author from the patch header, committer and dates pinned), the patched
commit's tree again, and the same derived sidecar bytes; on int-pk,
hash-keyed, spatial and V2 repositories, for feature edits, a meta edit
and a new dataset. Refusals give kart_tpu's code and ``Error:`` line
(kart_tpu's CLI entry point turns an ``InvalidOperation`` into exit 20 and
a ``NotFound`` into 40): ``--ref`` to a tag, a remote-tracking ref or a
missing branch, ``--no-commit`` with ``--ref`` or without a working copy,
an empty patch without ``--allow-empty``, and every ``PatchApplyError``.
Where kart_tpu would update a working copy, the port exits 30 and writes
nothing."""

import contextlib
import io
import json
import os
import shutil

import pytest
from click.testing import CliRunner

from helpers import create_points_gpkg, make_repo_with_edits
from kart_tpu.cli import cli as kart_cli
from kart_tpu.core.repo import KartRepo as JRepo
from kart_tpu.core.repo import NotFound as JNotFound
from kart_tpu.core.repo import RepoError as JRepoError
from kart_tpu_torch.cli import main as port_main
from kart_tpu_torch.core.repo import KartRepo as TRepo
from kart_tpu_torch.synth import commit_point_edits, synth_repo, v2_repo

DATE = "1700000000 +0000"


@pytest.fixture(autouse=True)
def _pinned_dates(monkeypatch):
    monkeypatch.setenv("GIT_AUTHOR_DATE", DATE)
    monkeypatch.setenv("GIT_COMMITTER_DATE", DATE)


def _kart(argv):
    """kart_tpu's CLI as its entry point runs it: a RepoError becomes
    ``Error: <message>`` and exit 40 (NotFound) or 20. -> (code, stdout,
    stderr)."""
    r = CliRunner().invoke(kart_cli, argv, prog_name="kart")
    exc = r.exception
    if exc is None or isinstance(exc, SystemExit):
        return r.exit_code, r.stdout, r.stderr
    if isinstance(exc, JRepoError):
        return (40 if isinstance(exc, JNotFound) else 20), r.stdout, r.stderr + f"Error: {exc}\n"
    raise exc


def _port(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_main(argv)
    return rc, out.getvalue(), err.getvalue()


def _snapshot(path):
    """Every file under the gitdir, by relative path, with its bytes."""
    gitdir = os.path.join(path, ".kart")
    out = {}
    for d, _, names in os.walk(gitdir):
        for n in names:
            full = os.path.join(d, n)
            with open(full, "rb") as f:
                out[os.path.relpath(full, gitdir)] = f.read()
    return out


def _second_dataset_commit(base):
    """An imported layer, then a commit importing a second one. -> path."""
    from kart_tpu.importer import ImportSource
    from kart_tpu.importer.importer import import_sources

    path, _ = make_repo_with_edits(base, n=20)
    repo = JRepo(path)
    import_sources(repo, ImportSource.open(create_points_gpkg(str(base / "second.gpkg"), n=4,
                                                              table="second")))
    return path


def _meta_commit(base):
    """An imported layer, then a commit changing its title and description."""
    path, _ = make_repo_with_edits(base, n=20)
    for argv in (["meta", "set", "points", "title=Retitled", "description=Described",
                  "-m", "retitle"],):
        assert _kart(["-C", path, *argv])[0] == 0
    return path


def _point_layer(base):
    """The port's point layer with every blob, then moves, inserts and
    deletes (real blobs) in a further commit."""
    import numpy as np

    repo, _ = synth_repo(str(base / "points"), 300, seed=2, blobs="real", spatial=True)
    pks = (1 << 24) + np.arange(300)
    commit_point_edits(repo, moves=(pks[[3, 50, 299]], np.array([-180.0, 12.5, 179.99999]),
                                    np.array([90.0, -33.0, 0.0])),
                       inserts=(np.array([(1 << 24) + 400]), np.array([1.0]), np.array([2.0])),
                       deletes=pks[[7, 8]], message="move points")
    return repo.workdir


BASES = {
    "int": lambda base: make_repo_with_edits(base, n=40)[0],
    "text": lambda base: synth_repo(str(base / "text"), 150, seed=4, blobs="real",
                                    pk="text")[0].workdir,
    "points": _point_layer,
    "v2": lambda base: v2_repo(str(base / "v2"), n=6, spatial=True)[0].workdir,
    "new-dataset": _second_dataset_commit,
    "meta": _meta_commit,
}


@pytest.fixture(scope="module")
def bases(tmp_path_factory):
    out = {}
    for name, build in BASES.items():
        base = tmp_path_factory.mktemp(f"apply-{name}")
        old = {k: os.environ.get(k) for k in ("GIT_AUTHOR_DATE", "GIT_COMMITTER_DATE")}
        os.environ.update(GIT_AUTHOR_DATE=DATE, GIT_COMMITTER_DATE=DATE)
        try:
            out[name] = str(build(base))
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return out


def _setup(src, tmp_path, patch_type="full", onto="ref"):
    """Write the port's patch of HEAD, put branch ``w`` at HEAD^ (checked
    out for ``onto="head"``), drop the sidecars of HEAD's feature trees, and
    copy the result for each package. -> (kart_tpu's copy, the port's
    copy, the patch file)."""
    setup = shutil.copytree(src, str(tmp_path / "setup"))
    rc, patch, err = _port(["--device", "cpu", "-C", setup, "create-patch",
                            "--patch-type", patch_type, "HEAD"])
    assert rc == 0, err
    patch_file = str(tmp_path / "patch.json")
    with open(patch_file, "w") as f:
        f.write(patch)
    repo = TRepo(setup)
    head = repo.structure("HEAD")
    for ds in head.datasets:
        f = os.path.join(setup, ".kart", "columnar", ds.feature_tree.oid + ".kcol")
        if os.path.exists(f):
            os.remove(f)
    repo.refs.set("refs/heads/w", repo.resolve_refish("HEAD^")[0])
    if onto == "head":
        repo.refs.set_head("refs/heads/w")
    kpath, ppath = str(tmp_path / "k"), str(tmp_path / "p")
    shutil.copytree(setup, kpath)
    shutil.copytree(setup, ppath)
    return kpath, ppath, patch_file, head.tree_oid


def _compare(kpath, ppath, argv):
    """One command in both packages -> its (code, stdout, stderr), equal."""
    ref = _kart(["-C", kpath, *argv])
    got = _port(["--device", "cpu", "-C", ppath, *argv])
    assert got == ref, (argv, ref, got)
    return got


def _sidecars(path):
    d = os.path.join(path, ".kart", "columnar")
    out = {}
    for name in sorted(os.listdir(d)) if os.path.isdir(d) else []:
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("onto", ["ref", "head"])
@pytest.mark.parametrize("patch_type", ["full", "minimal"])
@pytest.mark.parametrize("base", list(BASES))
def test_create_patch_apply_round_trip(bases, tmp_path, base, patch_type, onto):
    """The patch of HEAD applied at HEAD^: kart_tpu's outputs and commit
    oid, HEAD's tree again, and the same sidecars (the derived one with
    its envelope and vertex columns where the parent has them)."""
    kpath, ppath, patch, tree = _setup(bases[base], tmp_path, patch_type, onto)
    argv = ["apply", *(["--ref", "w"] if onto == "ref" else []), patch]
    rc, out, _ = _compare(kpath, ppath, argv)
    assert rc == 0 and out.startswith("Commit ")
    krepo, prepo = JRepo(kpath), TRepo(ppath)
    oid = prepo.resolve_refish("w")[0]
    assert oid == krepo.resolve_refish("w")[0] and out == f"Commit {oid[:7]}\n"
    assert prepo.odb.read_commit(oid).tree == tree
    assert _sidecars(ppath) == _sidecars(kpath)
    if base == "points":
        ds = prepo.structure("w").datasets.paths()[0]
        f = os.path.join(ppath, ".kart", "columnar",
                         prepo.structure("w").datasets[ds].feature_tree.oid + ".kcol")
        assert os.path.exists(f)  # derived by the commit
    assert _snapshot(ppath).keys() == _snapshot(kpath).keys()


def test_author_comes_from_the_patch_header(bases, tmp_path):
    """The applied commit's author is the patch's, its committer the
    environment's."""
    kpath, ppath, patch, _ = _setup(bases["int"], tmp_path)
    with open(patch) as f:
        doc = json.load(f)
    doc["kart.patch/v1"].update(authorName="Pat Author", authorEmail="pat@example.com",
                                authorTime="2021-03-04T05:06:07Z", authorTimeOffset="-05:30",
                                message="patched\n\nwith a body")
    for variant, header in (("offset", {}), ("no-colon", {"authorTimeOffset": "+0930"}),
                            ("bad-time", {"authorTime": "yesterday"}),
                            ("no-name", {"authorName": ""}), ("no-message", {"message": ""})):
        for path in (kpath, ppath):
            TRepo(path).refs.set("refs/heads/w", TRepo(path).resolve_refish("HEAD^")[0])
        name = str(tmp_path / f"{variant}.json")
        with open(name, "w") as f:
            json.dump({**doc, "kart.patch/v1": {**doc["kart.patch/v1"], **header}}, f)
        _compare(kpath, ppath, ["apply", "--ref", "w", name])
        assert JRepo(kpath).resolve_refish("w") == TRepo(ppath).resolve_refish("w")
    commit = TRepo(ppath).resolve_commit("w")
    assert commit.author.name == "Pat Author" and commit.message == "Apply patch\n"


@pytest.mark.parametrize("argv", [
    ["--ref", "refs/tags/v1"],
    ["--ref", "refs/remotes/origin/main"],
    ["--ref", "nosuch"],
    ["--ref", "refs/heads/nosuch"],
    ["--ref", "w", "--no-commit"],
    ["--no-commit"],
    ["--ref", "main"],
    ["--ref", "refs/heads/main"],
])
def test_ref_rules(bases, tmp_path, argv):
    """--ref names a branch: a tag, a remote-tracking ref or a missing
    branch is refused, as is --no-commit with --ref or without a working
    copy; the checked-out branch named is HEAD."""
    kpath, ppath, patch, _ = _setup(bases["int"], tmp_path)
    for path in (kpath, ppath):
        repo = TRepo(path)
        repo.refs.set("refs/tags/v1", repo.resolve_refish("HEAD^")[0])
        repo.refs.set("refs/remotes/origin/main", repo.resolve_refish("HEAD^")[0])
        repo.refs.set("refs/heads/main", repo.resolve_refish("HEAD^")[0])
    before = _snapshot(ppath)
    rc, _, _ = _compare(kpath, ppath, ["apply", *argv, patch])
    if rc:
        assert _snapshot(ppath) == before
    assert _snapshot(ppath).keys() == _snapshot(kpath).keys()


def _write_patch(tmp_path, doc, name="crafted.json"):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def test_allow_empty(bases, tmp_path):
    """A patch that changes nothing: kart_tpu's "No changes to commit"
    error without --allow-empty, an empty commit with it."""
    kpath, ppath, _, _ = _setup(bases["int"], tmp_path)
    empty = _write_patch(tmp_path, {"kart.diff/v1+hexwkb": {}})
    assert _compare(kpath, ppath, ["apply", empty])[0] == 20
    assert _compare(kpath, ppath, ["apply", "--allow-empty", empty])[0] == 0
    assert JRepo(kpath).head_commit_oid == TRepo(ppath).head_commit_oid


def _patch_of(path, rev="HEAD"):
    rc, out, err = _port(["--device", "cpu", "-C", path, "create-patch", rev])
    assert rc == 0, err
    return json.loads(out)


def _crafted(doc, schema):
    """Patches that must not apply to the int repository's HEAD (whose
    schema is ``schema``), by name."""
    feats = doc["kart.diff/v1+hexwkb"]["points"]["feature"]
    update = next(f for f in feats if "-" in f and "+" in f)
    insert = next(f for f in feats if "-" not in f)
    stale = {**update, "-": {**update["-"], "name": "not the old name"}}
    existing = {"+": {**update["+"], "name": "dup"}}
    header = doc.get("kart.patch/v1", {})

    def patch(ds, part, body, **top):
        return {**top, "kart.diff/v1+hexwkb": {ds: {part: body}}}

    return {
        "not-a-patch": {"hello": 1},
        "minimal-unknown-dataset": patch("nosuch", "meta", {"title": {"*": "x"}}),
        "features-unknown-dataset": patch("nosuch", "feature", [insert]),
        "unknown-dataset-meta": patch("nosuch", "meta", {"title": {"+": "x"}}),
        "minimal-no-base": patch("points", "feature", [{"*": update["+"]}]),
        "minimal-missing-base": patch("points", "feature", [{"*": update["+"]}],
                                      **{"kart.patch/v1": {"base": "ab" * 20}}),
        "stale-old-value": patch("points", "feature", [stale]),
        "insert-exists": patch("points", "feature", [existing]),
        "reapplied": doc,
        "stale-meta": patch("points", "meta", {"title": {"-": "old?", "+": "x"}}),
        "schema-delete": patch("points", "meta", {"schema.json": {"-": schema}}),
        "header-only": {"kart.patch/v1": header, "kart.diff/v1+hexwkb": {}},
    }


@pytest.mark.parametrize("case", ["not-a-patch", "minimal-unknown-dataset",
                                  "features-unknown-dataset", "unknown-dataset-meta",
                                  "minimal-no-base", "minimal-missing-base", "stale-old-value",
                                  "insert-exists", "reapplied", "stale-meta", "schema-delete",
                                  "header-only"])
def test_patch_apply_errors(bases, tmp_path, case):
    """Each way a patch fails to apply to HEAD: kart_tpu's exit code and
    ``Error:`` text, and nothing changed."""
    kpath, ppath, _, _ = _setup(bases["int"], tmp_path)
    schema = TRepo(ppath).structure("HEAD").datasets["points"].get_meta_item("schema.json")
    patch = _write_patch(tmp_path, _crafted(_patch_of(ppath), schema)[case])
    before = _snapshot(ppath)
    rc, _, err = _compare(kpath, ppath, ["apply", patch])
    assert rc == 20 and err.startswith("Error: ")
    assert _snapshot(ppath) == before


def test_invalid_json_raises_as_in_kart_tpu(bases, tmp_path):
    kpath, ppath, _, _ = _setup(bases["int"], tmp_path)
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        f.write("{not json")
    r = CliRunner().invoke(kart_cli, ["-C", kpath, "apply", bad])
    assert isinstance(r.exception, json.JSONDecodeError)
    with pytest.raises(json.JSONDecodeError):
        _port(["--device", "cpu", "-C", ppath, "apply", bad])


@pytest.mark.parametrize("argv", [
    ["apply"], ["apply", "nosuch.json"], ["apply", "."], ["apply", "--nosuch", "x"],
    ["apply", "--ref"], ["apply", "a", "b"], ["apply", "--no-commit=1", "x"],
])
def test_usage_errors(bases, tmp_path, argv):
    """Usage errors: click's text on stderr, exit 2."""
    path = bases["int"]
    ref = _kart(["-C", path, *argv])
    got = _port(["--device", "cpu", "-C", path, *argv])
    assert got == ref and got[0] == 2


def test_help_is_click_s(bases):
    path = bases["int"]
    assert _port(["--device", "cpu", "-C", path, "apply", "--help"]) == \
        _kart(["-C", path, "apply", "--help"])


@pytest.mark.parametrize("argv,code", [
    (["apply"], 0),
    (["apply", "--no-commit"], 0),
    (["apply", "--ref", "w"], 0),
    (["apply", "--ref", "other"], 0),
])
def test_working_copy(bases, tmp_path, argv, code):
    """With a GPKG working copy of branch ``w`` (written by kart_tpu in
    both copies): applied onto HEAD (``w`` named too) the port commits and
    moves the copy to the commit, ``--no-commit`` writes the patch into the
    copy as tracked edits, onto another branch the copy stays; kart_tpu's
    outputs and exit code, and the same rows in every table of the copy."""
    from test_torch_workingcopy import wc_tables

    kpath, ppath, patch, _ = _setup(bases["int"], tmp_path, onto="head")
    for path in (kpath, ppath):
        repo = TRepo(path)
        repo.refs.set("refs/heads/other", repo.resolve_refish("HEAD")[0])
        r = CliRunner().invoke(kart_cli, ["-C", path, "create-workingcopy"])
        assert r.exit_code == 0, r.output
    assert _compare(kpath, ppath, [*argv, patch])[0] == code
    assert wc_tables(os.path.join(ppath, "p.gpkg")) == wc_tables(os.path.join(kpath, "k.gpkg"))
    assert JRepo(kpath).resolve_refish("other") == TRepo(ppath).resolve_refish("other")
    assert JRepo(kpath).head_commit_oid == TRepo(ppath).head_commit_oid
    for status in (["status"], ["diff", "-o", "json"]):
        _compare(kpath, ppath, status)
