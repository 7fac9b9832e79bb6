"""Apply JSON patches: ``kart apply``.

A patch is the JSON diff document (``kart.diff/v1+hexwkb``) that ``kart
create-patch`` writes, with its ``kart.patch/v1`` header (the original
commit's message, author and base). A minimal patch's ``*`` deltas carry
no old value: it is read from the ``base`` commit the header names.

Counterpart of kart_tpu's ``apply.py``: ``parse_patch`` and
``apply_patch`` with the same ``--ref`` rules, author signature,
``--allow-empty`` and messages; the commit goes through
:meth:`~kart_tpu_torch.core.structure.RepoStructure.commit_diff`, so it
derives the changed datasets' sidecars. A patch applied to HEAD moves the
working copy to the new commit (a forced reset); ``--no-commit`` writes the
patch's feature changes into the working copy as tracked edits instead of
committing them.
"""

import re
from datetime import datetime, timezone

from kart_tpu_torch.core.objects import Signature
from kart_tpu_torch.core.repo import InvalidOperation, NotFound
from kart_tpu_torch.core.structure import PatchApplyError
from kart_tpu_torch.diff.structs import DatasetDiff, Delta, DeltaDiff, KeyValue, RepoDiff
from kart_tpu_torch.geometry import Geometry
from kart_tpu_torch.models.schema import Schema
from kart_tpu_torch.workingcopy import get_working_copy


def _feature_from_json(feature_json, schema):
    out = {}
    for col in schema.columns:
        value = feature_json.get(col.name)
        if value is not None and col.data_type == "geometry":
            value = Geometry.from_hex_wkb(value)
        elif value is not None and col.data_type == "blob":
            value = bytes.fromhex(value)
        out[col.name] = value
    return out


def _pk_of(feature_json, schema):
    pks = tuple(feature_json[c.name] for c in schema.pk_columns)
    return pks[0] if len(pks) == 1 else pks


def parse_patch(repo, patch_json, ref="HEAD"):
    """-> (RepoDiff, header dict), parsed against revision ``ref``."""
    try:
        diff_json = patch_json["kart.diff/v1+hexwkb"]
    except KeyError:
        raise PatchApplyError(
            "Patch is missing the 'kart.diff/v1+hexwkb' key — is this a Kart patch?")
    header = patch_json.get("kart.patch/v1", {})
    base_rs = None
    if header.get("base"):
        try:
            base_rs = repo.structure(header["base"])
        except NotFound:
            base_rs = None

    head_rs = repo.structure(ref) if not repo.head_is_unborn else None
    repo_diff = RepoDiff()
    for ds_path, ds_json in diff_json.items():
        ds_diff = DatasetDiff()
        ds = head_rs.datasets.get(ds_path) if head_rs is not None else None

        meta_json = ds_json.get("meta", {})
        if meta_json:
            meta_diff = DeltaDiff()
            for name, change in meta_json.items():
                if "*" in change:
                    if ds is None:
                        raise PatchApplyError(f"Minimal patch for unknown dataset {ds_path!r}")
                    change = {"-": ds.meta_items().get(name), "+": change["*"]}
                old = KeyValue((name, change["-"])) if change.get("-") is not None else None
                new = KeyValue((name, change["+"])) if change.get("+") is not None else None
                meta_diff.add_delta(Delta(old, new))
            ds_diff["meta"] = meta_diff

        if "schema.json" in meta_json and meta_json["schema.json"].get("+"):
            schema = Schema.from_column_dicts(meta_json["schema.json"]["+"])
        elif ds is not None:
            schema = ds.schema
        else:
            raise PatchApplyError(
                f"Patch contains features for unknown dataset {ds_path!r} and no schema")
        old_schema = ds.schema if ds is not None else schema

        features_json = ds_json.get("feature", [])
        if features_json:
            feature_diff = DeltaDiff()
            for change in features_json:
                minus, plus, star = change.get("-"), change.get("+"), change.get("*")
                if star is not None:
                    new_feature = _feature_from_json(star, schema)
                    pk = _pk_of(star, schema)
                    base_ds = base_rs.datasets.get(ds_path) if base_rs else None
                    if base_ds is None:
                        raise PatchApplyError(
                            "Minimal patch requires its base commit "
                            f"({header.get('base', 'unknown')}) to be present")
                    old_feature = base_ds.get_feature(
                        base_ds.schema.sanitise_pks(pk if isinstance(pk, tuple) else [pk]))
                    feature_diff.add_delta(
                        Delta.update(KeyValue((pk, old_feature)), KeyValue((pk, new_feature))))
                    continue
                old = new = None
                if minus is not None:
                    old = KeyValue((_pk_of(minus, old_schema),
                                    _feature_from_json(minus, old_schema)))
                if plus is not None:
                    new = KeyValue((_pk_of(plus, schema), _feature_from_json(plus, schema)))
                feature_diff.add_delta(Delta(old, new))
            ds_diff["feature"] = feature_diff
        repo_diff[ds_path] = ds_diff
    return repo_diff, header


def _author_from_header(header):
    """The patch header's author as a Signature, or None (no name, or no
    readable ``authorTime``)."""
    if not header.get("authorName"):
        return None
    ts, offset = 0, 0
    when = header.get("authorTime")
    if when:
        try:
            ts = int(datetime.strptime(when, "%Y-%m-%dT%H:%M:%SZ")
                     .replace(tzinfo=timezone.utc).timestamp())
        except ValueError:
            ts = 0
    off_text = header.get("authorTimeOffset")
    if off_text:
        m = re.fullmatch(r"([+-])(\d{2}):?(\d{2})", off_text)
        if m:
            offset = int(m.group(2)) * 60 + int(m.group(3))
            if m.group(1) == "-":
                offset = -offset
    if not ts:
        return None
    return Signature(header["authorName"], header.get("authorEmail", ""), ts, offset)


def apply_patch(repo, patch_json, *, no_commit=False, allow_empty=False, ref="HEAD",
                device=None):
    """Commit a patch onto ``ref`` (HEAD, or a branch) -> the new commit
    oid, or None with ``no_commit`` (the patch went into the working copy).
    The commit carries the patch's message and author."""
    if ref != "HEAD":
        if no_commit:
            raise InvalidOperation("--no-commit and --ref are incompatible")
        if not ref.startswith("refs/"):
            ref = f"refs/heads/{ref}"
        if not ref.startswith("refs/heads/"):
            raise InvalidOperation(f"--ref must name a branch, not {ref!r}")
        if not repo.refs.exists(ref):
            raise NotFound(f"No such ref: {ref}")
        if ref == repo.refs.head_branch():
            ref = "HEAD"
    repo_diff, header = parse_patch(repo, patch_json, ref=ref)
    head_rs = repo.structure(ref)
    wc = get_working_copy(repo, device=device) if ref == "HEAD" else None
    if wc is not None:
        wc.assert_db_tree_match(head_rs.tree_oid)
    if no_commit:
        if wc is None:
            raise InvalidOperation("--no-commit requires a working copy")
        with wc.session() as con:
            for ds_path, ds_diff in repo_diff.items():
                ds = head_rs.datasets.get(ds_path)
                if ds is None:
                    raise PatchApplyError("Cannot apply new-dataset patch to working copy only")
                wc._apply_feature_diff_sql(con, ds, ds_diff.get("feature", DeltaDiff()),
                                           track_changes_as_dirty=True)
        return None
    message = header.get("message") or "Apply patch"
    commit_oid = head_rs.commit_diff(repo_diff, message, allow_empty=allow_empty,
                                     author=_author_from_header(header), ref=ref)
    if wc is not None:
        wc.reset(repo.structure(commit_oid), force=True)
    return commit_oid
