"""Diff writers for every ``kart diff`` format: ``-o text`` (the
default), ``json``, ``json-lines``, ``geojson``, ``html``, ``quiet`` and
``feature-count``.

A writer is built from a commit spec (``A..B`` or ``A...B``; ``A^?`` is A's
first parent or the empty revision; ``A`` alone or nothing diffs A, or HEAD,
against the working copy's edits), streams the diff in its format and
reports ``has_changes`` for the exit code. Values stay lazy until each
delta is written; every writer passes ``device`` to the engine, whose
columnar route runs kernel K1 there. ``target_crs`` (``--crs``) reprojects
geometries; ``commit`` (``kart show``, ``kart create-patch``) adds the
commit header, and ``patch_type``/``include_patch_header`` make the JSON
writer write a patch.

Counterpart of kart_tpu's ``diff/writers.py``: ``BaseDiffWriter``
(``parse_diff_commit_spec``, ``iter_deltas``, ``get_geometry_transforms``,
``write_warnings_footer`` with the working copy's spatial-filter pk conflicts,
``commit_header_json``), ``TextDiffWriter``, ``JsonDiffWriter``,
``JsonLinesDiffWriter`` (the delta route and the fused columnar row route,
single process), ``GeojsonDiffWriter``, ``QuietDiffWriter``,
``FeatureCountDiffWriter`` and ``HtmlDiffWriter``, with the repo's spatial
filter: the engine prefilters sidecar block pairs by envelope (kernel K2),
and ``iter_deltas`` streams only the deltas one of whose sides matches the
filter (the exact per-value residue); the exit code follows what is
written, not the unfiltered diff. A working-copy diff takes the delta route
(no fused rows, no counts-only K1). kart_tpu colours text on a terminal
only; these writers print its plain form. On a partial clone (a
repository with a promisor remote) the deltas whose values are promised
blobs are held back while the rest stream, their blobs are fetched from the
promisor in one batch, and then they are filtered and written; such a
repository keeps the delta route. Not ported: the forked materialisers.
Every refusal comes before any output.
"""

import itertools
import json
import os
import re
import sys
from datetime import datetime, timedelta, timezone

from kart_tpu_torch.core.odb import ObjectMissing, ObjectPromised
from kart_tpu_torch.core.repo import InvalidOperation, NotFound
from kart_tpu_torch.diff.engine import (
    get_dataset_diff,
    get_dataset_feature_count_fast,
    get_feature_diff_rows,
    get_meta_diff,
    get_repo_diff,
)
from kart_tpu_torch.diff.key_filters import RepoKeyFilter
from kart_tpu_torch.diff.output import (
    dump_json_output,
    feature_as_geojson,
    feature_as_json,
    feature_as_text,
    feature_field_as_text,
    format_wkt_for_output,
    geometry_transform_for_dataset,
    resolve_output_path,
)
from kart_tpu_torch.models.dataset import FeatureOidPromise
from kart_tpu_torch.models.schema import Schema
from kart_tpu_torch.ops.blocks import unpack_oid_bytes
from kart_tpu_torch.spatial_filter import MatchResult, SpatialFilter

#: every output format of ``kart diff``
OUTPUT_FORMATS = ["text", "json", "geojson", "json-lines", "quiet", "feature-count", "html"]

_NULL = object()


class DiffUsageError(ValueError):
    """A writer refuses its arguments (kart_tpu's usage error, exit 2)."""


def _chunked(items, size):
    chunk = []
    for item in items:
        chunk.append(item)
        if len(chunk) == size:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


def _promised_value_oids(delta):
    """Force both sides of a delta (every writer prints them anyway); ->
    the oids of the promised blobs among them."""
    oids = []
    for kv in (delta.old, delta.new):
        if kv is None:
            continue
        try:
            kv.get_lazy_value()
        except ObjectPromised as e:
            oids.append(e.oid)
    return oids


class BaseDiffWriter:
    #: rows per blob prefetch / materialisation chunk
    PREFETCH_CHUNK = 8192

    @classmethod
    def get_diff_writer_class(cls, output_format):
        writers = {
            "text": TextDiffWriter,
            "json": JsonDiffWriter,
            "json-lines": JsonLinesDiffWriter,
            "geojson": GeojsonDiffWriter,
            "quiet": QuietDiffWriter,
            "feature-count": FeatureCountDiffWriter,
            "html": HtmlDiffWriter,
        }
        if output_format not in writers:
            raise DiffUsageError(f"Unknown output format: {output_format!r} (expected one of "
                                 f"{', '.join(writers)})")
        return writers[output_format]

    def __init__(self, repo, commit_spec="HEAD", user_key_filters=(), output_path="-", *,
                 json_style="pretty", device=None, target_crs=None, commit=None,
                 patch_type="full", include_patch_header=False):
        self.repo = repo
        self.commit_spec = commit_spec
        self.output_path = output_path
        self.json_style = json_style
        self.device = device
        self.target_crs = target_crs
        self.commit = commit
        self.patch_type = patch_type
        self.include_patch_header = include_patch_header
        self.repo_key_filter = RepoKeyFilter.build_from_user_patterns(user_key_filters)
        self.base_rs, self.target_rs, self.working_copy = self.parse_diff_commit_spec(
            repo, commit_spec)
        self.has_changes = False
        self.spatial_filter_pk_conflicts = {}
        # the repo's spatial filter: diffs show only the deltas that match it
        self.spatial_filter_spec = repo.spatial_filter_spec()
        self._ds_sf_cache = {}
        if self.spatial_filter_spec is not None:
            # resolve every dataset's filter before any output: a CRS that
            # the port cannot transform yet raises here
            for ds_path in self.all_ds_paths:
                self._ds_spatial_filter(ds_path)
        # --crs: every dataset's transforms before any output (a target the
        # port cannot transform yet raises here)
        self._transforms = {}
        if target_crs is not None:
            for ds_path in self.all_ds_paths:
                self.get_geometry_transforms(ds_path)

    @classmethod
    def parse_diff_commit_spec(cls, repo, commit_spec):
        """'A..B', 'A...B', 'A' or '' -> (base_rs, target_rs, working_copy).
        ``A..B`` diffs from merge-base(A, B), as git log reads it; 'A' (and
        '', HEAD) diffs A against the working copy, which must hold HEAD's
        tree."""
        parts = re.split(r"(\.{2,3})", commit_spec or "HEAD")
        if len(parts) == 3:
            base_rs = repo.structure(parts[0] or "HEAD")
            target_rs = repo.structure(parts[2] or "HEAD")
            if parts[1] == "..":
                ancestor = repo.merge_base(base_rs.commit_oid, target_rs.commit_oid)
                if ancestor is None:
                    raise InvalidOperation("No common ancestor found — try the ... operator")
                base_rs = repo.structure(ancestor)
            return base_rs, target_rs, None
        base_rs = repo.structure(parts[0] or "HEAD")
        target_rs = repo.structure("HEAD")
        working_copy = repo.working_copy
        if working_copy is None:
            raise NotFound("No working copy — diff between commits requires two revisions "
                           "(eg HEAD^...HEAD)")
        working_copy.assert_db_tree_match(target_rs.tree_oid)
        return base_rs, target_rs, working_copy

    @property
    def all_ds_paths(self):
        paths = set(self.base_rs.datasets.paths()) | set(self.target_rs.datasets.paths())
        if not self.repo_key_filter.match_all:
            paths &= set(self.repo_key_filter.ds_paths())
        return sorted(paths)

    def get_repo_diff(self):
        return get_repo_diff(self.base_rs, self.target_rs,
                             repo_key_filter=self.repo_key_filter, device=self.device,
                             spatial_filter_spec=self.spatial_filter_spec,
                             include_wc_diff=self.working_copy is not None,
                             working_copy=self.working_copy)

    def get_ds_diff(self, ds_path):
        return get_dataset_diff(self.base_rs, self.target_rs, ds_path,
                                ds_filter=self.repo_key_filter[ds_path], device=self.device,
                                spatial_filter_spec=self.spatial_filter_spec,
                                include_wc_diff=self.working_copy is not None,
                                working_copy=self.working_copy)

    def write_warnings_footer(self):
        """On stderr, the working copy's inserted rows whose pks features
        outside the spatial filter hold (a commit would overwrite them)."""
        if self.working_copy is not None:
            for ds_path, pks in self.working_copy.spatial_filter_pk_conflicts.items():
                if pks:
                    existing = self.spatial_filter_pk_conflicts.setdefault(ds_path, [])
                    existing.extend(pk for pk in pks if pk not in existing)
        conflicts = self.spatial_filter_pk_conflicts
        if not any(conflicts.values()):
            return
        print("Warning: Some primary keys of newly-inserted features in the working copy "
              "conflict with features outside the spatial filter - if committed, they would "
              "overwrite those features.", file=sys.stderr)
        for ds_path, pks in conflicts.items():
            if pks:
                shown = ", ".join(str(pk) for pk in pks[:50])
                more = f", (... {len(pks) - 50} more)" if len(pks) > 50 else ""
                print(f"  In dataset {ds_path} the conflicting primary key values are: "
                      f"{shown}{more}", file=sys.stderr)

    def _ds_spatial_filter(self, ds_path):
        """The dataset's SpatialFilter (the filter in the dataset's CRS), or
        None when no filter is active or the dataset has no geometry."""
        if self.spatial_filter_spec is None or ds_path is None:
            return None
        if ds_path not in self._ds_sf_cache:
            ds = None
            for rs in (self.target_rs, self.base_rs):
                ds = rs.datasets.get(ds_path)
                if ds is not None:
                    break
            sf = self.spatial_filter_spec.resolve_for_dataset(ds) if ds is not None else None
            self._ds_sf_cache[ds_path] = None if sf is SpatialFilter.MATCH_ALL else sf
        return self._ds_sf_cache[ds_path]

    @staticmethod
    def _delta_matches_filter(delta, sf):
        """True when either side of the delta matches the spatial filter. A
        side whose blob is absent cannot be tested: it fails open."""
        for kv in (delta.old, delta.new):
            if kv is None:
                continue
            try:
                feature = kv.get_lazy_value()
            except ObjectMissing:
                return True
            if sf.match_result(feature) is MatchResult.MATCHED:
                return True
        return False

    def _mark_ds_changes(self, ds_diff):
        """``has_changes`` for one dataset. Under a spatial filter feature
        changes count only when a delta streams (``iter_deltas`` marks
        that); meta changes always count."""
        if self.spatial_filter_spec is None:
            if ds_diff:
                self.has_changes = True
        elif ds_diff.get("meta"):
            self.has_changes = True

    def iter_deltas(self, ds_diff, ds_path=None):
        """Stream (key, delta) in key order, the blob data of each chunk's
        lazy values read in one batch; under a spatial filter (pass
        ``ds_path``), only the deltas that match it. On a partial clone the
        deltas with a promised value are held back, their blobs fetched
        from the promisor remote in one batch after the rest, and then
        yielded (kart_tpu's order)."""
        feature_diff = ds_diff.get("feature")
        if not feature_diff:
            return
        sf = self._ds_spatial_filter(ds_path)
        promisor = self.repo.has_promisor_remote()
        buffered, missing = [], []
        for key, delta in self._iter_prefetched(feature_diff.sorted_items()):
            if promisor:
                oids = _promised_value_oids(delta)
                if oids:
                    buffered.append((key, delta))
                    missing.extend(oids)
                    continue
            if sf is None or self._delta_matches_filter(delta, sf):
                self.has_changes = True
                yield key, delta
        if buffered:
            from kart_tpu_torch.transport.remote import fetch_promised_blobs

            fetch_promised_blobs(self.repo, missing)
            for key, delta in buffered:
                if sf is None or self._delta_matches_filter(delta, sf):
                    self.has_changes = True
                    yield key, delta

    def _iter_prefetched(self, items):
        """(key, delta) pairs, the blob data of each chunk's unforced lazy
        values read in one batch (what the batch cannot serve is read one
        by one when forced)."""
        for chunk in _chunked(items, self.PREFETCH_CHUNK):
            promises = [
                kv[1] for _, delta in chunk for kv in (delta.old, delta.new)
                if kv is not None and kv.value_is_lazy and isinstance(kv[1], FeatureOidPromise)
                and kv[1].data is None
            ]
            if promises:
                got = promises[0].ds._feature_odb().read_blobs_batch(
                    [p.oid_hex for p in promises])
                for p in promises:
                    p.data = got.get(p.oid_hex)
            yield from chunk

    @staticmethod
    def _feature_json_fast(kv, tx=None):
        """JSON-ready dict of one delta side, decoded straight from
        prefetched blob data when there is some and no reprojection."""
        v = kv[1]
        if (tx is None and isinstance(v, FeatureOidPromise) and v.data is not None
                and kv.value_is_lazy):
            data, v.data = v.data, None
            return v.ds.feature_json_from_data(v.pk_values, data)
        return feature_as_json(kv.get_lazy_value(), kv.key, tx)

    def get_geometry_transforms(self, ds_path):
        """-> (old transform, new transform) to the ``--crs`` target, or
        (None, None)."""
        if self.target_crs is None:
            return None, None
        if ds_path not in self._transforms:
            self._transforms[ds_path] = tuple(
                geometry_transform_for_dataset(
                    rs.datasets.get(ds_path) if rs is not None else None, self.target_crs)
                for rs in (self.base_rs, self.target_rs))
        return self._transforms[ds_path]

    def features_geojson(self, ds_path, ds_diff):
        """GeoJSON features of one dataset's deltas (the GeoJSON and HTML
        writers): ids ``I::pk``, ``D::pk``, ``U-::pk`` and ``U+::pk``."""
        old_tx, new_tx = self.get_geometry_transforms(ds_path)
        for _key, delta in self.iter_deltas(ds_diff, ds_path):
            if delta.type == "insert":
                yield feature_as_geojson(delta.new_value, delta.new_key, "I", new_tx)
            elif delta.type == "delete":
                yield feature_as_geojson(delta.old_value, delta.old_key, "D", old_tx)
            else:
                yield feature_as_geojson(delta.old_value, delta.old_key, "U-", old_tx)
                yield feature_as_geojson(delta.new_value, delta.new_key, "U+", new_tx)

    def commit_header_json(self):
        """The ``kart show`` header of ``commit`` as JSON, or None."""
        commit = self.commit
        if commit is None:
            return None
        oid = getattr(commit, "oid", None)
        author = commit.author
        when = _author_time(author)
        off = abs(author.offset)
        return {
            "commit": oid,
            "abbrevCommit": oid[:7] if oid else None,
            "message": commit.message,
            "authorName": author.name,
            "authorEmail": author.email,
            "authorTime": when.strftime("%Y-%m-%dT%H:%M:%SZ") if author.offset == 0
            else when.isoformat(),
            "authorTimeOffset": f"{'+' if author.offset >= 0 else '-'}{off // 60:02d}:"
                                f"{off % 60:02d}",
        }

    def write_diff(self):
        self.write_header()
        for ds_path in self.all_ds_paths:
            ds_diff = self.get_ds_diff(ds_path)
            if ds_diff:
                self._mark_ds_changes(ds_diff)
                self.write_ds_diff(ds_path, ds_diff)
        self.write_warnings_footer()
        return self.has_changes

    def write_header(self):
        pass

    def write_ds_diff(self, ds_path, ds_diff):
        raise NotImplementedError

    def close(self):
        """Flush and close an output file this writer opened."""
        fp = getattr(self, "fp", None)
        if fp is not None and self.output_path not in (None, "-") and fp is not self.output_path:
            fp.close()


def _author_time(author):
    """The author's time in the author's own UTC offset."""
    tz = timezone(timedelta(minutes=author.offset))
    return datetime.fromtimestamp(author.time, timezone.utc).astimezone(tz)


def _prefixed(text, prefix):
    return re.sub("^", prefix, text, flags=re.MULTILINE)


class TextDiffWriter(BaseDiffWriter):
    """Human-readable text (lossy for geometry): ``--- ds:feature:pk`` /
    ``+++`` headers with one line a field."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.fp = resolve_output_path(self.output_path)

    def _echo(self, text=""):
        self.fp.write(f"{text}\n")

    def write_header(self):
        commit = self.commit
        if commit is None:
            return
        author = commit.author
        self._echo(f"commit {getattr(commit, 'oid', '')}")
        self._echo(f"Author: {author.name} <{author.email}>")
        self._echo(f"Date:   {_author_time(author).strftime('%c %z')}")
        self._echo()
        for line in commit.message.splitlines():
            self._echo(f"    {line}")
        self._echo()

    def write_ds_diff(self, ds_path, ds_diff):
        if "meta" in ds_diff:
            for key, delta in ds_diff["meta"].sorted_items():
                self.write_meta_delta(ds_path, key, delta)
        for key, delta in self.iter_deltas(ds_diff, ds_path):
            self.write_feature_delta(ds_path, key, delta)

    def write_meta_delta(self, ds_path, key, delta):
        if delta.old:
            self._echo(f"--- {ds_path}:meta:{delta.old_key}")
        if delta.new:
            self._echo(f"+++ {ds_path}:meta:{delta.new_key}")
        if key == "schema.json" and delta.old and delta.new:
            self._echo(self._schema_diff_as_text(Schema.from_column_dicts(delta.old_value),
                                                 Schema.from_column_dicts(delta.new_value)))
            return
        if delta.old:
            self._echo(self._prefix_meta_item(delta.old_value, delta.old_key, "- "))
        if delta.new:
            self._echo(self._prefix_meta_item(delta.new_value, delta.new_key, "+ "))

    @staticmethod
    def _prefix_meta_item(value, name, prefix):
        if name.endswith(".wkt"):
            text = format_wkt_for_output(value)
        elif name.endswith(".json"):
            text = json.dumps(value, indent=2)
        else:
            text = str(value)
        return _prefixed(text, prefix)

    @staticmethod
    def _schema_diff_as_text(old_schema, new_schema):
        """The new schema's columns as JSON, with the removed, added and
        changed ones marked ``-``/``+``."""
        new_by_id = {c.id for c in new_schema}
        old_by_id = {c.id: c for c in old_schema}
        lines = ["["]
        for col in old_schema:
            if col.id not in new_by_id:
                lines.append(_prefixed(json.dumps(col.to_dict(), indent=2), "-   ") + ",")
        for col in new_schema:
            old_col = old_by_id.get(col.id)
            text = json.dumps(col.to_dict(), indent=2)
            if old_col is None:
                lines.append(_prefixed(text, "+   ") + ",")
            elif old_col == col:
                lines.append(_prefixed(text, "    ") + ",")
            else:
                lines.append(_prefixed(json.dumps(old_col.to_dict(), indent=2), "-   ") + ",")
                lines.append(_prefixed(text, "+   ") + ",")
        lines.append("]")
        return "\n".join(lines)

    def write_feature_delta(self, ds_path, key, delta):
        if delta.type == "insert":
            self._echo(f"+++ {ds_path}:feature:{delta.new_key}")
            self._echo(feature_as_text(delta.new_value, prefix="+ "))
            return
        if delta.type == "delete":
            self._echo(f"--- {ds_path}:feature:{delta.old_key}")
            self._echo(feature_as_text(delta.old_value, prefix="- "))
            return
        self._echo(f"--- {ds_path}:feature:{delta.old_key}\n+++ {ds_path}:feature:{delta.new_key}")
        old_f, new_f = delta.old_value, delta.new_value
        for k in itertools.chain(old_f.keys(), (k for k in new_f.keys() if k not in old_f)):
            if k.startswith("__") or old_f.get(k, _NULL) == new_f.get(k, _NULL):
                continue
            if k in old_f:
                self._echo(feature_field_as_text(old_f, k, "- "))
            if k in new_f:
                self._echo(feature_field_as_text(new_f, k, "+ "))


class JsonDiffWriter(BaseDiffWriter):
    """The whole diff as one JSON document, ``kart.diff/v1+hexwkb``."""

    def write_diff(self):
        repo_diff = self.get_repo_diff()
        for ds_diff in repo_diff.values():
            self._mark_ds_changes(ds_diff)
        output = {}
        header = self.commit_header_json()
        if header is not None:
            output["kart.show/v1"] = header
        output["kart.diff/v1+hexwkb"] = {
            ds_path: self.ds_diff_as_json(ds_path, ds_diff)
            for ds_path, ds_diff in repo_diff.items()
        }
        if self.include_patch_header:
            output["kart.patch/v1"] = self.patch_header()
        self.fp = dump_json_output(output, self.output_path, json_style=self.json_style)
        self.write_warnings_footer()
        return self.has_changes

    def patch_header(self):
        header = self.commit_header_json() or {}
        return {
            "authorEmail": header.get("authorEmail"),
            "authorName": header.get("authorName"),
            "authorTime": header.get("authorTime"),
            "authorTimeOffset": header.get("authorTimeOffset"),
            "base": self.base_rs.commit_oid if self.base_rs else None,
            "message": header.get("message"),
        }

    def ds_diff_as_json(self, ds_path, ds_diff):
        result = {}
        if "meta" in ds_diff:
            result["meta"] = {key: self.meta_delta_as_json(delta)
                              for key, delta in ds_diff["meta"].sorted_items()}
        if "feature" in ds_diff:
            old_tx, new_tx = self.get_geometry_transforms(ds_path)
            minimal = self.patch_type == "minimal"
            features = []
            for _key, delta in self.iter_deltas(ds_diff, ds_path):
                item = {}
                if delta.old and (not minimal or not delta.new):
                    item["-"] = self._feature_json_fast(delta.old, old_tx)
                if delta.new:
                    item["*" if delta.old and minimal else "+"] = self._feature_json_fast(
                        delta.new, new_tx)
                features.append(item)
            result["feature"] = features
        return result

    def meta_delta_as_json(self, delta):
        out = {}
        if delta.old is not None:
            out["-"] = delta.old_value
        if delta.new is not None:
            out["+"] = delta.new_value
        if self.patch_type == "minimal" and "-" in out and "+" in out:
            out.pop("-")
            out["*"] = out.pop("+")
        return out


class JsonLinesDiffWriter(BaseDiffWriter):
    """One JSON object per line. Commit-to-commit diffs of datasets with
    sidecars stream through the fused columnar row route; everything else
    through deltas. Both routes write identical bytes."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.fp = resolve_output_path(self.output_path)
        self._encode = json.JSONEncoder(separators=(",", ":"), ensure_ascii=True).encode

    def _writeln(self, obj):
        self.fp.write(self._encode(obj))
        self.fp.write("\n")

    def write_header(self):
        self._writeln({"type": "version", "version": "kart.diff/v2",
                       "outputFormat": "JSONL+hexwkb"})
        header = self.commit_header_json()
        if header:
            self._writeln({"type": "commit", "value": header})

    def write_diff(self):
        self.write_header()
        for ds_path in self.all_ds_paths:
            if self._write_ds_fast(ds_path):
                continue
            ds_diff = self.get_ds_diff(ds_path)
            if ds_diff:
                self._mark_ds_changes(ds_diff)
                self.write_ds_diff(ds_path, ds_diff)
        self.write_warnings_footer()
        return self.has_changes

    def _write_ds_fast(self, ds_path):
        """The fused row route for one dataset; True when it handled it. It
        has no per-value residue, no reprojection and no backfill, so a
        spatial filter, ``--crs`` or a promisor remote takes the delta
        route."""
        if (self.working_copy is not None or self.spatial_filter_spec is not None
                or not self.repo_key_filter.match_all or self.target_crs is not None
                or self.repo.has_promisor_remote()):
            return False
        rows = get_feature_diff_rows(self.base_rs, self.target_rs, ds_path, self.device)
        if rows is None:
            return False
        base_ds = self.base_rs.datasets.get(ds_path)
        target_ds = self.target_rs.datasets.get(ds_path)
        meta_diff = get_meta_diff(base_ds, target_ds)
        self._write_meta_infos(ds_path, meta_diff)
        if meta_diff or rows["count"]:
            self.has_changes = True
        if rows["count"]:
            self._materialise_rows(rows, base_ds, target_ds, self._feature_head(ds_path))
        return True

    def _feature_head(self, ds_path):
        """The constant prefix of every feature line of one dataset."""
        return '{"type":"feature","dataset":' + self._encode(ds_path) + ',"change":{'

    def _write_meta_infos(self, ds_path, meta_diff):
        for key, delta in meta_diff.sorted_items():
            obj = {"type": "metaInfo", "dataset": ds_path, "key": key, "change": {}}
            if delta.old is not None:
                obj["change"]["-"] = delta.old_value
            if delta.new is not None:
                obj["change"]["+"] = delta.new_value
            self._writeln(obj)

    def _materialise_rows(self, rows, base_ds, target_ds, head):
        """Write every row of a columnar row plan: each chunk's blobs read
        in pack order, each line composed as one string."""
        old_block, new_block = rows["old_block"], rows["new_block"]
        pks, old_rows, new_rows = rows["pks"], rows["old_rows"], rows["new_rows"]
        old_odb, new_odb = base_ds._feature_odb(), target_ds._feature_odb()
        old_json = base_ds.feature_json_str_from_data
        new_json = target_ds.feature_json_str_from_data
        for lo in range(0, rows["count"], self.PREFETCH_CHUNK):
            hi = min(lo + self.PREFETCH_CHUNK, rows["count"])
            o_sel, n_sel = old_rows[lo:hi], new_rows[lo:hi]
            o_shas = unpack_oid_bytes(old_block.oids[o_sel[o_sel >= 0]])
            n_shas = unpack_oid_bytes(new_block.oids[n_sel[n_sel >= 0]])
            if old_odb is new_odb:
                datas = old_odb.read_blobs_data_ordered(o_shas + n_shas)
                o_data, n_data = datas[: len(o_shas)], datas[len(o_shas) :]
            else:
                o_data = old_odb.read_blobs_data_ordered(o_shas)
                n_data = new_odb.read_blobs_data_ordered(n_shas)
            lines = []
            oi = ni = 0
            for pk, has_old, has_new in zip(pks[lo:hi].tolist(), (o_sel >= 0).tolist(),
                                            (n_sel >= 0).tolist()):
                pkv = (pk,)
                if has_old:
                    body = '"-":' + old_json(pkv, o_data[oi])
                    oi += 1
                    if has_new:
                        body += ',"+":' + new_json(pkv, n_data[ni])
                        ni += 1
                else:
                    body = '"+":' + new_json(pkv, n_data[ni])
                    ni += 1
                lines.append(head + body + "}}\n")
            self.fp.write("".join(lines))

    def write_ds_diff(self, ds_path, ds_diff):
        if "meta" in ds_diff:
            self._write_meta_infos(ds_path, ds_diff["meta"])
        head = self._feature_head(ds_path)
        old_tx, new_tx = self.get_geometry_transforms(ds_path)
        for _key, delta in self.iter_deltas(ds_diff, ds_path):
            old, new = delta.old, delta.new
            if old is not None:
                body = '"-":' + self._feature_json_str(old, old_tx)
                if new is not None:
                    body += ',"+":' + self._feature_json_str(new, new_tx)
            else:
                body = '"+":' + self._feature_json_str(new, new_tx)
            self.fp.write(head + body + "}}\n")

    def _feature_json_str(self, kv, tx=None):
        """Compact JSON text of one delta side: the fused blob->text decode
        from prefetched data when nothing is reprojected, else the generic
        convert-then-encode (the same bytes either way)."""
        v = kv[1]
        if (tx is None and isinstance(v, FeatureOidPromise) and v.data is not None
                and kv.value_is_lazy):
            data, v.data = v.data, None
            return v.ds.feature_json_str_from_data(v.pk_values, data)
        return self._encode(feature_as_json(kv.get_lazy_value(), kv.key, tx))


class GeojsonDiffWriter(BaseDiffWriter):
    """One FeatureCollection a dataset, each delta as features with ids
    ``I::pk``, ``D::pk``, ``U-::pk`` and ``U+::pk``. A diff of several
    datasets needs ``--output DIR`` and writes ``DIR/<ds path with / as
    __>.geojson`` for each."""

    def write_diff(self):
        repo_diff = self.get_repo_diff()
        for ds_diff in repo_diff.values():
            self._mark_ds_changes(ds_diff)
        ds_paths = [p for p, d in repo_diff.items() if "feature" in d]
        out = self.output_path
        multi = len(ds_paths) > 1
        if multi and (out in (None, "-") or hasattr(out, "write")):
            raise DiffUsageError("Need an --output directory for multi-dataset GeoJSON diffs")
        for ds_path in ds_paths:
            collection = {"type": "FeatureCollection",
                          "features": list(self.features_geojson(ds_path, repo_diff[ds_path]))}
            path = out
            if multi:
                os.makedirs(out, exist_ok=True)
                path = os.path.join(out, ds_path.replace("/", "__") + ".geojson")
            fp = dump_json_output(collection, path, json_style=self.json_style)
            if fp is not sys.stdout and fp is not out:
                fp.close()
        self.write_warnings_footer()
        return self.has_changes


class QuietDiffWriter(BaseDiffWriter):
    """No output; ``has_changes`` drives the exit code."""

    def write_ds_diff(self, ds_path, ds_diff):
        if self._ds_spatial_filter(ds_path) is not None and not self.has_changes:
            # the filtered exit code needs an answer: stream until the
            # first matching delta sets has_changes
            next(self.iter_deltas(ds_diff, ds_path), None)


class FeatureCountDiffWriter(BaseDiffWriter):
    """Changed-feature count per dataset: from a counts-only K1 launch when
    both revisions have sidecars (under a spatial filter, on the envelope
    prefilter's survivors: an envelope-precision count), else from the
    delta diff (under a filter, the deltas that match it)."""

    def write_diff(self):
        self.fp = resolve_output_path(self.output_path)
        for ds_path in self.all_ds_paths:
            count = None
            if self.working_copy is None and self.repo_key_filter.match_all:
                count = get_dataset_feature_count_fast(
                    self.base_rs, self.target_rs, ds_path, self.device,
                    spatial_filter_spec=self.spatial_filter_spec)
            if count is None:
                ds_diff = self.get_ds_diff(ds_path)
                if self._ds_spatial_filter(ds_path) is not None:
                    count = sum(1 for _ in self.iter_deltas(ds_diff, ds_path))
                else:
                    count = len(ds_diff.get("feature", ()))
            if count:
                self.has_changes = True
                self.fp.write(f"{ds_path}:\n\t{count} features changed\n")
        self.write_warnings_footer()
        return self.has_changes


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>kart diff</title>
<style>
 body {{ font-family: sans-serif; margin: 0; display: flex; height: 100vh; }}
 #list {{ width: 40%; overflow: auto; padding: 8px; box-sizing: border-box; }}
 #map {{ flex: 1; background: #eef; }}
 .I {{ color: #070; }} .D {{ color: #a00; }} .U- {{ color: #850; }} .U\\+ {{ color: #085; }}
 pre {{ margin: 2px 0; }}
 svg path, svg circle {{ fill-opacity: .3; stroke-width: 1; }}
</style></head><body>
<div id="list"><h3>kart diff</h3></div><svg id="map"></svg>
<script>
const DATA = {data};
const list = document.getElementById('list');
const svg = document.getElementById('map');
let minx=1e9,miny=1e9,maxx=-1e9,maxy=-1e9;
const geoms = [];
for (const [ds, fc] of Object.entries(DATA)) {{
  const h = document.createElement('h4'); h.textContent = ds; list.appendChild(h);
  for (const f of fc.features) {{
    const change = f.id.split('::')[0];
    const pre = document.createElement('pre');
    pre.className = change;
    pre.textContent = f.id + ' ' + JSON.stringify(f.properties);
    list.appendChild(pre);
    if (f.geometry) {{ geoms.push([change, f.geometry]); walk(f.geometry.coordinates); }}
  }}
}}
function walk(c) {{
  if (typeof c[0] === 'number') {{
    minx=Math.min(minx,c[0]); maxx=Math.max(maxx,c[0]);
    miny=Math.min(miny,c[1]); maxy=Math.max(maxy,c[1]);
  }} else c.forEach(walk);
}}
const W=600,H=600, dx=maxx-minx||1, dy=maxy-miny||1;
svg.setAttribute('viewBox', `0 0 ${{W}} ${{H}}`);
const X=x=>(x-minx)/dx*(W-20)+10, Y=y=>H-((y-miny)/dy*(H-20)+10);
const colors={{'I':'#070','D':'#a00','U-':'#850','U+':'#085'}};
for (const [change, g] of geoms) draw(g, colors[change]||'#333');
function draw(g, color) {{
  const el = (name)=>document.createElementNS('http://www.w3.org/2000/svg', name);
  const add=(node)=>{{node.setAttribute('stroke',color);node.setAttribute('fill',color);svg.appendChild(node);}};
  const ring=(pts)=>pts.map((p,i)=>`${{i?'L':'M'}}${{X(p[0])}} ${{Y(p[1])}}`).join('');
  if (g.type==='Point') {{ const c=el('circle'); c.setAttribute('cx',X(g.coordinates[0])); c.setAttribute('cy',Y(g.coordinates[1])); c.setAttribute('r',4); add(c); }}
  else if (g.type==='LineString') {{ const p=el('path'); p.setAttribute('d',ring(g.coordinates)); p.setAttribute('fill','none'); add(p); }}
  else if (g.type==='Polygon') {{ const p=el('path'); p.setAttribute('d',g.coordinates.map(ring).join('')+'Z'); add(p); }}
  else if (g.type.startsWith('Multi')) g.coordinates.forEach(c=>draw({{type:g.type.slice(5),coordinates:c}}, color));
}}
</script></body></html>
"""


class HtmlDiffWriter(BaseDiffWriter):
    """A self-contained HTML page: the diff's GeoJSON embedded, drawn as an
    inline SVG map. Written to ``--output``, or to ``diff.html`` in the
    current directory (``Wrote <path>`` on stderr)."""

    def write_diff(self):
        repo_diff = self.get_repo_diff()
        for ds_diff in repo_diff.values():
            self._mark_ds_changes(ds_diff)
        all_data = {
            ds_path: {"type": "FeatureCollection",
                      "features": list(self.features_geojson(ds_path, ds_diff))}
            for ds_path, ds_diff in repo_diff.items() if "feature" in ds_diff
        }
        self.output_path = self.output_path if self.output_path not in (None, "-") else "diff.html"
        self.fp = resolve_output_path(self.output_path)
        self.fp.write(_HTML_TEMPLATE.format(data=json.dumps(all_data)))
        if hasattr(self.fp, "name"):
            print(f"Wrote {self.fp.name}", file=sys.stderr)
        self.write_warnings_footer()
        return self.has_changes
