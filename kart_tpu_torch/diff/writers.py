"""Diff writers for ``-o json``, ``json-lines``, ``quiet`` and
``feature-count``.

A writer is built from a commit spec (``A..B`` or ``A...B``), streams the
diff in its format and reports ``has_changes`` for the exit code. Values
stay lazy until each delta is written; every writer passes ``device`` to
the engine, whose columnar route runs kernel K1 there.

Counterpart of kart_tpu's ``diff/writers.py``: ``BaseDiffWriter``
(``parse_diff_commit_spec``, ``iter_deltas``), ``JsonDiffWriter``,
``JsonLinesDiffWriter`` (the delta route and the fused columnar row route,
single process), ``QuietDiffWriter`` and ``FeatureCountDiffWriter``, with
the repo's spatial filter: the engine prefilters sidecar block pairs by
envelope (kernel K2), and ``iter_deltas`` streams only the deltas one of
whose sides matches the filter (the exact per-value residue); the exit
code follows what is written, not the unfiltered diff. Not ported: the
text, GeoJSON and HTML writers, ``--crs``, working-copy diffs, the ``kart
show`` commit header, the forked materialisers and the promised-blob
backfill of partial clones (a filtered repo with a promisor remote raises
``NotYetImplemented``).
"""

import json
import re

from kart_tpu_torch.core.odb import ObjectMissing
from kart_tpu_torch.core.repo import InvalidOperation, NotYetImplemented
from kart_tpu_torch.diff.engine import (
    get_dataset_diff,
    get_dataset_feature_count_fast,
    get_feature_diff_rows,
    get_meta_diff,
    get_repo_diff,
)
from kart_tpu_torch.diff.key_filters import RepoKeyFilter
from kart_tpu_torch.diff.output import dump_json_output, feature_as_json, resolve_output_path
from kart_tpu_torch.models.dataset import FeatureOidPromise
from kart_tpu_torch.ops.blocks import unpack_oid_bytes
from kart_tpu_torch.spatial_filter import MatchResult, SpatialFilter

#: every output format of ``kart diff``; the writers below are the ported ones
OUTPUT_FORMATS = ["text", "json", "geojson", "json-lines", "quiet", "feature-count", "html"]


def _chunked(items, size):
    chunk = []
    for item in items:
        chunk.append(item)
        if len(chunk) == size:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


class BaseDiffWriter:
    #: rows per blob prefetch / materialisation chunk
    PREFETCH_CHUNK = 8192

    @classmethod
    def get_diff_writer_class(cls, output_format):
        writers = {
            "json": JsonDiffWriter,
            "json-lines": JsonLinesDiffWriter,
            "quiet": QuietDiffWriter,
            "feature-count": FeatureCountDiffWriter,
        }
        if output_format not in writers:
            raise NotYetImplemented(
                f"-o {output_format} is not ported yet (ported: {', '.join(writers)})"
            )
        return writers[output_format]

    def __init__(self, repo, commit_spec="HEAD", user_key_filters=(), output_path="-", *,
                 json_style="pretty", device=None):
        self.repo = repo
        self.commit_spec = commit_spec
        self.output_path = output_path
        self.json_style = json_style
        self.device = device
        self.repo_key_filter = RepoKeyFilter.build_from_user_patterns(user_key_filters)
        self.base_rs, self.target_rs = self.parse_diff_commit_spec(repo, commit_spec)
        self.has_changes = False
        # the repo's spatial filter: diffs show only the deltas that match it
        self.spatial_filter_spec = repo.spatial_filter_spec()
        self._ds_sf_cache = {}
        if self.spatial_filter_spec is not None:
            if repo.has_promisor_remote():
                raise NotYetImplemented(
                    "diffs of a spatially filtered partial clone (promised blobs) are not "
                    "ported yet"
                )
            # resolve every dataset's filter before any output: a CRS that
            # the port cannot transform yet raises here
            for ds_path in self.all_ds_paths:
                self._ds_spatial_filter(ds_path)

    @classmethod
    def parse_diff_commit_spec(cls, repo, commit_spec):
        """'A..B' or 'A...B' -> (base_rs, target_rs). ``A..B`` diffs from
        merge-base(A, B), as git log reads it."""
        parts = re.split(r"(\.{2,3})", commit_spec or "HEAD")
        if len(parts) != 3:
            raise NotYetImplemented(
                "working-copy diffs are not ported: give two revisions (eg HEAD^...HEAD)"
            )
        base_rs = repo.structure(parts[0] or "HEAD")
        target_rs = repo.structure(parts[2] or "HEAD")
        if parts[1] == "..":
            ancestor = repo.merge_base(base_rs.commit_oid, target_rs.commit_oid)
            if ancestor is None:
                raise InvalidOperation("No common ancestor found — try the ... operator")
            base_rs = repo.structure(ancestor)
        return base_rs, target_rs

    @property
    def all_ds_paths(self):
        paths = set(self.base_rs.datasets.paths()) | set(self.target_rs.datasets.paths())
        if not self.repo_key_filter.match_all:
            paths &= set(self.repo_key_filter.ds_paths())
        return sorted(paths)

    def get_repo_diff(self):
        return get_repo_diff(self.base_rs, self.target_rs,
                             repo_key_filter=self.repo_key_filter, device=self.device,
                             spatial_filter_spec=self.spatial_filter_spec)

    def get_ds_diff(self, ds_path):
        return get_dataset_diff(self.base_rs, self.target_rs, ds_path,
                                ds_filter=self.repo_key_filter[ds_path], device=self.device,
                                spatial_filter_spec=self.spatial_filter_spec)

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
        ``ds_path``), only the deltas that match it."""
        feature_diff = ds_diff.get("feature")
        if not feature_diff:
            return
        sf = self._ds_spatial_filter(ds_path)
        for chunk in _chunked(feature_diff.sorted_items(), self.PREFETCH_CHUNK):
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
            for key, delta in chunk:
                if sf is None or self._delta_matches_filter(delta, sf):
                    self.has_changes = True
                    yield key, delta

    @staticmethod
    def _feature_json_fast(kv):
        """JSON-ready dict of one delta side, decoded straight from
        prefetched blob data when there is some."""
        v = kv[1]
        if isinstance(v, FeatureOidPromise) and v.data is not None and kv.value_is_lazy:
            data, v.data = v.data, None
            return v.ds.feature_json_from_data(v.pk_values, data)
        return feature_as_json(kv.get_lazy_value())

    def write_diff(self):
        self.write_header()
        for ds_path in self.all_ds_paths:
            ds_diff = self.get_ds_diff(ds_path)
            if ds_diff:
                self._mark_ds_changes(ds_diff)
                self.write_ds_diff(ds_path, ds_diff)
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


class JsonDiffWriter(BaseDiffWriter):
    """The whole diff as one JSON document, ``kart.diff/v1+hexwkb``."""

    def write_diff(self):
        repo_diff = self.get_repo_diff()
        for ds_diff in repo_diff.values():
            self._mark_ds_changes(ds_diff)
        output = {"kart.diff/v1+hexwkb": {
            ds_path: self.ds_diff_as_json(ds_path, ds_diff)
            for ds_path, ds_diff in repo_diff.items()
        }}
        self.fp = dump_json_output(output, self.output_path, json_style=self.json_style)
        return self.has_changes

    def ds_diff_as_json(self, ds_path, ds_diff):
        result = {}
        if "meta" in ds_diff:
            result["meta"] = {}
            for key, delta in ds_diff["meta"].sorted_items():
                item = result["meta"][key] = {}
                if delta.old is not None:
                    item["-"] = delta.old_value
                if delta.new is not None:
                    item["+"] = delta.new_value
        if "feature" in ds_diff:
            features = []
            for _key, delta in self.iter_deltas(ds_diff, ds_path):
                item = {}
                if delta.old:
                    item["-"] = self._feature_json_fast(delta.old)
                if delta.new:
                    item["+"] = self._feature_json_fast(delta.new)
                features.append(item)
            result["feature"] = features
        return result


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

    def write_diff(self):
        self.write_header()
        for ds_path in self.all_ds_paths:
            if self._write_ds_fast(ds_path):
                continue
            ds_diff = self.get_ds_diff(ds_path)
            if ds_diff:
                self._mark_ds_changes(ds_diff)
                self.write_ds_diff(ds_path, ds_diff)
        return self.has_changes

    def _write_ds_fast(self, ds_path):
        """The fused row route for one dataset; True when it handled it. It
        has no per-value residue, so a spatial filter takes the delta
        route."""
        if self.spatial_filter_spec is not None or not self.repo_key_filter.match_all:
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
        for _key, delta in self.iter_deltas(ds_diff, ds_path):
            old, new = delta.old, delta.new
            if old is not None:
                body = '"-":' + self._feature_json_str(old)
                if new is not None:
                    body += ',"+":' + self._feature_json_str(new)
            else:
                body = '"+":' + self._feature_json_str(new)
            self.fp.write(head + body + "}}\n")

    def _feature_json_str(self, kv):
        """Compact JSON text of one delta side: the fused blob->text decode
        from prefetched data, else the generic convert-then-encode (the
        same bytes either way)."""
        v = kv[1]
        if isinstance(v, FeatureOidPromise) and v.data is not None and kv.value_is_lazy:
            data, v.data = v.data, None
            return v.ds.feature_json_str_from_data(v.pk_values, data)
        return self._encode(feature_as_json(kv.get_lazy_value()))


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
            if self.repo_key_filter.match_all:
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
        return self.has_changes
