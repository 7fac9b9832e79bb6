"""``kart merge``, ``kart conflicts`` and ``kart resolve``.

Counterpart of kart_tpu's ``cli/merge_cmds.py`` with its option names,
defaults, messages and exit codes (a refused operation prints ``Error:
<message>`` and exits 2). ``merge`` runs one classify a dataset on the
card (``--device cpu``: the plain version). ``conflicts`` writes text
(features as ``feature_as_text`` blocks, or the ``-s``/``-ss``
summaries), json and geojson, reprojected by ``--crs`` to any CRS of the
transform engine, geographic or projected; ``resolve`` takes a version
(``--with``) or the features of a GeoJSON file (``--with-file``).
"""

import json
import sys

from kart_tpu_torch.cli.parser import Argument, Command, Option
from kart_tpu_torch.core.repo import InvalidOperation, KartRepoState, NotFound
from kart_tpu_torch.diff.output import (
    dump_json_output,
    feature_as_geojson,
    feature_as_json,
    feature_as_text,
    geometry_transform_for_dataset,
)

INVALID_ARGUMENT = 2


class _CliError(Exception):
    """A refused command: ``Error: <message>`` on stderr, exit 2."""


def commands():
    return [
        Command("merge", [
            Argument("refish", required=False),
            Option("--message", "-m", dest="message",
                   help="Commit message for the merge commit"),
            Option("--dry-run", dest="dry_run", kind="flag",
                   help="Show what would be merged, don't do it"),
            Option("--ff", dest="ff", kind="flag", secondary=["--no-ff"], default=True,
                   help="Allow/forbid fast-forward"),
            Option("--ff-only", dest="ff_only", kind="flag", help="Refuse non-fast-forward merges"),
            Option("--continue", dest="continue_", kind="flag",
                   help="Complete an in-progress merge"),
            Option("--abort", dest="abort_", kind="flag", help="Abort an in-progress merge"),
            Option("-o", "--output-format", dest="output_format", choices=["text", "json"],
                   default="text"),
        ], _refusable(run_merge), help="Merge a commit into the current branch"),
        Command("conflicts", [
            Option("-o", "--output-format", dest="output_format",
                   choices=["text", "json", "geojson", "quiet"], default="text"),
            Option("--exit-code", dest="exit_code", kind="flag",
                   help="Exit with 1 if there are conflicts, 0 if there are none"),
            Option("--json-style", dest="json_style",
                   choices=["extracompact", "compact", "pretty"], default="pretty"),
            Option("-s", "--summarise", "--summarize", dest="summarise", kind="count",
                   help="Summarise rather than list each conflict (-ss for even shorter)"),
            Option("--flat", dest="flat", kind="flag",
                   help="All conflicts in a flat list instead of a hierarchy"),
            Option("--crs", dest="target_crs",
                   help="Reproject geometries into the given CRS (EPSG:<code> or WKT)"),
            Argument("filters", nargs=-1),
        ], _refusable(run_conflicts), help="List the conflicts of an in-progress merge"),
        Command("resolve", [
            Argument("label"),
            Option("--with", dest="with_version", choices=["ancestor", "ours", "theirs", "delete"],
                   help="Resolve the conflict with the named version (or delete the feature)"),
            Option("--with-file", dest="with_file", path_exists=True,
                   help="Resolve the conflict with feature(s) from a GeoJSON file"),
        ], _refusable(run_resolve), help="Resolve one conflict of an in-progress merge"),
    ]


def _refusable(fn):
    def run(args, repo, device):
        try:
            return fn(args, repo, device)
        except _CliError as e:
            print(f"Error: {e}", file=sys.stderr)
            return INVALID_ARGUMENT
    return run


# --- merge -------------------------------------------------------------------

def run_merge(args, repo, device):
    from kart_tpu_torch.merge import (
        abort_merging_state,
        complete_merging_state,
        do_merge,
        reset_working_copy,
    )

    try:
        if args.abort_:
            if repo.state != KartRepoState.MERGING:
                raise _CliError("Repository is not in 'merging' state")
            abort_merging_state(repo)
            reset_working_copy(repo, device)
            print("Merge aborted")
            return 0
        if args.continue_:
            commit_oid = complete_merging_state(repo, message=args.message, device=device)
            if args.output_format == "json":
                dump_json_output({"kart.merge/v1": {"commit": commit_oid}}, "-")
            else:
                print(f"Merge committed as {commit_oid}")
            return 0
        if not args.refish:
            raise _CliError("Missing argument: COMMIT")
        result = do_merge(repo, args.refish, message=args.message, dry_run=args.dry_run,
                          ff=args.ff, ff_only=args.ff_only, device=device)
    except (InvalidOperation, NotFound) as e:
        raise _CliError(str(e))

    if args.output_format == "json":
        dump_json_output(_merge_json(result), "-")
    elif result.already_merged:
        print("Already up to date")
    elif result.fast_forward:
        print(f"Fast-forward to {result.commit_oid}")
    elif result.has_conflicts:
        n = len(result.merge_index.conflicts)
        if result.dry_run:
            print(f"Merge would result in {n} conflicts (dry run)")
        else:
            print(f"Merge resulted in {n} conflicts.")
            print('Repository is now in "merging" state. View conflicts with '
                  '"kart conflicts", resolve with "kart resolve", then '
                  '"kart merge --continue" (or "kart merge --abort").')
    elif result.dry_run:
        print("Merge is possible with no conflicts (dry run)")
    else:
        print(f"Merged and committed as {result.commit_oid}")
    return 0


def _merge_json(result):
    if result.has_conflicts and result.dry_run and not result.already_merged:
        return merge_conflict_report(result.merge_index.conflicts)
    body = {}
    if result.already_merged:
        body["noOp"] = True
        body["message"] = "Already up to date"
    elif result.fast_forward:
        body["fastForward"] = True
        body["commit"] = result.commit_oid
    elif result.has_conflicts:
        body["conflicts"] = _conflict_summary(result.merge_index.conflicts)
        body["state"] = "merging"
    else:
        body["commit"] = result.commit_oid
        body["merging"] = False
    if result.dry_run:
        body["dryRun"] = True
    return {"kart.merge/v1": body}


def merge_conflict_report(conflicts):
    """The ``kart merge <theirs> --dry-run -o json`` document of a
    conflicted merge."""
    return {"kart.merge/v1": {"conflicts": _conflict_summary(conflicts), "state": "merging",
                              "dryRun": True}}


def _conflict_summary(conflicts):
    """Conflicts -> {ds_path: {part: count}}; columnar conflict sets count
    from their key columns without materialising a label."""
    counts = getattr(conflicts, "summary_counts", None)
    if counts is not None:
        out = {}
        for parts, n in sorted(counts().items()):
            _set_value_at_path(out, parts, n)
        return out
    out = {}
    for label in conflicts:
        _set_value_at_path(out, tuple(label.split(":", 2)), _CONFLICT_PLACEHOLDER)
    return _summarise_tree(out, 2)


# --- conflicts ---------------------------------------------------------------

_CONFLICT_PLACEHOLDER = object()


class _ConflictDecoder:
    """Decodes conflict entries to output values, resolving the merge's two
    revisions and their datasets once per command."""

    def __init__(self, repo):
        from kart_tpu_torch.core.structure import RepoStructure

        self.repo = repo
        self.structures = []
        merge_head = repo.read_gitdir_file("MERGE_HEAD")
        for refish in ("HEAD", merge_head and merge_head.strip()):
            if not refish:
                continue
            try:
                self.structures.append(RepoStructure(repo, refish))
            except (NotFound, KeyError):
                continue  # labels use whichever revisions resolve
        self._ds_cache = {}

    def _datasets_for(self, ds_path):
        if ds_path not in self._ds_cache:
            self._ds_cache[ds_path] = [ds for ds in (s.datasets.get(ds_path)
                                                     for s in self.structures) if ds is not None]
        return self._ds_cache[ds_path]

    def versions_json(self, aot):
        return {name: self.entry_value_json(aot.get(name))
                for name in ("ancestor", "ours", "theirs") if aot.get(name) is not None}

    def entry_value_json(self, entry):
        if not self.structures:
            return {"$blob": entry.oid}
        ds_path, part, item = self.structures[0].decode_path(entry.path)
        data = self.repo.odb.read_blob(entry.oid)
        if part == "feature":
            for ds in self._datasets_for(ds_path):
                try:
                    return ds.get_feature(ds.decode_path_to_pks(item), data=data)
                except Exception:  # kart_tpu shows an undecodable blob by its oid
                    continue
            return {"$blob": entry.oid}
        # a meta item or attachment: *.json is JSON, anything else text
        if item.endswith(".json"):
            try:
                return json.loads(data)
            except ValueError:
                return {"$blob": entry.oid}
        try:
            return data.decode("utf-8")
        except UnicodeDecodeError:
            return {"$blob": entry.oid}


def _path_part_sort_key(part):
    """Numbers numerically, meta before feature, compound keys last."""
    if isinstance(part, str) and part.isdigit():
        part = int(part)
    if part == "meta":
        return ("A", part)
    if part == "feature":
        return ("B", part)
    if isinstance(part, str) and "," in part:
        return ("Z", part)
    if isinstance(part, int):
        return ("N", "", part)
    return ("N", part)


def _path_sort_key(path):
    if isinstance(path, str) and ":" in path:
        return tuple(_path_part_sort_key(p) for p in path.split(":"))
    return _path_part_sort_key(path)


def _set_value_at_path(root, path, value):
    cur = root
    for p in path[:-1]:
        cur = cur.setdefault(p, {})
    cur[path[-1]] = value


def _prefix_counts(labels):
    """The ``-ss`` tree of ``labels`` ({ds: {part: count}}) without sorting
    them: each (dataset, part) prefix counted, the prefixes nested in the
    order the sorted labels would first show them. None when a label does
    not split into exactly three parts or two prefixes have equal sort keys:
    then only the sort of every label decides the order."""
    counts = {}
    for label in labels:
        parts = label.split(":")
        if len(parts) != 3:
            return None
        prefix = (parts[0], parts[1])
        counts[prefix] = counts.get(prefix, 0) + 1
    keys = {p: (_path_part_sort_key(p[0]), _path_part_sort_key(p[1])) for p in counts}
    if len(set(keys.values())) != len(keys):
        return None
    out = {}
    for ds_path, part in sorted(counts, key=keys.__getitem__):
        out.setdefault(ds_path, {})[part] = counts[ds_path, part]
    return out


def _summarise_tree(node, summarise):
    """Nested conflicts with placeholder leaves -> names (-s) or counts
    (-ss) at the version level."""
    first = next(iter(node.values())) if node else None
    if first is _CONFLICT_PLACEHOLDER:
        if summarise == 1:
            return sorted(node.keys(), key=_path_sort_key)
        return len(node)
    for k, v in node.items():
        node[k] = _summarise_tree(v, summarise)
    return node


def _filter_conflicts(unresolved, filters):
    """Label-prefix filters: 'ds', 'ds:feature', 'ds:feature:3'."""
    if not filters:
        return unresolved
    prefixes = [f.rstrip(":") for f in filters]
    return {label: v for label, v in unresolved.items()
            if any(label == p or label.startswith(p + ":") for p in prefixes)}


def _build_conflicts_output(repo, conflicts, unresolved, output_format, *, summarise=0,
                            flat=False, target_crs=None):
    """The filtered unresolved labels -> the output structure of
    ``output_format``: nested dicts (``flat``: keyed by label) of their
    versions from ``conflicts`` (features as text blocks, JSON with hex WKB,
    or GeoJSON features, reprojected to ``target_crs``), or their
    summaries; for geojson, one FeatureCollection."""
    if output_format == "geojson":
        flat, summarise = True, 0
    if summarise >= 2 and not flat:
        counts = _prefix_counts(unresolved)
        if counts is not None:
            return counts
    decoder = None if summarise else _ConflictDecoder(repo)
    tx_cache = {}

    def transform_for(ds_path):
        if target_crs is None:
            return None
        if ds_path not in tx_cache:
            datasets = decoder._datasets_for(ds_path)
            tx_cache[ds_path] = (geometry_transform_for_dataset(datasets[0], target_crs)
                                 if datasets else None)
        return tx_cache[ds_path]

    def render(value, parts):
        if len(parts) > 1 and parts[1] == "feature" and isinstance(value, dict) \
                and "$blob" not in value:
            pk = parts[2] if len(parts) > 2 else None
            if output_format == "text":
                return feature_as_text(value)
            if output_format == "geojson":
                return feature_as_geojson(value, pk, None, transform_for(parts[0]))
            return feature_as_json(value, pk, transform_for(parts[0]))
        # a meta item or an undecodable blob
        if output_format == "text":
            return value if isinstance(value, str) else json.dumps(value)
        return value

    out = {}
    for label in sorted(unresolved, key=_path_sort_key):
        parts = tuple(label.split(":", 2))
        if summarise:
            if flat:
                out[label] = _CONFLICT_PLACEHOLDER
            else:
                _set_value_at_path(out, parts, _CONFLICT_PLACEHOLDER)
            continue
        leaf = {name: render(value, parts)
                for name, value in decoder.versions_json(conflicts[label]).items()}
        if flat:
            for name, value in leaf.items():
                out[f"{label}:{name}"] = value
        else:
            _set_value_at_path(out, parts, leaf)
    if summarise:
        out = _summarise_tree(out, summarise)
    if output_format == "geojson":
        features = []
        for key, feature in out.items():
            if isinstance(feature, dict) and feature.get("type") == "Feature":
                feature["id"] = key
                features.append(feature)
        return {"type": "FeatureCollection", "features": features}
    return out


def conflict_report_as_text(summary):
    """A conflict summary tree as the text ``kart conflicts -ss`` prints:
    the renderer of a push's conflict report."""
    return _conflicts_json_as_text(summary)


def _conflicts_json_as_text(json_obj):
    """Hierarchical text of a conflicts summary: each level indents 4, keys
    join with ':' (kart_tpu colours the version headers on a terminal
    only, so this is its piped output)."""

    def value_to_text(value, path, level):
        if isinstance(value, str):
            return f"{value}\n"
        if isinstance(value, int):
            return f"{value} conflicts\n"
        if isinstance(value, dict):
            separator = "\n" if level == 0 else ""
            return separator.join(item_to_text(k, v, path, level)
                                  for k, v in sorted(value.items(),
                                                     key=lambda kv: _path_sort_key(kv[0])))
        if isinstance(value, list):
            indent = "    " * level
            return "".join(f"{indent}{path}{item}\n" for item in value)
        return f"{value}\n"

    def item_to_text(key, value, path, level):
        key_text = f"{path}{key}:"
        value_text = value_to_text(value, key_text, level + 1)
        if isinstance(value, int):
            return f"{'    ' * level}{key_text} {value_text}"
        return f"{'    ' * level}{key_text}\n{value_text}"

    return value_to_text(json_obj, "", 0)


def run_conflicts(args, repo, device):
    from kart_tpu_torch.merge.index import MergeIndex

    if repo.state != KartRepoState.MERGING:
        raise _CliError("Repository is not in 'merging' state - there are no conflicts")
    fmt = args.output_format
    merge_index = MergeIndex.read_from_repo(repo)
    # label -> None: a conflict's versions are read only where they are shown
    unresolved = _filter_conflicts(
        dict.fromkeys(label for label in merge_index.conflicts
                      if label not in merge_index.resolves),
        args.filters,
    )
    if fmt == "quiet":
        return 1 if unresolved else 0
    body = _build_conflicts_output(repo, merge_index.conflicts, unresolved, fmt,
                                   summarise=args.summarise, flat=args.flat,
                                   target_crs=args.target_crs)
    if fmt == "json":
        dump_json_output({"kart.conflicts/v1": body}, "-", json_style=args.json_style)
    elif fmt == "geojson":
        dump_json_output(body, "-", json_style=args.json_style)
    else:
        text = _conflicts_json_as_text(body)
        if text:
            print(text)
    if args.exit_code:
        return 1 if unresolved else 0
    return 0


# --- resolve -----------------------------------------------------------------

def run_resolve(args, repo, device):
    from kart_tpu_torch.merge.index import MergeIndex

    if not args.with_version and not args.with_file:
        raise _CliError("Must supply either --with or --with-file")
    if args.with_version and args.with_file:
        raise _CliError("--with and --with-file are mutually exclusive")
    if repo.state != KartRepoState.MERGING:
        raise _CliError("Repository is not in 'merging' state")
    merge_index = MergeIndex.read_from_repo(repo)
    label = args.label
    if label not in merge_index.conflicts:
        known = ", ".join(sorted(merge_index.conflicts)[:5])
        raise _CliError(f"No such conflict {label!r}. Known conflicts: {known} ...")
    if label in merge_index.resolves:
        raise _CliError(f"Conflict {label!r} is already resolved")
    aot = merge_index.conflicts[label]
    if args.with_file:
        entries = _entries_from_file(repo, aot, args.with_file)
    elif args.with_version == "delete":
        entries = []
    else:
        entry = aot.get(args.with_version)
        entries = [entry] if entry is not None else []
    merge_index.add_resolve(label, entries)
    merge_index.write_to_repo(repo)
    remaining = len(merge_index.unresolved_labels)
    print(f"Resolved 1 conflict. {remaining} conflicts to go." if remaining
          else 'Resolved 1 conflict. All conflicts resolved - run "kart merge --continue"')
    return 0


def _entries_from_file(repo, aot, path):
    """A GeoJSON Feature or FeatureCollection -> the resolution's entries:
    each feature encoded into the conflict's dataset (properties, the
    geometry into its geometry column, the id as the pk when the
    properties lack it) and written as a blob."""
    from kart_tpu_torch.core.structure import RepoStructure
    from kart_tpu_torch.geometry import geojson_to_geometry
    from kart_tpu_torch.merge.index import ConflictEntry

    with open(path) as f:
        data = json.load(f)
    if data.get("type") == "FeatureCollection":
        geo_features = data["features"]
    elif data.get("type") == "Feature":
        geo_features = [data]
    else:
        raise _CliError(f"{path}: not a GeoJSON Feature or FeatureCollection")
    sample = next((e for e in aot if e is not None), None)
    ds_path, part, _item = RepoStructure(repo, "HEAD").decode_path(sample.path)
    if part != "feature":
        raise _CliError("--with-file can only resolve feature conflicts")
    merge_head = repo.read_gitdir_file("MERGE_HEAD")
    ds = None
    for refish in ("HEAD", merge_head and merge_head.strip()):
        if refish:
            ds = RepoStructure(repo, refish).datasets.get(ds_path)
            if ds is not None:
                break
    if ds is None:
        raise _CliError(f"Cannot find dataset {ds_path!r}")
    entries = []
    for geo_feature in geo_features:
        feature = dict(geo_feature.get("properties") or {})
        geom_col = ds.geom_column_name
        if geom_col and geo_feature.get("geometry") is not None:
            feature[geom_col] = geojson_to_geometry(geo_feature["geometry"])
        for pk_col in (c.name for c in ds.schema.pk_columns):
            if pk_col not in feature and geo_feature.get("id") is not None:
                feature[pk_col] = geo_feature["id"]
        full_path, blob = ds.encode_feature(feature)
        entries.append(ConflictEntry(full_path, repo.odb.write_blob(blob)))
    return entries
