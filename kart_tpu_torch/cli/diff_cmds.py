"""``kart diff``, ``kart show``, ``kart create-patch`` and ``kart log``.

Counterpart of kart_tpu's ``cli/diff_cmds.py`` ``diff``, ``show``,
``create-patch`` and ``log`` commands, with their option names, defaults
and messages: every output format (text by default, json, json-lines,
geojson, html, quiet, feature-count), ``--crs`` (any CRS, geographic or
projected), ``--exit-code`` and ``--only-feature-count`` (the sampled
estimate, one counts-only K1 launch a dataset on the card). ``log`` walks
the history in committer-date order with every option of kart_tpu's
(formats, ``--oneline``, ``--graph``, date, author, committer, message,
count and first-parent limits, dataset and feature filters,
``--with-dataset-changes`` and ``--with-feature-count``); each commit it
diffs against its first parent goes through the engine on the CLI's
device (one K1 launch when both revisions have sidecars). ``kart apply``
is not ported.
"""

import json
import re
import sys
import time
from datetime import datetime, timedelta, timezone

from kart_tpu_torch.cli.parser import Argument, Command, Option
from kart_tpu_torch.diff.estimation import ACCURACY_CHOICES
from kart_tpu_torch.diff.output import dump_json_output
from kart_tpu_torch.diff.writers import OUTPUT_FORMATS, BaseDiffWriter, JsonDiffWriter

JSON_STYLES = ["extracompact", "compact", "pretty"]

INVALID_ARGUMENT = 2


class _CliError(Exception):
    """A refused command: ``Error: <message>`` on stderr, exit 2."""


def commands():
    json_style = Option("--json-style", dest="json_style", choices=JSON_STYLES,
                        default="pretty")
    return [
        Command("diff", [
            Option("--output-format", "-o", dest="output_format", choices=OUTPUT_FORMATS,
                   default="text"),
            Option("--output", dest="output_path", default="-",
                   help="Output file (- for stdout)"),
            json_style,
            Option("--crs", dest="target_crs", help="Reproject geometries to this CRS for output"),
            Option("--exit-code", dest="exit_code", kind="flag",
                   help="Exit 1 when there are differences, 0 otherwise"),
            Option("--only-feature-count", dest="only_feature_count", choices=ACCURACY_CHOICES,
                   help="Skip the diff; print an estimated changed-feature count per dataset "
                        "at the given accuracy"),
            Argument("args", nargs=-1),
        ], run_diff, help="Show changes between commits"),
        Command("show", [
            Option("--output-format", "-o", dest="output_format", choices=OUTPUT_FORMATS,
                   default="text"),
            json_style,
            Option("--crs", dest="target_crs", help="Reproject geometries for output"),
            Argument("refish", required=False, default="HEAD"),
            Argument("filters", nargs=-1),
        ], run_show, help="Show the changes introduced by a commit"),
        Command("create-patch", [
            json_style,
            Option("--patch-type", dest="patch_type", choices=["full", "minimal"],
                   default="full",
                   help="minimal patches omit unchanged old values (needs the base commit "
                        "to apply)"),
            Option("--output", dest="output_path", default="-"),
            Argument("refish"),
        ], run_create_patch, help="Write a JSON patch of the changes introduced by a commit"),
        Command("log", [
            Option("--output-format", "-o", dest="output_format",
                   choices=["text", "json", "json-lines"], default="text"),
            Option("--oneline", dest="oneline", kind="flag"),
            Option("-n", "--max-count", dest="max_count", integer=True),
            Option("--skip", dest="skip", integer=True, help="Skip this many commits first"),
            Option("--since", "--after", dest="since", help="Only commits after this date"),
            Option("--until", "--before", dest="until", help="Only commits before this date"),
            Option("--author", dest="author", kind="multiple",
                   help="Only commits by this author (regex, repeatable)"),
            Option("--committer", dest="committer", kind="multiple",
                   help="Only commits by this committer (regex, repeatable)"),
            Option("--grep", dest="grep", kind="multiple",
                   help="Only commits whose message matches (regex, repeatable)"),
            Option("--graph", dest="graph", kind="flag",
                   help="Draw an ASCII commit graph (text output)"),
            Option("--first-parent", dest="first_parent", kind="flag",
                   help="Follow only first parents at merges"),
            Option("--with-dataset-changes", dest="dataset_changes", kind="flag",
                   help="List the datasets changed by each commit"),
            Option("--with-feature-count", dest="feature_count_accuracy",
                   choices=list(ACCURACY_CHOICES),
                   help="Add a featureChanges count per dataset to JSON output at the given "
                        "estimation accuracy"),
            json_style,
            Argument("refish", required=False, default="HEAD"),
            Argument("filters", nargs=-1),
        ], run_log, help="Show the commit log."),
    ]


def split_diff_args(repo, args):
    """The first arg is the commit spec if it contains '..' or resolves;
    the rest are filters."""
    from kart_tpu_torch.core.repo import NotFound

    args = list(args)
    if not args:
        return "HEAD", []
    first = args[0]
    if ".." in first:
        return first, args[1:]
    try:
        repo.resolve_refish(first.split("...")[0])
        return first, args[1:]
    except NotFound:
        return "HEAD", args


def _write(writer):
    try:
        return writer.write_diff()
    finally:
        writer.close()


def run_diff(args, repo, device):
    commit_spec, filters = split_diff_args(repo, args.args)
    if args.only_feature_count:
        has_changes = print_estimated_counts(repo, commit_spec, args.only_feature_count,
                                             args.output_format, args.output_path, filters,
                                             device=device)
        return (1 if has_changes else 0) if args.exit_code else 0
    writer_class = BaseDiffWriter.get_diff_writer_class(args.output_format)
    has_changes = _write(writer_class(repo, commit_spec, filters, args.output_path,
                                      json_style=args.json_style, device=device,
                                      target_crs=args.target_crs))
    if args.exit_code or args.output_format == "quiet":
        return 1 if has_changes else 0
    return 0


def print_estimated_counts(repo, commit_spec, accuracy, output_format, output_path,
                           filters=(), device=None):
    """``kart diff --only-feature-count``: -> True when a dataset changed."""
    from kart_tpu_torch.diff.estimation import estimate_diff_feature_counts

    base_rs, target_rs = BaseDiffWriter.parse_diff_commit_spec(repo, commit_spec)
    wanted = {f.split(":", 1)[0] for f in filters} if filters else None
    counts = estimate_diff_feature_counts(repo, base_rs, target_rs, accuracy=accuracy,
                                          ds_paths=wanted, device=device)
    if output_format == "json":
        fp = dump_json_output({"kart.diff/v1+feature-count": counts}, output_path)
        if fp is not sys.stdout:
            fp.close()
    else:
        text = "\n".join(f"{ds_path}:\n\t{count} features changed"
                         for ds_path, count in sorted(counts.items()))
        if output_path and output_path != "-":
            with open(output_path, "w") as f:
                f.write(text + "\n")
        elif text:
            print(text)
    return any(counts.values())


class _CommitForShow:
    def __init__(self, oid, commit):
        self.oid = oid
        self.author = commit.author
        self.message = commit.message


def _commit_and_spec(repo, refish):
    """-> (the commit to show, ``<oid>^?...<oid>``: its first parent, or the
    empty revision for a root commit, to it)."""
    oid, _ = repo.resolve_refish(refish)
    return _CommitForShow(oid, repo.odb.read_commit(oid)), f"{oid}^?...{oid}"


def run_show(args, repo, device):
    commit, spec = _commit_and_spec(repo, args.refish)
    writer_class = BaseDiffWriter.get_diff_writer_class(args.output_format)
    _write(writer_class(repo, spec, args.filters, "-", json_style=args.json_style,
                        device=device, target_crs=args.target_crs, commit=commit))
    return 0


def run_create_patch(args, repo, device):
    commit, spec = _commit_and_spec(repo, args.refish)
    _write(JsonDiffWriter(repo, spec, (), args.output_path, json_style=args.json_style,
                          device=device, commit=commit, patch_type=args.patch_type,
                          include_patch_header=True))
    return 0


# --- kart log ----------------------------------------------------------------

def _parse_log_date(value, option):
    """A date argument -> unix time: ISO 8601 (``2024-01-02``,
    ``2024-01-02T03:04:05+01:00``; without a zone, local time), a unix
    epoch (``@1700000000``, or nine or more bare digits), or ``<n>
    <unit>[s] ago`` (seconds to years)."""
    text = value.strip()
    if text.startswith("@") and text[1:].isdigit():
        return int(text[1:])
    if text.isdigit() and len(text) >= 9:  # a bare epoch, not a year
        return int(text)
    m = re.fullmatch(r"(\d+)\s+(second|minute|hour|day|week|month|year)s?\s+ago", text)
    if m:
        unit_s = {"second": 1, "minute": 60, "hour": 3600, "day": 86400,
                  "week": 7 * 86400, "month": 30 * 86400, "year": 365 * 86400}[m.group(2)]
        return int(time.time()) - int(m.group(1)) * unit_s
    try:
        dt = datetime.fromisoformat(text)
    except ValueError:
        raise _CliError(f"Cannot parse {option} date {value!r}: use ISO 8601, a unix "
                        f"epoch, or '<n> days ago'") from None
    if dt.tzinfo is None:
        dt = dt.astimezone()
    return int(dt.timestamp())


def _effective_parents(oid, parent_map, displayed):
    """The parents of ``oid`` moved to their nearest displayed ancestors,
    so that the graph opens no lane for a commit it will not draw."""
    out, seen = [], set()
    stack = list(parent_map.get(oid, ()))
    while stack:
        p = stack.pop(0)
        if p in seen:
            continue
        seen.add(p)
        if p in displayed:
            if p not in out:
                out.append(p)
        else:
            stack.extend(parent_map.get(p, ()))
    return out


def _graph_rows(entries, parent_map):
    """``git log --graph``'s lanes: -> [(prefix, oid, commit)], with
    ``(prefix, None, None)`` rows where a merge forks a lane. A lane holds
    the next commit it expects; a commit closes every lane expecting it
    and opens one for each further displayed parent."""
    displayed = {oid for oid, _ in entries}
    lanes, rows = [], []
    for oid, commit in entries:
        if oid not in lanes:
            lanes.append(oid)
        idx = lanes.index(oid)
        rows.append((" ".join("*" if i == idx else "|" for i in range(len(lanes))), oid,
                     commit))
        for i in reversed([i for i, lane in enumerate(lanes) if lane == oid and i != idx]):
            lanes.pop(i)
        parents = _effective_parents(oid, parent_map, displayed)
        if not parents:
            lanes.pop(idx)
            continue
        lanes[idx] = parents[0]
        for extra in parents[1:]:
            if extra not in lanes:
                lanes.insert(idx + 1, extra)
                rows.append((" ".join("|\\"[min(i - idx, 1)] if idx <= i <= idx + 1 else "|"
                                      for i in range(len(lanes))), None, None))
    return rows


def _iso_utc(ts):
    return datetime.fromtimestamp(ts, timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def _iso_tz(minutes):
    sign = "+" if minutes >= 0 else "-"
    return f"{sign}{abs(minutes) // 60:02d}:{abs(minutes) % 60:02d}"


def _commit_json(oid, commit):
    """kart's JSON form of a commit: UTC times, each zone beside it."""
    author, committer = commit.author, commit.committer
    return {
        "commit": oid,
        "abbrevCommit": oid[:7],
        "message": commit.message,
        "refs": [],
        "authorName": author.name,
        "authorEmail": author.email,
        "authorTime": _iso_utc(author.time),
        "authorTimeOffset": _iso_tz(author.offset),
        "committerEmail": committer.email,
        "committerName": committer.name,
        "commitTime": _iso_utc(committer.time),
        "commitTimeOffset": _iso_tz(committer.offset),
        "parents": list(commit.parents),
        "abbrevParents": [p[:7] for p in commit.parents],
    }


def _log_start(repo, refish, filters):
    """-> (the walk's first commit or None, the filters): a first argument
    that is no revision but names a dataset at HEAD (``points``,
    ``points:feature:3``) is a filter; anything else that does not resolve
    is refused."""
    from kart_tpu_torch.core.repo import NotFound

    try:
        return repo.resolve_refish(refish)[0], filters
    except NotFound:
        if refish == "HEAD":
            return None, filters
    try:
        start = repo.resolve_refish("HEAD")[0]
        known = set(repo.structure("HEAD").datasets.paths())
    except NotFound:
        start, known = None, set()
    if refish.split(":", 1)[0] not in known:
        raise _CliError(f"No such revision or dataset: {refish}")
    return start, (refish, *filters)


def run_log(args, repo, device):
    try:
        return _run_log(args, repo, device)
    except _CliError as e:
        print(f"Error: {e}", file=sys.stderr)
        return INVALID_ARGUMENT


def _run_log(args, repo, device):
    from kart_tpu_torch.diff.engine import get_repo_diff
    from kart_tpu_torch.diff.estimation import estimate_diff_feature_counts
    from kart_tpu_torch.diff.key_filters import RepoKeyFilter

    start, filters = _log_start(repo, args.refish, args.filters)
    if start is None:
        return 0
    since_ts = _parse_log_date(args.since, "--since") if args.since else None
    until_ts = _parse_log_date(args.until, "--until") if args.until else None
    author_res = [re.compile(a) for a in args.author]
    committer_res = [re.compile(c) for c in args.committer]
    grep_res = [re.compile(g) for g in args.grep]
    key_filter = RepoKeyFilter.build_from_user_patterns(filters)

    def structure(oid):
        return repo.structure(oid) if oid else None

    def touched_datasets(oid, commit):
        parent = commit.parents[0] if commit.parents else None
        diff = get_repo_diff(structure(parent), repo.structure(oid), repo_key_filter=key_filter,
                             device=device)
        return sorted(diff.keys()) if diff else []

    entries, parent_map = [], {}
    count = skipped = 0
    for oid, commit in repo.walk_commits(start, first_parent=args.first_parent):
        parent_map[oid] = commit.parents[:1] if args.first_parent else commit.parents
        if args.max_count is not None and count >= args.max_count:
            break
        when = commit.committer.time
        if (until_ts is not None and when > until_ts) or (
                since_ts is not None and when < since_ts):
            continue
        sig = f"{commit.author.name} <{commit.author.email}>"
        if author_res and not any(r.search(sig) for r in author_res):
            continue
        csig = f"{commit.committer.name} <{commit.committer.email}>"
        if committer_res and not any(r.search(csig) for r in committer_res):
            continue
        if grep_res and not any(r.search(commit.message) for r in grep_res):
            continue
        changed = None
        if not key_filter.match_all:
            changed = touched_datasets(oid, commit)
            if not changed:
                continue
        if args.skip is not None and skipped < args.skip:
            skipped += 1
            continue
        if args.dataset_changes and changed is None:
            changed = touched_datasets(oid, commit)  # displayed commits only
        entries.append((oid, commit, changed))
        count += 1

    if args.output_format in ("json", "json-lines"):
        ds_paths = {f.split(":", 1)[0] for f in filters} if filters else None
        out = []
        for oid, commit, changed in entries:
            item = _commit_json(oid, commit)
            if args.dataset_changes:
                item["datasetChanges"] = changed
            if args.feature_count_accuracy:
                parent = commit.parents[0] if commit.parents else None
                item["featureChanges"] = estimate_diff_feature_counts(
                    repo, structure(parent), repo.structure(oid),
                    accuracy=args.feature_count_accuracy, ds_paths=ds_paths, device=device)
            out.append(item)
        if args.output_format == "json":
            dump_json_output(out, "-", json_style=args.json_style)
        else:
            for item in out:
                sys.stdout.write(json.dumps(item, separators=(",", ":")) + "\n")
        return 0

    if args.graph:
        changed_by_oid = {oid: ch for oid, _, ch in entries}
        for prefix, oid, commit in _graph_rows([(o, c) for o, c, _ in entries], parent_map):
            if oid is None:
                print(prefix)
                continue
            suffix = ""
            if args.dataset_changes and changed_by_oid.get(oid):
                suffix = f"  ({', '.join(changed_by_oid[oid])})"
            print(f"{prefix} {oid[:7]} {commit.message_summary}{suffix}")
        return 0

    for oid, commit, changed in entries:
        if args.oneline:
            suffix = f"  ({', '.join(changed)})" if args.dataset_changes and changed else ""
            print(f"{oid[:7]} {commit.message_summary}{suffix}")
            continue
        tz = timezone(timedelta(minutes=commit.author.offset))
        when = datetime.fromtimestamp(commit.author.time, timezone.utc).astimezone(tz)
        header = f"commit {oid}"
        # click.secho(fg="yellow"): colour on a terminal only
        print(f"\x1b[33m{header}\x1b[0m" if sys.stdout.isatty() else header)
        print(f"Author: {commit.author.name} <{commit.author.email}>")
        print(f"Date:   {when.strftime('%a %b %d %H:%M:%S %Y %z')}")
        if args.dataset_changes and changed:
            print(f"Datasets: {', '.join(changed)}")
        print()
        for line in commit.message.splitlines():
            print(f"    {line}")
        print()
    return 0
