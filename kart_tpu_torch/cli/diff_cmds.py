"""``kart diff``, ``kart show`` and ``kart create-patch``.

Counterpart of kart_tpu's ``cli/diff_cmds.py`` ``diff``, ``show`` and
``create-patch`` commands, with their option names, defaults and messages:
every output format (text by default, json, json-lines, geojson, html,
quiet, feature-count), ``--crs`` (any CRS, geographic or projected), ``--exit-code`` and
``--only-feature-count`` (the sampled estimate, one counts-only K1 launch
a dataset on the card). ``kart log`` and ``kart apply`` are not ported.
"""

import sys

from kart_tpu_torch.cli.parser import Argument, Command, Option
from kart_tpu_torch.diff.estimation import ACCURACY_CHOICES
from kart_tpu_torch.diff.output import dump_json_output
from kart_tpu_torch.diff.writers import OUTPUT_FORMATS, BaseDiffWriter, JsonDiffWriter

JSON_STYLES = ["extracompact", "compact", "pretty"]


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
