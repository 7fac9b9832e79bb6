"""``kart diff``: changes between two commits.

Counterpart of kart_tpu's ``cli/diff_cmds.py`` ``diff`` command with its
option names and defaults (``-o/--output-format``, ``--output``,
``--json-style``, ``--exit-code``, ARGS) for the formats this port
writes: json, json-lines, quiet and feature-count. The other formats
(text, the default, geojson, html), ``--crs`` and
``--only-feature-count`` are not ported.
"""

from kart_tpu_torch.diff.writers import OUTPUT_FORMATS, BaseDiffWriter


def add_parser(commands):
    p = commands.add_parser(
        "diff",
        help="Show changes between commits",
        description="ARGS: an optional commit spec (A..B or A...B) followed by "
        "optional dataset[:pk] filters.",
    )
    p.add_argument("-o", "--output-format", choices=OUTPUT_FORMATS, default="text")
    p.add_argument("--output", dest="output_path", default="-",
                   help="Output file (- for stdout)")
    p.add_argument("--json-style", choices=["extracompact", "compact", "pretty"],
                   default="pretty")
    p.add_argument("--exit-code", action="store_true",
                   help="Exit 1 when there are differences, 0 otherwise")
    p.add_argument("args", nargs="*")
    p.set_defaults(run=run)


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


def run(args, repo, device):
    commit_spec, filters = split_diff_args(repo, args.args)
    writer_class = BaseDiffWriter.get_diff_writer_class(args.output_format)
    writer = writer_class(repo, commit_spec, filters, args.output_path,
                          json_style=args.json_style, device=device)
    try:
        has_changes = writer.write_diff()
    finally:
        writer.close()
    if args.exit_code or args.output_format == "quiet":
        return 1 if has_changes else 0
    return 0
