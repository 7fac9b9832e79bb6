"""``kart query``: predicate-pushdown scans and the cross-commit spatial
join, the command-line face of :func:`kart_tpu_torch.query.run_query`.

Counterpart of kart_tpu's ``cli/query_cmds.py``: the same options,
metavars, ``-o`` choices and messages, and the same ``{"kart.query/v2":
...}`` document on stdout. A malformed query prints ``Error: <message>``
and exits 2. ``--host`` runs the plain versions on the CPU, as ``--device
cpu`` does.
"""

import sys

from kart_tpu_torch.cli.parser import Argument, Command, Option
from kart_tpu_torch.diff.output import dump_json_output

INVALID_ARGUMENT = 2


class _CliError(Exception):
    """A refused command: ``Error: <message>`` on stderr, exit 2."""


def commands():
    return [
        Command("query", [
            Argument("refish"),
            Argument("dataset"),
            Option("--where", dest="where", metavar="PREDICATE",
                   help="Attribute predicate: AND-joined comparisons, IN lists and "
                        "IS [NOT] NULL tests"),
            Option("--bbox", dest="bbox", metavar="W,S,E,N",
                   help="Spatial predicate (E < W wraps the anti-meridian)"),
            Option("--intersects", dest="intersects", metavar="REFISH:DATASET",
                   help="Spatial join: report DATASET rows whose bbox overlaps any row "
                        "of the named side (two datasets, or two commits of one dataset)"),
            Option("--count-by", dest="count_by", metavar="COLUMN",
                   help="Group the count by one column instead of materialising rows"),
            Option("-o", "--output-format", dest="output_format",
                   choices=["count", "json", "bbox"], default="count"),
            Option("--page", dest="page", integer=True, metavar="INTEGER",
                   help="Page of -o json rows"),
            Option("--page-size", dest="page_size", integer=True, metavar="INTEGER",
                   help="Rows per -o json page (KART_QUERY_PAGE_SIZE)"),
            Option("--host", dest="host_only", kind="flag",
                   help="Run the plain versions on the CPU instead of the card"),
            Option("--approx", dest="approx", kind="flag",
                   help="Stop spatial verdicts at the envelope filter (skip the "
                        "exact-refine stage)"),
        ], run_query_cmd, help="Query one commit: filtered scans, aggregates and spatial joins"),
    ]


def _parse_intersects(text):
    """``<refish>:<dataset>`` (or ``<refish>/<dataset>`` when the refish has
    no slash of its own) -> (refish, ds_path)."""
    if ":" in text:
        refish, _, ds_path = text.partition(":")
    elif "/" in text:
        refish, _, ds_path = text.partition("/")
    else:
        raise _CliError(f"--intersects wants <refish>:<dataset>, got {text!r}")
    if not refish or not ds_path:
        raise _CliError(f"--intersects wants <refish>:<dataset>, got {text!r}")
    return refish, ds_path


def run_query_cmd(args, repo, device):
    from kart_tpu_torch.query import QueryError, run_query

    try:
        join = _parse_intersects(args.intersects) if args.intersects is not None else None
        result = run_query(repo, args.refish, args.dataset, where=args.where, bbox=args.bbox,
                           intersects=join, output=args.output_format, count_by=args.count_by,
                           page=args.page, page_size=args.page_size, approx=args.approx,
                           device="cpu" if args.host_only else device)
    except (_CliError, QueryError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return INVALID_ARGUMENT
    dump_json_output({"kart.query/v2": result}, "-")
    return 0
