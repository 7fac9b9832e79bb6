"""``kart branch``: list, create (at a start point) and delete branches.

Counterpart of kart_tpu's ``cli/ref_cmds.py`` ``branch`` command, with its
options, outputs and messages; its ``tag``, ``config``, ``gc`` and
``fsck`` are not ported.
"""

import sys

from kart_tpu_torch.cli.parser import Argument, Command, Option
from kart_tpu_torch.core.repo import InvalidOperation
from kart_tpu_torch.diff.output import dump_json_output

INVALID_ARGUMENT = 2


class _CliError(Exception):
    """A refused command: ``Error: <message>`` on stderr, exit 2."""


def commands():
    return [Command("branch", [
        Option("-d", "--delete", dest="delete_branch", help="Delete this branch"),
        Option("-f", "--force", dest="force", kind="flag"),
        Option("--output-format", "-o", dest="output_format", choices=["text", "json"],
               default="text"),
        Argument("name", required=False),
        Argument("start_point", required=False, default="HEAD"),
    ], run_branch, help="List, create or delete branches.")]


def run_branch(args, repo, device):
    try:
        return _branch(args, repo)
    except _CliError as e:
        print(f"Error: {e}", file=sys.stderr)
        return INVALID_ARGUMENT


def _branch(args, repo):
    if args.delete_branch:
        ref = f"refs/heads/{args.delete_branch}"
        if not repo.refs.exists(ref):
            raise _CliError(f"No such branch: {args.delete_branch}")
        if repo.head_branch == ref:
            raise InvalidOperation(f"Cannot delete the current branch {args.delete_branch}")
        if not args.force:
            oid = repo.refs.get(ref)
            head = repo.head_commit_oid
            if head and not repo.is_ancestor(oid, head):
                raise InvalidOperation(f"Branch {args.delete_branch} is not fully merged — "
                                       f"use -f to delete anyway")
        repo.refs.delete(ref)
        print(f"Deleted branch {args.delete_branch}")
        return 0
    if args.name:
        oid, _ = repo.resolve_refish(args.start_point)
        ref = f"refs/heads/{args.name}"
        if repo.refs.exists(ref) and not args.force:
            raise InvalidOperation(f"Branch already exists: {args.name}")
        repo.refs.set(ref, oid, log_message=f"branch: created from {args.start_point}")
        return 0
    current = repo.head_branch
    branches = list(repo.refs.iter_refs("refs/heads/"))
    if args.output_format == "json":
        dump_json_output({"kart.branch/v1": {
            "current": current.rsplit("/", 1)[-1] if current else None,
            "branches": {ref[len("refs/heads/"):]: {"commit": oid, "abbrevCommit": oid[:7]}
                         for ref, oid in branches},
        }}, "-")
        return 0
    for ref, _ in branches:
        print(f"{'*' if ref == current else ' '} {ref[len('refs/heads/'):]}")
    return 0
