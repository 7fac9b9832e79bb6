"""``kart branch`` (list, create at a start point, delete), ``tag`` (list,
create, ``-m`` annotated, ``-d``), ``config`` (get, set, ``--unset``) and
``reflog``.

Counterpart of kart_tpu's ``cli/ref_cmds.py`` commands of those names, with
their options, outputs, messages and exit codes (``config KEY`` of an unset
key prints nothing and exits 1); its ``gc``, ``fsck`` and ``git``
passthrough are not ported.
"""

from kart_tpu_torch.cli.parser import Argument, Command, Option
from kart_tpu_torch.cli.repo_cmds import _CliError, _refusable
from kart_tpu_torch.core.repo import InvalidOperation
from kart_tpu_torch.diff.output import dump_json_output


def commands():
    return [Command("tag", [
        Option("-d", "--delete", dest="delete_tag", help="Delete this tag"),
        Option("-m", "--message", dest="message",
               help="Create an annotated tag with this message"),
        Argument("name", required=False),
        Argument("target", required=False, default="HEAD"),
    ], _refusable(run_tag), help="List, create or delete tags."), Command("config", [
        Argument("key"),
        Argument("value", required=False),
        Option("--unset", dest="unset", kind="flag"),
    ], run_config, help="Get or set repository configuration."), Command("reflog", [
        Argument("ref", required=False, default="HEAD"),
    ], run_reflog, help="Show the log of where REF has pointed (reference: the pass-through "
                        "`kart reflog`, kart/cli.py:211-305)."), Command("branch", [
        Option("-d", "--delete", dest="delete_branch", help="Delete this branch"),
        Option("-f", "--force", dest="force", kind="flag"),
        Option("--output-format", "-o", dest="output_format", choices=["text", "json"],
               default="text"),
        Argument("name", required=False),
        Argument("start_point", required=False, default="HEAD"),
    ], _refusable(run_branch), help="List, create or delete branches.")]


def run_tag(args, repo, device):
    if args.delete_tag:
        ref = f"refs/tags/{args.delete_tag}"
        if not repo.refs.exists(ref):
            raise _CliError(f"No such tag: {args.delete_tag}")
        repo.refs.delete(ref)
        print(f"Deleted tag {args.delete_tag}")
        return 0
    if args.name:
        oid, _ = repo.resolve_refish(args.target)
        repo.create_tag(args.name, oid, message=args.message)
        return 0
    for ref, _ in repo.refs.iter_refs("refs/tags/"):
        print(ref[len("refs/tags/"):])
    return 0


def run_config(args, repo, device):
    if args.unset:
        del repo.config[args.key]
        return 0
    if args.value is not None:
        repo.config.set_many({args.key: args.value})
        return 0
    current = repo.config.get(args.key)
    if current is None:
        return 1
    print(current)
    return 0


def run_reflog(args, repo, device):
    ref, entries = args.ref, []
    # a short name resolves as git's does: heads, then tags, then remotes
    candidates = ([ref] if ref == "HEAD" or ref.startswith("refs/") else
                  [f"refs/heads/{ref}", f"refs/tags/{ref}", f"refs/remotes/{ref}"])
    for candidate in candidates:
        entries = repo.refs.read_reflog(candidate)
        if entries:
            ref = candidate
            break
    if not entries:
        print(f"No reflog for {ref}")
        return 0
    short = ref if ref == "HEAD" else ref.split("/", 2)[-1]
    for i, entry in enumerate(reversed(entries)):
        new = entry.get("new") or "0" * 40
        print(f"{new[:7]} {short}@{{{i}}}: {entry.get('message', '')}")
    return 0


def run_branch(args, repo, device):
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
