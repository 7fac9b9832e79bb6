"""``kart branch`` (list, create at a start point, delete), ``tag`` (list,
create, ``-m`` annotated, ``-d``), ``config`` (get, set, ``--unset``),
``reflog``, and the store's upkeep: ``gc`` (sweep crash leftovers, pack
the loose objects), ``fsck`` (re-hash every object, check refs, leftovers,
datasets, each sidecar against its feature tree and the working copy;
exit 1 on errors) and the ``git`` passthrough.

Counterpart of kart_tpu's ``cli/ref_cmds.py``, with its options, outputs,
messages and exit codes (``config KEY`` of an unset key prints nothing and
exits 1).
"""

import os
import shutil
import subprocess
import sys

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
    ], _refusable(run_branch), help="List, create or delete branches."), Command("gc", [
        Argument("args", nargs=-1),
    ], run_gc, ignore_unknown_options=True,
        help="Clean up the object store: pack loose objects, sweep crash leftovers (stale "
             "``*.tmp``/``*.lock`` files, abandoned push quarantines). ``--auto`` only repacks "
             "above the loose-object threshold; ``--grace=N`` sets the leftover age threshold "
             "in seconds (default 3600, env KART_GC_GRACE); ``--prune-now`` sweeps leftovers "
             "regardless of age."), Command("fsck", [
        Option("--reset-datasets", dest="reset_datasets", kind="flag"),
    ], run_fsck, help="Verify repository integrity: object store, refs, dataset structure, "
                      "working copy sync (reference: kart/fsck.py)."), Command("git", [
        Argument("args", nargs=-1),
    ], _refusable(run_git), ignore_unknown_options=True,
        help="Run a git command against this repository (reference: the raw-git passthrough, "
             "kart/cli.py:211-305). The object store, refs, and packs are git-compatible; the "
             "locked index deliberately stops stock git from touching the working copy.")]


def run_gc(args, repo, device):
    stats = repo.gc(*args.args)
    if stats and (stats.get("packed") or stats.get("pruned")):
        print(f"Packed {stats.get('packed', 0)} loose objects; "
              f"pruned {stats.get('pruned', 0)} temp files.")
    else:
        print("Nothing to do.")
    return 0


def run_fsck(args, repo, device):
    """kart_tpu's checks, in its order and words."""
    import numpy as np

    from kart_tpu_torch.core.objects import hash_object
    from kart_tpu_torch.diff import sidecar
    from kart_tpu_torch.ops.blocks import FeatureBlock

    errors = []
    print("Checking object store...")
    count = 0
    for oid in repo.odb.iter_oids():
        try:
            obj_type, content = repo.odb.read_raw(oid)
            if hash_object(obj_type, content) != oid:
                errors.append(f"Object {oid} content does not match its id")
        except Exception as e:  # every object is checked; each failure is an error line
            errors.append(f"Object {oid} is corrupt: {e}")
        count += 1
    print(f"  {count} objects")

    print("Checking refs...")
    for ref, oid in repo.refs.iter_refs():
        if not repo.odb.contains(oid):
            errors.append(f"Ref {ref} points at missing object {oid}")

    # leftovers are debris, not corruption: reported, and gc sweeps them
    print("Checking for stale crash leftovers...")
    stale = list(repo.find_stale_leftovers())
    if stale:
        print(f"  {len(stale)} stale lock/temp leftover(s) from a crashed process — run "
              f"`kart gc` to sweep:")
        for path in stale[:5]:
            print(f"    {os.path.relpath(path, repo.gitdir)}")
        if len(stale) > 5:
            print(f"    ... and {len(stale) - 5} more")

    if not repo.head_is_unborn:
        print("Checking datasets...")
        for ds in repo.datasets():
            try:
                ds.schema
                print(f"  {ds.path}: {ds.feature_count} features")
            except Exception as e:
                errors.append(f"Dataset {ds.path} is corrupt: {e}")

    # a sidecar must hold its feature tree's (key, oid) columns exactly: a
    # wrong one would silently wrong every columnar diff
    if not repo.head_is_unborn:
        print("Checking columnar sidecars...")
        for ds in repo.datasets():
            try:
                if ds.feature_tree is None or not sidecar.has_sidecar(repo, ds):
                    continue
                block = sidecar.load_block(repo, ds)
                tree_block = FeatureBlock.from_dataset(ds, pad=False)
                ok = (block is not None and block.count == tree_block.count
                      and np.array_equal(block.keys[: block.count],
                                         tree_block.keys[: tree_block.count])
                      and np.array_equal(block.oids[: block.count],
                                         tree_block.oids[: tree_block.count]))
                if ok:
                    print(f"  {ds.path}: sidecar OK ({block.count} rows)")
                else:
                    errors.append(f"Dataset {ds.path}: columnar sidecar does not match the "
                                  f"feature tree")
            except Exception as e:
                errors.append(f"Dataset {ds.path}: sidecar check failed: {e}")

    wc = repo.working_copy
    if wc is not None:
        print("Checking working copy...")
        tree, head_tree = wc.get_db_tree(), repo.head_tree_oid
        if tree != head_tree:
            errors.append(f"Working copy tree {tree} does not match HEAD tree {head_tree}")

    if errors:
        for e in errors:
            print(f"error: {e}", file=sys.stderr)
        return 1
    print("No errors found.")
    return 0


def run_git(args, repo, device):
    git_bin = shutil.which("git")
    if git_bin is None:
        raise _CliError("git is not installed on this system")
    env = dict(os.environ, GIT_DIR=repo.gitdir)
    if repo.workdir is not None:
        env["GIT_WORK_TREE"] = repo.workdir
    sys.stdout.flush()
    return subprocess.run([git_bin, *args.args], env=env).returncode


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
