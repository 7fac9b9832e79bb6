"""``kart data ls|version``, ``kart meta get|set``, ``kart commit-files``
and ``kart build-annotations``.

Counterpart of kart_tpu's ``cli/data_cmds.py``, with its options, outputs,
messages and exit codes (a refused command prints ``Error: <message>`` and
exits 2). ``data`` and ``meta`` are groups whose help and usage errors are
click's. ``meta set`` commits a meta diff through
:meth:`~kart_tpu_torch.core.structure.RepoStructure.commit_diff`, and
``commit-files`` writes repository files through a tree builder; when the
commit moves HEAD, each then moves the working copy to it without
``--force`` (a K1 diff of the two trees on the CLI's device), keeping its
edits.
``build-annotations`` counts the feature changes of HEAD's history into
the annotations cache (:meth:`kart_tpu_torch.annotations.DiffAnnotations
.build_all`), each commit diffed against its first parent on the CLI's
device; the other commands are host work.
"""

import json
import sys

from kart_tpu_torch.cli.parser import Argument, Command, Group, Option
from kart_tpu_torch.core.repo import KartRepoState
from kart_tpu_torch.diff.output import dump_json_output
from kart_tpu_torch.workingcopy import get_working_copy

INVALID_ARGUMENT = 2


class _CliError(Exception):
    """A refused command: ``Error: <message>`` on stderr, exit 2."""


def commands():
    output_format = Option("--output-format", "-o", dest="output_format",
                           choices=["text", "json"], default="text")
    data = Group("data", [], {
        "ls": Command("ls", [
            output_format,
            Option("--with-dataset-types", dest="with_dataset_types", kind="flag"),
            Argument("refish", required=False, default="HEAD"),
        ], _refusable(run_data_ls), help="List datasets."),
        "version": Command("version", [output_format], run_data_version,
                           help="Show the repository structure version."),
    }, help="Information about the datasets in the repository.")
    meta = Group("meta", [], {
        "get": Command("get", [
            output_format,
            Option("--ref", dest="ref", default="HEAD"),
            Argument("dataset"),
            Argument("keys", nargs=-1),
        ], _refusable(run_meta_get), help="Print meta items for a dataset."),
        "set": Command("set", [
            Option("--message", "-m", dest="message", help="Commit message"),
            Argument("dataset"),
            Argument("assignments", nargs=-1, required=True),
        ], _refusable(run_meta_set),
            help="Commit changes to meta items: kart meta set DATASET key=value ..."),
    }, help="Read and update metadata for datasets.")
    return [
        data,
        meta,
        Command("commit-files", [
            Option("--message", "-m", dest="message", required=True, help="Commit message"),
            Option("--ref", dest="ref", default="HEAD", help="Branch/ref to commit to"),
            Option("--allow-empty", dest="allow_empty", kind="flag",
                   help="Commit even with no changes"),
            Option("--remove-empty-files", dest="remove_empty_files", kind="flag",
                   help="KEY= (empty value) removes the file instead of writing it empty"),
            Argument("items", nargs=-1, required=True),
        ], _refusable(run_commit_files),
            help="Commit arbitrary repository files: kart commit-files -m MSG KEY=VALUE... "
                 "(VALUE may be @filename)."),
        Command("build-annotations", [
            Option("--all-reachable", dest="all_reachable", kind="flag"),
        ], run_build_annotations, help="Pre-compute diff feature-count annotations for commits."),
    ]


def _refusable(fn):
    def run(args, repo, device):
        try:
            return fn(args, repo, device)
        except _CliError as e:
            print(f"Error: {e}", file=sys.stderr)
            return INVALID_ARGUMENT
    return run


def run_data_ls(args, repo, device):
    datasets = [] if repo.head_is_unborn else list(repo.structure(args.refish).datasets)
    paths = [ds.path for ds in datasets]
    if args.output_format == "json":
        if args.with_dataset_types:
            dump_json_output({"kart.data.ls/v2": [
                {"path": ds.path, "type": "table", "version": ds.VERSION} for ds in datasets
            ]}, "-")
        else:
            dump_json_output({"kart.data.ls/v1": paths}, "-")
        return 0
    if not paths:
        print("Empty repository.", file=sys.stderr)
        print('  (use "kart import" to add some data)', file=sys.stderr)
        return 0
    for p in paths:
        print(p)
    return 0


def run_data_version(args, repo, device):
    if args.output_format == "json":
        dump_json_output({"repostructure.version": repo.version,
                          "localconfig.branding": "kart"}, "-")
    else:
        print(f"This Kart repo uses Datasets v{repo.version}")
    return 0


def run_meta_get(args, repo, device):
    ds = repo.structure(args.ref).datasets.get(args.dataset)
    if ds is None:
        raise _CliError(f"No dataset {args.dataset!r} at {args.ref}")
    items = ds.meta_items()
    if args.keys:
        missing = [k for k in args.keys if k not in items]
        if missing:
            raise _CliError(f"Couldn't find items: {', '.join(missing)}")
        items = {k: items[k] for k in args.keys}
    if args.output_format == "json":
        dump_json_output({args.dataset: items}, "-")
        return 0
    bold = sys.stdout.isatty()  # click.secho(bold=True): styled on a terminal only
    for name, value in items.items():
        print(f"\x1b[1m{name}\x1b[0m" if bold else name)
        print(json.dumps(value, indent=2) if isinstance(value, (dict, list)) else str(value))
        print()
    return 0


def run_meta_set(args, repo, device):
    from kart_tpu_torch.diff.structs import DatasetDiff, Delta, DeltaDiff, KeyValue, RepoDiff

    structure = repo.structure("HEAD")
    ds = structure.datasets.get(args.dataset)
    if ds is None:
        raise _CliError(f"No dataset {args.dataset!r}")
    items = ds.meta_items()
    meta_diff = DeltaDiff()
    for assignment in args.assignments:
        if "=" not in assignment:
            raise _CliError(f"Expected key=value, got {assignment!r}")
        key, _, value = assignment.partition("=")
        if value.startswith("@"):
            with open(value[1:]) as f:
                value = f.read()
        if key.endswith(".json"):
            value = json.loads(value)
        old = items.get(key)
        meta_diff.add_delta(Delta(KeyValue((key, old)) if old is not None else None,
                                  KeyValue((key, value))))
    ds_diff = DatasetDiff()
    ds_diff["meta"] = meta_diff
    repo_diff = RepoDiff()
    repo_diff[args.dataset] = ds_diff
    oid = structure.commit_diff(repo_diff, args.message or f"Update metadata for {args.dataset}")
    wc = get_working_copy(repo, device=device)
    if wc is not None:
        # non-force: only the dataset whose meta changed is written again,
        # edits elsewhere stay
        wc.reset(repo.structure(oid))
    print(f"Commit {oid[:7]}")
    return 0


def run_commit_files(args, repo, device):
    from kart_tpu_torch.core.tree_builder import TreeBuilder

    if repo.state != KartRepoState.NORMAL:
        raise _CliError(KartRepoState.bad_state_message(repo.state, (KartRepoState.NORMAL,)))
    parent_oid, ref_name = repo.resolve_refish(args.ref)
    if parent_oid is None:
        raise _CliError("Using commit-files to create the initial commit is not supported")
    # only HEAD or a branch moves: never a tag or a remote-tracking ref
    commit_to = "HEAD" if args.ref == "HEAD" else ref_name
    if commit_to is None or (commit_to != "HEAD" and not commit_to.startswith("refs/heads/")):
        raise _CliError(f"{args.ref!r} is not a branch that can be committed to")
    moves_head = commit_to == "HEAD" or repo.head_branch == commit_to
    parent = repo.odb.read_commit(parent_oid)
    tb = TreeBuilder(repo.odb, parent.tree)
    for item in args.items:
        if "=" not in item:
            raise _CliError(f"Expected KEY=VALUE, got {item!r}")
        key, _, value = item.partition("=")
        if not key or any(seg in ("", ".", "..") for seg in key.split("/")):
            raise _CliError(f"Invalid repository path: {key!r}")
        if value.startswith("@"):
            try:
                with open(value[1:], "rb") as f:
                    data = f.read()
            except OSError as e:
                raise _CliError(f"Cannot read {value[1:]!r}: {e}")
        else:
            data = value.encode()
        if args.remove_empty_files and not data:
            tb.remove(key)
        else:
            tb.insert(key, repo.odb.write_blob(data))
    new_tree = tb.flush()
    if new_tree == parent.tree and not args.allow_empty:
        raise _CliError("No changes to commit")
    new_commit = repo.create_commit(commit_to, new_tree, args.message, [parent_oid])
    wc = get_working_copy(repo, device=device) if moves_head else None
    if wc is not None:
        wc.reset(repo.structure(new_commit))  # non-force: the copy's edits stay
    print(f"Committed {new_commit[:7]}")
    return 0


def run_build_annotations(args, repo, device):
    from kart_tpu_torch.annotations import DiffAnnotations

    built = DiffAnnotations(repo).build_all(all_reachable=args.all_reachable, device=device)
    print(f"Built annotations for {built} commit(s)")
    return 0
