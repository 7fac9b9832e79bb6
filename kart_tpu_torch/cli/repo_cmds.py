"""``kart init``, ``import``, ``commit``, ``status``, ``checkout``,
``switch``, ``restore``, ``reset`` and ``create-workingcopy``: getting data
into a repository and editing it through its GeoPackage working copy.

Counterpart of kart_tpu's ``cli/repo_cmds.py``, with its options, outputs,
messages and exit codes (a refused command prints ``Error: <message>`` and
exits 2; an import source that cannot be read exits 48). ``init`` needs no
repository. ``status``, ``diff`` and ``commit`` read only the working
copy's tracked rows (host work); ``checkout -b``, ``switch -c`` and
``reset``/``checkout`` without a revision move the working copy without
``--force`` by diffing its tree against the target's (kernel K1 on the
CLI's device, one launch a changed dataset with sidecars); moving to
another revision rewrites it, and so does ``checkout --spatial-filter``,
which sets or clears the repository's spatial filter first.
"""

import os
import subprocess
import sys
import tempfile
from datetime import datetime, timezone

from kart_tpu_torch.cli.parser import Argument, Command, Option
from kart_tpu_torch.core.repo import InvalidOperation, KartConfigKeys, KartRepo, KartRepoState
from kart_tpu_torch.diff.key_filters import RepoKeyFilter
from kart_tpu_torch.diff.output import dump_json_output
from kart_tpu_torch.diff.structs import DeltaDiff
from kart_tpu_torch.workingcopy import get_working_copy

INVALID_ARGUMENT = 2
NO_IMPORT_SOURCE = 48


class _CliError(Exception):
    """A refused command: ``Error: <message>`` on stderr, exit 2."""


def _refusable(fn):
    def run(args, repo, device):
        try:
            return fn(args, repo, device)
        except _CliError as e:
            print(f"Error: {e}", file=sys.stderr)
            return INVALID_ARGUMENT
    return run


def _require_state(repo, *allowed):
    if repo.state not in allowed:
        raise _CliError(KartRepoState.bad_state_message(repo.state, allowed))
    return repo


def commands():
    output_format = Option("--output-format", "-o", dest="output_format",
                           choices=["text", "json"], default="text")
    init = Command("init", [
        Argument("directory", required=False, default="."),
        Option("--import", dest="import_from", help="Import from this data source immediately"),
        Option("--bare", dest="bare", kind="flag",
               help="Create a bare repository (no working copy)"),
        Option("--workingcopy-location", "--workingcopy-path", "--workingcopy",
               dest="wc_location", help="Location of the working copy (e.g. data.gpkg)"),
        Option("-b", "--initial-branch", dest="initial_branch", default="main",
               help="Initial branch name"),
        Option("--message", "-m", dest="message", help="Commit message for the initial import"),
    ], _refusable(run_init), help="Create an empty repository, or import an existing data "
                                  "source.", ignore_unknown_options=True)
    init.needs_repo = False
    return [
        init,
        Command("import", _import_params(), _refusable(run_import),
                help="Import data into the repository as new dataset(s)."),
        Command("commit", [
            Option("--message", "-m", dest="message", kind="multiple", help="Commit message"),
            Option("--allow-empty", dest="allow_empty", kind="flag",
                   help="Allow a commit with no changes"),
            Option("-o", "--output-format", dest="output_format", choices=["text", "json"],
                   default="text"),
            Argument("filters", nargs=-1),
        ], _refusable(run_commit), help="Record changes from the working copy to the "
                                        "repository."),
        Command("status", [output_format], _refusable(run_status),
                help="Show the working copy status."),
        Command("checkout", [
            Option("-b", dest="new_branch", help="Create a new branch and switch to it"),
            Option("--force", "-f", dest="force", kind="flag", help="Discard local changes"),
            Option("--spatial-filter", dest="spatial_filter_text",
                   help="Change the repo's spatial filter: '<crs>;<geometry>', @file, or "
                        "'none' to clear — the working copy is rebuilt to match (reference: "
                        "kart checkout --spatial-filter)"),
            Argument("refish", required=False),
        ], _refusable(run_checkout), help="Switch branches or restore working copy files."),
        Command("switch", [
            Option("-c", "--create", dest="create_branch",
                   help="Create and switch to this branch"),
            Option("--discard-changes", "--force", "-f", dest="force", kind="flag"),
            Argument("branch", required=False),
        ], _refusable(run_switch), help="Switch branches."),
        Command("restore", [
            Option("--source", "-s", dest="source", default="HEAD",
                   help="Revision to restore from"),
            Argument("filters", nargs=-1),
        ], _refusable(run_restore), help="Restore working copy features to their committed "
                                         "state."),
        Command("reset", [
            Option("--discard-changes", "--hard", dest="discard", kind="flag"),
            Argument("refish", required=False, default="HEAD"),
        ], _refusable(run_reset), help="Move the current branch tip (and working copy) to "
                                       "another revision."),
        Command("create-workingcopy", [
            Option("--delete-existing", dest="delete_existing", kind="flag",
                   secondary=["--no-delete-existing"]),
            Argument("location", required=False),
        ], _refusable(run_create_workingcopy),
            help="(Re)create the working copy from the current HEAD."),
    ]


def _import_params():
    return [
        Argument("sources", nargs=-1, required=True),
        Option("--message", "-m", dest="message", help="Commit message"),
        Option("--table", "-t", dest="table", help="Only import this table from the source"),
        Option("--dest-path", dest="dest_path", help="Dataset path to import into"),
        Option("--replace-existing", dest="replace_existing", kind="flag",
               help="Replace existing dataset(s)"),
        Option("--replace-ids", dest="replace_ids",
               help="Replace only features with the given IDs (one per line; use "
                    "@filename.txt to read them from a file). Implies --replace-existing. "
                    "A listed ID missing from the source is deleted from the dataset; an "
                    "empty value replaces no features."),
        Option("--no-checkout", dest="no_checkout", kind="flag",
               help="Don't update the working copy"),
        Option("--all-tables", "-a", dest="all_tables", kind="flag",
               help="Import all tables from the source (the default when no --table is "
                    "given; accepted for reference-CLI compatibility)"),
        Option("--list", dest="do_list", kind="flag",
               help="List the tables present in the source and exit"),
        Option("-o", "--output-format", dest="output_format", choices=["text", "json"],
               default="text", help="Output format for --list"),
        Option("--primary-key", dest="primary_key",
               help="Use this (existing, unique) column as the primary key"),
        Option("--crs", dest="crs_override",
               help="CRS of the source data, e.g. 'EPSG:27700' or full WKT — for sources "
                    "that don't carry one (GeoJSON, CSV, shapefile without .prj). EPSG codes "
                    "resolve via the built-in registry."),
    ]


def _do_checkout(repo, refish=None, *, force=False, device=None):
    """Move the working copy to ``refish`` (creating it when needed)."""
    structure = repo.structure(refish or "HEAD")
    wc = get_working_copy(repo, allow_uncreated=True, device=device)
    if wc is None:
        return None
    wc.reset(structure, force=force)
    return wc


# --- init / import -----------------------------------------------------------

def run_init(args, repo, device):
    repo = KartRepo.init_repository(args.directory, bare=args.bare,
                                    initial_branch=args.initial_branch)
    print(f"Initialized empty Kart repository in {repo.gitdir}")
    if args.wc_location and not args.bare:
        repo.config.set_many({KartConfigKeys.KART_WORKINGCOPY_LOCATION: args.wc_location})
    if args.import_from:
        defaults = {p.dest: p.default for p in _import_params()}
        import_args = type(args)(**{**defaults, "sources": (args.import_from,),
                                    "message": args.message})
        return run_import(import_args, KartRepo(args.directory), device)
    return 0


def run_import(args, repo, device):
    from kart_tpu_torch.crs import CrsError, make_crs
    from kart_tpu_torch.importer import ImportSource
    from kart_tpu_torch.importer.importer import import_sources

    if args.do_list:
        if args.table or args.all_tables:
            raise _CliError("--list cannot be combined with --table/--all-tables")
        body = {}
        for spec in args.sources:
            for src in ImportSource.open(spec):
                try:
                    title = src.meta_items().get("title")
                except Exception:
                    title = None
                body[src.dest_path] = title or ""
        if args.output_format == "json":
            dump_json_output({"kart.tables/v1": body}, "-")
        else:
            for name, title in sorted(body.items()):
                print(f"{name} - {title}" if title else name)
        return 0
    if args.all_tables and args.table:
        raise _CliError("--all-tables cannot be combined with --table")

    ids = None
    replace_ids = args.replace_ids
    if replace_ids is not None:
        if replace_ids.startswith("@"):
            try:
                with open(replace_ids[1:]) as f:
                    replace_ids = f.read()
            except OSError as e:
                raise _CliError(f"Cannot read --replace-ids file: {e}")
        ids = [line.strip() for line in replace_ids.splitlines() if line.strip()]
    if args.crs_override:
        try:  # a bad code or WKT fails before any import work
            make_crs(args.crs_override)
        except CrsError as e:
            raise _CliError(str(e))
    all_sources = []
    for spec in args.sources:
        opened = ImportSource.open(spec, table=args.table)
        if args.crs_override:
            for src in opened:
                if hasattr(src, "crs"):
                    src.crs = args.crs_override
                elif getattr(src, "crs_wkt", "n/a") is None:  # a Shapefile without .prj
                    src.crs_wkt = make_crs(args.crs_override).wkt
                else:
                    raise _CliError(f"--crs does not apply to {spec!r}: the source carries "
                                    f"its own CRS definition")
        all_sources.extend(opened)
    if args.primary_key:
        all_sources = [src.with_primary_key(args.primary_key) for src in all_sources]
    if args.dest_path:
        if len(all_sources) != 1:
            raise _CliError("--dest-path requires a single table import")
        all_sources[0].dest_path = args.dest_path
    checkout = not args.no_checkout and not repo.is_bare
    import_sources(repo, all_sources, message=args.message,
                   replace_existing=args.replace_existing, replace_ids=ids,
                   log=lambda m: print(m, file=sys.stderr))
    if checkout:
        _do_checkout(repo, "HEAD", force=True, device=device)
    return 0


# --- commit / status ----------------------------------------------------------

def _commit_message_from_editor(repo_diff):
    """No ``-m``: the user's editor ($VISUAL, $EDITOR, else vi) on a template
    of the changes; '#' lines are dropped and an empty message aborts."""
    lines = ["", "# Please enter the commit message for your changes.",
             "# Lines starting with '#' will be ignored, and an empty",
             "# message aborts the commit.", "#", "# Changes to be committed:", "#"]
    for ds_path in sorted(repo_diff):
        ds_diff = repo_diff[ds_path]
        n_features = len(ds_diff.get("feature") or ())
        n_meta = len(ds_diff.get("meta") or ())
        parts = []
        if n_meta:
            parts.append(f"{n_meta} meta item(s)")
        if n_features:
            parts.append(f"{n_features} feature(s)")
        lines.append(f"#   {ds_path}: {', '.join(parts) or 'no changes'}")
    editor = os.environ.get("VISUAL") or os.environ.get("EDITOR") or "vi"
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write("\n".join(lines) + "\n")
        path = f.name
    try:
        if subprocess.call(f'{editor} "{path}"', shell=True) != 0:
            return None
        with open(path) as f:
            text = f.read()
    finally:
        os.remove(path)
    stripped = "\n".join(line for line in text.splitlines() if not line.startswith("#")).strip()
    return stripped or None


def run_commit(args, repo, device):
    from kart_tpu_torch.diff.engine import get_repo_diff

    _require_state(repo, KartRepoState.NORMAL)
    wc = get_working_copy(repo, device=device)
    if wc is None:
        raise _CliError("No working copy — nothing to commit")
    target_rs = repo.structure("HEAD")
    wc.assert_db_tree_match(target_rs.tree_oid)
    key_filter = RepoKeyFilter.build_from_user_patterns(args.filters)
    repo_diff = get_repo_diff(target_rs, target_rs, repo_key_filter=key_filter, device=device,
                              include_wc_diff=True)
    if not repo_diff and not args.allow_empty:
        raise _CliError("No changes to commit")
    msg = "\n\n".join(args.message) if args.message else None
    if not msg:
        msg = _commit_message_from_editor(repo_diff)
    if not msg:
        raise _CliError("Aborting commit due to empty commit message")
    new_commit = target_rs.commit_diff(repo_diff, msg, allow_empty=args.allow_empty)
    commit_obj = repo.odb.read_commit(new_commit)
    wc.soft_reset_after_commit(commit_obj.tree, key_filter)
    branch = repo.head_branch
    branch_name = branch.rsplit("/", 1)[-1] if branch else "HEAD"
    if args.output_format == "json":
        author = commit_obj.author
        off = commit_obj.committer.offset
        dump_json_output({"kart.commit/v1": {
            "commit": new_commit,
            "abbrevCommit": new_commit[:7],
            "author": author.email,
            "committer": commit_obj.committer.email,
            "branch": branch_name,
            "message": commit_obj.message,
            "changes": {ds_path: ds_diff.type_counts() for ds_path, ds_diff in repo_diff.items()},
            "commitTime": datetime.fromtimestamp(author.time, timezone.utc)
            .strftime("%Y-%m-%dT%H:%M:%SZ"),
            "commitTimeOffset": f"{'+' if off >= 0 else '-'}"
                                f"{abs(off) // 60:02d}:{abs(off) % 60:02d}",
        }}, "-")
        return 0
    print(f"[{branch_name} {new_commit[:7]}] {commit_obj.message_summary}")
    return 0


def run_status(args, repo, device):
    from kart_tpu_torch.diff.engine import get_repo_diff

    state = repo.state
    branch = repo.head_branch
    head = repo.head_commit_oid
    changes = {}
    wc = get_working_copy(repo, device=device)
    if wc is not None and head is not None:
        target_rs = repo.structure("HEAD")
        diff = get_repo_diff(target_rs, target_rs, device=device, include_wc_diff=True)
        for ds_path, ds_diff in diff.items():
            changes[ds_path] = ds_diff.type_counts()
    short_branch = branch.rsplit("/", 1)[-1] if branch else None

    if args.output_format == "json":
        spec = repo.spatial_filter_spec()
        body = {
            "commit": head,
            "abbrevCommit": head[:7] if head else None,
            "branch": short_branch,
            "upstream": None,
            "state": state,
            "spatialFilter": (None if spec is None else
                              {"geometry": repo.config.get(
                                  KartConfigKeys.KART_SPATIALFILTER_GEOMETRY),
                               "crs": repo.config.get(KartConfigKeys.KART_SPATIALFILTER_CRS)}),
        }
        if state == KartRepoState.MERGING:
            from kart_tpu_torch.cli.merge_cmds import _conflict_summary
            from kart_tpu_torch.merge.index import MergeIndex

            mi = MergeIndex.read_from_repo(repo)
            merge_head = repo.read_gitdir_file("MERGE_HEAD") or ""
            merge_branch = repo.read_gitdir_file("MERGE_BRANCH") or ""
            body["merging"] = {
                "ancestor": None,
                "ours": {"branch": short_branch, "commit": head,
                         "abbrevCommit": head[:7] if head else None},
                "theirs": {"branch": merge_branch or None, "commit": merge_head or None,
                           "abbrevCommit": merge_head[:7] if merge_head else None},
            }
            body["conflicts"] = _conflict_summary(
                {label: aot for label, aot in mi.conflicts.items() if label not in mi.resolves})
        else:
            body["workingCopy"] = ({"path": str(wc), "changes": changes or None}
                                   if wc else None)
        dump_json_output({"kart.status/v1": body}, "-")
        return 0

    if branch:
        print(f"On branch {short_branch}")
    elif head:
        print(f"HEAD detached at {head[:7]}")
    if head is None:
        print("\nNo commits yet")
        return 0
    if state == KartRepoState.MERGING:
        print('\nRepository is in "merging" state.')
        print('View conflicts with "kart conflicts" and resolve them with "kart resolve".')
        return 0
    if not changes:
        print("\nNothing to commit, working copy clean")
        return 0
    print("\nChanges in working copy:")
    print('  (use "kart commit" to commit)')
    print('  (use "kart checkout -- ." to discard changes)\n')
    for ds_path, counts in changes.items():
        print(f"  {ds_path}:")
        for part, part_counts in counts.items():
            for change, n in part_counts.items():
                print(f"      {part}: {n} {change}")
    return 0


# --- checkout / switch / restore / reset -------------------------------------

_DIRTY = ("You have uncommitted changes in your working copy. "
          "Commit or discard first (use --force to discard).")


def _switch_spatial_filter(repo, text, refish, force):
    """Set (or with 'none' clear) the spatial filter and rebuild the working
    copy with the features of ``refish`` (default HEAD) inside it."""
    from kart_tpu_torch.spatial_filter import ResolvedSpatialFilterSpec

    spec = ResolvedSpatialFilterSpec.from_spec_string(text)
    old_spec = ResolvedSpatialFilterSpec.from_repo_config(repo)
    if spec.match_all:
        for key in (KartConfigKeys.KART_SPATIALFILTER_GEOMETRY,
                    KartConfigKeys.KART_SPATIALFILTER_CRS):
            repo.del_config(key)
    else:
        repo.config.set_many(spec.config_items())
    if spec.match_all and old_spec.match_all:
        return
    wc = get_working_copy(repo, allow_uncreated=True)
    if wc is None or repo.head_commit_oid is None:
        return
    if wc.is_dirty() and not force:
        raise InvalidOperation(_DIRTY)
    target = repo.structure(refish or "HEAD")
    full_path = getattr(wc, "full_path", None)  # a GPKG's file; a server's tables stay
    if full_path and os.path.exists(full_path):
        os.remove(full_path)
    wc.create_and_initialise()
    wc.write_full(target, *target.datasets)


def run_checkout(args, repo, device):
    _require_state(repo, KartRepoState.NORMAL)
    if args.spatial_filter_text is not None:
        _switch_spatial_filter(repo, args.spatial_filter_text, args.refish, args.force)
        if args.refish is None and args.new_branch is None:
            return 0
    if args.new_branch:
        start = args.refish or "HEAD"
        oid, _ = repo.resolve_refish(start)
        repo.refs.set(f"refs/heads/{args.new_branch}", oid,
                      log_message=f"branch: created from {start}")
        repo.refs.set_head(f"refs/heads/{args.new_branch}",
                           log_message=f"checkout: moving to {args.new_branch}")
        _do_checkout(repo, "HEAD", force=args.force, device=device)
        print(f"Switched to a new branch '{args.new_branch}'")
        return 0
    if not args.refish:
        _do_checkout(repo, "HEAD", force=args.force, device=device)
        return 0
    wc = get_working_copy(repo, device=device)
    if wc is not None and wc.is_dirty() and not args.force:
        raise InvalidOperation(_DIRTY)
    refish = args.refish
    try:
        oid, ref = repo.resolve_refish(refish)
    except Exception:
        # a bare name of exactly one remote branch makes a tracking branch
        matches = [(r, o) for r, o in repo.refs.iter_refs("refs/remotes/")
                   if r.split("/", 3)[-1] == refish and not r.endswith("/HEAD")]
        if len(matches) > 1:
            remotes = ", ".join(sorted(r.split("/")[2] for r, _ in matches))
            raise InvalidOperation(
                f"{refish!r} matches branches on multiple remotes ({remotes}) — check out "
                f"the remote-qualified name explicitly")
        if not matches:
            raise
        remote_ref, oid = matches[0]
        remote_name = remote_ref.split("/")[2]
        local = f"refs/heads/{refish}"
        repo.refs.set(local, oid, log_message=f"branch: created from {remote_ref}")
        repo.config.set_many({f"branch.{refish}.remote": remote_name,
                              f"branch.{refish}.merge": f"refs/heads/{refish}"})
        repo.refs.set_head(local, log_message=f"checkout: moving to {refish}")
        _do_checkout(repo, "HEAD", force=True, device=device)
        print(f"Switched to a new branch '{refish}' tracking '{remote_name}/{refish}'")
        return 0
    if ref and ref.startswith("refs/heads/"):
        repo.refs.set_head(ref, log_message=f"checkout: moving to {refish}")
        print(f"Switched to branch '{refish}'")
    else:
        repo.refs.set_head(oid, log_message=f"checkout: moving to {oid[:7]}")
        print(f"HEAD is now detached at {oid[:7]}")
    _do_checkout(repo, "HEAD", force=True, device=device)
    return 0


def run_switch(args, repo, device):
    if not args.create_branch and not args.branch:
        raise _CliError("Specify a branch to switch to")
    checkout_args = type(args)(new_branch=args.create_branch, force=args.force,
                               refish=args.branch, spatial_filter_text=None)
    return run_checkout(checkout_args, repo, device)


def run_restore(args, repo, device):
    from kart_tpu_torch.diff.engine import get_repo_diff

    wc = get_working_copy(repo, device=device)
    if wc is None:
        raise _CliError("No working copy")
    structure = repo.structure(args.source)
    key_filter = RepoKeyFilter.build_from_user_patterns(args.filters)
    if key_filter.match_all:
        wc.reset(structure, force=True)
    else:
        # only the filtered features: the inverse of their working-copy diff
        diff = get_repo_diff(structure, repo.structure("HEAD"), repo_key_filter=key_filter,
                             device=device, include_wc_diff=True)
        with wc.session() as con:
            for ds_path, ds_diff in diff.items():
                ds = structure.datasets.get(ds_path)
                if ds is None:
                    continue
                wc._apply_feature_diff_sql(con, ds, ~ds_diff.get("feature", DeltaDiff()))
        wc.reset_tracking_table(key_filter)
    print(f"Restored working copy from {args.source}")
    return 0


def run_reset(args, repo, device):
    _require_state(repo, KartRepoState.NORMAL)
    wc = get_working_copy(repo, device=device)
    if wc is not None and wc.is_dirty() and not args.discard:
        raise InvalidOperation(
            "You have uncommitted changes; use --discard-changes to discard them.")
    oid, _ = repo.resolve_refish(args.refish)
    branch = repo.head_branch
    if branch:
        repo.refs.set(branch, oid, log_message=f"reset: moving to {args.refish}")
    else:
        repo.refs.set_head(oid, log_message=f"reset: moving to {args.refish}")
    _do_checkout(repo, "HEAD", force=True, device=device)
    print(f"HEAD is now at {oid[:7]}")
    return 0


def run_create_workingcopy(args, repo, device):
    if args.location:
        repo.config.set_many({KartConfigKeys.KART_WORKINGCOPY_LOCATION: args.location})
    wc = get_working_copy(repo, allow_uncreated=True, device=device)
    if wc is None:
        raise _CliError("No working copy location configured")
    if args.delete_existing:
        wc.delete()
    structure = repo.structure("HEAD")
    wc.write_full(structure, *structure.datasets)
    print(f"Created working copy at {wc}")
    return 0
