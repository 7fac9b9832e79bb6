"""``kart clone``, ``fetch``, ``push``, ``pull`` and ``remote add|remove|
list`` over local, ``http(s)://`` and ssh remotes
(:mod:`kart_tpu_torch.transport`), and the servers ``kart serve`` (HTTP)
and ``kart serve-stdio`` (the far end of an ssh remote).

``clone --spatial-filter`` and every later ``fetch`` or ``pull`` from that
promisor run the blob filter on the source's envelope index: one launch of
kernel K3 on the CLI's device for a local remote, on the server's device
for a network one. ``pull`` fetches, then runs this CLI's own ``merge`` on
the remote branch (kernel K4 when the histories diverged). A server runs
its kernels on the CLI's ``--device`` (the card unless ``--device cpu``).

Counterpart of kart_tpu's ``cli/remote_cmds.py``, with its options, outputs,
messages and exit codes (a refused command prints ``Error: <message>`` and
exits 2). ``serve``'s fleet options (``--replica-of``, ``--replica-poll``,
``--replica-max-lag``, ``--peer-cache``) exit 30 before the server binds:
the fleet lane is not ported.
"""

import os

from kart_tpu_torch import transport
from kart_tpu_torch.cli import repo_cmds
from kart_tpu_torch.cli.parser import Argument, Command, Group, Option
from kart_tpu_torch.cli.repo_cmds import _CliError, _require_state
from kart_tpu_torch.core.repo import KartRepoState
from kart_tpu_torch.transport.remote import RemoteError


def commands():
    clone = Command("clone", [
        Option("--bare", dest="bare", kind="flag", help="Clone without a working copy"),
        Option("--depth", dest="depth", integer=True,
               help="Create a shallow clone with history truncated to this many commits"),
        Option("--spatial-filter", dest="spatial_filter_spec",
               help="Spatial filter: <crs>;<geometry> (or @file). Makes a filtered partial "
                    "clone — features outside the filter stay on the remote and are fetched "
                    "on demand."),
        Option("--workingcopy-location", "--workingcopy", dest="wc_location",
               help="Location of the working copy to create"),
        Option("-b", "--branch", dest="branch",
               help="Branch to check out instead of the remote HEAD"),
        Option("--checkout", dest="do_checkout", kind="flag", secondary=["--no-checkout"],
               default=True, help="Whether to create a working copy"),
        Argument("url"),
        Argument("directory", required=False),
    ], _refusable(run_clone), help="Clone a repository into a new directory.")
    clone.needs_repo = False
    remote = Group("remote", [], {
        "add": Command("add", [Argument("name"), Argument("url")], _refusable(run_remote_add),
                       help="Add a remote."),
        "list": Command("list", [Option("-v", dest="verbose", kind="flag", help="Show URLs")],
                        run_remote_list, help="List remotes."),
        "remove": Command("remove", [Argument("name")], _refusable(run_remote_remove),
                          help="Remove a remote."),
    }, help="Manage the set of remote repositories.")
    return [
        clone,
        Command("fetch", [
            Option("--depth", dest="depth", integer=True, help="Deepen/shallow-fetch limit"),
            Argument("remote", required=False, default="origin"),
        ], _refusable(run_fetch), help="Download objects and refs from a remote repository."),
        Command("push", [
            Option("--force", "-f", dest="force", kind="flag",
                   help="Allow non-fast-forward updates"),
            Option("-u", "--set-upstream", dest="set_upstream", kind="flag",
                   help="Set the upstream for the pushed branch"),
            Argument("remote", required=False, default="origin"),
            Argument("refspecs", nargs=-1),
        ], _refusable(run_push), help="Update remote refs along with the objects needed to "
                                      "complete them."),
        Command("pull", [
            Option("--ff", dest="ff", kind="flag", secondary=["--no-ff"], default=True,
                   help="Allow/forbid fast-forward merge"),
            Option("--ff-only", dest="ff_only", kind="flag",
                   help="Only update if fast-forward is possible"),
            Argument("remote", required=False, default="origin"),
            Argument("branch", required=False),
        ], _refusable(run_pull), help="Fetch from a remote and merge into the current branch "
                                      "(reference: kart/pull.py)."),
        remote,
        Command("serve", [
            Option("--host", dest="host", default="127.0.0.1", help="[default: 127.0.0.1]"),
            Option("--port", dest="port", integer=True, default=8470, help="[default: 8470]"),
            Option("--max-inflight", dest="max_inflight", integer=True,
                   help="Load-shed ceiling on concurrent requests (429 + Retry-After beyond "
                        "it); 0 = unlimited. Overrides KART_SERVE_MAX_INFLIGHT."),
            Option("--enum-cache-bytes", dest="enum_cache_bytes", integer=True,
                   help="Pack-enumeration cache byte budget; 0 disables. Overrides "
                        "KART_SERVE_ENUM_CACHE (docs/SERVING.md)."),
            Option("--tiles", dest="tiles_enabled", kind="flag", secondary=["--no-tiles"],
                   default="",
                   help="Enable/disable the vector-tile endpoint GET "
                        "/api/v1/tiles/<ref>/<dataset>/<z>/<x>/<y> (docs/TILES.md). "
                        "Overrides KART_SERVE_TILES; enabled by default."),
            Option("--tile-cache-bytes", dest="tile_cache_bytes", integer=True,
                   help="Tile cache byte budget; 0 disables. Overrides KART_TILE_CACHE "
                        "(docs/TILES.md)."),
            Option("--replica-of", dest="replica_of", metavar="URL",
                   help="Run as a read replica of the primary at URL (not ported)."),
            Option("--replica-poll", dest="replica_poll",
                   help="Seconds between replica sync cycles (not ported)."),
            Option("--replica-max-lag", dest="replica_max_lag",
                   help="Seconds a pinned read may stall for replication (not ported)."),
            Option("--peer-cache", dest="peer_cache", metavar="URLS",
                   help="Comma-separated fleet peer URLs (not ported)."),
        ], run_serve, help="Serve this repository over HTTP for clone/fetch/push/pull — and "
                           "vector tiles of any commit, straight off the columnar store."),
        _serve_stdio_command(),
    ]


def _serve_stdio_command():
    cmd = Command("serve-stdio", [Argument("path")], run_serve_stdio,
                  help="Serve the repository at PATH over stdin/stdout (one connection).")
    cmd.needs_repo = False
    return cmd


def _refusable(fn):
    """A refused command, a RemoteError included: ``Error: <message>``, exit 2."""
    def run(args, repo, device):
        try:
            return fn(args, repo, device)
        except RemoteError as e:
            raise _CliError(str(e)) from None
    return repo_cmds._refusable(run)


def run_clone(args, repo, device):
    directory = args.directory
    if directory is None:
        tail = args.url.rstrip("/").split("/")[-1]
        directory = tail[:-5] if tail.endswith(".kart") else tail
        if not directory:
            raise _CliError(f"Cannot derive directory name from {args.url!r}")
    if os.path.exists(directory) and os.listdir(directory):
        raise _CliError(f"Destination is not empty: {directory!r}")
    resolved = None
    if args.spatial_filter_spec:
        from kart_tpu_torch.geometry import GeometryError
        from kart_tpu_torch.spatial_filter import ResolvedSpatialFilterSpec, SpatialFilterError

        try:
            resolved = ResolvedSpatialFilterSpec.from_spec_string(args.spatial_filter_spec)
        except (SpatialFilterError, GeometryError) as e:
            raise _CliError(str(e))
        if resolved.match_all:
            resolved = None
    cloned = transport.clone(
        args.url, directory, bare=args.bare, depth=args.depth, spatial_filter_spec=resolved,
        wc_location=args.wc_location, do_checkout=args.do_checkout, branch=args.branch,
        device=device)
    print(f"Cloned into {cloned.workdir or cloned.gitdir}")
    return 0


def run_fetch(args, repo, device):
    updated = transport.fetch(repo, args.remote, depth=args.depth, device=device)
    for ref, oid in sorted(updated.items()):
        print(f"  {oid[:8]}  {ref}")
    if not updated:
        print("Already up to date.")
    return 0


def run_push(args, repo, device):
    updated = transport.push(repo, args.remote, list(args.refspecs), force=args.force,
                             set_upstream=args.set_upstream)
    for ref, oid in sorted(updated.items()):
        print(f"  {oid[:8] if oid else '(deleted)'}  {ref}")
    return 0


def run_pull(args, repo, device):
    from kart_tpu_torch.cli import merge_cmds

    _require_state(repo, KartRepoState.NORMAL)
    transport.fetch(repo, args.remote, device=device)
    branch = args.branch
    if branch is None:
        local = repo.refs.head_branch()
        if local is None:
            raise _CliError("Cannot pull: HEAD is detached")
        branch = local[len("refs/heads/"):] if local.startswith("refs/heads/") else local
    remote_ref = f"refs/remotes/{args.remote}/{branch}"
    if repo.refs.get(remote_ref) is None:
        raise _CliError(f"No such remote branch: {args.remote}/{branch}")
    merge = next(c for c in merge_cmds.commands() if c.name == "merge")
    merge_args = type(args)(refish=remote_ref, message=None, dry_run=False, ff=args.ff,
                            ff_only=args.ff_only, continue_=False, abort_=False,
                            output_format="text")
    return merge.run(merge_args, repo, device)


def run_remote_add(args, repo, device):
    transport.add_remote(repo, args.name, args.url)
    return 0


def run_remote_remove(args, repo, device):
    transport.remove_remote(repo, args.name)
    return 0


def run_remote_list(args, repo, device):
    for name in repo.remotes():
        print(f"{name}\t{repo.remote_url(name)}" if args.verbose else name)
    return 0


#: serve's fleet options, each with the variable kart_tpu reads it into
FLEET_OPTIONS = (("replica_of", "--replica-of"), ("replica_poll", "--replica-poll"),
                 ("replica_max_lag", "--replica-max-lag"), ("peer_cache", "--peer-cache"))


def run_serve(args, repo, device):
    from kart_tpu_torch.core.repo import NotYetImplemented
    from kart_tpu_torch.transport.http import refuse_fleet, serve

    for dest, flag in FLEET_OPTIONS:
        if getattr(args, dest) is not None:
            raise NotYetImplemented(
                f"serve {flag}: the fleet and events lane (replicas, the peer cache, "
                f"the events feed) is not ported yet")
    refuse_fleet()
    # the variables are the serving layer's one configuration surface; the
    # options set them for this process, as kart_tpu's do
    for value, name in ((args.max_inflight, "KART_SERVE_MAX_INFLIGHT"),
                        (args.enum_cache_bytes, "KART_SERVE_ENUM_CACHE"),
                        (args.tile_cache_bytes, "KART_TILE_CACHE")):
        if value is not None:
            os.environ[name] = str(value)
    if args.tiles_enabled in (True, False):  # given: the default is ""
        os.environ["KART_SERVE_TILES"] = "1" if args.tiles_enabled else "0"
    print(f"Serving {repo.gitdir} at http://{args.host}:{args.port}/ (Ctrl-C to stop)",
          flush=True)
    try:
        serve(repo, args.host, args.port, device=device)
    except KeyboardInterrupt:
        print("Stopped.")
    return 0


def run_serve_stdio(args, repo, device):
    """The server half of an ssh remote. Standard output carries the frames
    alone: file descriptor 1 is moved aside for them and pointed at
    standard error, so that a build at first use (g++, nvcc) or any print
    cannot write a byte into the stream."""
    import sys

    from kart_tpu_torch.core.repo import KartRepo, NotFound
    from kart_tpu_torch.transport.stdio import serve_stdio

    path = args.path
    if not os.path.exists(path):
        from kart_tpu_torch.cli.parser import UsageError

        raise UsageError(f"Invalid value for 'PATH': Path {path!r} does not exist.")
    try:
        repo = KartRepo(path)
    except NotFound as e:
        from kart_tpu_torch.cli.parser import UsageError

        raise UsageError(str(e)) from None
    # PATH must be the repository, not a directory inside one
    if os.path.realpath(repo.workdir or repo.gitdir) != os.path.realpath(path):
        print(f"Error: Not a repository: {path!r}", file=sys.stderr)
        return 2
    sys.stdout.flush()
    wire = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    try:
        serve_stdio(repo, sys.stdin.buffer, wire, device=device)
    finally:
        wire.close()
    return 0
