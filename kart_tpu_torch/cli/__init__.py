"""The port's ``kart`` command line:

    python -m kart_tpu_torch [-C PATH] [--device DEVICE] COMMAND [options] [ARGS...]

with the commands ``init``, ``import``, ``status``, ``commit``, ``checkout``,
``switch``, ``restore``, ``reset``, ``create-workingcopy``, ``branch``,
``tag``, ``config``, ``reflog``, ``gc``, ``fsck``, ``git``, ``clone``,
``fetch``, ``push``, ``pull``, ``remote add|list|remove``,
``diff``, ``show``, ``create-patch``, ``log``, ``apply``, ``merge``,
``conflicts``, ``resolve``, ``query``, ``export tiles``, ``spatial-filter
index|resolve``, ``data ls|version``, ``meta get|set``, ``commit-files`` and
``build-annotations``. Global options come before the command, as
in kart_tpu's CLI: ``-C PATH`` runs as if started in PATH, and ``--device``
picks where the kernels run (default: the card, ``cuda:0``, or with 2 or
more cards the mesh of all of them for work that ``parallel.should_shard``
sends there; ``cuda:N`` pins card N; ``cpu`` runs the host floor and the
plain PyTorch versions). Without a card and without ``--device cpu`` the
command raises :class:`~kart_tpu_torch.runtime.DeviceUnavailable`;
nothing falls back.

Counterpart of kart_tpu's ``cli/__init__.py`` (``-C``, ``--version`` and
the entry point's exception-to-exit-code translation) for the commands
ported. ``--version`` prints the port's version in click's
``version_option`` form and exits 0, before any command runs. Arguments are
parsed with click's rules and usage messages (:mod:`.parser`). Errors print
``Error: <message>`` on stderr and exit with kart_tpu's codes: 2 for a bad
argument, an unknown command or a path that is not a repository, 20 for
an invalid operation, 30 for what is not ported yet, 40 for an
unresolvable revision, 48 for an import source that cannot be read.
"""

import sys

from kart_tpu_torch import runtime
from kart_tpu_torch.cli.parser import Group, HelpRequested, Option, UsageError, VersionRequested

INVALID_ARGUMENT = 2
INVALID_OPERATION = 20
NOT_YET_IMPLEMENTED = 30
NOT_FOUND = 40
NO_IMPORT_SOURCE = 48

#: the program name ``--version`` prints
PROG_NAME = "kart (kart_tpu_torch)"


def build_cli():
    """-> the top-level :class:`~.parser.Group` of the ported commands."""
    from kart_tpu_torch.cli import (
        data_cmds,
        diff_cmds,
        merge_cmds,
        query_cmds,
        ref_cmds,
        remote_cmds,
        repo_cmds,
        spatial_cmds,
        tile_cmds,
    )

    commands = {cmd.name: cmd for cmd in (*diff_cmds.commands(), *merge_cmds.commands(),
                                          *query_cmds.commands(), *tile_cmds.commands(),
                                          *spatial_cmds.commands(), *data_cmds.commands(),
                                          *repo_cmds.commands(), *ref_cmds.commands(),
                                          *remote_cmds.commands())}
    return Group(
        "kart",
        [
            Option("-C", dest="repo_dir", metavar="PATH",
                   help="Run as if started in PATH instead of the current directory"),
            Option("--device", dest="device",
                   help="Device of the kernels: cuda[:N] (default cuda:0) or cpu"),
            Option("--version", dest="version", kind="flag", help="Show the version and exit."),
        ],
        commands, help="kart on PyTorch/CUDA",
    )


def main(argv=None):
    """Run one command; -> its exit code (usage errors included: this
    never raises SystemExit). ``argv`` defaults to ``sys.argv[1:]``."""
    from kart_tpu_torch.core.repo import KartRepo, NotFound, NotYetImplemented, RepoError
    from kart_tpu_torch.diff.writers import DiffUsageError
    from kart_tpu_torch.importer import ImportSourceError

    cli = build_cli()
    try:
        glob, cmd, args = cli.resolve(sys.argv[1:] if argv is None else list(argv))
    except HelpRequested as e:
        print(e.command.help_text())
        return 0
    except VersionRequested:
        import kart_tpu_torch

        print(f"{PROG_NAME}, version {kart_tpu_torch.__version__}")
        return 0
    except UsageError as e:
        e.show()
        return INVALID_ARGUMENT
    runtime.resolve_device(glob.device)  # no card: raise before any work
    # the commands take the request itself: unnamed, the card may be the mesh
    device = glob.device
    try:
        repo = None
        if getattr(cmd, "needs_repo", True):  # ``init`` makes its own
            try:
                repo = KartRepo(glob.repo_dir or ".")
            except NotFound as e:
                UsageError(str(e), cmd).show()
                return INVALID_ARGUMENT
        return cmd.run(args, repo, device)
    except DiffUsageError as e:
        UsageError(str(e), cmd).show()
        return INVALID_ARGUMENT
    except ImportSourceError as e:
        print(f"Error: {e}", file=sys.stderr)
        return NO_IMPORT_SOURCE
    except RepoError as e:
        code = (NOT_YET_IMPLEMENTED if isinstance(e, NotYetImplemented)
                else NOT_FOUND if isinstance(e, NotFound) else INVALID_OPERATION)
        print(f"Error: {e}", file=sys.stderr)
        return code
