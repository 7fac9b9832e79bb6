"""The port's ``kart`` command line:

    python -m kart_tpu_torch [-C PATH] [--device DEVICE] COMMAND [options] [ARGS...]

with the commands ``init``, ``import``, ``status``, ``commit``, ``checkout``,
``switch``, ``restore``, ``reset``, ``create-workingcopy``, ``branch``,
``tag``, ``config``, ``reflog``, ``gc``, ``fsck``, ``git``, ``clone``,
``fetch``, ``push``, ``pull``, ``remote add|list|remove``,
``diff``, ``show``, ``create-patch``, ``log``, ``apply``, ``merge``,
``conflicts``, ``resolve``, ``query``, ``export tiles``, ``spatial-filter
index|resolve``, ``data ls|version``, ``meta get|set``, ``commit-files``,
``build-annotations``, ``serve``, ``serve-stdio``, ``stats`` and ``top``.
Global options come before the command, as in kart_tpu's CLI: ``-C PATH``
runs as if started in PATH, ``-v``/``--verbose`` (``-vv``) raises the log
level and prints the command's phase summary on stderr, ``--trace`` writes
a Chrome trace of the command (``KART_TRACE=<path>`` picks the file),
``--reprobe`` is accepted and does nothing (kart_tpu's drops a JAX probe's
verdict, and the port has no such probe), and ``--device``
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
        stats_cmds,
        tile_cmds,
        top_cmds,
    )

    commands = {cmd.name: cmd for cmd in (*diff_cmds.commands(), *merge_cmds.commands(),
                                          *query_cmds.commands(), *tile_cmds.commands(),
                                          *spatial_cmds.commands(), *data_cmds.commands(),
                                          *repo_cmds.commands(), *ref_cmds.commands(),
                                          *remote_cmds.commands(), *stats_cmds.commands(),
                                          *top_cmds.commands())}
    return Group(
        "kart",
        [
            Option("-C", dest="repo_dir", metavar="PATH",
                   help="Run as if started in PATH instead of the current directory"),
            Option("--device", dest="device",
                   help="Device of the kernels: cuda[:N] (default cuda:0) or cpu"),
            Option("--version", dest="version", kind="flag", help="Show the version and exit."),
            Option("-v", "--verbose", dest="verbose", kind="count",
                   help="Increase verbosity (-v, -vv)"),
            Option("--trace", dest="trace", kind="flag",
                   help="Record a Chrome trace of this command (written on exit; "
                        "KART_TRACE=<path> picks the file)"),
            Option("--reprobe", dest="reprobe", kind="flag",
                   help="Accepted for kart_tpu's command lines; the port has no probe "
                        "verdict to drop"),
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
    _start_telemetry(glob, cmd)
    try:
        repo = None
        needs_repo = getattr(cmd, "needs_repo", True)  # ``init`` makes its own
        if needs_repo == "lazy":  # opened only when the command asks
            def repo():
                try:
                    return KartRepo(glob.repo_dir or ".")
                except NotFound as e:
                    raise UsageError(str(e), cmd) from None
        elif needs_repo:
            try:
                repo = KartRepo(glob.repo_dir or ".")
            except NotFound as e:
                UsageError(str(e), cmd).show()
                return INVALID_ARGUMENT
        from kart_tpu_torch import telemetry

        with telemetry.span("cli.command", cmd=cmd.name):
            return cmd.run(args, repo, device)
    except UsageError as e:
        if e.command is None:
            e.command = cmd
        e.show()
        return INVALID_ARGUMENT
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
    finally:
        _flush_telemetry(glob)


def _start_telemetry(glob, cmd):
    """kart_tpu's CLI group callback: one log configuration, ``KART_METRICS``
    and ``KART_TRACE`` honoured, ``--trace`` and ``-v`` enabling spans, and
    one root request a command (every transport verb it issues inherits the
    trace id)."""
    from kart_tpu_torch import telemetry

    telemetry.configure_logging(glob.verbose)
    telemetry.enable_from_env()
    if glob.trace and not telemetry.tracing_enabled():
        telemetry.enable(trace=True, trace_path=telemetry.default_trace_path())
    if glob.verbose:
        telemetry.enable(spans=True)  # feeds the end-of-command summary
    telemetry.set_root_request(verb=cmd.name)
    telemetry.incr("cli.commands", cmd=cmd.name)


def _flush_telemetry(glob):
    """The trace file (``--trace``/``KART_TRACE``) and, with ``-v``, the
    phase summary, on stderr."""
    from kart_tpu_torch import telemetry
    from kart_tpu_torch.telemetry import sinks

    if telemetry.tracing_enabled():
        dropped = telemetry.events_dropped_count()
        path = sinks.write_chrome_trace()
        if path:
            note = f" ({dropped} span events dropped at the buffer cap)" if dropped else ""
            print(f"Trace written to {path}{note}", file=sys.stderr)
    if glob.verbose:
        summary = sinks.phase_summary_text()
        if summary:
            print(summary, file=sys.stderr)
