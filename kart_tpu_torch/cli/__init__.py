"""The port's ``kart`` command line, on argparse:

    python -m kart_tpu_torch [-C PATH] [--device DEVICE] COMMAND [options] [ARGS...]

with the commands ``diff``, ``merge``, ``conflicts`` and ``resolve``.
Global options come before the command, as in kart_tpu's CLI: ``-C PATH``
runs as if started in PATH, and ``--device`` picks where the kernels run
(default: the card, ``cuda:0``; ``cpu`` runs their plain PyTorch
versions). Without a card and without ``--device cpu`` the command
raises :class:`~kart_tpu_torch.runtime.DeviceUnavailable`; nothing falls
back.

Counterpart of kart_tpu's ``cli/__init__.py`` (``-C`` and the entry point's
exception-to-exit-code translation) for the commands ported. Errors print
``Error: <message>`` on stderr and exit with kart_tpu's codes: 2 for a bad argument or a path that is not a repository,
20 for an invalid operation, 30 for what is not ported yet, 40 for an
unresolvable revision.
"""

import argparse
import sys

from kart_tpu_torch import runtime

INVALID_ARGUMENT = 2
INVALID_OPERATION = 20
NOT_YET_IMPLEMENTED = 30
NOT_FOUND = 40


def build_parser():
    from kart_tpu_torch.cli import diff_cmds, merge_cmds

    parser = argparse.ArgumentParser(prog="kart", description="kart on PyTorch/CUDA")
    parser.add_argument("-C", dest="repo_dir", metavar="PATH", default=None,
                        help="Run as if started in PATH instead of the current directory")
    parser.add_argument("--device", default=None,
                        help="Device of the kernels: cuda[:N] (default cuda:0) or cpu")
    commands = parser.add_subparsers(dest="command", metavar="COMMAND", required=True)
    diff_cmds.add_parser(commands)
    merge_cmds.add_parsers(commands)
    return parser


def main(argv=None):
    """Run one command; -> its exit code. ``argv`` defaults to
    ``sys.argv[1:]``."""
    from kart_tpu_torch.core.repo import KartRepo, NotFound, NotYetImplemented, RepoError

    args = build_parser().parse_args(argv)
    device = runtime.resolve_device(args.device)
    try:
        try:
            repo = KartRepo(args.repo_dir or ".")
        except NotFound as e:
            print(f"Error: {e}", file=sys.stderr)
            return INVALID_ARGUMENT
        return args.run(args, repo, device)
    except RepoError as e:
        code = (NOT_YET_IMPLEMENTED if isinstance(e, NotYetImplemented)
                else NOT_FOUND if isinstance(e, NotFound) else INVALID_OPERATION)
        print(f"Error: {e}", file=sys.stderr)
        return code
