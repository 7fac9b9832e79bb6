"""Usage errors of the port's command line against kart_tpu's click CLI:
for each bad invocation, the same exit code and the same first and last
lines of stderr (``Usage: kart <cmd> [OPTIONS] ...`` and ``Error: ...``),
and nothing on stdout; ``main()`` returns the code and never raises
SystemExit. ``--help`` text is not held to kart_tpu's."""

import contextlib
import io

import pytest
from click.testing import CliRunner

from helpers import make_repo_with_edits
from kart_tpu.cli import cli as kart_cli
from kart_tpu_torch.cli import main as port_main

#: the four invocations found to differ before the parser was replaced
RECORDED = [
    ["resolve"],
    ["diff", "-o", "nosuch", "HEAD^..HEAD"],
    ["merge", "--nosuch"],
    ["diff", "-o"],
]

COMMANDS = ["diff", "show", "create-patch", "merge", "conflicts", "resolve"]

#: each command: a bad -o, --crs with no value, one argument too many
PER_COMMAND = [
    argv for cmd in COMMANDS for argv in (
        [cmd, "-o", "nosuch"],
        [cmd, "--crs"],
        [cmd, "HEAD", "HEAD", "extra"] if cmd in ("create-patch", "merge")
        else [cmd, "a", "b"] if cmd == "resolve"
        else [cmd, "HEAD" if cmd == "show" else "HEAD^...HEAD", "nosuch", "extra"],
    )
]

#: kart query: a bad -o, --page not an int, --intersects with no value, an
#: extra argument, and more
QUERY = [
    ["query", "HEAD", "points", "-o", "nosuch"],
    ["query", "HEAD", "points", "--page", "x"],
    ["query", "HEAD", "points", "--page-size", "1.5"],
    ["query", "HEAD", "points", "--intersects"],
    ["query", "HEAD", "points", "extra"],
    ["query"],
    ["query", "HEAD"],
    ["query", "HEAD", "points", "--host=1"],
    ["query", "HEAD", "points", "--intersect", "HEAD^:points"],
    ["query", "HEAD", "points", "--crs", "EPSG:4326"],
    ["query", "HEAD", "points", "-ojson", "--", "--where"],
]

#: kart export tiles: the group without a command (its help, exit 2), an
#: unknown command or option, bad values of --zoom, --layers, --workers and
#: --max-features, an extra argument, a flag given a value
EXPORT = [
    ["export"],
    ["export", "nope"],
    ["export", "--bad"],
    ["export", "tiles", "--zoom", "x"],
    ["export", "tiles", "--zoom", "3-31"],
    ["export", "tiles", "--zoom"],
    ["export", "tiles", "--layers", "nope,bin"],
    ["export", "tiles", "--layers", ","],
    ["export", "tiles", "--workers", "x"],
    ["export", "tiles", "--workers"],
    ["export", "tiles", "--max-features", "1.5"],
    ["export", "tiles", "HEAD", "extra"],
    ["export", "tiles", "--nope"],
    ["export", "tiles", "--strict=1"],
    ["export", "tiles", "nosuchref"],
    ["export", "tiles", "--dataset", "nope"],
    ["export", "tiles", "-o"],
]

#: kart spatial-filter: the group alone (its help, exit 2), an unknown
#: command or option, a bad or missing -o, extra arguments, a flag given a
#: value
SPATIAL = [
    ["spatial-filter"],
    ["spatial-filter", "nope"],
    ["spatial-filter", "--bad"],
    ["spatial-filter", "index", "--bad"],
    ["spatial-filter", "index", "extra"],
    ["spatial-filter", "index", "--clear=1"],
    ["spatial-filter", "resolve", "-o", "x"],
    ["spatial-filter", "resolve", "-o"],
    ["spatial-filter", "resolve", "a", "b"],
    ["spatial-filter", "resolve", "nonsense"],
]

#: kart log: a bad --with-feature-count, a count that is no integer, an
#: unparseable date (not a usage error: ``Error:`` alone), a flag given a
#: value, a repeatable option with no value, a bad -o
LOG = [
    ["log", "--with-feature-count", "roughly"],
    ["log", "-n", "three"],
    ["log", "-nx"],
    ["log", "--skip", "1.5"],
    ["log", "--since", "next tuesday"],
    ["log", "--until", "2024-02-30"],
    ["log", "--graph=1"],
    ["log", "--author"],
    ["log", "--grep", "x", "--grep"],
    ["log", "-o", "geojson"],
    ["log", "--json-style", "loose"],
    ["log", "--with-dataset-change"],
    ["build-annotations", "extra"],
    ["build-annotations", "--all-reachable=1"],
    ["build-annotations", "--all"],
]

OTHERS = [
    ["diff", "--outpt", "x"],
    ["diff", "--output-format"],
    ["diff", "--exit-code=1"],
    ["diff", "-x"],
    ["diff", "--o", "json"],
    ["diff", "--only-feature-count", "nosuch", "HEAD^...HEAD"],
    ["diff", "--json-style", "loose"],
    ["diff", "-ojson", "HEAD^...HEAD", "--", "--not-an-option"],
    ["show", "-o"],
    ["show", "--patch-type", "full"],
    ["create-patch"],
    ["create-patch", "--patch-type", "tiny", "HEAD"],
    ["create-patch", "--output"],
    ["merge", "-m"],
    ["merge", "--ff-onl"],
    ["merge", "-o", "geojson", "theirs"],
    ["conflicts", "-sx"],
    ["conflicts", "--flat=1"],
    ["conflicts", "-o"],
    ["resolve", "a", "--with", "mine"],
    ["resolve", "a", "--with-file", "no-such-file.geojson"],
    ["resolve", "--with"],
    ["--nosuch", "diff"],
    ["nosuchcommand"],
    ["-C"],
    [],
]


def _port(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_main(argv)
    return rc, out.getvalue(), err.getvalue()


def _edges(text):
    lines = text.splitlines()
    return (lines[0], lines[-1]) if lines else ("", "")


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    return make_repo_with_edits(tmp_path_factory.mktemp("usage"))[0]


@pytest.mark.parametrize("argv",
                         RECORDED + PER_COMMAND + QUERY + OTHERS + EXPORT + SPATIAL + LOG,
                         ids=" ".join)
def test_usage_errors_match_kart_tpu(repo, argv):
    ref = CliRunner().invoke(kart_cli, ["-C", repo, *argv], prog_name="kart")
    assert ref.exception is None or isinstance(ref.exception, SystemExit), ref.exception
    rc, out, err = _port(["--device", "cpu", "-C", repo, *argv])
    assert rc == ref.exit_code
    assert out == ref.stdout
    assert _edges(err) == _edges(ref.stderr)


@pytest.mark.parametrize("argv", RECORDED)
def test_recorded_cases_are_usage_errors(repo, argv):
    """The recorded cases exit 2 with click's whole message."""
    ref = CliRunner().invoke(kart_cli, ["-C", repo, *argv], prog_name="kart")
    rc, out, err = _port(["--device", "cpu", "-C", repo, *argv])
    assert (rc, out, err) == (ref.exit_code, "", ref.stderr)
    assert rc == 2 and err.splitlines()[-1].startswith("Error: ")


def test_main_returns_the_code(repo):
    """No SystemExit escapes main(), for a usage error or for --help."""
    for argv in (["diff", "--nosuch"], ["diff", "--help"], ["--help"], ["resolve"]):
        try:
            rc, _, _ = _port(["-C", repo, *argv])
        except SystemExit as e:  # pragma: no cover - the fault this guards
            pytest.fail(f"main({argv}) raised SystemExit({e.code})")
        assert rc == (0 if "--help" in argv else 2)


def test_export_group_help_is_click_s(repo):
    """``kart export`` alone prints the group's help on stderr and exits 2,
    word for word click's."""
    ref = CliRunner().invoke(kart_cli, ["-C", repo, "export"], prog_name="kart")
    rc, out, err = _port(["--device", "cpu", "-C", repo, "export"])
    assert (rc, out, err) == (ref.exit_code, ref.stdout, ref.stderr) and rc == 2


def test_spatial_filter_group_help_is_click_s(repo):
    """``kart spatial-filter`` alone: the group's help word for word, its
    commands' help cut as click cuts it, on stderr, exit 2."""
    ref = CliRunner().invoke(kart_cli, ["-C", repo, "spatial-filter"], prog_name="kart")
    rc, out, err = _port(["--device", "cpu", "-C", repo, "spatial-filter"])
    assert (rc, out, err) == (ref.exit_code, ref.stdout, ref.stderr) and rc == 2


def test_not_a_repository_like_kart_tpu(tmp_path):
    argv = ["diff", "HEAD^...HEAD"]
    ref = CliRunner().invoke(kart_cli, ["-C", str(tmp_path), *argv], prog_name="kart")
    rc, out, err = _port(["--device", "cpu", "-C", str(tmp_path), *argv])
    assert (rc, out, err) == (ref.exit_code, ref.stdout, ref.stderr)


@pytest.mark.parametrize("command", ["watch", "fleet", "lint", "upgrade-to-kart"])
def test_unported_kart_commands_are_unknown_commands(repo, command):
    """A kart command the port lacks is a usage error, as any unknown one."""
    rc, out, err = _port(["--device", "cpu", "-C", repo, command])
    assert rc == 2 and out == ""
    assert _edges(err) == ("Usage: kart [OPTIONS] COMMAND [ARGS]...",
                           f"Error: No such command {command!r}.")


def test_build_annotations_help_is_click_s(repo):
    """``kart build-annotations --help``, word for word click's."""
    ref = CliRunner().invoke(kart_cli, ["-C", repo, "build-annotations", "--help"],
                             prog_name="kart")
    rc, out, err = _port(["--device", "cpu", "-C", repo, "build-annotations", "--help"])
    assert (rc, out, err) == (ref.exit_code, ref.stdout, ref.stderr) and rc == 0
