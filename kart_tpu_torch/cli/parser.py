"""A small command-line parser with click's rules and messages.

kart_tpu's CLI is built on click, and its users read click's usage errors
and rely on its parsing rules; the port cannot import click, so this
module keeps the part of them that the ported commands use:

* options anywhere among the arguments, ``--`` ending them, ``--opt=value``,
  short clusters (``-ss``, ``-ojson``), no abbreviations; a value option
  takes the next token whatever it looks like;
* a usage error prints ``Usage: kart <cmd> [OPTIONS] ...``, ``Try 'kart
  <cmd> --help' for help.``, a blank line and ``Error: <message>``, and
  exits 2 (an option missing its value or given one it does not take
  prints the ``Error:`` line alone, as click does);
* messages: ``No such option '--x'.`` (with click's close-match hint),
  ``Option '-o' requires an argument.``, ``Option '--flag' does not take a
  value.``, ``Invalid value for '--output-format' / '-o': 'x' is not one of
  ...``, ``Invalid value for '--with-file': Path 'x' does not exist.``,
  ``Invalid value for '--page': 'x' is not a valid integer.``,
  ``Invalid value for '--output' / '-o': Directory 'x' is a file.``,
  ``Invalid value for 'PATCH_FILE': 'x': No such file or directory``,
  ``Missing argument 'LABEL'.``, ``Missing option '--message' / '-m'.``,
  ``Got unexpected extra argument (x)``, ``No such command 'x'.`` and
  ``Missing command.``;
* parameters are checked in click's order: the options given, in the
  order first given, then every argument, then the other options as
  declared;
* a command made with ``ignore_unknown_options`` (``kart init``) keeps an
  unknown option as an argument, as click's context setting does;
* groups nest (``kart export tiles``): a group inside the top level given
  no arguments at all prints its help on stderr and exits 2, as click's
  does.

``--help`` prints a short help text in click's layout and exits 0; only a
group's (what ``kart export`` prints) is word for word kart_tpu's.
"""

import difflib
import os
import sys


class UsageError(Exception):
    """A bad invocation. ``command`` (a :class:`Command`, or None) puts the
    usage lines above the message."""

    def __init__(self, message, command=None):
        super().__init__(message)
        self.message = message
        self.command = command

    def show(self, prog="kart", file=None):
        file = file or sys.stderr
        if self.command is not None:
            name = self.command.full_name(prog)
            print(f"Usage: {self.command.usage(prog)}", file=file)
            print(f"Try '{name} --help' for help.", file=file)
            print(file=file)
        print(f"Error: {self.message}", file=file)


class HelpRequested(Exception):
    def __init__(self, command):
        super().__init__(command.name)
        self.command = command


class VersionRequested(Exception):
    """A group's ``--version`` flag: an eager option, handled before any
    command is looked for, as click's ``version_option``."""


class NoArgsIsHelp(UsageError):
    """A sub-group given no arguments at all: click prints its help on
    stderr and exits 2."""

    def __init__(self, command):
        super().__init__("", command)

    def show(self, prog="kart", file=None):
        print(self.command.help_text(prog), file=file or sys.stderr)


class Option:
    """One option. ``kind``: ``value`` (takes one value), ``multiple``
    (click's ``multiple=True``: takes one value each time it is given, a
    tuple of them, ``()`` when never given), ``flag`` (True; its
    ``secondary`` names, such as ``--no-ff``, set False) or ``count``."""

    def __init__(self, *opts, dest, kind="value", choices=None, default=None,
                 secondary=(), path_exists=False, dir_path=False, integer=False, metavar=None,
                 required=False, help=""):
        self.opts = opts
        self.required = required
        self.dir_path = dir_path
        self.integer = integer
        self.secondary = tuple(secondary)
        self.dest = dest
        self.kind = kind
        self.choices = choices
        self.path_exists = path_exists
        self.metavar = metavar
        self.help = help
        if default is None and kind in ("flag", "count", "multiple"):
            default = {"flag": False, "count": 0, "multiple": ()}[kind]
        self.default = default

    @property
    def takes_value(self):
        return self.kind in ("value", "multiple")

    def hint(self):
        return " / ".join(repr(o) for o in self.opts)

    def convert(self, value, command=None):
        if self.kind == "multiple":
            return tuple(self._convert_one(v, command) for v in value)
        return self._convert_one(value, command)

    def _convert_one(self, value, command):
        if self.choices is not None and value not in self.choices:
            raise UsageError(f"Invalid value for {self.hint()}: {value!r} is not one of "
                             + ", ".join(repr(c) for c in self.choices) + ".", command)
        if self.path_exists and not os.path.exists(value):
            raise UsageError(f"Invalid value for {self.hint()}: Path {value!r} does not exist.",
                             command)
        if self.dir_path and os.path.isfile(value):
            raise UsageError(f"Invalid value for {self.hint()}: Directory {value!r} is a file.",
                             command)
        if self.integer:
            try:
                return int(value)
            except ValueError:
                raise UsageError(f"Invalid value for {self.hint()}: {value!r} is not a valid "
                                 "integer.", command) from None
        return value


class Argument:
    """One positional argument: ``nargs`` 1 or -1 (the rest), required by
    default with one value and not with the rest, as in click. A
    ``readable_file`` must open for reading, as click's ``File("r")``
    checks (``-``, the standard input, passes)."""

    def __init__(self, dest, *, required=None, nargs=1, default=None, readable_file=False):
        self.dest = dest
        self.required = nargs == 1 if required is None else required
        self.nargs = nargs
        self.default = default if nargs == 1 else ()
        self.readable_file = readable_file

    def convert(self, value, command=None):
        if self.readable_file and value != "-":
            try:
                open(value).close()
            except OSError as e:
                raise UsageError(f"Invalid value for {self.dest.upper()!r}: '{value}': "
                                 f"{e.strerror}", command) from None
        return value

    def metavar(self):
        text = self.dest.upper()
        if not self.required:
            text = f"[{text}]"
        return text + ("..." if self.nargs == -1 else "")


class Namespace:
    def __init__(self, **values):
        self.__dict__.update(values)


class Command:
    """A command: its options and arguments in declaration order, and
    ``run(args, repo, device)``; a group holds sub-commands instead."""

    def __init__(self, name, params, run=None, *, help="", parent=None,
                 ignore_unknown_options=False):
        self.name = name
        self.ignore_unknown_options = ignore_unknown_options
        self.params = list(params)
        self.run = run
        self.help = help
        self.parent = parent
        self.subcommands = None
        self._long, self._short = {}, {}
        for p in self.params:
            if isinstance(p, Option):
                for o in (*p.opts, *p.secondary):
                    (self._short if len(o) == 2 and o[1] != "-" else self._long)[o] = p

    def full_name(self, prog="kart"):
        return prog if self.parent is None else f"{self.parent.full_name(prog)} {self.name}"

    def usage(self, prog="kart"):
        pieces = ["[OPTIONS]"]
        if self.subcommands is not None:
            pieces += ["COMMAND", "[ARGS]..."]
        pieces += [p.metavar() for p in self.params if isinstance(p, Argument)]
        return f"{self.full_name(prog)} {' '.join(pieces)}"

    def help_text(self, prog="kart"):
        lines = [f"Usage: {self.usage(prog)}", ""]
        if self.help:
            lines += [f"  {self.help}", ""]
        rows = []
        for p in self.params:
            if isinstance(p, Option):
                names = ", ".join((*p.opts, *p.secondary))
                if p.choices:
                    names += f" [{'|'.join(p.choices)}]"
                elif p.takes_value:
                    names += f" {p.metavar or 'TEXT'}"
                rows.append((names, p.help))
        rows.append(("--help", "Show this message and exit."))
        lines += ["Options:", *_definitions(rows)]
        if self.subcommands:
            # click's limit at a formatter width of 80 (its test runner's):
            # the width less 6, less the longest name
            limit = 74 - max(len(n) for n in self.subcommands)
            lines += ["", "Commands:", *_definitions(
                [(n, _short_help(c.help, limit)) for n, c in self.subcommands.items()])]
        return "\n".join(lines)

    def parse(self, argv, interspersed=True):
        """argv -> (Namespace, the tokens left after the options for a group)."""
        rargs, largs = list(argv), []
        opts, order = {}, []
        while rargs:
            arg = rargs.pop(0)
            if arg == "--":
                break
            if arg[:1] == "-" and len(arg) > 1:
                if self.ignore_unknown_options and self._unknown(arg):
                    largs.append(arg)  # click keeps it as an argument
                    continue
                self._process_opts(arg, rargs, opts, order)
            elif interspersed:
                largs.append(arg)
            else:
                rargs.insert(0, arg)
                break
        if "--help" in opts:
            raise HelpRequested(self)
        positional = largs + rargs
        if self.subcommands is not None:
            values = self._convert(opts, order, {})
            return Namespace(**values), positional
        given = {}
        for p in self.params:
            if isinstance(p, Argument):
                if p.nargs == -1:
                    given[p.dest], positional = tuple(positional), []
                elif positional:
                    given[p.dest] = positional.pop(0)
                order.append(p)  # given or not, after the options, as click orders them
        values = self._convert(opts, order, given)
        if positional:
            s = "" if len(positional) == 1 else "s"
            raise UsageError(f"Got unexpected extra argument{s} ({' '.join(positional)})", self)
        return Namespace(**values), []

    def _convert(self, opts, order, given):
        seen = []
        for p in order:
            if p not in seen:
                seen.append(p)
        values = {}
        for p in seen + [p for p in self.params if p not in seen]:
            if isinstance(p, Argument):
                if p.required and given.get(p.dest) in (None, ()):
                    hint = p.dest.upper() + ("..." if p.nargs == -1 else "")
                    raise UsageError(f"Missing argument {hint!r}.", self)
                if p.dest in given:
                    values[p.dest] = p.convert(given[p.dest], self)
                else:
                    values[p.dest] = p.default
            elif p.dest in opts:
                value = opts[p.dest]
                values[p.dest] = p.convert(value, self) if p.takes_value else value
            elif p.required:
                raise UsageError(f"Missing option {p.hint()}.", self)
            else:
                values[p.dest] = p.default
        return values

    def _unknown(self, arg):
        """True when ``arg`` names no option of this command (a short
        cluster by its first letter)."""
        name = arg.split("=", 1)[0] if arg[:2] == "--" else arg[:2]
        return name != "--help" and name not in self._long and name not in self._short

    def _process_opts(self, arg, rargs, opts, order):
        explicit = None
        long_opt = arg
        if "=" in arg:
            long_opt, explicit = arg.split("=", 1)
        if long_opt == "--help":
            opts["--help"] = True
            return
        option = self._long.get(long_opt)
        if option is None:
            if arg[:2] != "--":
                self._match_short(arg, rargs, opts, order)
                return
            hints = difflib.get_close_matches(long_opt, [*self._long, "--help"])
            message = f"No such option {long_opt!r}."
            if len(hints) == 1:
                message += f" Did you mean {hints[0]!r}?"
            elif hints:
                message += " (Did you mean one of: " + ", ".join(
                    repr(h) for h in sorted(hints)) + "?)"
            raise UsageError(message, self)
        if option.takes_value:
            if explicit is not None:
                rargs.insert(0, explicit)
            self._store(option, long_opt, self._value(long_opt, rargs), opts, order)
        elif explicit is not None:
            raise UsageError(f"Option {long_opt!r} does not take a value.")
        else:
            self._store(option, long_opt, None, opts, order)

    def _match_short(self, arg, rargs, opts, order):
        for i, ch in enumerate(arg[1:], start=2):
            opt = f"-{ch}"
            option = self._short.get(opt)
            if option is None:
                raise UsageError(f"No such option {opt!r}.", self)
            if option.takes_value:
                if i < len(arg):
                    rargs.insert(0, arg[i:])
                self._store(option, opt, self._value(opt, rargs), opts, order)
                return
            self._store(option, opt, None, opts, order)

    @staticmethod
    def _value(name, rargs):
        if not rargs:
            raise UsageError(f"Option {name!r} requires an argument.")
        return rargs.pop(0)

    @staticmethod
    def _store(option, name, value, opts, order):
        order.append(option)
        if option.kind == "count":
            opts[option.dest] = opts.get(option.dest, 0) + 1
        elif option.kind == "flag":
            opts[option.dest] = name not in option.secondary
        elif option.kind == "multiple":
            opts[option.dest] = (*opts.get(option.dest, ()), value)
        else:
            opts[option.dest] = value


def _short_help(text, limit):
    """click's one-line form of a help text in a group's command list: up
    to the first sentence's end, else whole words within ``limit`` and
    "..." where words were cut."""
    words = text.split()
    total = 0
    for i, word in enumerate(words):
        total += len(word) + (i > 0)
        if total > limit:
            break
        if word[-1] == ".":
            return " ".join(words[: i + 1])
        if total == limit and i != len(words) - 1:
            break
    else:
        return " ".join(words)
    total += len("...")
    while i > 0:
        total -= len(words[i]) + (i > 0)
        if total <= limit:
            break
        i -= 1
    return " ".join(words[:i]) + "..."


def _definitions(rows, col_max=30):
    """click's two-column listing: terms padded to the longest (at most
    ``col_max``) plus two spaces; a longer term puts its text on the next
    line."""
    width = min(max((len(t) for t, _ in rows), default=0), col_max) + 2
    out = []
    for term, text in rows:
        if len(term) <= col_max:
            out.append(f"  {term:<{width}}{text}".rstrip())
        else:
            out += [f"  {term}", f"  {'':<{width}}{text}".rstrip()]
    return out


class Group(Command):
    """A command that holds others: its options, then one of ``commands``
    (a dict of :class:`Command` or :class:`Group`). The top level is one;
    a group inside it, such as ``export``, takes its own sub-command."""

    def __init__(self, name, params, commands, help=""):
        super().__init__(name, params, help=help)
        self.subcommands = dict(commands)
        for cmd in self.subcommands.values():
            cmd.parent = self

    def resolve(self, argv):
        """argv -> (this group's Namespace, the command named, its
        Namespace), going down through nested groups."""
        if not argv and self.parent is not None:
            raise NoArgsIsHelp(self)
        values, rest = self.parse(argv, interspersed=False)
        if getattr(values, "version", False):
            raise VersionRequested()
        if not rest:
            raise UsageError("Missing command.", self)
        name, rest = rest[0], rest[1:]
        cmd = self.subcommands.get(name)
        if cmd is None:
            raise UsageError(f"No such command {name!r}.", self)
        if isinstance(cmd, Group):
            _, cmd, args = cmd.resolve(rest)
            return values, cmd, args
        args, _ = cmd.parse(rest)
        return values, cmd, args
