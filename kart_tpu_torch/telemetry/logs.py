"""One logging configuration for every entry point.

Before this module, ``kart_tpu_torch`` only configured logging when the CLI got
``-v`` (a ``logging.basicConfig`` on the root logger) — library users and
the spawned servers (``kart serve``, ``ssh … kart serve-stdio``) ran with
bare-root defaults: WARNING-level, ``lastResort`` formatting, and any
host application's root handlers double-printing our records.

Now everything routes through the single ``kart_tpu_torch`` logger: one stderr
handler, one format. Propagation stays ON so host applications (and test
harnesses like pytest's caplog) that attach root handlers still observe
our records — they own that trade-off; we only guarantee our own handler
never stacks. The level comes from CLI verbosity (``-v`` INFO, ``-vv``
DEBUG) or, for non-CLI entry points, the ``KART_LOG`` env var (a level
name: ``debug``/``info``/``warning``/``error``, case-insensitive — the
same switch reaches spawned servers without plumbing). Every module in the
package already names its logger under ``kart_tpu_torch.*`` (``__name__`` or an
explicit dotted name), so one parent covers the tree.
"""

import logging
import os
import sys

from kart_tpu_torch.telemetry import context as _rctx

#: ``rid`` is the active request id (``-`` outside a request scope) — every
#: log line a server emits while handling a request is correlatable with
#: that request's access-log record and trace spans
LOG_FORMAT = "%(asctime)s %(levelname)s %(name)s rid=%(rid)s %(message)s"


class _RequestIdFilter(logging.Filter):
    """Stamp the active request context's id onto every record our handler
    formats (filters run per-handler, so records reaching host/root
    handlers are untouched)."""

    def filter(self, record):
        ctx = _rctx.current()
        record.rid = ctx.request_id if ctx is not None else "-"
        return True

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "warn": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def level_from_env(environ=os.environ):
    """The ``KART_LOG`` level, or None when unset/unparseable."""
    raw = (environ.get("KART_LOG") or "").strip().lower()
    return _LEVELS.get(raw)


def configure_logging(verbosity=0, stream=None):
    """Attach the single ``kart_tpu_torch`` handler (idempotent: re-calls update
    level and stream in place, never stack handlers).

    Level precedence: explicit ``verbosity`` (1 = INFO, 2+ = DEBUG) when
    positive, else ``KART_LOG``, else WARNING. -> the configured logger.

    ``stream``: where records go (default ``sys.stderr``, resolved at call
    time so CLI test runners that swap stderr see the records). stdout is
    never used — the stdio transport server's frame discipline forbids it.
    """
    logger = logging.getLogger("kart_tpu_torch")
    env_level = level_from_env()
    if verbosity and verbosity > 0:
        level = logging.DEBUG if verbosity > 1 else logging.INFO
    elif env_level is not None:
        level = env_level
    else:
        level = logging.WARNING
    handler = None
    for h in logger.handlers:
        if getattr(h, "_kart_tpu_handler", False):
            handler = h
            break
    if handler is None:
        handler = logging.StreamHandler(stream or sys.stderr)
        handler._kart_tpu_handler = True
        handler.setFormatter(logging.Formatter(LOG_FORMAT))
        handler.addFilter(_RequestIdFilter())
        logger.addHandler(handler)
    elif stream is not None:
        handler.setStream(stream)
    logger.setLevel(level)
    return logger
