"""``kart stats``: the telemetry metrics, as a Prometheus-style text
exposition (docs/OBSERVABILITY.md §4).

Against a TARGET (an http(s):// or ssh:// URL, or a configured remote
name) it asks the running server for its live metric registry: requests
per verb, bytes shipped, fetch resumes, receive-pack outcomes, retries.
With no target it dumps this process's own registry (with
``KART_METRICS=1``).

Counterpart of kart_tpu's ``cli/stats_cmds.py``, with its options, output
and messages.
"""

import json as _json

from kart_tpu_torch.cli.parser import Argument, Command, Option
from kart_tpu_torch.cli.repo_cmds import _CliError, _refusable


def commands():
    stats = Command("stats", [
        Option("--output-format", "-o", dest="output_format", choices=["text", "json"],
               default="text",
               help="text = Prometheus exposition; json = structured snapshot "
                    "(local registry only)"),
        Argument("target", required=False),
    ], _refusable(run_stats), help="Dump telemetry metrics.")
    stats.needs_repo = "lazy"
    return [stats]


def _resolve_target(open_repo, target):
    """remote name -> its configured URL (needs a repository); URLs pass
    through."""
    from kart_tpu_torch.transport.remote import is_http_url
    from kart_tpu_torch.transport.stdio import is_ssh_url

    if is_http_url(target) or is_ssh_url(target):
        return target
    url = open_repo().remote_url(target)
    if url is None:
        raise _CliError(f"No such remote: {target!r}")
    return url


def fetch_remote_stats(url):
    """-> the Prometheus text exposition of the server at ``url``."""
    from kart_tpu_torch.transport.http import API, http_timeout
    from kart_tpu_torch.transport.remote import is_http_url
    from kart_tpu_torch.transport.stdio import StdioRemote, is_ssh_url

    if is_http_url(url):
        from urllib.request import Request, urlopen

        with urlopen(Request(url.rstrip("/") + f"{API}/stats"), timeout=http_timeout()) as resp:
            return resp.read().decode()
    if is_ssh_url(url):
        remote = StdioRemote(url)
        try:
            resp, _ = remote._rpc({"op": "stats"})
        finally:
            remote.close()
        return resp.get("metrics", "")
    raise _CliError(
        f"Cannot fetch stats from {url!r}: expected an http(s):// or "
        f"ssh:// URL (or a configured remote name)"
    )


def run_stats(args, open_repo, device):
    from kart_tpu_torch import telemetry
    from kart_tpu_torch.telemetry import sinks

    if args.target:
        try:
            text = fetch_remote_stats(_resolve_target(open_repo, args.target))
        except OSError as e:
            raise _CliError(f"Cannot reach {args.target!r}: {e}")
        print(text.rstrip("\n"))
        return 0
    if args.output_format == "json":
        print(_json.dumps(telemetry.snapshot(), indent=2, default=str))
        return 0
    text = sinks.prometheus_text()
    if text:
        print(text.rstrip("\n"))
    else:
        print("# no metrics recorded in this process "
              "(enable with KART_METRICS=1, or pass a server URL)")
    return 0
