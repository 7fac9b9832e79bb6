"""``kart top``: a live view of a running server (docs/OBSERVABILITY.md
§11).

Polls the server's structured stats document (``GET
/api/v1/stats?format=json`` over HTTP, the ``stats`` op with ``format:
"json"`` over ssh) and renders request rates over the configured windows,
per-verb latency percentiles from the server's own bucketed histograms,
inflight and queue depth, shed and cache counters, and the newest
slow-request exemplars.

Counterpart of kart_tpu's ``cli/top_cmds.py``, with its frame.
"""

import json as _json
import time

from kart_tpu_torch.cli.parser import Argument, Command, Option
from kart_tpu_torch.cli.repo_cmds import _CliError, _refusable
from kart_tpu_torch.cli.stats_cmds import _resolve_target


def commands():
    top = Command("top", [
        Option("--interval", "-i", dest="interval", default="2.0",
               help="Refresh interval (seconds)"),
        Option("--once", dest="once", kind="flag", help="Print one frame and exit (scripts/tests)"),
        Argument("target"),
    ], _refusable(run_top), help="Live server dashboard: request rates, latency percentiles, "
                                 "queue depth, shed/cache counters and slow-request exemplars.")
    top.needs_repo = "lazy"
    return [top]


def fetch_stats_json(url):
    """-> the parsed stats document of the server at ``url``."""
    from kart_tpu_torch.transport.http import API, http_timeout
    from kart_tpu_torch.transport.remote import is_http_url
    from kart_tpu_torch.transport.stdio import StdioRemote, is_ssh_url

    if is_http_url(url):
        from urllib.request import Request, urlopen

        with urlopen(Request(url.rstrip("/") + f"{API}/stats?format=json"),
                     timeout=http_timeout()) as resp:
            return _json.loads(resp.read().decode())
    if is_ssh_url(url):
        remote = StdioRemote(url)
        try:
            resp, _ = remote._rpc({"op": "stats", "format": "json"})
        finally:
            remote.close()
        return resp.get("stats", {})
    raise _CliError(
        f"Cannot fetch stats from {url!r}: expected an http(s):// or "
        f"ssh:// URL (or a configured remote name)"
    )


def _hist_by_verb(snapshot, name):
    """{verb: hist dict} for a labelled histogram family."""
    out = {}
    for n, labels, h in snapshot.get("histograms", ()):
        if n == name and "verb" in labels:
            out[labels["verb"]] = h
    return out


def _rate_of(rates_window, name, verb=None):
    total = 0.0
    hit = False
    for n, labels, rate in rates_window:
        if n != name:
            continue
        if verb is not None and labels.get("verb") != verb:
            continue
        total += rate
        hit = True
    return total if hit else 0.0


def _counter_total(snapshot, name):
    return sum(v for n, _l, v in snapshot.get("counters", ()) if n == name)


def _gauge(snapshot, name):
    for n, _l, v in snapshot.get("gauges", ()):
        if n == name:
            return v
    return 0


def render_top(payload, url):
    """One text frame of the live view."""
    snap = payload.get("snapshot", {})
    rates = payload.get("rates", {})
    windows = sorted(rates, key=lambda w: float(w.rstrip("s")))
    hists = _hist_by_verb(snap, "server.request_seconds")

    lines = [
        f"kart top — {url}",
        f"inflight {payload.get('inflight', _gauge(snap, 'server.inflight'))}"
        f"  queue depth {_gauge(snap, 'server.merge_queue.depth')}"
        f"  shed {_counter_total(snap, 'server.shed'):.0f}"
        f"  slow {_counter_total(snap, 'server.slow_requests'):.0f}"
        f"  trace drops {payload.get('events_dropped', 0)}",
    ]
    fleet = payload.get("fleet")
    if fleet:
        # the fleet operator's staleness line (docs/FLEET.md §3): how far
        # this replica's view trails, and where its writes/reads went
        lag = fleet.get("lag_seconds")
        hits = _counter_total(snap, "fleet.peer_cache.hits")
        misses = _counter_total(snap, "fleet.peer_cache.misses")
        peer = (
            f"  peer cache {hits / (hits + misses):.0%} hit"
            if hits + misses
            else ""
        )
        lines.append(
            f"{fleet.get('role', '?')} of {fleet.get('primary') or '-'}"
            f"  lag {f'{lag:.1f}s' if lag is not None else '-'}"
            f"  proxied writes {fleet.get('proxied_writes', 0)}"
            f"  ryw stalls/pins {fleet.get('ryw_stalls', 0)}"
            f"/{fleet.get('ryw_pins', 0)}{peer}"
        )
    events = payload.get("events")
    if events:
        # the live-update path at a glance (docs/EVENTS.md §7): who is
        # listening, how far the log has advanced, how fast the last
        # announcement fanned out, and whether the warmer is keeping up
        fanout = events.get("last_fanout_seconds")
        warm = events.get("last_warm") or {}
        lines.append(
            f"events  watchers {events.get('watchers', 0)}"
            f"  head seq {events.get('head_seq', 0)}"
            f"  warm queue {events.get('queue_depth', 0)}"
            f"  last fanout "
            f"{f'{fanout * 1000:.0f}ms' if fanout is not None else '-'}"
            f"  last warm {warm.get('tiles', 0)} tiles"
            f"/{warm.get('errors', 0)} err"
        )
    query = payload.get("query")
    if query:
        # the query engine at a glance (docs/QUERY.md §7): how much work
        # ran, how much the pushdown pruned away, and whether the scatter
        # and cache tiers are earning their keep
        lines.append(
            f"query  scans {query.get('scans', 0)}"
            f"  joins {query.get('joins', 0)}"
            f"  blocks pruned {query.get('blocks_pruned', 0)}"
            f"  pairs {query.get('pairs_emitted', 0)}"
            f"  scatter parts {query.get('scatter_parts', 0)}"
            f"  cache {query.get('cache_hits', 0)}h"
            f"/{query.get('cache_misses', 0)}m"
        )
    lines.append("")
    rate_heads = "".join(f"  req/s({w})" for w in windows)
    lines.append(
        f"{'verb':<14}{rate_heads}  {'count':>7}  {'p50':>8}  {'p90':>8}  "
        f"{'p99':>8}  {'max':>8}"
    )
    verbs = sorted(
        set(hists)
        | {
            labels.get("verb")
            for n, labels, _v in snap.get("counters", ())
            if n == "transport.server.requests" and labels.get("verb")
        }
    )
    for verb in verbs:
        h = hists.get(verb)
        cells = "".join(
            f"  {_rate_of(rates.get(w, ()), 'transport.server.requests', verb):>10.2f}"
            for w in windows
        )
        if h:
            lines.append(
                f"{verb:<14}{cells}  {h['count']:>7d}  {h['p50']:>8.3f}  "
                f"{h['p90']:>8.3f}  {h['p99']:>8.3f}  {h['max']:>8.3f}"
            )
        else:
            lines.append(f"{verb:<14}{cells}  {0:>7}  {'-':>8}  {'-':>8}  {'-':>8}  {'-':>8}")
    tiles_rates = "".join(
        f"  {_rate_of(rates.get(w, ()), 'tiles.served'):>10.2f}" for w in windows
    )
    if any(n == "tiles.served" for n, _l, _v in snap.get("counters", ())):
        lines.append(f"{'tiles/s':<14}{tiles_rates}")
    exemplars = payload.get("exemplars") or []
    if exemplars:
        lines.append("")
        lines.append(f"slow requests (last {len(exemplars)}):")
        for ex in exemplars[-3:]:
            spans = sorted(
                ex.get("spans", ()), key=lambda s: -s.get("dur", 0)
            )
            frames = ", ".join(
                f"{s['name']} {s['dur']:.3f}s" for s in spans[:3]
            )
            lines.append(
                f"  {ex.get('verb', '?'):<13} {ex.get('seconds', 0):>8.3f}s"
                f"  id={ex.get('request_id', '-')}"
                + (f"  [{frames}]" if frames else "")
            )
    return "\n".join(lines)


def run_top(args, open_repo, device):
    try:
        interval = float(args.interval)
    except ValueError:
        from kart_tpu_torch.cli.parser import UsageError

        raise UsageError(f"Invalid value for '--interval' / '-i': {args.interval!r} is not a "
                         "valid float.") from None
    url = _resolve_target(open_repo, args.target)
    while True:
        try:
            payload = fetch_stats_json(url)
        except OSError as e:
            raise _CliError(f"Cannot reach {args.target!r}: {e}")
        except ValueError as e:
            # a proxy error page or an old server answered with non-JSON
            raise _CliError(
                f"{args.target!r} did not return the JSON stats document "
                f"(old server version, or a proxy in the way?): {e}"
            )
        frame = render_top(payload, url)
        if args.once:
            print(frame)
            return 0
        print("\033[2J\033[1;1H" + frame, flush=True)
        time.sleep(max(0.2, interval))
