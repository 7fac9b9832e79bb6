"""The port's telemetry against kart_tpu's, on the CPU: each scenario runs
against both packages' ``telemetry`` (spans, counters, gauges, histograms
and their quantiles, the Prometheus exposition, the Chrome trace, the
access log and its slow-request exemplars, ``traceparent`` and the request
scopes, ``configure_logging``) and must give the same result; the CLI's
``-v`` and ``--trace`` write the phase summary and the trace as kart_tpu's
do."""

import contextlib
import io
import json
import logging
import os

import pytest

import kart_tpu.telemetry as jtm
import kart_tpu_torch.telemetry as ttm
from kart_tpu.telemetry import access as jaccess
from kart_tpu.telemetry import context as jcontext
from kart_tpu.telemetry import core as jcore
from kart_tpu.telemetry import sinks as jsinks
from kart_tpu_torch.telemetry import access as taccess
from kart_tpu_torch.telemetry import context as tcontext
from kart_tpu_torch.telemetry import core as tcore
from kart_tpu_torch.telemetry import sinks as tsinks

PACKAGES = {
    "k": (jtm, jcore, jsinks, jcontext, jaccess),
    "p": (ttm, tcore, tsinks, tcontext, taccess),
}


@pytest.fixture(autouse=True)
def _clean():
    for tm, *_ in PACKAGES.values():
        tm.reset()
    yield
    for tm, *_ in PACKAGES.values():
        tm.reset()


def _both(scenario):
    got = {side: scenario(*mods) for side, mods in PACKAGES.items()}
    assert got["p"] == got["k"]
    return got["p"]


def _counters(tm, core, sinks, context, access):
    tm.enable(metrics=True)
    tm.incr("transport.retries", verb="fetch-pack")
    tm.incr("transport.retries", 2, verb="fetch-pack")
    tm.incr("odb.objects_read", 7)
    tm.gauge_set("server.inflight", 3)
    tm.gauge_set("server.inflight", 1)
    for v in (0.0004, 0.003, 0.02, 0.2, 1.5, 30.0, 500.0):
        tm.observe("tiles.cache.fill_seconds", v)
    return tm.snapshot(), sinks.prometheus_text()


def _disabled(tm, core, sinks, context, access):
    with tm.span("diff.classify", rows=5):
        pass
    tm.incr("odb.objects_read")
    tm.observe("odb.bytes_inflated", 10)
    return tm.snapshot(), tm.drain_events(), sinks.prometheus_text()


def _quantiles(tm, core, sinks, context, access):
    tm.enable(metrics=True)
    for i in range(1, 200):
        tm.observe("server.request_seconds", (i % 37) * 0.013, verb="ls-refs")
    tm.observe("server.request_seconds", 0.5, verb="stats")
    return tm.snapshot()["histograms"], sinks.prometheus_text()


def _span_names(tm, core, sinks, context, access):
    tm.enable(trace=True)
    with tm.span("transport.request", verb="x"):
        with tm.span("server.enum_walk"):
            with tm.span("odb.read_blobs_batch"):
                pass
        with tm.span("server.enum_walk"):
            pass

    @tm.span("diff.decorated")
    def work():
        return 1

    work()
    events = tm.drain_events()
    counts = [(n, l, h["count"]) for n, l, h in tm.snapshot()["histograms"]]
    return sorted(e["name"] for e in events), sorted(counts), core.all_metric_names()


def _traceparent(tm, core, sinks, context, access):
    out = []
    for value in (None, "", "garbage", "00-xyz-abc-01", 42, "00-" + "a" * 31,
                  "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
                  "00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-01",
                  "ff-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"):
        out.append(context.parse_traceparent(value))
    wire = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
    with tm.request_scope(verb="fetch-pack", traceparent=wire) as srv:
        out.append((srv.trace_id, srv.request_id, srv.traceparent()))
    root = tm.set_root_request(verb="clone")
    with tm.request_scope(verb="ls-refs") as a:
        out.append((a.trace_id == root.trace_id, a.parent_id == root.request_id))
    with tm.request_scope(verb="x", inherit=False) as b:
        out.append((b.trace_id == root.trace_id, b.parent_id))
    return out


def _access_record(tm, core, sinks, context, access):
    tm.enable(metrics=True)
    wire = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
    with tm.request_scope(verb="fetch-pack", traceparent=wire, record=True) as ctx:
        tm.annotate(shed=True, enum_cache="hit", nothing=None)
        with tm.span("server.enum_walk"):
            pass
        record = access.record_request(verb="fetch-pack", status=200, bytes_in=10,
                                       bytes_out=20, seconds=0.01, ctx=ctx)
    record = dict(record)
    record.pop("ts", None)
    payload = access.stats_payload(extra={"inflight": 0})
    hists = [(n, l) for n, l, _h in payload["snapshot"]["histograms"]]
    return record, sorted(payload), sorted(hists), [s["name"] for s in ctx.span_tree()]


def _slow_exemplars(tm, core, sinks, context, access):
    os.environ["KART_SLOW_REQUEST_SECONDS"] = "0.001"
    try:
        tm.enable(metrics=True)
        with tm.request_scope(verb="fetch-pack", record=access.slow_threshold() is not None) as c:
            with tm.span("server.enum_walk"):
                pass
            access.record_request(verb="fetch-pack", status=200, seconds=0.5, ctx=c)
        ex = access.exemplars()
        return len(ex), ex[0]["verb"], [s["name"] for s in ex[0]["spans"]]
    finally:
        del os.environ["KART_SLOW_REQUEST_SECONDS"]


def _env(tm, core, sinks, context, access):
    tm.enable_from_env({"KART_METRICS": "1"})
    on = (tm.metrics_enabled(), tm.tracing_enabled())
    tm.reset()
    tm.enable_from_env({"KART_TRACE": "1"})
    return on, (tm.metrics_enabled(), tm.tracing_enabled()), access.stats_windows(
        {"KART_STATS_WINDOWS": "5,30"}), access.slow_threshold({"KART_SLOW_REQUEST_SECONDS": "x"})


def _logging(tm, core, sinks, context, access):
    name = "kart_tpu" if tm is jtm else "kart_tpu_torch"
    os.environ["KART_LOG"] = "debug"
    try:
        tm.configure_logging(0)
        tm.configure_logging(0)
        logger = logging.getLogger(name)
        level = logger.level
        handlers = len([h for h in logger.handlers
                        if getattr(h, f"_{name}_handler", False)
                        or getattr(h, "_kart_tpu_handler", False)])
    finally:
        del os.environ["KART_LOG"]
    tm.configure_logging(2)
    return level, handlers, logging.getLogger(name).level


def _chrome(tm, core, sinks, context, access, tmp=None):
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        tm.enable(trace=True, trace_path=path)
        with tm.span("cli.command"):
            with tm.span("diff.classify", rows=3):
                pass
        written = sinks.write_chrome_trace()
        with open(written) as f:
            doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return sorted({e.get("name") for e in events if e.get("ph") in ("X", "B", "E")})


SCENARIOS = {
    "counters": _counters,
    "disabled": _disabled,
    "quantiles": _quantiles,
    "span_names": _span_names,
    "traceparent": _traceparent,
    "access_record": _access_record,
    "slow_exemplars": _slow_exemplars,
    "env": _env,
    "logging": _logging,
    "chrome": _chrome,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equal(name):
    _both(SCENARIOS[name])


def test_naming_grammar_and_subsystems_equal():
    assert tcore.SUBSYSTEMS == jcore.SUBSYSTEMS
    assert tcore.NAME_RE.pattern == jcore.NAME_RE.pattern
    assert tcore.BUCKET_BOUNDS == jcore.BUCKET_BOUNDS


def test_port_metric_names_follow_the_grammar():
    """Every literal name the port passes to ``tm.incr``/``span``/
    ``observe``/``gauge_set`` is a dotted name of a known subsystem."""
    import ast

    import kart_tpu_torch

    pkg = os.path.dirname(kart_tpu_torch.__file__)
    bad = []
    for d, dirs, names in os.walk(pkg):
        dirs[:] = [x for x in dirs if x != "_build"]
        for n in names:
            if not n.endswith(".py"):
                continue
            with open(os.path.join(d, n)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name) and node.func.value.id == "tm"
                        and node.func.attr in ("incr", "span", "observe", "gauge_set")
                        and node.args and isinstance(node.args[0], ast.Constant)):
                    name = node.args[0].value
                    if not (tcore.NAME_RE.match(name)
                            and name.split(".")[0] in tcore.SUBSYSTEMS):
                        bad.append((n, name))
    assert bad == []


def _port_cli(argv):
    from kart_tpu_torch.cli import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_cli_verbose_prints_the_phase_summary(tmp_path):
    from helpers import make_repo_with_edits

    path = make_repo_with_edits(tmp_path)[0]
    rc, out, err = _port_cli(["--device", "cpu", "-C", path, "-v", "diff", "-o", "json",
                              "HEAD^...HEAD"])
    assert rc == 0 and json.loads(out) and "cli.command" in err
    rc2, out2, err2 = _port_cli(["--device", "cpu", "-C", path, "diff", "-o", "json",
                                 "HEAD^...HEAD"])
    assert out2 == out and err2 == ""
    ttm.reset()


def test_cli_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    from helpers import make_repo_with_edits

    path = make_repo_with_edits(tmp_path)[0]
    target = tmp_path / "t.json"
    monkeypatch.setenv("KART_TRACE", str(target))
    rc, out, err = _port_cli(["--device", "cpu", "-C", path, "--trace", "diff", "-o",
                              "json", "HEAD^...HEAD"])
    assert rc == 0 and f"Trace written to {target}" in err
    with open(target) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    assert any(e.get("name") == "cli.command" or e.get("ph") == "M" for e in events)
    ttm.reset()


@pytest.mark.parametrize("argv", [["-vv", "stats"], ["--reprobe", "stats"],
                                  ["--verbose", "--trace", "stats"]])
def test_global_options_accepted(argv, tmp_path, monkeypatch):
    monkeypatch.setenv("KART_TRACE", str(tmp_path / "t.json"))
    rc, out, err = _port_cli(["--device", "cpu", *argv])
    assert rc == 0 and out.startswith("#")
    ttm.reset()
