"""The port's observability layer (``repro_torch.obs``) against ``repro.obs``.

Same call sequences on both sides, same text out: the registry's
Prometheus render and its parse, histogram quantiles, the tracer ring and
its Chrome and jsonl exports, the ``export-trace`` CLI and the offline
``trace_analysis`` summaries. Engine wiring (registry deltas equal to the
meters, traced runs): ``test_torch_engine_obs.py``.
"""
import json
import math
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest

pytest.importorskip("jax")

import repro.obs as jobs  # noqa: E402
from repro.obs import __main__ as jobs_cli  # noqa: E402
from repro.runtime import trace_analysis as j_ta  # noqa: E402

import repro_torch.obs as tobs  # noqa: E402
from repro_torch.obs import __main__ as tobs_cli  # noqa: E402
from repro_torch.runtime import trace_analysis as t_ta  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _fill_registry(mod):
    """One call sequence against a fresh registry of ``mod``."""
    reg = mod.MetricsRegistry(enabled=True)
    c = reg.counter("t_bytes_total", "bytes moved", ("kind",))
    c.labels(kind="h2d").inc(7)
    c.labels(kind="disk").inc(3.5)
    c.labels("h2d").inc(2**60)
    reg.gauge("t_depth", "queue depth").set(4)
    reg.gauge("t_ratio", "", ("direction", "strategy")).labels(
        direction="read", strategy='s"p\\u\n'
    ).set(0.1 + 0.2)
    h = reg.histogram("t_latency_seconds", "latency", ("route",), buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.labels(route="a").observe(v)
    reg.histogram("t_plain_seconds", "plain").observe(0.003)
    reg.counter("t_off_total").inc(-1.5)
    return reg


def test_render_and_parse_match_the_reference():
    jreg, treg = _fill_registry(jobs), _fill_registry(tobs)
    assert treg.render() == jreg.render()
    assert tobs.parse_prometheus(treg.render()) == jobs.parse_prometheus(jreg.render())
    parsed = tobs.parse_prometheus(treg.render())
    assert parsed[("t_bytes_total", (("kind", "h2d"),))] == 7.0 + 2.0**60
    assert parsed[("t_latency_seconds_bucket", (("le", "+Inf"), ("route", "a")))] == 5
    for name, kw in (
        ("t_bytes_total", {"kind": "disk"}),
        ("t_latency_seconds", {"route": "a"}),
        ("t_depth", {}),
        ("t_missing", {}),
    ):
        assert treg.value(name, **kw) == jreg.value(name, **kw)


def test_disabled_registry_and_registration_rules():
    for mod in (jobs, tobs):
        reg = mod.MetricsRegistry(enabled=False)
        c = reg.counter("t_total")
        c.inc(5)
        reg.gauge("t_g").set(9)
        reg.histogram("t_h").observe(0.1)
        assert reg.value("t_total") == reg.value("t_g") == reg.value("t_h") == 0.0
        reg.set_enabled(True)
        c.inc(5)
        assert reg.value("t_total") == 5.0
        assert reg.counter("t_total") is c
        with pytest.raises(ValueError):
            reg.gauge("t_total")
        with pytest.raises(ValueError):
            reg.counter("t_total", labelnames=("other",))
        with pytest.raises(ValueError):
            reg.counter("t_l", labelnames=("a",)).labels("x", "y")


def test_env_switch(monkeypatch):
    monkeypatch.setenv("REPRO_OBS", "0")
    assert not tobs.MetricsRegistry().enabled
    monkeypatch.setenv("REPRO_OBS", "1")
    assert tobs.MetricsRegistry().enabled


@pytest.mark.parametrize("q", [0.0, 0.1, 0.25, 0.5, 0.6, 0.9, 0.99, 1.0])
def test_histogram_quantiles_match(q):
    values = (0.0004, 0.002, 0.002, 0.03, 0.03, 0.03, 0.4, 2.0, 7.5, 99.0)
    hs = [mod.HistogramValue() for mod in (jobs, tobs)]
    for h in hs:
        assert h.quantile(q) == 0.0
        for v in values:
            h.observe(v)
    jq, tq = (h.quantile(q) for h in hs)
    assert tq == jq and math.isfinite(tq)
    assert hs[1].counts == hs[0].counts and hs[1].sum == hs[0].sum


def _record(mod, capacity):
    tr = mod.Tracer(capacity=capacity)
    tr.record("run", 1.0, 2.5, cat="engine", args={"run": 1, "program": "pagerank"})
    for k in range(5):
        tr.record(
            "sweep", 1.0 + k * 0.25, 1.2 + k * 0.25, cat="engine", tid_label="sweeps",
            args={"run": 1, "sweep": k, "bytes_h2d": 64.0 * k, "bytes_disk_read": 8.0},
        )
    tr.record("stage_pins", 0.5, 0.25, cat="staging")  # negative span -> 0
    return tr


@pytest.mark.parametrize("capacity", [3, 64])
def test_tracer_ring_and_exports_match(capacity, tmp_path):
    jt, tt = _record(jobs, capacity), _record(tobs, capacity)
    assert len(tt.spans()) == min(capacity, 7)
    assert [s.seq for s in tt.spans()] == [s.seq for s in jt.spans()]
    assert json.dumps(tt.to_chrome()) == json.dumps(jt.to_chrome())
    mark = 4
    assert json.dumps(tt.to_chrome(since=mark)) == json.dumps(jt.to_chrome(since=mark))
    for suffix in (".json", ".jsonl"):
        a, b = tmp_path / f"j{suffix}", tmp_path / f"t{suffix}"
        jt.export(str(a))
        tt.export(str(b))
        assert b.read_text() == a.read_text()
    tt.clear()
    assert tt.spans() == []


def test_span_context_manager_gates_on_enabled():
    tr = tobs.Tracer()
    with tr.span("off"):
        pass
    assert tr.spans() == []
    tr.enabled = True
    with tr.span("on", cat="staging", tiles=3):
        pass
    (span,) = tr.spans()
    assert (span.name, span.cat, span.args_dict()) == ("on", "staging", {"tiles": 3})


def test_enable_tracing_resizes_in_place():
    before = tobs.TRACER
    try:
        assert tobs.enable_tracing(capacity=16) is before and before.enabled
        assert before._ring.maxlen == 16
    finally:
        tobs.disable_tracing()
        tobs.enable_tracing(capacity=65536)
        tobs.disable_tracing()
    assert not tobs.TRACER.enabled


@pytest.mark.parametrize("src_kind", ["jsonl", "chrome"])
def test_export_trace_cli_matches(src_kind, tmp_path, capsys):
    tr = _record(tobs, 64)
    src = tmp_path / ("spans.jsonl" if src_kind == "jsonl" else "trace.json")
    tr.export(str(src))
    assert tobs_cli.main(["export-trace", str(src), "-o", str(tmp_path / "t.json")]) == 0
    t_out = capsys.readouterr().out
    assert jobs_cli.main(["export-trace", str(src), "-o", str(tmp_path / "j.json")]) == 0
    j_out = capsys.readouterr().out
    assert t_out.replace("t.json", "X") == j_out.replace("j.json", "X")
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    doc = json.loads((tmp_path / "t.json").read_text())
    assert sum(e["ph"] == "X" for e in doc["traceEvents"]) == 7


def test_export_trace_cli_runs_as_a_module(tmp_path):
    src = tmp_path / "spans.jsonl"
    _record(tobs, 64).export(str(src))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "export-trace", str(src)],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "7 spans" in out.stdout and (tmp_path / "spans.json").exists()


@pytest.mark.parametrize("fmt", ["json", "jsonl"])
def test_trace_analysis_matches(fmt, tmp_path):
    tr = _record(tobs, 64)
    path = str(tmp_path / f"t.{fmt}")
    tr.export(path)
    t_ev, j_ev = t_ta.load_events(path), j_ta.load_events(path)
    assert t_ev == j_ev
    t_sum, j_sum = t_ta.run_summaries(t_ev), j_ta.run_summaries(j_ev)
    assert t_sum == j_sum
    (run,) = t_sum
    assert run["sweeps"] == 5 and run["bytes_h2d"] == 64.0 * 10 and run["bytes_disk_read"] == 40.0
    assert t_ta.fmt_run_table(t_sum) == j_ta.fmt_run_table(j_sum)


def test_telemetry_server_routes():
    reg = _fill_registry(tobs)
    calls = []
    health = {"status": "ok"}
    srv = tobs.TelemetryServer(
        registry=reg, on_scrape=lambda: calls.append(1), health_fn=lambda: health
    )
    with srv:
        body = urllib.request.urlopen(srv.url("/metrics"), timeout=10).read().decode()
        assert body == reg.render() and calls == [1]
        doc = json.loads(urllib.request.urlopen(srv.url("/healthz"), timeout=10).read())
        assert doc == {"status": "ok"}
        health["status"] = "degraded"
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(srv.url("/healthz"), timeout=10)
        assert err.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(srv.url("/nope"), timeout=10)
        assert err.value.code == 404
    with pytest.raises(RuntimeError):
        srv.address
