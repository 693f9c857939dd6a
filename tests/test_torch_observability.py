"""Port parity: ``repro_torch.observability`` (report, export, metrics, prom,
events), ``core.decompose`` and the serving launcher's telemetry flags,
against ``repro``'s modules; and the port's own spans: where they nest,
that they cost nothing and wait for nothing, and their clock.

The report and the exporter read span forests, so both packages are given
the same span JSON (recorded by either package's ``carla_conv``) and must
build the same rows, totals, table text and trace events (the exporter's
process name, ``repro_torch.carla``, aside).  Metrics, Prometheus text and
events are stdlib code fed the same operations: equal outputs, exactly.
``conv_from_pieces`` is held to ``repro``'s on the same numpy inputs within
1e-5 (fp32 sums of up to 21 partial convolutions, in different libraries),
and to the direct convolution within 1e-5 x max(1, max|out|).
Mirrors ``tests/test_observability.py`` and
``tests/test_observability_export.py`` where the test applies.
"""
import dataclasses
import json
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import carla as j_carla
from repro.core import decompose as j_decompose
from repro.core.fuse import Epilogue as JEpilogue
from repro.observability import events as j_events
from repro.observability import export as j_export
from repro.observability import metrics as j_metrics
from repro.observability import prom as j_prom
from repro.observability import report as j_report
from repro.observability import trace as j_trace
from repro_torch.core import carla as t_carla
from repro_torch.core import decompose as t_decompose
from repro_torch.core.fuse import Epilogue
from repro_torch.core.sparsity import SparsityTag
from repro_torch.kernels import ops as t_ops
from repro_torch.launch import serve
from repro_torch.models import cnn as t_cnn
from repro_torch.observability import events as t_events
from repro_torch.observability import export as t_export
from repro_torch.observability import metrics as t_metrics
from repro_torch.observability import prom as t_prom
from repro_torch.observability import report as t_report
from repro_torch.observability import trace as t_trace


@pytest.fixture(autouse=True)
def _no_event_logs():
    for ev in (j_events, t_events):
        ev.uninstall()
    yield
    for ev in (j_events, t_events):
        ev.uninstall()


def _arr(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _port_span_json() -> str:
    """Spans of three port dispatches on the CPU: a fused 3x3, a 1x1 and
    a pruned 1x1 with its dense twin."""
    x, w3, w1 = _arr(0, 2, 14, 14, 16), _arr(1, 3, 3, 16, 32), _arr(2, 16, 8)
    t = torch.from_numpy
    ep = Epilogue(scale=t(_arr(3, 32)), bias=t(_arr(4, 32)), relu=True)
    with t_trace.capture() as tr:
        t_carla.carla_conv(t(x), t(w3), padding=1, name="l33", epilogue=ep)
        t_carla.carla_conv(t(x), t(w1), name="l11")
        t_carla.carla_conv(t(x), t(w1), name="l11_pruned",
                           sparsity=SparsityTag(dense_ic=32, dense_k=16))
    return json.dumps([s.to_dict() for s in tr.spans])


def _repro_span_json() -> str:
    x, w3 = _arr(5, 1, 10, 10, 8), _arr(6, 3, 3, 8, 16)
    ep = JEpilogue(bias=jnp.asarray(_arr(7, 16)), relu=True)
    with j_trace.capture() as tr:
        j_carla.carla_conv(jnp.asarray(x), jnp.asarray(w3), padding=1,
                           name="j33", epilogue=ep)
        j_carla.carla_conv(jnp.asarray(x), jnp.asarray(_arr(8, 8, 4)),
                           stride=2, name="j11")
    return json.dumps([s.to_dict() for s in tr.spans])


SPAN_SOURCES = {"port": _port_span_json, "repro": _repro_span_json}


@pytest.fixture(scope="module", params=list(SPAN_SOURCES))
def span_json(request):
    return SPAN_SOURCES[request.param]()


def _forests(payload):
    return (j_trace.tracer.from_json(payload),
            t_trace.tracer.from_json(payload))


# ------------------------------- report ---------------------------------------
def test_reconcile_and_totals_match_repro(span_json):
    j_spans, t_spans = _forests(span_json)
    for peak in (None, 50.0):
        j_rows = j_report.reconcile(j_spans, peak_gflops=peak)
        t_rows = t_report.reconcile(t_spans, peak_gflops=peak)
        assert [dataclasses.asdict(r) for r in t_rows] == \
            [dataclasses.asdict(r) for r in j_rows]
        assert [r.speed_ratio for r in t_rows] == \
            [r.speed_ratio for r in j_rows]
        assert t_report.totals(t_rows) == j_report.totals(j_rows)
        assert t_report.format_table(t_rows) == \
            j_report.format_table(j_rows)
    assert t_report.totals([]) == {} == j_report.totals([])


def test_port_rows_carry_the_ledger():
    rows = t_report.reconcile(t_trace.tracer.from_json(_port_span_json()))
    assert [r.layer for r in rows] == ["l33", "l11", "l11_pruned"]
    assert rows[0].epilogue == "scale+bias+relu" and rows[0].fused_saved_mb > 0
    assert all(r.batch == 2 and r.measured_ms > 0 for r in rows)
    assert max(r.measured_util for r in rows) == pytest.approx(1.0)
    assert rows[2].pruned and rows[2].keep_fraction == pytest.approx(0.25)
    assert not any(r.tuned for r in rows)
    t = t_report.totals(rows)
    assert t["layers"] == 3 and t["pruned_layers"] == 1
    assert "savedMB" in t_report.format_table(rows).splitlines()[0]


# ------------------------------- export ---------------------------------------
def test_chrome_trace_matches_repro(span_json):
    j_spans, t_spans = _forests(span_json)
    j_doc = j_export.to_chrome_trace(j_spans)
    t_doc = t_export.to_chrome_trace(t_spans)
    names = {"repro.carla": "repro_torch.carla"}
    j_evs = [{**e, "args": {"name": names.get(e["args"]["name"],
                                              e["args"]["name"])}}
             if e["name"] == "process_name" else e
             for e in j_doc["traceEvents"]]
    assert t_doc["traceEvents"] == j_evs
    assert t_doc["otherData"] == {
        "exporter": "repro_torch.observability.export"}


def test_chrome_trace_file_has_one_complete_event_per_span(tmp_path):
    spans = t_trace.tracer.from_json(_port_span_json())
    path = tmp_path / "trace.json"
    t_export.export_chrome_trace(spans, str(path))
    doc = json.loads(path.read_text())
    xev = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xev) == sum(1 for root in spans for _ in root.walk()) == 9
    assert [e["name"] for e in xev[:3]] == ["carla_conv", "carla.plan",
                                            "kernels.conv2d"]
    flows = [e for e in doc["traceEvents"] if e["ph"] in ("s", "f")]
    assert len(flows) == 12                   # one arrow per child span
    assert {e["name"] for e in doc["traceEvents"] if e["ph"] == "C"} >= {
        "carla predicted vs measured (ms)", "carla DRAM (MB)"}


def test_export_puts_spans_and_device_ops_on_one_clock(tmp_path):
    # a span 5 us after the anchor's perf reading, a device op 12 us after
    # its wall reading: 7 us apart on the exported timeline
    anchor = t_trace.Anchor(wall_ns=1_790_000_000_000_000_000,
                            perf_ns=40_000_000_000)
    sp = t_trace.Span("kernels.launch", start_s=40.000005,
                      duration_s=3e-6, attrs={"route": "conv2d"})
    op = (anchor.wall_ns + 12_000, anchor.wall_ns + 20_000, "kernel")
    path = tmp_path / "trace.json"
    t_export.export_chrome_trace([sp], str(path), anchor=anchor,
                                 device_ops=[op])
    doc = json.loads(path.read_text())
    xev = {e["pid"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    host, dev = xev[t_export.DEFAULT_PID], xev[t_export.DEFAULT_PID + 1]
    assert host["ts"] == pytest.approx(0.0, abs=1e-3)
    assert dev["ts"] == pytest.approx(7.0, abs=1e-3)
    assert (host["dur"], dev["dur"]) == (pytest.approx(3.0), 8.0)
    assert {"name": t_export.DEVICE_PROCESS_NAME} in [
        e["args"] for e in doc["traceEvents"] if e["ph"] == "M"]
    # without an anchor the device ops have no clock to join
    assert t_export.to_chrome_trace([sp], device_ops=[op]) == \
        t_export.to_chrome_trace([sp])


# ----------------------------- the port's spans -------------------------------
def test_anchor_puts_a_span_on_the_device_trace_clock():
    anchor = t_trace.Anchor(wall_ns=1_790_000_000_123_456_789,
                            perf_ns=2_000_000_000)
    assert anchor.epoch_ns(2.000_250) == 1_790_000_000_123_706_789
    with t_trace.capture() as tr:
        with t_trace.span("x"):
            pass
    # perf_counter and the wall clock, read side by side
    (sp,) = tr.spans
    assert abs(tr.anchor.epoch_ns(sp.start_s) - time.time_ns()) < 5e9


@pytest.fixture(scope="module")
def resnet_smoke():
    params = t_cnn.resnet50_init(torch.Generator().manual_seed(0),
                                 width=0.0625, num_classes=10, device="cpu")
    return params, torch.from_numpy(_arr(9, 1, 32, 32, 3))


def test_a_forward_nests_every_span_under_one_root(resnet_smoke):
    params, x = resnet_smoke
    with t_trace.capture() as tr:
        t_cnn.resnet50_apply(params, x)
    (root,) = tr.spans
    assert (root.name, root.attrs) == ("cnn.forward",
                                       {"net": "resnet50", "batch": 1})
    names = [s.name for s in root.walk()]
    assert (names.count("cnn.pool"), names.count("cnn.head")) == (1, 1)
    convs = tr.find("carla_conv")
    assert len(convs) == names.count("carla.plan") == 53
    for sp in convs:
        plan, kernel = sp.children
        assert plan.name == "carla.plan" and not plan.children
        assert kernel.name in ("kernels.conv2d", "kernels.conv1x1")
        assert sp.duration_s >= plan.duration_s + kernel.duration_s
        assert sp.attrs["layer"] and sp.attrs["bytes_touched"] > 0


def test_tracing_off_makes_no_span_and_reads_no_clock(resnet_smoke,
                                                      monkeypatch):
    params, x = resnet_smoke
    made, reads = [], []
    monkeypatch.setattr(t_trace, "Span",
                        lambda *a, **k: made.append(a) or None)
    clock = time.perf_counter
    monkeypatch.setattr(time, "perf_counter",
                        lambda: reads.append(1) or clock())
    assert not t_trace.enabled()
    t_cnn.resnet50_apply(params, x)
    monkeypatch.undo()
    assert made == [] and reads == []


class _OnCuda(torch.Tensor):
    """A CPU tensor that says it is on CUDA: a span that would wait for the
    device calls ``torch.cuda.synchronize`` on it."""

    @property
    def is_cuda(self):
        return True


DISPATCHES = {
    "carla_conv 3x3": lambda x: t_carla.carla_conv(
        x, x.new_ones(3, 3, 8, 4), padding=1, impl="ref"),
    "carla_conv 1x1": lambda x: t_carla.carla_conv(
        x, x.new_ones(1, 1, 8, 4), impl="ref"),
    "ops.gemm": lambda x: t_ops.gemm(x.reshape(-1, 8), x.new_ones(8, 4),
                                     impl="ref"),
    "ops.conv1d_causal": lambda x: t_ops.conv1d_causal(
        x.reshape(1, -1, 8), x.new_ones(4, 8), impl="ref"),
}


@pytest.mark.parametrize("dispatch", list(DISPATCHES))
def test_no_span_waits_for_the_device(dispatch, monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(a))
    x = torch.from_numpy(_arr(10, 1, 6, 6, 8)).as_subclass(_OnCuda)
    with t_trace.capture() as tr:
        out = DISPATCHES[dispatch](x)
    assert out.is_cuda and tr.spans and syncs == []


# ------------------------------- metrics --------------------------------------
def _fill(m):
    """The same operations on a registry of either package."""
    reg = m.MetricsRegistry()
    reg.counter("tokens").inc(3)
    reg.counter("tokens").inc(2.5)
    reg.gauge("queue depth").set(4)
    reg.gauge("queue depth").dec()
    h = reg.histogram("step_s", buckets=(0.01, 0.1, 1.0))
    lw = reg.latency("decode_token", maxlen=50)
    for v in np.random.default_rng(11).exponential(0.05, 120):
        h.observe(float(v))
        lw.observe(float(v))
    reg.histogram("big").observe(20.0)
    return reg


def test_metrics_match_repro():
    j_reg, t_reg = _fill(j_metrics), _fill(t_metrics)
    assert t_reg.snapshot() == j_reg.snapshot()
    assert t_reg.format() == j_reg.format()
    for p in (0, 50, 90, 99, 100):
        assert t_reg.latencies["decode_token"].percentile(p) == \
            j_reg.latencies["decode_token"].percentile(p)
    assert t_reg.histograms["step_s"].cumulative() == \
        j_reg.histograms["step_s"].cumulative()


def test_prom_render_matches_repro():
    j_reg, t_reg = _fill(j_metrics), _fill(t_metrics)
    text = t_prom.render(t_reg)
    assert text == j_prom.render(j_reg)
    assert "# TYPE repro_tokens_total counter" in text
    assert "repro_queue_depth 3" in text
    assert t_prom.render_all({"serve": t_reg, "": t_reg}) == \
        j_prom.render_all({"serve": j_reg, "": j_reg})
    assert t_prom.render(t_reg, "x") == j_prom.render(j_reg, "x")


def test_metrics_http_exporter_serves_scrape():
    reg = _fill(t_metrics)
    exp = t_prom.MetricsExporter({"serve": reg}, port=0)
    port = exp.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            body = r.read().decode()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert r.read() == b"ok\n"
    finally:
        exp.stop()
    assert body == t_prom.render_all({"serve": reg})


# ------------------------------- events ---------------------------------------
def test_event_log_schema_matches_repro(tmp_path):
    recs = {}
    for name, ev in (("repro", j_events), ("port", t_events)):
        path = str(tmp_path / f"{name}.jsonl")
        ev.install(path)
        assert ev.enabled()
        ev.emit("serve.prefill", batch=2, prompt_tokens=8, ms=1.5)
        ev.emit("serve.complete", batch=2, tokens=4, ms_per_token=0.5)
        ev.uninstall()
        assert not ev.enabled()
        ev.emit("ghost.event", x=1)            # no sink: dropped
        recs[name] = list(ev.read(path))
    strip = lambda rs: [{k: v for k, v in r.items() if k != "ts"}
                        for r in rs]
    assert strip(recs["port"]) == strip(recs["repro"])
    assert [r["kind"] for r in recs["port"]] == ["serve.prefill",
                                                 "serve.complete"]
    assert all(isinstance(r["ts"], float) for r in recs["port"])
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"kind": "x"}\n')
    with pytest.raises(ValueError, match="missing 'ts'"):
        list(t_events.read(str(bad)))


def test_serve_writes_events_and_metrics(tmp_path, capsys):
    path = tmp_path / "events.jsonl"
    reg = serve.main(["--arch", "smollm-135m", "--smoke", "--prompt-len",
                      "8", "--gen", "4", "--batch", "2", "--device", "cpu",
                      "--event-log", str(path), "--metrics-port", "0"])
    out = capsys.readouterr().out
    assert "metrics: http://127.0.0.1:" in out and "decode_token:" in out
    recs = list(t_events.read(str(path)))
    assert [r["kind"] for r in recs] == ["serve.prefill", "serve.complete"]
    assert recs[0]["prompt_tokens"] == 8 and recs[1]["tokens"] == 4
    assert not t_events.enabled()
    assert reg.counters["prompt_tokens"].value == 16
    assert reg.counters["tokens_generated"].value == 8
    assert reg.latencies["decode_token"].count == 3
    assert reg.latencies["prefill"].count == 1


# ------------------------------ decompose -------------------------------------
@pytest.mark.parametrize("fl", [1, 3, 5, 7, 9])
def test_decompose_filter_is_repros(fl):
    assert [dataclasses.astuple(p) for p in t_decompose.decompose_filter(fl)] \
        == [dataclasses.astuple(p) for p in j_decompose.decompose_filter(fl)]
    assert t_decompose.piece_count(fl) == j_decompose.piece_count(fl)


def test_seven_by_seven_is_the_papers_21_pieces():
    assert t_decompose.piece_count(7) == (21, 14, 7)


@pytest.mark.parametrize("fl,stride,padding", [(7, 2, 3), (5, 1, 2),
                                               (3, 1, 1)])
def test_conv_from_pieces_matches_repro(fl, stride, padding):
    x, w = _arr(fl, 1, 19, 19, 3), _arr(fl + 1, fl, fl, 3, 8)
    want = j_decompose.conv_from_pieces(jnp.asarray(x), jnp.asarray(w),
                                        stride=stride, padding=padding)
    got = t_decompose.conv_from_pieces(torch.from_numpy(x),
                                       torch.from_numpy(w), stride=stride,
                                       padding=padding)
    assert tuple(got.shape) == want.shape
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) <= 1e-5
    direct = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(w).permute(3, 2, 0, 1), stride=stride,
        padding=padding).permute(0, 2, 3, 1)
    # the direct conv sums in one pass: 1e-5 relative to the output's scale
    scale = max(1.0, float(direct.abs().max()))
    assert float((got - direct).abs().max()) <= 1e-5 * scale
