"""Prometheus text-format exposition + stdlib HTTP exporter.

Renders any ``MetricsRegistry`` into the text exposition format
(https://prometheus.io/docs/instrumenting/exposition_formats/):

  * ``Counter``       -> ``<ns>_<name>_total``            (TYPE counter)
  * ``Gauge``         -> ``<ns>_<name>``                  (TYPE gauge)
  * ``Histogram``     -> ``_bucket{le=...}``/``_sum``/``_count``
  * ``LatencyWindow`` -> TYPE summary with ``quantile`` labels over the
    rolling window plus lifetime ``_sum``/``_count`` (seconds).

``MetricsExporter`` serves the rendering from a daemon
``http.server`` thread at ``/metrics`` (plus ``/healthz``) so the training
and serving loops can be scraped without adding any dependency.  Pass
``port=0`` to bind an ephemeral port (tests); the bound port is available
as ``exporter.port`` after ``start()``.  A copy of
``repro.observability.prom`` (same metric names and text, namespace
``repro`` by default).
"""
from __future__ import annotations

import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .metrics import MetricsRegistry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_QUANTILES = (0.5, 0.9, 0.99)


def _metric_name(namespace: str, name: str) -> str:
    full = f"{namespace}_{name}" if namespace else name
    full = _NAME_RE.sub("_", full)
    if full and full[0].isdigit():
        full = "_" + full
    return full


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v)) if isinstance(v, float) and not v.is_integer() \
        else str(int(v))


def render(registry: MetricsRegistry, namespace: str = "repro") -> str:
    """One registry -> text exposition (ends with a newline)."""
    lines: list[str] = []

    for name, c in sorted(registry.counters.items()):
        m = _metric_name(namespace, name) + "_total"
        lines += [f"# HELP {m} Counter {name!r}.",
                  f"# TYPE {m} counter",
                  f"{m} {_fmt(c.value)}"]

    for name, g in sorted(registry.gauges.items()):
        m = _metric_name(namespace, name)
        lines += [f"# HELP {m} Gauge {name!r}.",
                  f"# TYPE {m} gauge",
                  f"{m} {_fmt(g.value)}"]

    for name, h in sorted(registry.histograms.items()):
        m = _metric_name(namespace, name)
        lines += [f"# HELP {m} Histogram {name!r}.",
                  f"# TYPE {m} histogram"]
        for ub, cum in h.cumulative():
            lines.append(f'{m}_bucket{{le="{_fmt(ub)}"}} {cum}')
        lines += [f"{m}_sum {_fmt(h.sum)}",
                  f"{m}_count {h.count}"]

    for name, lw in sorted(registry.latencies.items()):
        m = _metric_name(namespace, name) + "_seconds"
        lines += [f"# HELP {m} Latency window {name!r} (window quantiles, "
                  "lifetime sum/count).",
                  f"# TYPE {m} summary"]
        for q in _QUANTILES:
            lines.append(f'{m}{{quantile="{q}"}} '
                         f"{_fmt(lw.percentile(q * 100))}")
        lines += [f"{m}_sum {_fmt(lw.total_s)}",
                  f"{m}_count {lw.count}"]

    return "\n".join(lines) + "\n"


def render_all(registries: dict[str, MetricsRegistry],
               namespace: str = "repro") -> str:
    """Render several registries, each under ``<namespace>_<key>_...``."""
    return "".join(
        render(reg, f"{namespace}_{key}" if key else namespace)
        for key, reg in sorted(registries.items()))


class MetricsExporter:
    """Serve ``/metrics`` for one or more registries from a daemon thread.

    Registries can be attached after construction (``attach``) — the
    handler snapshots the dict on every scrape, so a launcher can start
    the exporter first and register loop metrics as they come up.
    """

    def __init__(self, registries: MetricsRegistry | dict[str, MetricsRegistry]
                 | None = None, *, port: int = 0, addr: str = "127.0.0.1",
                 namespace: str = "repro"):
        if registries is None:
            registries = {}
        if isinstance(registries, MetricsRegistry):
            registries = {"": registries}
        self._registries = dict(registries)
        self._addr = addr
        self._port = port
        self._namespace = namespace
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def attach(self, name: str, registry: MetricsRegistry) -> None:
        self._registries[name] = registry

    def scrape(self) -> str:
        return render_all(self._registries, self._namespace)

    @property
    def port(self) -> int:
        return self._server.server_address[1] if self._server else self._port

    def start(self) -> int:
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path.split("?")[0] in ("/metrics", "/"):
                    body = exporter.scrape().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path == "/healthz":
                    body, ctype = b"ok\n", "text/plain"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):   # keep scrapes out of stdout
                pass

        self._server = ThreadingHTTPServer((self._addr, self._port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="metrics-exporter", daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
