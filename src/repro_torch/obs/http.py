"""Scrapeable telemetry endpoint — ``/metrics`` + ``/healthz`` over stdlib.

Port of ``repro.obs.http``. A tiny :class:`http.server.ThreadingHTTPServer`
in a daemon thread, so it needs neither an asyncio loop nor any
third-party dependency, and it stays up between the runs it reports on.

Routes:

* ``GET /metrics`` — Prometheus text exposition of the process registry.
  ``on_scrape`` (if given) runs first, so a caller can publish a fresh
  snapshot of its own statistics per scrape: the scraped counters then
  equal that snapshot by construction
  (:class:`repro_torch.serving.GraphServer` wires its stats here).
* ``GET /healthz`` — JSON health document from ``health_fn``; HTTP 200
  when ``status == "ok"``, 503 otherwise (breaker open, queue saturated).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.obs.registry import REGISTRY

__all__ = ["TelemetryServer"]


class TelemetryServer:
    """Serve ``registry`` (default: the process registry) over HTTP.

    ``port=0`` binds an ephemeral port; read it back from ``address``
    after :meth:`start`. Usable as a context manager.
    """

    def __init__(
        self,
        *,
        registry=None,
        health_fn=None,
        on_scrape=None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.registry = registry if registry is not None else REGISTRY
        self.health_fn = health_fn
        self.on_scrape = on_scrape
        self._host = host
        self._port = port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "TelemetryServer":
        if self._httpd is not None:
            raise RuntimeError("telemetry server already started")
        owner = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr noise
                pass

            def do_GET(self):
                try:
                    owner._handle(self)
                except BrokenPipeError:
                    pass

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="repro-telemetry",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        self._httpd = None
        self._thread = None

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def address(self) -> tuple[str, int]:
        """(host, bound port) — resolves ``port=0`` to the real port."""
        if self._httpd is None:
            raise RuntimeError("telemetry server is not started")
        return self._httpd.server_address[:2]

    def url(self, path: str = "/metrics") -> str:
        host, port = self.address
        return f"http://{host}:{port}{path}"

    # -- request handling ----------------------------------------------------
    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        if req.path in ("/metrics", "/metrics/"):
            if self.on_scrape is not None:
                try:
                    self.on_scrape()
                except Exception as exc:
                    self._send(req, 500, f"scrape callback failed: {exc}\n")
                    return
            body = self.registry.render()
            self._send(
                req, 200, body,
                content_type="text/plain; version=0.0.4; charset=utf-8",
            )
        elif req.path in ("/healthz", "/healthz/"):
            doc = {"status": "ok"}
            if self.health_fn is not None:
                try:
                    doc = dict(self.health_fn())
                except Exception as exc:
                    doc = {"status": "error", "error": str(exc)}
            code = 200 if doc.get("status") == "ok" else 503
            self._send(
                req, code, json.dumps(doc, sort_keys=True) + "\n",
                content_type="application/json",
            )
        else:
            self._send(req, 404, "try /metrics or /healthz\n")

    @staticmethod
    def _send(req, code: int, body: str, *, content_type="text/plain") -> None:
        data = body.encode("utf-8")
        req.send_response(code)
        req.send_header("Content-Type", content_type)
        req.send_header("Content-Length", str(len(data)))
        req.end_headers()
        req.wfile.write(data)
