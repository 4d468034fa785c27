"""Minimal Prometheus exporter: ``GET /metrics`` over stdlib http.server.

The training-side sidecar (``train.py --metrics-port``): one daemon
thread serving a :class:`~.registry.Registry`'s text exposition so a
Prometheus scraper (or ``curl``) can watch a live run without touching
the train loop. The serving server does NOT use this module's server —
it already owns a ThreadingHTTPServer and mounts the same rendering on
its own ``/metrics`` path (serving/server.py) — but shares the
content-type constant so both endpoints stay scrape-compatible.

A copy of the JAX package's ``obs/http.py``.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from differential_transformer_replication_tpu_torch.obs.registry import (
    CONTENT_TYPE,
    Registry,
)


def _make_handler(registry: Registry):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.split("?")[0] not in ("/metrics", "/"):
                self.send_response(404)
                self.end_headers()
                return
            body = registry.render().encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet: scrapes every few seconds
            pass

    return Handler


def start_metrics_server(registry: Registry, port: int,
                         host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Serve ``registry`` at ``http://host:port/metrics`` from a daemon
    thread; returns the server (call ``.shutdown()`` then
    ``.server_close()`` to stop). ``port=0`` binds an ephemeral port —
    read it back from ``server.server_address[1]``."""
    server = ThreadingHTTPServer((host, port), _make_handler(registry))
    thread = threading.Thread(
        target=server.serve_forever, name="metrics-exporter", daemon=True
    )
    thread.start()
    return server
