"""Stdlib-only HTTP plane for the metrics registry.

``MetricsServer`` runs a ``ThreadingHTTPServer`` on a daemon thread and
serves three read-only endpoints:

- ``/metrics`` — the registry in Prometheus text exposition v0.0.4
  (``text/plain; version=0.0.4``), scrape-ready.
- ``/healthz`` — liveness + readiness. Liveness is the server itself
  (the process answers ⇒ alive; ``close()`` flips it for the final
  scrape race). Readiness is the AND of component-registered probes
  (``add_probe(name, fn)`` — e.g. the serving front-end's "at least
  one live replica"); status 200 when ready, 503 when not, body a JSON
  per-probe breakdown either way.
- ``/statusz`` — a human-readable JSON snapshot of fleet/run state,
  produced by the registered ``statusz_fn`` at request time.

Everything is pull: the hot path never blocks on the scrape side, and
the scrape side reads shared state under the registry lock only. No
endpoint touches the device.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class HealthState:
    """Liveness flag + named readiness probes.

    ``ready()`` is the AND of every probe (a probe that *raises* counts
    as not ready — a crashing health check must fail closed). Probes
    are cheap host-side closures over component state; components flip
    readiness by their own state changing, not by pushing."""

    def __init__(self):
        self._lock = threading.Lock()
        self._live = True
        self._probes: Dict[str, Callable[[], bool]] = {}

    def add_probe(self, name: str, fn: Callable[[], bool]) -> None:
        with self._lock:
            self._probes[name] = fn

    def remove_probe(self, name: str) -> None:
        with self._lock:
            self._probes.pop(name, None)

    def set_live(self, live: bool) -> None:
        with self._lock:
            self._live = bool(live)

    def report(self) -> dict:
        with self._lock:
            probes = dict(self._probes)
            live = self._live
        results = {}
        for name, fn in sorted(probes.items()):
            try:
                results[name] = bool(fn())
            except Exception:
                results[name] = False
        return {
            "live": live,
            "ready": live and all(results.values()),
            "probes": results,
        }


class _Handler(BaseHTTPRequestHandler):
    # Set per-server via the factory in MetricsServer.
    server_version = "tpu-trainer-obs/1"

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass

    def _send(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
        owner: "MetricsServer" = self.server._owner  # type: ignore
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                body = owner.registry.exposition().encode()
                self._send(200, body, PROM_CONTENT_TYPE)
            elif path == "/healthz":
                report = owner.health.report()
                code = 200 if report["ready"] else 503
                self._send(code, (json.dumps(report, indent=1) + "\n")
                           .encode(), "application/json")
            elif path == "/statusz":
                status = owner.statusz_fn() if owner.statusz_fn else {}
                self._send(200, (json.dumps(status, indent=1, default=str)
                                 + "\n").encode(), "application/json")
            elif path == "/":
                self._send(200, b"/metrics /healthz /statusz\n",
                           "text/plain; charset=utf-8")
            else:
                self._send(404, b"not found\n", "text/plain; charset=utf-8")
        except BrokenPipeError:
            pass  # scraper went away mid-response; nothing to salvage
        except Exception as e:
            try:
                self._send(500, f"{type(e).__name__}: {e}\n".encode(),
                           "text/plain; charset=utf-8")
            except OSError:
                pass


class MetricsServer:
    """The daemon-thread scrape endpoint around one registry.

    ``port=0`` binds an ephemeral port (read it back from ``.port`` —
    the bench and chaos lanes use this to avoid collisions). ``close()``
    flips liveness off and shuts the listener down; it is safe to call
    twice."""

    def __init__(self, registry, *, port: int = 0, host: str = "127.0.0.1",
                 statusz_fn: Optional[Callable[[], dict]] = None,
                 health: Optional[HealthState] = None):
        self.registry = registry
        self.statusz_fn = statusz_fn
        self.health = health if health is not None else HealthState()
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd._owner = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="obs-metrics-server", daemon=True)
        self._thread.start()
        self._closed = False

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.health.set_live(False)
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
