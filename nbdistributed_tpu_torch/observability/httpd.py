"""Live scrape endpoint: ``GET /metrics``, ``/healthz``,
``/latency.json`` (a copy of ``nbdistributed_tpu/observability/httpd.py``:
the same routes, gate, metric names and labels).

A stdlib :class:`~http.server.ThreadingHTTPServer` owned by the
coordinator (``%dist_init`` + ``NBD_METRICS_PORT``) or the gateway
daemon (``%dist_pool start --metrics-port``), so a deployment can be
scraped by a stock Prometheus — no shim, no notebook round-trip:

- ``/metrics`` — Prometheus exposition text (version 0.0.4) from the
  coordinator's registry, with the per-rank **worker view merged in
  through the existing telemetry piggyback**: every heartbeat already
  pushes each rank's HBM / live-buffer / compile / dedup numbers to
  the coordinator, and the collector mirrors the newest snapshot into
  rank-labeled gauges.  Push-based on purpose — probing a worker's
  registry goes through its SERIAL request loop and would stall the
  scrape exactly when a long cell makes the numbers interesting.
  Clock-offset gauges and flight-ring health ride the same export.
- ``/healthz`` — liveness JSON (world size, alive/dead ranks, and —
  on a gateway — tenant/scheduler counts).  Never token-gated: a load
  balancer's prober holds no secrets.
- ``/latency.json`` — the latency observatory's summary + recent raw
  stage records (:mod:`.latency`), the machine-readable twin of
  ``%dist_lat``.

On a gateway pool (``gateway/daemon.py``), ``/metrics`` and
``/latency.json`` are **token-gated like the admin plane** (the pool token, via
``?token=…`` or ``Authorization: Bearer …``) — the manifest that
tells a kernel where to attach also authorizes its scrapes.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from . import flightrec
from . import latency as obs_latency
from . import metrics as obs_metrics
from . import telemetry as obs_telemetry


class MetricsHTTPD:
    """The scrape server.  Collectors are injected callables so the
    unit tests drive it with fakes and both owners (single-kernel
    coordinator, gateway daemon) share one implementation.

    ``collect_metrics() -> str`` (Prometheus text),
    ``collect_health() -> dict``, ``collect_latency() -> dict``;
    ``token`` gates /metrics and /latency.json when set.
    """

    def __init__(self, *, port: int = 0, host: str = "127.0.0.1",
                 collect_metrics, collect_health,
                 collect_latency=None, token: str | None = None):
        self.host = host
        self.token = token
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            # Scrapes are high-frequency; default request logging
            # would spam the daemon's log file.
            def log_message(self, fmt, *args):  # noqa: N802
                pass

            def _reply(self, code: int, body: bytes,
                       ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _authorized(self, query: dict) -> bool:
                if not outer.token:
                    return True
                if query.get("token", [None])[0] == outer.token:
                    return True
                auth = self.headers.get("Authorization", "")
                return auth == f"Bearer {outer.token}"

            def do_GET(self):  # noqa: N802
                try:
                    url = urlparse(self.path)
                    path = url.path.rstrip("/") or "/"
                    if path == "/healthz":
                        body = json.dumps(collect_health()).encode()
                        self._reply(200, body, "application/json")
                        return
                    if path not in ("/metrics", "/latency.json"):
                        self._reply(404, b"not found\n", "text/plain")
                        return
                    if not self._authorized(parse_qs(url.query)):
                        self._reply(
                            401,
                            b"pool token required (?token= or "
                            b"Authorization: Bearer)\n", "text/plain")
                        return
                    if path == "/metrics":
                        self._reply(
                            200, collect_metrics().encode(),
                            "text/plain; version=0.0.4; charset=utf-8")
                    else:
                        payload = (collect_latency()
                                   if collect_latency is not None
                                   else {})
                        self._reply(200, json.dumps(payload).encode(),
                                    "application/json")
                except BrokenPipeError:
                    pass  # scraper hung up mid-reply
                except Exception as e:
                    try:
                        self._reply(500, f"{type(e).__name__}: {e}\n"
                                    .encode(), "text/plain")
                    except Exception:
                        pass

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="nbd-metrics-httpd",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass


# ----------------------------------------------------------------------
# collectors over a CommunicationManager (both owners use these)


def _mirror_worker_view(reg, comm) -> None:
    """Fold each rank's newest heartbeat-piggybacked telemetry into
    rank-labeled gauges — the /metrics "merged worker registries"
    without a single request on the serial worker loops."""
    import time
    now = time.time()
    for r in range(getattr(comm, "num_workers", 0)):
        seen = comm.last_seen(r)
        if seen is not None:
            reg.gauge("nbd_heartbeat_staleness_seconds",
                      "seconds since this rank was last heard",
                      {"rank": str(r)}).set(round(now - seen, 3))
        tel = comm.last_telemetry(r)
        if not tel:
            continue
        labels = {"rank": str(r)}
        hbm = obs_telemetry.hbm_totals(tel)
        if hbm:
            for key in ("in_use", "peak", "limit"):
                if hbm.get(key) is not None:
                    reg.gauge(f"nbd_worker_hbm_{key}_bytes",
                              f"rank device memory {key} (the CUDA "
                              "caching allocator's, from the heartbeat "
                              "telemetry piggyback)", labels).set(hbm[key])
        for field, name, help in (
                ("bufs", "nbd_worker_live_buffers",
                 "live device-buffer count on this rank"),
                ("compiles", "nbd_worker_backend_compiles",
                 "backend compiles observed on this rank (0: the "
                 "port runs eager PyTorch and prebuilt kernels)"),
                ("compile_s", "nbd_worker_compile_seconds",
                 "cumulative backend compile seconds on this rank"),
                ("dedup", "nbd_worker_dedup_hits",
                 "replay-cache hits on this rank"),
                ("msgs", "nbd_worker_messages_seen",
                 "control messages this rank has received")):
            v = tel.get(field)
            if v is not None:
                reg.gauge(name, help, labels).set(float(v))


def collectors_for_comm(comm, *, extra_health=None,
                        extra_latency=None):
    """(collect_metrics, collect_health, collect_latency) bound to a
    :class:`~..messaging.coordinator.CommunicationManager`.

    ``extra_latency`` is a zero-arg callable whose dict is
    merged into the ``/latency.json`` payload — the daemon hangs the
    serving observatory's stage/utilization block there."""

    def collect_metrics() -> str:
        reg = obs_metrics.registry()
        obs_latency.export_clock_metrics(comm.clock, reg)
        flightrec.export_health(reg)
        _mirror_worker_view(reg, comm)
        return reg.prometheus_text()

    def collect_health() -> dict:
        import time
        dead = sorted(comm.dead_ranks())
        out = {
            "status": "degraded" if dead else "ok",
            "world_size": comm.num_workers,
            "alive": comm.connected_ranks(),
            "dead": dead,
            "pending": len(comm.pending_snapshot()),
            "ts": round(time.time(), 3),
        }
        if extra_health is not None:
            try:
                out.update(extra_health() or {})
            except Exception:
                pass
        return out

    def collect_latency() -> dict:
        out = comm.lat.status_block()
        if extra_latency is not None:
            try:
                out.update(extra_latency() or {})
            except Exception:
                pass
        return out

    return collect_metrics, collect_health, collect_latency


def start_for_comm(comm, *, port: int, host: str = "127.0.0.1",
                   token: str | None = None, extra_health=None,
                   extra_latency=None) -> MetricsHTTPD:
    """Start the scrape endpoint over a live coordinator.  ``port``
    0 binds an ephemeral port (read it back from ``.port``)."""
    cm, ch, cl = collectors_for_comm(comm, extra_health=extra_health,
                                     extra_latency=extra_latency)
    return MetricsHTTPD(port=port, host=host, token=token,
                        collect_metrics=cm, collect_health=ch,
                        collect_latency=cl)
