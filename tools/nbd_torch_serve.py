#!/usr/bin/env python
"""Thin HTTP shim over the gateway's serving plane (``%dist_serve``;
counterpart of ``tools/nbd_serve.py``).

Attaches to a live gateway pool as one tenant and exposes its
generation ingress as plain HTTP — the zero-dependency way to put
real traffic through the serving plane (load generators, curl,
another service).  Stdlib only; one process, one tenant connection,
the gateway does all admission control and durability:

    python tools/nbd_torch_serve.py --run-dir /tmp/nbd_runs/pool-x \\
        --port 8080

    curl -s localhost:8080/v1/submit -d \\
        '{"prompt": [5, 9, 2], "max_new_tokens": 16}'
        -> {"status": "accepted", "rid": "r0", ...}
        -> {"status": "shed" | "rejected", ...}  (explicit overload)
    curl -s localhost:8080/v1/result/r0
        -> {"status": "completed", "tokens": [...], "done": true}
    curl -s 'localhost:8080/v1/stream/r0?from=4'
        -> {"tokens": [...], "offset": 4, "done": ...}  (resume from
           the caller's last acked offset — exactly-once delivery is
           the gateway journal's, not this shim's)
    curl -s localhost:8080/v1/status

The shim is deliberately stateless: a restarted shim reattaches under
its tenant name (token from the gateway manifest) and every in-flight
request's stream remains claimable by offset — the same
reattach-mid-generation contract notebook kernels get.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from nbdistributed_tpu_torch.gateway import daemon as gw_mod  # noqa: E402
from nbdistributed_tpu_torch.gateway.client import (  # noqa: E402
    CellSubmitError, TenantClient)


def make_handler(client: TenantClient):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, data: dict) -> None:
            body = json.dumps(data).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet by default
            pass

        def do_POST(self):
            if self.path.rstrip("/") != "/v1/submit":
                self._json(404, {"error": "unknown endpoint"})
                return
            try:
                n = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(n) or b"{}")
                verdict = client.serve_submit(
                    req.get("prompt") or (),
                    int(req.get("max_new_tokens") or 0),
                    priority=req.get("priority"))
                self._json(200, verdict)
            except CellSubmitError as e:
                # Explicit overload verdicts map to 429/503, not 500:
                # the caller is meant to back off and retry.
                code = 429 if e.verdict.get("status") == "rejected" \
                    else 503
                self._json(code, e.verdict)
            except Exception as e:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def do_GET(self):
            path, _, query = self.path.partition("?")
            parts = [p for p in path.split("/") if p]
            try:
                if parts[:2] == ["v1", "result"] and len(parts) == 3:
                    self._json(200, client.serve_result(parts[2]))
                elif parts[:2] == ["v1", "stream"] and len(parts) == 3:
                    frm = 0
                    for kv in query.split("&"):
                        if kv.startswith("from="):
                            frm = int(kv[5:] or 0)
                    self._json(200, client.serve_stream(parts[2], frm))
                elif parts == ["v1", "status"]:
                    self._json(200, client.serve_status())
                else:
                    self._json(404, {"error": "unknown endpoint"})
            except Exception as e:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="HTTP ingress shim for the gateway serving plane")
    p.add_argument("--run-dir", default=None,
                   help="gateway run dir (default: discovery)")
    p.add_argument("--tenant", default="serve-http",
                   help="tenant name this shim attaches under")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    args = p.parse_args(argv)

    d = gw_mod.discover_gateway(args.run_dir)
    if d is None:
        print("no live gateway pool found (start one: "
              "python tools/nbd_torch_gateway.py -n 4)", file=sys.stderr)
        return 2
    m = gw_mod.read_gateway_manifest(d) or {}
    plane = m.get("tenant_plane") or {}
    token = ((m.get("tenants") or {}).get(args.tenant) or {}).get(
        "token")
    client = TenantClient(plane.get("host") or "127.0.0.1",
                          int(plane.get("port") or 0), args.tenant,
                          token=token,
                          pool_token=m.get("pool_token"))
    try:
        # Inside the try: a failed HTTP bind (port in use) must not
        # leak the tenant connection + reader thread without a clean
        # detach — the gateway would see a LOST tenant instead of a
        # goodbye (lifecycle-lint shutdown discipline).
        srv = ThreadingHTTPServer((args.host, args.port),
                                  make_handler(client))
        try:
            print(f"NBD_SERVE_HTTP ready on {args.host}:"
                  f"{srv.server_port} -> pool {d} "
                  f"(tenant {args.tenant!r})", flush=True)
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.server_close()
    finally:
        client.close(detach=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
