#!/usr/bin/env python
"""Probe of the port's live scrape endpoint (counterpart of
``tools/nbd_metrics_check.py``).

Spins an in-process 2-rank gateway pool (GPU ranks; ``--backend cpu``
for gloo on the CPU) with the metrics endpoint on, runs one tenant cell through it (so the stage histograms and the
latency ring hold real data), then:

- ``GET /healthz`` must return 200 JSON;
- ``GET /metrics`` (pool-token-gated) must return 200 with exposition
  text that parses (``metrics.validate_prometheus_text``) and carries
  the latency-observatory series (``nbd_stage_seconds``);
- an ungated ``GET /metrics`` must be refused (401);
- ``GET /latency.json`` must return the summary + at least one stage
  record, and is written to ``--out`` for the CI artifact upload.

Exit 0 on success, 1 with the failures listed otherwise::

    python tools/nbd_torch_metrics_check.py --backend cpu --out latency.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _get(url: str, timeout: float = 10.0) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "latency.json"),
                   help="where to write the /latency.json payload")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--backend", default="gpu", choices=["gpu", "cpu"],
                   help="gpu (default): one GPU a rank; cpu: gloo")
    args = p.parse_args(argv)

    from nbdistributed_tpu_torch.gateway.client import TenantClient
    from nbdistributed_tpu_torch.gateway.daemon import GatewayDaemon
    from nbdistributed_tpu_torch.observability.metrics import \
        validate_prometheus_text

    failures: list[str] = []
    print(f"[metrics-check] starting {args.workers}-rank "
          f"{args.backend} pool "
          "with an ephemeral metrics port", flush=True)
    # metrics_port=-1 = "bind an ephemeral OS-assigned port" (0 means
    # off, matching the knob) — pre-claiming a port and re-binding it
    # would be a TOCTOU race a busy host can lose.
    gw = GatewayDaemon(args.workers, backend=args.backend,
                       metrics_port=-1)
    try:
        base = f"http://127.0.0.1:{gw._metrics_httpd.port}"
        client = TenantClient("127.0.0.1", gw.tenant_port, "ci-probe",
                              pool_token=gw.pool_token)
        try:
            res = client.execute("rank + 1", timeout=120.0)
            if res.get("status") != "ok":
                failures.append(f"probe cell failed: {res}")
        finally:
            client.close()

        code, body = _get(f"{base}/healthz")
        if code != 200:
            failures.append(f"/healthz returned {code}")
        else:
            h = json.loads(body)
            print(f"[metrics-check] /healthz: {h}", flush=True)
            if h.get("dead"):
                failures.append(f"/healthz reports dead ranks: {h}")

        code, _ = _get(f"{base}/metrics")
        if code != 401:
            failures.append(
                f"ungated /metrics returned {code}, expected 401")

        code, body = _get(f"{base}/metrics?token={gw.pool_token}")
        if code != 200:
            failures.append(f"/metrics returned {code}")
        else:
            text = body.decode("utf-8")
            errs = validate_prometheus_text(text)
            failures += [f"/metrics: {e}" for e in errs]
            for series in ("nbd_stage_seconds", "nbd_cell_e2e_seconds",
                           "nbd_flight_ring_utilization",
                           "nbd_wire_messages_total"):
                if series not in text:
                    failures.append(
                        f"/metrics is missing the {series} series")
            print(f"[metrics-check] /metrics: {len(text.splitlines())} "
                  "lines, parse "
                  + ("clean" if not errs else f"FAILED ({len(errs)})"),
                  flush=True)

        code, body = _get(f"{base}/latency.json?token={gw.pool_token}")
        if code != 200:
            failures.append(f"/latency.json returned {code}")
        else:
            lat = json.loads(body)
            n = (lat.get("summary") or {}).get("count", 0)
            if not n:
                failures.append("/latency.json holds no stage records "
                                "after a completed cell")
            with open(args.out, "w") as f:
                json.dump(lat, f, indent=1)
            print(f"[metrics-check] /latency.json: {n} record(s) → "
                  f"{args.out}", flush=True)
    finally:
        gw.close()

    if failures:
        print("[metrics-check] FAILED:", flush=True)
        for f in failures:
            print(f"  - {f}", flush=True)
        return 1
    print("[metrics-check] OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
