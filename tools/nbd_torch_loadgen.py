#!/usr/bin/env python
"""Closed-loop load generator for the serving plane (counterpart of
``tools/nbd_loadgen.py``).

Drives the serving fast path at a configured request rate and scores
SLO pass/fail from what the CLIENT observed, emitting the pinned
machine-readable report (:mod:`nbdistributed_tpu_torch.serving_fast.loadgen`
— ``chip_smoke.py`` and the unit tests run the same core).  Two transports:

    # against the HTTP shim (tools/nbd_torch_serve.py):
    python tools/nbd_torch_loadgen.py --url http://localhost:8080 \\
        --rps 8 --duration 15 --slo-ttft-ms 2000 --slo-tpot-ms 500 \\
        --report /tmp/load.json

    # directly against a gateway pool (no shim):
    python tools/nbd_torch_loadgen.py --run-dir /tmp/nbd_runs/pool-x

Arrival process, rate, duration, and seed default from the
``NBD_LOADGEN_*`` knobs; the schedule is a pure function of the seed,
so two runs with the same flags offer bit-identical work.  Exit code:
0 = SLO pass (or no targets set and nothing hung), 1 = SLO fail,
2 = could not run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from nbdistributed_tpu_torch.serving_fast.loadgen import (  # noqa: E402
    HTTPTransport, ClientTransport, LoadConfig, run_load,
    validate_report)
from nbdistributed_tpu_torch.utils import knobs  # noqa: E402


def _span(s: str) -> tuple[int, int]:
    """``"lo:hi"`` or ``"n"`` -> inclusive (lo, hi)."""
    lo, _, hi = s.partition(":")
    return (int(lo), int(hi or lo))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="closed-loop load generator for the serving plane")
    p.add_argument("--url", default=None,
                   help="HTTP shim base URL (tools/nbd_torch_serve.py)")
    p.add_argument("--run-dir", default=None,
                   help="attach directly to this gateway pool "
                        "(default: discovery) when --url is not given")
    p.add_argument("--tenant", default="loadgen",
                   help="tenant name for direct attachment")
    p.add_argument("--rps", type=float,
                   default=knobs.get_float("NBD_LOADGEN_RPS", 4.0))
    p.add_argument("--duration", type=float,
                   default=knobs.get_float("NBD_LOADGEN_DURATION_S",
                                           15.0))
    p.add_argument("--arrival",
                   choices=["poisson", "uniform"],
                   default=knobs.get_str("NBD_LOADGEN_ARRIVAL",
                                         "poisson"))
    p.add_argument("--seed", type=int,
                   default=knobs.get_int("NBD_LOADGEN_SEED", 0))
    p.add_argument("--prompt-len", type=_span, default=(4, 16),
                   metavar="LO:HI",
                   help="prompt length range in tokens")
    p.add_argument("--max-new", type=_span, default=(4, 16),
                   metavar="LO:HI",
                   help="output budget range in tokens")
    p.add_argument("--vocab", type=int, default=50,
                   help="token ids are drawn from [1, vocab)")
    p.add_argument("--priority", type=int, default=0)
    p.add_argument("--slo-ttft-ms", type=float, default=None,
                   help="p99 TTFT target (milliseconds)")
    p.add_argument("--slo-tpot-ms", type=float, default=None,
                   help="p99 TPOT target (milliseconds)")
    p.add_argument("--drain", type=float, default=60.0,
                   help="seconds to wait for in-flight requests after "
                        "the offered window (then they count as hung)")
    p.add_argument("--report", default=None,
                   help="write the JSON report here (default: stdout)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress the human summary line")
    args = p.parse_args(argv)

    cfg = LoadConfig(
        rps=args.rps, duration_s=args.duration, arrival=args.arrival,
        seed=args.seed, prompt_len=args.prompt_len,
        max_new=args.max_new, vocab=args.vocab,
        priority=args.priority, slo_ttft_p99_ms=args.slo_ttft_ms,
        slo_tpot_p99_ms=args.slo_tpot_ms, drain_s=args.drain)

    client = None
    try:
        if args.url:
            transport = HTTPTransport(args.url)
        else:
            from nbdistributed_tpu_torch.gateway import daemon as gw_mod
            from nbdistributed_tpu_torch.gateway.client import TenantClient
            d = gw_mod.discover_gateway(args.run_dir)
            if d is None:
                print("no live gateway pool found (and no --url)",
                      file=sys.stderr)
                return 2
            m = gw_mod.read_gateway_manifest(d) or {}
            plane = m.get("tenant_plane") or {}
            token = ((m.get("tenants") or {}).get(args.tenant)
                     or {}).get("token")
            client = TenantClient(
                plane.get("host") or "127.0.0.1",
                int(plane.get("port") or 0), args.tenant,
                token=token, pool_token=m.get("pool_token"))
            transport = ClientTransport(client)
        report = run_load(transport, cfg)
    except Exception as e:
        print(f"loadgen failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2
    finally:
        if client is not None:
            try:
                client.close(detach=True)
            except Exception:
                pass

    validate_report(report)
    out = json.dumps(report, indent=2, sort_keys=True)
    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            f.write(out + "\n")
    else:
        print(out)
    if not args.quiet:
        c = report["client"]
        ttft = (c["ttft_ms"] or {}).get("p99")
        tpot = (c["tpot_ms"] or {}).get("p99")
        print(f"NBD_LOADGEN offered={report['offered']} "
              f"completed={report['completed']} "
              f"shed_rate={report['shed_rate']} "
              f"tok/s={report['tokens_per_s']} "
              f"p99_ttft_ms={ttft} p99_tpot_ms={tpot} "
              f"slo_pass={report['slo']['pass']}",
              file=sys.stderr, flush=True)
    return 0 if report["slo"]["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
