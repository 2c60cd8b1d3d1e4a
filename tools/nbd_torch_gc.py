#!/usr/bin/env python
"""Sweep stale nbdistributed_tpu_torch session run dirs from the tmp root
(counterpart of ``tools/nbd_gc.py``).

Run-dir siblings under ``<tmpdir>/nbd_runs`` accumulate one per
session (flight rings, postmortem bundles, the session manifest).  A
sibling is stale — and swept — when its manifest (or the directory,
when no manifest exists) is older than the TTL AND none of its
recorded worker pids are alive.  The current session's run dir
(``NBD_RUN_DIR``), anything with a live pid, and any dir a live gateway
daemon owns are never touched.

The in-notebook equivalent is ``%dist_gc [--dry-run]``; this CLI is
for cron / CI cleanup outside any kernel:

    python tools/nbd_torch_gc.py --dry-run
    python tools/nbd_torch_gc.py --ttl-s 3600
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from nbdistributed_tpu_torch.resilience import session  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None,
                   help="runs root (default: <tmpdir>/nbd_runs)")
    p.add_argument("--ttl-s", type=float, default=None,
                   help="stale age in seconds (default: NBD_GC_TTL_S, "
                        "else 6h)")
    p.add_argument("--dry-run", action="store_true",
                   help="list candidates without removing anything")
    args = p.parse_args(argv)
    res = session.gc_runs(args.root, ttl_s=args.ttl_s,
                          dry_run=args.dry_run)
    verb = "would sweep" if args.dry_run else "swept"
    print(f"{verb} {len(res['swept'])} stale run dir(s) under "
          f"{res['root']} (ttl {res['ttl_s']:.0f}s); "
          f"kept {len(res['kept'])}")
    for d in res["swept"]:
        print(f"  - {d}")
    if args.dry_run:
        for d in res["kept"]:
            why = res.get("kept_why", {}).get(d)
            print(f"  = kept {d}" + (f" — {why}" if why else ""))
    for e in res["errors"]:
        print(f"  ! {e}", file=sys.stderr)
    return 1 if res["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
