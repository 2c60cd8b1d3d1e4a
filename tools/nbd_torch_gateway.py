#!/usr/bin/env python
"""Run the port's session-gateway daemon: one pooled fleet of GPU ranks,
N tenant kernels (counterpart of ``tools/nbd_gateway.py``).

The gateway owns the workers and serves a tenant plane that notebook
kernels attach to with ``%dist_attach --tenant NAME`` (the in-notebook
spawner is ``%dist_pool start``).  Admission control, per-tenant
fair-share scheduling, backpressure, and crash fencing are described
in README "The gateway's tenant plane".  The ranks run on the GPU, one
rank a card, unless ``--backend cpu`` asks for gloo on the CPU:

    python tools/nbd_torch_gateway.py -n 4
    python tools/nbd_torch_gateway.py -n 2 --backend cpu --queue-depth 32

It prints ``NBD_GATEWAY_READY run_dir=... port=... world=...`` once the
pool serves, and stops the pool on SIGTERM/SIGINT (exit 0; 143 when the
signal lands while the ranks are still spawning, after reaping them).
Equivalent module form: ``python -m nbdistributed_tpu_torch.gateway.daemon``.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from nbdistributed_tpu_torch.gateway.daemon import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
