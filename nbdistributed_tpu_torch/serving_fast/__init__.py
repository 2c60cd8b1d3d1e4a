"""Host-side serving machinery (counterpart of
``nbdistributed_tpu/serving_fast``), dependency-free on purpose:

- :mod:`.paging` — the fixed-size KV block allocator.  The gateway keeps
  one per decode rank to gate admission on free *blocks*, and the
  device pool (:mod:`..models.paged_kv`) uses the same class for its
  physical block ids, so the admission verdict and the device table
  never disagree about capacity.
- :mod:`.loadgen` — the closed-loop load generator: deterministic
  arrival/length schedules, a pluggable transport (the HTTP shim or an
  in-process ``TenantClient``), SLO scoring and a report with a pinned
  schema.  ``tools/nbd_torch_loadgen.py`` is a thin CLI over it.
"""

from .loadgen import (LoadConfig, run_load, score_slo, synth_schedule,
                      validate_report)
from .paging import BlockAllocator, BlocksExhausted, blocks_needed

__all__ = ["BlockAllocator", "BlocksExhausted", "blocks_needed",
           "LoadConfig", "run_load", "score_slo", "synth_schedule",
           "validate_report"]
