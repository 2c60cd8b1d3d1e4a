"""Fault injection and recovery for the control plane (counterpart of
``nbdistributed_tpu/resilience``): the seeded :mod:`.faults` plan, the
:mod:`.retry` policy, the worker's replay cache and result mailbox
(:mod:`.dedup`), durable sessions (:mod:`.session`) and the training
guard (:mod:`.trainguard`).  The supervisor and the hang watchdog are
not ported yet (ROADMAP A5).  Stdlib-only at import time."""
