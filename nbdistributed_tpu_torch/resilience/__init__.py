"""Fault injection and recovery for the control plane (counterpart of
``nbdistributed_tpu/resilience``): the seeded :mod:`.faults` plan, the
:mod:`.retry` policy, the worker's replay cache and result mailbox
(:mod:`.dedup`), durable sessions (:mod:`.session`), the training
guard (:mod:`.trainguard`), host-level partition suspicion
(:mod:`.partition`), the auto-heal :mod:`.supervisor` and the collective
hang :mod:`.watchdog` with its stuck-cell doctor.  Stdlib-only at import
time."""

from .supervisor import Supervisor, SupervisorPolicy
from .watchdog import HangPolicy, HangWatchdog, SkewDetector, hang_report

__all__ = ["HangPolicy", "HangWatchdog", "SkewDetector", "Supervisor",
           "SupervisorPolicy", "hang_report"]
