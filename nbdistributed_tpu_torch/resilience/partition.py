"""Host-level failure domains: partition suspicion (a stdlib copy of
``nbdistributed_tpu/resilience/partition.py``).

With multi-host execution, the liveness signals the stack already
collects — heartbeat staleness, process deaths, transport EOFs — gain
a failure mode single-host worlds cannot produce: **every rank on one
host goes silent at once while the rest of the fleet is fine**.  That
signature is a network partition (or a dead host — indistinguishable
from here until the link heals), and treating it as N independent
worker deaths is exactly wrong: the far side is alive, riding the
orphan machinery, holding namespaces and possibly an in-flight result
that must be delivered exactly once when the link returns.

:class:`PartitionSentry` is the pure state machine both consumers
(``supervisor.py`` defers heals; ``watchdog.py`` suppresses hang
blame) share.  Per host it tracks::

    ok ──all ranks silent/dead while another host is fresh──▶ suspected
    suspected ──any rank fresh again──▶ ok        ("partition healed")
    suspected ──grace expires──▶ expired          (treat host as LOST)

The grace period (``NBD_PARTITION_GRACE_S``, default 30 s) is the
window in which a heal is deferred: shorter than the workers' orphan
TTL (so a healed link finds its orphans still alive), long enough that
a transient link flap never triggers a full respawn.  Transitions are
flight-recorded and counted (``nbd_partition_suspected_total``), so a
flapping DCN link is visible in ``%dist_status``, postmortems, and the
metrics export.

The coordinator's own host is never suspected: every rank sharing its
box going silent is not a *network* event from where we stand (and the
single-host world degenerates to "no host can ever be suspected",
paying nothing).  The port launches on one host until multi-host
launch lands (ROADMAP A5.5), so here the sentry is inert; the
supervisor and the watchdog build it all the same, as the JAX
package's do.
"""

from __future__ import annotations

import threading
import time

from ..observability import flightrec
from ..observability import metrics as obs_metrics

DEFAULT_PARTITION_GRACE_S = 30.0

OK = "ok"
SUSPECTED = "suspected"
EXPIRED = "expired"


def partition_grace_s(env=None) -> float:
    from ..utils import knobs
    return knobs.get_float("NBD_PARTITION_GRACE_S",
                           float(DEFAULT_PARTITION_GRACE_S), env=env)


def format_link_suffix(host_stats: dict) -> str:
    """``"rtt 2.1ms · hb-age 0.3s · retries 4"`` with None-guards —
    the ONE formatter behind every per-host link-health surface
    (``%dist_status`` host headers, the doctor's hosts/links table,
    postmortem reports), so the rendering and its edge handling can't
    drift apart across them.  ``host_stats`` is one value from
    ``CommunicationManager.link_stats()["hosts"]``."""
    rtt = host_stats.get("rtt_ms")
    hb = host_stats.get("hb_age_s")
    return " · ".join([
        f"rtt {rtt:.1f}ms" if rtt is not None else "rtt ?",
        f"hb-age {hb:.1f}s" if hb is not None else "hb-age -",
        f"retries {host_stats.get('retries', 0)}",
    ])


class PartitionSentry:
    """Tracks per-host partition suspicion from per-rank liveness.

    ``hosts`` maps rank -> host label; ``local_host`` is the
    coordinator's own label (exempt from suspicion).  Thread-safe;
    ``observe`` is the one mutator.  With fewer than two distinct
    remote-capable hosts the sentry is inert (``active`` False) and
    ``observe`` returns nothing.
    """

    def __init__(self, hosts: dict[int, str], *,
                 local_host: str = "local",
                 grace_s: float | None = None,
                 source: str = "supervisor",
                 clock=time.time):
        self.hosts = {int(r): str(h) for r, h in (hosts or {}).items()}
        self.local_host = local_host
        self.grace_s = (partition_grace_s() if grace_s is None
                        else float(grace_s))
        self.source = source
        self._clock = clock
        self._lock = threading.Lock()
        # host -> list of its ranks (suspicion domain: remote hosts only)
        self._domains: dict[str, list[int]] = {}
        for r, h in sorted(self.hosts.items()):
            if h != self.local_host:
                self._domains.setdefault(h, []).append(r)
        # Suspicion needs an "elsewhere is fine" witness, which any
        # OTHER host (including the local one) can provide — but there
        # must be at least one remote domain to suspect.
        self.active = bool(self._domains) and \
            len(set(self.hosts.values())) >= 2
        self._state: dict[str, str] = {h: OK for h in self._domains}
        self._since: dict[str, float] = {}

    # ------------------------------------------------------------------

    def observe(self, silent: set[int], dead: set[int],
                fresh: set[int], now: float | None = None) -> list[dict]:
        """Consume one liveness snapshot; return transition events.

        ``silent``: ranks whose heartbeats are stale; ``dead``: ranks
        whose process is known-exited; ``fresh``: ranks heard from
        recently.  Events are ``{"host", "event": "suspected" |
        "healed" | "expired", "ranks", "ts"}``; counters and flight
        records fire here so both consumers report identically.
        """
        if not self.active:
            return []
        now = self._clock() if now is None else now
        events: list[dict] = []
        with self._lock:
            for host, ranks in self._domains.items():
                gone = all(r in silent or r in dead for r in ranks)
                witness = any(r in fresh for r, h in self.hosts.items()
                              if h != host)
                st = self._state[host]
                if st == OK:
                    if gone and witness:
                        self._state[host] = SUSPECTED
                        self._since[host] = now
                        events.append({"host": host, "event": "suspected",
                                       "ranks": list(ranks), "ts": now})
                elif st == SUSPECTED:
                    if any(r in fresh for r in ranks):
                        self._state[host] = OK
                        self._since.pop(host, None)
                        events.append({"host": host, "event": "healed",
                                       "ranks": list(ranks), "ts": now})
                    elif now - self._since[host] > self.grace_s:
                        self._state[host] = EXPIRED
                        events.append({"host": host, "event": "expired",
                                       "ranks": list(ranks), "ts": now})
                elif st == EXPIRED:
                    # A host can come back even after we gave up on it
                    # (the heal may not have replaced it yet).
                    if any(r in fresh for r in ranks):
                        self._state[host] = OK
                        self._since.pop(host, None)
                        events.append({"host": host, "event": "healed",
                                       "ranks": list(ranks), "ts": now})
        for ev in events:
            flightrec.record(f"partition_{ev['event']}", host=ev["host"],
                             ranks=ev["ranks"], source=self.source)
            if ev["event"] == "suspected":
                obs_metrics.registry().counter(
                    "nbd_partition_suspected_total",
                    "whole-host heartbeat-loss episodes treated as "
                    "suspected partitions",
                    {"source": self.source}).inc()
        return events

    # ------------------------------------------------------------------

    def suspected_hosts(self) -> dict[str, float]:
        """host -> suspected-since timestamp, for hosts currently in
        the SUSPECTED state (grace not yet expired)."""
        with self._lock:
            return {h: self._since[h] for h, s in self._state.items()
                    if s == SUSPECTED}

    def expired_hosts(self) -> list[str]:
        with self._lock:
            return sorted(h for h, s in self._state.items()
                          if s == EXPIRED)

    def suspected_ranks(self) -> set[int]:
        """Every rank on a currently-suspected host — consumers must
        not treat their silence as death (supervisor) or their lag as
        a hang (watchdog) while the grace clock runs."""
        with self._lock:
            sus = {h for h, s in self._state.items() if s == SUSPECTED}
        return {r for r, h in self.hosts.items() if h in sus}

    def state_of(self, host: str) -> str:
        with self._lock:
            return self._state.get(host, OK)

    def describe(self) -> str:
        """One status line for %dist_status / the doctor."""
        with self._lock:
            sus = {h: self._since[h] for h, s in self._state.items()
                   if s == SUSPECTED}
            exp = [h for h, s in self._state.items() if s == EXPIRED]
        if not sus and not exp:
            return ""
        now = self._clock()
        parts = [f"⚡ {h}: suspected partition for {now - t:.0f}s "
                 f"(grace {self.grace_s:.0f}s)" for h, t in sus.items()]
        parts += [f"✖ {h}: partition grace expired — treated as lost"
                  for h in exp]
        return " · ".join(parts)
