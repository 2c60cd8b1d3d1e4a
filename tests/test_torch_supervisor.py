"""The port's auto-heal supervisor (``resilience/supervisor.py``) against
the JAX package's: the cases of ``tests/unit/test_resilience.py``'s
``test_supervisor_*`` run on both packages' ``Supervisor`` over the
same fake comm and process manager, and the transitions each records
are held equal — heal on death and re-bind, the budget capping a crash
loop, degraded is not dead, a failed heal retried until the budget is
spent — plus the postmortem each takes before healing and the
describe line."""

import threading
import time

import pytest

from nbdistributed_tpu.resilience import supervisor as jax_sup
from nbdistributed_tpu_torch.resilience import supervisor as sup_mod


class FakePM:
    def __init__(self):
        self.cbs = []

    def add_death_callback(self, cb):
        self.cbs.append(cb)

    def remove_death_callback(self, cb):
        self.cbs.remove(cb)

    def die(self, rank, rc=-9):
        for cb in list(self.cbs):
            cb(rank, rc)


class FakeComm:
    def __init__(self, n=2):
        self.num_workers = n
        self.pings = {}
        self.seen = {}

    def last_ping(self, rank):
        return self.pings.get(rank)

    def last_seen(self, rank):
        return self.seen.get(rank)


def _wait(cond, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def _moves(sup):
    return [(e["rank"], e["from"], e["to"]) for e in sup.status()["events"]
            if e["rank"] is not None]


@pytest.fixture(autouse=True)
def _run_dir(tmp_path, monkeypatch):
    # The supervisor takes a postmortem of each death into the run dir.
    monkeypatch.setenv("NBD_RUN_DIR", str(tmp_path))


def _heal_on_death(mod):
    healed = threading.Event()
    comm2, pm2 = FakeComm(), FakePM()

    def heal():
        healed.set()
        return comm2, pm2

    sup = mod.Supervisor(mod.SupervisorPolicy(poll_s=0.02,
                                              degraded_after_s=0.3),
                         heal=heal)
    comm, pm = FakeComm(), FakePM()
    try:
        sup.attach(comm, pm)
        now = time.time()
        comm.seen = {0: now, 1: now}
        pm.die(1)
        assert healed.wait(5), "heal was never invoked"
        assert _wait(sup.healthy)
        st = sup.status()
        assert st["heals_done"] == 1 and st["restarts_used"] == 1
        assert pm.cbs == [] and len(pm2.cbs) == 1     # re-bound
        pm2.die(0)
        assert _wait(lambda: sup.status()["heals_done"] == 2)
        assert _wait(sup.healthy)
        return _moves(sup), sup.status()["restarts_used"]
    finally:
        sup.stop()


def _budget_caps_crash_loops(mod):
    calls = []
    sup = mod.Supervisor(mod.SupervisorPolicy(poll_s=0.02, max_restarts=1,
                                              restart_window_s=600.0),
                         heal=lambda: calls.append(1) or None)
    comm, pm = FakeComm(), FakePM()
    try:
        sup.attach(comm, pm)
        pm.die(0)
        assert _wait(lambda: len(calls) == 1)
        assert _wait(sup.healthy)
        pm.die(1)
        assert _wait(lambda: any("budget exhausted" in e["detail"]
                                 for e in sup.status()["events"]))
        assert len(calls) == 1 and sup.status()["states"][1] == "dead"
        return _moves(sup), len(calls)
    finally:
        sup.stop()


def _degraded_is_not_dead(mod):
    calls = []
    sup = mod.Supervisor(mod.SupervisorPolicy(poll_s=0.02,
                                              degraded_after_s=0.3),
                         heal=lambda: calls.append(1) or None)
    comm, pm = FakeComm(), FakePM()
    try:
        sup.attach(comm, pm)
        now = time.time()
        comm.seen = {0: now, 1: now - 10}
        assert _wait(lambda: sup.status()["states"][1] == "degraded")
        assert sup.status()["states"][0] == "alive"
        comm.seen[1] = time.time()
        assert _wait(lambda: sup.status()["states"][1] == "alive")
        assert not calls
        return _moves(sup), len(calls)
    finally:
        sup.stop()


def _failed_heal_retries(mod):
    def heal():
        raise RuntimeError("respawn failed")

    sup = mod.Supervisor(mod.SupervisorPolicy(poll_s=0.02, max_restarts=2,
                                              restart_window_s=600.0),
                         heal=heal)
    comm, pm = FakeComm(), FakePM()
    try:
        sup.attach(comm, pm)
        pm.die(0)
        assert _wait(lambda: sup.status()["heals_failed"] == 2)
        assert _wait(lambda: any("budget exhausted" in e["detail"]
                                 for e in sup.status()["events"]))
        time.sleep(0.2)  # must not keep retrying past the budget
        st = sup.status()
        assert st["heals_failed"] == 2 and not sup.healthy()
        return _moves(sup), st["heals_failed"]
    finally:
        sup.stop()


CASES = {"heal_on_death_and_rebind": _heal_on_death,
         "budget_caps_crash_loops": _budget_caps_crash_loops,
         "degraded_is_not_dead": _degraded_is_not_dead,
         "failed_heal_retries_until_budget": _failed_heal_retries}


@pytest.mark.parametrize("name", sorted(CASES))
def test_supervisor_case_equals_jax(name):
    got = CASES[name](sup_mod)
    want = CASES[name](jax_sup)
    assert got == want


def test_death_takes_a_postmortem_before_the_heal(tmp_path):
    """Each death is bundled on the supervisor's thread before the
    heal; the bundle names the dead rank."""
    order = []
    comm2, pm2 = FakeComm(), FakePM()

    def heal():
        order.append(("heal", sup.last_postmortem is not None))
        return comm2, pm2

    sup = sup_mod.Supervisor(sup_mod.SupervisorPolicy(poll_s=0.02),
                             heal=heal)
    comm, pm = FakeComm(), FakePM()
    try:
        sup.attach(comm, pm)
        pm.die(1)
        assert _wait(lambda: sup.status()["heals_done"] == 1)
        assert order == [("heal", True)]
        assert sup.last_postmortem["dead_ranks"] == [1]
        assert sup.status()["last_postmortem"].startswith(str(tmp_path))
    finally:
        sup.stop()


def test_describe_line_equals_jax():
    lines = []
    for mod in (jax_sup, sup_mod):
        sup = mod.Supervisor(mod.SupervisorPolicy(auto_heal=False))
        sup._state = {0: mod.ALIVE, 1: mod.DEAD, 2: mod.HEALING,
                      3: mod.DEGRADED}
        sup.note_quarantine_suspect(3, "audit minority")
        lines.append(sup.describe().splitlines()[:2])
    assert lines[0] == lines[1]
    assert lines[1][0].startswith("🛡  supervisor: ●0:alive ✖1:dead "
                                  "🩹2:healing 🔶◐3:degraded")
