"""The port's hang watchdog (``resilience/watchdog.py``) against the JAX
package's, and the port's progress-stream adaptations.

Both packages' ``HangPolicy`` parse the same ``NBD_HANG_*``
environments to the same policies and refuse the same bad ones; both
``SkewDetector``s give the same verdicts (kind, cell, ranks, peers,
position, detail) on the same position and busy streams; both
``HangWatchdog``s walk the same ladder over one fake comm and process
manager, and the port records each rung in its flight ring;
``hang_report`` has the same sections.  Then the port's own parts: the
seeded ``dist``'s collectives on the progress stream
(``runtime/tracked_dist.py``), the completion probe that keeps an
enqueued NCCL collective "in" (``runtime/collective_guard.py``), and the
forced heal the watchdog's heal rung runs.
"""

import dataclasses
import re

import pytest

from nbdistributed_tpu.resilience import watchdog as jax_wd
from nbdistributed_tpu_torch.observability import flightrec
from nbdistributed_tpu_torch.resilience import watchdog as wd_mod
from nbdistributed_tpu_torch.runtime import collective_guard as cg
from nbdistributed_tpu_torch.runtime import tracked_dist

# ----------------------------------------------------------------------
# HangPolicy


ENVS = [
    {},
    {"NBD_HANG": "0"},
    {"NBD_HANG_SKEW_S": "5", "NBD_HANG_STALL_S": "9",
     "NBD_HANG_POLL_S": "0.2", "NBD_HANG_GRACE_S": "3",
     "NBD_HANG_ESCALATE": "warn,dump,interrupt,heal"},
    {"NBD_HANG_SKEW_S": "soon"},
    {"NBD_HANG_POLL_S": "0.25", "NBD_HANG_SKEW_S": "3",
     "NBD_HANG_STALL_S": "5", "NBD_HANG_GRACE_S": "2"},
    {"NBD_HANG_ESCALATE": "heal"},
    {"NBD_HANG_ESCALATE": " warn , interrupt "},
    {"NBD_HANG": "false", "NBD_HANG_STALL_S": "33"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_policy_from_env_equals_jax(env):
    got = wd_mod.HangPolicy.from_env(env=env)
    want = jax_wd.HangPolicy.from_env(env=env)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.describe() == want.describe()
    lenient = wd_mod.HangPolicy.from_env_lenient(env=env)
    assert dataclasses.asdict(lenient) == dataclasses.asdict(
        jax_wd.HangPolicy.from_env_lenient(env=env))


BAD = [
    lambda m: m.parse_ladder("warn,dmup"),
    lambda m: m.HangPolicy(escalate=("warn", "explode")),
    lambda m: m.HangPolicy.from_env(env={"NBD_HANG_ESCALATE": "wran"}),
]


@pytest.mark.parametrize("bad", BAD, ids=["ladder", "policy", "env"])
def test_policy_refusals_equal_jax(bad):
    errors = []
    for mod in (jax_wd, wd_mod):
        with pytest.raises(ValueError) as e:
            bad(mod)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "unknown escalation" in errors[1]
    lenient = [m.HangPolicy.from_env_lenient(
        env={"NBD_HANG_ESCALATE": "wran", "NBD_HANG_STALL_S": "33"})
        for m in (jax_wd, wd_mod)]
    assert dataclasses.asdict(lenient[0]) == dataclasses.asdict(lenient[1])


# ----------------------------------------------------------------------
# SkewDetector on synthetic streams


def _busy(mid, s, seq=None, op=None, in_=False, cops=None, deadline=None,
          rep=None):
    v = {"busy_id": mid, "busy_type": "execute", "busy_s": s,
         "hb_age": 0.5}
    if seq is not None:
        v.update({"seq": seq, "op": op or "all_reduce", "in": in_,
                  "cops": seq if cops is None else cops})
    if deadline is not None:
        v["deadline"] = deadline
    if rep is not None:
        v["rep"] = rep
    return v


def _uniformly_slow():
    for step in range(8):
        now = step * 20.0
        yield now, {r: _busy("m1", now + 5, seq=step + 1, in_=True)
                    for r in range(4)}, {}


def _inside_one_collective():
    for now, s in ((0.0, 5.0), (40.0, 45.0), (65.0, 70.0)):
        yield now, {r: _busy("m1", s, seq=3, in_=True)
                    for r in range(4)}, {}


def _skew_behind():
    # Ranks 0-2 entered all_reduce #7; rank 3 never did.
    for now in (0.0, 6.0, 12.0, 18.0):
        ranks = {r: _busy("m1", 30 + now, seq=7, in_=True)
                 for r in range(3)}
        ranks[3] = _busy("m1", 30 + now, seq=6, in_=False)
        yield now, ranks, {}


def _finished_below():
    # ``if rank != 3: dist.all_reduce(t)``: rank 3 finished the cell at
    # #0 while ranks 0-2 are inside all_reduce #1 (on NCCL: behind its
    # completion probe, blocked at the next host sync).
    pend = {"m1": {"type": "execute", "expect": [0, 1, 2, 3],
                   "responded": [3], "sent_at": 0.0}}
    for now in (0.0, 4.0, 8.0, 12.0):
        yield now, {r: _busy("m1", 1 + now, seq=1, in_=True)
                    for r in range(3)}, pend


def _local_work_after_collective():
    pend = {"m1": {"type": "execute", "expect": [0, 1],
                   "responded": [0], "sent_at": 0.0}}
    for now in (0.0, 11.0, 22.0, 33.0):
        yield now, {1: _busy("m1", 5 + now, seq=4, in_=False)}, pend


def _infinite_loop():
    for now in (0.0, 30.0, 61.0, 62.0):
        yield now, {r: _busy("m1", 1 + now) for r in range(2)}, {}


def _deadline():
    for now, s in ((0.0, 1.0), (2.0, 3.5), (3.0, 4.5)):
        yield now, {r: _busy("m1", s, seq=2, deadline=3.0)
                    for r in range(2)}, {}


def _phantom_divergence():
    # One poll where rank 1's slower ping still shows the old position.
    views = [(0.0, (5, 5)), (8.0, (6, 5)), (9.0, (6, 6)), (25.0, (7, 7))]
    for now, (a, b) in views:
        yield now, {0: _busy("m1", 10 + now, seq=a, in_=True),
                    1: _busy("m1", 10 + now, seq=b, in_=True)}, {}


def _repeat_loop_advancing():
    for i, now in enumerate((0.0, 40.0, 80.0, 120.0)):
        yield now, {r: _busy("m1", 1 + now, rep=i) for r in range(2)}, {}


def _two_cells():
    # Rank 0 still on cell m1, rank 1 on m2: no cross-cell skew.
    for now in (0.0, 15.0, 30.0):
        yield now, {0: _busy("m1", 5 + now, seq=3, in_=True),
                    1: _busy("m2", 5 + now, seq=9, in_=True)}, {}


STREAMS = {"uniformly_slow": _uniformly_slow,
           "inside_one_collective": _inside_one_collective,
           "skew_behind": _skew_behind,
           "finished_below": _finished_below,
           "local_work_after_collective": _local_work_after_collective,
           "infinite_loop": _infinite_loop, "deadline": _deadline,
           "phantom_divergence": _phantom_divergence,
           "repeat_loop_advancing": _repeat_loop_advancing,
           "two_cells": _two_cells}
EXPECT = {"uniformly_slow": set(), "inside_one_collective": {"stall"},
          "skew_behind": {"skew"}, "finished_below": {"skew"},
          "local_work_after_collective": set(),
          "infinite_loop": {"stall"}, "deadline": {"deadline"},
          "phantom_divergence": set(), "repeat_loop_advancing": set(),
          "two_cells": set()}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_skew_detector_verdicts_equal_jax(name):
    pol = {m: m.HangPolicy(skew_s=10.0, stall_s=60.0) for m in (jax_wd,
                                                                wd_mod)}
    dets = {m: m.SkewDetector(pol[m]) for m in pol}
    kinds = set()
    for now, ranks, pending in STREAMS[name]():
        got = dets[wd_mod].observe(now, ranks, pending)
        want = dets[jax_wd].observe(now, ranks, pending)
        assert got == want, (name, now)
        kinds |= {v["kind"] for v in got}
    assert kinds == EXPECT[name]


def test_finished_below_names_the_rank_that_skipped():
    det = wd_mod.SkewDetector(wd_mod.HangPolicy(skew_s=3.0, stall_s=5.0))
    verdicts = []
    for now, ranks, pending in _finished_below():
        verdicts = det.observe(now, ranks, pending) or verdicts
    (v,) = verdicts
    assert v["kind"] == "skew" and v["ranks"] == [0, 1, 2]
    assert v["peers"] == [3] and v["op"] == "all_reduce" and v["seq"] == 1
    assert v["detail"].startswith("ranks [3] finished the cell but rank(s)"
                                  " [0, 1, 2] are stuck inside all_reduce")


# ----------------------------------------------------------------------
# HangWatchdog's ladder over a fake comm and process manager


class FakeComm:
    def __init__(self, n=2):
        self.num_workers = n
        self.pings = {}
        self.pending = {}

    def last_ping(self, rank):
        return self.pings.get(rank)

    def pending_snapshot(self):
        return dict(self.pending)


class FakePM:
    def __init__(self, ranks):
        self._ranks = list(ranks)
        self.dumped = []
        self.interrupted = []

    def alive_ranks(self):
        return list(self._ranks)

    def dump_stacks(self, ranks=None):
        self.dumped.append(ranks)
        return list(self._ranks)

    def interrupt(self, ranks=None):
        self.interrupted.append(ranks)
        return list(self._ranks)


def _drive_ladder(mod):
    """One skew hang walked up warn → dump → interrupt → heal, then
    cleared by the heal's fresh world.  Returns the watchdog, both
    process managers and the heal count."""
    healed = []
    comm2, pm2 = FakeComm(2), FakePM([0, 1])

    def heal():
        healed.append(1)
        return comm2, pm2

    clock = {"t": 1000.0}
    pol = mod.HangPolicy(skew_s=5, stall_s=60, grace_s=10,
                         escalate=("warn", "dump", "interrupt", "heal"))
    wd = mod.HangWatchdog(pol, heal=heal, clock=lambda: clock["t"])
    comm, pm = FakeComm(2), FakePM([0, 1])
    wd._comm, wd._pm = comm, pm
    comm.pending["m1"] = {"type": "execute", "expect": [0, 1],
                          "responded": [0], "sent_at": 990.0}
    busy = {"busy_type": "execute", "busy_s": 3.0, "busy_id": "m1",
            "col": {"seq": 2, "op": "all_reduce", "in": True,
                    "age": 3.0, "cops": 2}}
    for dt in (0.0, 6.0, 5.0, 6.0, 11.0, 11.0, 1.0):
        clock["t"] += dt
        comm.pings[1] = (clock["t"], busy)
        wd.poll_once()
    return wd, pm, pm2, healed


def _events(wd):
    return [{k: v for k, v in e.items() if k != "ts"} for e in wd.events]


def test_ladder_runs_each_rung_equal_to_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("NBD_RUN_DIR", str(tmp_path))
    flightrec.reset_for_tests()
    flightrec.init("coordinator", directory=str(tmp_path))
    try:
        runs = {m: _drive_ladder(m) for m in (jax_wd, wd_mod)}
        (jwd, jpm, jpm2, jhealed), (wd, pm, pm2, healed) = (
            runs[jax_wd], runs[wd_mod])
        assert wd.escalations == jwd.escalations == {
            "warn": 1, "dump": 1, "interrupt": 1, "heal": 1}
        assert _events(wd) == _events(jwd)
        assert (wd.cells_flagged, wd.cells_resolved) == (
            jwd.cells_flagged, jwd.cells_resolved) == (1, 0)
        assert pm.dumped == jpm.dumped == [None]
        assert pm.interrupted == jpm.interrupted == [None]
        assert healed == jhealed == [1]
        assert wd._pm is pm2 and wd.status()["active"] == {}
        out = capsys.readouterr().out
        assert out.count("hang watchdog [SKEW]") == 2
        assert out.count("interrupted ranks [0, 1]") == 2
        flightrec.recorder().flush()
        ring = flightrec.read_latest(str(tmp_path), "coordinator")
        kinds = [(e["t"], e.get("step") or e.get("kind"))
                 for e in ring["events"] if e["t"].startswith("hang_")]
        assert kinds == [("hang_verdict", "skew"),
                         ("hang_escalation", "warn"),
                         ("hang_escalation", "dump"),
                         ("hang_escalation", "interrupt"),
                         ("hang_escalation", "heal")]
    finally:
        flightrec.reset_for_tests()


def test_hang_report_has_the_same_sections(tmp_path, monkeypatch):
    import time
    monkeypatch.setenv("NBD_RUN_DIR", str(tmp_path))
    reports = []
    for mod in (jax_wd, wd_mod):
        clock = {"t": time.time()}
        wd = mod.HangWatchdog(
            mod.HangPolicy(skew_s=2, stall_s=60, grace_s=2,
                           escalate=("warn",)),
            clock=lambda: clock["t"])
        comm = FakeComm(2)
        wd._comm = comm
        comm.pending["mA"] = {"type": "execute", "expect": [0, 1],
                              "responded": [], "sent_at": clock["t"] - 5}
        for _ in range(2):
            for r, seq, in_ in ((0, 7, True), (1, 6, False)):
                comm.pings[r] = (clock["t"], {
                    "busy_type": "execute", "busy_s": 20.0,
                    "busy_id": "mA",
                    "col": {"seq": seq, "op": "all_reduce", "in": in_,
                            "age": 18.0, "cops": seq}})
            wd.poll_once()
            clock["t"] += 3.0
        reports.append(mod.hang_report(comm, None, wd, dump_stacks=False))
    sections = [[re.sub(r"[\d.]+s", "Ns", ln) for ln in r.splitlines()[3:]]
                for r in reports]
    assert sections[0] == sections[1]
    assert reports[1].startswith("nbdistributed_tpu_torch stuck-cell "
                                 "doctor\n" + "=" * 41)
    assert "lagging rank(s) [1]" in reports[1]
    assert "HUNG [skew]" in reports[1]


# ----------------------------------------------------------------------
# the port's progress stream: the seeded dist, the completion probe


def test_tracked_dist_counts_world_collectives_only(monkeypatch):
    """The seeded ``dist`` advances the stream for a world collective
    (no hazard check, so a subset cell's call is not refused here), not
    for a subgroup's, and is ``torch.distributed`` otherwise."""
    import torch.distributed as dist
    monkeypatch.setattr(tracked_dist, "completion_probe",
                        lambda out=None: None)
    calls = []

    def fake_all_reduce(tensor, op=None, group=None, async_op=False):
        calls.append(group)
        return "done"

    cg.reset_progress()
    cg.begin_cell([0], world=2)         # a strict subset of the world
    try:
        wrapped = tracked_dist._tracked("all_reduce", fake_all_reduce)
        assert wrapped(1) == "done"
        assert cg.progress()["seq"] == 1 and cg.progress()["in"] is False
        assert wrapped(1, None, dist.group.WORLD) == "done"
        assert cg.progress()["seq"] == 2
        sub = object()
        wrapped(1, group=sub)
        wrapped(1, None, sub)
        assert cg.progress()["seq"] == 2 and calls[-2:] == [sub, sub]
        assert cg.end_cell() == 2
    finally:
        cg.reset_progress()
    seeded = tracked_dist.TrackedDist()
    assert seeded.get_rank is dist.get_rank
    assert seeded.ReduceOp is dist.ReduceOp
    assert seeded.send is dist.send                 # point to point
    assert seeded.all_reduce is not dist.all_reduce
    assert seeded.all_reduce.__wrapped__ is dist.all_reduce
    assert seeded.all_reduce is seeded.all_reduce   # built once
    assert set(tracked_dist.WORLD_COLLECTIVES) <= set(dir(seeded))


def test_completion_probe_keeps_an_enqueued_collective_in_flight():
    """An NCCL collective returns at enqueue: the entry stays "in" on
    the heartbeat's view until the probe reports the work done, and a
    newer entry is never rewound by an older probe."""
    cg.reset_progress()
    state = {"done": False}
    try:
        cg.enter("all_reduce")
        cg.done("all_reduce", probe=lambda: state["done"])
        assert cg.progress()["in"] is True
        assert cg.progress()["in"] is True
        state["done"] = True
        snap = cg.progress()
        assert snap["in"] is False and snap["seq"] == 1
        cg.enter("broadcast")
        cg.done("broadcast", probe=lambda: True)    # already complete
        assert cg.progress()["in"] is False
        cg.enter("barrier")
        stale = {"done": False}
        cg.done("barrier", probe=lambda: stale["done"])
        cg.enter("all_gather")                       # next entry
        stale["done"] = True
        snap = cg.progress()
        assert (snap["seq"], snap["op"], snap["in"]) == (4, "all_gather",
                                                         True)
        cg.done("all_gather")
        assert cg.progress()["in"] is False
        cg.enter("all_reduce")
        cg.done("all_reduce", probe=lambda: 1 / 0)  # a broken probe
        assert cg.progress()["in"] is False
    finally:
        cg.reset_progress()


def test_completion_probe_without_a_process_group_is_none():
    assert tracked_dist.completion_probe() is None

    class Work:
        def is_completed(self):
            return False

    w = Work()
    assert tracked_dist.completion_probe(w) == w.is_completed


def test_heal_rung_forces_the_rebuild(monkeypatch):
    """The watchdog's heal rung heals a world whose hung ranks are all
    alive: it passes ``--force`` (and the last checkpoint) to
    ``%dist_heal``; the supervisor's death heal does not force."""
    from nbdistributed_tpu_torch.magics.magic import DistributedMagics

    class Shell:
        user_ns: dict = {}
        input_transformers_cleanup: list = []

    DistributedMagics.reset_class_state()
    m = DistributedMagics(Shell())
    lines = []
    monkeypatch.setattr(m, "dist_heal", lines.append)
    monkeypatch.setattr(m, "_running", lambda: True)
    monkeypatch.setattr(DistributedMagics, "_last_ckpt_path", "ck/a")
    m._watchdog_heal()
    m._supervised_heal()
    monkeypatch.setattr(DistributedMagics, "_last_ckpt_path", None)
    m._watchdog_heal()
    assert lines == ["--force --restore ck/a", "--restore ck/a", "--force"]
