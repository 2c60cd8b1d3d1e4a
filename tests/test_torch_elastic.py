"""The port's elastic-pool substrate against the JAX package's:
``AutoscalePolicy`` from the same environments, ``PoolAutoscaler``
decisions and audit records on the same pressure series, and
``PoolMembership`` through the same resize plans — compared exactly
(dataclass fields, decision tuples, every audit record, every
``describe()``).  Plus the port's own copies of the JAX unit cases
(``tests/unit/test_elastic.py``) that are not about serving, and the
``gc_runs`` keep-rule for a pool mid-resize on both packages.

Pure state machines on fake clocks: no processes, no sleeps.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest

from nbdistributed_tpu.gateway import membership as jax_membership
from nbdistributed_tpu.resilience import autoscaler as jax_autoscaler
from nbdistributed_tpu_torch.gateway import membership as membership
from nbdistributed_tpu_torch.resilience import autoscaler as autoscaler

PAIRS = [("jax", jax_autoscaler, jax_membership),
         ("torch", autoscaler, membership)]


@pytest.fixture(params=PAIRS, ids=[p[0] for p in PAIRS])
def mods(request):
    return request.param[1], request.param[2]


ENVS = [
    {},
    {"NBD_AUTOSCALE_MIN": "2", "NBD_AUTOSCALE_MAX": "16",
     "NBD_AUTOSCALE_UP_QUEUE": "1", "NBD_AUTOSCALE_SUSTAIN_S": "3",
     "NBD_AUTOSCALE_COOLDOWN_S": "7", "NBD_AUTOSCALE_IDLE_S": "30"},
    {"NBD_AUTOSCALE_SUSTAIN_S": "x", "NBD_AUTOSCALE_MAX": "y"},
    {"NBD_AUTOSCALE_UP_BACKLOG": "0", "NBD_AUTOSCALE_UP_P95_S": "0.5",
     "NBD_AUTOSCALE_INTERVAL_S": "1"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_policy_from_env_equals_jax(env):
    ours = autoscaler.AutoscalePolicy.from_env(env=env)
    ref = jax_autoscaler.AutoscalePolicy.from_env(env=env)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.describe() == ref.describe()


def _series(seed, n=400):
    """A seeded load series: spikes, sustained pressure, idle
    stretches, out-of-band worlds, each signal on its own."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    regime = "idle"
    for _ in range(n):
        t += float(rng.choice([0.5, 1.0, 2.5, 5.0, 10.0]))
        if rng.random() < 0.08:
            regime = str(rng.choice(["idle", "queue", "backlog", "p95",
                                     "spike", "busy"]))
        q = b = a = 0
        p95 = 0.0
        if regime == "queue":
            q = int(rng.integers(0, 12))
        elif regime == "backlog":
            b = int(rng.integers(0, 20))
        elif regime == "p95":
            p95 = float(rng.uniform(0.0, 5.0))
        elif regime == "spike":
            q = 20 if rng.random() < 0.2 else 0
        elif regime == "busy":
            a = int(rng.integers(0, 3))
        out.append((t, q, a, b, p95))
    return out


def _drive(mod, series, policy_kw, world=2, jumps=()):
    a = mod.PoolAutoscaler(mod.AutoscalePolicy(**policy_kw))
    decisions = []
    for i, (t, q, act, b, p95) in enumerate(series):
        if i in jumps:
            world = jumps[i]            # an operator resized by hand
        d = a.observe(t, world_size=world, queued=q, active=act,
                      backlog=b, queue_p95_s=p95)
        if d is not None:
            decisions.append((i, d.action, d.target, d.reason))
            world = d.target
            a.note_resized(t + 1.0)
    return decisions, a.decisions(), a.decisions_total


POLICIES = [
    dict(min_workers=1, max_workers=8, sustain_s=10.0, idle_s=60.0,
         cooldown_s=30.0),
    dict(min_workers=2, max_workers=4, sustain_s=3.0, idle_s=20.0,
         cooldown_s=5.0, up_queue=2, up_backlog=0, up_p95_s=1.0),
    dict(min_workers=1, max_workers=3, sustain_s=0.0, idle_s=5.0,
         cooldown_s=0.0),
]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pol", range(len(POLICIES)))
def test_decisions_and_audit_equal_jax_on_a_pressure_series(seed, pol):
    series = _series(seed)
    jumps = {50: 9, 120: 1, 300: 5}     # out-of-band worlds: clamps
    ours = _drive(autoscaler, series, POLICIES[pol], jumps=jumps)
    ref = _drive(jax_autoscaler, series, POLICIES[pol], jumps=jumps)
    assert ours[0], "the series decided nothing: it tests nothing"
    assert ours[0] == ref[0]
    assert json.dumps(ours[1], sort_keys=True) \
        == json.dumps(ref[1], sort_keys=True)
    assert ours[2] == ref[2]


def _scaler(mod, **kw):
    kw.setdefault("min_workers", 1)
    kw.setdefault("max_workers", 8)
    kw.setdefault("sustain_s", 10.0)
    kw.setdefault("idle_s", 60.0)
    kw.setdefault("cooldown_s", 30.0)
    return mod.PoolAutoscaler(mod.AutoscalePolicy(**kw))


def test_grow_requires_sustained_pressure(mods):
    mod, _ = mods
    a = _scaler(mod)
    assert a.observe(0.0, world_size=2, queued=10) is None
    assert a.observe(5.0, world_size=2, queued=10) is None
    d = a.observe(10.0, world_size=2, queued=10)
    assert d.action == "grow" and d.target == 4 and "queue" in d.reason


def test_single_spike_does_not_flap(mods):
    mod, _ = mods
    a = _scaler(mod)
    assert a.observe(0.0, world_size=2, queued=10) is None
    assert a.observe(5.0, world_size=2, queued=0, active=1) is None
    assert a.observe(6.0, world_size=2, queued=10) is None
    assert a.observe(12.0, world_size=2, queued=10) is None
    assert a.observe(16.0, world_size=2, queued=10).action == "grow"


def test_cooldown_blackout(mods):
    mod, _ = mods
    a = _scaler(mod)
    a.observe(0.0, world_size=2, queued=10)
    assert a.observe(10.0, world_size=2, queued=10).action == "grow"
    a.note_resized(11.0)
    a.observe(12.0, world_size=4, queued=10)
    assert a.observe(30.0, world_size=4, queued=10) is None
    assert a.observe(45.0, world_size=4, queued=10) is None
    assert a.observe(55.0, world_size=4, queued=10).action == "grow"
    rec = a.decisions()[-3]
    assert rec["verdict"] == "hold" and rec["reason"] == "cooldown"


def test_shrink_after_idle_and_band_clamp(mods):
    mod, _ = mods
    a = _scaler(mod)
    a.observe(0.0, world_size=4)
    d = a.observe(60.0, world_size=4)
    assert d.action == "shrink" and d.target == 2
    a = _scaler(mod, min_workers=2, max_workers=4)
    d = a.observe(0.0, world_size=1)
    assert d.action == "grow" and d.target == 2 and d.record["clamp"]
    d = a.observe(0.0, world_size=9, queued=50)
    assert d.action == "shrink" and d.target == 4


# ----------------------------------------------------------------------
# PoolMembership


PLANS = [
    # (op, args) over one membership, world 2 at epoch 1.
    [("begin", 4, 2, "pressure", 10.0), ("complete", 4, 2, 11.0),
     ("begin", 2, 3, "idle", 20.0), ("complete", 2, 3, 21.0)],
    [("begin", 3, 2, "manual", 1.0), ("abort",),
     ("begin", 5, 2, "manual", 2.0), ("complete", 5, 2, 3.0)],
    [("begin", 4, 2, "a", 1.0), ("begin", 3, 3, "b", 2.0),
     ("complete", 4, 2, 3.0)],
    [("complete", 3, 2, 1.0), ("complete", 1, 3, 2.0)]
    + [("begin", 2, e, "cycle", float(e)) for e in (4,)]
    + [("complete", 2, 4, 5.0)]
    + sum([[("begin", 3, e, "churn", float(e)),
            ("complete", 3, e, float(e) + 0.5)]
           for e in range(5, 25)], []),
]


def _run_plan(mod, plan):
    m = mod.PoolMembership(2, epoch=1, now=0.5)
    trace = [m.describe()]
    for step in plan:
        op = step[0]
        try:
            if op == "begin":
                out = m.begin_resize(step[1], step[2], reason=step[3],
                                     now=step[4])
            elif op == "complete":
                out = m.complete_resize(step[1], step[2], now=step[3])
            else:
                out = m.abort_resize()
        except RuntimeError as e:
            out = f"RuntimeError: {e}"
        trace.append((op, out, m.describe(), m.active_ranks(),
                      m.draining, m.epoch, m.transition(),
                      [m.epoch_set(e) for e in range(0, 26)],
                      [m.rank_state(r) for r in range(6)]))
    return trace


@pytest.mark.parametrize("plan", range(len(PLANS)))
def test_membership_equals_jax_through_a_resize_plan(plan):
    ours = _run_plan(membership, PLANS[plan])
    ref = _run_plan(jax_membership, PLANS[plan])
    assert json.dumps(ours, sort_keys=True, default=str) \
        == json.dumps(ref, sort_keys=True, default=str)


def test_membership_resize_cycle(mods):
    _, mod = mods
    m = mod.PoolMembership(2, epoch=1)
    plan = m.begin_resize(4, 2, reason="pressure", now=10.0)
    assert plan["from_world"] == 2 and plan["to_world"] == 4
    assert m.draining and m.rank_state(0) == mod.DRAINING
    assert m.active_ranks() == []
    with pytest.raises(RuntimeError, match="already in flight"):
        m.begin_resize(3, 3)
    gen = m.complete_resize(4, 2, now=11.0)
    assert gen == 2 and m.generation == 2 and m.epoch == 2
    assert m.active_ranks() == [0, 1, 2, 3] and not m.draining
    assert m.epoch_set(1) == [0, 1]
    assert m.describe()["retired_epochs"] == [1]
    m.begin_resize(2, 3)
    m.abort_resize()
    assert not m.draining and m.active_ranks() == [0, 1, 2, 3]


# ----------------------------------------------------------------------
# gc_runs: a pool mid-resize keeps its run dir on both packages


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_gc_keeps_recent_gateway_manifest(pkg, tmp_path, monkeypatch):
    if pkg == "jax":
        from nbdistributed_tpu.resilience import session as session_mod
    else:
        from nbdistributed_tpu_torch.resilience import session as \
            session_mod
    monkeypatch.delenv("NBD_RUN_DIR", raising=False)
    root = tmp_path / "runs"
    d = root / "pool-x"
    d.mkdir(parents=True)
    now = time.time()
    (d / "gateway.json").write_text(json.dumps({
        "kind": "gateway", "pid": 2 ** 30, "epoch": 2,
        "updated_ts": now - 5.0}))
    os.utime(d, (now - 7200, now - 7200))
    res = session_mod.gc_runs(str(root), ttl_s=60.0, dry_run=True,
                              now=now)
    assert str(d) in res["kept"]
    assert "resize" in res["kept_why"][str(d)]
    (d / "gateway.json").write_text(json.dumps({
        "kind": "gateway", "pid": 2 ** 30, "epoch": 2,
        "updated_ts": now - 9000}))
    os.utime(d / "gateway.json", (now - 9000, now - 9000))
    os.utime(d, (now - 9000, now - 9000))
    res = session_mod.gc_runs(str(root), ttl_s=60.0, dry_run=True,
                              now=now)
    assert str(d) in res["swept"]
