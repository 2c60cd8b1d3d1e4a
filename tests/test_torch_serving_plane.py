"""The port's serving plane (``gateway/serving.py``) against the JAX
package's, with no pool: the journal, the offset-dedup merge, and the
``ServingManager``'s admission, failover, recovery and delivery driven
against a fake comm.

Part 1 runs every case of ``tests/unit/test_serving_plane.py`` on the
port: the JAX file's source is compiled with its
``nbdistributed_tpu.`` imports pointed at ``nbdistributed_tpu_torch.``
(the fake comm then raises the port's ``WorkerDied``), so each case
holds the port to exactly what it holds the JAX package to.

Part 2 feeds both packages the same inputs and compares the outputs
exactly: one scripted session (submits, ticks driven by hand, a killed
decode rank, a successor plane over the same run dir) through both
managers, each over its own fake comm — the verdict sequence, the
delivered results, ``describe()``'s counters and the journal files line
for line; ``merge_emission`` on a seeded random stream; and
``ServeJournal.load``/``unfinished`` on the same files, torn tails
included, with a journal written by either package loaded by the
other.
"""

import json
import random

import jax_unit_cases
import pytest

import nbdistributed_tpu.gateway.serving as jax_serving
import nbdistributed_tpu_torch.gateway.serving as t_serving

CASES = {p: jax_unit_cases.load("test_serving_plane.py", p)
         for p in ("jax", "torch")}
SERVING = {"jax": jax_serving, "torch": t_serving}

# Part 1: every JAX case, on the port.
globals().update(jax_unit_cases.cases(CASES["torch"]))


# ----------------------------------------------------------------------
# Part 2: the same session through both managers

COUNTERS = ("accepted", "completed", "shed", "rejected", "replayed",
            "resumed", "failovers", "step_retries", "dup_dropped",
            "tokens_total", "decoding", "pending", "slots", "max_len",
            "decode_rank", "decode_ranks", "ranks", "kv", "last_error")

# (op, args): submit (tenant, prompt, max_new, priority), tick, crash
# rank (its next step raises ``WorkerDied`` before the comm lists it
# dead: the failover path, not a retirement), stream (rid, from).
SCRIPT = [
    ("submit", ("alice", [5, 9, 2], 6, 0)),
    ("submit", ("bob", [7, 1], 5, 1)),
    ("tick", ()),
    ("submit", ("alice", [3, 4, 8], 4, 0)),
    ("submit", ("alice", [2], 3, 0)),          # queued
    ("submit", ("alice", [6, 6], 3, 0)),       # at alice's cap
    ("submit", ("carol", [1] * 60, 10, 0)),    # too long
    ("tick", ()),
    ("submit", ("bob", [9, 9, 9], 4, 5)),      # sheds a queued one
    ("tick", ()),
    ("crash", (2,)),                           # a decode rank
    ("tick", ()),
    ("tick", ()),
    ("stream", ("r0", 2)),
    ("tick", ()), ("tick", ()), ("tick", ()), ("tick", ()),
    ("tick", ()), ("tick", ()), ("tick", ()), ("tick", ()),
]


def _tick(mgr, serving):
    try:
        mgr._tick()
    except serving._RankLost as e:
        mgr._on_rank_lost(e.rank)


def _session(pkg: str, run_dir: str, *, decode_ranks: int = 1) -> dict:
    cases, serving = CASES[pkg], SERVING[pkg]
    comm = cases["FakeComm"](num_workers=3, per_tick=1)
    delivered, notices = [], []
    mgr = serving.ServingManager(
        comm, run_dir, world_size=3, max_batch=2, max_len=64, steps=2,
        step_timeout=5.0, queue_depth=2, inflight=3,
        decode_ranks=decode_ranks, kv_block_tokens=8, kv_blocks=6,
        deliver=lambda t, m: delivered.append(
            (t, m.msg_type, m.msg_id, m.data)),
        notify=lambda t, m: notices.append((t, m.msg_type, m.data)))
    out = []
    for op, args in SCRIPT:
        if op == "submit":
            out.append(mgr.submit(args[0], args[1], args[2],
                                  priority=args[3]))
        elif op == "tick":
            _tick(mgr, serving)
        elif op == "crash":
            comm.kill(args[0])
            listed = comm.dead_ranks
            comm.dead_ranks = lambda: set()
            _tick(mgr, serving)
            comm.dead_ranks = listed
        else:
            out.append(mgr.stream(*args))
    d = mgr.describe()
    mgr.stop(close_workers=False)
    # A successor plane over the same run dir: it recovers whatever
    # the first left unfinished and runs it to the end.
    comm2 = cases["FakeComm"](num_workers=3, per_tick=2)
    succ = serving.ServingManager(
        comm2, run_dir, world_size=3, max_batch=2, max_len=64, steps=2,
        step_timeout=5.0, queue_depth=8, inflight=8,
        decode_ranks=decode_ranks, kv_block_tokens=8, kv_blocks=6,
        deliver=lambda t, m: delivered.append(
            (t, m.msg_type, m.msg_id, m.data)))
    succ._recover_from_journal()
    for _ in range(12):
        _tick(succ, serving)
    d2 = succ.describe()
    succ.stop(close_workers=False)
    with open(serving.journal_path(run_dir, "serve"),
              encoding="utf-8") as f:
        journal = f.read().splitlines()
    return {"verdicts": out, "delivered": delivered, "notices": notices,
            "describe": {k: d[k] for k in COUNTERS},
            "successor": {k: d2[k] for k in COUNTERS},
            "steps": comm.steps_seen + comm2.steps_seen,
            "journal": journal}


@pytest.mark.parametrize("decode_ranks", [1, 2])
def test_scripted_session_equal_to_jax(tmp_path, decode_ranks):
    got = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        got[pkg] = _session(pkg, str(d), decode_ranks=decode_ranks)
    j, t = got["jax"], got["torch"]
    assert t["verdicts"] == j["verdicts"]
    assert [v["status"] for v in t["verdicts"][:6]] == [
        "accepted", "accepted", "accepted", "accepted", "rejected",
        "rejected"]
    assert t["delivered"] == j["delivered"]
    assert t["notices"] == j["notices"]
    assert t["describe"] == j["describe"]
    assert t["successor"] == j["successor"]
    assert t["steps"] == j["steps"]
    assert t["journal"] == j["journal"]
    # The session did what it set out to: a failover with replays, a
    # shed delivered (one rank's two slots leave a request queued for
    # bob's burst to shed; two ranks' four hold them all), and every
    # accepted request finished in the end.
    assert t["describe"]["failovers"] >= 1
    assert t["describe"]["replayed"] >= 1
    assert t["describe"]["shed"] == (1 if decode_ranks == 1 else 0)
    assert t["describe"]["dup_dropped"] == 0
    done = {m[3]["rid"] for m in t["delivered"]
            if m[1] == "serve_done"}
    accepted = {v["rid"] for v in t["verdicts"]
                if v.get("status") == "accepted" and "rid" in v}
    assert done == accepted


def test_merge_emission_equal_on_a_seeded_stream():
    rng = random.Random(0)
    for _ in range(2000):
        have = rng.randrange(0, 40)
        base = rng.randrange(0, 20)
        offset = rng.randrange(0, 30)
        toks = [rng.randrange(0, 50) for _ in range(rng.randrange(0, 8))]
        assert t_serving.merge_emission(have, base, offset, toks) == \
            jax_serving.merge_emission(have, base, offset, toks)


def _write_journal(serving, path, rng):
    j = serving.ServeJournal(path)
    streams = {}
    for i in range(6):
        rid = f"r{i}"
        prompt = [rng.randrange(1, 50) for _ in range(rng.randrange(1, 5))]
        j.accept(rid, rng.choice(["a", "b"]), prompt, 8,
                 rng.randrange(0, 3))
        streams[rid] = []
    for _ in range(30):
        rid = rng.choice(sorted(streams))
        s = streams[rid]
        if len(s) >= 8:
            continue
        new = [rng.randrange(0, 50) for _ in range(rng.randrange(1, 3))]
        back = rng.randrange(0, len(s) + 1)
        # Some emissions replay part of what was already written.
        j.emit(rid, len(s) - back, s[len(s) - back:] + new)
        s.extend(new)
    for rid in ("r1", "r4"):
        j.done(rid, "completed")
    j.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("torn", [False, True])
def test_journal_load_and_unfinished_equal(tmp_path, writer, torn):
    path = str(tmp_path / "serve-serve.jsonl")
    _write_journal(SERVING[writer], path, random.Random(7))
    if torn:
        with open(path, "a", encoding="utf-8") as f:
            f.write('{"e": "emit", "rid": "r2", "o": 1, "t": [3')
    states = {p: SERVING[p].ServeJournal.load(path) for p in SERVING}
    assert states["torch"] == states["jax"]
    assert len(states["torch"]) == 6
    plans = {p: SERVING[p].ServeJournal.unfinished(states[p])
             for p in SERVING}
    assert plans["torch"] == plans["jax"]
    assert {p["rid"] for p in plans["torch"]} <= {"r0", "r2", "r3",
                                                  "r5"}


def test_journal_files_written_equal(tmp_path):
    for p in SERVING:
        _write_journal(SERVING[p], str(tmp_path / f"{p}.jsonl"),
                       random.Random(3))
    with open(tmp_path / "jax.jsonl", encoding="utf-8") as f:
        j = f.read()
    with open(tmp_path / "torch.jsonl", encoding="utf-8") as f:
        t = f.read()
    assert t == j
    assert all(json.loads(line) for line in t.splitlines())


def test_export_tenant_journal_and_paths_equal(tmp_path):
    run = str(tmp_path)
    _write_journal(jax_serving, jax_serving.journal_path(run, "serve"),
                   random.Random(11))
    _write_journal(t_serving, t_serving.migrated_journal_path(run, "x"),
                   random.Random(12))
    for tenant in ("a", "b", "nobody"):
        assert t_serving.export_tenant_journal(run, tenant) == \
            jax_serving.export_tenant_journal(run, tenant)
    assert t_serving.export_tenant_journal(run, "a")
    assert t_serving.export_tenant_journal(run, "nobody") == ""
    assert t_serving.journal_path(run, "s") == \
        jax_serving.journal_path(run, "s")
    assert t_serving.migrated_journal_path(run, "s") == \
        jax_serving.migrated_journal_path(run, "s")
