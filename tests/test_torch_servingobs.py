"""The port's serving observatory (``observability/servingobs.py``) and
perf-regression core (``observability/perfbase.py``) against the JAX
package's.

Part 1 runs every case of ``tests/unit/test_servingobs.py`` on the
port: the JAX file's source compiled with its ``nbdistributed_tpu.``
imports pointed at ``nbdistributed_tpu_torch.``.  Part 2 feeds one
seeded event stream (lifecycles on a hand-advanced clock, per-rank
clock offsets, drops, utilization samples) to both packages'
``ServingObservatory`` and holds every ``complete()`` record,
``summary()``, ``util_summary()``, ``status_block()`` and both
renderers equal.
"""

import random

import jax_unit_cases

import nbdistributed_tpu.observability.servingobs as jax_sobs
import nbdistributed_tpu_torch.observability.servingobs as t_sobs

CASES = jax_unit_cases.load("test_servingobs.py", "torch")
globals().update(jax_unit_cases.cases(CASES))


def _stream(sobs) -> dict:
    """One seeded event stream through ``sobs``; every output."""
    rng = random.Random(5)
    clk = CASES["FakeClock"](1000.0)
    offsets = CASES["FakeOffsets"]({0: 0.0, 1: 0.003, 2: -0.002})
    obs = sobs.ServingObservatory(now=clk, clock=offsets)
    out = {"complete": []}
    for i in range(24):
        rid, rank = f"r{i}", rng.randrange(3)
        obs.begin(rid, rng.choice(["alice", "bob"]), t_submit=clk.t)
        if i % 7 == 6:
            obs.drop(rid)
            continue
        obs.note_admit(rid, t=clk.advance(rng.uniform(0.001, 0.02)))
        obs.note_placed(rid, rank, kv_alloc_s=rng.uniform(0, 0.003),
                        need_blocks=rng.randrange(1, 6),
                        pf_total=rng.randrange(1, 4),
                        t=clk.advance(rng.uniform(0.0, 0.05)))
        for k in range(rng.randrange(1, 5)):
            clk.advance(rng.uniform(0.005, 0.03))
            obs.note_prefill_progress(rid, k + 1, 4)
            obs.note_emission(rid, rank, rng.randrange(1, 4),
                              t_recv=clk.t,
                              t_worker=(clk.t - 0.001
                                        if i % 3 else None),
                              emit_s=rng.uniform(0, 0.001))
            obs.note_decode(rid, rng.uniform(0.001, 0.01))
        clk.advance(rng.uniform(0.0, 0.01))
        out["complete"].append(obs.complete(
            rid, "completed" if i % 5 else "shed", t_finish=clk.t))
        obs.note_util(
            ranks={r: {"placed": rng.randrange(3), "slots": 2,
                       "kv_used": rng.randrange(8),
                       "kv_free": rng.randrange(8),
                       "frag": rng.randrange(8),
                       "pending": rng.randrange(2)}
                   for r in range(3)},
            prefill_toks=rng.randrange(20), decode_toks=rng.randrange(10),
            backlog=rng.randrange(4), tenant="parity-serve",
            t=clk.advance(0.001))
    out["summary"] = obs.summary()
    out["util"] = obs.util_summary()
    out["status"] = obs.status_block(records=8)
    out["table"] = sobs.format_serve_stage_table(out["summary"])
    out["waterfall"] = sobs.format_serve_waterfall(obs.records(5))
    out["runs"] = [sobs.largest_free_run(rng.sample(range(40), k))
                   for k in range(0, 40, 3)]
    return out


def test_event_stream_status_block_equal_to_jax():
    j, t = _stream(jax_sobs), _stream(t_sobs)
    assert t == j
    assert t["status"]["summary"]["count"] == len(
        [r for r in t["complete"] if r is not None]) >= 15
    assert t["status"]["records"] and t["util"]["count"] >= 15
