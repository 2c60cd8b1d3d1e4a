"""Multi-rank continuous batching and block-bounded admission of the
port's ``ServingManager`` against the JAX package's.

Part 1 runs every case of ``tests/unit/test_serving_fast_driver.py``
and the gateway-side block-accounting cases of
``tests/unit/test_paged_blocks.py`` (``BlockAllocator``, the
allocator the gateway keeps one of per decode rank) on the port: each
JAX file's source compiled with its ``nbdistributed_tpu.`` imports
pointed at ``nbdistributed_tpu_torch.``.

Part 2 drives both packages' managers over their own copies of the
JAX file's fake comm, ticks by hand, three decode ranks with small
block pools, a burst that outgrows them and a decode rank lost
mid-stream: every placement (which request on which rank, which
admissions and releases each tick carried), every per-rank block
count and every defer must be the same.
"""

import jax_unit_cases
import pytest

import nbdistributed_tpu.gateway.serving as jax_serving
import nbdistributed_tpu_torch.gateway.serving as t_serving

# The allocator cases of test_paged_blocks.py (the rest of that file is
# the load generator's: tests/test_torch_loadgen.py runs those).
PAGED_BLOCK_CASES = (
    "test_blocks_needed_ceil", "test_alloc_free_reuse_deterministic",
    "test_alloc_all_or_nothing_and_double_admission",
    "test_block_table_growth", "test_can_fit_matches_alloc_verdict",
    "test_defrag_compacts_and_conserves", "test_defrag_noop_when_dense",
    "test_reset_returns_everything", "test_snapshot_shape",
    "test_ctor_validation")


DRIVER = {p: jax_unit_cases.load("test_serving_fast_driver.py", p)
          for p in ("jax", "torch")}
SERVING = {"jax": jax_serving, "torch": t_serving}

globals().update(jax_unit_cases.cases(DRIVER["torch"]))
globals().update(jax_unit_cases.cases(
    jax_unit_cases.load("test_paged_blocks.py", "torch"),
    PAGED_BLOCK_CASES, suffix="_gateway"))


def _tick(mgr, serving):
    try:
        mgr._tick()
    except serving._RankLost as e:
        mgr._on_rank_lost(e.rank)


def _placements(pkg: str, run_dir: str, kv_blocks: int) -> dict:
    cases, serving = DRIVER[pkg], SERVING[pkg]
    comm = cases["FakeComm"](num_workers=3, per_tick=1)
    events = []

    class Flight:
        def record(self, event, **kw):
            events.append((event, kw))

    mgr = serving.ServingManager(
        comm, run_dir, world_size=3, max_batch=3, max_len=48, steps=1,
        step_timeout=5.0, queue_depth=16, inflight=16, decode_ranks=0,
        kv_block_tokens=4, kv_blocks=kv_blocks, flight=Flight())
    verdicts = [mgr.submit(f"t{i % 3}", [i + 1] * (2 + i % 5),
                           3 + (i * 7) % 9, priority=i % 2)
                for i in range(12)]
    ranks_by_tick = []
    for k in range(40):
        if k == 4:
            comm.kill(1)
            listed = comm.dead_ranks
            comm.dead_ranks = lambda: set()
            _tick(mgr, serving)
            comm.dead_ranks = listed
        _tick(mgr, serving)
        d = mgr.describe()
        ranks_by_tick.append((d["ranks"], d["kv"]["used"],
                              d["kv"]["free"], d["pending"],
                              d["decoding"]))
    d = mgr.describe()
    results = {v["rid"]: mgr.result(v["rid"]) for v in verdicts
               if v.get("rid")}
    mgr.stop(close_workers=False)
    keep = ("serve_place", "serve_defer", "serve_failover",
            "serve_open", "serve_rank_retired")
    return {"verdicts": verdicts, "steps": comm.steps_seen,
            "ranks": ranks_by_tick, "results": results,
            "events": [e for e in events if e[0] in keep],
            "counters": {k: d[k] for k in (
                "accepted", "completed", "failovers", "replayed",
                "dup_dropped", "tokens_total")}}


@pytest.mark.parametrize("kv_blocks", [6, 12])
def test_multi_rank_placement_and_blocks_equal_to_jax(tmp_path,
                                                      kv_blocks):
    got = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        got[pkg] = _placements(pkg, str(d), kv_blocks)
    assert got["torch"] == got["jax"]
    t = got["torch"]
    # Every rank took requests, some waited for blocks, a rank was
    # lost and its requests replayed, and all of them completed.
    placed_on = {e[1]["rank"] for e in t["events"]
                 if e[0] == "serve_place"}
    assert placed_on == {0, 1, 2}
    assert t["counters"]["failovers"] >= 1
    assert t["counters"]["replayed"] >= 1
    assert t["counters"]["dup_dropped"] == 0
    assert t["counters"]["completed"] == 12
    if kv_blocks == 6:
        assert any(e[0] == "serve_defer" for e in t["events"])
