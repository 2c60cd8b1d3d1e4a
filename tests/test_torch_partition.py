"""The port's ``resilience/partition.py`` (a stdlib copy) against the JAX
package's: the same ``PartitionSentry`` transitions for the same event
sequences, the same describe lines, the same link-suffix rendering, and
the same flight records and counter."""

import pytest

from nbdistributed_tpu.resilience import partition as jax_part
from nbdistributed_tpu_torch.observability import flightrec
from nbdistributed_tpu_torch.observability import metrics
from nbdistributed_tpu_torch.resilience import partition

HOSTS = {0: "local", 1: "hostB", 2: "hostB", 3: "hostC"}

# (silent, dead, fresh, now) snapshots.
SEQUENCES = {
    "whole_host_silence": [({1}, set(), {0, 2, 3}, 1.0),
                           ({1, 2}, set(), {0, 3}, 2.0),
                           ({1, 2}, set(), {0, 3}, 3.0)],
    "no_fresh_witness": [({1, 2, 3}, set(), set(), 1.0)],
    "heals_on_any_rank": [({1, 2}, set(), {0, 3}, 1.0),
                          ({2}, set(), {0, 1, 3}, 2.0)],
    "grace_expiry_then_late_return": [({1, 2}, set(), {0, 3}, 1.0),
                                      ({1, 2}, set(), {0, 3}, 9.0),
                                      ({1, 2}, set(), {0, 3}, 12.0),
                                      (set(), set(), {0, 1, 2, 3}, 13.0)],
    "death_counts_as_gone": [({1}, {2}, {0, 3}, 1.0)],
    "local_host_exempt": [({0}, set(), {1, 2, 3}, 1.0)],
    "two_hosts_flap": [({1, 2, 3}, set(), {0}, 1.0),
                       ({3}, set(), {0, 1, 2}, 2.0),
                       ({1, 2}, set(), {0, 3}, 3.0),
                       ({1, 2}, set(), {0, 3}, 20.0),
                       ({1, 2, 3}, set(), {0}, 21.0)],
}


def _run(mod, seq):
    s = mod.PartitionSentry(HOSTS, local_host="local", grace_s=10.0,
                            source="test", clock=lambda: 30.0)
    trace = []
    for silent, dead, fresh, now in seq:
        trace.append((s.observe(silent, dead, fresh, now=now),
                      sorted(s.suspected_ranks()), s.expired_hosts(),
                      {h: s.state_of(h) for h in ("hostB", "hostC")}))
    return trace, s.describe(), s.active


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_sentry_transitions_equal_jax(name, tmp_path, monkeypatch):
    monkeypatch.setenv("NBD_RUN_DIR", str(tmp_path))
    flightrec.reset_for_tests()
    flightrec.init("coordinator", directory=str(tmp_path))
    counter = metrics.registry().counter(
        "nbd_partition_suspected_total", "", {"source": "test"})
    before = counter.value
    try:
        got, want = _run(partition, SEQUENCES[name]), _run(
            jax_part, SEQUENCES[name])
        assert got == want
        events = [e for step in got[0] for e in step[0]]
        flightrec.recorder().flush()
        ring = flightrec.read_latest(str(tmp_path), "coordinator")
        recorded = [(e["t"], e["host"], e["ranks"]) for e in ring["events"]
                    if e["t"].startswith("partition_")]
        assert recorded == [(f"partition_{e['event']}", e["host"],
                             e["ranks"]) for e in events]
        assert counter.value - before == sum(
            e["event"] == "suspected" for e in events)
    finally:
        flightrec.reset_for_tests()


def test_single_host_world_is_inert():
    for mod in (partition, jax_part):
        single = mod.PartitionSentry({0: "local", 1: "local"},
                                     local_host="local", grace_s=5.0)
        assert not single.active
        assert single.observe({0, 1}, set(), set()) == []
        assert single.describe() == ""


@pytest.mark.parametrize("stats", [
    {"rtt_ms": 2.14, "hb_age_s": 0.31, "retries": 4},
    {"rtt_ms": None, "hb_age_s": None},
    {"hb_age_s": 12.0, "retries": 0}])
def test_link_suffix_equals_jax(stats):
    assert partition.format_link_suffix(stats) == \
        jax_part.format_link_suffix(stats)


def test_grace_knob_equals_jax():
    for env in ({}, {"NBD_PARTITION_GRACE_S": "7.5"},
                {"NBD_PARTITION_GRACE_S": "bad"}):
        assert partition.partition_grace_s(env=env) == \
            jax_part.partition_grace_s(env=env)
