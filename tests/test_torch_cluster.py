"""End-to-end: a 2-rank cluster of the port's workers on the CPU (gloo),
driven over the port's control plane (counterpart of
``tests/integration/test_worker_cluster.py``).

One module-scoped cluster of ``python -m
nbdistributed_tpu_torch.runtime.worker`` processes: cells run on every
rank with last-expression echo and a persistent namespace, the torch
process group and the functional collectives work across processes,
tensors cross ``get_var``/``set_var``, a tiny ``DecodeServer`` serves
the same greedy tokens as in process, the ``checkpoint`` and ``guard``
requests answer (a live guard's ``tg`` rides the pings), an interrupt
aborts a cell and leaves the workers serving, and a death raises
``WorkerDied``.

No test sleeps: every wait polls its condition under its own deadline.
"""

import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbdistributed_tpu_torch.manager import ProcessManager, wait_until_ready
from nbdistributed_tpu_torch.messaging.codec import unflatten_pytree_wire
from nbdistributed_tpu_torch.messaging.coordinator import (
    CommunicationManager, WorkerDied)

pytestmark = [pytest.mark.integration]

WORLD = 2
ATTACH_TIMEOUT = 120     # torch import + gloo rendezvous, ~5 s idle


class Streams:
    """Collects stream_output pushes; :meth:`wait_for` polls them."""

    def __init__(self):
        self.lines: list[tuple[int, str]] = []
        self.cond = threading.Condition()

    def __call__(self, rank, data):
        with self.cond:
            self.lines.append((rank, data.get("text", "")))
            self.cond.notify_all()

    def wait_for(self, text: str, ranks, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self.cond:
            while True:
                seen = {r for r, t in self.lines if text in t}
                if set(ranks) <= seen:
                    return True
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self.cond.wait(left)


@pytest.fixture(scope="module")
def cluster():
    comm = CommunicationManager(num_workers=WORLD, timeout=120)
    streams = Streams()
    comm.set_output_callback(streams)
    pm = ProcessManager()
    pm.add_death_callback(lambda rank, rc: comm.mark_worker_dead(rank))
    try:
        pm.start_workers(WORLD, comm.port, backend="cpu")
        wait_until_ready(comm, pm, ATTACH_TIMEOUT, poll_s=0.5)
    except Exception:
        pm.shutdown()
        comm.shutdown()
        raise
    yield comm, pm, streams
    live = [r for r in range(WORLD) if r not in comm.dead_ranks()]
    if live:
        comm.post(live, "shutdown")
    pm.shutdown()
    comm.shutdown()


def outputs(responses):
    return {r: m.data.get("output", m.data.get("error"))
            for r, m in responses.items()}


def cell_ok(comm, code):
    """Run ``code`` on every rank; errors fail."""
    r = comm.send_to_all("execute", code)
    errs = {k: m.data["error"] for k, m in r.items() if "error" in m.data}
    assert not errs, errs


def pull(comm, name):
    """``name`` from every rank through ``get_var``'s pytree path."""
    out = {}
    for r, m in comm.send_to_all("get_var", name).items():
        assert "pytree" in m.data, m.data
        out[r] = unflatten_pytree_wire(m.data["pytree"], m.bufs)
    return out


def test_execute_echo_and_namespace(cluster):
    comm, _, _ = cluster
    assert outputs(comm.send_to_all("execute", "rank * 10 + 1")) == {
        0: "1", 1: "11"}
    comm.send_to_all("execute", "stash = rank + 100")
    assert outputs(comm.send_to_all("execute", "print('p', rank)\nstash")) \
        == {0: "p 0\n100", 1: "p 1\n101"}


def test_process_group_and_namespace(cluster):
    comm, pm, _ = cluster
    out = outputs(comm.send_to_all(
        "execute", "(dist.get_world_size(), dist.get_backend(), "
                   "dist.get_rank() == rank, world_size, device.type, gpu_id,"
                   " torch.__name__, __rank__)"))
    assert out == {r: f"(2, 'gloo', True, 2, 'cpu', None, 'torch', {r})"
                   for r in range(WORLD)}
    assert pm.dist_port is not None and pm.backend == "cpu"


def test_workers_import_no_jax_and_no_transformers(cluster):
    comm, _, _ = cluster
    out = outputs(comm.send_to_all(
        "execute", "import sys\n('jax' in sys.modules, "
                   "'transformers' in sys.modules, "
                   "'nbdistributed_tpu' in sys.modules)"))
    assert out == {r: "(False, False, False)" for r in range(WORLD)}


def test_functional_collectives(cluster):
    comm, _, _ = cluster
    r = comm.send_to_all("execute", """
x = torch.arange(8, dtype=torch.float32) * (rank + 1)
res = {
    "sum": all_reduce(x), "mean": all_reduce(x, "mean"),
    "max": all_reduce(-x, "max"), "min": all_reduce(x, "min"),
    "int": all_reduce(torch.tensor([rank + 1, 7])),
    "np": all_reduce(np.full(3, rank + 1.0)),
    "gather": all_gather(x), "bcast": broadcast(x, 1),
    "rs": reduce_scatter(x), "rs_max": reduce_scatter(x, "max"),
    "scatter": scatter(torch.stack([x, 10 * x]), 1),
    "gather0": gather(x, 0), "reduce1": reduce(x, 1),
    "x": x,
}
barrier()
""")
    assert all("error" not in m.data for m in r.values()), outputs(r)
    res = pull(comm, "res")
    xs = [torch.arange(8.) * (k + 1) for k in range(WORLD)]
    for k in range(WORLD):
        got = res[k]
        assert torch.equal(got["x"], xs[k])          # the input untouched
        assert torch.equal(got["sum"], xs[0] + xs[1])
        assert torch.equal(got["mean"], (xs[0] + xs[1]) / 2)
        assert torch.equal(got["max"], torch.maximum(-xs[0], -xs[1]))
        assert torch.equal(got["min"], torch.minimum(xs[0], xs[1]))
        assert torch.equal(got["int"], torch.tensor([3, 14]))
        assert torch.equal(got["np"], torch.full((3,), 3.0,
                                                  dtype=torch.float64))
        assert torch.equal(got["gather"], torch.stack(xs))
        assert torch.equal(got["bcast"], xs[1])
        assert torch.equal(got["rs"], (xs[0] + xs[1]).chunk(2)[k])
        assert torch.equal(got["rs_max"], xs[1].chunk(2)[k])
        assert torch.equal(got["scatter"], [xs[1], 10 * xs[1]][k])
        assert torch.equal(got["reduce1"], xs[0] + xs[1]) if k == 1 \
            else got["reduce1"] is None
        assert torch.equal(got["gather0"], torch.stack(xs)) if k == 0 \
            else got["gather0"] is None


def _jax_quantized_sum(summed: np.ndarray, world: int, block: int = 256):
    """The JAX package's blockwise int8 formula on the summed input
    (``nbdistributed_tpu/parallel/collectives.py:322-335``): pad to the
    world's blocks, per-block absmax scale, int8 round trip."""
    flat = jnp.asarray(summed, jnp.float32).reshape(-1)
    pad = (-flat.size) % (world * block)
    blocks = jnp.pad(flat, (0, pad)).reshape(-1, block)
    absmax = jnp.max(jnp.abs(blocks), axis=1, keepdims=True)
    scale = jnp.where(absmax > 0, absmax / 127.0, 1.0)
    q = jnp.clip(jnp.round(blocks / scale), -127, 127).astype(jnp.int8)
    out = (q.astype(jnp.float32) * scale).reshape(-1)
    return np.asarray(out[:flat.size] if pad else out)


def test_all_reduce_quantized_matches_jax_formula(cluster):
    comm, _, _ = cluster
    r = comm.send_to_all("execute", """
g = torch.Generator().manual_seed(100 + rank)
qin = {"v": torch.randn(1000, generator=g) * (rank + 1)}
qin["sum"] = all_reduce_quantized(qin["v"])
qin["mean"] = all_reduce_quantized(qin["v"], "mean")
qin["int"] = all_reduce_quantized(torch.arange(600) * (rank + 1))
""")
    assert all("error" not in m.data for m in r.values()), outputs(r)
    res = pull(comm, "qin")
    summed = res[0]["v"].numpy() + res[1]["v"].numpy()
    want = _jax_quantized_sum(summed, WORLD)
    scale = float(np.abs(want).max())
    for k in range(WORLD):
        np.testing.assert_allclose(res[k]["sum"].numpy(), want, rtol=1e-6,
                                   atol=1e-6 * scale)
        np.testing.assert_allclose(res[k]["mean"].numpy(), want / 2,
                                   rtol=1e-6, atol=1e-6 * scale)
        want_int = np.round(_jax_quantized_sum(np.arange(600) * 3.0,
                                               WORLD)).astype(np.int64)
        np.testing.assert_array_equal(res[k]["int"].numpy(), want_int)
    assert torch.equal(res[0]["sum"], res[1]["sum"])


def test_get_and_set_var_bf16_tensor(cluster):
    comm, _, _ = cluster
    g = torch.Generator().manual_seed(7)
    w = torch.randn(4, 5, generator=g).to(torch.bfloat16)
    r = comm.send_to_all("set_var", {"name": "w"}, bufs={"value": w})
    assert all(m.data == {"status": "set", "name": "w"} for m in r.values())
    comm.send_to_all("execute", "w2 = w * (rank + 1)")
    for rank, m in comm.send_to_all("get_var", "w2").items():
        assert m.data["array"] and m.data["dtype"] == "bfloat16"
        got = m.bufs["value"]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (4, 5)
        assert torch.equal(got, w * (rank + 1))
    assert outputs(comm.send_to_all("execute", "(w.dtype, w.device.type)")) \
        == {r: "(torch.bfloat16, 'cpu')" for r in range(WORLD)}


def test_cell_error_surfaces_per_rank(cluster):
    comm, _, _ = cluster
    r = comm.send_to_all("execute", "if rank == 1:\n    1 / 0\nrank")
    assert r[0].data["output"] == "0"
    assert r[1].data["error"] == "division by zero"
    assert "ZeroDivisionError" in r[1].data["traceback"]
    assert outputs(comm.send_to_all("execute", "'ok'")) == {
        0: "'ok'", 1: "'ok'"}


_SERVER_CELL = """
from nbdistributed_tpu_torch.models import init_params, tiny_config
torch.set_num_threads(1)
cfg = tiny_config(dtype=torch.float32)
params = init_params(cfg, 0, device=device)
srv = DecodeServer(params, cfg, max_batch=2, max_len=64, pad_to=4)
rids = [srv.submit(p, 6) for p in PROMPTS]
srv.run_until_done()
[srv.outputs[r] for r in rids]
"""
PROMPTS = [[5, 9, 2, 44], [1, 2, 3], [100, 7, 7, 7, 7, 8]]


def _in_process_tokens(max_new=6):
    from nbdistributed_tpu_torch.models import (DecodeServer, init_params,
                                                tiny_config)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = tiny_config(dtype=torch.float32)
        srv = DecodeServer(init_params(cfg, 0, device="cpu"), cfg,
                           max_batch=2, max_len=64, pad_to=4)
        rids = [srv.submit(p, max_new) for p in PROMPTS]
        srv.run_until_done()
        return [srv.outputs[r] for r in rids]
    finally:
        torch.set_num_threads(n)


def test_decode_server_cell_matches_in_process(cluster):
    comm, _, _ = cluster
    want = _in_process_tokens()
    out = outputs(comm.send_to_all(
        "execute", f"PROMPTS = {PROMPTS!r}\n" + _SERVER_CELL))
    assert out == {r: repr(want) for r in range(WORLD)}


def test_serve_open_step_close(cluster):
    comm, _, _ = cluster
    want = _in_process_tokens()
    r = comm.send_to_rank(1, "serve_open", {"max_batch": 2, "max_len": 64,
                                            "pad_to": 4})
    assert r.data == {"status": "open", "slots": 2}, r.data
    admit = [{"rid": f"q{i}", "prompt": p, "max_new": 6}
             for i, p in enumerate(PROMPTS)]
    got = {a["rid"]: [] for a in admit}
    finished = set()
    for tick in range(50):
        r = comm.send_to_rank(1, "serve_step", {
            "admit": admit if tick == 0 else [], "steps": 2})
        assert r.data["status"] == "ok" and not r.data["errors"], r.data
        for rid, e in r.data["emitted"].items():
            assert e["o"] == len(got[rid])       # emissions at offsets
            got[rid] += e["t"]
        finished |= set(r.data["finished"])
        if len(finished) == len(admit):
            break
    assert [got[f"q{i}"] for i in range(len(PROMPTS))] == want
    r = comm.send_to_rank(1, "serve_close", {})
    assert r.data == {"status": "ok", "existed": True}


def _poll(comm, kind, data, want, timeout=60):
    """Send ``kind`` until every rank has answered with status ``want``
    once; each rank's first such reply.

    A finished background save answers ``done`` to one status request
    and ``idle`` after that (the poll consumes it), and the ranks may
    finish on different polls: so each rank's first ``done`` is kept,
    and later polls ask only the ranks still pending."""
    deadline = time.monotonic() + timeout
    got = {}
    while True:
        pending = [k for k in range(WORLD) if k not in got]
        r = comm.send_to_ranks(pending, kind, data)
        got.update({k: m for k, m in r.items()
                    if m.data.get("status") == want})
        if len(got) == WORLD:
            return got
        assert time.monotonic() < deadline, {k: m.data for k, m in r.items()}
        threading.Event().wait(0.05)


def test_status_and_refused_handlers(cluster, tmp_path):
    """The status probe, then the ``checkpoint`` and ``guard`` requests
    the worker once refused: a save, a background save polled to done,
    a restore written into the live tensor, and the guard's status and
    audit with no guard live."""
    comm, _, _ = cluster
    st = comm.send_to_rank(0, "get_status").data
    assert st["backend"] == "gloo" and st["world_size"] == WORLD
    assert st["devices"][0]["platform"] == "cpu"
    cell_ok(comm, "ck_t = torch.arange(6.0) + rank; ck_meta = {'r': rank}")
    path, bg = str(tmp_path / "ck"), str(tmp_path / "bg")
    names = ["ck_t", "ck_meta"]
    r = comm.send_to_all("checkpoint", {"action": "save", "path": path,
                                        "names": names})
    assert all(m.data["status"] == "save"
               and m.data["summary"]["ck_t"] == {"leaves": 1, "bytes": 24}
               for m in r.values()), {k: m.data for k, m in r.items()}
    r = comm.send_to_all("checkpoint", {"action": "save", "path": bg,
                                        "names": names, "background": True})
    assert all(m.data["status"] == "started" for m in r.values())
    done = _poll(comm, "checkpoint", {"action": "status"}, "done")
    assert all(m.data["summary"]["ck_meta"]["leaves"] == 1
               for m in done.values())
    r = comm.send_to_all("checkpoint", {"action": "status"})
    assert all(m.data == {"status": "idle"} for m in r.values())
    cell_ok(comm, "ck_live = ck_t; ck_t.mul_(0); ck_meta = None")
    for where in (path, bg):
        r = comm.send_to_all("checkpoint", {"action": "restore",
                                            "path": where})
        assert all(m.data["status"] == "restore" for m in r.values())
    assert outputs(comm.send_to_all(
        "execute", "(ck_t is ck_live, ck_t.tolist(), ck_meta)")) == {
        k: f"(True, {[float(k + i) for i in range(6)]}, {{'r': {k}}})"
        for k in range(WORLD)}
    r = comm.send_to_rank(0, "checkpoint", {"action": "nope", "path": path})
    assert "unknown checkpoint action" in r.data["error"]
    r = comm.send_to_all("guard", {"action": "status"})
    assert all(m.data == {"enabled": True, "active": False}
               for m in r.values())
    r = comm.send_to_all("guard", {"action": "audit"})
    assert all("no live TrainGuard" in m.data["error"] for m in r.values())
    assert outputs(comm.send_to_all("execute", "1 + 1")) == {0: "2", 1: "2"}
    w = torch.zeros(4, 5, dtype=torch.bfloat16)
    comm.send_to_all("set_var", {"name": "w"}, bufs={"value": w})
    info = comm.send_to_rank(0, "get_namespace_info").data["namespace_info"]
    assert info["w"] == {"kind": "array", "shape": [4, 5],
                         "dtype": "bfloat16", "sharding": None,
                         "device": "cpu"}
    assert comm.send_to_all("sync")[1].data == {"status": "synced"}


GUARD_CELL = """
from nbdistributed_tpu_torch.resilience import trainguard as _tg
_gp = {"w": torch.zeros(3)}
def _gstep(p, b):
    p["w"].add_(1.0)
    return torch.tensor(1.0), {"ok": torch.tensor(True),
                               "gnorm": torch.tensor(1.0)}
_g = _tg.TrainGuard(_gstep, _gp, None, audit_every=0, snapshot_every=0)
for _ in range(3):
    _g.step(None)
_g.finish()["step"]
"""


def test_ping_carries_tg_once_a_guard_is_live(cluster):
    """With a TrainGuard live, the heartbeat carries its ``tg`` field;
    the ``guard`` request reports it, audits it over the world, and
    turns the host machinery off and on."""
    comm, _, _ = cluster
    assert outputs(comm.send_to_all("execute", GUARD_CELL)) == {0: "3",
                                                               1: "3"}
    deadline = time.monotonic() + 30
    while True:
        pings = [comm.last_ping(r) for r in range(WORLD)]
        if all(p is not None and "tg" in (p[1] or {}) for p in pings):
            break
        assert time.monotonic() < deadline, pings
        threading.Event().wait(0.1)
    assert all(p[1]["tg"] == {"sk": 0, "as": None, "v": "none", "rb": 0,
                              "rp": 0} for p in pings)
    r = comm.send_to_all("guard", {"action": "audit"})
    assert all(m.data["status"] == "audited" and m.data["ok"]
               and m.data["active"] and m.data["step"] == 3
               for m in r.values()), {k: m.data for k, m in r.items()}
    r = comm.send_to_all("guard", {"action": "off"})
    assert all(m.data["status"] == "off" and not m.data["enabled"]
               for m in r.values())
    r = comm.send_to_all("guard", {"action": "on"})
    assert all(m.data["enabled"] for m in r.values())
    cell_ok(comm, "_tg.reset_for_tests()")


def test_heartbeat_and_telemetry_arrive(cluster):
    """Pings reach the coordinator off the serial loop, with the
    telemetry sample (a CPU worker reports no device memory)."""
    comm, _, _ = cluster
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        tel = [comm.last_telemetry(r) for r in range(WORLD)]
        if all(t is not None for t in tel):
            break
        threading.Event().wait(0.1)
    assert all(t is not None and t["compiles"] == 0 and "hbm" not in t
               for t in tel), tel
    assert all(comm.last_ping(r) is not None for r in range(WORLD))


def test_profile_trace_metrics_and_chaos(cluster, tmp_path):
    comm, _, _ = cluster
    r = comm.send_to_all("profile", {"action": "start",
                                     "log_dir": str(tmp_path)})
    assert all(m.data["status"] == "profiling" for m in r.values())
    again = comm.send_to_rank(0, "profile", {"action": "start"}).data
    assert "already running" in again["error"]
    comm.send_to_all("execute", "torch.ones(8, 8) @ torch.ones(8, 8)")
    r = comm.send_to_all("profile", {"action": "stop"})
    for rank, m in r.items():
        assert m.data["status"] == "stopped"
        assert m.data["trace"] == str(tmp_path / f"rank{rank}" /
                                      "trace.json")
        assert (tmp_path / f"rank{rank}" / "trace.json").stat().st_size
        with open(tmp_path / f"rank{rank}" / "trace.json") as f:
            events = json.load(f)["traceEvents"]
        # The program's span around the executed cell rides the
        # profiler's own trace.
        assert any(e.get("name") == "cell"
                   and e.get("cat") == "user_annotation" for e in events)
    stop = comm.send_to_rank(0, "profile", {"action": "stop"}).data
    assert stop["error"] == "no profiler trace is running"

    r = comm.send_to_all("trace", {"action": "start"})
    comm.send_to_all("execute", "all_reduce(torch.ones(2))")
    dump = comm.send_to_rank(1, "trace", {"action": "dump"}).data
    names = {sp["name"] for sp in dump["trace"]["spans"]}
    assert {"handle/execute", "cell", "collective/all_reduce"} <= names
    comm.send_to_all("trace", {"action": "stop"})

    m = comm.send_to_rank(0, "metrics", {}).data["metrics"]
    assert m["counters"].get('nbd_collectives_total{op="all_reduce"}', 0) \
        >= 1, m["counters"]
    r = comm.send_to_rank(0, "chaos", {"action": "status"}).data
    assert r["status"] == "off" and r["dedup_hits"] == 0


def test_interrupt_aborts_cell_and_workers_survive(cluster):
    comm, pm, streams = cluster
    result = {}

    def _send():
        result.update(comm.send_to_all("execute", """
import time
print("spinning", flush=True)
t0 = time.monotonic()
while time.monotonic() - t0 < 120:
    _ = torch.ones(64, 64) @ torch.ones(64, 64)
"""))

    t = threading.Thread(target=_send, daemon=True)
    t.start()
    assert streams.wait_for("spinning", range(WORLD), timeout=60)
    assert pm.interrupt() == [0, 1]
    t.join(timeout=60)
    assert not t.is_alive(), "the interrupt did not abort the cell"
    for m in result.values():
        assert "KeyboardInterrupt" in m.data["error"]
    assert outputs(comm.send_to_all("execute", "'still here'")) == {
        0: "'still here'", 1: "'still here'"}


def test_death_raises_worker_died(cluster):
    """Last in the module: rank 1 exits mid-cell."""
    comm, pm, _ = cluster
    with pytest.raises(WorkerDied):
        comm.send_to_all("execute", "import os\nif rank == 1:\n"
                                    "    os._exit(3)\nrank")
    deadline = time.monotonic() + 30
    while pm.alive_ranks() != [0] and time.monotonic() < deadline:
        threading.Event().wait(0.05)
    assert pm.alive_ranks() == [0]
    assert 1 in comm.dead_ranks()
