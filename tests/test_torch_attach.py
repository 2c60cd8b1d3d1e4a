"""Durable sessions of the port on the CPU: a notebook kernel that dies
leaves its fleet orphaned, and ``%dist_attach`` (or ``%dist_init
--attach``) in a fresh kernel adopts it — the cases of the JAX
package's ``tests/integration/test_attach_reattach.py``.

A sacrificial kernel (a child Python process driving the port's magics
on a stand-in shell) brings up 2 gloo ranks, seeds ``x = 42`` and
``hits = 0``, starts a cell that bumps ``hits`` and sleeps, and is
SIGKILLed mid-cell.  This process then reattaches through the magics
and holds: the epoch bump, the namespaces intact, the interrupted
cell's result delivered exactly once (``hits`` is 1, a second drain
finds nothing), a stale coordinator's frames rejected without running,
and ``%dist_status``'s attached header.  A second fleet with a short
``NBD_ORPHAN_TTL_S`` is orphaned and never reattached: each rank exits
0 at TTL expiry, with the orphan lifecycle in its flight ring.

Each wait has its own deadline, generous enough for a loaded host.
"""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import time

import pytest

pytestmark = [pytest.mark.integration]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KERNEL = r'''
import json, os, sys, threading, time
sys.path.insert(0, sys.argv[2])
from nbdistributed_tpu_torch.magics.magic import DistributedMagics

class Shell:
    def __init__(self):
        self.user_ns = {}
        self.input_transformers_cleanup = []

run_dir = sys.argv[1]
m = DistributedMagics(Shell())
m.dist_init("-n 2 --backend cpu -t 120")
m.distributed("", "x = 42\nhits = 0")
comm = DistributedMagics._comm
mid = comm.post([0, 1], "execute", {
    "code": "hits += 1\nimport time\ntime.sleep(3.0)\nhits",
    "target_ranks": [0, 1]})
with open(os.path.join(run_dir, "kernel.json.tmp"), "w") as f:
    json.dump({"mid": mid, "token": comm.session_token}, f)
os.replace(os.path.join(run_dir, "kernel.json.tmp"),
           os.path.join(run_dir, "kernel.json"))
time.sleep(600)         # SIGKILLed here
'''


def _poll(cond, what, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


class Shell:
    def __init__(self):
        self.user_ns = {}
        self.input_transformers_cleanup = []


@pytest.fixture
def magics(monkeypatch, tmp_path):
    from nbdistributed_tpu_torch.magics.magic import DistributedMagics
    from nbdistributed_tpu_torch.observability import flightrec
    run_dir = str(tmp_path / "run")
    os.makedirs(run_dir)
    monkeypatch.setenv("NBD_RUN_DIR", run_dir)
    monkeypatch.setenv("NBD_ORPHAN_TTL_S", "180")
    flightrec.reset_for_tests()
    DistributedMagics.reset_class_state()
    m = DistributedMagics(Shell())

    def run(fn, *args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            getattr(m, fn)(*args)
        return buf.getvalue()

    kernel = None

    def crash_a_kernel():
        nonlocal kernel
        kernel = subprocess.Popen(
            [sys.executable, "-c", KERNEL, run_dir, ROOT],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        path = os.path.join(run_dir, "kernel.json")

        def ready():
            assert kernel.poll() is None, kernel.stdout.read().decode()
            return os.path.exists(path)
        _poll(ready, "the sacrificial kernel's fleet", 180)
        info = json.load(open(path))
        time.sleep(0.5)              # the cell is now mid-flight
        os.kill(kernel.pid, signal.SIGKILL)
        kernel.wait(30)
        return info

    try:
        yield run, crash_a_kernel, run_dir
    finally:
        if kernel is not None and kernel.poll() is None:
            kernel.kill()
        DistributedMagics.shutdown_all()
        from nbdistributed_tpu_torch.resilience import session
        for pid in ((session.read_manifest(run_dir) or {}).get("pids")
                    or {}).values():
            try:
                os.kill(int(pid), signal.SIGKILL)
            except (OSError, ValueError):
                pass
        DistributedMagics.reset_class_state()
        flightrec.reset_for_tests()


def _outputs(res):
    return {r: m.data.get("output") for r, m in res.items()}


def test_reattach_redelivers_exactly_once_and_fences(magics):
    run, crash_a_kernel, run_dir = magics
    from nbdistributed_tpu_torch.magics.magic import DistributedMagics
    info = crash_a_kernel()
    out = run("dist_attach", run_dir)
    assert (f"🔗 reattached to 2 workers (epoch 2, run {run_dir}"
            in out), out
    assert "namespaces intact" in out
    # The interrupted cell's result, once per rank, exactly once.
    mid = info["mid"][:8]
    for r in (0, 1):
        assert (f"📬 rank {r} · interrupted cell {mid}… finished while "
                "orphaned: 1") in out, out
    comm = DistributedMagics._comm
    assert comm.session_epoch == 2
    assert comm.session_token == info["token"]
    from nbdistributed_tpu_torch.resilience import session
    again = session.drain_mailboxes(comm)
    assert all(not d for d in again.values()), again
    assert _outputs(comm.send_to_all("execute", "(x, hits)")) == {
        0: "(42, 1)", 1: "(42, 1)"}
    # A stale coordinator's frames are rejected, not run.
    comm.session_epoch = 1
    try:
        resp = comm.send_to_all("execute", "x = 'clobbered'")
    finally:
        comm.session_epoch = 2
    for m in resp.values():
        assert m.data.get("stale_epoch") is True
        assert "stale coordinator epoch 1" in m.data["error"]
    assert _outputs(comm.send_to_all("execute", "x")) == {0: "42", 1: "42"}
    out = run("dist_status", "")
    assert f"🔑 session: run {run_dir}" in out
    assert "epoch 2 · attached (orphan TTL 180s)" in out, out
    # Auto-distributed cells run on the adopted fleet again.
    out = run("distributed", "", "y = x + rank\ny")
    assert "❌" not in out
    assert _outputs(comm.send_to_all("execute", "y")) == {0: "42", 1: "43"}
    assert session.read_manifest(run_dir)["epoch"] == 2
    out = run("dist_shutdown", "")
    assert "✅ shut down 2 workers" in out
    assert session.read_manifest(run_dir) is None


def test_dist_init_attach_is_the_same_path(magics):
    run, crash_a_kernel, run_dir = magics
    from nbdistributed_tpu_torch.magics.magic import DistributedMagics
    crash_a_kernel()
    out = run("dist_init", f"--attach {run_dir}")
    assert "🔗 reattached to 2 workers (epoch 2" in out, out
    assert out.count("finished while orphaned: 1") == 2, out
    # The adopted session replays its own init at a heal.
    assert DistributedMagics._last_init_line == "-n 2 --backend cpu -t 120"
    out = run("dist_attach", run_dir)
    assert "⚠️ already attached (2 workers)" in out


def test_attach_without_a_session_fails_and_spawns_nothing(magics):
    run, _, run_dir = magics
    from nbdistributed_tpu_torch.magics.magic import DistributedMagics
    out = run("dist_attach", run_dir)
    assert out.startswith("❌ attach failed: no session manifest in"), out
    assert DistributedMagics._comm is None


def test_orphan_ttl_expiry_self_terminates(tmp_path, monkeypatch):
    from nbdistributed_tpu_torch.manager import (ProcessManager,
                                                 wait_until_ready)
    from nbdistributed_tpu_torch.messaging import CommunicationManager
    from nbdistributed_tpu_torch.observability import flightrec
    run_dir = str(tmp_path / "run")
    monkeypatch.setenv("NBD_RUN_DIR", run_dir)
    flightrec.reset_for_tests()
    comm = CommunicationManager(num_workers=2, timeout=120)
    pm = ProcessManager()
    pm.add_death_callback(lambda r, rc: comm.mark_worker_dead(r))
    try:
        pm.start_workers(2, comm.port, backend="cpu",
                         extra_env={"NBD_ORPHAN_TTL_S": "2"})
        wait_until_ready(comm, pm, 180)
        assert _outputs(comm.send_to_all("execute", "1 + 1")) == {
            0: "2", 1: "2"}
        # The coordinator "dies": its listener closes, nothing
        # reattaches, and no shutdown reaches the workers.
        pm.quiesce()
        comm.shutdown()
        _poll(lambda: all(p.poll() is not None
                          for p in pm.processes.values()),
              "the orphans' exit at TTL expiry", 120)
        assert {r: p.poll() for r, p in pm.processes.items()} == {
            0: 0, 1: 0}
        for r in (0, 1):
            ring = _poll(lambda: flightrec.read_latest(run_dir,
                                                       f"rank{r}"),
                         f"rank {r}'s flight ring", 30)
            kinds = [e.get("t") for e in ring["events"]]
            assert "orphan_entered" in kinds and "orphan_expired" in kinds
            assert "worker_shutdown" in kinds
            assert "orphan_reattached" not in kinds
    finally:
        pm.shutdown()
        flightrec.reset_for_tests()
