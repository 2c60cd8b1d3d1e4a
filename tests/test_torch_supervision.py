"""Supervision and diagnosis on a 2-rank gloo cluster, through the port's
magics (``magics.magic.DistributedMagics`` on a stand-in shell, no
IPython singleton): the hang watchdog's stall, dump and interrupt on a
Python loop (the worker survives), ``%dist_status``'s stalled state and
``%dist_doctor``; ``--deadline`` verdicts through the synchronous path
and the async window; a rank-conditional ``dist.all_reduce`` named as
skew and healed; a killed rank's postmortem bundle, ``%dist_postmortem
--last`` and ``%dist_heal --restore`` by hand; ``%dist_supervise on``
healing and restoring values bitwise; the scrape endpoint serving
``/metrics`` while a cell sleeps; ``%dist_guard status`` and ``audit``.

One module-scoped cluster; every wait polls under its own deadline.
The tests run in file order: the heals replace the world the later
tests use.
"""

import contextlib
import io
import json
import os
import socket
import threading
import time
import urllib.request

import pytest

pytestmark = [pytest.mark.integration]

THRESHOLDS = {"NBD_HANG_POLL_S": "0.2", "NBD_HANG_SKEW_S": "2",
              "NBD_HANG_STALL_S": "2", "NBD_HANG_GRACE_S": "2"}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Shell:
    """What the magics use of an IPython shell."""

    def __init__(self):
        self.user_ns = {}
        self.input_transformers_cleanup = []


def _magics():
    from nbdistributed_tpu_torch.magics.magic import DistributedMagics
    return DistributedMagics


def _poll(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(scope="module")
def nb(tmp_path_factory):
    saved = {k: os.environ.get(k)
             for k in (*THRESHOLDS, "NBD_METRICS_PORT", "NBD_RUN_DIR")}
    os.environ.update(THRESHOLDS)
    port = _free_port()
    os.environ["NBD_METRICS_PORT"] = str(port)
    os.environ["NBD_RUN_DIR"] = str(tmp_path_factory.mktemp("run"))
    # This process's flight recorder may still be a ring an earlier
    # module opened elsewhere: the coordinator's ring belongs in this
    # run dir, where the postmortem bundles look for it.
    from nbdistributed_tpu_torch.observability import flightrec
    flightrec.reset_for_tests()
    DM = _magics()
    DM.reset_class_state()
    magics = DM(Shell())

    def run(fn, *args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ret = getattr(magics, fn)(*args)
        return buf.getvalue(), ret

    out, _ = run("dist_init", "-n 2 --backend cpu -t 120")
    try:
        assert "2 workers ready" in out, out
        assert f"📈 scrape endpoint: http://127.0.0.1:{port}/metrics" in out
        assert DM._watchdog is not None     # armed by %dist_init
        yield run, magics, port
    finally:
        DM.shutdown_all()
        DM.reset_class_state()
        flightrec.reset_for_tests()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _cell(run, code, line=""):
    out, _ = run("distributed", line, code)
    return out


def _pull(run, magics, name):
    run("dist_pull", f"{name} --all --as _pulled")
    return magics.shell.user_ns.pop("_pulled")


def _verdict_kinds():
    wd = _magics()._watchdog
    return [e["kind"] for e in wd.status()["events"]
            if e["event"] == "verdict"]


def test_watchdog_is_armed_with_the_env_policy(nb):
    run, _, _ = nb
    out, _ = run("dist_watchdog", "status")
    assert out.startswith("🐕 hang watchdog: skew 2s · stall 2s · poll "
                          "0.2s · ladder warn→dump (grace 2s)"), out
    out, _ = run("dist_watchdog", "--stall 5")
    assert "policy flags require the 'on' subcommand" in out


def test_python_loop_is_stalled_dumped_and_interrupted(nb):
    """Stall → warn → dump (a stack file naming the loop) → interrupt:
    the cell comes back as a KeyboardInterrupt error and the worker
    survives.  ``%dist_status`` shows the ranks stalled, and
    ``%dist_doctor`` renders, while the cell is still running."""
    run, magics, _ = nb
    DM = _magics()
    out, _ = run("dist_watchdog",
                 "on --escalate warn,dump,interrupt --grace 2")
    assert "ladder warn→dump→interrupt" in out
    flagged0 = DM._watchdog.cells_flagged
    box = {}
    th = threading.Thread(target=lambda: box.update(out=_cell(
        run, "spin = 0\nwhile True:\n    spin += 1  # the hung loop\n")))
    th.start()
    try:
        _poll(lambda: DM._watchdog.cells_flagged > flagged0
              and any(v["ranks"] == [0, 1]
                      for v in DM._watchdog.last_verdicts),
              "a stall verdict on both ranks")
        status, _ = run("dist_status", "")
        doctor, _ = run("dist_doctor", "--no-stacks")
    finally:
        th.join(60)
    assert not th.is_alive()
    assert status.count("⚠ stalled") == 2, status
    assert "⚠ HUNG [stall]" in status
    assert "stuck-cell doctor" in doctor and "HUNG [stall]" in doctor
    assert "execute" in doctor and "last flight events:" in doctor
    out = box["out"]
    assert "KeyboardInterrupt" in out and "hang watchdog [STALL]" in out
    assert DM._watchdog.escalations.get("interrupt", 0) >= 1
    run_dir = os.environ["NBD_RUN_DIR"]
    stacks = [n for n in os.listdir(run_dir) if n.startswith("stacks-rank0")]
    text = "".join(open(os.path.join(run_dir, n)).read() for n in stacks)
    assert "line 3" in text and "<rank 0>" in text, text[-2000:]
    out = _cell(run, "'alive-' + str(rank)")
    assert "alive-0" in out and "alive-1" in out


def test_deadline_through_the_sync_path_and_the_window(nb):
    run, _, _ = nb
    run("dist_watchdog", "on --escalate warn")
    before = _verdict_kinds().count("deadline")
    out = _cell(run, "import time\ntime.sleep(3.5)\ndl_sync = rank",
                "--deadline 1")
    assert "hang watchdog [DEADLINE]" in out, out
    assert "past the cell's --deadline 1s budget" in out
    assert _verdict_kinds().count("deadline") == before + 1
    out, fut = run("distributed", "--async --deadline 1",
                   "time.sleep(3.5)\ndl_async = rank")
    assert fut is not None, out
    out, _ = run("dist_wait", "")
    assert "✅ drained 1 cell(s)" in out
    _poll(lambda: _verdict_kinds().count("deadline") == before + 2,
          "the async cell's deadline verdict", timeout=10)
    out = _cell(run, "dl_sync, dl_async")
    assert "(0, 0)" in out and "(1, 1)" in out


def test_rank_conditional_collective_is_skew_and_healed(nb):
    """``if rank != 1: dist.all_reduce(t)``: the seeded ``dist``'s
    collective puts rank 0 inside all_reduce #N while rank 1 finished
    the cell: a skew verdict naming both, then the heal rung rebuilds
    the world, which all-reduces again."""
    run, magics, _ = nb
    DM = _magics()
    old_pm = DM._pm
    run("dist_watchdog", "on --escalate warn,dump,heal --grace 1")
    out = _cell(run, "t = torch.ones(1)\nif rank != 1:\n"
                     "    dist.all_reduce(t)\nfloat(t)")
    assert "[rank-conditional-collective]" in out
    _poll(lambda: DM._pm is not old_pm and DM._pm is not None
          and magics._running() and not DM._healing
          and len(DM._pm.alive_ranks()) == 2, "the healed world")
    verdict = next(e for e in DM._watchdog.status()["events"]
                   if e["event"] == "verdict" and e["kind"] == "skew")
    assert verdict["ranks"] == [0]
    assert verdict["detail"].startswith(
        "ranks [1] finished the cell but rank(s) [0] are stuck inside "
        "all_reduce #")
    assert DM._watchdog.escalations.get("heal", 0) >= 1
    _poll(lambda: DM._comm is not None
          and len(DM._comm.connected_ranks()) == 2, "the healed ranks")
    out = _cell(run, "t = torch.ones(1)\ndist.all_reduce(t)\nhealed = "
                     "float(t)")
    assert "❌" not in out, out
    assert _pull(run, magics, "healed") == {0: 2.0, 1: 2.0}
    run("dist_watchdog", "on --escalate warn,dump")


def test_killed_rank_leaves_a_bundle_and_heals_by_hand(nb, tmp_path):
    """No supervisor: the death callback takes the postmortem (its
    manifest names rank 0; the dead ring ends with the dispatch of the
    cell it died on); ``%dist_postmortem --last`` renders it;
    ``%dist_heal --restore`` brings the checkpoint back bitwise."""
    run, magics, _ = nb
    DM = _magics()
    ck = str(tmp_path / "ck")
    _cell(run, "w = torch.arange(6.0) * (rank + 1) + 0.1\n"
               "w_bits = w.view(torch.int32).tolist()")
    want = _pull(run, magics, "w_bits")
    out, _ = run("dist_checkpoint", f"{ck} w")
    assert "✅ 2 ranks saved" in out, out
    out, _ = run("dist_chaos", "on --kill-rank 0 --kill-at 1")
    assert "kill rank 0 at msg 1" in out
    _cell(run, "w += 1000")
    from nbdistributed_tpu_torch.observability import postmortem
    # report.txt is the bundle's last file: the directory shows first.
    bundle = _poll(lambda: [b for b in postmortem.list_bundles()
                            if os.path.exists(os.path.join(b, "report.txt"))],
                   "a postmortem bundle")
    manifest = json.load(open(os.path.join(bundle[-1], "manifest.json")))
    assert manifest["dead_ranks"] == [0]
    ring = json.load(open(os.path.join(bundle[-1], "flight_rank0.json")))
    coord = json.load(open(os.path.join(bundle[-1],
                                        "flight_coordinator.json")))
    last_exec = [e for e in coord["events"]
                 if e["t"] == "send" and e.get("type") == "execute"][-1]
    assert ring["events"][-1]["t"] == "dispatch"
    assert ring["events"][-1]["msg_id"] == last_exec["msg_id"]
    out, _ = run("dist_postmortem", "--last")
    assert out.startswith("nbdistributed_tpu_torch postmortem")
    assert "dead    : ranks [0]" in out and "rank 0 [DEAD]" in out
    out, _ = run("dist_heal", f"--restore {ck}")
    assert "🩹 healing: dead ranks [0]" in out
    assert "✅ 2 ranks restored" in out, out
    _cell(run, "w_bits = w.view(torch.int32).tolist()")
    assert _pull(run, magics, "w_bits") == want
    out, _ = run("dist_heal", "")
    assert "nothing to heal" in out
    assert DM._watchdog is not None


def test_supervisor_heals_a_killed_rank_and_restores_bitwise(nb, tmp_path):
    run, magics, _ = nb
    DM = _magics()
    ck = str(tmp_path / "ck")
    _cell(run, "v = torch.randn(8, generator=torch.Generator()"
               ".manual_seed(rank))\nv_bits = v.view(torch.int32).tolist()")
    want = _pull(run, magics, "v_bits")
    run("dist_checkpoint", f"{ck} v")
    out, _ = run("dist_supervise", "on --max-restarts 2")
    assert "✅ supervising 2 workers: auto-heal ON" in out
    _cell(run, "v.mul_(3)")
    run("dist_chaos", "on --kill-rank 1 --kill-at 1")
    _cell(run, "v.add_(1)")
    sup = DM._supervisor
    _poll(lambda: sup.status()["heals_done"] == 1 and sup.healthy()
          and magics._running() and not DM._healing, "the supervised heal")
    _poll(lambda: DM._comm is not None
          and len(DM._comm.connected_ranks()) == 2, "the healed ranks")
    out = _cell(run, "v_bits = v.view(torch.int32).tolist()")
    assert "❌" not in out, out
    assert _pull(run, magics, "v_bits") == want
    st = sup.status()
    moves = [(e["from"], e["to"]) for e in st["events"] if e["rank"] == 1]
    assert moves == [("alive", "dead"), ("dead", "healing"),
                     ("healing", "alive")]
    assert st["restarts_used"] == 1 and st["last_postmortem"]
    out, _ = run("dist_supervise", "status")
    assert "restarts 1/2 in window · heals 1 ok" in out
    out, _ = run("dist_postmortem", "--last")
    assert "reason  : supervisor: ranks [1] died" in out
    out, _ = run("dist_status", "")
    assert "🛡  supervisor: ●0:alive ●1:alive" in out
    out, _ = run("dist_supervise", "off")
    assert "✅ supervisor stopped" in out and DM._supervisor is None


def test_scrape_endpoint_serves_while_a_cell_sleeps(nb):
    run, _, port = nb
    got = {}

    def scrape():
        # Scrape once the cell is running (the worker's busy ping).
        _poll(lambda: (_magics()._comm.last_ping(0) or (0, {}))[1]
              .get("busy_s") is not None, "the busy cell", timeout=30)
        for path in ("/metrics", "/healthz", "/latency.json"):
            t0 = time.monotonic()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                got[path] = (r.status, r.read().decode())
            got[path + " s"] = time.monotonic() - t0

    th = threading.Thread(target=scrape)
    th.start()
    out = _cell(run, "import time\ntime.sleep(4)\n'slept'")
    th.join(30)
    assert "slept" in out and not th.is_alive()
    assert got["/metrics"][0] == 200
    assert 'nbd_heartbeat_staleness_seconds{rank="0"}' in got["/metrics"][1]
    assert 'nbd_worker_messages_seen{rank="1"}' in got["/metrics"][1]
    health = json.loads(got["/healthz"][1])
    assert health["alive"] == [0, 1] and health["pending"] == 1
    assert json.loads(got["/latency.json"][1])["summary"]["count"] >= 1
    assert all(got[p + " s"] < 5 for p in ("/metrics", "/healthz"))


GUARD_CELL = """\
from nbdistributed_tpu_torch.models import (AdamW, init_params, loss_fn,
                                            param_leaves, tiny_config)
from nbdistributed_tpu_torch.parallel import make_mesh
from nbdistributed_tpu_torch.resilience import trainguard
gcfg = tiny_config(dtype=torch.float32)
gparams = init_params(gcfg, 0, device="cpu")
gopt = AdamW(param_leaves(gparams), lr=1e-3)
guard = trainguard.guard_ddp(lambda p, b: loss_fn(p, b, gcfg), gopt,
                             make_mesh({"dp": world_size}), gparams,
                             audit_every=0)
gbatch = {"tokens": torch.randint(0, gcfg.vocab_size, (2, 16),
                                  generator=torch.Generator()
                                  .manual_seed(3 + rank))}
glosses = [float(guard.step(gbatch)) for _ in range(2)]
"""


def test_dist_guard_status_and_audit(nb):
    run, _, _ = nb
    out = _cell(run, GUARD_CELL)
    assert "❌" not in out, out
    out, _ = run("dist_guard", "status")
    for r in (0, 1):
        assert f"🔹 rank {r}: step 2 · skips 0" in out, out
    out, _ = run("dist_guard", "audit")
    assert "✅ audit fanned out to every rank" in out
    for r in (0, 1):
        assert f"🔹 rank {r}: step 2 · skips 0 (streak 0/" in out
        assert "audits 1 (last @2: ok)" in out, out
    out, _ = run("dist_guard", "off")
    assert "✅ guard off" in out
    out, _ = run("dist_guard", "on")
    assert "✅ guard on" in out


def test_teardown_fails_the_cell_waiting_on_it(nb):
    """A heal or ``%dist_shutdown`` under a cell that is still waiting
    (its ranks hung, so no reply will come) fails the cell at once: the
    coordinator's shutdown aborts every pending request.  Last in the
    file: it tears the cluster down."""
    run, magics, _ = nb
    DM = _magics()
    box = {}
    th = threading.Thread(target=lambda: box.update(out=_cell(
        run, "import time\ntime.sleep(60)")))
    t0 = time.monotonic()
    th.start()
    _poll(lambda: DM._comm.pending_snapshot(), "the pending cell")
    DM.shutdown_all()
    th.join(30)
    assert not th.is_alive() and time.monotonic() - t0 < 30
    assert "aborted: the coordinator shut down while it was pending" \
        in box["out"], box
