"""The port's gateway tenant plane end to end on the CPU: one pool of 2
gloo ranks, started by ``%dist_pool start`` (the daemon is a
subprocess, as in a notebook) and shared by every test here, in file
order.  Tenant ``alice`` is this process's kernel, driving the magics on
a stand-in shell (``%dist_attach --tenant``, ``%%distributed
--priority``, ``%dist_status``, ``%dist_pool``); the other tenants are
raw ``TenantClient`` connections.  What is held, as in the JAX
package's ``test_gateway_tenants.py``, ``test_gateway_effects.py`` and
the non-serving cases of ``test_elastic_chaos.py``: isolated
namespaces and the opt-in ``shared`` dict; admission (the headcount,
the in-flight cap, queue positions, a shed lowest-priority cell with
its visible verdict); a tenant kernel's crash parking its result and a
reattach draining it exactly once; the stale-epoch fence; a
``tiny_config`` training cell whose losses are bitwise the in-process
step's; a resize 2 → 3 → 2 with an all-reduce queued across each flip
and refused as stale, and a template replayed on each new fleet; the
one-GPU-a-rank refusal; ``%dist_serve`` and ``%dist_pool migrate``
through the magics; ``%dist_gc`` keeping the live pool; and
``%dist_pool stop`` leaving no process behind.

Every wait polls under its own deadline.
"""

import contextlib
import io
import os
import signal
import threading
import time
import types

import pytest

pytestmark = [pytest.mark.integration]

TRAIN_SETUP = """\
import torch
torch.set_num_threads(1)
from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                            make_train_step, param_leaves,
                                            tiny_config)
cfg = tiny_config(dtype=torch.float32)
gen = torch.Generator().manual_seed(7 + rank)
batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                 generator=gen)}
params = init_params(cfg, 0, device="cpu")
step = make_train_step(cfg, AdamW(param_leaves(params), lr=1e-3))
"""


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


def _outputs(data):
    return {r: (d or {}).get("output")
            for r, d in (data.get("results") or {}).items()}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    from nbdistributed_tpu_torch.gateway import daemon as gw
    root = tmp_path_factory.mktemp("pools")
    run_dir = str(root / "pool")
    DM = _magics()
    DM.reset_class_state()
    magics = DM(Shell())

    def run(fn, *args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ret = getattr(magics, fn)(*args)
        return buf.getvalue(), ret

    out, _ = run("dist_pool", f"start -n 2 --backend cpu --mesh-slots 1 "
                 f"--queue-depth 2 --tenant-inflight 2 --max-tenants 4 "
                 f"--run-dir {run_dir}")
    manifest = gw.read_gateway_manifest(run_dir)
    clients = []

    def attach(name, **kw):
        from nbdistributed_tpu_torch.gateway.client import TenantClient
        m = gw.read_gateway_manifest(run_dir)
        c = TenantClient(m["tenant_plane"]["host"],
                         m["tenant_plane"]["port"], name,
                         pool_token=m["pool_token"], **kw)
        clients.append(c)
        return c

    try:
        assert "✅ pool up" in out and manifest is not None, out
        yield types.SimpleNamespace(run=run, magics=magics,
                                    run_dir=run_dir, attach=attach,
                                    clients=clients, start_out=out,
                                    root=str(root))
    finally:
        for c in clients:
            try:
                c.close()
            except Exception:
                pass
        m = gw.read_gateway_manifest(run_dir)
        if m is not None and gw.gateway_alive(m):
            from nbdistributed_tpu_torch.gateway.client import \
                pool_shutdown
            pool_shutdown("127.0.0.1", m["tenant_plane"]["port"],
                          m["pool_token"])
            _poll(lambda: not gw.gateway_alive(
                gw.read_gateway_manifest(run_dir)), "the pool's stop")
        DM.reset_class_state()


def test_pool_starts_and_alice_attaches_through_the_magics(pool):
    assert f"run dir {pool.run_dir}" in pool.start_out
    assert f"%dist_attach --tenant NAME {pool.run_dir}" in pool.start_out
    out, _ = pool.run("dist_attach", f"--tenant alice {pool.run_dir}")
    assert (f"🤝 attached to pool {pool.run_dir} as tenant 'alice' "
            "(epoch 1, 2 ranks, sched fair") in out, out
    out, _ = pool.run("dist_pool", "status")
    assert (f"🏊 pool {pool.run_dir} · pid " in out
            and "2 ranks · epoch 1 · gen 1 · sched fair (slots 1, "
            "queue 0/2" in out), out
    assert "alice*" in out and "attached" in out


def test_two_tenants_have_isolated_namespaces(pool):
    run = pool.run
    bob = pool.attach("bob")
    assert bob.world_size == 2
    _, res = run("distributed", "", "x = 'one'")
    assert set(res) == {"0", "1"}
    assert bob.execute("x = 'two'")["status"] == "ok"
    _, res = run("distributed", "", "x += '!'\nx")
    assert {r: d["output"] for r, d in res.items()} == {
        "0": "'one!'", "1": "'one!'"}
    assert _outputs(bob.execute("x")) == {"0": "'two'", "1": "'two'"}
    bob.execute("del x")
    assert _outputs(bob.execute("'x' in dir()")) == {"0": "False",
                                                     "1": "False"}
    _, res = run("distributed", "", "x")
    assert res["0"]["output"] == "'one!'"
    run("distributed", "", "shared['weights'] = 123")
    assert _outputs(bob.execute("shared['weights']")) == {"0": "123",
                                                          "1": "123"}
    assert _outputs(bob.execute("tenant")) == {"0": "'bob'",
                                               "1": "'bob'"}


def test_pool_status_shows_both_tenants_and_the_busy_rank(pool):
    bob = pool.attach("bob2")
    th = threading.Thread(target=lambda: bob.execute(
        "import time\ntime.sleep(4)"))
    th.start()
    try:
        def busy():
            out, _ = pool.run("dist_pool", "status")
            return out if "rank 0: ⚙ execute" in out \
                and "tenant bob2" in out else None
        out = _poll(busy, "rank 0 busy for tenant bob2", 20.0)
        assert "alice*" in out and "bob2" in out
    finally:
        th.join(30)
    bob.close(detach=True)


def test_admission_queue_shed_and_caps(pool):
    run, attach = pool.run, pool.attach
    from nbdistributed_tpu_torch.gateway.client import CellSubmitError
    # The headcount: alice, bob, and two more fill max_tenants=4
    # (bob2 detached cleanly and was evicted).
    _poll(lambda: "bob2" not in run("dist_pool", "status")[0],
          "bob2's eviction")
    carol = attach("carol")
    dave = attach("dave")
    with pytest.raises(RuntimeError, match="max_tenants=4"):
        attach("erin")
    bob = next(c for c in pool.clients if c.name == "bob")
    holder = threading.Thread(target=lambda: bob.execute(
        "import time\ntime.sleep(3)"))
    holder.start()
    _poll(lambda: bob.pool_status()["scheduler"]["active"] == 1,
          "bob's cell holding the one mesh slot")
    positions, results = [], []

    def queued_cell(i):
        results.append(carol.execute(
            f"{i} + 1", priority=1,
            on_queued=lambda n: positions.append(n["position"])))

    carols = [threading.Thread(target=queued_cell, args=(i,))
              for i in range(2)]
    for t in carols:
        t.start()
        _poll(lambda: len(positions) == carols.index(t) + 1,
              "carol's queued notice")
    assert sorted(positions) == [1, 2]
    # carol is at her in-flight cap (2 queued).
    with pytest.raises(CellSubmitError) as ei:
        carol.execute("3")
    assert ei.value.verdict["status"] == "rejected"
    assert ei.value.verdict["reason"] == "tenant-inflight-cap"
    # The queue is full: alice's priority-0 cell is the lowest-priority
    # youngest, and is shed with a visible verdict.
    out, res = run("distributed", "--priority 0", "never = 1")
    assert res is None and "🪓 cell shed under overload" in out, out
    holder.join(30)
    for t in carols:
        t.join(30)
    assert len(results) == 2 and all(r["status"] == "ok"
                                     for r in results)
    st = bob.pool_status()
    assert st["scheduler"]["tenants"]["alice"]["shed"] == 1
    assert _outputs(dave.execute("rank")) == {"0": "0", "1": "1"}
    carol.close(detach=True)
    dave.close(detach=True)


def test_crashed_tenant_parks_and_reattach_drains_exactly_once(pool):
    from nbdistributed_tpu_torch.gateway.client import (GatewayGone,
                                                        TenantFenced)
    c1 = pool.attach("crash")
    c1.execute("hits = 0")
    err = []

    def inflight():
        try:
            c1.execute("hits += 1\nimport time\ntime.sleep(1.5)\nhits")
        except Exception as e:
            err.append(e)

    th = threading.Thread(target=inflight)
    th.start()
    _poll(lambda: c1.pool_status()["scheduler"]["active"] == 1,
          "the in-flight cell")
    c1._ch.close()                 # the kernel dies mid-cell
    th.join(30)
    assert err and isinstance(err[0], GatewayGone)
    probe = pool.attach("probe")
    _poll(lambda: probe.pool_status()["tenants"]["tenants"]["crash"][
        "parked"] == 1, "the parked result")
    c2 = pool.attach("crash", token=c1.token)
    assert c2.attach_status == "reattached" and c2.epoch == 2
    assert len(c2.parked) == 1
    drained = c2.drain()
    assert len(drained) == 1
    (res,) = drained.values()
    assert res["status"] == "ok" and _outputs(res) == {"0": "1", "1": "1"}
    assert c2.drain() == {}                       # exactly once
    assert _outputs(c2.execute("hits")) == {"0": "1", "1": "1"}
    # A third kernel resumes the tenant: the second is fenced.
    c3 = pool.attach("crash", token=c1.token)
    assert c3.epoch == 3
    with pytest.raises(TenantFenced):
        c2.execute("hits = 'hijacked'")
    assert _outputs(c3.execute("hits")) == {"0": "1", "1": "1"}
    with pytest.raises(RuntimeError, match="refused"):
        pool.attach("crash", token="not-the-token")
    for c in (c2, c3, probe):
        c.close(detach=c is not c2)


def test_alice_kernel_crash_and_reattach_through_the_magics(pool):
    DM = _magics()
    client = DM._tenant
    lost = []

    def inflight():
        try:
            client.execute("import time\ntime.sleep(1.5)\n'alice-done'")
        except Exception as e:      # the kernel's own view of its death
            lost.append(type(e).__name__)

    th = threading.Thread(target=inflight)
    th.start()
    _poll(lambda: client.pool_status()["scheduler"]["active"] == 1,
          "alice's in-flight cell")
    client._ch.close()              # the notebook kernel dies
    th.join(30)
    assert lost == ["GatewayGone"]
    DM._drop_tenant_state()         # ... and a new one starts
    from nbdistributed_tpu_torch.gateway import daemon as gw
    from nbdistributed_tpu_torch.gateway.client import pool_status_probe
    m = gw.read_gateway_manifest(pool.run_dir)
    _poll(lambda: pool_status_probe(
        "127.0.0.1", m["tenant_plane"]["port"], m["pool_token"])[
        "tenants"]["tenants"]["alice"]["parked"] == 1,
        "alice's parked result")
    out, _ = pool.run("dist_attach", f"--tenant alice {pool.run_dir}")
    assert (f"🔗 reattached to pool {pool.run_dir} as tenant 'alice' "
            "(epoch 2, 2 ranks") in out, out
    assert out.count("finished while detached: 'alice-done'") == 2, out
    out, _ = pool.run("dist_status", "")
    assert (f"🌐 tenant 'alice' @ pool {pool.run_dir} · epoch 2 · alive"
            in out), out
    out, _ = pool.run("dist_pool", "status")
    assert "alice*" in out


def test_training_cell_losses_are_bitwise_the_in_process_step(pool):
    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                                make_train_step,
                                                param_leaves, tiny_config)
    trainer = pool.attach("trainer")
    assert trainer.execute(TRAIN_SETUP)["status"] == "ok"
    got = [_outputs(trainer.execute("repr(float(step(params, batch)))"))
           for _ in range(2)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for r in (0, 1):
            cfg = tiny_config(dtype=torch.float32)
            gen = torch.Generator().manual_seed(7 + r)
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                             generator=gen)}
            params = init_params(cfg, 0, device="cpu")
            step = make_train_step(cfg, AdamW(param_leaves(params),
                                              lr=1e-3))
            want = [repr(repr(float(step(params, batch))))
                    for _ in range(2)]
            assert [g[str(r)] for g in got] == want
    finally:
        torch.set_num_threads(threads)
    trainer.close(detach=True)


SUM_CELL = "t = torch.full((2,), float(rank + 1))\ndist.all_reduce(t)\nfloat(t[0])"
QUEUED_CELL = "shared['queued'] = rank\n" + SUM_CELL


def _queue_behind_a_slow_cell(client, code):
    """Hold the pool's one mesh slot with a 2 s cell and queue ``code``
    behind it; returns the two threads and the box their replies land in."""
    box, positions = {}, []

    def execute(key, cell, **kw):
        try:
            box[key] = client.execute(cell, **kw)
        except Exception as e:  # noqa: BLE001 - the verdict under test
            box[key] = e

    slow = threading.Thread(target=execute, args=(
        "slow", "import time\ntime.sleep(2)\n'slow'"))
    slow.start()
    _poll(lambda: client.pool_status()["scheduler"]["active"] == 1,
          "the slow cell")
    queued = threading.Thread(target=execute, args=("queued", code), kwargs={
        "on_queued": lambda n: positions.append(n["position"])})
    queued.start()
    _poll(lambda: positions, "the queued notice")
    return slow, queued, box


def _stale(reply, ranks, epoch):
    """Each rank of ``ranks`` refused the cell as stale: the frame was
    stamped at submit with the old ``epoch``, so nothing of it ran."""
    results = reply.get("results") or {}
    assert sorted(results) == [str(r) for r in ranks], reply
    for r in ranks:
        d = results[str(r)]
        assert d.get("stale_epoch") is True, reply
        assert d["error"].startswith(f"stale coordinator epoch {epoch} "), \
            reply


def test_resize_with_a_queued_cell_and_template_replay(pool, tmp_path):
    """As in the JAX package, the coordinator stamps a cell's epoch at
    submit, so a cell that waited in the queue through a flip reaches
    the new fleet under the old epoch and comes back as a stale verdict
    (the JAX chaos test's "the epoch flip may retire a queued cell"):
    an all-reduce queued at 2 ranks never runs on part of a 3-rank
    world, and one queued at 3 ranks never runs on the 2 that are left."""
    run = pool.run
    tpl = tmp_path / "warm.py"
    tpl.write_text("shared['warm'] = shared.get('warm', 0) + 1\n")
    out, _ = run("dist_pool", f"template --file {tpl} --name warm")
    assert "✅ template 'warm' ran on ranks [0, 1]" in out, out
    out, _ = run("dist_pool", "template")
    assert "📋 templates: warm" in out
    bob = pool.attach("resizer")
    assert _outputs(bob.execute(SUM_CELL)) == {"0": "3.0", "1": "3.0"}
    slow, queued, box = _queue_behind_a_slow_cell(bob, QUEUED_CELL)
    out, _ = run("dist_pool", "resize -n 3")
    assert "✅ resized: 3 ranks · epoch 2 · generation 2 · drain" in out, out
    assert "TIMED OUT" not in out
    slow.join(30)
    queued.join(60)
    assert not slow.is_alive() and not queued.is_alive()
    assert _outputs(box["slow"]) == {"0": "'slow'", "1": "'slow'"}
    _stale(box["queued"], [0, 1], 1)
    # Nothing of it ran; the template was replayed on the new fleet,
    # and the whole world sums.
    assert _outputs(bob.execute("shared.get('queued'), shared['warm']")) \
        == {"0": "(None, 1)", "1": "(None, 1)", "2": "(None, 1)"}
    assert _outputs(bob.execute(SUM_CELL)) == {
        "0": "6.0", "1": "6.0", "2": "6.0"}
    out, _ = run("dist_pool", "status")
    assert "3 ranks · epoch 2 · gen 2" in out and "joined ep 2" in out, out
    _, res = run("distributed", "", "rank")
    assert sorted(res) == ["0", "1", "2"]
    slow, queued, box = _queue_behind_a_slow_cell(bob, QUEUED_CELL)
    out, _ = run("dist_pool", "resize -n 2")
    assert "✅ resized: 2 ranks · epoch 3 · generation 3" in out, out
    slow.join(30)
    queued.join(60)
    assert not slow.is_alive() and not queued.is_alive()
    assert _outputs(box["slow"]) == {
        "0": "'slow'", "1": "'slow'", "2": "'slow'"}
    # Queued at 3 ranks: ranks 0 and 1 refuse it as stale and rank 2
    # is gone, so the tenant gets an error verdict and nothing ran.
    assert box["queued"] == {
        "status": "error",
        "error": "TransportError: ranks [2] are not connected"}, box
    assert _outputs(bob.execute("shared.get('queued'), shared['warm']")) \
        == {"0": "(None, 1)", "1": "(None, 1)"}
    assert _outputs(bob.execute(SUM_CELL)) == {"0": "3.0", "1": "3.0"}
    out, _ = run("dist_pool", "resize -n 2")
    assert "ℹ pool is already 2 ranks" in out
    bob.close(detach=True)


def test_gpu_pool_past_the_cards_is_refused(pool, monkeypatch):
    from nbdistributed_tpu_torch.manager import topology
    monkeypatch.setattr(topology, "available_gpus", lambda: 1)
    out, _ = pool.run("dist_pool", "start -n 2 --backend gpu "
                      f"--run-dir {pool.root}/refused")
    assert out.strip() == ("❌ a gpu pool runs one rank a GPU and this "
                           "host has 1: 2 ranks refused"), out
    assert not os.path.exists(f"{pool.root}/refused")
    monkeypatch.setattr(topology, "available_gpus", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pool.run("dist_pool", "start -n 1 --backend auto")


SERVE_SPEC = """\
import torch
torch.set_num_threads(1)
from nbdistributed_tpu_torch.models import init_params, tiny_config
cfg = tiny_config(dtype=torch.float32)
params = init_params(cfg, 0, device="cpu")
"""


def test_dist_serve_and_migrate_through_the_magics(pool):
    """``%dist_serve`` from alice's kernel: a plane for the tenant
    ``srv`` on the pool, a request submitted with ``--wait`` whose
    tokens are the in-process greedy ``generate``'s, the status, stage
    table and stream resume, the plane on ``%dist_pool status``, and
    stop; ``%dist_pool migrate`` refusing a destination with no live
    gateway."""
    import torch

    from nbdistributed_tpu_torch.models import (generate, init_params,
                                                tiny_config)
    run = pool.run
    pool.magics.shell.user_ns["SPEC"] = SERVE_SPEC
    out, _ = run("dist_serve", "start --spec NOPE")
    assert out == ("❌ --spec NOPE: no string variable of that name in "
                   "this kernel\n")
    out, _ = run("dist_serve", "start --spec SPEC --tenant srv "
                 "--max-batch 2 --max-len 64 --steps 4")
    assert out.startswith("🍽️ serving as tenant 'srv': 2 KV slots · "
                          "max_len 64 · decode rank "), out
    out, _ = run("dist_serve", "start --spec SPEC --tenant srv2")
    assert "a serving plane is already running" in out, out
    cfg = tiny_config(dtype=torch.float32)
    want = generate(init_params(cfg, 0, device="cpu"), [[5, 9, 2]], cfg,
                    6)[0, 3:].tolist()
    out, _ = run("dist_serve", "submit --prompt 5,9,2 --max-new 6 --wait")
    assert out.startswith("✅ accepted r0 — tokens stream here"), out
    assert f"🧾 r0 completed: {want}" in out, out
    out, _ = run("dist_serve", "stream --rid r0 --from 2")
    assert out == f"r0[2:]: {want[2:]} (done)\n", out
    out, _ = run("dist_serve", "result --rid r0")
    assert out == f"r0: completed {want}\n", out
    out, _ = run("dist_serve", "status")
    assert out.startswith("🍽️ serving[srv] · decode rank 1 · KV 0/2"), out
    assert ("accepted 1 · completed 1 · shed 0 · rejected 0 · replayed 0"
            " · resumed 1 · failovers 0 · dup-dropped 0") in out, out
    out, _ = run("dist_serve", "lat --last 1")
    assert "⏱ serving stage decomposition (1 recorded" in out, out
    assert "r0" in out and "decode" in out, out
    out, _ = run("dist_pool", "status")
    assert "🍽️ serving[srv]" in out, out
    out, _ = run("dist_serve", "submit --prompt 1 --max-new 100")
    assert "too-long" in out or "exceeds the server's max_len" in out, out
    out, _ = run("dist_pool", f"migrate --tenant bob --to "
                 f"{pool.root}/no-such-pool")
    assert out.splitlines()[-1] == (
        f"❌ migration refused: no live gateway at "
        f"{pool.root}/no-such-pool"), out
    out, _ = run("dist_pool", "migrate")
    assert out == "❌ migrate needs --tenant NAME\n"
    out, _ = run("dist_serve", "stop")
    assert out == "🛑 serving stopped: 1 completed · 6 tokens\n", out
    out, _ = run("dist_serve", "status")
    assert out == "(no serving plane running — %dist_serve start)\n"
    out, _ = run("dist_pool", "status")
    assert "serving[" not in out


def test_tenant_mode_magics_and_gc(pool):
    run = pool.run
    out, _ = run("dist_init", "-n 1 --backend cpu")
    assert "attached to a gateway pool as tenant 'alice'" in out
    out, _ = run("rank", "[0]", "1")
    assert "only %%distributed cells run on a pool" in out
    out, _ = run("dist_top", "")
    assert "🌐 tenant 'alice'" in out
    out, _ = run("dist_lat", "")
    assert "execute" in out
    out, _ = run("dist_gc", f"--dry-run --root {pool.root}")
    gw_pid = __import__("json").load(open(os.path.join(
        pool.run_dir, "gateway.json")))["pid"]
    assert (f"= kept {pool.run_dir} — live gateway daemon (pid {gw_pid})"
            in out), out
    out, _ = run("dist_shutdown", "")
    assert "✅ detached tenant 'alice' from the pool" in out
    assert _magics()._tenant is None
    # A clean goodbye with nothing parked frees alice's slot: the name
    # comes back as a new tenant.
    probe = pool.attach("probe2")
    _poll(lambda: "alice" not in probe.pool_status()["tenants"][
        "tenants"], "alice's eviction")
    probe.close(detach=True)
    out, _ = run("dist_attach", f"--tenant alice {pool.run_dir}")
    assert "🤝 attached" in out and "(epoch 1," in out, out


def _gone(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] == "Z"
    except OSError:
        return True


def test_pool_stop_leaves_no_process(pool):
    from nbdistributed_tpu_torch.gateway import daemon as gw
    from nbdistributed_tpu_torch.resilience import session
    daemon_pid = gw.read_gateway_manifest(pool.run_dir)["pid"]
    pids = list(session.read_manifest(pool.run_dir)["pids"].values())
    assert len(pids) == 2 and all(not _gone(p) for p in pids + [daemon_pid])
    out, _ = pool.run("dist_pool", "stop")
    assert f"🛑 pool {pool.run_dir}: stopping" in out, out
    assert _magics()._tenant is None
    _poll(lambda: all(_gone(p) for p in pids + [daemon_pid]),
          "the daemon and its ranks to exit", 30.0)
    assert gw.read_gateway_manifest(pool.run_dir) is None


# ----------------------------------------------------------------------
# the tools: tools/nbd_torch_gateway.py and tools/nbd_torch_gc.py

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _children(ppid):
    """The port's worker processes whose parent is ``ppid`` (from
    /proc; a helper the parent runs while it imports is not one)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                if int(f.read().split(")")[-1].split()[1]) != ppid:
                    continue
            with open(f"/proc/{d}/cmdline", "rb") as f:
                if b"nbdistributed_tpu_torch.runtime.worker" in f.read():
                    out.append(int(d))
        except (OSError, ValueError, IndexError):
            pass
    return out


def test_gateway_tool_starts_and_stops_a_cpu_pool(tmp_path):
    import subprocess
    import sys
    from nbdistributed_tpu_torch.gateway import daemon as gw
    from nbdistributed_tpu_torch.gateway.client import (pool_shutdown,
                                                        pool_status_probe)
    run_dir = str(tmp_path / "pool")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools",
                                      "nbd_torch_gateway.py"),
         "-n", "2", "--backend", "cpu", "--run-dir", run_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith(f"NBD_GATEWAY_READY run_dir={run_dir} "
                               "port="), line
        assert line.rstrip().endswith("world=2")
        workers = _children(proc.pid)
        assert len(workers) == 2
        m = gw.read_gateway_manifest(run_dir)
        st = pool_status_probe("127.0.0.1", m["tenant_plane"]["port"],
                               m["pool_token"])
        assert st["world_size"] == 2 and st["pid"] == proc.pid
        assert pool_shutdown("127.0.0.1", m["tenant_plane"]["port"],
                             m["pool_token"]) == {"status": "stopping"}
        assert proc.wait(60) == 0
        _poll(lambda: all(_gone(p) for p in workers), "the ranks' exit",
              30.0)
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "nbd_torch_gc.py"),
             "--dry-run", "--root", str(tmp_path), "--ttl-s", "3600"],
            capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        assert out.stdout.startswith(
            f"would sweep 0 stale run dir(s) under {tmp_path} (ttl "
            "3600s); kept 1"), out.stdout
        assert f"= kept {run_dir} — younger than ttl" in out.stdout
    finally:
        if proc.poll() is None:
            proc.kill()


def test_gateway_tool_sigterm_mid_spawn_reaps_the_fleet(tmp_path):
    """A SIGTERM while the ranks are still spawning raises through the
    daemon's construction, which reaps what it spawned: exit 143 and no
    rank left behind."""
    import subprocess
    import sys
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools",
                                      "nbd_torch_gateway.py"),
         "-n", "2", "--backend", "cpu", "--run-dir",
         str(tmp_path / "pool")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        workers = _poll(lambda: _children(proc.pid), "the first rank",
                        60.0)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 143, proc.stdout.read()
        assert "NBD_GATEWAY_READY" not in proc.stdout.read()
        _poll(lambda: all(_gone(p) for p in workers),
              "the half-started ranks' exit", 30.0)
    finally:
        if proc.poll() is None:
            proc.kill()
