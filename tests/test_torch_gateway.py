"""The port's gateway tenant plane against the JAX package's, without a
fleet: the ``TenantRegistry`` (admission, tokens, epochs, fences,
detach, eviction, mailbox partitions, migration snapshots), the gateway
manifest (keys and values written by the daemon, ``gateway_alive``,
``discover_gateway``), ``gc_runs``'s live-gateway rule, the
``TenantClient``'s wire frames and verdict parsing over each package's
own transport, and the daemon's delivery / eviction / drain bookkeeping
on skeletal daemons.  Where both packages take the same inputs, both
are fed and their outputs compared exactly (tokens, pids and clocks
normalised); the other cases run once per package.  The non-serving
cases of ``tests/unit/test_gateway.py``.
"""

import json
import os
import threading
import types

import pytest

import nbdistributed_tpu.gateway.client as jax_client
import nbdistributed_tpu.gateway.daemon as jax_daemon
import nbdistributed_tpu.gateway.membership as jax_membership
import nbdistributed_tpu.gateway.scheduler as jax_scheduler
import nbdistributed_tpu.gateway.tenancy as jax_tenancy
import nbdistributed_tpu.messaging.codec as jax_codec
import nbdistributed_tpu.messaging.native as jax_native
import nbdistributed_tpu.resilience.dedup as jax_dedup
import nbdistributed_tpu.resilience.session as jax_session
import nbdistributed_tpu_torch.gateway.client as t_client
import nbdistributed_tpu_torch.gateway.daemon as t_daemon
import nbdistributed_tpu_torch.gateway.membership as t_membership
import nbdistributed_tpu_torch.gateway.scheduler as t_scheduler
import nbdistributed_tpu_torch.gateway.tenancy as t_tenancy
import nbdistributed_tpu_torch.messaging.codec as t_codec
import nbdistributed_tpu_torch.messaging.native as t_native
import nbdistributed_tpu_torch.resilience.dedup as t_dedup
import nbdistributed_tpu_torch.resilience.session as t_session

PKGS = {
    "jax": types.SimpleNamespace(
        client=jax_client, daemon=jax_daemon, tenancy=jax_tenancy,
        membership=jax_membership, scheduler=jax_scheduler,
        codec=jax_codec, native=jax_native, dedup=jax_dedup,
        session=jax_session),
    "torch": types.SimpleNamespace(
        client=t_client, daemon=t_daemon, tenancy=t_tenancy,
        membership=t_membership, scheduler=t_scheduler,
        codec=t_codec, native=t_native, dedup=t_dedup,
        session=t_session),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


class _Tokens:
    """Replace each distinct minted token by its order of appearance."""

    def __init__(self):
        self.seen = {}

    def __call__(self, obj):
        if isinstance(obj, dict):
            return {k: self(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [self(v) for v in obj]
        if isinstance(obj, str) and len(obj) >= 16 and all(
                c in "0123456789abcdef" for c in obj):
            return f"<tok{self.seen.setdefault(obj, len(self.seen))}>"
        return obj


# ----------------------------------------------------------------------
# registry: one scripted session through both packages

SCRIPT = [
    ("hello", "alice", None, 1, None), ("hello", "bob", None, 2, 3),
    ("hello", "alice", "bad", 3, None), ("hello", "alice", "own", 4, 5),
    ("fence", "alice", 1), ("fence", "alice", 2), ("fence", "alice", None),
    ("detach", 1), ("detach", 4), ("hello", "carol", None, 5, None),
    ("hello", "dave", None, 6, None), ("evict", "alice"),
    ("evict", "bob"), ("detach", 2), ("evict", "bob"),
    ("hello", "dave", None, 7, None), ("hello", "erin", None, 8, 1),
    ("export", "carol"), ("export", "nobody"),
    ("release", "carol", False), ("release", "carol", True),
    ("import", "carol"), ("import", "carol"), ("hello", "carol", "own", 9,
                                               None),
    ("detach", 9), ("release", "carol", False), ("names",),
    ("hello", "alice", "own", 10, None), ("by_client", 1),
    ("by_client", 10), ("manifest",), ("describe",),
]


def _run_registry(pkg):
    reg = pkg.tenancy.TenantRegistry(max_tenants=3)
    out, snaps = [], {}
    for step in SCRIPT:
        op = step[0]
        try:
            if op == "hello":
                _, name, tok, cid, prio = step
                t = reg.get(name)
                token = (t.token if tok == "own" and t is not None
                         else tok)
                t, reply = reg.hello(name, token, cid, priority=prio)
                res = (reply, t.priority, t.reattaches, t.attached)
            elif op == "fence":
                res = reg.fence(reg.get(step[1]), step[2])
            elif op == "detach":
                t = reg.detach_client(step[1])
                res = None if t is None else t.name
            elif op == "evict":
                res = reg.evict(step[1])
            elif op == "export":
                t = reg.get(step[1])
                if t is not None:
                    t.mailbox.park("m-" + step[1], pkg.codec.Message(
                        msg_type="response", msg_id="m-" + step[1],
                        data={"output": step[1]}))
                res = reg.export_tenant(step[1])
                if res is not None:
                    snaps[step[1]] = res
            elif op == "release":
                res = reg.release(step[1], force=step[2])
            elif op == "import":
                t, why = reg.import_tenant(snaps[step[1]])
                res = (None if t is None else (t.name, t.epoch), why)
            elif op == "names":
                res = reg.names()
            elif op == "by_client":
                t = reg.by_client(step[1])
                res = None if t is None else t.name
            elif op == "manifest":
                res = reg.manifest_block()
            else:
                res = reg.describe()
                for row in res["tenants"].values():
                    row.pop("last_seen_age_s")
                    row.pop("token_fp")
        except pkg.tenancy.TenantRejected as e:
            res = ("rejected", e.reason, str(e))
        out.append((step, res))
    return out


def test_registry_script_equals_jax():
    norm_j, norm_t = _Tokens(), _Tokens()
    ref = norm_j(_run_registry(PKGS["jax"]))
    ours = norm_t(_run_registry(PKGS["torch"]))
    assert json.dumps(ours, sort_keys=True) == json.dumps(ref, sort_keys=True)
    # The script reaches every verdict it is meant to.
    text = json.dumps(ours)
    for word in ("admitted", "reattached", "max_tenants=3",
                 "token mismatch", "imported"):
        assert word in text, word


def test_hello_admits_and_mints_token(pkg):
    reg = pkg.tenancy.TenantRegistry(max_tenants=2)
    t, reply = reg.hello("alice", None, client_id=7)
    assert reply["status"] == "admitted" and reply["tenant"] == "alice"
    assert t.token and reply["token"] == t.token
    assert t.epoch == 1 and reply["epoch"] == 1
    assert reg.by_client(7) is t


def test_admission_headcount_bound(pkg):
    reg = pkg.tenancy.TenantRegistry(max_tenants=2)
    reg.hello("a", None, 1)
    reg.hello("b", None, 2)
    with pytest.raises(pkg.tenancy.TenantRejected) as ei:
        reg.hello("c", None, 3)
    assert "max_tenants=2" in str(ei.value)
    _, reply = reg.hello("a", reg.get("a").token, 4)
    assert reply["status"] == "reattached"


def test_wrong_token_cannot_hijack_a_tenant_name(pkg):
    reg = pkg.tenancy.TenantRegistry()
    reg.hello("alice", None, 1)
    for bad in (None, "", "wrong-token"):
        with pytest.raises(pkg.tenancy.TenantRejected):
            reg.hello("alice", bad, 2)
    assert reg.get("alice").epoch == 1


def test_reattach_bumps_epoch_and_fences_old_connection(pkg):
    reg = pkg.tenancy.TenantRegistry()
    t, _ = reg.hello("alice", None, client_id=1)
    t2, reply = reg.hello("alice", t.token, client_id=2, priority=7)
    assert t2 is t and reply["status"] == "reattached"
    assert t.epoch == 2 and t.reattaches == 1 and t.priority == 7
    assert reg.fence(t, 1) is True
    assert reg.fence(t, 2) is False and reg.fence(t, None) is False
    assert reg.by_client(1) is t and reg.by_client(2) is t
    reg.hello("alice", t.token, client_id=3)
    assert t.priority == 7


def test_detach_keeps_tenant_state_for_reattach(pkg):
    reg = pkg.tenancy.TenantRegistry()
    t, _ = reg.hello("alice", None, client_id=1)
    t.mailbox.park("mid-1", object())
    assert reg.detach_client(1) is t
    assert not t.attached and reg.get("alice") is t
    assert len(t.mailbox) == 1 and reg.by_client(1) is None
    reg.hello("alice", t.token, client_id=2)
    assert reg.detach_client(1) is None and t.client_id == 2
    reg.hello("alice", t.token, client_id=3)
    assert reg.detach_client(2) is None
    assert t.client_id == 3 and reg.detach_client(3) is t


def test_mailbox_partitions_are_per_tenant(pkg):
    reg = pkg.tenancy.TenantRegistry()
    a, _ = reg.hello("a", None, 1)
    b, _ = reg.hello("b", None, 2)
    a.mailbox.park("m1", "ra")
    b.mailbox.park("m2", "rb")
    assert a.mailbox.claim_all() == {"m1": "ra"}
    assert a.mailbox.claim_all() == {}
    assert len(b.mailbox) == 1


# ----------------------------------------------------------------------
# gateway manifest and its liveness probe


def _skeleton_daemon(pkg, run_dir):
    d = object.__new__(pkg.daemon.GatewayDaemon)
    d.world_size = 3
    d.session_epoch = 2
    d.membership = pkg.membership.PoolMembership(3, epoch=1, now=1.0)
    d.membership.begin_resize(3, 2, reason="test", now=2.0)
    d.membership.complete_resize(3, 2, now=3.0)
    d.tenant_host = "127.0.0.1"
    d.tenant_port = 4242
    d.pool_token = "ab" * 16
    d.policy = pkg.scheduler.SchedPolicy("fair", mesh_slots=1,
                                         tenant_inflight=3, queue_depth=2)
    d.registry = pkg.tenancy.TenantRegistry(max_tenants=4)
    t, _ = d.registry.hello("alice", "cd" * 16, 1)
    d.registry.hello("alice", "cd" * 16, 2)
    d.registry.hello("bob", "ef" * 16, 3)
    d.registry.detach_client(3)
    d._metrics_httpd = types.SimpleNamespace(port=9100)
    d.run_dir = run_dir
    d._manifest_lock = threading.Lock()
    d._close_started = False
    return d


def test_manifest_written_by_the_daemon_equals_jax(tmp_path):
    got = {}
    for name, pkg in PKGS.items():
        run_dir = str(tmp_path / name)
        os.makedirs(run_dir)
        _skeleton_daemon(pkg, run_dir)._write_manifest_sync()
        m = pkg.daemon.read_gateway_manifest(run_dir)
        assert m["pid"] == os.getpid()
        assert pkg.daemon.gateway_alive(m)
        for k in ("pid", "created_ts", "updated_ts"):
            m.pop(k)
        for rank in m["membership"]["ranks"].values():
            rank.pop("joined_ts")
        got[name] = m
    assert got["torch"] == got["jax"]
    assert sorted(got["torch"]) == [
        "epoch", "generation", "kind", "max_tenants", "membership",
        "metrics", "policy", "pool_token", "tenant_plane", "tenants",
        "world_size"]
    assert got["torch"]["tenants"]["alice"] == {
        "token": "cd" * 16, "epoch": 2, "attached": True}


def test_gateway_alive_probe(pkg, tmp_path):
    d = str(tmp_path)
    path = pkg.daemon.gateway_manifest_path(d)
    assert path.endswith("gateway.json")
    assert pkg.daemon.read_gateway_manifest(d) is None
    assert pkg.daemon.gateway_alive(None) is False
    with open(path, "w") as f:
        f.write('{"kind": "gateway", "pid": %d}' % os.getpid())
    assert pkg.daemon.gateway_alive(pkg.daemon.read_gateway_manifest(d))
    for content in ('{"pid": 2147483646}', '{"pid": "x"}', "{torn"):
        with open(path, "w") as f:
            f.write(content)
        assert not pkg.daemon.gateway_alive(
            pkg.daemon.read_gateway_manifest(d))


def test_discover_gateway_picks_the_newest_live_pool(pkg, tmp_path,
                                                     monkeypatch):
    root = tmp_path / "runs"
    monkeypatch.setattr(pkg.session, "default_runs_root",
                        lambda: str(root))
    monkeypatch.delenv("NBD_RUN_DIR", raising=False)
    for name, pid, ts in (("old", os.getpid(), 1.0),
                          ("new", os.getpid(), 5.0),
                          ("dead", 2 ** 30, 9.0)):
        (root / name).mkdir(parents=True)
        (root / name / "gateway.json").write_text(json.dumps(
            {"kind": "gateway", "pid": pid, "updated_ts": ts}))
    assert pkg.daemon.discover_gateway() == str(root / "new")
    assert pkg.daemon.discover_gateway(str(root / "dead")) \
        == str(root / "dead")
    assert pkg.daemon.discover_gateway(str(tmp_path / "none")) is None
    monkeypatch.setenv("NBD_RUN_DIR", str(root / "old"))
    assert pkg.daemon.discover_gateway() == str(root / "old")


def test_gc_runs_keeps_live_gateway_dir_as_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("NBD_RUN_DIR", raising=False)
    root = tmp_path / "runs"
    live, stale = root / "pool-live", root / "stale"
    live.mkdir(parents=True)
    stale.mkdir()
    with open(t_daemon.gateway_manifest_path(str(live)), "w") as f:
        f.write('{"kind": "gateway", "pid": %d}' % os.getpid())
    old = 1_000_000.0
    os.utime(str(live), (old, old))
    os.utime(str(stale), (old, old))
    ours = t_session.gc_runs(str(root), ttl_s=60, dry_run=True)
    ref = jax_session.gc_runs(str(root), ttl_s=60, dry_run=True)
    assert ours == ref
    assert str(stale) in ours["swept"] and str(live) in ours["kept"]
    assert ours["kept_why"][str(live)] \
        == f"live gateway daemon (pid {os.getpid()})"


# ----------------------------------------------------------------------
# the client over each package's own transport: frames and verdicts

POLICY = {"mode": "fair", "mesh_slots": 1}


def _scripted_gateway(pkg, token):
    """A listener answering the tenant plane from a script; returns
    (listener, frames) where frames collects what the client sent."""
    lst = pkg.native.make_listener(port=0, auth_token=token)
    frames = []

    def on_message(cid, msg):
        frames.append({"type": msg.msg_type, "data": msg.data,
                       "epoch": msg.epoch})
        mt, data = msg.msg_type, msg.data or {}

        def reply(**kw):
            lst.send_to_rank(cid, msg.reply(**kw))
        if mt == "tenant_hello":
            reply(data={"status": "admitted", "tenant": data["tenant"],
                        "token": "11" * 16, "epoch": 3,
                        "parked": ["p1"], "world_size": 2,
                        "policy": POLICY})
        elif mt == "execute":
            code = data["code"]
            if code == "queued":
                reply(msg_type="queued", data={
                    "status": "queued", "position": 2,
                    "msg_id": msg.msg_id, "reason": "serialized: x"})
                reply(data={"status": "ok", "results": {
                    "0": {"output": "1"}, "1": {"output": "1"}}})
            elif code in ("shed", "rejected"):
                reply(data={"status": code, "reason": "overload",
                            "error": f"cell {code}"})
            elif code == "fenced":
                reply(data={"error": "stale tenant epoch 3",
                            "stale_epoch": True})
            else:
                reply(data={"status": "error",
                            "error": "WorkerDied: worker 1 died"})
        elif mt == "mailbox":
            reply(data={"status": "ok",
                        "results": {"p1": {"status": "ok"}}})
        elif mt in ("pool_status", "pool_shutdown", "pool_resize",
                    "pool_template", "tenant_export", "tenant_import",
                    "tenant_release", "detach") or mt.startswith("serve"):
            reply(data={"status": "ok", "echo": mt})
    lst.on_message = on_message
    lst.start()
    return lst, frames


def _drive_client(pkg):
    token = "77" * 16
    lst, frames = _scripted_gateway(pkg, token)
    out = []
    try:
        c = pkg.client.TenantClient("127.0.0.1", lst.port, "alice",
                                    pool_token=token, priority=4)
        out.append(("hello", c.token, c.epoch, c.parked, c.world_size,
                    c.policy, c.attach_status))
        notices = []
        res = c.execute("queued", priority=2, deadline_s=9.0,
                        target_ranks=[0, 1], on_queued=notices.append)
        # The notice names the request it queued (a fresh id a run).
        assert notices and all(len(n.pop("msg_id")) == 32
                               for n in notices)
        out.append(("queued", res, notices))
        for code in ("shed", "rejected", "fenced"):
            try:
                c.execute(code)
                out.append((code, "returned"))
            except Exception as e:
                out.append((code, type(e).__name__, str(e),
                            getattr(e, "verdict", None)))
        out.append(("error", c.execute("boom")))
        out.append(("drain", c.drain()))
        out.append(("status", c.pool_status()))
        out.append(("serve_status", c.serve_status()))
        out.append(("serve_submit", c.serve_submit([1, 2], 3,
                                                   priority=1)))
        c.close(detach=True)
        assert not c._reader.is_alive()
        host, port = "127.0.0.1", lst.port
        out.append(("probe", pkg.client.pool_status_probe(
            host, port, token, timeout=10)))
        out.append(("resize", pkg.client.pool_resize(
            host, port, token, 3, timeout=10)))
        out.append(("template", pkg.client.pool_template(
            host, port, token, "x = 1", name="warm", timeout=10)))
        out.append(("shutdown", pkg.client.pool_shutdown(
            host, port, token, timeout=10)))
    finally:
        lst.close()
    return out, frames


def test_client_frames_and_verdicts_equal_jax():
    ours, ours_frames = _drive_client(PKGS["torch"])
    ref, ref_frames = _drive_client(PKGS["jax"])
    assert ours == ref
    assert ours_frames == ref_frames
    # What the script pins: the hello is unstamped, every later
    # request carries the tenant epoch, the verdicts map to the client's
    # exceptions, and the admin frames re-prove the pool token.
    assert ours_frames[0] == {"type": "tenant_hello", "epoch": None,
                              "data": {"tenant": "alice", "token": None,
                                       "priority": 4}}
    assert ours_frames[1] == {"type": "execute", "epoch": 3, "data": {
        "code": "queued", "priority": 2, "deadline_s": 9.0,
        "target_ranks": [0, 1]}}
    assert [o[1] for o in ours[2:5]] == ["CellSubmitError",
                                         "CellSubmitError", "TenantFenced"]
    assert ours[1][2] == [{"status": "queued", "position": 2,
                           "reason": "serialized: x"}]
    assert ours_frames[-1]["data"] == {"token": "77" * 16}
    assert ours_frames[-3]["data"] == {"token": "77" * 16, "workers": 3,
                                       "reason": "manual"}


def test_tenant_client_close_joins_reader_thread(pkg):
    tc = object.__new__(pkg.client.TenantClient)
    tc._closed = False
    tc._dead = None
    unblock = threading.Event()
    tc._ch = types.SimpleNamespace(close=unblock.set)
    tc._reader = threading.Thread(target=unblock.wait, daemon=True)
    tc._reader.start()
    tc.close()
    tc._reader.join(timeout=2.0)
    assert not tc._reader.is_alive()


def test_tenant_client_close_from_reader_thread_never_self_joins(pkg):
    tc = object.__new__(pkg.client.TenantClient)
    tc._closed = False
    tc._dead = None
    tc._ch = types.SimpleNamespace(close=lambda: None)
    done = []

    def _run():
        tc.close()
        done.append(True)

    t = threading.Thread(target=_run, daemon=True)
    tc._reader = t
    t.start()
    t.join(timeout=2.0)
    assert done == [True]


# ----------------------------------------------------------------------
# the daemon's bookkeeping on skeletal daemons


class _Flight:
    def __init__(self):
        self.events = []

    def record(self, kind, **kw):
        self.events.append((kind, kw))


def test_deliver_parks_when_submitting_connection_superseded(pkg):
    class _Reply:
        msg_id = "cell-1"

    d = object.__new__(pkg.daemon.GatewayDaemon)
    d._lock = threading.Lock()
    d.flight = _Flight()
    sent = []
    d._send_to_client = lambda cid, reply: (sent.append(
        (cid, getattr(reply, "msg_type", "reply"))) or True)
    t = pkg.tenancy.Tenant("alice", "tok")
    t.client_id = 2
    d._deliver(t, _Reply(), submit_cid=1)
    assert sent == [(2, "parked_notice")]
    assert t.mailbox.ids() == ["cell-1"] and t.parked_total == 1
    r2 = _Reply()
    r2.msg_id = "cell-2"
    d._deliver(t, r2, submit_cid=2)
    assert sent[-1][0] == 2 and sent[-1][1] != "parked_notice"
    assert t.mailbox.ids() == ["cell-1"]


def test_serve_count_brackets_execute_and_mailbox(pkg):
    d = object.__new__(pkg.daemon.GatewayDaemon)
    d._lock = threading.Lock()
    seen = []

    class _T:
        name = "alice"

    d._serving = {"alice": 1}
    d._serve_execute_inner = lambda t, m, c: seen.append(
        d._serving.get("alice"))
    d._serve_execute(_T(), None, 1)
    assert seen == [1] and d._serving == {}
    d._serving = {"alice": 2}

    def boom(*a):
        raise RuntimeError("worker died")

    d._serve_execute_inner = boom
    with pytest.raises(RuntimeError):
        d._serve_execute(_T(), None, 1)
    assert d._serving == {"alice": 1}
    d._serving = {"alice": 1}
    d._handle_mailbox = boom
    with pytest.raises(RuntimeError):
        d._serve_mailbox(_T(), None, 7)
    assert d._serving == {}


def test_gateway_drain_reparks_when_serve_thread_raises(pkg):
    class _T:
        name = "alice"
        mailbox = pkg.dedup.ResultMailbox()

    _T.mailbox.park("m1", pkg.codec.Message(msg_type="response",
                                            data={"output": "precious"}))
    d = object.__new__(pkg.daemon.GatewayDaemon)
    d._lock = threading.Lock()
    d.flight = _Flight()

    def _boom(cid, m):
        raise RuntimeError("encode blew up")

    d._send_to_client = _boom
    msg = pkg.codec.Message(msg_type="mailbox", data={"action": "drain"})
    with pytest.raises(RuntimeError, match="encode blew up"):
        d._handle_mailbox(7, _T(), msg)
    assert _T.mailbox.ids() == ["m1"]
    assert "tenant_mailbox_reparked" in [k for k, _ in d.flight.events]


def test_evict_gated_on_namespace_gc(pkg):
    class _Sched:
        def __init__(self):
            self.forgot = []

        def forget_tenant(self, name):
            self.forgot.append(name)

        def tenant_idle(self, name):
            return True

    class _Comm:
        def __init__(self, dead=(), fail_times=0):
            self._deadset, self.sent = set(dead), []
            self.fail_times = fail_times
            self.scheduler = _Sched()

        def dead_ranks(self):
            return set(self._deadset)

        def send_to_ranks(self, ranks, *a, **kw):
            if self.fail_times > 0:
                self.fail_times -= 1
                raise RuntimeError("request timed out")
            self.sent.append(list(ranks))

    class _T:
        client_id = None
        mailbox = ()

    class _Reg:
        def __init__(self, tenant=_T()):
            self.evicted, self.tenant = [], tenant

        def get(self, name):
            return self.tenant

        def evict(self, name):
            self.evicted.append(name)
            return True

    def mk(comm, reg=None, closed=False):
        d = object.__new__(pkg.daemon.GatewayDaemon)
        d._lock = threading.Lock()
        d.flight = _Flight()
        d.comm = comm
        d.world_size = 4
        d.registry = reg or _Reg()
        d._write_manifest = lambda: None
        d._closed = threading.Event()
        if closed:
            d._closed.set()
        return d

    d = mk(_Comm(fail_times=99), closed=True)
    d._evict_after_gc("alice")
    assert d.registry.evicted == []
    live = _T()
    live.client_id = 7
    d = mk(_Comm(), reg=_Reg(live))
    d._evict_after_gc("alice")
    assert d.registry.evicted == []
    c = _Comm(fail_times=1)
    d = mk(c)
    d._evict_after_gc("alice")
    assert c.sent and d.registry.evicted == ["alice"]
    c = _Comm(dead={2})
    d = mk(c)
    d._evict_after_gc("alice")
    assert c.sent == [[0, 1, 3]] and c.scheduler.forgot == ["alice"]


# ----------------------------------------------------------------------
# the port's own rules (ROADMAP queue C adaptations)


def test_gpu_pool_holds_one_rank_a_card(monkeypatch):
    """A port rank owns one GPU and NCCL refuses two ranks of one
    communicator on one device: a gpu pool past the host's cards is
    refused before anything spawns, and a resize past them before the
    drain (the JAX pool's worker owns all its chips instead)."""
    from nbdistributed_tpu_torch.manager import topology
    monkeypatch.setattr(topology, "available_gpus", lambda: 2)
    assert t_daemon.gpu_refusal("gpu", 2) is None
    assert t_daemon.gpu_refusal("cpu", 64) is None
    msg = t_daemon.gpu_refusal("gpu", 3)
    assert msg == ("a gpu pool runs one rank a GPU and this host has 2: "
                   "3 ranks refused")
    with pytest.raises(RuntimeError, match="3 ranks refused"):
        t_daemon.GatewayDaemon(3, backend="gpu")
    d = object.__new__(t_daemon.GatewayDaemon)
    d._backend = "gpu"
    d.flight = _Flight()
    d._resize_lock = None       # never reached: refused before the drain
    assert d.resize(3) == {"status": "error", "error": msg}
    assert d.flight.events == [("resize_refused",
                                {"target": 3, "error": msg})]


# ----------------------------------------------------------------------
# the serving and migration frames, answered as the JAX daemon answers

def _fake_comm_cls(name: str):
    """The fake comm of ``tests/unit/test_serving_plane.py`` for one
    package (its ``WorkerDied`` is that package's)."""
    import jax_unit_cases
    return jax_unit_cases.load("test_serving_plane.py", name)["FakeComm"]


class _PoolSched:
    def __init__(self):
        self.forgot = []

    def forget_tenant(self, name):
        self.forgot.append(name)


def _frame_daemon(name: str, run_dir: str):
    """A skeletal daemon of one package: the registry, the tenant
    plane's bookkeeping and a fake comm speaking the serve protocol."""
    pkg = PKGS[name]
    d = object.__new__(pkg.daemon.GatewayDaemon)
    sent = []
    got = threading.Condition()

    def send(cid, m):
        with got:
            sent.append((cid, m.msg_type, m.data))
            got.notify_all()
        return True

    d._send_to_client = send
    d._lock = threading.Lock()
    d._serving = {}
    d._serve_mgr = None
    d.flight = _Flight()
    d.pool_token = "pool-token"
    d.run_dir = run_dir
    d.world_size = 2
    d.comm = _fake_comm_cls(name)(num_workers=2)
    d.comm.scheduler = _PoolSched()
    d._write_manifest = lambda: None
    d.registry = pkg.tenancy.TenantRegistry()
    return d, sent, got


# (client id, frame type, payload): cid 6 never said hello, cid 5 is
# alice's connection.
_FRAMES = [
    (6, "serve_status", {}), (6, "serve_submit", {"prompt": [1]}),
    (6, "serve_result", {"rid": "r0"}), (6, "serve_stream", {}),
    (6, "serve_stop", {}), (6, "serve_start", {}),
    (5, "serve_status", {}),
    (5, "serve_submit", {"prompt": [5, 9], "max_new_tokens": 3}),
    (5, "serve_result", {"rid": "r0"}), (5, "serve_stream", {"rid": "r0"}),
    (5, "serve_stop", {}),
    (5, "serve_start", {"tenant": "alice"}),
    (5, "serve_start", {"max_batch": 2, "max_len": 32, "steps": 8,
                        "queue_depth": 1, "inflight": 1}),
    (5, "serve_start", {}),
    (5, "serve_submit", {"prompt": [], "max_new_tokens": 3}),
    (5, "serve_submit", {"prompt": [5, 9], "max_new_tokens": 3}),
    (5, "serve_result", {"rid": "r9"}),
    (5, "serve_stream", {"rid": "r0", "from": 1}),
    (5, "serve_stop", {}),
    (5, "serve_status", {}),
    (6, "tenant_export", {"token": "wrong", "tenant": "alice"}),
    (6, "tenant_export", {"token": "pool-token", "tenant": "nobody"}),
    (6, "tenant_export", {"token": "pool-token", "tenant": "alice"}),
    (5, "tenant_import", {"token": "pool-token", "snapshot": None}),
    (6, "tenant_import", {"token": "pool-token", "snapshot": "BOB"}),
    (6, "tenant_import", {"token": "pool-token", "snapshot": "BOB"}),
    (6, "tenant_release", {"token": "pool-token", "tenant": "alice"}),
    (6, "tenant_release", {"token": "pool-token", "tenant": "bob",
                           "force": True}),
    (5, "tenant_release", {"token": "wrong", "tenant": "bob"}),
]

# Fields that carry clocks or minted tokens, not decisions.
_VOLATILE = {"lat", "slo", "token", "ts", "last_seen", "attached_ts",
             "created_ts", "submitted_ts"}


def _stable(obj):
    if isinstance(obj, dict):
        return {k: _stable(v) for k, v in obj.items()
                if k not in _VOLATILE}
    if isinstance(obj, list):
        return [_stable(v) for v in obj]
    return obj


def _run_frames(name: str, run_dir: str) -> list:
    d, sent, got = _frame_daemon(name, run_dir)
    pkg = PKGS[name]
    d.registry.hello("alice", None, 5)
    bob = pkg.tenancy.TenantRegistry()
    bob.hello("bob", None, 9)
    bob_snap = bob.export_tenant("bob")
    try:
        for cid, mt, data in _FRAMES:
            if data.get("snapshot") == "BOB":
                data = dict(data, snapshot=bob_snap)
            n = len(sent)
            d._on_tenant_message(cid, pkg.codec.Message(
                msg_type=mt, data=dict(data), rank=cid))
            with got:
                assert got.wait_for(lambda: any(
                    m[1] == "response" for m in sent[n:]), timeout=20)
            if mt == "serve_submit" and d._serve_mgr is not None:
                # Let the one accepted request finish before the next
                # frame, so every reply is a function of the frames.
                mgr = d._serve_mgr
                rid = (sent[-1][2] or {}).get("rid")
                if rid:
                    deadline = 100
                    while not mgr.result(rid)["done"] and deadline:
                        with got:
                            got.wait(0.05)
                        deadline -= 1
    finally:
        if d._serve_mgr is not None:
            d._serve_mgr.stop()
    return [(cid, mt, _stable(data)) for cid, mt, data in sent]


def test_serve_and_migration_frames_answer_as_jax(tmp_path):
    """Each of the six ``serve_*`` frames and the three migration
    frames answers as the JAX daemon's does, before a hello (the
    serve frames are refused, the migration frames checked against the
    pool token) and after it: a plane started, a submit served to its
    ``serve_done``, a second start refused, stop, status off; an
    export with the serving journal riding along, an import (idempotent
    on retry) and a release."""
    got = {}
    for name in ("jax", "torch"):
        run = tmp_path / name
        run.mkdir()
        got[name] = _run_frames(name, str(run))
    assert got["torch"] == got["jax"]
    replies = [m for m in got["torch"] if m[1] == "response"]
    assert len(replies) == len(_FRAMES)
    st = [r[2].get("status") for r in replies]
    assert st[:6] == [None] * 6       # no hello: refused
    assert all("no tenant_hello" in r[2]["error"] for r in replies[:6])
    assert st[6:11] == ["off"] * 5
    assert st[11] == "error"          # a tenant's name is taken
    assert st[12:20] == ["serving", "already-serving", "rejected",
                         "accepted", "unknown", "completed", "stopped",
                         "off"]
    done = [m for m in got["torch"] if m[1] == "serve_done"]
    assert len(done) == 1 and done[0][2]["status"] == "completed"
    assert replies[20][2] == {"error": "pool token mismatch"}
    assert "no tenant 'nobody'" in replies[21][2]["error"]
    snap = replies[22][2]["snapshot"]
    assert replies[22][2]["status"] == "ok" and snap["tenant"] == "alice"
    assert '"e":"accept"' in snap["serve_journal"]
    assert "needs a snapshot" in replies[23][2]["error"]
    assert replies[24][2]["status"] == replies[25][2]["status"] \
        == "imported"
    assert replies[26][2]["status"] == "error"     # attached: no force
    assert replies[27][2] == {"status": "released"}
    assert replies[28][2] == {"error": "pool token mismatch"}


def test_auto_backend_raises_without_a_gpu(monkeypatch):
    from nbdistributed_tpu_torch.manager import topology
    monkeypatch.setattr(topology, "available_gpus", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        t_daemon.GatewayDaemon(1, backend="auto")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        t_daemon.GatewayDaemon(1)      # the default is the card
