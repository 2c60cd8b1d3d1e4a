"""The port's serving plane end to end on the CPU: one in-process
``GatewayDaemon`` over 3 gloo ranks, shared by every test here in file
order, serving ``tiny_config`` in float32 with the JAX package's
weights (``init_params(PRNGKey(0))``, converted by
``models/convert.py`` and loaded by the model-spec cell on every
rank).  The cases of the JAX package's
``tests/integration/test_serve_chaos.py`` and ``test_serving_fast.py``:

- the loadgen on two decode ranks through ``ClientTransport`` and
  through the ``/v1`` HTTP shim (``tools/nbd_torch_serve.py``): every
  offered request in an explicit bucket, nothing hung, the report
  valid, completed streams equal to solo ``generate``;
- overload: a rejected verdict at the tenant's cap and a delivered shed;
- the serving tenant's cells refused with a message naming
  ``%dist_serve``;
- reattach mid-generation: the result parked once, the stream resumed
  from an offset;
- chunked prefill: a short stream keeps emitting while a long prompt
  prefills in chunks;
- stage attribution against ``/metrics``;
- last, a SIGKILL of a non-zero decode rank mid-decode (rank 0 hosts
  the process group's store): the plane fails over, replays from its
  journal, and every stream equals both the port's solo ``generate``
  and the JAX package's on the same weights, with ``dup_dropped == 0``.

On the CPU's plain path prefill and decode compute the same rows, so
the streams are held exactly, as the JAX tests hold them.
"""

import ast
import importlib
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbdistributed_tpu.models import transformer as jtf

# The module, not the package's same-named function.
jax_generate_mod = importlib.import_module("nbdistributed_tpu.models.generate")

pytestmark = [pytest.mark.integration]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 3
PROMPTS = [[5, 9, 2], [7, 1], [3, 4, 8, 1], [11, 3], [2, 2, 2, 2],
           [6, 13], [1, 2, 3], [9, 9]]
MAX_NEW = 6


def _spec(path: str) -> str:
    return ("import torch as _t\n"
            "_t.set_num_threads(1)\n"
            "from nbdistributed_tpu_torch.models import tiny_config\n"
            "cfg = tiny_config(dtype=_t.float32)\n"
            f"params = _t.load({path!r})\n")


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    from nbdistributed_tpu_torch.gateway.daemon import GatewayDaemon
    from nbdistributed_tpu_torch.gateway.scheduler import SchedPolicy
    from nbdistributed_tpu_torch.models import (params_from_jax,
                                                tiny_config)
    from nbdistributed_tpu_torch.observability import flightrec
    run_dir = str(tmp_path_factory.mktemp("servepool"))
    jcfg = jtf.tiny_config(dtype=jnp.float32, use_flash=False)
    tree = jax.tree.map(np.asarray,
                        jtf.init_params(jax.random.PRNGKey(0), jcfg))
    cfg = tiny_config(dtype=torch.float32)
    params = params_from_jax(tree, cfg, device="cpu")
    wpath = os.path.join(run_dir, "weights.pt")
    torch.save(params, wpath)
    old = {k: os.environ.get(k) for k in ("NBD_RUN_DIR",)}
    os.environ["NBD_RUN_DIR"] = run_dir
    flightrec.reset_for_tests()
    gw = GatewayDaemon(
        WORLD, backend="cpu",
        policy=SchedPolicy("fair", mesh_slots=1, tenant_inflight=16,
                           queue_depth=32),
        request_timeout=None, attach_timeout=240.0)
    gw.spec = _spec(wpath)
    gw.jax = (jcfg, jax.tree.map(jnp.asarray, tree))
    try:
        yield gw
    finally:
        gw.close()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def attach(pool, name, **kw):
    from nbdistributed_tpu_torch.gateway.client import TenantClient
    return TenantClient(pool.tenant_host, pool.tenant_port, name,
                        pool_token=pool.pool_token, **kw)


def solo_on_rank0(client, jobs, spec) -> list[list[int]]:
    """The port's solo greedy ``generate`` for ``[(prompt, max_new)]``
    on rank 0, the decode ranks' process family, in the caller's own
    namespace (the serving tenant's cannot run cells)."""
    cell = (spec + "from nbdistributed_tpu_torch.models import "
            "generate as _g\n"
            f"[_g(params, [p], cfg, n)[0, len(p):].tolist() "
            f"for p, n in {jobs!r}]")
    out = client.execute(cell, target_ranks=[0], timeout=300)
    return ast.literal_eval(out["results"]["0"]["output"])


def solo_jax(pool, jobs) -> list[list[int]]:
    jcfg, jparams = pool.jax
    return [[int(t) for t in np.asarray(jax_generate_mod.generate(
        jparams, jnp.asarray(p, jnp.int32)[None], jcfg, n))[0][len(p):]]
        for p, n in jobs]


def wait_results(client, rids, timeout=240.0) -> dict:
    got: dict = {}
    deadline = time.time() + timeout
    while len(got) < len(rids) and time.time() < deadline:
        for rid in rids:
            if rid not in got:
                r = client.serve_result(rid)
                if r.get("done"):
                    got[rid] = r
        time.sleep(0.05)
    return got


def stop_plane(client):
    try:
        client.serve_stop()
    except Exception:
        pass


def check_completed(client, cfg, report, spec):
    from nbdistributed_tpu_torch.serving_fast import synth_schedule
    plan = synth_schedule(cfg)
    comp = [r for r in report["requests"] if r["status"] == "completed"]
    assert comp, report
    jobs = [(plan[r["i"]]["prompt"], plan[r["i"]]["max_new"])
            for r in comp]
    for r, ref in zip(comp, solo_on_rank0(client, jobs, spec)):
        assert r["tokens"] == ref, (r, ref)


# ----------------------------------------------------------------------


def test_loadgen_two_decode_ranks_client_transport(pool):
    from nbdistributed_tpu_torch.serving_fast import (LoadConfig, run_load,
                                                      validate_report)
    from nbdistributed_tpu_torch.serving_fast.loadgen import \
        ClientTransport
    t = attach(pool, "smoke")
    try:
        t.serve_start(pool.spec, max_batch=2, max_len=48, pad_to=4,
                      steps=2, queue_depth=8, inflight=64,
                      decode_ranks=2, kv_block_tokens=8, timeout=600)
        cfg = LoadConfig(rps=3.0, duration_s=3.0, seed=1,
                         prompt_len=(2, 5), max_new=(4, 4),
                         drain_s=120.0, detail=True)
        rep = run_load(ClientTransport(t), cfg)
        validate_report(rep)
        assert rep["hung"] == 0 and rep["failed"] == 0, rep
        assert rep["slo"]["pass"] is True
        check_completed(t, cfg, rep, pool.spec)
        st = t.serve_status()
        assert st["decode_ranks"] == [1, 2], st
        assert st["kv"]["block_tokens"] == 8 and st["dup_dropped"] == 0
    finally:
        stop_plane(t)
        t.close(detach=True)


def test_loadgen_through_the_http_shim(pool):
    from nbdistributed_tpu_torch.serving_fast import (LoadConfig, run_load,
                                                      validate_report)
    from nbdistributed_tpu_torch.serving_fast.loadgen import HTTPTransport
    t = attach(pool, "shimadmin")
    shim = None
    try:
        t.serve_start(pool.spec, max_batch=2, max_len=48, pad_to=4,
                      steps=2, queue_depth=8, inflight=64,
                      decode_ranks=2, kv_block_tokens=8, timeout=600)
        shim = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tools",
                                          "nbd_torch_serve.py"),
             "--run-dir", pool.run_dir, "--port", "0"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        line = shim.stdout.readline()
        assert line.startswith("NBD_SERVE_HTTP ready on 127.0.0.1:"), line
        port = int(line.split()[3].rsplit(":", 1)[1])
        cfg = LoadConfig(rps=3.0, duration_s=2.0, seed=3,
                         prompt_len=(2, 5), max_new=(4, 4),
                         drain_s=120.0, detail=True)
        rep = run_load(HTTPTransport(f"http://127.0.0.1:{port}"), cfg)
        validate_report(rep)
        assert rep["hung"] == 0 and rep["failed"] == 0, rep
        assert rep["completed"] == rep["offered"] > 0, rep
        check_completed(t, cfg, rep, pool.spec)
    finally:
        if shim is not None:
            shim.send_signal(signal.SIGINT)
            assert shim.wait(timeout=30) == 0
        stop_plane(t)
        t.close(detach=True)


def test_overload_sheds_and_rejects_explicitly(pool):
    from nbdistributed_tpu_torch.gateway.client import CellSubmitError
    lo = attach(pool, "lo", priority=0)
    hi = attach(pool, "hi", priority=5)
    try:
        lo.serve_start(pool.spec, max_batch=1, max_len=48, pad_to=4,
                       steps=1, queue_depth=2, inflight=2, timeout=600)
        v0 = lo.serve_submit(PROMPTS[0], 30)
        v1 = lo.serve_submit(PROMPTS[1], 30)
        assert v0["status"] == v1["status"] == "accepted"
        with pytest.raises(CellSubmitError) as exc:
            lo.serve_submit(PROMPTS[2], 30)
        assert exc.value.verdict["status"] == "rejected"
        hi_rids = [hi.serve_submit(pr, 4)["rid"] for pr in PROMPTS[3:5]]
        deadline = time.time() + 60
        while lo.serve_result(v1["rid"]).get("status") != "shed":
            assert time.time() < deadline, lo.serve_status()
            time.sleep(0.05)
        st = lo.serve_status()
        assert st["shed"] >= 1 and st["rejected"] >= 1, st
        got = wait_results(hi, hi_rids)
        assert [got[r]["status"] for r in hi_rids] == ["completed"] * 2
        # The shed verdict reached lo's connection as a terminal push.
        assert lo.serve_result(v1["rid"])["done"] is True
    finally:
        stop_plane(lo)
        lo.close(detach=True)
        hi.close(detach=True)


def test_serving_tenant_mode_refuses_cells(pool):
    from nbdistributed_tpu_torch.gateway.client import CellSubmitError
    admin = attach(pool, "admin")
    srv_kernel = None
    try:
        admin.serve_start(pool.spec, tenant="srvplane", max_batch=2,
                          max_len=48, pad_to=4, timeout=600)
        srv_kernel = attach(pool, "srvplane")
        with pytest.raises(CellSubmitError) as exc:
            srv_kernel.execute("x = 1")
        v = exc.value.verdict
        assert v["status"] == "rejected"
        assert v["reason"] == "serving-tenant"
        assert "%dist_serve" in v["error"]
        with pytest.raises(RuntimeError, match="already running"):
            admin.serve_start(pool.spec, timeout=60)
    finally:
        stop_plane(admin)
        if srv_kernel is not None:
            srv_kernel.close(detach=True)
        admin.close(detach=True)


def test_reattach_mid_generation_parks_and_resumes(pool):
    crashy = attach(pool, "crashy")
    watcher = attach(pool, "watcher")
    resumed = None
    try:
        [solo] = solo_on_rank0(watcher, [(PROMPTS[0], 12)], pool.spec)
        crashy.serve_start(pool.spec, max_batch=2, max_len=48, pad_to=4,
                           steps=1, timeout=600)
        rid = crashy.serve_submit(PROMPTS[0], 12)["rid"]
        token = crashy.token
        crashy._ch.close()        # the kernel dies, no goodbye
        got = wait_results(watcher, [rid])
        assert got[rid]["status"] == "completed"
        assert got[rid]["tokens"] == solo
        resumed = attach(pool, "crashy", token=token)
        drained = resumed.drain()
        key = f"serve:{rid}"
        assert key in drained, drained.keys()
        assert drained[key]["tokens"] == solo
        assert resumed.drain() == {}                 # exactly once
        s = resumed.serve_stream(rid, 3)
        assert s["tokens"] == solo[3:] and s["done"]
        assert resumed.serve_status()["resumed"] >= 1
    finally:
        stop_plane(resumed or watcher)
        watcher.close(detach=True)
        if resumed is not None:
            resumed.close(detach=True)
        try:
            crashy.close()
        except Exception:
            pass


def test_chunked_prefill_keeps_short_stream_alive(pool):
    t = attach(pool, "chunk")
    try:
        t.serve_start(pool.spec, max_batch=2, max_len=64, pad_to=4,
                      steps=1, queue_depth=8, inflight=8,
                      decode_ranks=1, kv_block_tokens=8, prefill_chunk=4,
                      timeout=600)
        short_p, short_n = [5, 9, 2], 30
        long_p, long_n = [((7 * i) % 50) + 1 for i in range(56)], 4
        rid_s = t.serve_submit(short_p, short_n)["rid"]
        deadline = time.time() + 60
        while not t.serve_result(rid_s).get("tokens"):
            assert time.time() < deadline
            time.sleep(0.02)
        before = len(t.serve_result(rid_s)["tokens"])
        rid_l = t.serve_submit(long_p, long_n)["rid"]
        progressed = 0
        while time.time() < deadline:
            rl = t.serve_result(rid_l)
            n_short = len(t.serve_result(rid_s)["tokens"])
            if not rl.get("tokens") and n_short > before:
                progressed = n_short - before
            if rl.get("tokens") or rl.get("done"):
                break
            time.sleep(0.01)
        assert progressed > 0, "short stream starved during the prefill"
        got = wait_results(t, [rid_s, rid_l])
        refs = solo_on_rank0(t, [(short_p, short_n), (long_p, long_n)],
                             pool.spec)
        assert got[rid_s]["tokens"] == refs[0]
        assert got[rid_l]["tokens"] == refs[1]
        assert t.serve_status()["dup_dropped"] == 0
    finally:
        stop_plane(t)
        t.close(detach=True)


def test_stage_attribution_and_metrics_consistency(pool):
    from nbdistributed_tpu_torch.observability import metrics as obs_metrics
    from nbdistributed_tpu_torch.observability.servingobs import \
        SERVE_STAGES
    from nbdistributed_tpu_torch.serving_fast import (LoadConfig, run_load,
                                                      validate_report)
    from nbdistributed_tpu_torch.serving_fast.loadgen import \
        ClientTransport

    def metric(prefix):
        for ln in obs_metrics.registry().prometheus_text().splitlines():
            if ln.startswith(prefix):
                return float(ln.rsplit(" ", 1)[1])
        return 0.0

    def counters():
        return {v: metric('nbd_serve_requests_total'
                          f'{{tenant="serve",verdict="{v}"}}')
                for v in ("accepted", "shed", "rejected")}

    t = attach(pool, "latpin")
    try:
        t.serve_start(pool.spec, max_batch=2, max_len=48, pad_to=4,
                      steps=2, queue_depth=8, inflight=64,
                      decode_ranks=2, kv_block_tokens=8, timeout=600)
        before = counters()
        cfg = LoadConfig(rps=3.0, duration_s=2.0, seed=7,
                         prompt_len=(2, 5), max_new=(4, 4), drain_s=120.0)
        rep = run_load(ClientTransport(t), cfg)
        validate_report(rep)
        assert rep["completed"] > 0 and rep["hung"] == 0, rep
        lat = t.serve_status().get("lat") or {}
        finished = [r for r in lat.get("records") or []
                    if r["status"] in ("completed", "failed")]
        assert len(finished) >= rep["completed"]
        for r in finished:
            total = sum(r["stages"][s] for s in SERVE_STAGES)
            assert abs(total - r["e2e_s"]) <= 1e-3, r
            ttft = (r["stages"]["admit"] + r["stages"]["queue"]
                    + r["stages"]["kv_alloc"] + r["stages"]["prefill"])
            assert abs(ttft - r["ttft_s"]) <= 1e-3, r
            assert all(r["stages"][s] >= 0.0 for s in SERVE_STAGES), r
        after = counters()
        for v in ("accepted", "shed", "rejected"):
            assert after[v] - before[v] == rep[v], (v, before, after, rep)
        n = metric('nbd_serve_stage_seconds_count'
                   '{stage="decode",tenant="latpin"}')
        assert n == len(finished), (n, len(finished))
    finally:
        stop_plane(t)
        t.close(detach=True)


def test_sigkill_non_zero_decode_rank_streams_equal_solo(pool):
    t1 = attach(pool, "t1")
    try:
        jobs = [(p, MAX_NEW) for p in PROMPTS]
        solo = solo_on_rank0(t1, jobs, pool.spec)
        assert solo == solo_jax(pool, jobs)
        t1.serve_start(pool.spec, max_batch=4, max_len=48, pad_to=4,
                       steps=1, queue_depth=32, inflight=32, timeout=600)
        rids = [t1.serve_submit(p, MAX_NEW)["rid"] for p in PROMPTS[:4]]
        kill = WORLD - 1            # the decode rank; never rank 0
        pool.comm.send_to_ranks([kill], "chaos", {
            "action": "set",
            "spec": {"seed": 5, "kill_rank": kill, "kill_at": 3}},
            timeout=60)
        for p in PROMPTS[4:]:
            rids.append(t1.serve_submit(p, MAX_NEW)["rid"])
            time.sleep(0.05)
        deadline = time.time() + 120
        while t1.serve_status().get("failovers", 0) < 1:
            assert time.time() < deadline, t1.serve_status()
            time.sleep(0.2)
        got = wait_results(t1, rids)
        assert len(got) == len(rids), t1.serve_status()
        for i, rid in enumerate(rids):
            assert got[rid]["status"] == "completed", got[rid]
            assert got[rid]["tokens"] == solo[i], (rid, PROMPTS[i])
        st = t1.serve_status()
        assert st["dup_dropped"] == 0, st
        assert st["replayed"] >= 1 and st["failovers"] >= 1, st
        assert st["decode_rank"] == 1, st
        assert st["completed"] == len(rids) and st["shed"] == 0, st
        assert kill in pool.comm.dead_ranks()
    finally:
        stop_plane(t1)
        t1.close(detach=True)
