"""The port's router (``gateway/router.py``) end to end on the CPU, as
the JAX package's ``tests/integration/test_elastic_chaos.py`` holds its
router: two single-rank gloo pools under one runs root.

- ``PoolDirectory.discover`` finds both, ``place`` routes away from the
  loaded source;
- a live migration (export → import → release) of a tenant whose
  serving plane stopped mid-stream: the journal rides along, is staged
  at the destination, and the destination's plane adopts it at its
  start and finishes the stream, equal to solo ``generate``; the
  tenant reattaches there with its token and an epoch no lower; the
  source no longer knows it;
- a dead-source migration: the source daemon gone, its manifest fenced
  to a dead pid, the tenant rebuilt from the manifest and the journal
  on disk, and its unfinished stream finished by the destination's
  next plane.

Both pools' planes serve ``tiny_config`` in float32 from one seed.
"""

import json
import os
import time

import pytest
import torch

pytestmark = [pytest.mark.integration]

PROMPTS = [[5, 9, 2], [7, 1, 4]]
MAX_NEW = 24


def _spec(path):
    return ("import torch as _t\n"
            "_t.set_num_threads(1)\n"
            "from nbdistributed_tpu_torch.models import tiny_config\n"
            "cfg = tiny_config(dtype=_t.float32)\n"
            f"params = _t.load({path!r})\n")


def _mini_pool(run_dir):
    from nbdistributed_tpu_torch.gateway.daemon import GatewayDaemon
    from nbdistributed_tpu_torch.gateway.scheduler import SchedPolicy
    os.environ["NBD_RUN_DIR"] = run_dir
    return GatewayDaemon(
        1, backend="cpu",
        policy=SchedPolicy("fair", mesh_slots=1, tenant_inflight=8,
                           queue_depth=16),
        request_timeout=None, attach_timeout=240.0)


def _attach(gw, name, **kw):
    from nbdistributed_tpu_torch.gateway.client import TenantClient
    return TenantClient(gw.tenant_host, gw.tenant_port, name,
                        pool_token=gw.pool_token, **kw)


def _wait(client, rid, timeout=240.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        r = client.serve_result(rid)
        if r.get("done"):
            return r
        time.sleep(0.05)
    raise AssertionError(f"{rid} never finished: {client.serve_status()}")


def _mid_stream(client, rid, timeout=120.0):
    """Wait until ``rid`` has emitted some but not all of its tokens."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        n = len(client.serve_result(rid).get("tokens") or ())
        if n:
            return n
        time.sleep(0.005)
    raise AssertionError(f"{rid} never started")


def test_tenant_migration_live_and_dead_source(tmp_path_factory):
    from nbdistributed_tpu_torch.gateway import router as router_mod
    from nbdistributed_tpu_torch.gateway.daemon import \
        gateway_manifest_path
    from nbdistributed_tpu_torch.gateway.serving import \
        migrated_journal_path
    from nbdistributed_tpu_torch.models import (generate, init_params,
                                                tiny_config)
    runs_root = str(tmp_path_factory.mktemp("routerroot"))
    run_a = os.path.join(runs_root, "pool-a")
    run_b = os.path.join(runs_root, "pool-b")
    os.makedirs(run_a)
    os.makedirs(run_b)
    cfg = tiny_config(dtype=torch.float32)
    params = init_params(cfg, 0, device="cpu")
    wpath = os.path.join(runs_root, "weights.pt")
    torch.save(params, wpath)
    spec = _spec(wpath)
    solo = [generate(params, [p], cfg, MAX_NEW)[0, len(p):].tolist()
            for p in PROMPTS]
    saved = os.environ.get("NBD_RUN_DIR")
    gw_a = gw_b = None
    try:
        gw_a = _mini_pool(run_a)
        gw_b = _mini_pool(run_b)
        directory = router_mod.PoolDirectory(runs_root)
        assert sorted(directory.discover()) == [run_a, run_b]

        # ---- live path -------------------------------------------
        ta = _attach(gw_a, "mig")
        tok, epoch_a = ta.token, ta.epoch
        ta.serve_start(spec, max_batch=2, max_len=48, pad_to=4,
                       steps=1, queue_depth=8, inflight=8, timeout=600)
        rid = ta.serve_submit(PROMPTS[0], MAX_NEW)["rid"]
        _mid_stream(ta, rid)
        ta.serve_stop()                       # the stream is unfinished
        ta.close()
        placed = directory.place(exclude=run_a)
        assert placed is not None and placed[0] == run_b
        out = router_mod.migrate_tenant("mig", run_a, run_b, force=True)
        assert out["status"] == "migrated", out
        assert out["src_alive"] and out["released"], out
        assert out["journal_moved"], out
        assert os.path.exists(migrated_journal_path(run_b, "mig"))
        assert "mig" not in gw_a.registry.names()

        tb = _attach(gw_b, "mig", token=tok)
        assert tb.token == tok and tb.epoch >= out["epoch"] >= epoch_a
        st = tb.serve_start(spec, max_batch=2, max_len=48, pad_to=4,
                            steps=2, timeout=600)
        assert st["status"] == "serving"
        got = _wait(tb, rid)
        assert got["status"] == "completed"
        assert got["tokens"] == solo[0]
        st = tb.serve_status()
        assert st["replayed"] >= 1 and st["dup_dropped"] == 0, st
        assert not os.path.exists(migrated_journal_path(run_b, "mig"))
        r = tb.execute("40 + 2", target_ranks=[0], timeout=180)
        assert r["results"]["0"]["output"].strip() == "42"
        tb.serve_stop()
        tb.close()

        # ---- dead-source path ------------------------------------
        ta2 = _attach(gw_a, "mig2")
        tok2 = ta2.token
        ta2.serve_start(spec, max_batch=2, max_len=48, pad_to=4,
                        steps=1, timeout=600)
        rid2 = ta2.serve_submit(PROMPTS[1], MAX_NEW)["rid"]
        _mid_stream(ta2, rid2)
        ta2.close()
        mpath = gateway_manifest_path(run_a)
        with open(mpath) as f:
            manifest = json.load(f)
        gw_a.close()                 # a daemon gone, its disk left
        gw_a = None
        manifest["pid"] = 2 ** 22 + 11
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        assert sorted(directory.discover()) == [run_b]
        out2 = router_mod.migrate_tenant("mig2", run_a, run_b)
        assert out2["status"] == "migrated", out2
        assert not out2["src_alive"] and not out2["released"], out2
        assert out2["journal_moved"], out2
        tb2 = _attach(gw_b, "mig2", token=tok2)
        assert tb2.token == tok2
        tb2.serve_start(spec, max_batch=2, max_len=48, pad_to=4,
                        steps=2, timeout=600)
        got2 = _wait(tb2, rid2)
        assert got2["tokens"] == solo[1]
        assert tb2.serve_status()["dup_dropped"] == 0
        tb2.serve_stop()
        tb2.close()
        with pytest.raises(router_mod.MigrationError, match="same pool"):
            router_mod.migrate_tenant("mig2", run_b, run_b)
        with pytest.raises(router_mod.MigrationError,
                           match="no live gateway"):
            router_mod.migrate_tenant("mig2", run_b, run_a)
    finally:
        if saved is None:
            os.environ.pop("NBD_RUN_DIR", None)
        else:
            os.environ["NBD_RUN_DIR"] = saved
        for gw in (gw_b, gw_a):
            if gw is not None:
                try:
                    gw.close()
                except Exception:
                    pass
