"""Runnable end-to-end self-test: ``python -m nbdistributed_tpu_torch.selftest``
(console script ``nbd-torch-selftest``; a copy of
``nbdistributed_tpu/selftest.py``).

Bring up a worker cluster through the public API, drive the core
capabilities, print a check-by-check report, exit nonzero on any
failure: a smoke test of an installation without pytest or a notebook.
The checks, their order and their names are the JAX package's, except
that "jax.distributed world formed" reads "torch.distributed world
formed"; ``NBD_SELFTEST_FAULTS``, ``NBD_SELFTEST_OBS`` and
``NBD_SELFTEST_SERVE`` gate the same checks.

``--backend gpu`` (the default) runs one worker per CUDA card over
NCCL; with no CUDA device it exits nonzero before anything is spawned
(the CPU is never picked quietly).  ``--backend cpu`` runs gloo workers
on the CPU.  ``-n`` defaults to 2 on the CPU and to the number of
visible cards, capped at 2, on the GPU: a port rank owns one card and
NCCL refuses two ranks of one communicator on one device, so ``-n``
above the card count is refused before any spawn.  The serving smoke
needs a pool of two ranks; on one card it is a failed check that says
so.

The model-stack check calls the flash-attention forward (K1) on fp32
``(1, 96, 4, 32)`` queries against ``(1, 96, 2, 32)`` keys and values
on the rank's device, held to ``attention_reference`` within 2e-5; on
a CUDA rank it also requires ``flash_attention.launches`` to rise by
exactly one, so the kernel ran and not its plain version.  The error
is printed whatever the verdict.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
import tempfile
import time

from .utils import knobs as _knobs

_K1_TOL = 2e-5


def _parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="nbd-torch-selftest",
        description="nbdistributed_tpu_torch end-to-end self-test")
    ap.add_argument("--backend", choices=["gpu", "cpu"], default="gpu",
                    help="gpu: one worker per CUDA card over NCCL (the "
                         "default); cpu: gloo workers on the CPU")
    ap.add_argument("-n", "--num-workers", type=int, default=None,
                    help="workers (default: 2 on the CPU; the visible "
                         "cards, at most 2, on the GPU)")
    return ap.parse_args(argv)


def _world_size(backend: str, n: int | None) -> tuple[int | None, str]:
    """``(n, "")``, or ``(None, why)`` when the world cannot run here.
    Decided before any process is spawned."""
    if n is not None and n < 1:
        return None, f"-n must be >= 1, got {n}"
    if backend == "cpu":
        return (2 if n is None else n), ""
    from .manager import topology
    cards = topology.available_gpus()
    if cards == 0:
        return None, ("--backend gpu needs a CUDA device and this host "
                      "has none (torch.cuda.device_count() == 0); pass "
                      "--backend cpu to run the self-test on gloo")
    if n is None:
        return min(cards, 2), ""
    if n > cards:
        return None, (f"-n {n} refused: a gpu rank owns one CUDA card "
                      f"and this host has {cards}")
    return n, ""


def main(argv: list[str] | None = None) -> int:
    args = _parse_args(argv)
    n, why = _world_size(args.backend, args.num_workers)
    if n is None:
        print(f"❌ nbdistributed_tpu_torch self-test: {why}", flush=True)
        return 2

    from nbdistributed_tpu_torch.manager import (ProcessManager,
                                                 wait_until_ready)
    from nbdistributed_tpu_torch.messaging import CommunicationManager

    backend = args.backend
    ranks = list(range(n))
    checks: list[tuple[str, bool, str]] = []

    def check(name: str, ok: bool, detail: str = "") -> None:
        checks.append((name, ok, detail))
        print(f"  {'✅' if ok else '❌'} {name}"
              + (f" — {detail}" if detail and not ok else ""), flush=True)

    def outputs(code, timeout=60):
        return {r: m.data.get("output") for r, m in comm.send_to_all(
            "execute", code, timeout=timeout).items()}

    group = "nccl" if backend == "gpu" else "gloo"
    where = (f" ({n} of the host's CUDA cards, one a rank)"
             if backend == "gpu" else "")
    print(f"nbdistributed_tpu_torch self-test: {n} worker"
          f"{'s' if n != 1 else ''}, {backend}/{group} backend{where}",
          flush=True)
    comm = CommunicationManager(num_workers=n, timeout=120)
    pm = ProcessManager()
    pm.add_death_callback(lambda r, rc: comm.mark_worker_dead(r))
    try:
        pm.start_workers(n, comm.port, backend=backend)
        wait_until_ready(comm, pm, 180)
        check("worker bring-up + readiness handshake", True)

        out = outputs("rank * 2")
        check("remote execution with REPL echo",
              out == {r: str(r * 2) for r in ranks}, repr(out))

        out = outputs("dist.get_world_size()")
        check("torch.distributed world formed",
              out == {r: str(n) for r in ranks}, repr(out))

        out = outputs("_st_ar = torch.ones(3, device=device) * (rank + 1)\n"
                      "dist.all_reduce(_st_ar)\n"
                      "float(_st_ar[0])", timeout=180)
        want = str(float(n * (n + 1) // 2))
        check("cross-process all_reduce",
              out == {r: want for r in ranks}, repr(out))

        comm.send_to_all("execute",
                         "st_v = torch.arange(4.0, device=device) + rank")
        with tempfile.TemporaryDirectory() as d:
            r1 = comm.send_to_all(
                "checkpoint", {"action": "save", "path": d,
                               "names": ["st_v"]})
            comm.send_to_all("execute", "st_v = None")
            r2 = comm.send_to_all(
                "checkpoint", {"action": "restore", "path": d,
                               "names": None})
            out = outputs("float(st_v[0])")
            ok = (all(m.data.get("status") == "save" for m in r1.values())
                  and all(m.data.get("status") == "restore"
                          for m in r2.values())
                  and out == {r: str(float(r)) for r in ranks})
            check("checkpoint save/restore round-trip", ok, repr(out))

        resp = comm.send_to_all("sync", timeout=60)
        check("barrier sync", all(m.data.get("status") == "synced"
                                  for m in resp.values()))

        resp = comm.send_to_all("get_status", timeout=60)
        check("status probe", all("platform" in m.data or "rank" in m.data
                                  for m in resp.values()))

        resp = comm.send_to_all("execute", "1 / 0")
        ok = all("ZeroDivisionError" in (m.data.get("traceback") or "")
                 for m in resp.values())
        out = outputs("'alive'")
        check("error isolation (workers survive exceptions)",
              ok and out == {r: "'alive'" for r in ranks}, repr(out))

        # Model/kernel stack on rank 0: the flash-attention forward
        # (K1 on a CUDA rank, its plain version on the CPU) against the
        # reference, then an int8 sampled decode.  The tuple ends with
        # the error and the launches, printed below whatever the
        # verdict.
        model_cell = """
from nbdistributed_tpu_torch.ops import attention_reference, flash_attention
from nbdistributed_tpu_torch.models import (tiny_config, init_params,
                                            generate, quantize_params)
_g = torch.Generator(device=device).manual_seed(0)
_q = torch.randn((1, 96, 4, 32), generator=_g, device=device)
_k = torch.randn((1, 96, 2, 32), generator=_g, device=device)
_v = torch.randn((1, 96, 2, 32), generator=_g, device=device)
_n0 = flash_attention.launches
_o = flash_attention(_q, _k, _v, True)
_launched = flash_attention.launches - _n0
_err = float((_o - attention_reference(_q, _k, _v, causal=True))
             .abs().max())
_cfg = tiny_config(dtype=torch.float32, use_flash=False)
_p = quantize_params(init_params(_cfg, 0, device=device))
_tok = generate(_p, torch.zeros((1, 4), dtype=torch.long, device=device),
                _cfg, 4, temperature=0.8, top_k=8,
                generator=torch.Generator(device=device).manual_seed(1),
                kv_quantized=True)
(_err, _launched, device.type, int(_tok.shape[1]) == 8,
 int(_tok.max()) < _cfg.vocab_size)
"""
        # Keep this WELL under the 420 s cap the self-test's test puts
        # on the whole subprocess, so a hung cell fails as a reported
        # check, not a TimeoutExpired.
        r0 = comm.send_to_ranks([0], "execute", model_cell,
                                timeout=120)[0]
        got = _literal(r0.data.get("output"))
        ok = False
        if isinstance(got, tuple) and len(got) == 5:
            err, launched, dev, ok_len, ok_vocab = got
            # A CUDA rank must have launched the kernel exactly once.
            ok_k1 = launched == 1 if dev == "cuda" else launched == 0
            ok = err < _K1_TOL and ok_k1 and ok_len and ok_vocab
        check("model stack (flash kernel exact, int8 sampled decode)", ok,
              repr(r0.data.get("error") or r0.data.get("output")))
        if isinstance(got, tuple) and len(got) == 5:
            print(f"     K1 flash_attention fp32 (1, 96, 4, 32) on "
                  f"{got[2]}: max abs error {got[0]:.3e} (limit "
                  f"{_K1_TOL:g}), launches {got[1]}", flush=True)

        # Batched speculative decoding, sparse MoE dispatch, and the
        # windowed-ring hop plan.
        r3_cell = """
from nbdistributed_tpu_torch.models import (tiny_config, init_params,
                                            generate, speculative_generate)
_cfg = tiny_config(dtype=torch.float32, use_flash=False)
_p = init_params(_cfg, 0, device=device)
_pr = torch.randint(0, _cfg.vocab_size, (2, 5), device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
_sp, _ = speculative_generate(_p, _p, _pr, _cfg, _cfg, 4, gamma=2)
_ok_spec = bool((_sp == generate(_p, _pr, _cfg, 4)).all())
from nbdistributed_tpu_torch.parallel import expert as _ex
_mp = _ex.init_moe_params(torch.Generator(device=device).manual_seed(2),
                          16, 32, 4, dtype=torch.float32)
_x = torch.randn((24, 16), device=device,
                 generator=torch.Generator(device=device).manual_seed(3))
_yd, _ = _ex.moe_ffn(_x, _mp)
_ys, _ = _ex.moe_ffn(_x, _mp, dispatch_mode="sparse")
_ok_moe = float((_yd - _ys).abs().max()) < 1e-5
from nbdistributed_tpu_torch.parallel.ring import hop_plan
_ok_plan = hop_plan(8, 16, 16) == (0, 1)
(_ok_spec, _ok_moe, _ok_plan)
"""
        r0 = comm.send_to_ranks([0], "execute", r3_cell,
                                timeout=120)[0]
        check("batched speculative + sparse MoE + SWA hop plan",
              r0.data.get("output") == "(True, True, True)",
              repr(r0.data.get("error") or r0.data.get("output")))

        # Continuous-batching server: staggered admission into a
        # 2-slot pool must reproduce standalone generate per request.
        serve_cell = """
from nbdistributed_tpu_torch.models import (DecodeServer, tiny_config,
                                            init_params, generate)
_cfg = tiny_config(dtype=torch.float32, use_flash=False)
_p = init_params(_cfg, 0, device=device)
_srv = DecodeServer(_p, _cfg, max_batch=2, max_len=32, pad_to=4)
_r0 = _srv.submit([5, 9, 2], 4)
_srv.step()
_r1 = _srv.submit([7, 1], 3)
_srv.run_until_done(max_steps=50)
def _solo(pr, n):
    o = generate(_p, torch.tensor([pr], device=device), _cfg, n)
    return [int(t) for t in o[0, len(pr):].tolist()]
_dr = init_params(_cfg, 9, device=device)
_ssrv = DecodeServer(_p, _cfg, max_batch=2, max_len=32, pad_to=4,
                     draft_params=_dr, draft_cfg=_cfg, gamma=2)
_r2 = _ssrv.submit([5, 9, 2], 4)
_ssrv.run_until_done(max_steps=20)
(_srv.outputs[_r0] == _solo([5, 9, 2], 4),
 _srv.outputs[_r1] == _solo([7, 1], 3),
 _ssrv.outputs[_r2] == _solo([5, 9, 2], 4))
"""
        r0 = comm.send_to_ranks([0], "execute", serve_cell,
                                timeout=180)[0]
        check("continuous-batching server (staggered + speculative "
              "== solo)",
              r0.data.get("output") == "(True, True, True)",
              repr(r0.data.get("error") or r0.data.get("output")))

        # Fault-injection smoke (gated: NBD_SELFTEST_FAULTS=1).
        # Duplicate-heavy plans on BOTH control-plane directions: the
        # worker replay cache must absorb every redelivered frame so a
        # 10-increment counter lands on exactly 10 per rank.
        # (Duplicate-only because this manager has no retry policy —
        # dropped frames would surface as request timeouts.)
        if _knobs.get_raw("NBD_SELFTEST_FAULTS"):
            from nbdistributed_tpu_torch.resilience.faults import FaultPlan
            comm.send_to_all(
                "chaos", {"action": "set",
                          "spec": {"seed": 7, "duplicate": 0.5}},
                timeout=60)
            comm.set_fault_plan(FaultPlan(seed=8, duplicate=0.5))
            comm.send_to_all("execute", "_ft_n = 0", timeout=60)
            for _ in range(10):
                comm.send_to_all("execute", "_ft_n += 1", timeout=60)
            out = outputs("_ft_n")
            st = comm.send_to_all("get_status", timeout=60)
            dedup = sum(m.data.get("dedup_hits", 0)
                        for m in st.values())
            comm.set_fault_plan(None)
            comm.send_to_all("chaos", {"action": "clear"}, timeout=60)
            check("fault-injection smoke (duplicates absorbed, "
                  "exactly-once execute)",
                  out == {r: "10" for r in ranks},
                  f"{out} dedup_hits={dedup}")

        # Observability smoke (gated: NBD_SELFTEST_OBS=1): trace a
        # cell on every rank end-to-end and assert the merged
        # Chrome-trace export carries spans from the coordinator AND
        # every rank, stitched under one trace id.
        if _knobs.get_raw("NBD_SELFTEST_OBS"):
            from nbdistributed_tpu_torch.observability import \
                export as _obs_exp
            comm.send_to_all("trace", {"action": "start",
                                       "trace_id": "selftest0trace00"},
                             timeout=60)
            comm.tracer.start(trace_id="selftest0trace00")
            comm.send_to_all(
                "execute", "_st_tr = torch.ones(2, device=device)\n"
                           "dist.all_reduce(_st_tr)\n"
                           "float(_st_tr[0])",
                timeout=180)
            comm.tracer.stop()
            dumps = comm.send_to_all("trace", {"action": "dump"},
                                     timeout=60)
            comm.send_to_all("trace", {"action": "stop"}, timeout=60)
            merged = _obs_exp.merge_trace(
                comm.tracer.dump(),
                {r: m.data.get("trace") or {} for r, m in dumps.items()},
                comm.clock.offsets())
            spans = [e for e in merged["traceEvents"]
                     if e.get("ph") == "X"]
            pids = {e["pid"] for e in spans}
            names = {e["name"] for e in spans}
            check("observability (2-rank traced cell, merged export)",
                  {-1, *ranks} <= pids and "handle/execute" in names
                  and any(n.startswith("send/") for n in names),
                  f"pids={sorted(pids)} names={sorted(names)[:8]}")
            m0 = comm.send_to_ranks([0], "metrics", {}, timeout=60)[0]
            mj = m0.data.get("metrics", {})
            check("observability (rank metrics registry exports)",
                  any(k.startswith("nbd_wire_messages_total")
                      for k in mj.get("counters", {})),
                  repr(sorted(mj.get("counters", {}))[:6]))

            # Postmortem sub-check: every process has been
            # flight-recording since bring-up — recover the rings from
            # the run dir, assemble a bundle, and assert the merged
            # trace carries recovered events for the coordinator and
            # every rank (no one had to die for this to work).
            from nbdistributed_tpu_torch.observability import flightrec
            from nbdistributed_tpu_torch.observability import \
                postmortem as _obs_pm
            manifest = _obs_pm.capture(comm, [],
                                       reason="selftest sub-check")
            ok, detail = False, "capture returned None"
            if manifest is not None:
                import json as _json
                with open(os.path.join(manifest["dir"],
                                       "trace.json")) as f:
                    tr = _json.load(f)
                flight = [e for e in tr["traceEvents"]
                          if e.get("cat") == "flight"]
                pids = {e["pid"] for e in flight}
                rings = flightrec.find_rings(
                    _knobs.get_str("NBD_RUN_DIR", ""))
                ok = {-1, *ranks} <= pids and len(rings) >= n + 1
                detail = (f"flight pids={sorted(pids)} "
                          f"rings={len(rings)} dir={manifest['dir']}")
            check("observability (flight rings recovered into "
                  "postmortem bundle)", ok, detail)
    except Exception as e:
        check("harness", False, f"{type(e).__name__}: {e}")
    finally:
        try:
            comm.post(ranks, "shutdown")
            time.sleep(0.3)
        except Exception:
            pass
        pm.shutdown()
        comm.shutdown()

    # Serving smoke (gated: NBD_SELFTEST_SERVE=1): a 2-rank gateway
    # pool serving 3 requests through %dist_serve's wire surface, with
    # one injected rank SIGKILL mid-decode — every accepted request
    # must complete with its exact solo-generate greedy tokens after
    # the journal-replay failover, with zero duplicated emissions.
    # Runs AFTER the main fleet is down (its own pool, its own ports).
    if _knobs.get_raw("NBD_SELFTEST_SERVE"):
        _serve_smoke(check, backend)

    failed = [c for c in checks if not c[1]]
    print(f"\n{len(checks) - len(failed)}/{len(checks)} checks passed",
          flush=True)
    return 1 if failed else 0


def _literal(text):
    try:
        return ast.literal_eval(text or "")
    except (ValueError, SyntaxError):
        return None


_SERVE_NAME = ("serving smoke (rank SIGKILL mid-decode; journal replay; "
               "exact greedy streams)")


def _serve_smoke(check, backend: str = "cpu") -> None:
    from nbdistributed_tpu_torch.gateway.client import TenantClient
    from nbdistributed_tpu_torch.gateway.daemon import (GatewayDaemon,
                                                        gpu_refusal)
    from nbdistributed_tpu_torch.gateway.scheduler import SchedPolicy

    # The pool needs two ranks, and a gpu pool one card a rank.
    why = gpu_refusal(backend, 2)
    if why is not None:
        check(_SERVE_NAME, False, f"not run: its pool needs two ranks "
                                  f"and {why}")
        return
    spec = (
        "from nbdistributed_tpu_torch.models import tiny_config, "
        "init_params\n"
        "cfg = tiny_config(dtype=torch.float32, use_flash=False)\n"
        "params = init_params(cfg, 0, device=device)\n")
    ref_cell = (
        "from nbdistributed_tpu_torch.models import (tiny_config, "
        "init_params, generate)\n"
        "_cfg = tiny_config(dtype=torch.float32, use_flash=False)\n"
        "_p = init_params(_cfg, 0, device=device)\n"
        "_prompts = [[5, 9, 2], [7, 1], [3, 4, 8, 1]]\n"
        "[generate(_p, torch.tensor([pr], device=device), _cfg, 6)"
        "[0, len(pr):].tolist() for pr in _prompts]")
    gw = client = None
    try:
        gw = GatewayDaemon(
            2, backend=backend,
            policy=SchedPolicy("fair", mesh_slots=1,
                               tenant_inflight=8, queue_depth=16),
            request_timeout=None, attach_timeout=240.0,
            watchdog=False)
        client = TenantClient(gw.tenant_host, gw.tenant_port, "st",
                              pool_token=gw.pool_token)
        out = client.execute(ref_cell, timeout=240)
        solo = _literal(
            (out.get("results") or {}).get("0", {}).get("output"))
        # Arm the mid-decode SIGKILL on the decode rank (the highest
        # live rank, 1) BEFORE serving starts: spec execute +
        # serve_open + ticks count toward kill_at, so it dies inside
        # the decode loop.
        gw.comm.send_to_ranks([1], "chaos", {
            "action": "set",
            "spec": {"seed": 3, "kill_rank": 1, "kill_at": 4}},
            timeout=60)
        client.serve_start(spec, max_batch=2, max_len=32, pad_to=4,
                           steps=2, timeout=300)
        prompts = [[5, 9, 2], [7, 1], [3, 4, 8, 1]]
        rids = [client.serve_submit(pr, 6)["rid"] for pr in prompts]
        got: dict[str, tuple] = {}
        deadline = time.time() + 240
        while len(got) < len(rids) and time.time() < deadline:
            for rid in rids:
                if rid in got:
                    continue
                r = client.serve_result(rid)
                if r.get("done"):
                    got[rid] = (r.get("status"), r.get("tokens"))
            time.sleep(0.3)
        st = client.serve_status()
        ok = (solo is not None and len(got) == len(rids)
              and all(got[rid] == ("completed", solo[i])
                      for i, rid in enumerate(rids))
              and st.get("failovers", 0) >= 1
              and st.get("dup_dropped", 0) == 0)
        check(_SERVE_NAME, ok,
              f"got={got} solo={solo} failovers="
              f"{st.get('failovers')} replayed={st.get('replayed')} "
              f"dup={st.get('dup_dropped')}")
    except Exception as e:
        check("serving smoke harness", False,
              f"{type(e).__name__}: {e}")
    finally:
        try:
            if client is not None:
                client.close()
        except Exception:
            pass
        if gw is not None:
            gw.close()


if __name__ == "__main__":
    sys.exit(main())
