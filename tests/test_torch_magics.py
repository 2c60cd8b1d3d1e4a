"""The port's notebook surface through a real IPython shell: ``%load_ext
nbdistributed_tpu_torch`` and ``%dist_init -n 2 --backend cpu`` (gloo
workers), then the counterparts of the JAX package's magic tests
(``tests/integration/test_magics_e2e.py``), the vetting, async-window
and observability magics, ``%dist_lint self``, and the refusals of
``%dist_init``.

The shell is IPython's process-wide singleton, which another module of
the same pytest process may have used: the fixture takes it with
``start_ipython() or get_ipython()`` and its teardown unloads the
extension (cell hooks and input transformer out of the shell).
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

pytestmark = [pytest.mark.integration]

EXT = "nbdistributed_tpu_torch"


def _shell():
    from IPython.testing.globalipapp import get_ipython, start_ipython
    return start_ipython() or get_ipython()


def _load_port(shell):
    """``%load_ext nbdistributed_tpu_torch``, after unloading the JAX
    package's extension if an earlier module of this process left it
    loaded: a later JAX module's ``%load_ext`` then registers its
    magics again instead of finding the extension loaded and keeping
    this package's."""
    if "nbdistributed_tpu" in shell.extension_manager.loaded:
        shell.run_line_magic("unload_ext", "nbdistributed_tpu")
    shell.run_line_magic("load_ext", EXT)


def _magics():
    from nbdistributed_tpu_torch.magics.magic import DistributedMagics
    return DistributedMagics


def test_extension_replaces_the_jax_magics_and_refuses(capsys):
    """Loading the JAX extension, unloading it and loading the port's
    leaves the port's magics registered under the shared names; with
    no GPU here ``--backend auto`` raises, and the multi-host options
    refuse what cannot launch.  Runs before the cluster fixture."""
    from nbdistributed_tpu_torch.magics.ipython_magics import IPythonMagics
    shell = _shell()
    shell.run_line_magic("unload_ext", EXT)
    shell.run_line_magic("load_ext", "nbdistributed_tpu")
    shell.run_line_magic("unload_ext", "nbdistributed_tpu")
    shell.run_line_magic("load_ext", EXT)
    try:
        out = capsys.readouterr().out
        assert "nbdistributed_tpu_torch loaded." in out
        for name in ("dist_status", "dist_init", "dist_pull"):
            bound = shell.magics_manager.magics["line"][name]
            assert isinstance(bound.__self__, IPythonMagics), name
        for name in ("distributed", "rank"):
            bound = shell.magics_manager.magics["cell"][name]
            assert isinstance(bound.__self__, IPythonMagics), name
        shell.run_line_magic("dist_status", "")
        assert "No cluster" in capsys.readouterr().out
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            shell.run_line_magic("dist_init", "-n 1 --backend auto")
        # The multi-host options refuse what cannot launch, before
        # anything is spawned; a coordinator address alone changes
        # nothing of a one-host world.
        for line, verdict in [
                ("--hosts local,b --backend cpu",
                 "❌ Worker startup failed: coordinator_host '127.0.0.1' "
                 "is loopback but the plan has remote hosts ['b']"),
                ("--agents b=1.2.3.4:5",
                 "❌ --agents requires a --hosts plan naming the agent "
                 "hosts."),
                ("--chips-per-worker 2",
                 "❌ --chips-per-worker 2: a rank owns one GPU here")]:
            shell.run_line_magic("dist_init", f"-n 1 {line}")
            assert verdict in capsys.readouterr().out, line
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            shell.run_line_magic("dist_init",
                                 "-n 1 --coordinator-addr 10.0.0.1")
        assert _magics()._comm is None
    finally:
        shell.run_line_magic("unload_ext", EXT)


def test_metrics_endpoint_knob_starts_and_serves(monkeypatch, capsys):
    """``NBD_METRICS_PORT`` makes ``%dist_init`` serve ``/healthz`` and
    ``/metrics``; ``%dist_shutdown`` closes the endpoint."""
    import json
    import socket
    import urllib.request
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    shell = _shell()
    _load_port(shell)
    try:
        monkeypatch.setenv("NBD_METRICS_PORT", str(port))
        shell.run_line_magic("dist_init", "-n 1 --backend cpu")
        assert (f"📈 scrape endpoint: http://127.0.0.1:{port}/metrics"
                in capsys.readouterr().out)
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["alive"] == [0]
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            assert 'nbd_heartbeat_staleness_seconds{rank="0"}' in \
                r.read().decode()
        shell.run_line_magic("dist_shutdown", "")
        assert _magics()._metrics_httpd is None
        with pytest.raises(OSError):
            urllib.request.urlopen(f"{base}/healthz", timeout=5)
    finally:
        shell.run_line_magic("dist_shutdown", "")
        shell.run_line_magic("unload_ext", EXT)


@pytest.fixture(scope="module")
def ip():
    shell = _shell()
    _load_port(shell)
    shell.run_line_magic(
        "dist_init", "-n 2 --backend cpu --attach-timeout 180 -t 120")
    assert _magics()._comm is not None, "cluster failed to start"
    yield shell
    shell.run_line_magic("dist_shutdown", "")
    shell.run_line_magic("unload_ext", EXT)


def run(ip, code):
    return ip.run_cell(code)


def test_init_banner_names_the_torch_namespace(ip, capsys):
    """The banner of the fixture's %dist_init, re-rendered: the
    reference's torch namespace, the vetting and async magics (the
    self-lint among them), and the multi-host options; no magic is
    left that raises for want of a port."""
    from nbdistributed_tpu_torch.magics.magic import _BANNER
    text = _BANNER.format(n=2, backend="cpu", secs=1.0)
    assert text.startswith("✅ 2 workers ready (backend=cpu, attach 1.0s).")
    for name in ("torch, np, dist", "device, gpu_id", "DecodeServer",
                 "%dist_wait", "%dist_lint warn|strict|off",
                 "%dist_watchdog", "%dist_doctor", "--deadline S",
                 "%dist_heal [--restore ckpt]", "%dist_supervise",
                 "%dist_postmortem [--last]", "%dist_guard",
                 "%dist_attach [RUN_DIR]", "%dist_pool start|status|stop|",
                 "%dist_gc [--dry-run]", "resize|template|migrate",
                 "%dist_serve start|submit|result|stream|",
                 "%dist_init --hosts/--agents/--coordinator-addr",
                 "%dist_lint warn|strict|off|status|effects|deps|self"):
        assert name in text
    assert "Not ported" not in text and "A5.7" not in text
    assert "jax" not in text.lower() and "A5.4" not in text
    assert "A5.5" not in text
    assert "(A5.6)" not in text and "A5.6b" not in text


def test_plain_cell_auto_distributes(ip, capsys):
    run(ip, "auto_val = rank * 5 + 1\nauto_val")
    out = capsys.readouterr().out
    assert "Rank 0:\n1\n" in out and "Rank 1:\n6\n" in out


def test_rank_magic_targets_subset(ip, capsys):
    run(ip, "%%rank [1]\n'only-one'")
    out = capsys.readouterr().out
    assert "Rank 1" in out and "only-one" in out
    assert "Rank 0:" not in out


def test_rank_magic_bad_spec_reports(ip, capsys):
    run(ip, "%%rank [9]\n1+1")
    out = capsys.readouterr().out
    assert "out of range" in out


def test_collective_subset_warning(ip, capsys):
    # Reference a collective without calling it: actually running one on
    # a subset would genuinely deadlock the group.
    run(ip, "%%rank [0]\nalias = all_reduce")
    out = capsys.readouterr().out
    assert "deadlock" in out.lower()
    run(ip, "%%rank [0]\nno_collective_here = 1")
    assert "deadlock" not in capsys.readouterr().out.lower()


def test_lint_modes(ip, capsys, monkeypatch):
    monkeypatch.setenv("NBD_LINT", "off")
    run(ip, "%%rank [0]\nalias = all_reduce")
    assert "deadlock" not in capsys.readouterr().out.lower()
    # Strict blocks an error-severity subset cell before anything
    # reaches a worker: the marker it would set never exists.
    monkeypatch.setenv("NBD_LINT", "strict")
    run(ip, "%%rank [0]\nstrict_marker = 1\nall_reduce(torch.ones(1))")
    out = capsys.readouterr().out
    assert "[subset-collective]" in out and "NOT dispatched" in out, out
    monkeypatch.setenv("NBD_LINT", "warn")
    run(ip, "'strict_marker' in dir()")
    assert capsys.readouterr().out.count("False") == 2


def test_sync_magic(ip, capsys):
    ip.run_line_magic("sync", "")
    out = capsys.readouterr().out
    assert "✅ All 2 workers synchronized" in out


def test_status_magic(ip, capsys):
    ip.run_line_magic("dist_status", "")
    out = capsys.readouterr().out
    assert "Rank 0" in out and "Rank 1" in out
    assert "running" in out
    assert "backend=cpu" in out
    assert out.count("cpu:0 (cpu) · 2 ranks on gloo") == 2


def test_status_magic_shows_busy_without_stalling(ip, capsys):
    """%dist_status during a long cell must return promptly (busy ranks
    are not probed — their serial loop cannot answer) and report the
    running cell from the heartbeat payload."""
    comm = _magics()._comm
    t = threading.Thread(
        target=lambda: comm.send_to_all(
            "execute", "import time\ntime.sleep(6)\n'slow'",
            timeout=120),
        daemon=True)
    t.start()
    try:
        deadline = time.time() + 30
        while time.time() < deadline:
            pings = [comm.last_ping(r) for r in range(2)]
            if all(p and p[1].get("busy_type") == "execute"
                   for p in pings):
                break
            time.sleep(0.2)
        else:
            raise AssertionError("not all ranks reported busy")
        capsys.readouterr()
        t0 = time.time()
        ip.run_line_magic("dist_status", "")
        elapsed = time.time() - t0
        out = capsys.readouterr().out
        assert "busy: execute running" in out, out
        assert elapsed < 4.0, f"status stalled {elapsed:.1f}s on busy ranks"
    finally:
        t.join(timeout=60)
    assert not t.is_alive()


def test_error_reported_per_rank(ip, capsys):
    run(ip, "if rank == 1:\n    raise ValueError('r1 only')")
    out = capsys.readouterr().out
    assert "❌ Rank 1: r1 only" in out and "Rank 0: r1" not in out


def test_dist_pull_array(ip, capsys):
    run(ip, "pull_me = torch.arange(4.0) * (rank + 1)")
    capsys.readouterr()
    ip.run_line_magic("dist_pull", "pull_me --rank 1 --as pulled")
    out = capsys.readouterr().out
    assert "✅ pulled = tensor(4,) float32 (from rank 1)" in out
    got = ip.user_ns["pulled"]
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert torch.equal(got, torch.arange(4.0) * 2)
    ip.run_line_magic("dist_pull", "pull_me --all --as every")
    assert [v.tolist() for _, v in sorted(ip.user_ns["every"].items())] \
        == [[0, 1, 2, 3], [0, 2, 4, 6]]


def test_dist_pull_bf16_and_numpy(ip, capsys):
    run(ip, "bf = torch.arange(3.0, dtype=torch.bfloat16) + rank\n"
            "host = np.arange(3) * 2")
    ip.run_line_magic("dist_pull", "bf --rank 1")
    ip.run_line_magic("dist_pull", "host")
    out = capsys.readouterr().out
    assert "tensor(3,) bfloat16" in out and "array(3,) int64" in out
    assert ip.user_ns["bf"].dtype == torch.bfloat16
    assert ip.user_ns["bf"].tolist() == [1.0, 2.0, 3.0]
    assert isinstance(ip.user_ns["host"], np.ndarray)


def test_dist_pull_chunked_tensor(ip, capsys, monkeypatch):
    """A value over the threshold streams over the bulk plane and
    still comes back as a tensor."""
    monkeypatch.setenv("NBD_XFER_THRESHOLD_BYTES", "1024")
    run(ip, "big = torch.arange(5000.0) + rank")
    ip.run_line_magic("dist_pull", "big --rank 1")
    out = capsys.readouterr().out
    assert "✅ big = tensor(5000,) float32 (from rank 1) [chunked:" in out
    assert torch.equal(ip.user_ns["big"], torch.arange(5000.0) + 1)


def test_dist_push_array(ip, capsys):
    ip.user_ns["pushed"] = np.full((3,), 9.0, np.float32)
    ip.run_line_magic("dist_push", "pushed")
    capsys.readouterr()
    run(ip, "(float(pushed.sum()), type(pushed).__name__)")
    out = capsys.readouterr().out
    assert out.count("(27.0, 'Tensor')") == 2
    ip.user_ns["pushed_t"] = torch.ones(2, dtype=torch.bfloat16)
    ip.run_line_magic("dist_push", "pushed_t --ranks [1]")
    assert "✅ pushed pushed_t to ranks [1]" in capsys.readouterr().out
    run(ip, "%%rank [1]\npushed_t.dtype")
    assert "torch.bfloat16" in capsys.readouterr().out


def test_dist_pull_push_params_pytree(ip, capsys):
    """%dist_pull / %dist_push carry a params pytree on the buffer
    path (treedef JSON + leaf bufs, no pickle): structure and tensors
    round-trip kernel <-> workers."""
    run(ip, "tree_var = {'w': torch.arange(6.0).reshape(2, 3),"
            " 'b': {'scale': torch.ones(3) * (rank + 1), 'step': 4}}")
    capsys.readouterr()
    ip.run_line_magic("dist_pull", "tree_var --rank 1 --as tree_pulled")
    out = capsys.readouterr().out
    assert "pytree (dict)" in out
    got = ip.user_ns["tree_pulled"]
    assert torch.equal(got["w"], torch.arange(6.0).reshape(2, 3))
    assert torch.equal(got["b"]["scale"], torch.ones(3) * 2)
    assert got["b"]["step"] == 4
    ip.user_ns["tree_back"] = got
    ip.run_line_magic("dist_push", "tree_back")
    capsys.readouterr()
    run(ip, "float(tree_back['b']['scale'].sum())")
    out = capsys.readouterr().out
    assert out.count("6.0") == 2      # rank-1's values landed on both


def test_ide_proxies_after_distributed_cell(ip):
    run(ip, "proxy_target = torch.zeros((5, 6))")
    p = ip.user_ns.get("proxy_target")
    assert isinstance(p, torch.Tensor) and p.device.type == "meta"
    assert tuple(p.shape) == (5, 6)


def test_dist_mode_toggle_runs_locally(ip, capsys):
    ip.run_line_magic("dist_mode", "-d")
    capsys.readouterr()
    run(ip, "local_only = 'kernel'\nprint('ran locally')")
    out = capsys.readouterr().out
    assert "ran locally" in out
    assert "Rank" not in out
    assert ip.user_ns["local_only"] == "kernel"
    ip.run_line_magic("dist_mode", "")
    assert "Auto-distributed mode: OFF" in capsys.readouterr().out
    ip.run_line_magic("dist_mode", "-e")
    assert "Auto-distributed mode ON" in capsys.readouterr().out


def test_magic_cells_not_auto_wrapped(ip, capsys):
    run(ip, "%dist_debug")
    out = capsys.readouterr().out
    assert "world size   : 2" in out


def test_repeat_runs_the_cell_k_times_worker_side(ip, capsys):
    run(ip, "rep_n = 0")
    run(ip, "%%distributed --repeat 5 --until 'rep_n >= 3'\n"
            "rep_n += 1\nrep_n")
    out = capsys.readouterr().out
    assert "🔁 3/5 steps" in out and "stopped early by --until" in out
    run(ip, "%%distributed --until 'x'\n1")
    assert "--until requires --repeat" in capsys.readouterr().out


def test_distributed_strict_option(ip, capsys):
    """``--strict`` runs a clean cell and refuses an error-severity one
    before dispatch (its marker never reaches a worker)."""
    ip.run_cell_magic("distributed", "--strict", "strict_ok = rank + 7")
    run(ip, "strict_ok")
    assert "7" in capsys.readouterr().out
    ip.run_cell_magic("distributed", "--strict",
                      "never_set = 1\nif rank == 0:\n"
                      "    dist.all_reduce(torch.ones(1))")
    out = capsys.readouterr().out
    assert "[rank-conditional-collective]" in out
    assert "⛔ cell NOT dispatched" in out
    run(ip, "'never_set' in dir()")
    assert capsys.readouterr().out.count("False") == 2


def test_distributed_async_option(ip, capsys):
    """``--async`` returns the cell's pending future at once;
    ``%dist_wait`` drains it and the value is on every rank."""
    from nbdistributed_tpu_torch.magics.proxies import CellFuture
    run(ip, "import time")
    capsys.readouterr()
    # The cell sleeps: the drain must find it in flight (a cell whose
    # reply lands before %dist_wait leaves the window empty).
    fut = ip.run_cell_magic("distributed", "--async",
                            "time.sleep(0.5)\n"
                            "async_v = torch.full((2,), rank + 0.5)")
    assert isinstance(fut, CellFuture)
    assert "streamed to ranks [0, 1]" in capsys.readouterr().out
    ip.run_line_magic("dist_wait", "")
    assert "✅ drained 1 cell(s)" in capsys.readouterr().out
    assert fut.state == "done"
    run(ip, "float(async_v.sum())")
    out = capsys.readouterr().out
    assert "1.0" in out and "3.0" in out


def test_distributed_sync_option(ip, capsys):
    """``--sync`` dispatches synchronously (no future); with
    ``--async`` it is refused."""
    assert ip.run_cell_magic("distributed", "--sync", "sync_v = 3") is None
    assert ip.run_cell_magic("distributed", "--async --sync", "1") is None
    assert "choose one of --async / --sync" in capsys.readouterr().out


def test_async_window_knob_streams_cells(ip, capsys, monkeypatch):
    """``NBD_ASYNC_WINDOW`` streams every ``%%distributed`` cell
    through the window; a synchronous cell drains it first."""
    monkeypatch.setenv("NBD_ASYNC_WINDOW", "4")
    fut = ip.run_cell_magic("distributed", "", "knob_v = rank")
    assert fut is not None and "⧗ async cell" in capsys.readouterr().out
    ip.run_cell_magic("distributed", "--sync", "knob_w = knob_v + 1")
    assert fut.done
    monkeypatch.delenv("NBD_ASYNC_WINDOW")
    run(ip, "knob_w")
    out = capsys.readouterr().out
    assert "1" in out and "2" in out


def _trace_pids(path):
    import json
    events = json.loads(path.read_text())["traceEvents"]
    return {e["pid"] for e in events if e.get("ph") == "X"}


@pytest.mark.parametrize("name", [
    "dist_lint", "dist_wait", "dist_chaos", "dist_profile", "dist_trace",
    "dist_metrics", "dist_lat", "dist_top"])
def test_vetting_window_and_observability_magics_run(ip, capsys, name,
                                                      tmp_path):
    """Each magic of the vetting / async / observability slice runs on
    the gloo cluster and reports what it read."""
    if name == "dist_lint":
        ip.run_line_magic("dist_lint", "status")
        assert "🔎 cell vetting: warn" in capsys.readouterr().out
        ip.run_line_magic("dist_lint", "effects")
        assert "effect footprints" in capsys.readouterr().out
        ip.run_line_magic("dist_lint", "deps --dot")
        assert capsys.readouterr().out.startswith("digraph cell_deps")
    elif name == "dist_wait":
        ip.run_line_magic("dist_wait", "")
        assert "✅ async window empty" in capsys.readouterr().out
    elif name == "dist_chaos":
        ip.run_line_magic("dist_chaos", "on --duplicate 0.5 --seed 3")
        assert "💥 chaos ON (both)" in capsys.readouterr().out
        run(ip, "chaos_n = rank + 20")
        ip.run_line_magic("dist_chaos", "off")
        assert "✅ chaos off" in capsys.readouterr().out
        run(ip, "chaos_n")
        out = capsys.readouterr().out
        assert "20" in out and "21" in out
    elif name == "dist_profile":
        ip.run_line_magic("dist_profile", f"start --log-dir {tmp_path}")
        run(ip, "prof_y = torch.ones(8, 8) @ torch.ones(8, 8)")
        ip.run_line_magic("dist_profile", f"stop --log-dir {tmp_path}")
        assert "🔬 profiling stopped" in capsys.readouterr().out
        for r in (0, 1):
            assert (tmp_path / f"rank{r}" / "trace.json").stat().st_size
    elif name == "dist_trace":
        ip.run_line_magic("dist_trace", "start")
        run(ip, "traced = rank")
        path = tmp_path / "trace.json"
        ip.run_line_magic("dist_trace", f"save {path}")
        ip.run_line_magic("dist_trace", "stop")
        assert "load in ui.perfetto.dev" in capsys.readouterr().out
        assert _trace_pids(path) == {-1, 0, 1}
    elif name == "dist_metrics":
        ip.run_line_magic("dist_metrics", "")
        out = capsys.readouterr().out
        assert "📊 coordinator: wire tx/rx" in out
        assert "🔹 rank 0: cells" in out and "🔹 rank 1: cells" in out
    elif name == "dist_lat":
        ip.run_line_magic("dist_lat", "--last 1")
        out = capsys.readouterr().out
        assert "latency observatory" in out and "execute" in out
    else:
        ip.run_line_magic("dist_top", "")
        out = capsys.readouterr().out
        assert "cluster top · 2 workers · backend=cpu" in out
        assert "\n0    ● alive" in out and "\n1    ● alive" in out


def test_dist_lint_self_reports_ten_passes_clean(ip, capsys):
    """``%dist_lint self`` runs the port's ten self-lint passes over
    this checkout and prints each one clean."""
    capsys.readouterr()
    ip.run_line_magic("dist_lint", "self")
    out = capsys.readouterr().out
    assert "framework self-lint — 10 passes over" in out
    for name in ("env-knobs", "codec-headers", "thread-shared-state",
                 "protocol-coverage", "lock-order",
                 "blocking-under-lock", "callback-under-lock",
                 "resource-leak", "bracket-discipline",
                 "shutdown-completeness"):
        assert f"   · {name}: clean" in out, name
    assert "all passes clean ✅" in out


@pytest.mark.parametrize("line", ["status", "start --spec S",
                                  "submit --prompt 1,2", "stop"])
def test_dist_serve_outside_a_pool_says_so(ip, capsys, line):
    """``%dist_serve`` runs on a gateway pool: in a plain ``%dist_init``
    world every subcommand says so, as the JAX magic does, and sends
    nothing."""
    capsys.readouterr()
    ip.run_line_magic("dist_serve", line)
    assert capsys.readouterr().out == (
        "❌ not attached to a gateway pool — %dist_attach --tenant NAME "
        "first (%dist_pool start spawns one)\n")


def test_timeline_records_distributed_cells(ip, capsys):
    run(ip, "tl_probe = 1")
    capsys.readouterr()
    ip.run_line_magic("timeline_show", "")
    out = capsys.readouterr().out
    assert "tl_probe" in out
    assert "distributed" in out and "local" in out


def test_timeline_save(ip, capsys, tmp_path):
    path = tmp_path / "tl.json"
    ip.run_line_magic("timeline_save", str(path))
    out = capsys.readouterr().out
    assert "saved" in out and path.exists()
    ip.run_line_magic("timeline_debug", "")
    assert "timeline:" in capsys.readouterr().out


def test_namespace_info_magic_surface(ip, capsys):
    ip.run_line_magic("dist_sync_ide", "")
    out = capsys.readouterr().out
    assert "synced" in out


def test_checkpoint_and_restore_magics(ip, capsys, tmp_path):
    path = tmp_path / "magic_ck"
    run(ip, "ckm_v = torch.arange(4.0) + rank\nckm_live = ckm_v")
    capsys.readouterr()
    ip.run_line_magic("dist_checkpoint", f"{path} ckm_v")
    out = capsys.readouterr().out
    assert "2 ranks saved" in out and "ckm_v (1 leaves)" in out
    run(ip, "ckm_v.zero_()")
    capsys.readouterr()
    ip.run_line_magic("dist_restore", str(path))
    out = capsys.readouterr().out
    assert "2 ranks restored" in out
    run(ip, "(float(ckm_v[3]), ckm_v is ckm_live)")
    out = capsys.readouterr().out
    assert "(3.0, True)" in out and "(4.0, True)" in out


def test_checkpoint_missing_var_reports_per_rank(ip, capsys, tmp_path):
    ip.run_line_magic("dist_checkpoint",
                      f"{tmp_path / 'ck_missing'} not_a_var")
    out = capsys.readouterr().out
    assert "❌" in out and "not_a_var" in out
    ip.run_line_magic("dist_restore", f"{tmp_path / 'nowhere'}")
    assert "no checkpoint data found" in capsys.readouterr().out


def test_background_checkpoint_and_status(ip, capsys, tmp_path):
    """--background returns immediately; --status polls until every
    rank has said done once; the written checkpoint restores exactly
    and becomes the session's completed checkpoint."""
    path = tmp_path / "magic_ck_bg"
    run(ip, "ckbg_v = torch.arange(6.0) * (rank + 1)")
    capsys.readouterr()
    ip.run_line_magic("dist_checkpoint", f"{path} ckbg_v --background")
    out = capsys.readouterr().out
    assert "background save started" in out
    # Each rank's "done" is reported exactly once (the status poll
    # consumes the handle), and ranks can finish on different polls —
    # accumulate across polls.
    done_total = 0
    for _ in range(100):
        ip.run_line_magic("dist_checkpoint", "--status")
        out = capsys.readouterr().out
        done_total += out.count("done")
        if done_total == 2:
            break
        time.sleep(0.1)
    else:
        raise AssertionError(
            f"background save never finished (saw {done_total} done): "
            f"{out}")
    assert _magics()._last_ckpt_path == str(path)
    ip.run_line_magic("dist_checkpoint", "--status")
    assert capsys.readouterr().out.count("idle") == 2
    run(ip, "ckbg_v = None")
    capsys.readouterr()
    ip.run_line_magic("dist_restore", str(path))
    capsys.readouterr()
    run(ip, "float(ckbg_v[5])")
    out = capsys.readouterr().out
    assert "5.0" in out and "10.0" in out


def test_dist_logs_shows_worker_stdio(ip, capsys):
    run(ip, "import sys; sys.stderr.write('raw-stderr-marker\\n')")
    pm = _magics()._pm
    deadline = time.time() + 10
    while time.time() < deadline:  # poll the drain thread, no fixed sleep
        if "raw-stderr-marker" in pm.io[0].tail(400):
            break
        time.sleep(0.05)
    capsys.readouterr()
    ip.run_line_magic("dist_logs", "")
    out = capsys.readouterr().out
    assert "rank 0 stdio" in out and "rank 1 stdio" in out
    assert "raw-stderr-marker" in out


def test_dist_interrupt_magic_idle(ip, capsys):
    ip.run_line_magic("dist_interrupt", "")
    out = capsys.readouterr().out
    assert "interrupt sent to ranks [0, 1]" in out
    run(ip, "'post-interrupt-alive'")
    out = capsys.readouterr().out
    assert out.count("post-interrupt-alive") == 2


def test_collective_subset_runtime_guard(ip, capsys):
    """Calling a world-collective from a subset cell — via an alias the
    text check cannot see — surfaces a prompt per-rank error (the
    runtime guard raises at CALL time) instead of deadlocking."""
    run(ip, "alias_fn = all_reduce")       # full world: bind, no call
    capsys.readouterr()
    t0 = time.time()
    run(ip, "%%rank [0]\nalias_fn(torch.ones(1))")
    dt = time.time() - t0
    out = capsys.readouterr().out
    assert "strict subset" in out and "deadlock" in out, out
    assert dt < 60, f"guard should raise instantly, took {dt:.0f}s"
    run(ip, "'alive-' + str(rank)")
    out = capsys.readouterr().out
    assert "alive-0" in out and "alive-1" in out


def test_collective_full_world_still_works_and_counts(ip, capsys):
    run(ip, "full_sum = all_reduce(torch.tensor(rank + 1.0))\n"
            "float(full_sum)")
    out = capsys.readouterr().out
    assert out.count("3.0") == 2                 # (0+1) + (1+1)
    from nbdistributed_tpu_torch.runtime import collective_guard
    h = collective_guard.cell_hash(
        "full_sum = all_reduce(torch.tensor(rank + 1.0))\n"
        "float(full_sum)\n")
    assert _magics()._cell_rank_history.get(h) == {0, 1}


def test_timeline_sidecar_flushes_and_hook_embeds(ip, capsys, tmp_path):
    import json

    from nbdistributed_tpu_torch import jupyter_hooks as jh

    nb = tmp_path / "session.ipynb"
    nb.write_text("{}")
    ip.run_line_magic("timeline_sidecar", f"on {nb}")
    capsys.readouterr()
    run(ip, "sidecar_probe = rank + 40\nsidecar_probe")
    capsys.readouterr()
    sc = jh.sidecar_path(str(nb))
    payload = json.loads(open(sc).read())
    assert any("sidecar_probe" in r["code"] for r in payload["records"])
    model = {"type": "notebook", "content": {"metadata": {}}}
    jh.pre_save_hook(model=model, path=str(nb))
    assert model["content"]["metadata"][jh.METADATA_KEY]["records"]
    ip.run_line_magic("timeline_sidecar", "off")
    assert not os.path.exists(sc)
    capsys.readouterr()


def test_status_shows_durable_session_header(ip, capsys):
    ip.run_line_magic("dist_status", "")
    out = capsys.readouterr().out
    assert "🔑 session: run" in out and "epoch 1" in out


def test_session_manifest_written_by_init(ip):
    from nbdistributed_tpu_torch.resilience import session as session_mod
    from nbdistributed_tpu_torch.utils import knobs
    m = session_mod.read_manifest(knobs.get_str("NBD_RUN_DIR"))
    pm = _magics()._pm
    assert m is not None and m["world_size"] == 2
    assert m["pids"] == {str(r): p.pid for r, p in pm.processes.items()}
    assert m["backend"] == "cpu"
    assert m["token"] == _magics()._comm.session_token


def test_shutdown_leaves_no_worker(ip, capsys):
    """The last test: %dist_shutdown stops every worker (no pid left),
    removes the session manifest and the auto transformer."""
    from nbdistributed_tpu_torch.resilience import session as session_mod
    from nbdistributed_tpu_torch.utils import knobs
    pids = [p.pid for p in _magics()._pm.processes.values()]
    ip.run_line_magic("dist_shutdown", "")
    assert "✅ shut down 2 workers" in capsys.readouterr().out
    for pid in pids:
        assert not os.path.exists(f"/proc/{pid}"), pid
    assert session_mod.read_manifest(knobs.get_str("NBD_RUN_DIR")) is None
    assert _magics()._comm is None and not _magics()._auto_active
    run(ip, "after_shutdown = 5")
    assert ip.user_ns["after_shutdown"] == 5        # ran locally
    ip.run_line_magic("sync", "")
    assert "No distributed cluster" in capsys.readouterr().out
