"""The port's self-test (``python -m nbdistributed_tpu_torch.selftest``,
``nbd-torch-selftest``): every check passes on CPU gloo ranks with the
three gates set, ``--backend gpu`` without a CUDA device fails before
anything is spawned, the world's size follows the cards, and the cells
it dispatches vet clean (the counterparts of the JAX package's
``tests/integration/test_selftest.py`` and of
``test_no_error_false_positives_in_selftest_corpus`` /
``test_selftest_corpus_cells_get_non_opaque_reports``).
"""

import ast
import os
import re
import subprocess
import sys

import pytest

from nbdistributed_tpu_torch import selftest
from nbdistributed_tpu_torch.analysis import infer_effects, vet_cell

pytestmark = [pytest.mark.integration]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX self-test's check names, in order ("jax.distributed world
# formed" reads "torch.distributed world formed").
CHECKS = [
    "worker bring-up + readiness handshake",
    "remote execution with REPL echo",
    "torch.distributed world formed",
    "cross-process all_reduce",
    "checkpoint save/restore round-trip",
    "barrier sync",
    "status probe",
    "error isolation (workers survive exceptions)",
    "model stack (flash kernel exact, int8 sampled decode)",
    "batched speculative + sparse MoE + SWA hop plan",
    "continuous-batching server (staggered + speculative == solo)",
    "fault-injection smoke (duplicates absorbed, exactly-once execute)",
    "observability (2-rank traced cell, merged export)",
    "observability (rank metrics registry exports)",
    "observability (flight rings recovered into postmortem bundle)",
    "serving smoke (rank SIGKILL mid-decode; journal replay; exact "
    "greedy streams)",
]


def _env(**kw):
    env = {**os.environ, **kw}
    env.pop("NBD_RUN_DIR", None)
    return env


def test_selftest_passes_every_check_on_cpu_with_all_gates():
    proc = subprocess.run(
        [sys.executable, "-m", "nbdistributed_tpu_torch.selftest",
         "--backend", "cpu"], cwd=REPO,
        env=_env(NBD_SELFTEST_FAULTS="1", NBD_SELFTEST_OBS="1",
                 NBD_SELFTEST_SERVE="1"),
        capture_output=True, text=True, timeout=420)
    out = proc.stdout
    assert proc.returncode == 0, out + proc.stderr
    assert out.splitlines()[0] == ("nbdistributed_tpu_torch self-test: 2 "
                                   "workers, cpu/gloo backend")
    m = re.search(r"(\d+)/(\d+) checks passed", out)
    assert m and m.group(1) == m.group(2) and int(m.group(2)) >= 16, out
    ran = re.findall(r"^  ✅ (.+)$", out, re.M)
    assert ran == CHECKS, out
    # The kernel's plain version on a CPU rank, its error printed.
    k1 = re.search(r"K1 flash_attention fp32 \(1, 96, 4, 32\) on cpu: "
                   r"max abs error (\S+) \(limit 2e-05\), launches 0", out)
    assert k1 and float(k1.group(1)) < 2e-5, out


def test_gpu_backend_without_a_cuda_device_fails_before_any_spawn():
    proc = subprocess.run(
        [sys.executable, "-m", "nbdistributed_tpu_torch.selftest"],
        cwd=REPO, env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert proc.stdout.startswith("❌ nbdistributed_tpu_torch self-test: "
                                  "--backend gpu needs a CUDA device")
    assert "workers" not in proc.stdout and "checks passed" \
        not in proc.stdout


@pytest.fixture
def no_spawn(monkeypatch):
    """Fail the test if a worker or a pool is spawned."""
    from nbdistributed_tpu_torch.gateway import daemon
    from nbdistributed_tpu_torch.manager import process_manager

    def spawned(*a, **k):
        raise AssertionError("a worker was spawned")
    monkeypatch.setattr(process_manager.ProcessManager, "start_workers",
                        spawned)
    monkeypatch.setattr(daemon.GatewayDaemon, "__init__", spawned)


@pytest.mark.parametrize("cards,argv,code,says", [
    (0, [], 2, "--backend gpu needs a CUDA device and this host has none "
               "(torch.cuda.device_count() == 0); pass --backend cpu to "
               "run the self-test on gloo"),
    (2, ["-n", "3"], 2, "-n 3 refused: a gpu rank owns one CUDA card and "
                        "this host has 2"),
    (2, ["--backend", "cpu", "-n", "0"], 2, "-n must be >= 1, got 0"),
], ids=["no-card", "more-ranks-than-cards", "no-rank"])
def test_refusals_come_before_any_spawn(monkeypatch, capsys, no_spawn,
                                        cards, argv, code, says):
    from nbdistributed_tpu_torch.manager import topology
    monkeypatch.setattr(topology, "available_gpus", lambda: cards)
    assert selftest.main(argv) == code
    assert capsys.readouterr().out == (
        f"❌ nbdistributed_tpu_torch self-test: {says}\n")


@pytest.mark.parametrize("backend,cards,n,want", [
    ("cpu", 0, None, 2), ("cpu", 0, 3, 3), ("gpu", 1, None, 1),
    ("gpu", 4, None, 2), ("gpu", 4, 3, 3)])
def test_world_size_follows_the_backend_and_the_cards(monkeypatch, backend,
                                                      cards, n, want):
    from nbdistributed_tpu_torch.manager import topology
    monkeypatch.setattr(topology, "available_gpus", lambda: cards)
    assert selftest._world_size(backend, n) == (want, "")


def test_serve_smoke_on_one_card_is_a_failed_check(monkeypatch, no_spawn):
    from nbdistributed_tpu_torch.manager import topology
    monkeypatch.setattr(topology, "available_gpus", lambda: 1)
    checks = []
    selftest._serve_smoke(lambda *c: checks.append(c), "gpu")
    assert checks == [(
        CHECKS[-1], False, "not run: its pool needs two ranks and a gpu "
        "pool runs one rank a GPU and this host has 1: 2 ranks refused")]


# ----------------------------------------------------------------------
# the cells the self-test dispatches vet clean


def _selftest_cells():
    """Every cell the self-test dispatches: the ``*_cell`` string
    assignments and the literal cells handed to ``send_to_all`` /
    ``send_to_ranks`` / ``outputs``, read from the module's source so
    the corpus cannot drift from the code."""
    with open(selftest.__file__, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    cells = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id.endswith("_cell")
                        for t in node.targets)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            cells.append(node.value.value)
        name = (node.func.attr if isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                else node.func.id if isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name) else None)
        if name in ("send_to_all", "send_to_ranks", "outputs"):
            for arg in node.args:
                if isinstance(arg, ast.Constant) \
                        and isinstance(arg.value, str) \
                        and arg.value not in ("execute", "sync",
                                              "get_status", "checkpoint",
                                              "trace", "metrics", "chaos"):
                    cells.append(arg.value)
    assert len(cells) >= 14
    return cells


def test_no_error_false_positives_in_selftest_corpus():
    bad = []
    for i, src in enumerate(_selftest_cells()):
        res = vet_cell(src, ranks=None, world=2)
        for f in res.errors:
            bad.append(f"selftest cell {i} L{f.line}: [{f.rule}] "
                       f"{f.snippet.strip()}")
    assert not bad, "\n".join(bad)


def test_selftest_corpus_cells_get_non_opaque_reports():
    bad = []
    for i, src in enumerate(_selftest_cells()):
        rep = infer_effects(src)
        if not rep.parsed or rep.opaque:
            bad.append(f"selftest cell {i}: {rep.opaque_reasons}")
    assert not bad, "\n".join(bad)
