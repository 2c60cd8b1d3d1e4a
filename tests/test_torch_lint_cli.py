"""``nbd-torch-lint`` (``nbdistributed_tpu_torch/analysis/cli.py``): the
counterparts of the JAX package's CLI cases in
``tests/unit/test_analysis.py`` — the checkout's root, the pinned exit
codes, the json and sarif formats, the dot exports, the shutdown
ledger and the knob table — and the checkout-local launcher
``tools/nbd_torch_lint.py`` run as a user runs it.
"""

import json
import os
import subprocess
import sys

import pytest

from nbdistributed_tpu_torch.analysis import selfcheck
from nbdistributed_tpu_torch.analysis.cli import _repo_root, main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def checkout_lint():
    """The ten passes over this checkout, run once for the module."""
    return selfcheck.run_self_lint(REPO)


@pytest.fixture
def lint_once(monkeypatch, checkout_lint):
    """``--self`` modes read the module's one run of the passes over
    this checkout (the CLI's own code is what these tests drive; the
    launcher test below runs the passes for real)."""
    def run(root):
        assert root == REPO
        return checkout_lint
    monkeypatch.setattr(selfcheck, "run_self_lint", run)


# A rank-conditional collective: the port's vetting's error finding
# (line 3), the JAX tests' HANG_CELL in torch.
HANG_CELL = """\
t = torch.ones(2, device=device)
if rank == 1:
    dist.all_reduce(t)
'done-%d' % rank
"""


def test_cli_repo_root_resolution(tmp_path, monkeypatch):
    assert _repo_root("/explicit/x") == "/explicit/x"
    # This checkout: README.md sits next to the port's package dir.
    assert _repo_root(None) == REPO
    # No checkout anywhere (package parent faked away, cwd bare):
    # --self refuses with a clear exit code instead of flagging every
    # knob as undocumented against a missing README.
    monkeypatch.chdir(tmp_path)
    import nbdistributed_tpu_torch
    monkeypatch.setattr(nbdistributed_tpu_torch, "__file__",
                        str(tmp_path / "site-packages"
                            / "nbdistributed_tpu_torch" / "__init__.py"))
    assert _repo_root(None) is None
    assert main(["--self"]) == 2


def test_cli_exit_codes_pinned(tmp_path, capsys, lint_once):
    # 2: no mode selected (help), unreadable file, --deps-dot sans
    # files.
    assert main([]) == 2
    capsys.readouterr()
    assert main([str(tmp_path / "missing.py")]) == 2
    capsys.readouterr()
    assert main(["--deps-dot"]) == 2
    capsys.readouterr()
    # 0: clean checkout self-lint; clean file.
    assert main(["--self", "--root", REPO]) == 0
    assert capsys.readouterr().out.endswith(
        "nbd-torch-lint --self: all passes clean\n")
    ok = tmp_path / "ok.py"
    ok.write_text("x = 1\n")
    assert main([str(ok)]) == 0
    capsys.readouterr()
    # 1: error-severity cell finding.
    bad = tmp_path / "bad.py"
    bad.write_text(HANG_CELL)
    assert main([str(bad)]) == 1
    assert "[error] [rank-conditional-collective]" in \
        capsys.readouterr().out
    # Highest code wins regardless of argument order.
    missing = str(tmp_path / "missing.py")
    assert main([missing, str(bad)]) == 2
    capsys.readouterr()
    assert main([str(bad), missing]) == 2
    capsys.readouterr()
    # Unparseable: 0 by the never-block contract, 1 under --strict.
    broken = tmp_path / "broken.py"
    broken.write_text("def broken(:\n    pass\n")
    assert main([str(broken)]) == 0
    capsys.readouterr()
    assert main([str(broken), "--strict"]) == 1
    assert "FAILED under --strict" in capsys.readouterr().out


def test_cli_subset_rankspec_arms_the_subset_rule(tmp_path, capsys):
    cell = tmp_path / "subset.py"
    cell.write_text("dist.barrier()\n")
    assert main([str(cell), "--ranks", "[0,2]"]) == 2      # needs --world
    capsys.readouterr()
    assert main([str(cell), "--ranks", "[0,2]", "--world", "4",
                 "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    (entry,) = doc["files"].values()
    assert [f["rule"] for f in entry["findings"]] == ["subset-collective"]


def test_cli_json_format_self_and_files(tmp_path, capsys, lint_once):
    assert main(["--self", "--root", REPO, "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["mode"] == "self" and doc["total"] == 0
    assert doc["exit_code"] == 0 and doc["root"] == REPO
    assert list(doc["passes"]) == [
        "env-knobs", "codec-headers", "thread-shared-state",
        "protocol-coverage", "lock-order", "blocking-under-lock",
        "callback-under-lock", "resource-leak", "bracket-discipline",
        "shutdown-completeness"]
    bad = tmp_path / "bad.py"
    bad.write_text(HANG_CELL)
    assert main([str(bad), "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["mode"] == "files" and doc["exit_code"] == 1
    (entry,) = doc["files"].values()
    assert entry["parsed"] is True
    assert any(f["rule"] == "rank-conditional-collective"
               and f["severity"] == "error" and f["line"] == 3
               for f in entry["findings"])


def test_cli_sarif_self_mode_validates(capsys, lint_once):
    assert main(["--self", "--root", REPO, "--format", "sarif"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["version"] == "2.1.0"
    assert "sarif-2.1.0" in doc["$schema"]
    (run,) = doc["runs"]
    assert run["tool"]["driver"]["name"] == "nbd-torch-lint"
    ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert {"resource-leak", "bracket-discipline",
            "shutdown-completeness", "lock-order", "env-knobs",
            "protocol-coverage"} <= ids
    assert run["results"] == []


def test_cli_sarif_file_mode_findings_and_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(HANG_CELL)
    assert main([str(bad), "--format", "sarif"]) == 1
    doc = json.loads(capsys.readouterr().out)
    (res,) = doc["runs"][0]["results"]
    assert res["ruleId"] == "rank-conditional-collective"
    assert res["level"] == "error"
    loc = res["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"].endswith("bad.py")
    assert loc["region"]["startLine"] == 3
    broken = tmp_path / "broken.py"
    broken.write_text("def broken(:\n")
    assert main([str(broken), "--format", "sarif"]) == 0
    doc = json.loads(capsys.readouterr().out)
    (res,) = doc["runs"][0]["results"]
    assert res["ruleId"] == "not-analyzable" and res["level"] == "note"
    assert main([str(broken), "--format", "sarif", "--strict"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["runs"][0]["results"][0]["level"] == "warning"


def test_cli_lock_graph_and_deps_dot(tmp_path, capsys):
    assert main(["--lock-graph", "--root", REPO]) == 0
    out = capsys.readouterr().out
    assert out.startswith("digraph lock_order")
    assert "nbd-torch-lint --lock-graph" in out
    a = tmp_path / "a.py"
    b = tmp_path / "b.py"
    a.write_text("x = 1\n")
    b.write_text("y = x + 1\n")
    assert main(["--deps-dot", str(a), str(b)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("digraph cell_deps")
    assert '"c0" -> "c1"' in out and 'label="x"' in out


def test_cli_shutdown_ledger_mode(capsys):
    assert main(["--shutdown-ledger", "--root", REPO]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert "CoordinatorListener" in doc
    assert doc["CoordinatorListener"]["file"].startswith(
        "nbdistributed_tpu_torch/")
    attrs = {r["attr"] for r in doc["CoordinatorListener"]["resources"]}
    assert {"_server", "_wake_r", "_wake_w"} <= attrs


def test_cli_knob_table_is_the_ports_registry(capsys):
    from nbdistributed_tpu_torch.utils import knobs
    assert main(["--knob-table"]) == 0
    out = capsys.readouterr().out
    assert out.strip() == knobs.knob_table_markdown().strip()
    assert "`NBD_NOTEBOOK_BACKEND`" in out


def test_launcher_runs_the_self_lint_from_a_checkout(tmp_path):
    """``python tools/nbd_torch_lint.py --self`` from another directory:
    the launcher finds the checkout and every pass is clean."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "nbd_torch_lint.py"),
         "--self"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[:10] == [f"[{name}] clean" for name in (
        "env-knobs", "codec-headers", "thread-shared-state",
        "protocol-coverage", "lock-order", "blocking-under-lock",
        "callback-under-lock", "resource-leak", "bracket-discipline",
        "shutdown-completeness")]
    assert lines[-1] == "nbd-torch-lint --self: all passes clean"
