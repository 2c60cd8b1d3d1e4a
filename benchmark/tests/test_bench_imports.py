"""Nothing that runs imports JAX or the JAX package: the benchmark's
sources by their import statements, and a run by what ``sys.modules``
holds after it (top-level names compared whole)."""

import ast
import json
import subprocess
import sys

from perfkit import runner, spec

SOURCES = sorted(p for p in spec.BENCH.rglob("*.py")
                 if "tests" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in SOURCES:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(runner.FORBIDDEN), path


def test_the_references_import_nothing_of_the_port():
    for path in (spec.BENCH / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "nbdistributed_tpu_torch" not in tops, path
        assert tops <= {"__future__", "contextlib", "torch"}, path


def test_the_port_name_is_not_the_jax_package_name():
    sys.modules.setdefault("nbdistributed_tpu_torch", sys.modules[__name__])
    assert "nbdistributed_tpu" not in runner.forbidden_modules()


def test_a_run_loads_no_jax():
    code = (
        "import sys, json, time, torch\n"
        "sys.path[:0] = [%r]\n"
        "from conftest import small_train_cell, small_serve_cell, run_small\n"
        "from perfkit import runner\n"
        "for cell, cfg in (small_train_cell(), small_serve_cell()):\n"
        "    line, _ = run_small(cell, cfg, seconds=0.5, trace=True)\n"
        "    assert line['correct']\n"
        "print(json.dumps(runner.forbidden_modules()))\n"
        % str(spec.BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_without_the_port_a_run_fails_and_prints_no_result(tmp_path):
    import shutil
    shutil.copytree(spec.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.SPEC_FILE, tmp_path / "BENCHMARK.json")
    cell = json.loads(spec.SPEC_FILE.read_text())["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "1", "--seconds", "1", "--trace", "0"], capture_output=True,
        text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
