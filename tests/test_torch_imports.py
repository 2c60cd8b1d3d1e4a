"""Import hygiene of the PyTorch port: no module of the port, no
``tools/nbd_torch_*.py``, neither ``chip_smoke.py`` nor
``chip_kernel_ab.py``, no ``examples/make_torch_*.py`` and no code cell
of the port's notebooks imports JAX (or its ecosystem) or anything of
the JAX package.

The scan reads the source (AST): in a process that already has JAX
loaded, ``sys.modules`` cannot tell who imported it.
"""

import ast
import importlib
import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "nbdistributed_tpu_torch"
BANNED = {"jax", "jaxlib", "flax", "optax", "nbdistributed_tpu"}
SOURCES = (sorted(PORT.rglob("*.py"))
           + sorted((ROOT / "tools").glob("nbd_torch_*.py"))
           + [ROOT / "chip_smoke.py", ROOT / "chip_kernel_ab.py"]
           + sorted((ROOT / "examples").glob("make_torch_*.py")))
NOTEBOOKS = sorted((ROOT / "examples").glob("0*_torch_*.ipynb"))


def _imported_roots(path: pathlib.Path, text: str | None = None) -> set[str]:
    roots = set()
    text = path.read_text() if text is None else text
    for node in ast.walk(ast.parse(text, str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr",
                          getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            roots.add(node.args[0].value.split(".")[0])
    return roots


def test_port_sources_exist():
    assert len(SOURCES) > 10 and all(p.exists() for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    assert not (_imported_roots(path) & BANNED), path


def test_notebooks_exist():
    assert [p.name for p in NOTEBOOKS] == [
        "00_torch_quickstart.ipynb", "01_torch_parallelism.ipynb",
        "02_torch_finetune.ipynb"]


@pytest.mark.parametrize("path", NOTEBOOKS, ids=[p.name for p in NOTEBOOKS])
def test_no_jax_imports_in_notebook_cells(path):
    """Each code cell, its magic lines dropped (a ``%%rank`` header, a
    line magic), scanned as Python."""
    cells = ["".join(c["source"]) for c in json.loads(path.read_text())[
        "cells"] if c["cell_type"] == "code"]
    for i, src in enumerate(cells):
        code = "\n".join(line for line in src.splitlines()
                         if not line.lstrip().startswith("%"))
        assert not (_imported_roots(path, code) & BANNED), (path, i)


def test_scanner_catches_banned_forms(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\n"
                   "from nbdistributed_tpu.ops import x\n"
                   "import importlib\n"
                   "importlib.import_module('optax')\n"
                   "from nbdistributed_tpu_torch import ops\n")
    assert _imported_roots(src) & BANNED == {"jax", "nbdistributed_tpu",
                                             "optax"}


def test_every_port_module_imports_without_cuda():
    """Importing builds nothing and needs no GPU, nvcc or triton."""
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        importlib.import_module(".".join(parts))


def _c_signature(cu: pathlib.Path, fn: str) -> list:
    """ctypes types of the parameters of ``extern "C" int fn(...)``."""
    import ctypes
    import re

    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", cu.read_text())
    types = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        types.append(ctypes.c_void_p if "*" in param
                     else ctypes.c_float if param.startswith("float ")
                     else ctypes.c_int if param.startswith("int ")
                     else None)
    return types


def test_decode_group_limit_matches_kernel():
    """The decode wrapper's MAX_GROUP is the kernel's kMaxGroup, so the
    wrapper refuses exactly the groups the kernel cannot hold."""
    import re

    from nbdistributed_tpu_torch.ops import decode
    src = (PORT / "ops" / "csrc" / "flash_decode.cu").read_text()
    m = re.search(r"constexpr int kMaxGroup = (\d+);", src)
    assert m and int(m.group(1)) == decode.MAX_GROUP


# The wrapper module's ARGTYPES attribute of each C entry point.
_ARGTYPES_ATTR = {"nbd_flash_attention_bwd_dq": "DQ_ARGTYPES",
                  "nbd_flash_attention_bwd_dkv": "DKV_ARGTYPES"}


@pytest.mark.parametrize("module,source,fn", [
    ("attention", "flash_attention.cu", "nbd_flash_attention_fwd"),
    ("decode", "flash_decode.cu", "nbd_flash_decode"),
    ("attention", "flash_attention_bwd.cu", "nbd_flash_attention_bwd_dq"),
    ("attention", "flash_attention_bwd.cu", "nbd_flash_attention_bwd_dkv")])
def test_ctypes_bindings_match_c_signatures(module, source, fn):
    """The wrappers' ctypes argtypes follow the kernels' C entry points
    parameter by parameter (a mismatch passes ints as floats or cuts
    pointers, and shows only on the card)."""
    mod = importlib.import_module(f"nbdistributed_tpu_torch.ops.{module}")
    want = _c_signature(PORT / "ops" / "csrc" / source, fn)
    got = getattr(mod, _ARGTYPES_ATTR.get(fn, "ARGTYPES"))
    assert None not in want and got == want


def test_every_kernel_source_is_built():
    """Every CUDA source is in the build list, and nothing else is."""
    from nbdistributed_tpu_torch.ops import _build
    sources = sorted(p.stem for p in (PORT / "ops" / "csrc").glob("*.cu"))
    assert sorted(_build.KERNELS) == sources


def test_worker_import_is_light():
    """Importing the worker module (as every CPU test process does)
    initialises no CUDA and imports neither ``transformers`` nor JAX;
    run in a fresh interpreter so nothing else has loaded them."""
    import subprocess
    import sys

    code = ("import sys, torch\n"
            "import nbdistributed_tpu_torch.runtime.worker\n"
            "import nbdistributed_tpu_torch.manager.process_manager\n"
            "print(torch.cuda.is_initialized(), "
            "'transformers' in sys.modules, 'jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False", "False"]


def test_package_import_loads_no_notebook_surface():
    """``import nbdistributed_tpu_torch`` loads neither the magics nor
    IPython, and the magics' bodies (``magics/magic.py``) import no
    IPython either: only their binding, ``magics/ipython_magics.py``,
    does.  A fresh interpreter, so nothing else has loaded them."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import nbdistributed_tpu_torch\n"
            "a = sorted(m for m in sys.modules if m.startswith(("
            "'nbdistributed_tpu_torch.', 'IPython')))\n"
            "import nbdistributed_tpu_torch.magics.magic\n"
            "import nbdistributed_tpu_torch.jupyter_hooks\n"
            "print(a, 'IPython' in sys.modules, 'jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "False", "False"]


def test_analysis_modules_load_neither_jax_nor_the_jax_package():
    """The four self-lint modules (``selfcheck``, ``concur``,
    ``lifecycle``, ``cli``) and the self-test import neither JAX nor
    any module of ``nbdistributed_tpu``: a fresh interpreter, so
    nothing else has loaded them."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import nbdistributed_tpu_torch.analysis.selfcheck\n"
            "import nbdistributed_tpu_torch.analysis.concur\n"
            "import nbdistributed_tpu_torch.analysis.lifecycle\n"
            "import nbdistributed_tpu_torch.analysis.cli\n"
            "import nbdistributed_tpu_torch.selftest\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'nbdistributed_tpu')), "
            "'nbdistributed_tpu_torch.analysis.cli' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "True"]
