"""Import hygiene of the PyTorch port: no module of the port, and
neither ``chip_smoke.py`` nor ``chip_kernel_ab.py``, imports JAX (or its
ecosystem) or anything of the JAX package.

The scan reads the source (AST): in a process that already has JAX
loaded, ``sys.modules`` cannot tell who imported it.
"""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "nbdistributed_tpu_torch"
BANNED = {"jax", "jaxlib", "flax", "optax", "nbdistributed_tpu"}
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "chip_kernel_ab.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
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
