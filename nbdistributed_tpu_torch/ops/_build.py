"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface (pointers,
ints, the CUDA stream; it returns the ``cudaGetLastError()`` code of
its launch) and is compiled on its own by ``nvcc`` for ``sm_90a`` into
a shared library under ``build/nbd_torch_kernels/`` at the root of the
checkout.  The library's file name carries a hash of its source and of
the shared headers (``csrc/*.cuh``), so an edited kernel is rebuilt and
a stale one is never loaded.
:func:`build_all` starts one ``nvcc`` per source at once and waits for
all of them.  Nothing here runs at import time: the CPU tests import
every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nbd_torch_kernels"
KERNELS = ("flash_attention", "flash_attention_bwd", "flash_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are compiled from "
        f"{CSRC} at first use and need the CUDA toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    # A source's hash covers the headers it may include (csrc/*.cuh).
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_log(name: str) -> str:
    """What nvcc printed for ``name`` (``-Xptxas -v``: registers,
    shared memory and spills per kernel), or '' if not built here."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names=KERNELS) -> dict[str, float]:
    """Compile every kernel in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns seconds spent
    per kernel built; raises with nvcc's output if any build fails."""
    import time

    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    spent, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        spent[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}):\n"
                          f"{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return spent


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def bind(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of kernel library ``name`` with its
    argtypes declared, bound once and cached: a launch after the first
    costs one dict lookup here."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn


def check(code: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch "
                           f"(cudaGetLastError)")
