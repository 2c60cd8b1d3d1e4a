"""The notebook surface as a whole against the JAX package's: one
transcript of cells, run once through ``%load_ext nbdistributed_tpu``
(2 JAX CPU workers) and once through ``%load_ext
nbdistributed_tpu_torch`` (2 gloo workers), each kernel an IPython shell
in its own subprocess (IPython's shell is a process-wide singleton).
What the two print is compared line for line.

Capture starts after ``%dist_init``: its banner names each package's
own worker namespace and is pinned by ``test_torch_magics.py``.  Both
runs start with ``NBD_LINT=off``; a later section turns the vetting on
with ``%dist_lint warn`` and ``strict``, where both analyzers' findings
(cells in the vocabulary the packages share) print identically, and an
async section streams ``%%distributed --async`` cells, an errored one
among them, drains them with ``%dist_wait`` and by a synchronous cell.
The errored cell runs between two cells that sleep, so every future is
still in flight when IPython echoes it, and the error lands while the
drain waits, never beside another print.  A cell
that differs between the packages is a pair (JAX text, port text);
every other cell is the same text.  One pair builds ``tiny_config`` (float32) from the
same numpy parameters — pushed with ``%dist_push``, carried into the
port by ``models/convert.py`` — and runs greedy ``generate``; the
tokens pulled back with ``%dist_pull`` must be exactly equal.

The normalisations applied to both transcripts before comparing:

- the streamed sections of one cell are merged per rank and put in rank
  order (the ranks' output races to the kernel);
- numbers with a decimal point on the two lines that report times
  (``🔁 … steps in …s`` and ``[chunked: … s]``) become ``<num>``;
- each run's checkpoint directory becomes ``{ck}``;
- ``tensor(`` becomes ``array(``: ``%dist_pull`` describes a pulled
  tensor as ``tensor(shape) dtype`` and a JAX array as ``array(shape)
  dtype``;
- a traceback frame in the framework's own executor names its file
  ``<executor>``: the path names the package.
"""

import json
import os
import pathlib
import pickle
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbdistributed_tpu.models import init_params, tiny_config

pytestmark = [pytest.mark.integration]

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROMPT = [5, 9, 2, 44]
N_NEW = 6

# The kernel of one run: argv = extension, transcript JSON, numpy
# parameters (pickle, written by this test), checkpoint directory.
KERNEL = r'''
import importlib, json, pickle, sys
from IPython.testing.globalipapp import start_ipython
ext, cells_path, params_path, ck = sys.argv[1:5]
ip = start_ipython()
ip.run_line_magic("load_ext", ext)
ip.run_line_magic("dist_init", "-n 2 --backend cpu -t 300 --attach-timeout 240")
with open(params_path, "rb") as f:
    ip.user_ns["np_params"] = pickle.load(f)
print("@@CAPTURE@@", flush=True)
for i, cell in enumerate(json.load(open(cells_path))):
    print(f"@@CELL {i}@@", flush=True)
    ip.run_cell(cell.replace("{ck}", ck))
    sys.stdout.flush()
print("@@TOKENS@@ " + json.dumps(ip.user_ns.get("toks")), flush=True)
# Not %dist_shutdown: the JAX package's pkills every JAX worker on the
# host, other test processes' included.  The polite tier stops this
# kernel's own fleet.
importlib.import_module(ext + ".magics.magic").DistributedMagics.shutdown_all()
'''

_JAX_MODEL = f"""\
from nbdistributed_tpu.models import generate, tiny_config
cfg = tiny_config(dtype=jnp.float32)
params = jax.tree.map(jnp.asarray, np_params)
toks = np.asarray(generate(params, jnp.asarray([{PROMPT}], jnp.int32),
                           cfg, {N_NEW}))[0, {len(PROMPT)}:].tolist()
toks"""
_PORT_MODEL = f"""\
from nbdistributed_tpu_torch.models import generate, tiny_config
from nbdistributed_tpu_torch.models.convert import params_from_jax
cfg = tiny_config(dtype=torch.float32)
params = params_from_jax(np_params, cfg, device=device)
toks = generate(params, torch.tensor([{PROMPT}]), cfg,
                {N_NEW})[0, {len(PROMPT)}:].tolist()
toks"""

TRANSCRIPT = [
    "x = rank * 5 + 1\nx",
    "print(f'hello from {rank} of {world_size}')",
    "%%rank [1]\n'only-one'",
    "%%rank [9]\n1+1",
    "%%rank [0]\nalias = all_reduce",
    "%sync",
    "if rank == 1:\n    raise ValueError('r1 only')",
    "pull_me = np.arange(4.0) * (rank + 1)",
    "%dist_pull pull_me --rank 1 --as pulled",
    ("arr = jnp.arange(4.0) * (rank + 1)",
     "arr = torch.arange(4.0) * (rank + 1)"),
    "%dist_pull arr --rank 1",
    "%dist_pull pull_me --all --as every",
    "%dist_mode -d",
    "import numpy as np\npushed = np.full((3,), 9.0, np.float32)\n"
    "print('local', float(pulled.sum()), sorted(every))",
    "%dist_mode",
    "%dist_mode -e",
    "%dist_push pushed",
    "float(pushed.sum())",
    "%dist_push pushed --ranks [1]",
    "tree_var = {'w': np.arange(6.0).reshape(2, 3),"
    " 'b': {'scale': np.ones(3) * (rank + 1), 'step': 4}}",
    "%dist_pull tree_var --rank 1 --as tree_pulled",
    "ckm_v = np.arange(4.0) + rank",
    "%dist_checkpoint {ck}/a ckm_v",
    "ckm_v = 'clobbered'",
    "%dist_restore {ck}/a",
    "float(ckm_v[3])",
    "%dist_checkpoint {ck}/b not_a_var",
    "%dist_checkpoint {ck}/c",
    "%%distributed --repeat 3\nrep = rank",
    "%%distributed --until 'x'\n1",
    "%dist_push np_params",
    (_JAX_MODEL, _PORT_MODEL),
    "%dist_pull toks",
    "%dist_pull toks --rank 1 --as toks1",
    "import time",
    "%dist_lint warn",
    "%%rank [0]\nalias2 = all_reduce",
    "for i in range(2):\n    print(x)",
    "%dist_lint strict",
    "blocked = 1\nif rank == 0:\n    y = all_reduce(x)",
    "'blocked' in dir()",
    "%dist_lint status",
    "%dist_lint warn",
    "%%distributed --async\ntime.sleep(1.5)\nasync_a = rank + 1",
    "%%distributed --async\nraise ValueError('async boom')",
    "%%distributed --async\ntime.sleep(1.5)\nasync_b = rank * 2",
    "%dist_wait",
    "async_a + async_b",
    "%%distributed --async\ntime.sleep(1.5)\nasync_c = 7",
    "async_c + rank",
    "%dist_wait",
    "%dist_lint off",
]

_HEADER = re.compile(r"^🔹 Rank (\d+):$")
_STATUS = ("✅", "❌", "⚠️", "🔁", "💀", "⏱️", "Traceback", "  File ",
           "@@")


def _merge_sections(lines: list[str]) -> list[str]:
    """Merge each run of streamed ``🔹 Rank N:`` sections per rank, in
    rank order."""
    out, i = [], 0
    while i < len(lines):
        if not _HEADER.match(lines[i]):
            out.append(lines[i])
            i += 1
            continue
        per_rank: dict[int, list[str]] = {}
        while i < len(lines) and _HEADER.match(lines[i]):
            rank = int(_HEADER.match(lines[i]).group(1))
            i += 1
            body = per_rank.setdefault(rank, [])
            while (i < len(lines) and not _HEADER.match(lines[i])
                   and not lines[i].startswith(_STATUS)):
                body.append(lines[i])
                i += 1
        for rank in sorted(per_rank):
            out += [f"🔹 Rank {rank}:"] + per_rank[rank]
    return out


def normalise(text: str, ck: str) -> list[str]:
    lines = []
    for line in text.replace(ck, "{ck}").splitlines():
        if line.startswith("🔁") or "[chunked:" in line:
            line = re.sub(r"\d+\.\d+", "<num>", line)
        line = line.replace("tensor(", "array(")
        line = re.sub(r'File ".*/nbdistributed_tpu(_torch)?/runtime/'
                      r'executor\.py"', 'File "<executor>"', line)
        lines.append(line)
    return _merge_sections(lines)


def _run(ext: str, cells: list[str], params_path: str, tmp, env_extra):
    ck = str(tmp / f"ck_{ext}")
    cells_path = tmp / f"cells_{ext}.json"
    cells_path.write_text(json.dumps(cells))
    env = dict(os.environ, NBD_LINT="off",
               NBD_RUN_DIR=str(tmp / f"run_{ext}"),
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]),
               **env_extra)
    return subprocess.Popen(
        [sys.executable, "-c", KERNEL, ext, str(cells_path), params_path,
         ck], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True), ck


def _killed_from_outside(out: str) -> bool:
    """A JAX worker SIGKILLed by another process: the JAX package's
    ``%dist_shutdown`` in a concurrent test process pkills every
    ``nbdistributed_tpu.runtime.worker`` on the host."""
    return "exited (code -9)" in out


def _transcript(out: str, ck: str) -> tuple[list[str], list]:
    assert "@@CAPTURE@@" in out, out[-3000:]
    body = out.split("@@CAPTURE@@", 1)[1]
    body, tokens = body.split("@@TOKENS@@", 1)
    return normalise(body, ck), json.loads(tokens.splitlines()[0])


def test_jax_and_port_extensions_print_the_same_transcript(tmp_path):
    cfg = tiny_config(dtype=jnp.float32)
    np_params = jax.tree.map(np.asarray,
                             init_params(jax.random.PRNGKey(0), cfg))
    params_path = tmp_path / "params.pkl"
    params_path.write_bytes(pickle.dumps(np_params))
    jax_cells = [c if isinstance(c, str) else c[0] for c in TRANSCRIPT]
    port_cells = [c if isinstance(c, str) else c[1] for c in TRANSCRIPT]
    port, port_ck = _run("nbdistributed_tpu_torch", port_cells,
                         str(params_path), tmp_path, {})
    jx = None
    try:
        for attempt in range(3):
            jx, jax_ck = _run("nbdistributed_tpu", jax_cells,
                              str(params_path), tmp_path,
                              {"JAX_PLATFORMS": "cpu"})
            jax_out = jx.communicate(timeout=400)[0]
            if not _killed_from_outside(jax_out):
                break
        port_out = port.communicate(timeout=400)[0]
    finally:
        for proc in (port, jx):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    assert jx.returncode == 0, jax_out[-3000:]
    assert port.returncode == 0, port_out[-3000:]
    want, want_toks = _transcript(jax_out, jax_ck)
    got, got_toks = _transcript(port_out, port_ck)
    assert got == want
    assert got_toks == want_toks and len(got_toks) == N_NEW
    # The transcript exercised what it names (guards against both runs
    # failing the same way).
    text = "\n".join(got)
    for expected in ("🔹 Rank 1:\n6", "hello from 1 of 2",
                     "out of range for world size 2",
                     "✅ All 2 workers synchronized", "❌ Rank 1: r1 only",
                     "✅ pulled = array(4,) float64 (from rank 1)",
                     "✅ arr = array(4,) float32 (from rank 1)",
                     "local 12.0 [0, 1]", "Auto-distributed mode: OFF",
                     "✅ 2 ranks saved → {ck}/a: ckm_v (1 leaves)",
                     "✅ 2 ranks restored ← {ck}/a",
                     "🔁 3/3 steps", "--until requires --repeat",
                     f"🔹 Rank 1:\n{want_toks}",
                     "✅ toks = pytree (list) (from rank 0)",
                     "[subset-collective-ref]", "[host-sync-in-loop]",
                     "[rank-conditional-collective]",
                     "⛔ cell NOT dispatched", "🔎 cell vetting: strict",
                     "(window 2/4)", "in flight on ranks [0, 1]",
                     "✗ async cell #2: async cell #2 errored — rank 0: "
                     "async boom; rank 1: async boom",
                     "✅ drained 2 cell(s) · 1 errored",
                     "draining async window (1 in flight) — synchronous "
                     "cell", "✅ async window empty · 4 cell(s) "
                     "completed this session, 1 errored"):
        assert expected in text, expected
