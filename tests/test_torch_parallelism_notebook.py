"""The port's parallelism tour (``examples/01_torch_parallelism.ipynb``,
written by ``examples/make_torch_parallelism_notebook.py``): the
committed notebook is the generator's output; its cells vet clean on a
world of four (the counterparts of the JAX package's notebook vetting
tests, ``tests/unit/test_analysis.py``); and every code cell runs in
order through a real IPython shell on four gloo ranks.

The run is held to ``test_parallelism_notebook_strategies_exact``
(``tests/integration/test_notebook.py``) with the cut meshes'
sentences (dp dropped first: sp=4, ep4, sp2×tp2, tp2×sp2), and the
numbers that do not depend on the random init to the JAX notebook's:
the hop plan (computed by the JAX package's ``hop_plan``), "buffer 7
deep", "self-draft mean accepted/round: 3.00" and "sharded 4-way".
"""

import importlib.util
import json
import os

import pytest

from nbdistributed_tpu_torch.analysis import infer_effects, vet_cell
from test_torch_finetune_notebook import _run_cell, _subset_context

pytestmark = [pytest.mark.integration]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOTEBOOK = os.path.join(REPO, "examples", "01_torch_parallelism.ipynb")
EXT = "nbdistributed_tpu_torch"
WORLD = 4


def _cells():
    with open(NOTEBOOK, encoding="utf-8") as f:
        nb = json.load(f)
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_torch_parallelism_notebook",
        os.path.join(REPO, "examples",
                     "make_torch_parallelism_notebook.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


def test_committed_notebook_is_the_generators_output():
    gen = _generator()
    with open(NOTEBOOK, encoding="utf-8") as f:
        assert f.read() == gen.render()
    nb = json.loads(gen.render())
    assert nb["nbformat"] == 4 and nb["nbformat_minor"] == 5
    assert len({c["id"] for c in nb["cells"]}) == len(nb["cells"])
    # The JAX tour's title and sections, each a markdown cell.
    with open(os.path.join(REPO, "examples",
                           "make_parallelism_notebook.py")) as f:
        jax_sections = f.read().count('\nmd("""')
    headings = [c for c in nb["cells"] if c["cell_type"] == "markdown"
                and c["source"][0].startswith("#")]
    assert len(headings) == jax_sections == 21


def test_no_error_false_positives_in_the_parallelism_notebook():
    bad = []
    for i, src in enumerate(_cells()):
        ranks, world = _subset_context(src, world=WORLD)
        for f in vet_cell(src, ranks=ranks, world=world).errors:
            bad.append(f"cell {i} L{f.line}: [{f.rule}] "
                       f"{f.snippet.strip()}")
    assert not bad, "\n".join(bad)


def test_parallelism_cells_get_non_opaque_reports():
    bad = []
    for i, src in enumerate(_cells()):
        rep = infer_effects(src)
        if not rep.parsed or rep.opaque:
            bad.append(f"cell {i}: {rep.opaque_reasons}")
    assert not bad, "\n".join(bad)


@pytest.fixture(scope="module")
def run():
    """Every code cell through IPython's shell (the JAX package's
    extension unloaded) on four gloo ranks: [(src, ok, out)]."""
    from IPython.testing.globalipapp import get_ipython, start_ipython

    from nbdistributed_tpu_torch.magics.magic import DistributedMagics

    cells = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NBD_NOTEBOOK_BACKEND", "cpu")
        mp.setenv("NBD_NOTEBOOK_WORKERS", str(WORLD))
        # Four ranks share the host: one intra-op thread each.
        mp.setenv("OMP_NUM_THREADS", "1")
        ip = start_ipython() or get_ipython()
        for ext in ("nbdistributed_tpu", EXT):
            if ext in ip.extension_manager.loaded:
                ip.run_line_magic("unload_ext", ext)
        try:
            for src in _cells():
                res, out = _run_cell(ip, src)
                cells.append((src, res.success, out))
                if not res.success:
                    break
        finally:
            if DistributedMagics._comm is not None:
                DistributedMagics.shutdown_all()
            if EXT in ip.extension_manager.loaded:
                ip.run_line_magic("unload_ext", EXT)
    return cells


def test_parallelism_runs_cell_by_cell_on_four_gloo_ranks(run):
    assert len(run) == len(_cells())
    for src, ok, out in run:
        assert ok, (src, out)
        assert "❌" not in out and "Traceback" not in out, (src, out)
    text = "\n".join(out for _, _, out in run)
    assert f"✅ {WORLD} workers ready (backend=cpu" in text
    for r in range(WORLD):
        assert f"rank {r} of {WORLD} on cpu" in text
    assert f"✅ shut down {WORLD} workers" in run[-1][2]


def test_parallelism_notebook_strategies_exact(run):
    """``test_parallelism_notebook_strategies_exact`` with the 4-rank
    meshes' sentences, every exactness check true and the exact
    attention, pipeline and packing checks' errors at float rounding:
    the generator's ``CHECKS``, which ``chip_smoke.py --mesh-nccl``
    holds the four-card run to as well."""
    gen = _generator()
    text = "\n".join(out for _, _, out in run)
    assert gen.failed_checks(text) == []
    bounds = {s.split()[0]: b for s, b in gen.CHECKS if b is not None}
    assert bounds == {"ring": 1e-5, "ulysses": 1e-5, "zigzag": 1e-5,
                      "pipeline": 1e-5, "doc0": 1e-4}


def test_static_numbers_equal_the_jax_notebooks(run):
    """What does not depend on the random init: the hop plan (the JAX
    package's ``hop_plan(8, 2048, 4096)``), the 1F1B buffer depth, a
    self-draft's acceptance and the FSDP split."""
    from nbdistributed_tpu.parallel.ring import hop_plan

    text = "\n".join(out for _, _, out in run)
    plan = list(hop_plan(8, 2048, 4096))
    assert (f"SWA ring hop plan (sp=8, S=16K, window=4K): {plan} — "
            f"{len(plan)}/8 hops pay compute+ppermute") in text
    assert "3/8 hops pay compute+ppermute" in text
    assert "(buffer 7 deep, not 8)" in text
    assert "self-draft mean accepted/round: 3.00 (max 3)" in text
    assert "wq bytes/device: 32768 of 131072 (sharded 4-way)" in text
