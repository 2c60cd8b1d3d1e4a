"""The port's quickstart notebook (``examples/00_torch_quickstart.ipynb``,
written by ``examples/make_torch_notebook.py``): the committed notebook
is the generator's output; every code cell runs in order through a real
IPython shell on two gloo ranks (the HF round trip included, and the
serving cell's assert that ``DecodeServer`` equals solo ``generate``,
which holds exactly on the CPU); and its cells vet clean (the
counterparts of the JAX package's notebook vetting tests).
"""

import importlib.util
import json
import os
import shutil
import tempfile

import pytest

from nbdistributed_tpu_torch.analysis import infer_effects, vet_cell
from nbdistributed_tpu_torch.magics import rankspec

pytestmark = [pytest.mark.integration]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOTEBOOK = os.path.join(REPO, "examples", "00_torch_quickstart.ipynb")
EXT = "nbdistributed_tpu_torch"


def _cells():
    with open(NOTEBOOK, encoding="utf-8") as f:
        nb = json.load(f)
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


def test_committed_notebook_is_the_generators_output():
    spec = importlib.util.spec_from_file_location(
        "make_torch_notebook",
        os.path.join(REPO, "examples", "make_torch_notebook.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    with open(NOTEBOOK, encoding="utf-8") as f:
        assert f.read() == gen.render()
    nb = json.loads(gen.render())
    assert nb["nbformat"] == 4 and nb["nbformat_minor"] == 5
    assert len({c["id"] for c in nb["cells"]}) == len(nb["cells"])


def _subset_context(src, world):
    """A leading ``%%rank [spec]`` arms the subset rule with its ranks,
    as the magic layer does."""
    first = src.splitlines()[0].strip() if src.strip() else ""
    if first.startswith("%%rank"):
        return rankspec.parse_ranks(first[len("%%rank"):].strip(),
                                    world), world
    return None, world


def test_no_error_false_positives_in_the_quickstart():
    bad = []
    for i, src in enumerate(_cells()):
        ranks, world = _subset_context(src, world=2)
        for f in vet_cell(src, ranks=ranks, world=world).errors:
            bad.append(f"cell {i} L{f.line}: [{f.rule}] "
                       f"{f.snippet.strip()}")
    assert not bad, "\n".join(bad)


def test_quickstart_cells_get_non_opaque_reports():
    bad = []
    for i, src in enumerate(_cells()):
        rep = infer_effects(src)
        if not rep.parsed or rep.opaque:
            bad.append(f"cell {i}: {rep.opaque_reasons}")
    assert not bad, "\n".join(bad)


@pytest.fixture
def shell(monkeypatch):
    """IPython's process-wide shell with the JAX package's extension
    unloaded, as ``tests/test_torch_magics.py`` takes it; the
    notebook's first cell loads the port's extension."""
    from IPython.testing.globalipapp import get_ipython, start_ipython
    monkeypatch.setenv("NBD_NOTEBOOK_BACKEND", "cpu")
    monkeypatch.setenv("NBD_NOTEBOOK_WORKERS", "2")
    ip = start_ipython() or get_ipython()
    for ext in ("nbdistributed_tpu", EXT):
        if ext in ip.extension_manager.loaded:
            ip.run_line_magic("unload_ext", ext)
    yield ip
    from nbdistributed_tpu_torch.magics.magic import DistributedMagics
    if DistributedMagics._comm is not None:
        DistributedMagics.shutdown_all()
    if EXT in ip.extension_manager.loaded:
        ip.run_line_magic("unload_ext", EXT)
    ckpt = os.path.join(tempfile.gettempdir(), "nbd_torch_demo_ckpt")
    for d in (ckpt, ckpt + "_bg"):
        shutil.rmtree(d, ignore_errors=True)


def test_quickstart_runs_cell_by_cell_on_two_gloo_ranks(shell, capsys):
    outs = []
    for src in _cells():
        result = shell.run_cell(src)
        out = capsys.readouterr().out
        outs.append(out)
        assert result.success, (src, out, result.error_in_exec
                                or result.error_before_exec)
        assert "❌" not in out, (src, out)
    text = "\n".join(outs)
    assert "✅ 2 workers ready (backend=cpu" in text
    for r in (0, 1):
        # The DDP ranks agree, and the restored params give the exact
        # eval loss.
        assert f"rank {r}: eval after restore" in text
        assert f"rank {r}: HF and converted tokens match" in text
    losses = {line.split("eval loss ")[1] for line in text.splitlines()
              if "eval loss " in line}
    assert len(losses) == 1, losses
    assert "bit-identical to solo generate:" in text
    assert "🔹 Rank 0: done" in text and "🔹 Rank 1: done" in text
    assert "✅ kernel_params = pytree (dict) (from rank 0)" in text
    assert "✅ shut down 2 workers" in outs[-1]
