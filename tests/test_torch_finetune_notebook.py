"""The port's fine-tune notebook (``examples/02_torch_finetune.ipynb``,
written by ``examples/make_torch_finetune_notebook.py``): the committed
notebook is the generator's output; its cells vet clean (the
counterparts of the JAX package's notebook vetting tests,
``tests/unit/test_analysis.py``); and every code cell runs in order
through a real IPython shell on two gloo ranks with
``NBD_NOTEBOOK_LAYERS=2`` (SmolLM2-135M's full width, 2 of its 30
layers), in per-run temporary directories.

The run is held to ``test_finetune_notebook_journey``
(``tests/integration/test_notebook.py``) and to the JAX package on the
same checkpoint directory: its ``load_hf_pretrained``, the same byte
rows, its ``batch_iterator`` per rank, and four DDP steps in this
process (the two ranks' gradients averaged, ``optax.adamw(3e-4)``, the
plain attention reference).  Held: the parameter count (both packages
keep the tied embedding's ``lm_head = embed.T`` as a leaf of its own,
so the counts are equal), both ranks' batches bitwise, and rank 0's
losses within 1e-5 relative (``tests/test_torch_train.py``'s
tolerance for train steps).
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os

import numpy as np
import pytest

from nbdistributed_tpu_torch.analysis import infer_effects, vet_cell
from nbdistributed_tpu_torch.magics import rankspec

pytestmark = [pytest.mark.integration]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOTEBOOK = os.path.join(REPO, "examples", "02_torch_finetune.ipynb")
EXT = "nbdistributed_tpu_torch"
WORLD = 2
LAYERS = 2
STEPS = 4
LOSS_RTOL = 1e-5

# Run on the ranks just before the training loop: the batches the
# loop draws, recorded as they are drawn.
RECORD_CELL = """\
_drawn = []
_batch_iterator = batch_iterator
def batch_iterator(*args, **kw):
    for b in _batch_iterator(*args, **kw):
        _drawn.append(np.array(b["tokens"]))
        yield b
"""


def _cells():
    with open(NOTEBOOK, encoding="utf-8") as f:
        nb = json.load(f)
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


def test_committed_notebook_is_the_generators_output():
    spec = importlib.util.spec_from_file_location(
        "make_torch_finetune_notebook",
        os.path.join(REPO, "examples", "make_torch_finetune_notebook.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    with open(NOTEBOOK, encoding="utf-8") as f:
        assert f.read() == gen.render()
    nb = json.loads(gen.render())
    assert nb["nbformat"] == 4 and nb["nbformat_minor"] == 5
    assert len({c["id"] for c in nb["cells"]}) == len(nb["cells"])


def _subset_context(src, world):
    first = src.splitlines()[0].strip() if src.strip() else ""
    if first.startswith("%%rank"):
        return rankspec.parse_ranks(first[len("%%rank"):].strip(),
                                    world), world
    return None, world


def test_no_error_false_positives_in_the_finetune_notebook():
    bad = []
    for i, src in enumerate(_cells()):
        ranks, world = _subset_context(src, world=WORLD)
        for f in vet_cell(src, ranks=ranks, world=world).errors:
            bad.append(f"cell {i} L{f.line}: [{f.rule}] "
                       f"{f.snippet.strip()}")
    assert not bad, "\n".join(bad)


def test_finetune_cells_get_non_opaque_reports():
    bad = []
    for i, src in enumerate(_cells()):
        rep = infer_effects(src)
        if not rep.parsed or rep.opaque:
            bad.append(f"cell {i}: {rep.opaque_reasons}")
    assert not bad, "\n".join(bad)


def _run_cell(ip, src):
    """(result, printed text) of one cell through the shell."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = ip.run_cell(src)
    return result, buf.getvalue()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every code cell through IPython's shell (the JAX package's
    extension unloaded) on two gloo ranks; before ``%dist_shutdown``
    rank 0's losses and both ranks' recorded batches are pulled into
    the kernel.  {"cells": [(src, ok, out)], "text", "losses", "drawn",
    "ckpt_dir"}."""
    from IPython.testing.globalipapp import get_ipython, start_ipython

    from nbdistributed_tpu_torch.magics.magic import DistributedMagics

    tmp = tmp_path_factory.mktemp("torch_finetune_nb")
    ckpt_dir = str(tmp / "ckpt")
    cells, got = [], {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NBD_NOTEBOOK_BACKEND", "cpu")
        mp.setenv("NBD_NOTEBOOK_WORKERS", str(WORLD))
        mp.setenv("NBD_NOTEBOOK_LAYERS", str(LAYERS))
        mp.setenv("NBD_NOTEBOOK_CKPT_DIR", ckpt_dir)
        mp.setenv("NBD_NOTEBOOK_CK_OUT", str(tmp / "ck_out"))
        # The ranks' intra-op threads (two ranks share the host), and
        # transformers without its TensorFlow probe: time, not numbers.
        mp.setenv("OMP_NUM_THREADS", "2")
        mp.setenv("USE_TF", "0")
        ip = start_ipython() or get_ipython()
        for ext in ("nbdistributed_tpu", EXT):
            if ext in ip.extension_manager.loaded:
                ip.run_line_magic("unload_ext", ext)
        try:
            for src in _cells():
                if src.startswith("import time\nit = batch_iterator("):
                    res, out = _run_cell(ip, "%%distributed\n"
                                         + RECORD_CELL)
                    assert res.success and "❌" not in out, out
                if src == "%dist_shutdown":
                    for line in (
                            "%%distributed\n_drawn = np.stack(_drawn)\n"
                            "_losses = np.array(losses)\n",
                            "%dist_pull _losses --rank 0 --as _losses0",
                            "%dist_pull _drawn --all --as _drawn_all"):
                        res, out = _run_cell(ip, line)
                        assert res.success and "❌" not in out, out
                    got = {"losses": ip.user_ns.pop("_losses0"),
                           "drawn": ip.user_ns.pop("_drawn_all")}
                res, out = _run_cell(ip, src)
                cells.append((src, res.success, out))
                if not res.success:
                    break
        finally:
            if DistributedMagics._comm is not None:
                DistributedMagics.shutdown_all()
            if EXT in ip.extension_manager.loaded:
                ip.run_line_magic("unload_ext", EXT)
    return {"cells": cells, "ckpt_dir": ckpt_dir,
            "text": "\n".join(out for _, _, out in cells), **got}


def test_finetune_runs_cell_by_cell_on_two_gloo_ranks(run):
    assert len(run["cells"]) == len(_cells())
    for src, ok, out in run["cells"]:
        assert ok, (src, out)
        assert "❌" not in out and "Traceback" not in out, (src, out)
    text = run["text"]
    assert f"✅ {WORLD} workers ready (backend=cpu" in text
    assert "✅ shut down 2 workers" in run["cells"][-1][2]


def test_finetune_notebook_journey(run):
    """``test_finetune_notebook_journey`` (``test_notebook.py``): the
    checkpoint built, loaded on both ranks, the real-text rows made,
    the DDP loss improves, generation produced, state checkpointed."""
    text = run["text"]
    assert "SmolLM2-135M-architecture" in text
    assert "🔹 Rank 0:" in text and "🔹 Rank 1:" in text
    assert "step 0: loss" in text and "step 3: loss" in text
    assert "improved" in text and "NOT improved" not in text
    for r in range(WORLD):
        assert f"rank {r}: loaded " in text
        assert f"rank {r}: fine-tune step ready (B=2/rank, " \
               f"global batch {2 * WORLD})" in text
        assert f"rank {r}: full-logits loss" in text
    assert text.count("(match: True)") == WORLD
    assert "continuation" in text
    assert f"✅ {WORLD} ranks saved" in text
    assert "❌" not in text


def _corpus_rows():
    """The notebook's rows as the JAX notebook's cell makes them (from
    the JAX package's directory: the same checkout root)."""
    import nbdistributed_tpu as jpkg
    root = os.path.dirname(os.path.dirname(os.path.abspath(jpkg.__file__)))
    corpus = ""
    for f in ("README.md", "PARITY.md", "SURVEY.md"):
        p = os.path.join(root, f)
        if os.path.exists(p):
            corpus += open(p, encoding="utf-8").read() + "\n\n"
    ids = np.frombuffer(corpus.encode("utf-8"), dtype=np.uint8)
    n_rows = len(ids) // 128
    return np.asarray(ids[:n_rows * 128], dtype=np.int32).reshape(n_rows,
                                                                  128)


@pytest.fixture(scope="module")
def jax_ref(run):
    """The JAX package on the notebook's checkpoint: its loaded count,
    each rank's batches, and rank 0's losses over four DDP steps with
    the two ranks' gradients averaged (``optax.adamw(3e-4)``, the plain
    attention)."""
    import jax
    import jax.numpy as jnp
    import optax

    from nbdistributed_tpu.models import loss_fn
    from nbdistributed_tpu.models.hf import load_hf_pretrained
    from nbdistributed_tpu.utils.data import batch_iterator

    params, cfg = load_hf_pretrained(run["ckpt_dir"], dtype=jnp.float32)
    cfg = dataclasses.replace(cfg, use_flash=False)
    count = sum(x.size for x in jax.tree_util.tree_leaves(params))
    data = _corpus_rows()
    its = [batch_iterator({"tokens": data}, batch_size=2, rank=r,
                          world_size=WORLD, seed=0, epochs=None)
           for r in range(WORLD)]
    grads = jax.jit(jax.value_and_grad(lambda p, b: loss_fn(p, b, cfg)))
    opt = optax.adamw(3e-4)
    state = opt.init(params)
    losses, drawn = [], [[] for _ in range(WORLD)]
    for _ in range(STEPS):
        outs = []
        for r, it in enumerate(its):
            tokens = next(it)["tokens"]
            drawn[r].append(tokens)
            outs.append(grads(params, {"tokens": jnp.asarray(tokens)}))
        losses.append(float(outs[0][0]))
        g = jax.tree.map(lambda *gs: sum(gs) / WORLD,
                         *[gr for _, gr in outs])
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return {"count": count, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "losses": losses, "drawn": [np.stack(d) for d in drawn]}


def test_loaded_count_matches_jax(run, jax_ref):
    """Both packages keep the tied embedding's ``lm_head`` as its own
    leaf: the port's count is the JAX count (63.7M at 2 layers; 162.8M
    at SmolLM2-135M's 30)."""
    assert (jax_ref["layers"], jax_ref["d_model"]) == (LAYERS, 576)
    want = (f"loaded {jax_ref['count'] / 1e6:.1f}M params, d_model=576, "
            f"layers={LAYERS}")
    for r in range(WORLD):
        assert f"rank {r}: {want}" in run["text"], want


def test_batches_equal_jax_bitwise(run, jax_ref):
    drawn = run["drawn"]
    assert sorted(drawn) == list(range(WORLD))
    for r in range(WORLD):
        got = np.asarray(drawn[r])
        assert got.shape == (STEPS, 2, 128)
        assert got.dtype == jax_ref["drawn"][r].dtype
        assert np.array_equal(got, jax_ref["drawn"][r]), r


def test_rank0_losses_match_jax(run, jax_ref):
    got = np.asarray(run["losses"], np.float64)
    assert got.shape == (STEPS,)
    np.testing.assert_allclose(got, jax_ref["losses"], rtol=LOSS_RTOL)
