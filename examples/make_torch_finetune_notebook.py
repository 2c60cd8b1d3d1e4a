"""Generate examples/02_torch_finetune.ipynb — the reference's flagship
user journey (its ``00_accelerate.ipynb`` cells 10/18/28/36-40) on the
PyTorch/CUDA port (``nbdistributed_tpu_torch``), section by section the
JAX package's ``02_finetune.ipynb`` in torch: load a pretrained
checkpoint, tokenize a dataset, and fine-tune it interactively, cell by
cell, data-parallel across workers.

The checkpoint is built locally at the real SmolLM2-135M architecture
and saved with ``save_pretrained`` (no hub download), so the load ->
convert -> fine-tune path the notebook runs is the one a hub checkpoint
takes.  The corpus is this repository's own documentation,
byte-tokenized.  ``NBD_NOTEBOOK_LAYERS`` sets the checkpoint's depth
(30, SmolLM2-135M's own, by default); the widths never change.

The notebook is written with ``json`` (nbformat 4.5 with deterministic
cell ids), so the generator runs where ``nbformat`` is not installed:
``python examples/make_torch_finetune_notebook.py``.
"""

import json
import os

C = []


def _cell(kind, src):
    cell = {"cell_type": kind, "id": f"cell-{len(C)}", "metadata": {},
            "source": src.splitlines(keepends=True)}
    if kind == "code":
        cell.update(execution_count=None, outputs=[])
    C.append(cell)


def md(src):
    _cell("markdown", src)


def code(src):
    _cell("code", src)


md("""# Fine-tune a checkpoint, interactively — the accelerate journey

The reference framework's flagship demo (`00_accelerate.ipynb`) loads a
pretrained SmolLM2-135M, tokenizes a dataset, and fine-tunes it with
DDP — every step an ordinary notebook cell running on all workers.
This notebook is that journey on the PyTorch/CUDA port: HF checkpoint →
the port's parameter tree (`load_hf_pretrained`), local text corpus →
token rows (`batch_iterator`), cell-by-cell data-parallel fine-tuning
with an explicit gradient `all_reduce`, and generation from the tuned
weights.  On a GPU host every rank owns one card: the forward is the
hand-written flash kernel, the backward its two gradient kernels, and
generation the flash-decode kernel.

> **Checkpoint provenance**: the checkpoint is built locally at the
> exact SmolLM2-135M architecture (`LlamaForCausalLM`, 576 hidden / 30
> layers / 9 heads / 3 KV heads, tied embeddings) and saved with
> `save_pretrained` — the directory the loader consumes has the files
> a hub download of the same model would have, without the network.""")

code("%load_ext nbdistributed_tpu_torch")

code("""\
import os
import tempfile
backend = os.environ.get("NBD_NOTEBOOK_BACKEND", "auto")
nw = int(os.environ.get("NBD_NOTEBOOK_WORKERS", "2"))
# SmolLM2-135M's own depth; only the depth is overridable (the CPU
# tests run 2 layers at the full width).
n_layers = int(os.environ.get("NBD_NOTEBOOK_LAYERS", "30"))
# Overridable so tests use a per-run temp dir (no litter, no races).
ckpt_dir = os.environ.get(
    "NBD_NOTEBOOK_CKPT_DIR",
    os.path.join(tempfile.gettempdir(), "nbd_torch_smol135m_local"))
ck_out = os.environ.get(
    "NBD_NOTEBOOK_CK_OUT",
    os.path.join(tempfile.gettempdir(), "nbd_torch_finetune_ck"))""")

md("""## Build the local checkpoint (stands in for the hub download)

A hub pull would be `AutoModelForCausalLM.from_pretrained(
"HuggingFaceTB/SmolLM2-135M")`; here we construct the identical
architecture with `transformers` and `save_pretrained` it (safetensors,
every `transformers` version's default).  This runs *before*
`%dist_init`, locally in the kernel — exactly where a user would run
their download cell.""")

code("""\
import torch
from transformers import LlamaConfig, LlamaForCausalLM

torch.manual_seed(0)
hf_cfg = LlamaConfig(
    vocab_size=49152, hidden_size=576, intermediate_size=1536,
    num_hidden_layers=n_layers, num_attention_heads=9,
    num_key_value_heads=3, max_position_embeddings=2048,
    rope_theta=100000.0, tie_word_embeddings=True)
model = LlamaForCausalLM(hf_cfg)
n_params = sum(p.numel() for p in model.parameters())
model.save_pretrained(ckpt_dir)
del model
print(f"saved {n_params/1e6:.1f}M-param SmolLM2-135M-architecture "
      f"checkpoint to {ckpt_dir}")""")

code("%dist_init -n {nw} --backend {backend} -t 600")

md("""## Load the checkpoint on every worker

`load_hf_pretrained` converts the `transformers` checkpoint into the
port's parameter tree + `TransformerConfig` on this rank's `device`
(the tied embedding becomes a separate `lm_head = embed.T`, as in the
JAX package); each rank holds a full fp32 replica — data parallelism,
like the reference's Accelerate DDP.""")

code("""\
# (cells now run on the workers: define worker-side paths/imports here
# — the workers inherit the coordinator's environment)
import os
import tempfile
from nbdistributed_tpu_torch.models import param_leaves
ckpt_dir = os.environ.get(
    "NBD_NOTEBOOK_CKPT_DIR",
    os.path.join(tempfile.gettempdir(), "nbd_torch_smol135m_local"))
params, cfg = load_hf_pretrained(ckpt_dir, dtype=torch.float32,
                                 device=device)
n = sum(t.numel() for t in param_leaves(params))
print(f"rank {rank}: loaded {n/1e6:.1f}M params, "
      f"d_model={cfg.d_model}, layers={cfg.n_layers}")""")

md("""## The dataset: real local text, packed into training batches

The reference tokenizes MRPC from the hub; here the corpus is this
repository's own documentation (real English prose), byte-tokenized
(ids 0-255 ⊂ the model's vocabulary) and cut into fixed-length rows.
`batch_iterator` is the shipped per-rank dataloader: every rank builds
it with the same seed and takes its own stride through an identical
permutation — the sharding Accelerate's dataloader wrapper does.""")

code("""\
import numpy as _np
# Corpus files live at the repo root; resolve from the installed
# package so the notebook works from any working directory.
import nbdistributed_tpu_torch as _pkg
repo = os.path.dirname(os.path.dirname(os.path.abspath(_pkg.__file__)))
corpus = ""
for f in ("README.md", "PARITY.md", "SURVEY.md"):
    p = os.path.join(repo, f)
    if os.path.exists(p):
        corpus += open(p, encoding="utf-8").read() + "\\n\\n"
ids = _np.frombuffer(corpus.encode("utf-8"), dtype=_np.uint8)
S = 128
n_rows = len(ids) // S
assert n_rows > 0, f"empty corpus — no docs found under {repo}"
data = _np.asarray(ids[:n_rows * S], dtype=_np.int32).reshape(n_rows, S)
print(f"rank {rank}: {len(ids)} bytes of local text -> "
      f"{n_rows} rows of {S}")""")

md("""## Cell-by-cell DDP fine-tuning

The local gradients come from autograd (through the flash kernels on a
GPU); between the backward and the optimizer step every gradient is
averaged over the ranks with `all_reduce(g, "mean")` — the
`torch.distributed` DDP loop, written out.  `AdamW` is the port's
(`optax.adamw`'s defaults and update).  Every `print` streams back
rank-tagged while the loop runs.""")

code("""\
from nbdistributed_tpu_torch.models import AdamW, loss_fn

B = 2  # per-rank batch
leaves = param_leaves(params)
for p in leaves:
    p.requires_grad_(True)
opt = AdamW(leaves, lr=3e-4)

def ddp_step(params, batch):
    for p in leaves:
        p.grad = None
    loss = loss_fn(params, batch, cfg)
    loss.backward()
    if world_size > 1:
        for p in leaves:
            p.grad = all_reduce(p.grad, "mean")
    opt.step()
    return loss.detach()

print(f"rank {rank}: fine-tune step ready (B={B}/rank, "
      f"global batch {B * world_size})")""")

code("""\
import time
it = batch_iterator({"tokens": data}, batch_size=B, rank=rank,
                    world_size=world_size, seed=0, epochs=None)
losses = []
for step in range(4):
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in next(it).items()}
    t0 = time.time()
    l = ddp_step(params, batch)
    losses.append(float(l))
    print(f"step {step}: loss {float(l):.4f} "
          f"({time.time() - t0:.1f}s)")
print(f"rank {rank}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
      f"({'improved' if losses[-1] < losses[0] else 'NOT improved'})")""")

md("""## Memory-lean loss: chunked-vocab cross-entropy

`ce_chunk=N` makes the loss stream the lm_head in N-column blocks
(`ops/xent.py`): the `(B, S, V)` logits — the buffer that caps the
train batch at LM scale — never materialize, in forward or backward.
Same numbers, a fraction of the memory:""")

code("""\
import dataclasses
cfg_lean = dataclasses.replace(cfg, ce_chunk=8192)
check = {"tokens": torch.as_tensor(data[:2], device=device)}
with torch.no_grad():
    l_full = float(loss_fn(params, check, cfg))
    l_lean = float(loss_fn(params, check, cfg_lean))
print(f"rank {rank}: full-logits loss {l_full:.6f}, "
      f"chunked {l_lean:.6f} (match: {abs(l_full - l_lean) < 1e-4})")""")

md("""## Generate from the fine-tuned weights (rank 0)

`%%rank [0]` targets one worker, like the reference's rank-0
inspection cells.  The prompt is a byte-tokenized string; the greedy
continuation decodes back to text.""")

code("""\
%%rank [0]
from nbdistributed_tpu_torch.models import generate
prompt_text = "The reference "
prompt = torch.as_tensor(
    _np.frombuffer(prompt_text.encode(), dtype=_np.uint8)
    .astype(_np.int64), device=device)[None]
toks = generate(params, prompt, cfg, max_new_tokens=16)
cont = bytes(int(t) for t in toks[0, prompt.shape[1]:]
             if 0 <= int(t) < 256).decode("utf-8", "replace")
print(f"prompt {prompt_text!r} -> continuation {cont!r}")""")

md("""## Checkpoint the fine-tuned state and shut down

`%dist_checkpoint` saves named namespace entries per rank (atomic,
exact round-trip, a crc32 a leaf) — the resume story the reference
leaves to `torch.save` in user cells.""")

code("%dist_checkpoint {ck_out} params")

code("%dist_shutdown")

NOTEBOOK = {
    "cells": C,
    "metadata": {
        "kernelspec": {"display_name": "Python 3", "language": "python",
                       "name": "python3"},
        "language_info": {"name": "python"},
    },
    "nbformat": 4,
    "nbformat_minor": 5,
}


def render() -> str:
    """The notebook's text, as written to disk."""
    return json.dumps(NOTEBOOK, indent=1, ensure_ascii=False) + "\n"


OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "02_torch_finetune.ipynb")

if __name__ == "__main__":
    with open(OUT, "w", encoding="utf-8") as f:
        f.write(render())
    print("wrote", OUT, "-", len(C), "cells")
