"""Generate examples/00_torch_quickstart.ipynb — the quick start of the
PyTorch/CUDA port (``nbdistributed_tpu_torch``), section by section the
JAX package's ``00_quickstart.ipynb`` in torch.

The notebook is written with ``json`` (nbformat 4.5 with deterministic
cell ids), so the generator runs where ``nbformat`` is not installed:
``python examples/make_torch_notebook.py``.
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


md("""# Interactive distributed PyTorch on the GPU — quick start

The end-to-end acceptance scenario of `nbdistributed_tpu_torch`, the
PyTorch/CUDA port: bring up a worker cluster from the notebook, run
plain cells on every rank with streamed per-rank output, target single
ranks with `%%rank`, and train a small transformer data-parallel — all
cell by cell, with full REPL semantics.

On a GPU host each worker owns one card (`--backend gpu`, what `auto`
picks when a CUDA card is present) and the ranks join an NCCL process
group; everywhere else `--backend cpu` gives a real multi-process world
with gloo collectives.""")

code("%load_ext nbdistributed_tpu_torch")

code("""\
import os
import tempfile
# The demo runs anywhere: pick the backend from the environment so CI
# can force cpu. On a GPU host "auto" selects the cards (one a rank).
backend = os.environ.get("NBD_NOTEBOOK_BACKEND", "auto")
nw = int(os.environ.get("NBD_NOTEBOOK_WORKERS", "2"))
ckpt_dir = os.path.join(tempfile.gettempdir(), "nbd_torch_demo_ckpt")""")

code("%dist_init -n {nw} --backend {backend} -t 300")

md("""## Every cell now runs on all workers

After `%dist_init`, plain cells are transparently dispatched to every
worker (disable with `%dist_mode -d`). Each worker has a persistent
namespace pre-seeded with `rank`, `world_size`, `torch`, `np`, `dist`
(`torch.distributed`, its process group joined), `device` (this rank's
card, or the CPU), functional collectives (`all_reduce`, `all_gather`,
`broadcast`, ...) and the sharding toolkit (`Mesh`, `P`,
`shard_map`).""")

code("""\
x = torch.ones((100, 100), device=device) * (rank + 1)
print(f"rank {rank}: x.sum() = {float(x.sum())}")
x.mean()""")

md("""### Collectives, interactively

`all_reduce` sums across the whole world — each rank contributes its
own `x`, every rank gets the same total back (functional: `x` itself is
not written).""")

code("""\
total = all_reduce(x)
float(total[0, 0])  # sum over ranks of (rank+1) — identical everywhere""")

md("""## `%%rank` — target a subset

Create parameters on rank 0 only, then broadcast them to the world
(the reference README's tensor-parallel warm-up pattern).""")

code("""\
%%rank [0]
gen = torch.Generator(device=device).manual_seed(0)
W = torch.randn((256, 256), generator=gen, device=device) * 0.02
print("created on rank 0 only:", tuple(W.shape))""")

code("""\
if rank != 0:
    W = torch.zeros((256, 256), device=device)
W = broadcast(W, root=0)
float(W.sum())  # identical on every rank after broadcast""")

md("""## Data-parallel training, cell by cell

A tiny Llama-style transformer from the built-in model family (bf16,
flash attention at head dim 32: on a GPU the forward is the
hand-written flash kernel and the backward its two gradient kernels),
trained DDP: each rank computes grads on its own shard of the batch and
all-reduces them — the same loop structure as the reference's
Accelerate demo, written out by hand.""")

code("""\
from nbdistributed_tpu_torch.models import (AdamW, init_params, loss_fn,
                                            param_leaves, tiny_config)

cfg = tiny_config()                          # bf16, use_flash=True
params = init_params(cfg, 0, device=device)  # same init everywhere
for p in param_leaves(params):
    p.requires_grad_(True)
# The port's AdamW (optax.adamw's defaults and update): each bf16 leaf
# is stepped in fp32 and cast once, so tiny steps aren't rounded away.
opt = AdamW(param_leaves(params), lr=3e-4)

def ddp_step(params, opt, batch):
    leaves = param_leaves(params)
    for p in leaves:
        p.grad = None
    loss = loss_fn(params, batch, cfg)
    loss.backward()
    if world_size > 1:
        # The torch.distributed DDP loop: average every gradient over
        # the ranks before the optimizer step.
        for p in leaves:
            p.grad = all_reduce(p.grad, "mean")
        loss = all_reduce(loss.detach(), "mean")
    opt.step()
    return loss.detach()
print("world size:", world_size)""")

code("""\
# Deterministic per-rank data sharding (the seeded batch_iterator):
# every rank builds the SAME shuffled permutation and takes its own
# rows of each global batch — the Accelerate-dataloader role, without
# a dataloader.
full_data = {"tokens": np.random.default_rng(0).integers(
    0, cfg.vocab_size, size=(64, 64)).astype("int64")}
batches = batch_iterator(full_data, batch_size=8, rank=rank,
                         world_size=world_size, seed=0, epochs=None)

def next_batch():
    return {k: torch.as_tensor(v, device=device)
            for k, v in next(batches).items()}""")

code("""\
for step in range(5):
    loss = ddp_step(params, opt, next_batch())
    if rank == 0:
        print(f"step {step}: loss {float(loss):.4f}")""")

md("""### Eval

Every rank evaluates the *same* held-out batch; after DDP the params are
identical on all ranks, so the losses must agree exactly.""")

code("""\
eval_gen = torch.Generator(device=device).manual_seed(999)
eval_batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 64),
                                      generator=eval_gen, device=device)}
with torch.no_grad():
    eval_loss = float(loss_fn(params, eval_batch, cfg))
print(f"rank {rank}: eval loss {eval_loss:.4f}")""")

md("""## Checkpoint / restore

`%dist_checkpoint` snapshots named namespace objects — the params and
the optimizer, moments included — from every rank (atomic per-rank
dirs, bfloat16-exact, a crc32 a leaf); `%dist_restore` writes them back
into the live tensors — the save/resume loop for long interactive
sessions.""")

code("""\
# Fresh checkpoint dirs: a stale one from an earlier run must never be
# silently restored below.
import os, shutil, tempfile
ckpt_dir = os.path.join(tempfile.gettempdir(), "nbd_torch_demo_ckpt")
shutil.rmtree(ckpt_dir, ignore_errors=True)
shutil.rmtree(ckpt_dir + "_bg", ignore_errors=True)""")

code("%dist_checkpoint {ckpt_dir} params opt")

code("""\
# Clobber the params in place, then restore them (the restore writes
# into these tensors, so the optimizer still holds them).
with torch.no_grad():
    for p in param_leaves(params):
        p.zero_()""")

code("%dist_restore {ckpt_dir}")

code("""\
# Restored params must give the exact same eval loss — a silent save
# failure above would surface here as an assertion error.
with torch.no_grad():
    restored_loss = float(loss_fn(params, eval_batch, cfg))
assert restored_loss == eval_loss, (restored_loss, eval_loss)
print(f"rank {rank}: eval after restore {restored_loss:.4f} (exact)")""")

md("""### Background (async) checkpointing

`--background` returns immediately: each tensor is cloned on the
device, and the copy to host and the disk IO run on a side stream and
a worker thread, so the next training cell starts at once.
`%dist_checkpoint --status` polls per rank.""")

code("%dist_checkpoint {ckpt_dir}_bg params opt --background")

code("""\
# Training continues immediately while the save drains...
loss = ddp_step(params, opt, next_batch())
print(f"rank {rank}: trained a step during the save "
      f"(loss {float(loss):.4f})")""")

code("""\
import time
time.sleep(1.0)  # let the background write land for the poll below""")

code("%dist_checkpoint --status")

md("""## Generation

The model family includes a KV-cache decode loop (greedy or sampled):
one prefill, then one token a step through the hand-written
flash-decode kernel on a GPU — here greedy continuations of a toy
prompt on every rank.""")

code("""\
from nbdistributed_tpu_torch.models import generate
prompt = torch.ones((1, 4), dtype=torch.long, device=device) * (rank + 1)
out_tokens = generate(params, prompt, cfg, max_new_tokens=8)
print(f"rank {rank}: {out_tokens[0].tolist()}")""")

md("""## Continuous-batching serving with prefix caching

`DecodeServer` (seeded in every worker namespace) serves staggered
requests from one slot-pool KV cache — every decode step is one shared
batched forward no matter how requests arrive, and greedy outputs match
standalone `generate` per request.  A shared system prompt registered
with `cache_prefix` is prefilled ONCE; matching requests then admit by
one device-to-device copy plus a suffix-only prefill (causal attention
+ absolute RoPE make the copied KV rows exact).""")

code("""\
%%rank [0]
srv = DecodeServer(params, cfg, max_batch=2, max_len=64, pad_to=4)
system_prompt = [7, 3, 9, 1]
srv.cache_prefix(system_prompt)          # prefilled once
ra = srv.submit(system_prompt + [5], 6)  # admits via copy + suffix
rb = srv.submit(system_prompt + [8, 2], 6)
srv.run_until_done()
print("request A:", srv.outputs[ra])
print("request B:", srv.outputs[rb])
solo = generate(params, torch.tensor([system_prompt + [5]], device=device),
                cfg, max_new_tokens=6)[0, 5:].tolist()
assert srv.outputs[ra] == solo, "serving must match solo generate"
print("bit-identical to solo generate:", solo)""")

md("""## Quantized decode: int8 and nibble-packed int4

Decode streams every weight per token, so bytes are throughput:
`quantize_params` stores the matmul weights int8 (half the bf16
stream), `quantize_params4` nibble-packs them into uint8 at exactly
0.5 bytes/weight with per-64-input-group scales.  Both trees serve
through the same `generate`/`DecodeServer` paths via `qlinear`
dispatch.""")

code("""\
%%rank [0]
from nbdistributed_tpu_torch.models import quantize_params, quantize_params4

def tree_mb(t):
    return sum(x.numel() * x.element_size()
               for x in param_leaves(t)) / 1e6

q8, q4 = quantize_params(params), quantize_params4(params)
toks8 = generate(q8, prompt, cfg, max_new_tokens=8)[0].tolist()
toks4 = generate(q4, prompt, cfg, max_new_tokens=8)[0].tolist()
print(f"fp {tree_mb(params):.1f} MB -> int8 {tree_mb(q8):.1f} MB "
      f"-> int4 {tree_mb(q4):.1f} MB")
print("int8 decode:", toks8)
print("int4 decode:", toks4)""")

md("""## Pull model state into the kernel — no pickle

`%dist_pull` / `%dist_push` carry whole params/optimizer trees as a
JSON tree description plus raw tensor buffers — model state crosses
the control plane without pickle, so hardened (`allow_pickle=False`)
deployments lose nothing.""")

code("%dist_pull params --rank 0 --as kernel_params")

md("""## Bring your HuggingFace checkpoint

Any Llama-architecture `transformers` model converts into this
framework's parameter tree — after which the whole GPU path applies
(sharding rules, flash kernels, the generate loop above). Here a tiny
randomly initialized HF Llama proves the round trip inside the
notebook: the converted model's greedy continuation must match HF's
own `generate`.""")

code("""\
import dataclasses
from transformers import LlamaConfig, LlamaForCausalLM
from nbdistributed_tpu_torch.models import params_from_hf, generate

torch.manual_seed(0)
hf_model = LlamaForCausalLM(LlamaConfig(
    vocab_size=128, hidden_size=64, intermediate_size=160,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    max_position_embeddings=256)).eval()
hf_prompt = torch.tensor([[5, 9, 2, 44]])
with torch.no_grad():
    hf_tokens = hf_model.generate(hf_prompt, max_new_tokens=6,
                                  do_sample=False)[0].tolist()

pt_params, pt_cfg = params_from_hf(hf_model, dtype=torch.float32,
                                   device=device)
pt_cfg = dataclasses.replace(pt_cfg, use_flash=False)
pt_tokens = generate(pt_params, torch.tensor([[5, 9, 2, 44]], device=device),
                     pt_cfg, max_new_tokens=6)[0].tolist()
assert pt_tokens == hf_tokens, (pt_tokens, hf_tokens)
print(f"rank {rank}: HF and converted tokens match: {pt_tokens}")""")

md("## Cluster status, timeline, shutdown")

code("%dist_status")

code("%timeline_show")

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
                   "00_torch_quickstart.ipynb")

if __name__ == "__main__":
    with open(OUT, "w", encoding="utf-8") as f:
        f.write(render())
    print("wrote", OUT, "-", len(C), "cells")
