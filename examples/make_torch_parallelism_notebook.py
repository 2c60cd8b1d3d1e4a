"""Generate examples/01_torch_parallelism.ipynb — a tour of the
parallelism library of the PyTorch/CUDA port (``nbdistributed_tpu_torch``),
section by section the JAX package's ``01_parallelism.ipynb`` in torch.

The JAX tour runs in one process over an 8-device virtual mesh; the
port's meshes are SPMD over processes (one rank a GPU), so this
notebook is cluster-driven: ``%dist_init`` starts the world (4 ranks by
default) and every code cell runs on every rank.  Each JAX mesh is cut
to the 4-rank world by dropping ``dp`` first; each section's markdown
states its cut.

The notebook is written with ``json`` (nbformat 4.5 with deterministic
cell ids), so the generator runs where ``nbformat`` is not installed:
``python examples/make_torch_parallelism_notebook.py``.
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


md("""# Parallelism library tour — dp / tp / ZeRO-1 / sp / pp / ep

Every strategy in `nbdistributed_tpu_torch.parallel`, exercised on a
**4-rank world**: one rank a GPU with NCCL on a GPU host (`--backend
gpu`, what `auto` picks there), four CPU ranks with gloo elsewhere.
The port's meshes are SPMD over processes, as a `torch.distributed`
user writes them: every cell below runs on every rank, each rank holds
only its own shard, and the collectives are explicit.  Notebook 00
covers the interactive workflow; this one is the library reference.

The JAX package's tour runs on an 8-device virtual mesh; each mesh here
is cut to the 4 ranks by dropping `dp` first (each section says how).
Every cell's data comes from seeded CPU generators, so all ranks see
the same whole tensors and take their own slices.""")

code("%load_ext nbdistributed_tpu_torch")

code("""\
import os
backend = os.environ.get("NBD_NOTEBOOK_BACKEND", "auto")
nw = int(os.environ.get("NBD_NOTEBOOK_WORKERS", "4"))""")

code("%dist_init -n {nw} --backend {backend} -t 600")

code("""\
import dataclasses
from nbdistributed_tpu_torch.models import (AdamW, init_params, loss_fn,
                                            param_leaves, param_shardings,
                                            tiny_config)
from nbdistributed_tpu_torch.parallel import tensor_parallel

def seeded(seed):
    # A CPU generator: the same numbers on every rank, on any device.
    return torch.Generator().manual_seed(seed)

def randn(seed, *shape):
    return torch.randn(shape, generator=seeded(seed)).to(device)

def randint(seed, high, *shape):
    return torch.randint(0, high, shape, generator=seeded(seed)).to(device)

def whole(tree, m, rules):
    # A tree's leaves gathered whole from this rank's shards.
    if isinstance(tree, dict):
        return {k: whole(tree[k], m, rules[k]) for k in tree}
    x = tree.detach().clone()
    for dim, axis in enumerate(rules or ()):
        if axis is not None:
            x = m.all_gather(x.contiguous(), axis, dim)
    return x

print(f"rank {rank} of {world_size} on {device}")""")

md("""## Data + tensor parallel training

A tiny Llama-style transformer trained over a `dp×tp` mesh (2×2, as in
JAX): `apply_shardings` gives each rank its Megatron slice of every
weight by the `param_shardings` rules, and the model issues the
per-block `tp` all-reduces and the step the gradient mean over `dp`.""")

code("""\
cfg = tiny_config(dtype=torch.float32, use_flash=False)
mesh = make_mesh({"dp": 2, "tp": 2})
rules = param_shardings(cfg)
opt_loss = lambda p, b: loss_fn(p, b, cfg, mesh=mesh, rules=rules)

params = apply_shardings(init_params(cfg, 0, device=device), mesh, rules)
opt = AdamW(param_leaves(params), lr=3e-4)
step = tensor_parallel.make_tp_train_step(opt_loss, opt, mesh, rules)
batch = shard_batch({"tokens": randint(1, cfg.vocab_size, 8, 33)}, mesh)
losses = [float(step(params, batch)) for i in range(3)]
if rank == 0:
    for i, l in enumerate(losses):
        print(f"step {i}: loss {l:.4f}")
    print("wq sharding:", rules["layers"]["wq"], "->",
          tuple(params["layers"]["wq"].shape), "a rank")""")

md("""## ZeRO-1 — optimizer state sharded over dp

Same step, different optimizer-state shardings: the Adam moments drop
to `1/dp` per replica — each rank steps its slice, reduce-scattered
gradients in, the updated slices all-gathered out (arXiv:2004.13336).""")

code("""\
from nbdistributed_tpu_torch.parallel.zero import (make_zero1_train_step,
                                                  zero1_state_shardings)

zstep, zinit = make_zero1_train_step(opt_loss, opt, mesh, rules, params)
zstate = zinit(params)
loss = zstep(params, batch)
mu = zstate.moments(params["embed"])["mu"]
spec = zero1_state_shardings(opt, params, rules, mesh)["embed"]
if rank == 0:
    print(f"loss {float(loss):.4f}; moment sharding: {spec} "
          f"({tuple(mu.shape)} of the {tuple(params['embed'].shape)} "
          f"embed shard)")""")

md("""### FSDP / ZeRO-3 — weight sharding by rules

`fsdp_param_shardings` shards every large weight over `dp` (2-D HSDP
with `tp_axis`); params, grads, and optimizer state shrink by the dp
size, each weight all-gathered just before use and its gradient
reduce-scattered back — torch FSDP's schedule.  The mesh is `dp`=4, as
in JAX.""")

code("""\
from nbdistributed_tpu_torch.models import fsdp_param_shardings

fsdp_mesh = make_mesh({"dp": 4})
frules = fsdp_param_shardings(cfg)
full = whole(params, mesh, rules)
fparams = apply_shardings(full, fsdp_mesh, frules)
wq = fparams["layers"]["wq"]
if rank == 0:
    print("wq bytes/device:", wq.numel() * wq.element_size(), "of",
          full["layers"]["wq"].numel() * wq.element_size(),
          "(sharded 4-way)")
fstep = tensor_parallel.make_tp_train_step(
    lambda p, b: loss_fn(p, b, cfg, mesh=fsdp_mesh, rules=frules),
    AdamW(param_leaves(fparams), lr=3e-4), fsdp_mesh, frules)
ftok = shard_batch({"tokens": randint(13, cfg.vocab_size, 4, 32)},
                   fsdp_mesh)
floss = fstep(fparams, ftok)
if rank == 0:
    print(f"FSDP train step: loss {float(floss):.4f}")""")

md("""## Gradient accumulation

`accum_steps=N` runs N microbatches inside the step (fp32 accumulator,
each rank's own rows split — no resharding): activation memory ÷ N at
full-batch numerics.""")

code("""\
astep = tensor_parallel.make_tp_train_step(opt_loss, opt, mesh, rules,
                                           accum_steps=2)
loss = astep(params, batch)
if rank == 0:
    print(f"accumulated step loss {float(loss):.4f}")""")

md("""## Sequence parallelism — ring and Ulysses

Long-context attention with the sequence axis sharded 4 ways (JAX: 8;
here `sp`=4, S = 64·4).  Ring streams K/V chunks around the ranks with
`ppermute` and folds them by an online softmax; Ulysses re-shards
sequence↔heads with two all-to-alls and runs plain local attention.
Each rank passes its own chunk; both are exact.""")

code("""\
from nbdistributed_tpu_torch.ops import attention_reference

sp_mesh = make_mesh({"sp": 4})
B, S, H, D = 1, 64 * 4, 8, 32
q, k, v = (randn(i, B, S, H, D) for i in range(3))
ref = attention_reference(q, k, v, causal=True)
Cs, ci = S // 4, sp_mesh.index("sp")
mine = lambda t: t[:, ci * Cs:(ci + 1) * Cs]
for name, fn in [("ring", ring_attention), ("ulysses", ulysses_attention)]:
    out = fn(mine(q), mine(k), mine(v), sp_mesh, causal=True)
    err = all_reduce((out - mine(ref)).abs().max(), "max")
    if rank == 0:
        print(f"{name:8s} S={S} sharded 4-way: max |err| vs full "
              f"attention = {float(err):.2e}")""")

md("""### Zigzag — the load-balanced causal ring

With plain chunking, causality means rank 0 idles on every hop after
the first while rank n-1 computes on all of them.  The zigzag schedule
gives rank d global chunks d **and** 2n-1-d, so every rank does equal
real work per hop (the flash kernel skips the masked blocks: on a GPU
each hop is the hand-written flash forward).  Reorder once with
`zigzag_shard`, train in that layout, undo with `zigzag_unshard` (4
ranks, as the ring above).""")

code("""\
zz = lambda t: mine(zigzag_shard(t, 4))
out_zz = ring_attention(zz(q), zz(k), zz(v), sp_mesh, causal=True,
                        use_flash=True, schedule="zigzag")
out_all = sp_mesh.all_gather(out_zz.contiguous(), "sp", 1)
err = float((zigzag_unshard(out_all, 4) - ref).abs().max())
if rank == 0:
    print(f"zigzag   S={S} sharded 4-way: max |err| vs full attention "
          f"= {err:.2e}")""")

md("""## Pipeline parallelism — GPipe over a `pp` axis

Stages live on different ranks (`pp`=4, as in JAX); microbatches stream
through `ppermute` hops.  Exact vs running the stages sequentially,
which every rank can do here from the same seeded stages.""")

code("""\
from nbdistributed_tpu_torch.parallel import pipeline

pp_mesh = make_mesh({"pp": 4})
Dm = 16
stages = {"w": randn(3, 4, Dm, Dm) * 0.3,
          "b": torch.zeros((4, Dm), device=device)}
stage_fn = lambda pr, x: torch.tanh(x @ pr["w"] + pr["b"])
x_in = randn(4, 8, Dm)
out = pipeline.pipeline_forward(
    stage_fn, pipeline.shard_stage_params(stages, pp_mesh), x_in, pp_mesh,
    n_microbatches=4)
seq = x_in
for s in range(4):
    seq = stage_fn({k: t[s] for k, t in stages.items()}, seq)
err = all_reduce((out - seq).abs().max(), "max")
if rank == 0:
    print("pipeline max |err| vs sequential:", float(err))""")

md("""## Expert parallelism — MoE over an `ep` axis

Top-k routed experts, capacity-bounded dense dispatch, experts sharded
across ranks (JAX: dp2×ep4; here `ep`=4, every rank holding the whole
batch).""")

code("""\
from nbdistributed_tpu_torch.models import (init_moe_model, moe_loss_fn,
                                            moe_model_shardings,
                                            tiny_moe_config)

ep_mesh = make_mesh({"ep": 4})
mcfg = tiny_moe_config(dtype=torch.float32, use_flash=False)
mrules = moe_model_shardings(mcfg, tp_axis=None)
mp = apply_shardings(init_moe_model(mcfg, 5, device=device), ep_mesh,
                     mrules)
mb = {"tokens": randint(6, mcfg.vocab_size, 4, 17)}
with torch.no_grad():
    mloss = float(moe_loss_fn(mp, mb, mcfg, mesh=ep_mesh))
if rank == 0:
    print(f"MoE loss over the ep mesh: {mloss:.4f}")
    print("expert weights sharding:", mrules["layers"]["moe"]["w_up"],
          "->", tuple(mp["layers"]["moe"]["w_up"].shape), "a rank")""")

md("""### Dropless dispatch — no token ever dropped

`moe_dispatch="dropless"` runs the expert SwiGLU as per-expert segment
products over variable-size expert segments.  Over the `ep` mesh it
becomes the shard-capacity hybrid: a static per-shard all-to-all feeds
locally dropless segments — per-expert slack pools across each shard's
experts (`ep`=4, as above).""")

code("""\
mcfg_ll = dataclasses.replace(mcfg, capacity_factor=float(mcfg.n_experts))
mcfg_dl = dataclasses.replace(mcfg, moe_dispatch="dropless",
                              capacity_factor=float(mcfg.n_experts))
with torch.no_grad():
    l_dense = float(moe_loss_fn(mp, mb, mcfg_ll, mesh=ep_mesh))
    l_dropless = float(moe_loss_fn(mp, mb, mcfg_dl, mesh=ep_mesh))
if rank == 0:
    print(f"lossless dense {l_dense:.6f}  dropless-over-ep {l_dropless:.6f}"
          f"  equal: {abs(l_dense - l_dropless) < 1e-5}")""")

md("""### Model-integrated SP — train long context in one line

`make_train_step(cfg, opt, sp=SeqParallel(mesh), rules=rules)` routes
every layer's attention through the ring; everything else is
position-wise, so each rank keeps only its sequence chunk.  tp composes
through the rules (heads stay local through the ring).  JAX's mesh is
dp2×sp2×tp2; here sp2×tp2.""")

code("""\
from nbdistributed_tpu_torch.models import SeqParallel, make_train_step

sp_tr_mesh = make_mesh({"sp": 2, "tp": 2})
spec = SeqParallel(mesh=sp_tr_mesh, method="ring")
p_sp = apply_shardings(whole(params, mesh, rules), sp_tr_mesh, rules)
sp_step = make_train_step(cfg, AdamW(param_leaves(p_sp), lr=3e-4),
                          sp=spec, rules=rules)
sp_loss = sp_step(p_sp, {"tokens": randint(8, cfg.vocab_size, 4, 32)})
if rank == 0:
    print(f"ring-attention train step over sp×tp: loss "
          f"{float(sp_loss):.4f}")""")

md("""## Generation — KV-cache decode on a tp mesh

One prefill, then one token a step; the cache shards like the
parameters (KV heads over tp, batch over dp; the dp×tp mesh above).
Sampling: greedy, temperature, and `top_k` / `top_p` filters, drawn
from a seeded `torch.Generator`.""")

code("""\
from nbdistributed_tpu_torch.models import generate

prompt = randint(7, cfg.vocab_size, 2, 6)
toks_greedy = generate(params, prompt, cfg, max_new_tokens=8, mesh=mesh)
toks = generate(params, prompt, cfg, max_new_tokens=8, temperature=0.8,
                top_k=50, top_p=0.95, mesh=mesh,
                generator=torch.Generator(device=device).manual_seed(9))
params_w = whole(params, mesh, rules)   # the trained tree, whole
if rank == 0:
    print("greedy:   ", toks_greedy[:, 6:].tolist())
    print("top-k/p:  ", toks[:, 6:].tolist())""")

md("""### Sequence-parallel decode — the KV cache sharded over `sp`

Long-context serving: the cache (not the weights) outgrows one card's
memory first.  Each `sp` shard runs the decode kernel over its `T/n`
cache slice (on a GPU the hand-written flash-decode kernel) and shards
merge by log-sum-exp — flash's inter-block combine run across ranks,
one reduction per layer per step.  JAX's mesh is dp2×tp2×sp2; here
tp2×sp2.""")

code("""\
sp_dec_mesh = make_mesh({"tp": 2, "sp": 2})
cfg_f = dataclasses.replace(cfg, use_flash=True)
ps_sp = apply_shardings(params_w, sp_dec_mesh, rules)
toks_sp = generate(ps_sp, prompt, cfg_f, max_new_tokens=8,
                   mesh=sp_dec_mesh, max_len=32)
if rank == 0:
    print("sp-sharded decode matches:",
          bool(torch.equal(toks_sp, toks_greedy)))""")

md("""## Int8 weight-only quantization

Per-output-channel scales commute with the matmul, so the product reads
the raw int8 weights (half the bytes of bf16 on the decode-dominant
streams) and rescales the activation once.  Same forward/decode path;
tp shardings map onto the int8+scale tree.""")

code("""\
from nbdistributed_tpu_torch.models import (forward, quantization_error,
                                            quantize_params)

qparams = quantize_params(params_w)
errs = quantization_error(params_w, qparams)
with torch.no_grad():
    ref = forward(params_w, prompt, cfg)
    got = forward(qparams, prompt, cfg)
agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
q_greedy = generate(qparams, prompt, cfg, 8)[:, 6:].tolist()
if rank == 0:
    print("per-weight relative quantization error:",
          {k: round(v, 4) for k, v in errs.items()})
    print(f"int8 vs fp32 top-1 agreement: {agree:.2%}")
    print("int8 greedy:", q_greedy)""")

md("""## Speculative decoding

A draft model proposes γ tokens; the target verifies them all in one
batched forward.  Greedy mode reproduces the target's own decode;
`mean_acc` (accepted per round) sets the speedup.""")

code("""\
from nbdistributed_tpu_torch.models import (TransformerConfig,
                                            speculative_generate)

draft_cfg = TransformerConfig(vocab_size=cfg.vocab_size, d_model=64,
                              n_layers=1, n_heads=2, n_kv_heads=2,
                              d_ff=128, dtype=torch.float32,
                              use_flash=False)
draft = init_params(draft_cfg, 12, device=device)
sp_prompt = prompt[:1]
spec, mean_acc = speculative_generate(params_w, draft, sp_prompt, cfg,
                                      draft_cfg, 10, gamma=3)
ref = generate(params_w, sp_prompt, cfg, max_new_tokens=10)
# Self-draft sanity: drafting with the target itself accepts everything.
_, acc_self = speculative_generate(params_w, params_w, sp_prompt, cfg,
                                   cfg, 10, gamma=3)
# Batched streams share every draft/verify forward; per-stream cache
# pointers keep diverging acceptance independent.
spec_b, _ = speculative_generate(params_w, draft, prompt, cfg, draft_cfg,
                                 10, gamma=3)
ref_b = generate(params_w, prompt, cfg, max_new_tokens=10)
if rank == 0:
    print("speculative == target greedy:", bool(torch.equal(spec, ref)),
          f"(mean accepted/round {float(mean_acc):.2f})")
    print(f"self-draft mean accepted/round: {float(acc_self):.2f} (max 3)")
    print(f"batched speculative (B={prompt.shape[0]}) == batched greedy:",
          bool(torch.equal(spec_b, ref_b)))""")

md("""## 1F1B pipeline schedule — O(stages) activation memory

GPipe via autograd keeps every microbatch's graph; the 1F1B
(PipeDream-flush) schedule interleaves one forward and one backward
sub-step per tick, so the in-flight buffer is `2·stages − 1`
microbatch inputs regardless of the microbatch count — same loss,
same gradients (`pp`=4, as in JAX).""")

code("""\
Dm = 16
fb_stages = {"w": randn(20, 4, Dm, Dm) * 0.3,
             "b": torch.zeros((4, Dm), device=device)}
fb_stage_fn = lambda pr, h: torch.tanh(h @ pr["w"] + pr["b"])
mse = lambda out, tgt: ((out - tgt) ** 2).mean()
xin, tgt = randn(21, 16, Dm), randn(22, 16, Dm)
sh = pipeline.shard_stage_params(fb_stages, pp_mesh)
shg = {k: t.clone().requires_grad_() for k, t in sh.items()}
l_ref = pipeline.make_pipeline_loss(fb_stage_fn, mse, pp_mesh,
                                    n_microbatches=8)(shg, xin, tgt)
l_ref.backward()
l_fb, g_fb = pipeline.make_pipeline_1f1b(fb_stage_fn, mse, pp_mesh,
                                         n_microbatches=8)(sh, xin, tgt)
gerr = all_reduce(torch.stack([(g_fb[k] - shg[k].grad).abs().max()
                               for k in g_fb]).max(), "max")
ok = abs(float(l_fb) - float(l_ref)) < 1e-5 and float(gerr) < 1e-4
if rank == 0:
    print(f"1F1B vs GPipe grads match: {ok} "
          f"(buffer {2 * 4 - 1} deep, not 8)")""")

md("""## Sparse MoE dispatch + windowed-ring hop plan

Two routing upgrades: `dispatch_mode="sparse"` replaces the quadratic
one-hot dispatch einsums with a sort/segment gather (linear in
tokens, identical drops), and sliding-window ring attention prunes
whole out-of-band hops from the ring — `hop_plan` computes the
contributing steps statically (the plan below is for sp=8, as in
JAX: a plan needs no mesh).""")

code("""\
from nbdistributed_tpu_torch.parallel import expert
from nbdistributed_tpu_torch.parallel.ring import hop_plan

mx = randn(23, 64, 16)
mpar = {k: t.to(device) for k, t in expert.init_moe_params(
    seeded(24), 16, 32, 4, dtype=torch.float32).items()}
yd, _ = expert.moe_ffn(mx, mpar)
ysp, _ = expert.moe_ffn(mx, mpar, dispatch_mode="sparse")
plan = hop_plan(8, 2048, 4096)   # sp=8, 2048-token chunks, 4K window
if rank == 0:
    print(f"sparse MoE dispatch == dense: "
          f"{float((ysp - yd).abs().max()) < 1e-5}")
    print(f"SWA ring hop plan (sp=8, S=16K, window=4K): {list(plan)} — "
          f"{len(plan)}/8 hops pay compute+ppermute")""")

md("""## LoRA fine-tuning

Adapters mirror the targeted weights; a differentiable merge reuses
the whole stack (flash kernels, remat, every sharding rule), and the
optimizer state exists only for adapter leaves (~0.6% of full-model at
7B, rank 16).""")

code("""\
from nbdistributed_tpu_torch.models import (ALL_TARGETS, lora_init,
                                            lora_merge,
                                            make_lora_train_step)

lora = lora_init(10, cfg, rank=4, targets=ALL_TARGETS, device=device)
lstep = make_lora_train_step(cfg, AdamW(param_leaves(lora), lr=1e-2))
lbatch = {"tokens": randint(11, cfg.vocab_size, 2, 16)}
with torch.no_grad():
    l0 = float(loss_fn(lora_merge(params_w, lora), lbatch, cfg))
for _ in range(10):
    lstep(params_w, lora, lbatch)
with torch.no_grad():
    l1 = float(loss_fn(lora_merge(params_w, lora), lbatch, cfg))
n_ad = sum(t.numel() for t in param_leaves(lora))
n_all = sum(t.numel() for t in param_leaves(params_w))
if rank == 0:
    print(f"LoRA: {n_ad:,} adapter params ({n_ad / n_all:.1%} of model), "
          f"loss {l0:.3f} -> {l1:.3f}")""")

md("""## Packed-document training (segment ids)

`pack_tokens(return_segments=True)` emits per-window document ids;
`batch["segments"]` engages the whole contract — attention masked
across documents (inside the flash kernels, both passes, on a GPU),
RoPE restart per document, boundary targets dropped.  Ground truth:
packed logits equal each document forwarded alone.""")

code("""\
from nbdistributed_tpu_torch.models import packed_positions

docs = [[(i * 11 + j) % cfg.vocab_size for j in range(n)]
        for i, n in enumerate([15, 9, 20])]
win, seg = pack_tokens(docs, 23, eos_id=0, return_segments=True)
win = torch.as_tensor(win, device=device)
seg = torch.as_tensor(seg, device=device)
d0 = torch.tensor([docs[0] + [0]], device=device)
with torch.no_grad():
    packed_loss = float(loss_fn(params_w, {"tokens": win,
                                           "segments": seg}, cfg))
    lp = forward(params_w, win[:1], cfg, packed_positions(seg[:1]),
                 segment_ids=seg[:1])
    err = float((lp[:, :16] - forward(params_w, d0, cfg)).abs().max())
if rank == 0:
    print(f"packed loss {packed_loss:.4f}; doc0 logits vs solo forward: "
          f"max |err| = {err:.2e}")""")

md("""## Continuous-batching serving

`DecodeServer` admits requests of any length into a fixed slot pool
whenever a slot frees; every decode step is ONE shared B-row forward
with per-slot cache pointers, so staggered requests share every
matmul.  Greedy serving is identical per request to a standalone
`generate` call — occupancy is invisible to the numerics.""")

code("""\
srv = DecodeServer(params_w, cfg, max_batch=2, max_len=64, pad_to=8)
ra = srv.submit([5, 9, 2], 6)
srv.step()                            # ra decodes alone...
rb = srv.submit([7, 1, 3, 11], 5)     # ...rb joins mid-flight
srv.run_until_done(max_steps=60)

def solo(pr, n):
    out = generate(params_w, torch.tensor([pr], device=device), cfg, n)
    return out[0, len(pr):].tolist()

same = (srv.outputs[ra] == solo([5, 9, 2], 6),
        srv.outputs[rb] == solo([7, 1, 3, 11], 5))
if rank == 0:
    print(f"staggered == solo: {same[0]} {same[1]}")""")

md("""## Ring-overlapped collective matmul

The Megatron sequence-parallel block's `all_gather -> matmul` and
`matmul -> reduce_scatter`, decomposed into `ppermute` rings
interleaved with per-chunk GEMMs: each transfer hides behind the
product that does not need it (`tp`=4, as in JAX).  `shard_map` hands
each rank its blocks of the whole inputs and gathers the output.
Exact vs the replicated MLP.""")

code("""\
import torch.nn.functional as F
from nbdistributed_tpu_torch.parallel.overlap import megatron_sp_block

tp_mesh = make_mesh({"tp": 4})
S_, D_, F_ = 16, 8, 32
ox = randn(30, S_, D_)
owu = randn(31, D_, F_) * 0.2
owd = randn(32, F_, D_) * 0.2
ov = shard_map(
    lambda a, b, c: megatron_sp_block(a, b, c, tp_mesh, "tp"),
    tp_mesh, in_specs=(P("tp", None), P(None, "tp"), P("tp", None)),
    out_specs=P("tp", None))(ox, owu, owd)
ref = F.gelu(ox @ owu, approximate="tanh") @ owd
if rank == 0:
    print(f"ring-overlap Megatron-SP block exact: "
          f"{float((ov - ref).abs().max()) < 1e-4}")""")

code("%dist_shutdown")

# Each cell's self-check: a sentence its output must hold and, where that
# line ends in an error against an exact reference, the bound the error
# stays under (float rounding).  The CPU tests and the four-card run of
# ``chip_smoke.py --mesh-nccl`` both hold the tour's output to this table.
CHECKS = (
    ("ring     S=256 sharded 4-way: max |err| vs full attention", 1e-5),
    ("ulysses  S=256 sharded 4-way: max |err| vs full attention", 1e-5),
    ("zigzag   S=256 sharded 4-way: max |err| vs full attention", 1e-5),
    ("pipeline max |err| vs sequential", 1e-5),
    ("doc0 logits vs solo forward: max |err|", 1e-4),
    ("MoE loss over the ep mesh", None),
    ("dropless-over-ep", None),
    ("equal: True", None),
    ("moment sharding: P('dp', 'tp')", None),
    ("greedy:", None),
    ("top-k/p:", None),
    ("ring-attention train step over sp×tp", None),
    ("accumulated step loss", None),
    ("sp-sharded decode matches: True", None),
    ("int8 vs fp32 top-1 agreement", None),
    ("FSDP train step: loss", None),
    ("wq bytes/device: 32768 of 131072 (sharded 4-way)", None),
    ("speculative == target greedy: True", None),
    ("self-draft mean accepted/round: 3.00 (max 3)", None),
    ("batched speculative (B=2) == batched greedy: True", None),
    ("1F1B vs GPipe grads match: True (buffer 7 deep, not 8)", None),
    ("sparse MoE dispatch == dense: True", None),
    ("[0, 1, 2] — 3/8 hops pay compute+ppermute", None),
    ("LoRA:", None),
    ("adapter params", None),
    ("staggered == solo: True True", None),
    ("ring-overlap Megatron-SP block exact: True", None),
)


def failed_checks(text: str) -> list[str]:
    """The :data:`CHECKS` that the tour's output ``text`` fails: a
    sentence missing, or an error that is not a number under its bound
    (its line's last word, after any ``=``)."""
    bad = []
    for sentence, bound in CHECKS:
        line = next((ln for ln in text.splitlines() if sentence in ln), None)
        if line is None:
            bad.append(f"missing: {sentence!r}")
            continue
        if bound is None:
            continue
        try:
            err = float(line.rsplit("=", 1)[-1].split()[-1])
        except ValueError:
            err = float("nan")
        if not err < bound:
            bad.append(f"{line.strip()!r}: not under {bound}")
    return bad


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
                   "01_torch_parallelism.ipynb")

if __name__ == "__main__":
    with open(OUT, "w", encoding="utf-8") as f:
        f.write(render())
    print("wrote", OUT, "-", len(C), "cells")
