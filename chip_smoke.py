#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``nbdistributed_tpu_torch``) on one
NVIDIA GPU: builds the hand-written CUDA kernels from the checkout,
holds each against its plain PyTorch version, drives the serving and
training slices at the full width of SmolLM2-135M and of Mixtral-8x7B
(2 of its 32 layers), and times each kernel.

    python3 chip_smoke.py

Phases (each prints one or more lines; any failure exits non-zero):

1. build the kernels (one ``nvcc`` per source, in parallel); the card's
   name and power limit;
2. K1, the flash-attention forward, called through its wrappers,
   against its plain version in bf16 (and fp32 cases): one 64 x 64
   tile, group 1, the serving shapes, the training path's (B=4,
   S=2048, without and with the training batch's packed-document
   segments) and Mixtral's attention (S=2048, H=32, Hkv=8, D=128);
3. K4, flash-decode, called through its wrapper, against its plain
   version: per-row positions over [0, T-1], a window, int8 caches
   with scales, fp32, T=1000 (ragged against the 128-key chunk), rows
   whose window lies past every valid key (o = 0, lse = NEG_INF),
   groups 1 and 8, D=32 and 128, one chunk (nsplit = 1), the lse, the
   serving path's own shape and positions and its full context, a
   paged step's dense view (large finite values past every position),
   the Mixtral server's shape (Hkv=8, group 4, D=128, T=1024) in
   bf16, int8 and fp32, and the mesh phase's shard shapes (B=4 of 8
   slots, T=512 and the path's 128; Mixtral's Hkv=4 of 8 on tp) at
   positions shifted by the slice's offset: negative, inside and past
   the slice, and a window wholly past it;
4. K2/K3, the flash-attention backward (dQ, dK/dV), called through the
   wrapper the path calls, against the plain backward in bf16 (one
   tile, group 1, causal S=2048 with group 3 at D=64 and D=128,
   non-causal Sq != Sk, a window, segments, offsets, D=32, the
   training path's shape with its batch's segments, Mixtral's
   attention) and fp32 cases; the K1 forward that feeds each case is
   held to the plain forward first;
5. the serving path, with every launch count set to 0 just before and
   read just after: full-width ``forward`` (bf16, B=1, S=512) and a
   bf16 ``DecodeServer`` answering 12 staggered requests; K1 must have
   launched once per layer, K4 once per layer per decode step.  The
   kernel-path logits are then held against the plain path's, and the
   same requests are served in fp32 and held against solo ``generate``
   under the near-tie rule (``near_tie_check``: a stream may leave its
   reference only where the reference's top-2 logit gap is below 1e-4;
   every fp32 check below uses it);
6. a profile of bf16 decode steps: device time per step against the
   host's wall time, and the kernels that take it;
7. paged KV (``serve_paged``): 16 blocks of 64 tokens (1/8 of the dense
   pool) serving phase 5's requests, token for token the dense bf16
   server's, with admissions that waited for blocks and every block
   back at the end; on 8 of them int8 KV paged against int8 KV dense
   and fp32 paged against solo ``generate``; the gather's and scatter's
   device time; a profile of paged steps;
8. speculative decoding (``serve_speculative``, gamma 4, draft = the
   target's first 2 layers): fp32 against solo ``generate``; an fp32
   self-draft accepting every proposal but at near-ties; bf16 tokens
   per round, ms per round and tokens/s; K4 (gamma + 1) x 2 times a
   round and none in the verify; a profile of rounds;
9. prefix caching and chunked prefill (``serve_prefix_chunked``): a
   384-token cached prefix against a server without it, with the
   prefill positions each fed; interleaved prefill in chunks of 128 of
   600-1500-token prompts against solo ``generate``; in bf16, the
   slowest decode step while a long prompt streams in beside one
   unchunked admission step;
10. int8 and int4 weights (``serve_quantized``): weight bytes, decode
   ms per step and the forward's relative L2 in bf16 (12 requests),
   fp32 against solo ``generate`` on the same quantized tree (4
   requests), and the lm_head product's time in each form;
11. the training path, counts reset just before and read just after:
   8 bf16 AdamW steps with remat on one fixed batch of B=4 x S=2048
   packed documents, fed through ``batch_iterator`` and
   ``prefetch_to_device``; per step K1 must launch 60 times (forward
   and remat recompute), K2 and K3 30 times each; every loss finite
   and the last below the first.  Then a profile of one step, the
   fp32 loss and every gradient through the kernels against the plain
   path (B=1, S=2048), and three bf16 LoRA steps (base untouched, loss
   falls);
12. the Mixtral MoE family (``mixtral_8x7b_config(n_layers=2)``, full
   width, seed 0), each path's run with the counts reset just before
   and read just after: ``moe_forward`` (fp32, B=1, S=512, capacity
   factor 4: lossless) in the dense, sparse and dropless modes, logits
   within 1e-5 relative L2, aux within 1e-6, K1 once per layer per
   forward, dropless's host reads one per layer;
13. fp32 MoE serving on 8 of 12 requests made as phase 5's are (in
   Mixtral's vocabulary) against solo ``generate``, an fp32 self-draft (gamma 4) accepting every proposal
   but at near-ties with K4 (gamma + 1) x 2 per round, and an int8
   (``quantize_moe_params``) tree against solo ``generate`` on it;
14. bf16 MoE serving (capacity factor 1.25, dense dispatch) of the 12
   requests: tokens/s, ms per step, weight bytes, K4 once per layer per
   step, a profile of decode steps with the MoE block's device share,
   the paged server (blocks of 64) token for token the dense one, and
   the int8 tree's weight bytes and ms per step;
15. bf16 MoE training: ``moe_loss_fn`` and AdamW, 4 steps on B=1 x
   S=2048 packed documents, per step K1, K2 and K3 once per layer,
   losses finite and falling, peak memory, a profiled step; three LoRA
   steps on the attention projections;
16. timing of each kernel at the main paths' shapes (K1 at the serving,
   training and Mixtral shapes, K4 at the serving shape, at full
   context, at the Mixtral server's shape and at the mesh's sp shard), beside its plain
   version, one PyTorch library call and the card's bound; K4 and its
   yardsticks on the device by CUDA-graph replay (a K4 call is shorter
   than the host's launch of it);
17. (run right after phase 6) the worker cluster: one worker spawned by
   the port's ``ProcessManager`` (``backend="gpu"``) and driven over
   its control plane: the NCCL process group (``dist.all_reduce`` and
   the functional ``all_reduce`` on the card, a 64 MB all-reduce
   timed), phase 5's path run in the worker with its counts reset just
   before and read just after there (K1 once per layer, K4 once per
   layer per decode step; tokens equal to the in-process bf16 server's;
   no kernel rebuilt in the worker), a serve_open / serve_step /
   serve_close round, an interrupt of a cell looping GPU matmuls, the
   spawn-to-ready time and the median round trip of a trivial cell.
   Then HF interop: SmolLM2 and Mixtral (2 layers) laid out as
   ``transformers`` state dicts and converted back onto the GPU, bit
   for bit, and ``load_hf_pretrained`` where ``transformers`` imports.

18. (run after phase 15) serving on a mesh: four ranks of one gloo
   process group spawned by this script on the one card (each on
   ``cuda:0``; NCCL refuses two ranks on one device), loading the
   kernels this process built.  In fp32 they serve phase 5's 12 requests
   with SmolLM2-135M (30 layers) on ``{"dp": 2, "sp": 2}`` and the 8 of
   phase 13 with Mixtral (2 layers, full width, capacity factor 4) on
   ``{"ep": 4}`` (dense and dropless dispatch) and on ``{"tp": 2,
   "sp": 2}``, at ``max_len`` 256 (both sp slices hold keys); each rank
   builds its shard of the model from seed 0, leaf by leaf.  Each run's
   counts are reset just before and read just after on every rank: K4
   once per layer per decode step, every rank's tokens equal, and the
   tokens held to solo ``generate`` under the near-tie rule.  Rows: ms
   per step, collectives per step and each rank's peak memory; the
   ranks time-share the card and every collective crosses the host, so
   no number is a link speed.

19. (run after phase 18) training on a mesh: phase 18's ranks train,
   each from seed 0 and guarded, SmolLM2-135M (30 layers, fp32, remat)
   with Megatron rules on ``{"dp": 2, "tp": 2}`` (attention on every
   head on every tp rank: 9 and 3 heads do not divide 2) and with HSDP
   rules on the same mesh (3 AdamW steps, B=4 x S=512 packed
   documents), ZeRO-2 on ``{"dp": 4}`` (accum_steps 2, B=8 x S=512, 3
   steps and a NaN batch between steps 2 and 3 that must be skipped
   bitwise), and Mixtral (2 layers, full width, fp32, capacity factor
   4, dropless) with ``moe_loss_fn`` on ``{"ep": 4}`` (2 steps, B=1 x
   S=512).  Each is held to the single-process step on the whole tree
   and batch, run first in this process: every rank's losses equal, the
   losses within 1e-5 and each step's gradient norm within 1e-4
   relative, every leaf gathered from the shards within 1e-4 relative
   L2; per rank per step K1/K2/K3 60/30/30 for SmolLM2 (x2 with
   accumulation) and 2/2/2 for Mixtral, counts reset just before and
   read just after; the ZeRO moments a quarter of each leaf.  Rows: ms
   per step, collectives per step and peak memory per rank, host-bound
   gloo times.

20. (run after phase 19) sequence-parallel training.  First K1, K2
   and K3 at ring-hop geometry for Mistral-7B's attention (H 32, Hkv 8,
   D 128, chunks of 1024), bf16 and fp32, against their plain versions:
   the diagonal hop, a fully visible and a fully masked one, window 1536
   at its edge and past it, zigzag half-pairs, key-side segments unlike
   the query side's (rows no key reaches must be the same rows on both
   sides; K2/K3 from a whole-sequence lse and delta; a fully masked
   hop's gradients exactly zero).  Then phase 18's ranks, each job from
   seed 0 in fp32 and held to the single-process run here as phase 19
   holds its jobs: SmolLM2-135M (30 layers, remat, packed documents,
   B=2 x S=2048 on ``{"sp": 4}`` and B=4 on ``{"dp": 2, "sp": 2}``,
   the ring, 2 AdamW steps), Mistral-7B (``mistral_7b_config``, 2 of 32
   layers, window 4096, B=1 x S=8192 on sp4: the pruned plan of 3 hops
   and one jump home), TinyLlama-1.1B (4 of 22 layers, Ulysses on
   ``{"sp": 2, "tp": 2}`` with Megatron rules), Mixtral (1 layer,
   dropless, capacity factor 4, ring on ``{"sp": 2, "ep": 2}``, one
   forward and backward without an optimizer), and Mistral's attention
   alone as the zigzag ring on sp4 (S=8192, bf16 and fp32, full and
   window 1024) against ``flash_attention`` on the whole sequence.
   K1/K2/K3 per rank per step: hops x layers (K1 twice with remat).
   Rows: ms per step, collectives per step (ring hops are
   ``batch_isend_irecv`` calls), peak GB per rank, the phase's seconds;
   host-bound gloo times.

21. (run after phase 20) pipeline-parallel training.  First
   ``remat_policy="dots"`` on phase 11's shape (bf16, B=4 x S=2048,
   one step, this process) against full remat and none: the loss within
   1e-6 of full remat's, K1 60 (attention recomputed), K2 and K3 30;
   peak GB and ms of each.  Then phase 18's ranks, each job from seed 0
   in fp32, AdamW lr 1e-4, 2 steps, held to the single-process step as
   phase 19 holds its jobs (each step's gradient norm from an AdamW that
   records it): Mistral-7B (``mistral_7b_config``, 4 of 32 layers, one a
   stage, B=16 x S=512, 16 microbatches) on ``{"pp": 4}`` by GPipe
   (``make_pp_train_step``) and by 1F1B (``make_pp_1f1b_train_step``,
   its losses within 1e-5 of GPipe's), and SmolLM2-135M (30 layers, 15 a
   stage) by 1F1B on ``{"dp": 2, "pp": 2}`` (``batch_axis="dp"``, B=8,
   4 microbatches).  K1/K2/K3 per rank per step: the stage's layers per
   microbatch, K1 twice under 1F1B but on the last stage.  And
   ``allgather_matmul`` against ``all_gather`` and one product at a
   Megatron shape on ``{"tp": 4}`` (bf16, x 2048 x 4096 a rank, w
   4096 x 3584): C4's overlap, reported.  Rows: ms per step per rank,
   collectives per step, peak GB per rank, the phase's seconds.

22. (run after phase 21) the training guard and per-rank checkpoints,
   SmolLM2-135M at full depth and width, bf16, remat, B=4 x S=2048,
   AdamW, from seed 0.  (1) Phase 18's ranks, each training on a mesh
   of its own (``make_mesh({"dp": 1}, ranks=[rank])``) with the same
   batches under ``TrainGuard(audit_every=2, snapshot_every=2)``, 6
   steps, fault-free and then with one bit of rank 1's ``wq`` flipped
   at step 3 by the process fault plan: every fault-free audit ``ok``,
   the step-4 audit names minority (1,) and root 0 with one repair, and
   every rank's final params and moments bitwise the fault-free run's;
   K1/K2/K3 60/30/30 a rank a step.  (2) In this process, an inf scaled
   into four lm_head weights at step 3: steps 3-5 skipped with the
   params, moments and AdamW's step bitwise unchanged, the blown skip
   budget rolling back to the step-2 snapshot bitwise, steps 6-9
   finite.  (3) ``save_async`` after two steps, step 3 run at once in
   place; the save restored into a fresh tree and optimizer is the
   step-2 state bitwise and steps 3-4 from it repeat the uninterrupted
   run's losses and fingerprints; a byte flipped on disk is refused
   with its leaf named.  (4) A worker: the ``checkpoint`` request (save,
   background save, status, restores into the live tensors) and the
   ``guard`` request (status, audit, off, on) on CUDA tensors, and the
   ``tg`` field on its pings.  Rows, reported: the fingerprint's ms
   beside its bound, a snapshot's ms, the guarded step beside the
   unguarded one, the save's and restore's GB/s, ``save_async``'s
   synchronous ms, peak GB a rank.

Phases 7-10 and 13-14 run each server with the launch counts reset
just before and K4's read just after, held to one per layer per decode
step (per round: the draft's launches), and their K4 launches join
phase 5's in the kernels line (``launches_by_path``), as do the
worker's K1 and K4 launches (``cluster_serve``), as the MoE
forward's and MoE training's K1/K2/K3 launches join the SmolLM2
paths', the mesh runs' K4 launches on rank 0 (``mesh_*``) and the
mesh training runs' K1/K2/K3 launches on rank 0 (``train_mesh_*``,
``train_sp_*``, ``grad_sp_*``, ``train_pp_*``), the dots step's
(``train_remat_dots``) and phase 22's (``train_guard_*``,
``train_checkpoint``, ``cluster_guard``).

``python3 chip_smoke.py --mesh-nccl`` runs phases 18, 19, 20 and 21's
ranks and phase 22's guarded replicas alone on four cards, one NCCL
rank per card (what one card cannot
show: NCCL, its ``reduce_scatter_tensor``, its point-to-point ring and
pipeline hops overlapping compute, ``all_to_all_single``, and the links
between cards).

Then one JSON line listing the kernels (each with its design, bf16 /
fp32, and ptxas's registers, spills and static shared memory per
instantiation), and as the last line
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Exits non-zero, printing no result,
when there is no CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, data sheet
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor-core peak, data sheet

N_LAYERS_SMOL = 30


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, iters=30, warmup=3):
    """Mean device time of ``fn`` in ms: CUDA events around ``iters``
    calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=30, reps=10):
    """Device time of one call of ``fn`` in ms: ``calls`` calls captured
    in a CUDA graph, replayed ``reps`` times between CUDA events, so the
    host's launch overhead stays out of the time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * reps)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def tol_ratio(got, want, atol, rtol):
    """Worst |got - want| / (atol + rtol * |want|) over the elements:
    within tolerance when it is at most 1 (``torch.allclose``'s test)."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


# The plain side computes in fp32 and rounds once to the output dtype,
# so a bf16 element may differ by one bf16 ulp (at most 2^-7 = 7.8e-3 of
# its magnitude) where two fp32 results straddle a rounding boundary.
# K1 sums its keys in another order (tile by tile, rescaled) and in bf16
# rounds P to bf16 before P.V, as attention_reference does, so it gets
# more room than K4; the lse is fp32 on both sides.  fp32 K4 sums its
# keys in another order (chunks, warps) than the plain version's one
# pass.  Measured errors are in PERF.md beside each limit.
K1_TOL = {"bfloat16": (4e-3, 1e-2), "float32": (1e-5, 1e-5)}
K4_TOL = {"bfloat16": (1e-3, 8e-3), "float32": (1e-5, 1e-5)}
LSE_TOL = 1e-4
# K2/K3 sum up to S * group terms per element (dK/dV over every row of
# the group that sees a key), in tiles, where the plain version sums in
# one GEMM: bf16 keeps K1's room (K3 feeds P and dS to the tensor cores
# as bf16 hi + lo pairs: one rounding alone goes past it); fp32 allows
# the longer sums' reassociation (~1e-6 of the sum of |terms|, ~10-100).
K23_TOL = {"bfloat16": (4e-3, 1e-2), "float32": (1e-4, 1e-4)}
# fp32 loss and gradients through the kernels against the plain path
# (autograd of attention_reference), relative L2 per leaf: 30 layers of
# fp32 sums in different orders, each ~1e-6 relative.
TRAIN_FP32_TOL = 1e-4


# ----------------------------------------------------------------------
# phase 2: K1 against its plain version

def k1_inputs(B, S, H, Hkv, D, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(dtype)
    return q, k, v


def case_segments(kind, B, S):
    """Segment ids (B, S), int32 on the card: None; ``"cuts"``, the same
    documents in every row, cut at 300, 301 and 700; or ``"train"``, the
    training path's own batch (``packed_batch``, documents of 64-1536
    tokens packed by ``pack_tokens``)."""
    import torch
    if kind is None:
        return None
    if kind == "train":
        from nbdistributed_tpu_torch.models import smol_135m_config
        seg = packed_batch(smol_135m_config(), B, S,
                           seed=TRAIN_BATCH_SEED)["segments"]
        return seg.to(torch.int32).contiguous()
    cuts = torch.tensor([0, 300, 301, 700, S])
    seg = torch.bucketize(torch.arange(S), cuts[1:-1], right=True)
    return seg[None].expand(B, S).to("cuda", torch.int32).contiguous()


def check_k1(name, out, lse, ref, ref_lse, dtype):
    """Hold K1's (out, lse) to the plain version's; returns the output's
    max abs error."""
    import torch
    atol, rtol = K1_TOL[str(dtype).split(".")[-1]]
    e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
    ratio = tol_ratio(out, ref, atol, rtol)
    say("k1_vs_plain", case=name, max_abs_err=e_out, tol_ratio=ratio,
        atol=atol, rtol=rtol, lse_err=e_lse, lse_tol=LSE_TOL)
    check(torch.isfinite(out.float()).all().item(),
          f"K1 {name}: non-finite output")
    check(ratio <= 1 and e_lse <= LSE_TOL,
          f"K1 {name}: error {e_out} (ratio {ratio}) / lse {e_lse} "
          f"over tolerance")
    return e_out


def phase_k1():
    """K1 through the wrappers the path calls — ``flash_attention`` for
    the output, ``_flash_forward`` (the JAX counterpart's entry, which
    returns the lse) — against ``_flash_forward_plain``: one 64 x 64
    tile (the tensor-core layout alone), group 1, the serving shapes,
    the training path's (B=4, S=2048, without and with its batch's
    segments) and Mixtral's attention (H=32, Hkv=8, D=128) in bf16 and
    fp32."""
    import torch
    from nbdistributed_tpu_torch.ops import attention as A

    bf16, fp32 = torch.bfloat16, torch.float32
    # name, B, S, H, Hkv, D, dtype, window, segments
    cases = [("one_tile_S64", 1, 64, 1, 1, 64, bf16, None, None),
             ("group1_S1024", 2, 1024, 4, 4, 64, bf16, None, None),
             ("causal_S1024", 2, 1024, 9, 3, 64, bf16, None, None),
             ("causal_ragged_S1000", 2, 1000, 9, 3, 64, bf16, None, None),
             ("window256_S1024", 2, 1024, 9, 3, 64, bf16, 256, None),
             ("segments_S1024", 2, 1024, 9, 3, 64, bf16, None, "cuts"),
             ("forward_shape_S512", 1, 512, 9, 3, 64, bf16, None, None),
             ("train_shape_S2048", TRAIN_B, 2048, 9, 3, 64, bf16, None,
              None),
             ("train_shape_S2048_segments", TRAIN_B, 2048, 9, 3, 64, bf16,
              None, "train"),
             ("fp32_ragged_S1000", 2, 1000, 9, 3, 64, fp32, None, None),
             ("mixtral_S2048_g4_D128", 1, 2048, 32, 8, 128, bf16, None,
              None),
             ("fp32_mixtral_S2048_g4_D128", 1, 2048, 32, 8, 128, fp32, None,
              None)]
    worst = 0.0
    for name, B, S, H, Hkv, D, dtype, window, segs in cases:
        q, k, v = k1_inputs(B, S, H, Hkv, D, dtype, seed=len(name))
        seg = case_segments(segs, B, S)
        scale = 1.0 / D ** 0.5
        out = A.flash_attention(q, k, v, causal=True, scale=scale,
                                window=window, segment_ids=seg)
        out2, lse = A._flash_forward(q, k, v, causal=True, scale=scale,
                                     window=window, segment_ids=seg)
        torch.cuda.synchronize()
        ref, ref_lse = A._flash_forward_plain(
            q, k, v, causal=True, scale=scale, window=window,
            segment_ids=seg, kv_segment_ids=seg)
        e_out = check_k1(name, out, lse, ref, ref_lse, dtype)
        check(torch.equal(out, out2), f"K1 {name}: flash_attention and "
              f"_flash_forward disagree")
        if dtype == torch.bfloat16:
            worst = max(worst, e_out)
    return worst


# ----------------------------------------------------------------------
# phase 3: K4 against its plain version

def serving_pos(B):
    """Decode positions as the main path's 16..232-token streams give
    them (prompts of 16-200 tokens plus up to 32 new ones)."""
    import torch
    g = torch.Generator().manual_seed(3)
    return torch.randint(16, 233, (B,), generator=g).to("cuda", torch.int32)


def k4_inputs(B, Hkv, group, D, T, cache, seed, pos=None,
              qdtype=None):
    """Decode inputs on the card: q (B, H, D) in ``qdtype`` (bf16, or
    fp32 for an fp32 cache); a (B, Hkv, T, D) cache, ``cache`` one of
    "bf16", "fp32" or "int8" (with (B, Hkv, T, 1) fp32 scales); pos, by
    default spread over [0, T-1]."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    fp32 = cache == "fp32"
    qdtype = qdtype or (torch.float32 if fp32 else torch.bfloat16)
    q = torch.randn(B, Hkv * group, D, generator=g, device="cuda").to(qdtype)
    ks = vs = None
    if cache == "int8":
        kc = torch.randint(-127, 128, (B, Hkv, T, D), generator=g,
                           device="cuda").to(torch.int8)
        vc = torch.randint(-127, 128, (B, Hkv, T, D), generator=g,
                           device="cuda").to(torch.int8)
        ks = torch.rand(B, Hkv, T, 1, generator=g, device="cuda") * 0.02
        vs = torch.rand(B, Hkv, T, 1, generator=g, device="cuda") * 0.02
    else:
        cdt = torch.float32 if fp32 else torch.bfloat16
        kc = torch.randn(B, Hkv, T, D, generator=g, device="cuda").to(cdt)
        vc = torch.randn(B, Hkv, T, D, generator=g, device="cuda").to(cdt)
    if pos is None:
        pos = torch.linspace(0, T - 1, B).round().to("cuda", torch.int32)
    return q, kc, vc, ks, vs, pos


def past_valid_pos(B, T):
    """Positions over [0, T-1] with the last two rows past the cache
    (the sequence-parallel caller's case): with window 256, row B-1
    (pos T+300) attends nothing (lo >= valid_k) and row B-2 (pos T+100)
    the cache's last 155 keys."""
    import torch
    pos = torch.linspace(0, T - 1, B).round().to(torch.int32)
    pos[-1], pos[-2] = T + 300, T + 100
    return pos.to("cuda")


def shard_pos(values):
    import torch
    return torch.tensor(values, dtype=torch.int32, device="cuda")


def phase_k4():
    """K4 through ``flash_decode_attention``, the wrapper the path
    calls, against ``decode_reference``: per-row positions over [0, T-1]
    at T=2048 with a window and int8 variants, fp32 caches, T=1000
    (ragged against the 128-key chunk), rows whose window lies past
    every valid key, groups 1 and 8, D=32 and 128 in each cache type
    (every key-tile geometry of the kernel), one chunk (B*Hkv=576:
    nsplit = 1, no combine), and the main path's own shape (B=8 slots,
    T=max_len=1024, serving positions), its full context (T=2048, every
    slot at 2047), a paged step's gathered view (±3e4 past every row's
    position) and the Mixtral serving shape (Hkv=8, group 4, D=128,
    T=1024) in bf16, int8 and fp32; and the mesh phase's shard shapes
    (SmolLM2's dp x sp rank: B=4, Hkv=3, T=512 and the path's T=128;
    Mixtral's tp x sp rank: Hkv=4, group 4, D=128) at shifted positions,
    negative and past the slice, and with a window wholly past it.
    Returns the worst bf16 output error."""
    import torch
    from nbdistributed_tpu_torch.ops import decode as K
    from nbdistributed_tpu_torch.ops._common import NEG_INF

    fp32 = torch.float32
    # name, B, Hkv, group, D, T, window, cache, positions, q dtype
    cases = [("pos_spread", 8, 3, 3, 64, 2048, None, "bf16", None, None),
             ("window256", 8, 3, 3, 64, 2048, 256, "bf16", None, None),
             ("int8_scales", 8, 3, 3, 64, 2048, None, "int8", None, None),
             ("int8_window256", 8, 3, 3, 64, 2048, 256, "int8", None, None),
             ("fp32_pos_spread", 8, 3, 3, 64, 2048, None, "fp32", None,
              None),
             ("ragged_T1000", 8, 3, 3, 64, 1000, None, "bf16", None, None),
             ("window_past_valid_T1000", 8, 3, 3, 64, 1000, 256, "bf16",
              "past", None),
             ("fp32_window_past_valid_T1000", 8, 3, 3, 64, 1000, 256,
              "fp32", "past", None),
             ("group1_T1000", 8, 9, 1, 64, 1000, None, "bf16", None, None),
             ("group8_T1000", 8, 1, 8, 64, 1000, 256, "bf16", "past", None),
             ("D32_T1000", 8, 3, 3, 32, 1000, None, "bf16", None, None),
             ("D128_T1000", 8, 3, 3, 128, 1000, None, "bf16", None, None),
             ("fp32_D32_T1000", 8, 3, 3, 32, 1000, None, "fp32", None, None),
             ("fp32_D128_T1000", 8, 3, 3, 128, 1000, None, "fp32", None,
              None),
             ("int8_D32_T1000", 8, 3, 3, 32, 1000, None, "int8", None, None),
             ("int8_D128_T1000", 8, 3, 3, 128, 1000, None, "int8", None,
              None),
             ("int8_fp32q_T1000", 8, 3, 3, 64, 1000, 256, "int8", "past",
              fp32),
             ("one_chunk_B64_T1000", 64, 9, 1, 64, 1000, 256, "bf16",
              "past", None),
             ("serving_shape_T1024", 8, 3, 3, 64, 1024, None, "bf16",
              "serving", None),
             ("paged_view_garbage_T1024", 8, 3, 3, 64, 1024, None, "bf16",
              "garbage", None),
             ("full_context_T2048", 8, 3, 3, 64, 2048, None, "bf16", "full",
              None),
             ("mixtral_g4_D128_T1024", 8, 8, 4, 128, 1024, None, "bf16",
              "serving", None),
             ("int8_mixtral_g4_D128_T1024", 8, 8, 4, 128, 1024, None,
              "int8", "serving", None),
             ("fp32_mixtral_g4_D128_T1024", 8, 8, 4, 128, 1024, None,
              "fp32", "serving", None),
             # The mesh phase's shard shapes: a dp x sp rank's (B=4 of 8
             # slots, T/2 of the cache) and Mixtral's tp x sp rank's
             # (Hkv=4 of 8), at positions shifted by the slice's offset:
             # negative (the slice holds none of the row's keys), inside,
             # and past it (all of them); a window wholly past the slice.
             ("shard_T512_shifted", 4, 3, 3, 64, 512, None, "bf16",
              "shard", None),
             ("fp32_shard_T512_shifted", 4, 3, 3, 64, 512, None, "fp32",
              "shard", None),
             ("shard_T512_window_past_slice", 4, 3, 3, 64, 512, 256,
              "bf16", "shard_window", None),
             ("fp32_shard_T512_window_past_slice", 4, 3, 3, 64, 512, 256,
              "fp32", "shard_window", None),
             ("shard_mixtral_g4_D128_T512", 8, 4, 4, 128, 512, None, "bf16",
              "shard_shifted", None),
             ("fp32_shard_mixtral_g4_D128_T512", 8, 4, 4, 128, 512, None,
              "fp32", "shard_shifted", None),
             ("fp32_shard_path_T128", 4, 3, 3, 64, MESH_MAX_LEN // 2, None,
              "fp32", "shard_shifted", None),
             ("fp32_shard_mixtral_path_g4_D128_T128", 8, 4, 4, 128,
              MESH_MAX_LEN // 2, None, "fp32", "shard_shifted", None)]
    worst = 0.0
    for name, B, Hkv, group, D, T, window, cache, kind, qdt in cases:
        pos = {None: None, "past": past_valid_pos(B, T),
               "serving": serving_pos(B), "garbage": serving_pos(B),
               "full": torch.full((B,), T - 1, dtype=torch.int32,
                                  device="cuda"),
               "shard": shard_pos([-300, -1, T // 2, T + 300]),
               "shard_window": shard_pos([-5, T // 4, T + 88, T + 300]),
               "shard_shifted": serving_pos(B) - 128}[kind]
        q, kc, vc, ks, vs, pos = k4_inputs(B, Hkv, group, D, T, cache,
                                           seed=len(name), pos=pos,
                                           qdtype=qdt)
        if kind == "garbage":
            # A paged step's dense view: whatever the trash and unwritten
            # blocks hold (finite) lies past each row's position and
            # must reach no output.
            past = (torch.arange(T, device="cuda")[None, :]
                    > pos.long()[:, None])[:, None, :, None]
            kc.masked_fill_(past, 3e4)
            vc.masked_fill_(past, -3e4)
        out, lse = K.flash_decode_attention(q, kc, vc, pos, scale=0.125,
                                            window=window, k_s=ks, v_s=vs,
                                            return_lse=True)
        out_nolse = K.flash_decode_attention(q, kc, vc, pos, scale=0.125,
                                             window=window, k_s=ks, v_s=vs)
        torch.cuda.synchronize()
        ref, ref_lse = K.decode_reference(q, kc, vc, pos, scale=0.125,
                                          window=window, k_s=ks, v_s=vs)
        atol, rtol = K4_TOL[str(q.dtype).split(".")[-1]]
        e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
        ratio = tol_ratio(out, ref, atol, rtol)
        same = torch.equal(out, out_nolse)
        # Rows that attend nothing: exactly o = 0 and lse = NEG_INF.
        valid = pos.long() + 1
        lo = valid - window if window else torch.zeros_like(valid)
        empty = torch.clamp(lo, min=0) >= torch.clamp(valid, min=0, max=T)
        n_empty = int(empty.sum())
        empty_ok = bool((out[empty] == 0).all()
                        and (lse[empty] == NEG_INF).all())
        say("k4_vs_plain", case=name, dtype=str(q.dtype), cache=cache,
            nsplit_chunk=K._decode_splits(B * Hkv, T), max_abs_err=e_out,
            tol_ratio=ratio, atol=atol, rtol=rtol, lse_err=e_lse,
            lse_tol=LSE_TOL, lse_off_identical=same,
            rows_attending_nothing=n_empty, those_rows_exact=empty_ok)
        check(torch.isfinite(out.float()).all().item(), f"K4 {name}: "
              f"non-finite output")
        check(ratio <= 1 and e_lse <= LSE_TOL and same and empty_ok,
              f"K4 {name}: error {e_out} (ratio {ratio}) / lse {e_lse} "
              f"over tolerance, or a row that attends nothing is not "
              f"o = 0, lse = NEG_INF")
        want_empty = {"past": n_empty > 0, "shard": n_empty == 2,
                      "shard_window": n_empty == 2,
                      "shard_shifted": 0 < n_empty < B}.get(kind,
                                                            n_empty == 0)
        check(want_empty, f"K4 {name}: {n_empty} rows attend nothing")
        if q.dtype == torch.bfloat16:
            worst = max(worst, e_out)
    return worst


# ----------------------------------------------------------------------
# phase 4: K2/K3 against the plain backward

def check_k23(name, got, want, dtype):
    """Hold K2/K3's (dq, dk, dv) to the plain backward's; returns
    ``{grad: {max_abs_err, tol_ratio}}``."""
    import torch
    atol, rtol = K23_TOL[str(dtype).split(".")[-1]]
    row = {}
    for gname, a, b in zip(("dq", "dk", "dv"), got, want):
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"K2/K3 {name}: {gname} is {a.dtype} {tuple(a.shape)}")
        check(torch.isfinite(a.float()).all().item(),
              f"K2/K3 {name}: non-finite {gname}")
        row[gname] = dict(max_abs_err=max_err(a, b),
                          tol_ratio=tol_ratio(a, b, atol, rtol))
    say("k23_vs_plain", case=name, atol=atol, rtol=rtol, **row)
    for gname, r in row.items():
        check(r["tol_ratio"] <= 1, f"K2/K3 {name}: {gname} error "
              f"{r['max_abs_err']} (ratio {r['tol_ratio']}) over tolerance")
    return row


def phase_k23():
    """K2/K3 through ``_flash_backward`` — the wrapper the autograd
    backward calls, which launches K2 then K3 — against
    ``_flash_backward_plain`` on the same inputs, with the forward's
    (out, lse) from K1, held first to the plain forward's; Mixtral's
    attention (S=2048, H=32, Hkv=8, D=128) in bf16 and fp32 among the
    cases.  Returns the worst bf16 errors of K2, K3 and those K1
    forwards."""
    import torch
    from nbdistributed_tpu_torch.ops import attention as A

    bf16, fp32 = torch.bfloat16, torch.float32
    # name, B, Sq, Sk, H, Hkv, D, dtype, causal, window, segments, offsets
    cases = [
        ("one_tile_S64", 1, 64, 64, 1, 1, 64, bf16, True, None, None,
         (0, 0)),
        ("group1_S1024", 2, 1024, 1024, 4, 4, 64, bf16, True, None, None,
         (0, 0)),
        ("causal_S2048_g3_D64", 2, 2048, 2048, 9, 3, 64, bf16, True, None,
         None, (0, 0)),
        ("causal_S2048_g3_D128", 1, 2048, 2048, 6, 2, 128, bf16, True,
         None, None, (0, 0)),
        ("noncausal_Sq1000_Sk1500", 2, 1000, 1500, 9, 3, 64, bf16, False,
         None, None, (0, 0)),
        ("window256_S1024", 2, 1024, 1024, 9, 3, 64, bf16, True, 256,
         None, (0, 0)),
        ("segments_S1024", 2, 1024, 1024, 9, 3, 64, bf16, True, None,
         "cuts", (0, 0)),
        ("offsets_q512_Sq512_Sk1024", 2, 512, 1024, 9, 3, 64, bf16, True,
         None, None, (512, 0)),
        ("D32_causal_S1000", 2, 1000, 1000, 4, 2, 32, bf16, True, None,
         None, (0, 0)),
        ("train_shape_S2048_segments", TRAIN_B, 2048, 2048, 9, 3, 64, bf16,
         True, None, "train", (0, 0)),
        ("fp32_causal_ragged_S1000", 2, 1000, 1000, 9, 3, 64, fp32, True,
         None, None, (0, 0)),
        ("mixtral_S2048_g4_D128", 1, 2048, 2048, 32, 8, 128, bf16, True,
         None, None, (0, 0)),
        ("fp32_mixtral_S2048_g4_D128", 1, 2048, 2048, 32, 8, 128, fp32,
         True, None, None, (0, 0)),
    ]
    worst = {"dq": 0.0, "dkv": 0.0, "k1": 0.0}
    for (name, B, Sq, Sk, H, Hkv, D, dtype, causal, window, segs,
         offsets) in cases:
        g = torch.Generator(device="cuda").manual_seed(len(name))
        q = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, Sk, Hkv, D, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, Sk, Hkv, D, generator=g, device="cuda").to(dtype)
        do = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
        seg = case_segments(segs, B, Sq)
        args = dict(causal=causal, scale=1.0 / D ** 0.5, offsets=offsets,
                    window=window, segment_ids=seg, kv_segment_ids=seg)
        out, lse = A._flash_forward(q, k, v, **args)
        got = A._flash_backward(q, k, v, out, lse, do, **args)
        torch.cuda.synchronize()
        e_k1 = check_k1(f"{name} (K2/K3 input)", out, lse,
                        *A._flash_forward_plain(q, k, v, **args), dtype)
        want = A._flash_backward_plain(q, k, v, out, lse, do, **args)
        row = check_k23(name, got, want, dtype)
        if dtype == bf16:
            worst["k1"] = max(worst["k1"], e_k1)
            worst["dq"] = max(worst["dq"], row["dq"]["max_abs_err"])
            worst["dkv"] = max(worst["dkv"], row["dk"]["max_abs_err"],
                               row["dv"]["max_abs_err"])
    return worst


# ----------------------------------------------------------------------
# phase 5: the serving path

def make_requests(cfg, n=12, seed=11):
    import torch
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(16, 201, (n,), generator=g).tolist()
    return [torch.randint(0, cfg.vocab_size, (L,), generator=g).tolist()
            for L in lens]


def serve(params, cfg, prompts, max_new=32, **server_kw):
    """Serve ``prompts`` staggered (waves of 5, 4 and the rest, three
    steps apart) on ``DecodeServer(max_batch=8, max_len=1024,
    **server_kw)``; returns (outputs, decode steps, wall seconds,
    per-step seconds, run): ``run`` holds the server and ``waited``, the
    requests that were pending at a moment a slot was free (a paged
    pool's admissions that waited for blocks)."""
    import torch
    from nbdistributed_tpu_torch.models import DecodeServer

    srv = DecodeServer(params, cfg, **{**dict(max_batch=8, max_len=1024),
                                       **server_kw})
    waves = [prompts[:5], prompts[5:9], prompts[9:]]
    rids, steps, step_s, waited = [], 0, [], set()

    def note_waiting():
        if srv._free:
            waited.update(r for r, _, _ in srv._pending)

    def one_step():
        nonlocal steps
        ts = time.perf_counter()
        if srv.step():
            steps += 1
            step_s.append(time.perf_counter() - ts)
        note_waiting()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for wave in waves:
        rids += [srv.submit(p, max_new) for p in wave]
        note_waiting()
        for _ in range(3):
            one_step()
    while not srv.done():
        one_step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([srv.outputs[r] for r in rids], steps, wall, step_s,
            dict(server=srv, waited=len(waited)))


def phase_main_path(seed=0):
    """Counts reset, full-width forward + bf16 serving, counts read."""
    import torch
    from nbdistributed_tpu_torch.models import (forward, init_params,
                                                smol_135m_config)
    from nbdistributed_tpu_torch.ops import (flash_attention,
                                             flash_decode_attention)

    cfg = smol_135m_config()
    params = init_params(cfg, seed)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), generator=g)
    prompts = make_requests(cfg)

    reset_launch_counts()
    logits = forward(params, tokens, cfg)
    outputs, steps, wall, step_s, _ = serve(params, cfg, prompts)
    k1 = flash_attention.launches
    k4 = flash_decode_attention.launches
    say("main_path_counts", k1_launches=k1, k4_launches=k4,
        decode_steps=steps, want_k1=N_LAYERS_SMOL,
        want_k4=N_LAYERS_SMOL * steps)
    check(k1 == N_LAYERS_SMOL, f"K1 launched {k1} times, want 30")
    check(steps > 0 and k4 == N_LAYERS_SMOL * steps,
          f"K4 launched {k4} times over {steps} decode steps")

    n_tok = sum(len(o) for o in outputs)
    check(all(len(o) == 32 for o in outputs), "a request fell short")
    check(all(0 <= t < cfg.vocab_size for o in outputs for t in o),
          "token out of vocabulary")
    step_s = sorted(step_s)
    say("serve_bf16", requests=len(outputs), tokens=n_tok,
        decode_steps=steps, wall_s=wall, tokens_per_s=n_tok / wall,
        ms_per_step_mean=1e3 * sum(step_s) / len(step_s),
        ms_per_step_median=1e3 * step_s[len(step_s) // 2])

    # The kernel path's logits against the plain path's (both bf16):
    # every layer rounds its attention output to bf16 in a different
    # place, so hold the relative L2 error to 5e-2.
    plain = forward(params, tokens, dataclasses.replace(cfg,
                                                        use_flash=False))
    check(torch.isfinite(logits).all().item() and logits.shape ==
          (1, 512, cfg.vocab_size), "forward: bad logits")
    rel = float((logits - plain).norm() / plain.norm())
    agree = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    say("forward_bf16", rel_l2_err=rel, tol=5e-2, argmax_agree=agree,
        max_abs_err=max_err(logits, plain))
    check(rel <= 5e-2, f"forward bf16: relative error {rel}")
    dense = dict(outputs=outputs, tokens_per_s=n_tok / wall,
                 ms_per_step_median=1e3 * step_s[len(step_s) // 2])
    return {"k1": k1, "k4": k4, "steps": steps}, prompts, params, dense


def profile_steps(step, n_steps):
    """``torch.profiler`` over ``n_steps`` calls of ``step``: device
    kernel time per step against the host's wall time, the idle share,
    kernels per step and the kernels that take the most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    kernels = []
    for e in prof.key_averages():
        # A user annotation (``Optimizer.step#AdamW.step``) spans kernels
        # already counted: it is a range, not device work.
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us / 1e3 / n_steps, e.count / n_steps, e.key))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    return dict(wall_ms_per_step=wall_ms,
                device_ms_per_step=busy if kernels else "not measured",
                idle_share=1 - busy / wall_ms if kernels else "not measured",
                kernels_per_step=sum(k[1] for k in kernels),
                top=[dict(name=k[2][:80], ms_per_step=k[0],
                          calls_per_step=k[1]) for k in kernels[:8]])


def phase_profile(params, n_steps=8, name="profile_decode_step", cfg=None,
                  **server_kw):
    """Where a bf16 decode step's time goes: a profile of ``n_steps``
    steps of a full 8-slot server (128-token prompts) of ``cfg``
    (SmolLM2-135M by default), built with ``server_kw`` (a paged or a
    speculative server)."""
    import torch
    from nbdistributed_tpu_torch.models import (DecodeServer,
                                                smol_135m_config)

    cfg = cfg or smol_135m_config()
    srv = DecodeServer(params, cfg, max_batch=8, max_len=1024, **server_kw)
    g = torch.Generator().manual_seed(13)
    for _ in range(8):
        srv.submit(torch.randint(0, cfg.vocab_size, (128,),
                                 generator=g).tolist(), 8 * n_steps + 16)
    srv.step()
    srv.step()
    row = profile_steps(srv.step, n_steps)
    say(name, **row)
    return row


# A served fp32 stream may leave its reference only where the
# reference's top-2 logits are this close: the two runs sum in other
# orders (batch shapes, the verify's S = gamma + 1, a chunk's or a
# suffix's prefill), ~1e-6 apart at SmolLM2's width.
NEAR_TIE = 1e-4


def near_tie_check(name, params, cfg, prompts, got, want):
    """Hold served fp32 streams ``got`` to their references ``want``
    (solo ``generate`` or another server), token for token, except at a
    near-tie: where stream i first differs at step j, the reference's
    top-2 logit gap after ``prompts[i] + want[i][:j]`` (one fresh
    prefill) must be below NEAR_TIE.  Prints and returns the gaps."""
    import torch
    from nbdistributed_tpu_torch.models import (forward_with_cache,
                                                init_kv_cache)

    gaps = []
    for prompt, g, w in zip(prompts, got, want):
        check(len(g) == len(w), f"{name}: {len(g)} tokens, reference "
              f"{len(w)}")
        j = next((i for i, (x, y) in enumerate(zip(g, w)) if x != y), None)
        if j is None:
            continue
        cache = init_kv_cache(cfg, 1, len(prompt) + j, device="cuda")
        logits, _ = forward_with_cache(params, [prompt + w[:j]], cache, 0,
                                       cfg, last_only=True)
        top2 = torch.topk(logits[0, -1], 2).values
        gap = float(top2[0] - top2[1])
        gaps.append(gap)
        check(gap < NEAR_TIE, f"{name}: diverged from its reference at "
              f"step {j} where the reference's top-2 gap is {gap}")
    say(name, requests=len(got), divergences_at_near_ties=len(gaps),
        gaps=gaps, near_tie=NEAR_TIE)
    return gaps


def solo_outputs(params, cfg, prompts, max_new=32):
    """Each prompt's ``max_new`` tokens from a solo ``generate``."""
    from nbdistributed_tpu_torch.models import generate
    return [generate(params, [p], cfg, max_new)[0, len(p):].tolist()
            for p in prompts]


def phase_fp32(prompts, seed=0):
    """fp32 forward kernel vs plain, and fp32 serving vs solo generate
    under the near-tie rule.  Returns the fp32 parameters and the solo
    outputs, which the later serving paths reuse as references."""
    import torch
    from nbdistributed_tpu_torch.models import (forward, init_params,
                                                smol_135m_config)

    cfg = smol_135m_config(dtype=torch.float32)
    params = init_params(cfg, seed)
    g = torch.Generator().manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), generator=g)
    a = forward(params, tokens, cfg)
    b = forward(params, tokens, smol_135m_config(dtype=torch.float32,
                                                 use_flash=False))
    rel = float((a - b).norm() / b.norm())
    say("forward_fp32", rel_l2_err=rel, tol=1e-4, max_abs_err=max_err(a, b))
    check(rel <= 1e-4, f"forward fp32: relative error {rel}")

    outputs, steps, _, _, _ = serve(params, cfg, prompts)
    solo = solo_outputs(params, cfg, prompts)
    near_tie_check("serve_fp32_vs_solo", params, cfg, prompts, outputs, solo)
    say("serve_fp32", requests=len(prompts), decode_steps=steps)
    return params, solo


# ----------------------------------------------------------------------
# phases 7-10: serving beyond the dense pool.  Every server run below
# has its counts reset just before and K4's read just after, held to
# what the run must launch; a path's launches are its own servers'
# runs, not those of the dense or unprefixed servers it is held to.

PAGED = dict(kv_block_tokens=64, kv_blocks=16)   # 1/8 of the dense pool
GAMMA = 4


def k4_launches():
    from nbdistributed_tpu_torch.ops import flash_decode_attention
    return flash_decode_attention.launches


def counted_serve(path, want_per_step, params, cfg, prompts, **kw):
    """``serve`` as one run of ``path``: counts reset just before, K4's
    read just after, which must be ``want_per_step`` per decode step
    (per round on a speculative server).  Returns serve's result and
    the run's K4 launches."""
    reset_launch_counts()
    out = serve(params, cfg, prompts, **kw)
    k4, steps = k4_launches(), out[1]
    check(steps > 0 and k4 == want_per_step * steps,
          f"{path}: K4 launched {k4} times over {steps} steps, want "
          f"{want_per_step} per step")
    return out, k4


def gather_costs(cfg):
    """Device time (CUDA-graph replay: each is a handful of launches
    that take the host longer to launch than the card to run) of the paged
    step's gather (every slot's 16 blocks into the dense (L, 8, Hkv,
    1024, D) view, K and V) and of its one-block-per-slot scatter, bf16,
    at the serving shape."""
    import torch
    from nbdistributed_tpu_torch.models import paged_kv

    pool = paged_kv.make_paged_pool(cfg, 8 * 16, 64, device="cuda")
    table = torch.arange(8 * 16, dtype=torch.int32,
                         device="cuda").reshape(8, 16)
    dense = paged_kv.gather_dense(pool, table)
    pos = serving_pos(8)
    active = torch.ones(8, dtype=torch.bool, device="cuda")
    gather = graph_ms(lambda: paged_kv.gather_dense(pool, table), 10, 5)
    scatter = graph_ms(lambda: paged_kv.scatter_step(
        pool, dense, table, pos, active, 8 * 16, 64), 10, 5)
    nbytes = 2 * sum(t.numel() * t.element_size() for t in dense.values())
    return dict(gather_ms=gather, scatter_ms=scatter, gather_bytes=nbytes,
                gather_bound_ms=1e3 * nbytes / HBM_BYTES_PER_S)


def phase_serve_paged(params, prompts, dense, params32, solo32):
    """The paged server (bf16, 16 blocks of 64 tokens: 1/8 of the dense
    pool's 128) on phase 5's requests: token for token the dense bf16
    server's, with admissions that waited for blocks while a slot was
    free and every block back at the end; then, on 8 of them, int8 KV
    paged against int8 KV dense and fp32 paged against solo generate
    (near-tie rule)."""
    from nbdistributed_tpu_torch.models import smol_135m_config

    cfg = smol_135m_config()
    L = N_LAYERS_SMOL
    (outs, steps, wall, step_s, run), k4 = counted_serve(
        "serve_paged", L, params, cfg, prompts, **PAGED)
    snap = run["server"].kv_snapshot()
    step_s = sorted(step_s)
    n_tok = sum(len(o) for o in outs)
    say("serve_paged_bf16", requests=len(outs), decode_steps=steps,
        k4_launches=k4, want_k4=L * steps, waited_for_blocks=run["waited"],
        kv_snapshot_end=snap, equal_to_dense=outs == dense["outputs"],
        tokens_per_s=n_tok / wall, dense_tokens_per_s=dense["tokens_per_s"],
        ms_per_step_median=1e3 * step_s[len(step_s) // 2],
        dense_ms_per_step_median=dense["ms_per_step_median"])
    check(outs == dense["outputs"], "paged bf16 serving differs from the "
          "dense bf16 server")
    check(run["waited"] > 0, "no admission waited for blocks")
    check(snap["used"] == 0 and snap["owners"] == {},
          f"blocks still held at the end: {snap}")
    total = k4

    (int8_dense, *_), _ = counted_serve("serve_paged", L, params, cfg,
                                        prompts[:8], kv_quantized=True)
    (int8_paged, *_), k4 = counted_serve("serve_paged", L, params, cfg,
                                         prompts[:8], kv_quantized=True,
                                         **PAGED)
    total += k4
    say("serve_paged_int8_kv", equal_to_dense_int8_kv=int8_paged ==
        int8_dense)
    check(int8_paged == int8_dense, "paged int8-KV serving differs from "
          "the dense int8-KV server")

    cfg32 = smol_135m_config(dtype=params32["embed"].dtype)
    (outs32, *_), k4 = counted_serve("serve_paged", L, params32, cfg32,
                                     prompts[:8], **PAGED)
    total += k4
    near_tie_check("serve_paged_fp32_vs_solo", params32, cfg32, prompts[:8],
                   outs32, solo32[:8])
    costs = gather_costs(cfg)
    say("paged_gather_cost", **costs)
    profile = phase_profile(params, 4, name="profile_paged_step",
                            kv_block_tokens=64)
    return dict(k4=total, steps=steps, costs=costs, profile=profile,
                waited=run["waited"], tokens_per_s=n_tok / wall)


def truncated_draft(params, n_layers=2):
    """The target's first ``n_layers`` layers with its embed, final norm
    and lm_head (views, no copy)."""
    return dict(params, layers={k: v[:n_layers]
                                for k, v in params["layers"].items()})


def self_draft_rounds(params, cfg, prompts, max_new=32):
    """fp32 self-draft (draft = target): serve ``prompts``, and for each
    round in which a stream accepted fewer than GAMMA proposals though
    its budget allowed more, the target's top-2 gap at the first
    rejection (a fresh prefill of the stream up to the position the
    target corrected).  Returns (rounds, those gaps, outputs, K4)."""
    import torch
    from nbdistributed_tpu_torch.models import (DecodeServer,
                                                forward_with_cache,
                                                init_kv_cache)

    srv = DecodeServer(params, cfg, max_batch=8, max_len=1024,
                       draft_params=params, draft_cfg=cfg, gamma=GAMMA)
    reset_launch_counts()
    rids = [srv.submit(p, max_new) for p in prompts]
    rounds, short = 0, []
    while not srv.done():
        before = {r: len(srv.outputs[r]) for r in rids}
        emitted = srv.step()
        rounds += bool(emitted)
        for rid, toks in emitted.items():
            if len(toks) < min(GAMMA + 1, max_new - before[rid]):
                short.append((rid, before[rid] + len(toks) - 1))
    k4 = k4_launches()
    gaps = []
    for rid, j in short:
        ctx = srv.prompts[rid] + srv.outputs[rid][:j]
        cache = init_kv_cache(cfg, 1, len(ctx), device="cuda")
        logits, _ = forward_with_cache(params, [ctx], cache, 0, cfg,
                                       last_only=True)
        top2 = torch.topk(logits[0, -1], 2).values
        gaps.append(float(top2[0] - top2[1]))
    return rounds, gaps, [srv.outputs[r] for r in rids], k4


def phase_serve_speculative(params, prompts, dense, params32, solo32):
    """Speculative serving, gamma 4, draft = the target's first 2
    layers: fp32 on 8 requests against solo generate (near-tie rule);
    fp32 self-draft, every round accepting all 4 but at near-ties; bf16
    on the 12 requests: tokens per round, ms per round, tokens/s.  Each
    round launches K4 (gamma + 1) x 2 times (the draft's 4 proposals and
    its extra write); the target's verify (S = 5) launches none."""
    from nbdistributed_tpu_torch.models import smol_135m_config

    cfg32 = smol_135m_config(dtype=params32["embed"].dtype)
    want_per_round = (GAMMA + 1) * 2
    spec32 = dict(draft_params=truncated_draft(params32),
                  draft_cfg=smol_135m_config(dtype=cfg32.dtype, n_layers=2),
                  gamma=GAMMA)
    (outs32, rounds32, *_), total = counted_serve(
        "serve_speculative", want_per_round, params32, cfg32, prompts[:8],
        **spec32)
    near_tie_check("serve_speculative_fp32_vs_solo", params32, cfg32,
                   prompts[:8], outs32, solo32[:8])

    rounds, gaps, outs_self, k4 = self_draft_rounds(params32, cfg32,
                                                    prompts[:8])
    total += k4
    say("serve_speculative_fp32_self_draft", rounds=rounds,
        short_rounds=len(gaps), gaps_at_first_rejection=gaps,
        near_tie=NEAR_TIE, k4_launches=k4,
        want_k4=rounds * (GAMMA + 1) * N_LAYERS_SMOL)
    check(k4 == rounds * (GAMMA + 1) * N_LAYERS_SMOL,
          f"self-draft: K4 launched {k4} times over {rounds} rounds")
    check(all(g < NEAR_TIE for g in gaps), f"self-draft rejected a "
          f"proposal away from a near-tie: gaps {gaps}")
    near_tie_check("serve_speculative_fp32_self_draft_vs_solo", params32,
                   cfg32, prompts[:8], outs_self, solo32[:8])

    cfg = smol_135m_config()
    spec = dict(draft_params=truncated_draft(params),
                draft_cfg=smol_135m_config(n_layers=2), gamma=GAMMA)
    (outs, rounds, wall, step_s, _), k4 = counted_serve(
        "serve_speculative", want_per_round, params, cfg, prompts, **spec)
    total += k4
    step_s = sorted(step_s)
    n_tok = sum(len(o) for o in outs)
    row = dict(requests=len(outs), rounds=rounds, k4_launches=k4,
               want_k4=rounds * want_per_round,
               tokens_per_round_all_slots=(n_tok - len(outs)) / rounds,
               ms_per_round_median=1e3 * step_s[len(step_s) // 2],
               tokens_per_s=n_tok / wall,
               dense_tokens_per_s=dense["tokens_per_s"])
    say("serve_speculative_bf16", **row)
    check(all(len(o) == 32 and all(0 <= t < cfg.vocab_size for t in o)
              for o in outs), "speculative bf16: a stream fell short or "
          "left the vocabulary")
    profile = phase_profile(params, 4, name="profile_speculative_round",
                            **spec)
    return dict(k4=total, bf16=row, profile=profile,
                self_draft_short_rounds=len(gaps))


def random_prompts(cfg, lens, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
            for n in lens]


def phase_serve_prefix_chunked(params, params32):
    """Prefix caching (fp32): a 384-token prefix through
    ``cache_prefix``, 8 requests of prefix + a 16-64-token suffix, equal
    to a server without the prefix (near-tie rule), with the prefill
    positions each fed.  Chunked, interleaved prefill (``prefill_chunk
    =128``, ``max_len=2048``): 4 prompts of 600-1500 tokens and 4 short
    ones, fp32 equal to solo generate (near-tie rule); bf16, the
    slowest decode step while a long prompt streams in beside one
    unchunked admission step."""
    import torch
    from nbdistributed_tpu_torch.models import DecodeServer, smol_135m_config

    L = N_LAYERS_SMOL
    cfg32 = smol_135m_config(dtype=params32["embed"].dtype)
    g = torch.Generator().manual_seed(17)
    prefix = random_prompts(cfg32, [384], 17)[0]
    suffixes = random_prompts(
        cfg32, torch.randint(16, 65, (8,), generator=g).tolist(), 18)
    prompts = [prefix + s for s in suffixes]
    fed, runs, total = {}, {}, 0
    for key in ("with", "without"):
        srv = DecodeServer(params32, cfg32, max_batch=8, max_len=1024)
        if key == "with":
            srv.cache_prefix(prefix)
        fed[key] = 0

        # Count the positions each admission feeds through the prefill
        # forward (the prefix's own prefill above is not counted).
        def counting(p, cache, prompt, slot, start, length,
                     orig=srv._prefill_fn, key=key):
            fed[key] += prompt.shape[1]
            return orig(p, cache, prompt, slot, start, length)

        srv._prefill_fn = counting
        reset_launch_counts()
        rids = [srv.submit(p, 32) for p in prompts]
        steps = 0
        while not srv.done():
            steps += bool(srv.step())
        k4 = k4_launches()
        check(k4 == L * steps, f"prefix run: K4 launched {k4} times over "
              f"{steps} steps")
        total += k4 if key == "with" else 0
        runs[key] = [srv.outputs[r] for r in rids]
    near_tie_check("serve_prefix_fp32_vs_no_prefix", params32, cfg32,
                   prompts, runs["with"], runs["without"])
    say("serve_prefix_positions", prefix_tokens=len(prefix),
        suffix_tokens=[len(s) for s in suffixes],
        prefill_positions_with_prefix=fed["with"],
        prefill_positions_without=fed["without"])
    check(fed["with"] < fed["without"], "the prefix saved no prefill")

    lens = torch.randint(600, 1501, (4,), generator=g).tolist()
    short = torch.randint(16, 129, (4,), generator=g).tolist()  # one chunk
    chunked_prompts = random_prompts(cfg32, short + lens, 19)
    chunk = dict(prefill_chunk=128, interleave_prefill=True, max_len=2048)
    (outs32, *_), k4 = counted_serve("serve_prefix_chunked", L, params32,
                                     cfg32, chunked_prompts, **chunk)
    total += k4
    near_tie_check("serve_chunked_fp32_vs_solo", params32, cfg32,
                   chunked_prompts, outs32,
                   solo_outputs(params32, cfg32, chunked_prompts))

    # bf16: 4 short streams decode while one long prompt streams in,
    # chunk by chunk; against one unchunked admission of it.
    cfg = smol_135m_config()

    def stream_in(**kw):
        reset_launch_counts()
        srv = DecodeServer(params, cfg, **{**dict(max_batch=8,
                                                  max_len=2048), **kw})
        for p in chunked_prompts[:4]:
            srv.submit(p, 64)
        steps = sum(bool(srv.step()) for _ in range(3))
        times = []
        torch.cuda.synchronize()
        ts = time.perf_counter()
        srv.submit(chunked_prompts[-1], 8)
        while srv.prefill_progress() or not times:
            steps += bool(srv.step())
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - ts))
            ts = time.perf_counter()
        k4 = k4_launches()
        check(k4 == L * steps, f"stream-in run: K4 launched {k4} times "
              f"over {steps} steps")
        return times, k4

    chunked_ms, k4 = stream_in(**chunk)
    total += k4
    mono_ms, _ = stream_in()
    row = dict(long_prompt=len(chunked_prompts[-1]), prefill_chunk=128,
               chunked_step_ms=chunked_ms, slowest_chunked_step_ms=max(
                   chunked_ms), unchunked_admission_step_ms=mono_ms[0])
    say("serve_chunked_bf16_stream_in", **row)
    return dict(k4=total, prefill_positions=dict(fed), stream_in=row)


def weight_bytes(tree):
    """Bytes of every tensor of a (possibly quantized) parameter tree."""
    import torch
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    return sum(weight_bytes(v) for v in tree.values())


def dequant_costs(params):
    """Device time (CUDA-graph replay) of the lm_head product at the
    decode shape (8 rows): bf16 against int8 and int4 leaves, each of
    which casts its weight to bf16 (int4: unpacks it through int32) on
    every call."""
    import torch
    from nbdistributed_tpu_torch.models import (qlinear, quantize_weight,
                                                quantize_weight4)

    w = params["lm_head"]
    x = torch.randn(8, 1, w.shape[0], device="cuda").to(w.dtype)
    leaves = {"bf16": w, "int8": quantize_weight(w),
              "int4": quantize_weight4(w, group=64)}
    return {k: dict(ms=graph_ms(lambda v=v: qlinear(x, v), 10, 5),
                    weight_bytes=weight_bytes({"w": v}))
            for k, v in leaves.items()}


def phase_serve_quantized(params, prompts, params32):
    """int8 (``quantize_params``) and int4 (``quantize_params4``, group
    64) weights of the bf16 model serving the 12 requests: weight bytes,
    decode ms per step, the forward's relative L2 against the
    unquantized forward; in fp32, 4 requests on each quantized tree
    against solo generate on the same tree (near-tie rule; the int4
    tree's solo runs are the slowest of the script)."""
    import torch
    from nbdistributed_tpu_torch.models import (forward, quantize_params,
                                                quantize_params4,
                                                smol_135m_config)

    L = N_LAYERS_SMOL
    cfg = smol_135m_config()
    cfg32 = smol_135m_config(dtype=params32["embed"].dtype)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), generator=g)
    ref = forward(params, tokens, cfg)
    kinds = {"int8": quantize_params, "int4": quantize_params4}
    rows, total = {"bf16": dict(weight_bytes=weight_bytes(params))}, 0
    for name, quantize in kinds.items():
        qp = quantize(params)
        logits = forward(qp, tokens, cfg)
        rel = float((logits - ref).norm() / ref.norm())
        (outs, steps, wall, step_s, _), k4 = counted_serve(
            "serve_quantized", L, qp, cfg, prompts)
        total += k4
        check(torch.isfinite(logits).all().item() and all(
            len(o) == 32 and all(0 <= t < cfg.vocab_size for t in o)
            for o in outs), f"{name}: bad logits or streams")
        step_s = sorted(step_s)
        rows[name] = dict(weight_bytes=weight_bytes(qp), decode_steps=steps,
                          ms_per_step_median=1e3 * step_s[len(step_s) // 2],
                          tokens_per_s=sum(map(len, outs)) / wall,
                          forward_rel_l2_vs_bf16=rel)
        say("serve_quantized_bf16", kind=name, **rows[name])
        del qp
        qp32 = quantize(params32)
        (outs32, *_), k4 = counted_serve("serve_quantized", L, qp32, cfg32,
                                         prompts[:4])
        total += k4
        near_tie_check(f"serve_quantized_{name}_fp32_vs_solo", qp32, cfg32,
                       prompts[:4], outs32,
                       solo_outputs(qp32, cfg32, prompts[:4]))
    rows["lm_head_product"] = dequant_costs(params)
    say("quantized_product_cost", **rows["lm_head_product"])
    return dict(k4=total, rows=rows)


def serving_beyond_dense(params, prompts, dense, params32, solo32):
    """Phases 7-10 in order, from phase 5's bf16 parameters, requests
    and dense outputs and the fp32 parameters and solo outputs of
    ``phase_fp32``; returns ({path: result}, {path: seconds})."""
    import torch

    beyond, seconds = {}, {}
    for name, phase, args in (
            ("serve_paged", phase_serve_paged,
             (params, prompts, dense, params32, solo32)),
            ("serve_speculative", phase_serve_speculative,
             (params, prompts, dense, params32, solo32)),
            ("serve_prefix_chunked", phase_serve_prefix_chunked,
             (params, params32)),
            ("serve_quantized", phase_serve_quantized,
             (params, prompts, params32))):
        ts = time.perf_counter()
        beyond[name] = phase(*args)
        seconds[name] = time.perf_counter() - ts
        torch.cuda.empty_cache()
    say("serving_beyond_dense_seconds", **seconds)
    return beyond, seconds


# ----------------------------------------------------------------------
# phase 11: the training path

TRAIN_B, TRAIN_STEPS, TRAIN_BATCH_SEED = 4, 8, 7


def packed_batch(cfg, B, S, seed):
    """One (B, S) batch of random documents of 64-1536 tokens, packed by
    ``pack_tokens`` (eos-separated, segments on) and fed through
    ``batch_iterator`` and ``prefetch_to_device`` as a trainer feeds
    them."""
    import numpy as np
    from nbdistributed_tpu_torch.utils.data import (batch_iterator,
                                                    pack_tokens,
                                                    prefetch_to_device)

    rng = np.random.default_rng(seed)
    docs, total = [], 0
    while total < (B + 1) * S:
        n = int(rng.integers(64, 1537))
        docs.append(rng.integers(1, cfg.vocab_size, n))
        total += n + 1
    windows, segs = pack_tokens(docs, S, eos_id=0, return_segments=True)
    it = batch_iterator({"tokens": windows, "segments": segs},
                        batch_size=B, rank=0, world_size=1, seed=seed)
    return next(prefetch_to_device(it, device="cuda"))


def launch_counts():
    from nbdistributed_tpu_torch.ops import attention as A
    return {"k1": A.flash_attention.launches,
            "k2": A.flash_attention_bwd_dq.launches,
            "k3": A.flash_attention_bwd_dkv.launches}


def reset_launch_counts():
    from nbdistributed_tpu_torch.ops import attention as A
    from nbdistributed_tpu_torch.ops import decode as K
    A.flash_attention.launches = 0
    A.flash_attention_bwd_dq.launches = 0
    A.flash_attention_bwd_dkv.launches = 0
    K.flash_decode_attention.launches = 0


def phase_train(seed=0):
    """The training path at full width: counts reset, ``TRAIN_STEPS``
    bf16 AdamW steps with remat on one fixed packed batch, counts read.
    Then one profiled step."""
    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                                make_train_step,
                                                num_tokens_per_step,
                                                param_leaves,
                                                smol_135m_config)

    cfg = smol_135m_config(remat=True)
    params = init_params(cfg, seed)
    batch = packed_batch(cfg, TRAIN_B, cfg.max_seq_len, TRAIN_BATCH_SEED)
    step = make_train_step(cfg, AdamW(param_leaves(params), lr=1e-3))
    want = {"k1": 2 * N_LAYERS_SMOL, "k2": N_LAYERS_SMOL,
            "k3": N_LAYERS_SMOL}

    reset_launch_counts()
    losses, secs, per_step = [], [], []
    for _ in range(TRAIN_STEPS):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(params, batch)))
        secs.append(time.perf_counter() - t0)
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
    counts = launch_counts()

    n_tok = num_tokens_per_step(batch["tokens"].shape)
    steady = sorted(secs[2:])
    ms = 1e3 * steady[len(steady) // 2]
    say("train_bf16", steps=TRAIN_STEPS, losses=losses,
        launches=counts, launches_per_step=per_step[0],
        want_per_step=want, tokens_per_step=n_tok,
        ms_per_step_median_3_8=ms, tokens_per_s=n_tok / (ms / 1e3),
        ms_per_step=[1e3 * t for t in secs],
        segments=int(batch["segments"].max() - batch["segments"].min() + 1),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    for i, c in enumerate(per_step):
        check(c == want, f"train step {i + 1} launched {c}, want {want}")
    check(all(map(lambda x: x == x and abs(x) != float("inf"), losses)),
          f"non-finite train loss: {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")

    row = profile_steps(lambda: step(params, batch), 1)
    # The profiler slows the host, so its idle share overstates an
    # unprofiled step's.  Estimate the latter from the profiled device
    # time over the unprofiled median step: an estimate, not a reading.
    if isinstance(row["device_ms_per_step"], float):
        row["idle_share_estimate_unprofiled"] = \
            1 - row["device_ms_per_step"] / ms
    say("profile_train_step", **row)
    return ({"k1": counts["k1"], "k2": counts["k2"], "k3": counts["k3"],
             "steps": TRAIN_STEPS, "ms_per_step": ms,
             "tokens_per_s": n_tok / (ms / 1e3), "losses": losses}, row)


def phase_train_fp32_vs_plain(seed=0):
    """fp32 loss and every gradient leaf through the kernels
    (``use_flash=True``: K1 forward, K2/K3 backward) against the plain
    path (``use_flash=False``: autograd of ``attention_reference``) at
    full width, B=1, S=2048, packed documents, remat on."""
    import torch
    from nbdistributed_tpu_torch.models import (init_params, loss_fn,
                                                named_param_leaves,
                                                smol_135m_config)

    cfg = smol_135m_config(dtype=torch.float32, remat=True)
    params = init_params(cfg, seed)
    named = named_param_leaves(params)
    leaves = [t.requires_grad_() for _, t in named]
    batch = packed_batch(cfg, 1, cfg.max_seq_len, seed=8)

    def value_and_grad(c):
        loss = loss_fn(params, batch, c)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    lk, gk = value_and_grad(cfg)
    lp, gp = value_and_grad(dataclasses.replace(cfg, use_flash=False))
    rel = {name: float((a - b).norm() / b.norm())
           for (name, _), a, b in zip(named, gk, gp)}
    loss_rel = abs(lk - lp) / abs(lp)
    worst = max(rel, key=rel.get)
    say("train_fp32_kernels_vs_plain", loss_kernels=lk, loss_plain=lp,
        loss_rel_err=loss_rel, grad_rel_l2=rel, worst_leaf=worst,
        tol=TRAIN_FP32_TOL)
    check(all(torch.isfinite(g).all().item() for g in gk),
          "non-finite kernel-path gradient")
    check(loss_rel <= TRAIN_FP32_TOL and rel[worst] <= TRAIN_FP32_TOL,
          f"fp32 train: loss {loss_rel}, {worst} {rel[worst]} over "
          f"{TRAIN_FP32_TOL}")
    return {"loss_rel_err": loss_rel, "worst_leaf": worst,
            "worst_rel_l2": rel[worst]}


def phase_lora(seed=0, steps=3):
    """Three bf16 LoRA steps at full width on the training batch: the
    base parameters stay bit-identical and the loss falls."""
    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                                lora_init, lora_num_params,
                                                make_lora_train_step,
                                                param_leaves,
                                                smol_135m_config)

    cfg = smol_135m_config(remat=True)
    base = init_params(cfg, seed)
    before = [t.clone() for t in param_leaves(base)]
    lora = lora_init(1, cfg, rank=8)
    step = make_lora_train_step(cfg, AdamW(param_leaves(lora), lr=5e-3))
    batch = packed_batch(cfg, TRAIN_B, cfg.max_seq_len, TRAIN_BATCH_SEED)
    losses = [float(step(base, lora, batch)) for _ in range(steps)]
    same = all(torch.equal(a, b) for a, b in zip(before, param_leaves(base)))
    say("lora_bf16", steps=steps, losses=losses, base_identical=same,
        adapter_params=lora_num_params(lora))
    check(same, "LoRA steps changed the base parameters")
    check(all(map(lambda x: x == x and abs(x) != float("inf"), losses)),
          f"non-finite LoRA loss: {losses}")
    check(losses[-1] < losses[0], f"LoRA loss did not fall: {losses}")
    return losses


# ----------------------------------------------------------------------
# phases 12-15: the Mixtral MoE family.  mixtral_8x7b_config at full
# width with n_layers 32 -> 2 (93 GB of bf16 weights > the card's 80 GB;
# chip time), random weights from seed 0.  Every path's run has its
# counts reset just before and read just after.

N_LAYERS_MOE = 2
# capacity_factor >= n_experts / top_k: no expert can overflow at any
# token count, so the three dispatch modes, the server and solo
# generate route every token alike.
MOE_LOSSLESS = 4.0
MOE_TRAIN_STEPS = 4


def mixtral_cfg(**kw):
    from nbdistributed_tpu_torch.models import mixtral_8x7b_config
    return mixtral_8x7b_config(n_layers=N_LAYERS_MOE, **kw)


def moe_host_reads():
    from nbdistributed_tpu_torch.parallel import expert
    return expert._dropless_ffn.host_reads


def rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def phase_moe_modes(seed=0):
    """fp32, lossless capacity: ``moe_forward`` on B=1, S=512 in the
    dense, sparse and dropless modes.  Logits within 1e-5 relative L2 of
    the dense mode's, aux within 1e-6; K1 once per layer per forward;
    dropless reads its expert group sizes on the host once per layer.
    Returns (params, cfg, row)."""
    import torch
    from nbdistributed_tpu_torch.models import init_moe_model, moe_forward

    cfg = mixtral_cfg(dtype=torch.float32, capacity_factor=MOE_LOSSLESS)
    params = init_moe_model(cfg, seed)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), generator=g)
    modes = {m: dataclasses.replace(cfg, moe_dispatch=m)
             for m in ("dense", "sparse", "dropless")}
    L = cfg.n_layers

    reset_launch_counts()
    reads = moe_host_reads()
    out = {m: moe_forward(params, tokens, c) for m, c in modes.items()}
    torch.cuda.synchronize()
    k1, reads = launch_counts()["k1"], moe_host_reads() - reads

    ref, ref_aux = out["dense"]
    rel = {m: rel_l2(out[m][0], ref) for m in ("sparse", "dropless")}
    aux = {m: float(a) for m, (_, a) in out.items()}
    ms = {m: cuda_ms(lambda c=c: moe_forward(params, tokens, c), 3, 1)
          for m, c in modes.items()}
    row = dict(k1_launches=k1, want_k1=len(modes) * L,
               dropless_host_reads=reads, want_host_reads=L,
               logits_rel_l2_vs_dense=rel, tol=1e-5, aux=aux, aux_tol=1e-6,
               ms_per_forward=ms, capacity_factor=MOE_LOSSLESS)
    say("moe_modes_fp32", **row)
    check(torch.isfinite(ref).all().item()
          and ref.shape == (1, 512, cfg.vocab_size), "moe_forward: bad logits")
    check(k1 == len(modes) * L, f"moe_forward: K1 launched {k1} times")
    check(reads == L, f"dropless: {reads} host reads over {L} layers")
    check(all(r <= 1e-5 for r in rel.values()), f"modes disagree: {rel}")
    check(all(abs(a - aux["dense"]) <= 1e-6 for a in aux.values()),
          f"aux losses disagree: {aux}")
    return params, cfg, row


def phase_moe_fp32(params, cfg, prompts):
    """fp32 at lossless capacity on 8 of the requests: the server against
    solo ``generate``; a self-draft speculative server (gamma 4)
    accepting every proposal but at near-ties, K4 (gamma + 1) x layers
    a round; a ``quantize_moe_params`` tree's server against solo
    ``generate`` on the same tree (4 requests).  Near-tie rule
    throughout."""
    from nbdistributed_tpu_torch.models import quantize_moe_params

    L = cfg.n_layers
    (outs, steps, *_), k4 = counted_serve("serve_moe", L, params, cfg,
                                          prompts[:8])
    solo = solo_outputs(params, cfg, prompts[:8])
    near_tie_check("serve_moe_fp32_vs_solo", params, cfg, prompts[:8], outs,
                   solo)
    rounds, gaps, outs_self, k4_spec = self_draft_rounds(params, cfg,
                                                         prompts[:8])
    say("serve_moe_fp32_self_draft", rounds=rounds, short_rounds=len(gaps),
        gaps_at_first_rejection=gaps, near_tie=NEAR_TIE,
        k4_launches=k4_spec, want_k4=rounds * (GAMMA + 1) * L)
    check(k4_spec == rounds * (GAMMA + 1) * L,
          f"MoE self-draft: K4 launched {k4_spec} times over {rounds} rounds")
    check(all(g < NEAR_TIE for g in gaps), f"MoE self-draft rejected a "
          f"proposal away from a near-tie: gaps {gaps}")
    near_tie_check("serve_moe_fp32_self_draft_vs_solo", params, cfg,
                   prompts[:8], outs_self, solo)
    qp = quantize_moe_params(params)
    (outs_q, *_), k4_int8 = counted_serve("serve_moe_int8", L, qp, cfg,
                                          prompts[:4])
    near_tie_check("serve_moe_int8_fp32_vs_solo", qp, cfg, prompts[:4],
                   outs_q, solo_outputs(qp, cfg, prompts[:4]))
    return dict(k4_serve=k4, steps=steps, k4_speculative=k4_spec,
                self_draft_rounds=rounds, self_draft_short_rounds=len(gaps),
                k4_int8=k4_int8, solo=solo)


def moe_layer_ms(params, cfg):
    """Device time (CUDA-graph replay) of one MoE block at the decode
    step's shape: 8 rows, all live."""
    import torch
    from nbdistributed_tpu_torch.models.moe import _moe_mlp_block
    from nbdistributed_tpu_torch.models.transformer import layer_params

    layer = layer_params(params, 0)
    x = torch.randn(8, 1, cfg.d_model, device="cuda").to(cfg.dtype)
    mask = torch.ones(8, 1, dtype=torch.bool, device="cuda")
    return graph_ms(lambda: _moe_mlp_block(x, layer, cfg, token_mask=mask),
                    10, 5)


def served_row(outs, steps, wall, step_s, cfg):
    check(all(len(o) == 32 and all(0 <= t < cfg.vocab_size for t in o)
              for o in outs), "a stream fell short or left the vocabulary")
    step_s = sorted(step_s)
    n_tok = sum(len(o) for o in outs)
    return dict(requests=len(outs), tokens=n_tok, decode_steps=steps,
                wall_s=wall, tokens_per_s=n_tok / wall,
                ms_per_step_median=1e3 * step_s[len(step_s) // 2])


def phase_serve_moe(prompts, seed=0):
    """bf16, capacity factor 1.25, dense dispatch: the 12 requests on
    ``DecodeServer(max_batch=8, max_len=1024)``, K4 once per layer per
    step; a profile of decode steps with the MoE block's device time
    (graph replay) beside it; the paged server (blocks of 64 tokens)
    token for token the dense one; a ``quantize_moe_params`` tree
    serving the same requests.  Returns (params, cfg, row)."""
    import torch
    from nbdistributed_tpu_torch.models import (init_moe_model, moe_forward,
                                                quantize_moe_params)

    cfg = mixtral_cfg()
    params = init_moe_model(cfg, seed)
    L = cfg.n_layers
    (outs, steps, wall, step_s, _), k4 = counted_serve("serve_moe", L,
                                                       params, cfg, prompts)
    # What a decode step must read: every weight but the embedding,
    # whose 8 gathered rows are noise (the dense mode runs all 8
    # experts).
    step_bytes = weight_bytes(params) - weight_bytes({"e": params["embed"]})
    row = dict(served_row(outs, steps, wall, step_s, cfg), k4_launches=k4,
               want_k4=L * steps, weight_bytes=weight_bytes(params),
               step_weight_bytes=step_bytes,
               step_weight_bound_ms=1e3 * step_bytes / HBM_BYTES_PER_S)
    say("serve_moe_bf16", **row)
    profile = phase_profile(params, 4, name="profile_moe_decode_step",
                            cfg=cfg)
    layer_ms = moe_layer_ms(params, cfg)
    device = profile["device_ms_per_step"]
    row["profile"] = dict(profile, moe_block_ms=layer_ms,
                          moe_share_of_device=L * layer_ms / device
                          if isinstance(device, float) else "not measured")
    say("profile_moe_decode_step_moe_share", moe_block_ms=layer_ms,
        moe_blocks_per_step=L,
        moe_share_of_device=row["profile"]["moe_share_of_device"])

    (outs_p, steps_p, *_), k4_paged = counted_serve(
        "serve_moe_paged", L, params, cfg, prompts, kv_block_tokens=64)
    say("serve_moe_paged_bf16", equal_to_dense=outs_p == outs,
        decode_steps=steps_p, k4_launches=k4_paged)
    check(outs_p == outs, "paged bf16 MoE serving differs from the dense "
          "bf16 MoE server")

    qp = quantize_moe_params(params)
    (outs_q, steps_q, wall_q, step_s_q, _), k4_int8 = counted_serve(
        "serve_moe_int8", L, qp, cfg, prompts)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (1, 128), generator=g)
    ref = moe_forward(params, tokens, cfg)[0]
    int8 = dict(served_row(outs_q, steps_q, wall_q, step_s_q, cfg),
                weight_bytes=weight_bytes(qp),
                forward_rel_l2_vs_bf16=rel_l2(moe_forward(qp, tokens, cfg)[0],
                                              ref))
    say("serve_moe_int8_bf16", **int8)
    del qp
    row.update(k4_paged=k4_paged, k4_int8=k4_int8, int8=int8)
    return params, cfg, row


def phase_train_moe(params, cfg):
    """bf16 training at full width: ``moe_loss_fn`` and the port's AdamW,
    ``MOE_TRAIN_STEPS`` steps on one B=1 x S=2048 batch of packed
    documents, counts reset just before and read just after (per step
    K1, K2 and K3 once per layer: no remat); losses finite and falling;
    then one profiled step, and three LoRA steps (rank 8, attention
    targets) leaving the base untouched with finite losses."""
    import torch
    from nbdistributed_tpu_torch.models import (AdamW, lora_init,
                                                make_lora_train_step,
                                                moe_loss_fn,
                                                num_tokens_per_step,
                                                param_leaves)

    L = cfg.n_layers
    batch = packed_batch(cfg, 1, 2048, TRAIN_BATCH_SEED)
    leaves = [p.requires_grad_() for p in param_leaves(params)]
    opt = AdamW(leaves, lr=1e-3)

    def step():
        for p in leaves:
            p.grad = None
        loss = moe_loss_fn(params, batch, cfg)
        loss.backward()
        opt.step()
        return loss.detach()

    want = {"k1": L, "k2": L, "k3": L}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, secs, per_step = [], [], []
    for _ in range(MOE_TRAIN_STEPS):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step()))
        secs.append(time.perf_counter() - t0)
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_tok = num_tokens_per_step(batch["tokens"].shape)
    ms = 1e3 * sorted(secs[1:])[len(secs[1:]) // 2]
    row = dict(steps=MOE_TRAIN_STEPS, losses=losses, launches=counts,
               launches_per_step=per_step, want_per_step=want,
               tokens_per_step=n_tok, ms_per_step=[1e3 * t for t in secs],
               ms_per_step_median_after_first=ms,
               tokens_per_s=n_tok / (ms / 1e3), peak_mem_gb=peak)
    say("train_moe_bf16", **row)
    for i, c in enumerate(per_step):
        check(c == want, f"MoE train step {i + 1} launched {c}, want {want}")
    check(all(map(lambda x: x == x and abs(x) != float("inf"), losses)),
          f"non-finite MoE train loss: {losses}")
    check(losses[-1] < losses[0], f"MoE train loss did not fall: {losses}")
    profile = profile_steps(step, 1)
    if isinstance(profile["device_ms_per_step"], float):
        profile["idle_share_estimate_unprofiled"] = \
            1 - profile["device_ms_per_step"] / ms
    say("profile_train_moe_step", **profile)

    opt.state.clear()
    del opt
    for p in leaves:
        p.grad = None
        p.requires_grad_(False)
    torch.cuda.empty_cache()
    base = [t.clone() for t in leaves]
    lora = lora_init(1, cfg, rank=8)
    lstep = make_lora_train_step(cfg, AdamW(param_leaves(lora), lr=5e-3))
    lora_losses = [float(lstep(params, lora, batch)) for _ in range(3)]
    same = all(torch.equal(a, b) for a, b in zip(base, leaves))
    say("lora_moe_bf16", steps=3, losses=lora_losses, base_identical=same)
    check(same, "MoE LoRA steps changed the base parameters")
    check(all(map(lambda x: x == x and abs(x) != float("inf"),
                  lora_losses)), f"non-finite MoE LoRA loss: {lora_losses}")
    return dict(row, k1=counts["k1"], k2=counts["k2"], k3=counts["k3"],
                profile=profile, lora_losses=lora_losses)


def phase_moe(seed=0):
    """Phases 12-15 in order; each model is freed before the next is
    built.  Returns {phase: result}."""
    import torch

    ts = time.perf_counter()
    params32, cfg32, modes = phase_moe_modes(seed)
    prompts = make_requests(cfg32)
    fp32 = phase_moe_fp32(params32, cfg32, prompts)
    del params32
    torch.cuda.empty_cache()
    params, cfg, serve_row = phase_serve_moe(prompts, seed)
    train = phase_train_moe(params, cfg)
    del params
    torch.cuda.empty_cache()
    say("moe_seconds", seconds=time.perf_counter() - ts)
    return dict(modes=modes, fp32=fp32, serve=serve_row, train=train)


# ----------------------------------------------------------------------
# phase 17: the worker cluster and HF interop

CLUSTER_READY_S = 300      # torch import + CUDA + the NCCL rendezvous
CLUSTER_RT_CELLS = 20
NCCL_BYTES = 64 << 20

# Runs in the worker: phase 5's path (full-width forward, then the 12
# requests on a bf16 server) with the counts reset just before and read
# just after, and the kernels loaded from the parent's build.
CLUSTER_SERVE_CELL = """
import chip_smoke as cs
from nbdistributed_tpu_torch.models import (forward, init_params,
                                            smol_135m_config)
from nbdistributed_tpu_torch.ops import (_build, flash_attention,
                                         flash_decode_attention)
torch.backends.cuda.matmul.allow_tf32 = False
rebuilt = _build.build_all()
cfg = smol_135m_config()
params = init_params(cfg, 0, device=device)
tokens = torch.randint(0, cfg.vocab_size, (1, 512),
                       generator=torch.Generator().manual_seed(5))
prompts = cs.make_requests(cfg)
cs.reset_launch_counts()
logits = forward(params, tokens, cfg)
outputs, steps, wall, _, _ = cs.serve(params, cfg, prompts)
served = {"k1": flash_attention.launches,
          "k4": flash_decode_attention.launches, "steps": steps,
          "wall_s": wall, "outputs": outputs, "rebuilt": sorted(rebuilt),
          "logits_finite": bool(torch.isfinite(logits).all()),
          "logits_shape": list(logits.shape)}
"""

CLUSTER_NCCL_CELL = """
t = torch.full((4,), float(rank + 2), device=device)
f = all_reduce(t)
u = t.clone()
dist.all_reduce(u)
x = torch.ones(NCCL_BYTES // 4, device=device)
for _ in range(3):
    dist.all_reduce(x)
torch.cuda.synchronize()
e0 = torch.cuda.Event(enable_timing=True)
e1 = torch.cuda.Event(enable_timing=True)
e0.record()
for _ in range(20):
    dist.all_reduce(x)
e1.record()
torch.cuda.synchronize()
nccl = {"device": str(device), "backend": dist.get_backend(),
        "world": dist.get_world_size(), "functional": f.tolist(),
        "functional_device": str(f.device), "input_after": t.tolist(),
        "in_place": u.tolist(), "all_reduce_ms": e0.elapsed_time(e1) / 20,
        "quantized": all_reduce_quantized(torch.arange(1000., device=device)
                                          ).sub(torch.arange(1000.,
                                          device=device)).abs().max().item()}
"""

CLUSTER_SPIN_CELL = """
import time
a = torch.randn(4096, 4096, device=device, dtype=torch.bfloat16)
print("spinning", flush=True)
t0 = time.monotonic()
while time.monotonic() - t0 < 120:
    c = a @ a
"""


class _Streams:
    """The coordinator's output callback: collects pushes, and
    ``wait_for`` polls for a text under a deadline."""

    def __init__(self):
        import threading
        self.cond = threading.Condition()
        self.texts = []

    def __call__(self, rank, data):
        with self.cond:
            self.texts.append(data.get("text", ""))
            self.cond.notify_all()

    def wait_for(self, text, timeout):
        deadline = time.monotonic() + timeout
        with self.cond:
            while not any(text in t for t in self.texts):
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self.cond.wait(left)
            return True


def cell(comm, code, timeout=300):
    """Run ``code`` on the one worker; its reply data (errors raise)."""
    data = comm.send_to_rank(0, "execute", code, timeout=timeout).data
    check("error" not in data, f"worker cell failed: {data.get('error')}"
          f"\n{data.get('traceback', '')}")
    return data


def fetch(comm, name):
    data = comm.send_to_rank(0, "get_var", name, timeout=60).data
    check(not data.get("error") and not data.get("array"),
          f"get_var {name}: {data}")
    return data["value"]


def phase_cluster(prompts, dense):
    """One NCCL worker spawned by the port's process manager and driven
    over its control plane: the process group and the collectives on
    the card, phase 5's serving path inside the worker (tokens equal to
    the in-process server's, K1 and K4 counted in the worker), a
    serve_open/serve_step/serve_close round, an interrupt of a cell
    looping GPU matmuls, and the control plane's costs."""
    import statistics
    import threading

    from nbdistributed_tpu_torch.manager import (ProcessManager,
                                                 wait_until_ready)
    from nbdistributed_tpu_torch.messaging.coordinator import \
        CommunicationManager

    ts = time.perf_counter()
    comm = CommunicationManager(1, timeout=300)
    streams = _Streams()
    comm.set_output_callback(streams)
    pm = ProcessManager()
    pm.add_death_callback(lambda rank, rc: comm.mark_worker_dead(rank))
    try:
        t0 = time.perf_counter()
        pm.start_workers(1, comm.port, backend="gpu")
        wait_until_ready(comm, pm, CLUSTER_READY_S, poll_s=0.5)
        ready_s = time.perf_counter() - t0
        check(pm.gpus == {0: 0}, f"GPU assignment {pm.gpus}")

        cell(comm, f"NCCL_BYTES = {NCCL_BYTES}\n" + CLUSTER_NCCL_CELL)
        nccl = fetch(comm, "nccl")
        say("cluster_process_group", spawn_to_ready_s=ready_s, **nccl)
        check(nccl["device"] == "cuda:0" and nccl["backend"] == "nccl"
              and nccl["world"] == 1, f"process group: {nccl}")
        check(nccl["functional"] == [2.0] * 4
              and nccl["in_place"] == [2.0] * 4
              and nccl["input_after"] == [2.0] * 4
              and nccl["functional_device"] == "cuda:0",
              f"all_reduce on the card: {nccl}")
        check(nccl["quantized"] <= 1000 / 254, f"all_reduce_quantized: "
              f"{nccl['quantized']}")

        rt = []
        for _ in range(CLUSTER_RT_CELLS):
            tr = time.perf_counter()
            cell(comm, "1")
            rt.append(time.perf_counter() - tr)

        cell(comm, CLUSTER_SERVE_CELL, timeout=600)
        served = fetch(comm, "served")
        steps = served["steps"]
        n_tok = sum(len(o) for o in served["outputs"])
        row = dict(k1_launches=served["k1"], k4_launches=served["k4"],
                   decode_steps=steps, want_k1=N_LAYERS_SMOL,
                   want_k4=N_LAYERS_SMOL * steps,
                   rebuilt_in_worker=served["rebuilt"],
                   tokens=n_tok, wall_s=served["wall_s"],
                   tokens_per_s=n_tok / served["wall_s"],
                   in_process_tokens_per_s=dense["tokens_per_s"])
        say("cluster_serve", **row)
        check(served["rebuilt"] == [], "the worker rebuilt kernels: "
              f"{served['rebuilt']}")
        check(served["logits_finite"] and served["logits_shape"]
              == [1, 512, 49152], "worker forward: bad logits")
        check(served["k1"] == N_LAYERS_SMOL, f"worker K1 launched "
              f"{served['k1']} times, want {N_LAYERS_SMOL}")
        check(steps > 0 and served["k4"] == N_LAYERS_SMOL * steps,
              f"worker K4 launched {served['k4']} times over {steps} "
              "decode steps")
        check(served["outputs"] == dense["outputs"], "the worker's bf16 "
              "tokens differ from the in-process server's")

        # The serving protocol on the same model: the first wave of
        # phase 5's requests admitted in one tick.
        r = comm.send_to_rank(0, "serve_open", {
            "max_batch": 8, "max_len": 1024, "pad_to": 64}).data
        check(r == {"status": "open", "slots": 8}, f"serve_open: {r}")
        wave = prompts[:5]
        got = {f"r{i}": [] for i in range(len(wave))}
        done, ticks = set(), 0
        tw = time.perf_counter()
        while len(done) < len(wave):
            ticks += 1
            check(ticks <= 100, "serve_step did not finish the wave")
            r = comm.send_to_rank(0, "serve_step", {
                "admit": [{"rid": f"r{i}", "prompt": p, "max_new": 32}
                          for i, p in enumerate(wave)] if ticks == 1
                else [], "steps": 8}, timeout=300).data
            check(r.get("status") == "ok" and not r["errors"],
                  f"serve_step: {r}")
            for rid, e in r["emitted"].items():
                check(e["o"] == len(got[rid]), "serve_step offsets")
                got[rid] += e["t"]
            done |= set(r["finished"])
        wave_s = time.perf_counter() - tw
        r = comm.send_to_rank(0, "serve_close", {}).data
        check(r == {"status": "ok", "existed": True}, f"serve_close: {r}")
        same = [got[f"r{i}"] for i in range(len(wave))] \
            == dense["outputs"][:len(wave)]
        say("cluster_serve_protocol", requests=len(wave), ticks=ticks,
            seconds=wave_s, tokens_equal_in_process=same)
        check(same, "serve_step tokens differ from the in-process server's")

        # An interrupt while the cell keeps the GPU busy.
        result = {}
        th = threading.Thread(target=lambda: result.update(
            comm.send_to_all("execute", CLUSTER_SPIN_CELL, timeout=300)),
            daemon=True)
        th.start()
        check(streams.wait_for("spinning", 120), "spin cell never started")
        ti = time.perf_counter()
        check(pm.interrupt() == [0], "interrupt: worker not signalled")
        th.join(timeout=120)
        interrupt_s = time.perf_counter() - ti
        check(not th.is_alive(), "the interrupt did not end the cell")
        err = result[0].data.get("error", "")
        check("KeyboardInterrupt" in err, f"interrupted cell: {err}")
        after = cell(comm, "torch.cuda.synchronize()\n"
                           "float((a[:4, :4] * 0).sum()) + 1")
        check(after["output"] == "1.0", f"cell after interrupt: {after}")
        say("cluster_interrupt", reply_after_signal_s=interrupt_s,
            error=err.splitlines()[0], next_cell=after["output"])
        comm.post([0], "shutdown")
    finally:
        pm.shutdown()
        comm.shutdown()
    out = dict(spawn_to_ready_s=ready_s,
               trivial_cell_ms_median=1e3 * statistics.median(rt),
               trivial_cell_ms=[1e3 * x for x in rt],
               nccl_all_reduce_64mb_ms=nccl["all_reduce_ms"],
               nccl_all_reduce_64mb_world=1, serve=row,
               serve_protocol_ticks=ticks, interrupt_s=interrupt_s,
               seconds=time.perf_counter() - ts)
    say("cluster", **{k: v for k, v in out.items() if k != "serve"})
    return out


# ----------------------------------------------------------------------
# phase 18: serving on a mesh.  Four ranks of one gloo process group,
# spawned by this script, all on the one card (NCCL refuses two ranks on
# one device; gloo runs all_reduce, all_gather and broadcast on CUDA
# tensors through host staging).  The ranks time-share the card, and
# every collective crosses the host, so no number here is a link speed.

MESH_WORLD = 4
MESH_MAX_LEN = 256      # prompts of 16-200 tokens + 32 new: both sp
#                         slices of 128 tokens hold keys
MESH_READY_S = 300      # spawn, torch import, CUDA and the rendezvous
MESH_RUN_S = 900
MESH_NOTE = {"gloo": "4 ranks time-share one GPU over gloo's host "
                     "staging: no number is a link speed",
             "nccl": "4 ranks, one GPU each, NCCL over the host's links"}


def seeded_moe_shard(cfg, seed, mesh, rules):
    """``init_moe_model(cfg, seed)``'s tree on this rank's card, drawn
    leaf by leaf in that function's order from the same generator, each
    leaf cut to this rank's shard by ``rules`` as soon as it is drawn:
    a rank never holds the whole 2-layer fp32 Mixtral (12.6 GB)."""
    import math

    import torch
    from nbdistributed_tpu_torch.parallel import apply_shardings
    from nbdistributed_tpu_torch.utils import fan_in_normal

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    D, H, Hkv, Dh, L, E, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, cfg.n_layers, cfg.n_experts,
                              cfg.d_ff)
    lay = rules["layers"]

    def cut(x, spec):
        return apply_shardings(x, mesh, spec)

    def normal(shape, fan_in):
        return fan_in_normal(gen, shape, fan_in, cfg.dtype)

    # init_moe_params' draws, layer by layer: (name, shape, fan_in); the
    # router is N(0, 1) * 0.02 in fp32, the experts fan-in normal.
    draws = (("router", (D, E), None), ("w_gate", (E, D, F), D),
             ("w_up", (E, D, F), D), ("w_down", (E, F, D), F))
    moe = {}
    for i in range(L):
        for name, shape, fan_in in draws:
            spec = lay["moe"][name]
            dtype = torch.float32 if fan_in is None else cfg.dtype
            if all(e is None for e in spec) and dtype == torch.float32:
                # A whole fp32 leaf is drawn straight into its layer's
                # slot: the same normal_ on the same generator, the same
                # division, no transient copy.
                if name not in moe:
                    moe[name] = torch.empty((L,) + shape, device="cuda")
                out = torch.randn(shape, generator=gen, device="cuda",
                                  out=moe[name][i])
                out.mul_(0.02) if fan_in is None else \
                    out.div_(math.sqrt(fan_in))
                continue
            x = (torch.randn(shape, generator=gen, device="cuda") * 0.02
                 if fan_in is None else normal(shape, fan_in))
            part = cut(x[None], spec)
            del x
            if name not in moe:
                moe[name] = torch.empty((L,) + part.shape[1:],
                                        dtype=part.dtype, device="cuda")
            moe[name][i] = part[0]
            del part
    ones = lambda *shape: torch.ones(shape, device="cuda")  # noqa: E731
    tree = {"embed": cut(normal((cfg.vocab_size, D), 1.0), rules["embed"])}
    tree["layers"] = {
        "attn_norm": ones(L, D),
        "wq": cut(normal((L, D, H * Dh), D), lay["wq"]),
        "wk": cut(normal((L, D, Hkv * Dh), D), lay["wk"]),
        "wv": cut(normal((L, D, Hkv * Dh), D), lay["wv"]),
        "wo": cut(normal((L, H * Dh, D), H * Dh), lay["wo"]),
        "mlp_norm": ones(L, D), "moe": moe}
    tree["final_norm"] = ones(D)
    tree["lm_head"] = cut(normal((D, cfg.vocab_size), D), rules["lm_head"])
    return tree


def _count_collectives():
    """Wrap torch.distributed's all_reduce, all_gather, broadcast,
    reduce_scatter_tensor, batch_isend_irecv (one ring ppermute) and
    all_to_all_single with call counters (the mesh layer looks them up
    at each call)."""
    import torch.distributed as dist
    counts = {"all_reduce": 0, "all_gather": 0, "broadcast": 0,
              "reduce_scatter_tensor": 0, "batch_isend_irecv": 0,
              "all_to_all_single": 0}
    for name in counts:
        fn = getattr(dist, name)

        def counted(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)

        setattr(dist, name, counted)
    return counts


def mesh_job(job, counts):
    """One mesh serving run on this rank: the model built from the seed
    and cut to this rank's shard, then the requests served with the
    launch and collective counts reset just before and read just after."""
    import gc

    import torch
    from nbdistributed_tpu_torch.models import (init_params,
                                                moe_model_shardings,
                                                param_shardings,
                                                smol_135m_config)
    from nbdistributed_tpu_torch.parallel import apply_shardings, make_mesh

    mesh = make_mesh(job["mesh"])
    if job["model"] == "smol":
        cfg = smol_135m_config(dtype=torch.float32)
        params = init_params(cfg, 0)
        if "tp" in mesh.shape:
            params = apply_shardings(params, mesh, param_shardings(cfg))
    else:
        cfg = mixtral_cfg(dtype=torch.float32, capacity_factor=MOE_LOSSLESS,
                          moe_dispatch=job["dispatch"])
        rules = moe_model_shardings(
            cfg, ep_axis="ep" if "ep" in mesh.shape else None,
            tp_axis="tp" if "tp" in mesh.shape else None)
        params = seeded_moe_shard(cfg, 0, mesh, rules)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for k in counts:
        counts[k] = 0
    outs, steps, wall, step_s, run = serve(params, cfg, job["prompts"],
                                           max_len=MESH_MAX_LEN, mesh=mesh)
    k4, k1 = k4_launches(), launch_counts()["k1"]
    del run                     # the server: its pool and the tree
    n_coll = dict(counts)
    step_s = sorted(step_s)
    row = dict(outputs=outs, steps=steps, k4=k4, k1=k1, wall_s=wall,
               ms_per_step_median=1e3 * step_s[len(step_s) // 2],
               collectives=n_coll,
               collectives_per_step=sum(n_coll.values()) / max(steps, 1),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               weight_gb=weight_bytes(params) / 1e9)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return row


def mesh_rank(rank, port, jobs, q, backend, done):
    """A rank of the mesh phase (spawned): joins the 4-rank group — gloo,
    every rank on ``cuda:0``; or NCCL, rank r on ``cuda:r`` — loads the
    kernels the parent built, runs ``jobs`` in order and puts ``(rank,
    {job: row})`` (or the error) on ``q``; then waits for ``done``, so
    that the shared-memory tensors it sent stay reachable until the
    parent has taken every item."""
    import datetime
    import os
    import traceback
    t_start = time.time()
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        import torch
        import torch.distributed as dist
        dev = rank if backend == "nccl" else 0
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}",
            world_size=MESH_WORLD, rank=rank,
            timeout=datetime.timedelta(seconds=MESH_READY_S),
            **({"device_id": torch.device("cuda", dev)}
               if backend == "nccl" else {}))
        from nbdistributed_tpu_torch.ops import _build
        out = {"rebuilt": sorted(_build.build_all())}
        out["clock"] = {"start": t_start, "ready": time.time()}
        counts = _count_collectives()
        for job in jobs:
            send = lambda item: q.put((rank, item))  # noqa: E731
            out[job["name"]] = (
                guard_job(job, counts, send) if job.get("guard")
                else train_pp_job(job, counts, send) if job.get("train_pp")
                else overlap_job(job, counts, send) if job.get("overlap")
                else train_sp_job(job, counts, send) if job.get("train_sp")
                else train_mesh_job(job, counts, send) if job.get("train")
                else mesh_job(job, counts))
        dist.barrier()
        out["clock"]["done"] = time.time()
        q.put((rank, out))
        done.wait(MESH_RUN_S)
        dist.destroy_process_group()
    except BaseException:
        err = traceback.format_exc()
        try:                     # what held the card's memory, if CUDA ran
            import gc
            import torch
            live = sorted(((t.numel() * t.element_size(), tuple(t.shape))
                           for t in gc.get_objects()
                           if torch.is_tensor(t) and t.is_cuda),
                          reverse=True)[:12]
            err += (f"\nallocated {torch.cuda.memory_allocated() / 2**30:.2f}"
                    f" GiB, peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                    f" GiB; largest live tensors {live}")
        except Exception:
            pass
        q.put((rank, {"error": err}))


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_mesh_ranks(jobs, backend, on_item=None):
    """Spawn the 4 ranks, run ``jobs`` on them, stop them all; returns
    {rank: {job: row}} (a rank's error raises).  A rank's tuple items
    before its result go to ``on_item(rank, item)``."""
    import multiprocessing as mp
    import queue

    import os

    ctx = mp.get_context("spawn")
    q, done = ctx.Queue(), ctx.Event()
    port = _free_port()
    procs = [ctx.Process(target=mesh_rank,
                         args=(r, port, jobs, q, backend, done), daemon=True)
             for r in range(MESH_WORLD)]
    out = {}
    # The ranks' allocators grow segments in place: a job's freed blocks
    # must not strand the next, larger job's memory on a shared card.
    env = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        for p in procs:
            p.start()
        if env is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = env
        deadline = time.monotonic() + MESH_READY_S + MESH_RUN_S * (
            2 if any(j.get("train") or j.get("train_sp") or j.get("train_pp")
                     or j.get("guard") for j in jobs)
            else 1)
        while len(out) < MESH_WORLD:
            try:
                rank, res = q.get(timeout=5.0)
            except queue.Empty:
                # A rank that died without a result (it could not even
                # start) fails the phase now, not at the deadline.
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None}
                check(not dead, f"mesh ranks exited without a result: "
                      f"{dead}")
                check(time.monotonic() < deadline, "mesh ranks "
                      f"{sorted(set(range(MESH_WORLD)) - set(out))} did "
                      f"not finish in time")
                continue
            if isinstance(res, tuple):
                on_item(rank, res)
                continue
            check("error" not in res, f"mesh rank {rank} failed:\n"
                  f"{res.get('error')}")
            out[rank] = res
        done.set()
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    return out


def near_tie_or_equal(name, make_params, cfg, prompts, got, want):
    """``got == want``, or the near-tie rule with the reference's
    parameters built (by ``make_params``) only when a stream differs."""
    if got == want:
        say(name, requests=len(got), divergences_at_near_ties=0,
            near_tie=NEAR_TIE)
        return []
    return near_tie_check(name, make_params(), cfg, prompts, got, want)


def phase_mesh(smol_prompts, smol_solo, moe_solo, backend="gloo"):
    """Phase 18: four ranks (gloo on the one card; NCCL on four cards
    with ``--mesh-nccl``) serve, in fp32, SmolLM2-135M (30 layers) on
    dp x sp and Mixtral (2 layers, full width, capacity factor 4) on
    tp x sp and on ep (dense and dropless dispatch), each held to solo
    ``generate`` under the near-tie rule; every rank's tokens equal and
    its K4 launches layers x decode steps."""
    import torch
    from nbdistributed_tpu_torch.models import init_moe_model, init_params

    ts = time.perf_counter()
    torch.cuda.empty_cache()     # the ranks need what this process cached
    moe_prompts = make_requests(mixtral_cfg())[:8]
    # Largest first: every rank of tp x sp holds all 8 experts (11.3 GB).
    jobs = [dict(name="mesh_mixtral_tp2_sp2", model="mixtral",
                 mesh={"tp": 2, "sp": 2}, dispatch="dense",
                 prompts=moe_prompts),
            dict(name="mesh_mixtral_ep4_dense", model="mixtral",
                 mesh={"ep": 4}, dispatch="dense", prompts=moe_prompts),
            dict(name="mesh_mixtral_ep4_dropless", model="mixtral",
                 mesh={"ep": 4}, dispatch="dropless", prompts=moe_prompts),
            dict(name="mesh_smol_dp2_sp2", model="smol",
                 mesh={"dp": 2, "sp": 2}, prompts=smol_prompts)]
    ranks = run_mesh_ranks(jobs, backend)
    check(all(r["rebuilt"] == [] for r in ranks.values()),
          f"a mesh rank rebuilt kernels: {[r['rebuilt'] for r in ranks.values()]}")
    smol = smol_135m_config_fp32()
    mix = mixtral_cfg(dtype=torch.float32, capacity_factor=MOE_LOSSLESS)
    rows = {}
    for job in jobs:
        name = job["name"]
        per = [ranks[r][name] for r in range(MESH_WORLD)]
        first = per[0]
        L = smol.n_layers if job["model"] == "smol" else mix.n_layers
        check(all(p["outputs"] == first["outputs"] for p in per),
              f"{name}: the ranks' tokens differ")
        check(all(p["steps"] == first["steps"] and p["steps"] > 0
                  and p["k4"] == L * p["steps"] for p in per),
              f"{name}: K4 launches {[p['k4'] for p in per]} over "
              f"{[p['steps'] for p in per]} steps, want {L} per step")
        if job["model"] == "smol":
            near_tie_or_equal(f"{name}_vs_solo",
                              lambda: init_params(smol, 0), smol,
                              job["prompts"], first["outputs"], smol_solo)
        else:
            near_tie_or_equal(f"{name}_vs_solo",
                              lambda: init_moe_model(mix, 0), mix,
                              job["prompts"], first["outputs"], moe_solo)
        rows[name] = dict(
            mesh=job["mesh"], layers=L, requests=len(first["outputs"]),
            decode_steps=first["steps"], k4_launches_rank0=first["k4"],
            k4_launches_per_rank=[p["k4"] for p in per],
            want_k4=L * first["steps"], k1_launches_rank0=first["k1"],
            ms_per_step_median_rank0=first["ms_per_step_median"],
            ms_per_step_median_per_rank=[p["ms_per_step_median"]
                                         for p in per],
            wall_s_rank0=first["wall_s"],
            collectives_rank0=first["collectives"],
            collectives_per_step_rank0=first["collectives_per_step"],
            peak_gb_per_rank=[p["peak_gb"] for p in per],
            weight_gb_per_rank=[p["weight_gb"] for p in per],
            backend=backend, note=MESH_NOTE[backend])
        say(name, **rows[name])
    rows["seconds"] = time.perf_counter() - ts
    say("mesh_seconds", seconds=rows["seconds"])
    return rows


# ----------------------------------------------------------------------
# phase 19: training on a mesh.  Phase 18's four ranks (gloo on the one
# card; NCCL, one card each, with --mesh-nccl) train each job below from
# seed 0, held to the single-process step on the whole tree and batch,
# which this process runs first and keeps on the host.  Every job runs
# guarded, so each step's gradient norm is held to the reference's too
# (AdamW alone would not see a gradient off by a constant factor).

TRAIN_MESH_LR = 1e-4
TRAIN_MESH_S = 512
TRAIN_MESH_LOSS_RTOL = 1e-5
TRAIN_MESH_LEAF_RTOL = 1e-4
TRAIN_MESH_BATCH_SEED = 9
# Largest first: the Mixtral ranks need the card that the SmolLM2 jobs
# leave cached.  The ZeRO-2 batch is 8 rows without segments, so that
# each dp4 rank has one row per microbatch and the mean over the two
# microbatches is the whole batch's mean (packed documents would weigh
# the microbatches by their kept targets).
TRAIN_MESH_JOBS = (
    dict(name="train_mesh_moe_ep4", model="mixtral", mesh={"ep": 4},
         rules="moe", B=1, segments=True, steps=2),
    dict(name="train_mesh_megatron_dp2_tp2", model="smol",
         mesh={"dp": 2, "tp": 2}, rules="megatron", B=4, segments=True,
         steps=3),
    dict(name="train_mesh_hsdp_dp2_tp2", model="smol",
         mesh={"dp": 2, "tp": 2}, rules="hsdp", B=4, segments=True, steps=3),
    dict(name="train_mesh_zero2_dp4", model="smol", mesh={"dp": 4},
         rules=None, zero=True, accum=2, B=8, segments=False, steps=3,
         nan_after=2),
)


def train_mesh_cfg(job):
    import torch
    from nbdistributed_tpu_torch.models import smol_135m_config
    if job["model"] == "smol":
        return smol_135m_config(dtype=torch.float32, remat=True)
    return mixtral_cfg(dtype=torch.float32, capacity_factor=MOE_LOSSLESS,
                       moe_dispatch="dropless")


def train_mesh_batch(job, cfg):
    """The job's whole batch on the card (every rank makes the same one
    and takes its rows); ``scale`` (ones) is what the NaN step poisons."""
    import torch
    batch = dict(packed_batch(cfg, job["B"], TRAIN_MESH_S,
                              TRAIN_MESH_BATCH_SEED))
    if not job["segments"]:
        del batch["segments"]
    batch["scale"] = torch.ones(job["B"], device="cuda")
    return batch


def train_mesh_reference(job):
    """The single-process step (the port's ``loss_fn`` or ``moe_loss_fn``
    and AdamW) on the whole tree and batch: each step's loss and
    gradient norm, and the final leaves on the host."""
    import gc

    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_moe_model,
                                                init_params, loss_fn,
                                                moe_loss_fn,
                                                named_param_leaves)

    cfg = train_mesh_cfg(job)
    smol = job["model"] == "smol"
    params = init_params(cfg, 0) if smol else init_moe_model(cfg, 0)
    batch = train_mesh_batch(job, cfg)
    named = named_param_leaves(params)
    leaves = [t.requires_grad_() for _, t in named]
    opt = AdamW(leaves, lr=TRAIN_MESH_LR)
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms = [], []
    for _ in range(job["steps"]):
        for p in leaves:
            p.grad = None
        loss = (loss_fn if smol else moe_loss_fn)(params, batch, cfg)
        loss.backward()
        gnorms.append(float(torch.stack([p.grad.float().pow(2).sum()
                                         for p in leaves]).sum().sqrt()))
        opt.step()
        losses.append(float(loss.detach()))
    peak = torch.cuda.max_memory_allocated() / 1e9
    final = {path: t.detach().cpu() for path, t in named}
    del params, named, leaves, opt, batch, loss
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, gnorms=gnorms, peak_gb=peak), final


def send_shards(name, named, rules, mesh, send):
    """Send ``(path, tensor)`` shards of a tree cut by ``rules`` to the
    parent, each from the first rank that holds it (every other axis at
    coordinate 0), with its (shards, index) per dimension; returns the
    count sent."""
    import torch
    from nbdistributed_tpu_torch.parallel.mesh import spec_split
    sent = 0
    for path, t in named:
        node = rules
        for key in path.split("/"):
            node = node.get(key) if isinstance(node, dict) else None
        spec = tuple(node or ())
        used = {a for e in spec for a in
                ((e,) if isinstance(e, str) else (e or ()))}
        if any(mesh.index(a) for a in mesh.shape if a not in used):
            continue                 # another rank holds this slice too
        split = [spec_split(mesh, spec[d] if d < len(spec) else None)
                 for d in range(t.ndim)]
        # Into shared memory: the queue then passes a handle, not bytes.
        host = torch.empty(t.shape, dtype=t.dtype).share_memory_()
        host.copy_(t.detach())
        send(("leaf", name, path, split, host))
        sent += 1
    return sent


def train_mesh_job(job, counts, send):
    """One training job on this rank: the model built from the seed and
    cut to this rank's shard, the guarded step (ZeRO-2: with the NaN
    step), counts reset just before the steps and read per step; then
    each leaf shard this rank is the first holder of goes to the parent
    (``send``) to be held to the reference."""
    import gc

    import torch
    from nbdistributed_tpu_torch.models import (AdamW, fsdp_param_shardings,
                                                init_params, loss_fn,
                                                moe_loss_fn,
                                                moe_model_shardings,
                                                named_param_leaves,
                                                param_leaves,
                                                param_shardings)
    from nbdistributed_tpu_torch.parallel import (apply_shardings, make_mesh,
                                                  make_tp_train_step,
                                                  make_zero2_train_step,
                                                  shard_batch)

    t_start = time.perf_counter()
    mesh = make_mesh(job["mesh"])
    cfg = train_mesh_cfg(job)
    torch.cuda.reset_peak_memory_stats()
    if job["model"] == "smol":
        rules = {"megatron": param_shardings(cfg),
                 "hsdp": fsdp_param_shardings(cfg, tp_axis="tp"),
                 None: None}[job["rules"]]
        params = init_params(cfg, 0)
        if rules is not None:
            params = apply_shardings(params, mesh, rules)

        def loss(p, b):
            return loss_fn(p, b, cfg, mesh=mesh, rules=rules) * \
                b["scale"].mean()
    else:
        rules = moe_model_shardings(cfg, tp_axis=None)
        params = seeded_moe_shard(cfg, 0, mesh, rules)

        def loss(p, b):
            return moe_loss_fn(p, b, cfg, mesh=mesh, rules=rules)
    opt = AdamW(param_leaves(params), lr=TRAIN_MESH_LR)
    batch = train_mesh_batch(job, cfg)
    if "dp" in mesh.shape:
        batch = shard_batch(batch, mesh)
    zero = None
    if job.get("zero"):
        step, init = make_zero2_train_step(loss, opt, mesh, rules, params,
                                           accum_steps=job["accum"],
                                           guard=True)
        zero = init(params)
    else:
        step = make_tp_train_step(loss, opt, mesh, rules, guard=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    for k in counts:
        counts[k] = 0
    losses, vs, secs, per_step, coll = [], [], [], [], []
    row = {}
    t_steps = time.perf_counter()

    def one(b):
        before, c0 = launch_counts(), dict(counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lval, aux = step(params, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        coll.append(sum(counts[k] - c0[k] for k in counts))
        return float(lval), aux["v"].tolist()

    for i in range(job["steps"]):
        if i == job.get("nan_after"):
            bad = dict(batch, scale=batch["scale"].clone())
            if mesh.index("dp") == 0:
                bad["scale"][0] = float("nan")
            state = [zero.moments(t) for t in param_leaves(params)]
            snap = ([t.clone() for t in param_leaves(params)],
                    [{k: (v.clone() if torch.is_tensor(v) else v)
                      for k, v in st.items()} for st in state])
            _, v_bad = one(bad)
            same = all(torch.equal(a, b) for a, b in
                       zip(snap[0], param_leaves(params))) and all(
                all(torch.equal(a[k], b[k]) if torch.is_tensor(a[k])
                    else a[k] == b[k] for k in a)
                for a, b in zip(snap[1], state))
            row.update(nan_step_v=v_bad, nan_step_skipped_bitwise=same)
            del snap
        lval, v = one(batch)
        losses.append(lval)
        vs.append(v)
    if zero is not None:
        row["moment_fraction"] = sorted({
            zero.moments(t)["mu"].numel() / t.numel()
            for t in param_leaves(params)})
    peak = torch.cuda.max_memory_allocated() / 1e9
    t_send = time.perf_counter()
    sent = send_shards(job["name"], named_param_leaves(params), rules, mesh,
                       send)
    steady = sorted(secs[1:]) or secs
    t_end = time.perf_counter()
    row.update(seconds=dict(setup=t_steps - t_start, steps=t_send - t_steps,
                            send=t_end - t_send),
               losses=losses, v=vs, launches_per_step=per_step,
               ms_per_step=[1e3 * x for x in secs],
               ms_per_step_median=1e3 * steady[len(steady) // 2],
               collectives_per_step=coll, collectives=dict(counts),
               peak_gb=peak, leaves_sent=sent,
               k1=sum(c["k1"] for c in per_step),
               k2=sum(c["k2"] for c in per_step),
               k3=sum(c["k3"] for c in per_step))
    del params, opt, step, batch, zero
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_train_mesh(backend="gloo"):
    """Phase 19: the references here, then the four ranks train every
    job; every rank's losses equal, the losses within 1e-5 and each
    step's gradient norm within 1e-4 relative of the reference's, every
    leaf (gathered from the shards) within 1e-4 relative L2 of the
    reference's final leaf, K1/K2/K3 launches per rank per step as the
    model and accumulation give them, the ZeRO moments a quarter of each
    leaf and the NaN step skipped bitwise; no kernel rebuilt."""
    import torch

    ts = time.perf_counter()
    refs, finals, key_of = {}, {}, {}
    for job in TRAIN_MESH_JOBS:
        key = (job["model"], job["B"], job["segments"], job["steps"])
        key_of[job["name"]] = key
        if key not in refs:
            t0 = time.perf_counter()
            refs[key], finals[key] = train_mesh_reference(job)
            refs[key]["seconds"] = time.perf_counter() - t0
            say("train_mesh_reference", job=job["name"], **refs[key])
    acc, compare_s = {}, [0.0]

    def on_item(rank, item):
        t0 = time.perf_counter()
        _, name, path, split, arr = item
        ref = finals[key_of[name]][path]
        for d, (n, idx) in enumerate(split):
            if n > 1:
                w = ref.shape[d] // n
                ref = ref.narrow(d, idx * w, w)
        got = arr
        check(got.shape == ref.shape, f"{name} {path}: shard "
              f"{tuple(got.shape)} against {tuple(ref.shape)}")
        e = acc.setdefault(name, {}).setdefault(path, [0.0, 0.0, 0])
        e[0] += float(torch.linalg.vector_norm(got - ref)) ** 2
        e[1] += float(torch.linalg.vector_norm(ref)) ** 2
        e[2] += got.numel()
        compare_s[0] += time.perf_counter() - t0

    torch.cuda.empty_cache()
    t_ranks, t_wall = time.perf_counter(), time.time()
    ranks = run_mesh_ranks([dict(j, train=True) for j in TRAIN_MESH_JOBS],
                           backend, on_item)
    t_ranks = time.perf_counter() - t_ranks
    c0 = ranks[0]["clock"]
    clock = {"spawn_to_ready_s": c0["ready"] - t_wall,
             "ready_to_done_s": c0["done"] - c0["ready"],
             "done_to_joined_s": t_wall + t_ranks - c0["done"]}
    check(all(r["rebuilt"] == [] for r in ranks.values()),
          f"a mesh rank rebuilt kernels: "
          f"{[r['rebuilt'] for r in ranks.values()]}")
    rows = {}
    for job in TRAIN_MESH_JOBS:
        name, ref = job["name"], refs[key_of[job["name"]]]
        per = [ranks[r][name] for r in range(MESH_WORLD)]
        first = per[0]
        cfg = train_mesh_cfg(job)
        L = cfg.n_layers
        micro = job.get("accum", 1)
        want = ({"k1": 2 * L * micro, "k2": L * micro, "k3": L * micro}
                if job["model"] == "smol" else {"k1": L, "k2": L, "k3": L})
        check(all(p["losses"] == first["losses"] for p in per),
              f"{name}: the ranks' losses differ: "
              f"{[p['losses'] for p in per]}")
        loss_rel = [abs(a - b) / abs(b)
                    for a, b in zip(first["losses"], ref["losses"])]
        gnorm_rel = [abs(v[2] - g) / g for v, g in zip(first["v"],
                                                      ref["gnorms"])]
        leaf = {path: (e[0] / e[1]) ** 0.5 if e[1] else e[0] ** 0.5
                for path, e in acc.get(name, {}).items()}
        covered = {path: e[2] for path, e in acc.get(name, {}).items()}
        whole = {path: t.numel()
                 for path, t in finals[key_of[name]].items()}
        worst = max(leaf, key=leaf.get) if leaf else None
        launches_ok = all(c == want for p in per
                          for c in p["launches_per_step"])
        rows[name] = dict(
            mesh=job["mesh"], rules=job["rules"], layers=L, batch=job["B"],
            seq=TRAIN_MESH_S, steps=job["steps"], lr=TRAIN_MESH_LR,
            losses=first["losses"], reference_losses=ref["losses"],
            loss_rel_err=loss_rel, gnorm=[v[2] for v in first["v"]],
            reference_gnorm=ref["gnorms"], gnorm_rel_err=gnorm_rel,
            worst_leaf=worst, worst_leaf_rel_l2=leaf.get(worst),
            leaves=len(leaf), launches_per_step_rank0=first[
                "launches_per_step"], want_per_step=want,
            k1_launches_rank0=first["k1"], k2_launches_rank0=first["k2"],
            k3_launches_rank0=first["k3"],
            ms_per_step_median_per_rank=[p["ms_per_step_median"]
                                         for p in per],
            ms_per_step_rank0=first["ms_per_step"],
            collectives_per_step_rank0=first["collectives_per_step"],
            collectives_rank0=first["collectives"],
            peak_gb_per_rank=[p["peak_gb"] for p in per],
            reference_peak_gb=ref["peak_gb"], seconds_rank0=first["seconds"],
            backend=backend,
            note=MESH_NOTE[backend],
            **{k: first[k] for k in ("nan_step_v", "nan_step_skipped_bitwise",
                                     "moment_fraction") if k in first})
        say(name, **rows[name])
        check(all(v[0] == 1.0 for p in per for v in p["v"]),
              f"{name}: a good step was skipped")
        check(max(loss_rel) <= TRAIN_MESH_LOSS_RTOL,
              f"{name}: losses {first['losses']} against {ref['losses']}")
        check(max(gnorm_rel) <= TRAIN_MESH_LEAF_RTOL,
              f"{name}: gradient norms {rows[name]['gnorm']} against "
              f"{ref['gnorms']}")
        check(covered == whole, f"{name}: leaves not covered by the "
              f"shards: {sorted(set(whole) - set(covered))}")
        check(leaf[worst] <= TRAIN_MESH_LEAF_RTOL,
              f"{name}: leaf {worst} {leaf[worst]} over "
              f"{TRAIN_MESH_LEAF_RTOL}")
        check(launches_ok, f"{name}: launches per step "
              f"{[p['launches_per_step'] for p in per]}, want {want}")
        if job.get("zero"):
            check(all(p["moment_fraction"] == [0.25] for p in per),
                  f"{name}: moment shards {first['moment_fraction']}")
            check(all(p["nan_step_v"][0] == 0.0
                      and p["nan_step_skipped_bitwise"] for p in per),
                  f"{name}: the NaN step was not skipped bitwise")
    rows["seconds"] = time.perf_counter() - ts
    say("train_mesh_seconds", seconds=rows["seconds"], ranks_s=t_ranks,
        rank0_clock=clock, compare_s=compare_s[0],
        references_s=sum(r["seconds"] for r in refs.values()))
    return rows


# ----------------------------------------------------------------------
# phase 20: sequence-parallel training.  K1, K2 and K3 first at a ring
# hop's geometry, here; then phase 18's four ranks (gloo on the one
# card; NCCL, one card each, with --mesh-nccl) train each job below from
# seed 0 with attention as the ring (or Ulysses) over sp, held to the
# single-process step on the whole tree and batch, run first here, as
# phase 19 holds its jobs.  Every ring hop is one K1 launch at the hop's
# global offsets, and one K2 and one K3 in the backward.

TRAIN_SP_S = 2048
ZIGZAG_S = 8192
ZIGZAG_WINDOW = 1024
ZIGZAG_SEED = 13
# The zigzag ring against one launch on the whole sequence: in fp32
# element by element at K1's and K2/K3's fp32 limits; in bf16 each hop's
# output (and dQ/dK/dV) is rounded to bf16 before the fp32 fold, as the
# JAX ring folds them, so a result carries up to one rounding a hop
# where one launch carries one: relative L2 per tensor, 2.5 bf16 ulps.
ZIGZAG_BF16_REL_L2 = 1e-2
# Largest first, as in phase 19.  K1/K2/K3 per rank per step: the
# plan's hops times the layers, K1 twice with remat (the MoE family runs
# without it); the zigzag job's four half-pair launches a hop, per run.
TRAIN_SP_JOBS = (
    dict(name="train_sp_ring_window_mistral_sp4", model="mistral",
         mesh={"sp": 4}, method="ring", B=1, S=8192, segments=False,
         steps=2),
    dict(name="grad_sp_moe_mixtral_sp2_ep2", model="mixtral",
         mesh={"sp": 2, "ep": 2}, method="ring", B=1, S=1024,
         segments=False, steps=1, grad_only=True),
    dict(name="train_sp_ulysses_tinyllama_sp2_tp2", model="tinyllama",
         mesh={"sp": 2, "tp": 2}, method="ulysses", rules="megatron", B=2,
         S=TRAIN_SP_S, segments=True, steps=2),
    dict(name="train_sp_ring_smol_sp4", model="smol", mesh={"sp": 4},
         method="ring", B=2, S=TRAIN_SP_S, segments=True, steps=2),
    dict(name="train_sp_ring_smol_dp2_sp2", model="smol",
         mesh={"dp": 2, "sp": 2}, method="ring", B=4, S=TRAIN_SP_S,
         segments=True, steps=2),
    dict(name="train_sp_zigzag_mistral_sp4", model="attention",
         mesh={"sp": 4}, B=1, S=ZIGZAG_S),
)
# Depth cut to fit four ranks of fp32 weights, gradients and AdamW
# moments on one card beside the reference (PERF.md, phase 20).
SP_LAYERS = {"mistral": 2, "tinyllama": 4, "mixtral": 1}


def phase_hop_kernels():
    """K1, K2 and K3 at the geometry of ring hops of Mistral-7B's
    attention (H 32, Hkv 8, D 128, chunks of 1024, zigzag halves of
    512), bf16 and fp32, each through the wrapper the ring calls against
    its plain version: the diagonal hop, a fully visible and a fully
    masked one, window 1536 at its edge and past it, zigzag half-pairs
    and key-side segments unlike the query side's.  Rows no key reaches
    are undefined on both sides (K1: lse ~ -6.9e29, the plain version
    -1e30 + log Sk): they must agree on which rows those are, and only
    the others are compared.  K2/K3 run from a whole-sequence lse and
    delta (this hop folded with the diagonal one), as the ring runs
    them; a fully masked hop's dK/dV must be exactly zero.  Returns the
    worst bf16 errors of K1, K2 and K3."""
    import torch
    from nbdistributed_tpu_torch.ops import attention as A

    H, Hkv, D, C, Z = 32, 8, 128, 1024, 512
    # name, chunk length, (q_off, k_off), window, key-side segments
    cases = [
        ("hop_diagonal", C, (C, C), None, False),
        ("hop_fully_visible", C, (2 * C, 0), None, False),
        ("hop_fully_masked", C, (0, C), None, False),
        ("hop_window1536_edge", C, (2 * C, C), 1536, False),
        ("hop_window1536_rows_past", C, (3 * C, C), 1536, False),
        ("zigzag_half_diagonal", Z, (Z, Z), None, False),
        ("zigzag_half_masked", Z, (Z, 5 * Z), None, False),
        ("zigzag_half_visible", Z, (6 * Z, 2 * Z), None, False),
        ("zigzag_half_window768", Z, (6 * Z, 5 * Z), 768, False),
        ("hop_kv_segments_differ", C, (2 * C, C), None, True),
    ]
    worst = {"k1": 0.0, "dq": 0.0, "dkv": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for name, L, offs, window, segs in cases:
            g = torch.Generator(device="cuda").manual_seed(len(name))
            q, do = (torch.randn(1, L, H, D, generator=g, device="cuda")
                     .to(dtype) for _ in range(2))
            k, v, kd, vd = (torch.randn(1, L, Hkv, D, generator=g,
                                        device="cuda").to(dtype)
                            for _ in range(4))
            qseg = kseg = None
            if segs:
                pos = torch.arange(L, device="cuda")
                qseg = (5 + torch.bucketize(pos, torch.tensor(
                    [200, 600], device="cuda"), right=True))[None]
                kseg = (4 + torch.bucketize(pos, torch.tensor(
                    [300, 900], device="cuda"), right=True))[None]
                qseg, kseg = (t.to(torch.int32).contiguous()
                              for t in (qseg, kseg))
            args = dict(causal=True, scale=D ** -0.5, offsets=offs,
                        window=window, segment_ids=qseg,
                        kv_segment_ids=kseg)
            label = f"{name}_{str(dtype).split('.')[-1]}"
            out, lse = A._flash_forward(q, k, v, **args)
            ref, ref_lse = A._flash_forward_plain(q, k, v, **args)
            undef = ref_lse <= -1e29                      # (B, H, Sq)
            check(torch.equal(lse <= -1e29, undef),
                  f"K1 {label}: rows without keys differ from the plain "
                  f"version's")
            rows = undef.transpose(1, 2)[..., None]       # (B, Sq, H, 1)
            e_k1 = check_k1(label, out.masked_fill(rows, 0),
                            lse.masked_fill(undef, 0),
                            ref.masked_fill(rows, 0),
                            ref_lse.masked_fill(undef, 0), dtype)
            # The whole sequence's lse: this hop folded with the
            # diagonal one (finite on every row: each query sees
            # itself), and delta from this hop's output.
            _, lse_d = A._flash_forward_plain(
                q, kd, vd, **dict(args, offsets=(offs[0], offs[0]),
                                  kv_segment_ids=qseg))
            L_all = torch.logaddexp(ref_lse, lse_d)
            delta = A._flash_bwd_prep(ref, do)
            got = A._flash_backward_hop(q, k, v, do, L_all, delta, **args)
            want = A._flash_backward_plain(q, k, v, None, L_all, do,
                                           delta=delta, **args)
            torch.cuda.synchronize()
            row = check_k23(label, got, want, dtype)
            if bool(undef.all()):
                check(all(bool((t == 0).all()) for t in got),
                      f"K2/K3 {label}: a hop no query sees must give "
                      f"zero gradients")
            say("hop_kernel_case", case=label, offsets=offs, window=window,
                undefined_rows=int(undef.sum()), rows=undef.numel())
            if dtype == torch.bfloat16:
                worst["k1"] = max(worst["k1"], e_k1)
                worst["dq"] = max(worst["dq"], row["dq"]["max_abs_err"])
                worst["dkv"] = max(worst["dkv"], row["dk"]["max_abs_err"],
                                   row["dv"]["max_abs_err"])
    return worst


def train_sp_cfg(job):
    import torch
    from nbdistributed_tpu_torch.models import (mistral_7b_config,
                                                mixtral_8x7b_config,
                                                smol_135m_config,
                                                tinyllama_1b_config)
    model = job["model"]
    if model == "mixtral":
        return mixtral_8x7b_config(
            dtype=torch.float32, n_layers=SP_LAYERS[model],
            capacity_factor=MOE_LOSSLESS, moe_dispatch="dropless")
    make = {"smol": smol_135m_config, "tinyllama": tinyllama_1b_config,
            "mistral": mistral_7b_config}[model]
    kw = {"n_layers": SP_LAYERS[model]} if model in SP_LAYERS else {}
    return make(dtype=torch.float32, remat=True, **kw)


def train_sp_want(job, cfg):
    """K1/K2/K3 per rank per step: one of each per hop per layer, K1
    again in the remat recompute."""
    from nbdistributed_tpu_torch.parallel import hop_plan
    n = job["mesh"]["sp"]
    C = job["S"] // n
    hops = (1 if job["method"] == "ulysses" else
            len(hop_plan(n, C, cfg.sliding_window)))
    L = cfg.n_layers
    return {"k1": hops * L * (2 if cfg.remat else 1), "k2": hops * L,
            "k3": hops * L}


def train_sp_batch(job, cfg):
    batch = dict(packed_batch(cfg, job["B"], job["S"],
                              TRAIN_MESH_BATCH_SEED))
    if not job["segments"]:
        del batch["segments"]
    return batch


def zigzag_inputs(dtype):
    """q, k, v and the output cotangent of Mistral-7B's attention over
    the whole sequence (B 1, S 8192, H 32, Hkv 8, D 128) from
    ``ZIGZAG_SEED``: the same numbers in the parent and in every rank."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(ZIGZAG_SEED)
    shapes = [(1, ZIGZAG_S, 32, 128), (1, ZIGZAG_S, 8, 128),
              (1, ZIGZAG_S, 8, 128), (1, ZIGZAG_S, 32, 128)]
    return [torch.randn(s, generator=g, device="cuda").to(dtype)
            for s in shapes]


ZIGZAG_RUNS = tuple((d, w) for d in ("bfloat16", "float32")
                    for w in (None, ZIGZAG_WINDOW))


def train_sp_reference(job):
    """The single-process reference: for a training job the step
    (``loss_fn`` or ``moe_loss_fn`` and AdamW; for a gradient job the
    gradients alone) on the whole tree and batch, with each step's loss
    and gradient norm and the final leaves (or the gradients) on the
    host; for the zigzag job ``flash_attention`` on the whole sequence
    in natural order, its output and gradients on the host."""
    import gc

    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_moe_model,
                                                init_params, loss_fn,
                                                moe_loss_fn,
                                                named_param_leaves)
    from nbdistributed_tpu_torch.ops import flash_attention

    torch.cuda.reset_peak_memory_stats()
    if job["model"] == "attention":
        final = {}
        for dname, window in ZIGZAG_RUNS:
            q, k, v, do = zigzag_inputs(getattr(torch, dname))
            q, k, v = (t.requires_grad_() for t in (q, k, v))
            out = flash_attention(q, k, v, True, None, window)
            out.backward(do)
            final[(dname, window)] = [t.detach().cpu() for t in
                                      (out, q.grad, k.grad, v.grad)]
            del q, k, v, do, out
        return dict(peak_gb=torch.cuda.max_memory_allocated() / 1e9), final
    cfg = train_sp_cfg(job)
    moe = job["model"] == "mixtral"
    params = init_moe_model(cfg, 0) if moe else init_params(cfg, 0)
    batch = train_sp_batch(job, cfg)
    named = named_param_leaves(params)
    leaves = [t.requires_grad_() for _, t in named]
    opt = None if job.get("grad_only") else AdamW(leaves, lr=TRAIN_MESH_LR)
    losses, gnorms = [], []
    for _ in range(job["steps"]):
        for p in leaves:
            p.grad = None
        loss = (moe_loss_fn if moe else loss_fn)(params, batch, cfg)
        loss.backward()
        gnorms.append(float(torch.stack([p.grad.float().pow(2).sum()
                                         for p in leaves]).sum().sqrt()))
        if opt is not None:
            opt.step()
        losses.append(float(loss.detach()))
    peak = torch.cuda.max_memory_allocated() / 1e9
    final = {path: (t.grad if opt is None else t).detach().cpu()
             for path, t in named}
    del params, named, leaves, opt, batch, loss
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, gnorms=gnorms, peak_gb=peak), final


class KeepGrads:
    """An optimizer for a gradient-only job: keeps the gradients the step
    gives it, by id of their leaf, and updates nothing."""

    def __init__(self, leaves):
        self.param_groups = [{"params": list(leaves)}]
        self.grads = {}

    def step(self):
        self.grads = {id(p): p.grad.detach().clone()
                      for p in self.param_groups[0]["params"]}


def zigzag_sp_job(job, counts, send, mesh):
    """The zigzag ring on this rank: each run of ``ZIGZAG_RUNS`` on its
    two half-chunks of the zigzag-ordered sequence, forward and
    backward, launches and collectives counted from just before to just
    after; rank 0 sends the gathered output and gradients."""
    import torch
    from nbdistributed_tpu_torch.parallel import (hop_plan, ring_attention,
                                                  zigzag_shard)
    from nbdistributed_tpu_torch.parallel.mesh import local_slice

    n, me = mesh.size("sp"), mesh.index("sp")
    row = {}
    for dname, window in ZIGZAG_RUNS:
        dtype = getattr(torch, dname)
        chunks = [local_slice(zigzag_shard(t, n), 1, n, me).contiguous()
                  for t in zigzag_inputs(dtype)]
        q, k, v = (t.requires_grad_() for t in chunks[:3])
        torch.cuda.synchronize()
        reset_launch_counts()
        c0 = dict(counts)
        t0 = time.perf_counter()
        out = ring_attention(q, k, v, mesh, use_flash=True,
                             schedule="zigzag", window=window)
        out.backward(chunks[3])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        hops = len(hop_plan(n, q.shape[1], window, "zigzag"))
        key = f"{dname}_window{window}"
        row[key] = dict(launches=launch_counts(), hops=hops,
                        want={k_: 4 * hops for k_ in ("k1", "k2", "k3")},
                        ms=1e3 * secs,
                        collectives=sum(counts[c] - c0[c] for c in counts))
        whole = [mesh.all_gather(t.detach().contiguous(), "sp", 1)
                 for t in (out, q.grad, k.grad, v.grad)]
        if me == 0:
            host = []
            for t in whole:
                h = torch.empty(t.shape, dtype=t.dtype).share_memory_()
                h.copy_(t)
                host.append(h)
            send(("zigzag", job["name"], (dname, window), host))
        del q, k, v, out, chunks, whole
    row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return row


def train_sp_job(job, counts, send):
    """One sequence-parallel job on this rank: the model from the seed cut
    to this rank's shard, its rows of the batch (whole rows: the loss
    cuts its chunk), the guarded step over dp and sp (for a gradient
    job, gradients and no update), counts reset just before the steps
    and read per step; then each leaf (or gradient) shard this rank is
    the first holder of goes to the parent."""
    import gc

    import torch
    from nbdistributed_tpu_torch.models import (AdamW, SeqParallel,
                                                init_params, loss_fn,
                                                moe_loss_fn,
                                                moe_model_shardings,
                                                named_param_leaves,
                                                param_leaves,
                                                param_shardings)
    from nbdistributed_tpu_torch.parallel import (apply_shardings, make_mesh,
                                                  make_tp_train_step,
                                                  shard_batch)

    t_start = time.perf_counter()
    mesh = make_mesh(job["mesh"])
    torch.cuda.reset_peak_memory_stats()
    if job["model"] == "attention":
        return zigzag_sp_job(job, counts, send, mesh)
    cfg = train_sp_cfg(job)
    sp = SeqParallel(mesh, method=job["method"])
    moe = job["model"] == "mixtral"
    if moe:
        rules = moe_model_shardings(cfg, tp_axis=None)
        params = seeded_moe_shard(cfg, 0, mesh, rules)
    else:
        rules = param_shardings(cfg) if job.get("rules") else None
        params = init_params(cfg, 0)
        if rules is not None:
            params = apply_shardings(params, mesh, rules)

    def loss(p, b):
        fn = moe_loss_fn if moe else loss_fn
        return fn(p, b, cfg, rules=rules, sp=sp)

    leaves = param_leaves(params)
    opt = (KeepGrads(leaves) if job.get("grad_only")
           else AdamW(leaves, lr=TRAIN_MESH_LR))
    batch = train_sp_batch(job, cfg)
    if "dp" in mesh.shape:
        batch = shard_batch(batch, mesh)
    step = make_tp_train_step(loss, opt, mesh, rules, guard=True,
                              sp_axis="sp")
    torch.cuda.synchronize()
    reset_launch_counts()
    for k in counts:
        counts[k] = 0
    losses, vs, secs, per_step, coll = [], [], [], [], []
    t_steps = time.perf_counter()
    for _ in range(job["steps"]):
        before, c0 = launch_counts(), dict(counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lval, aux = step(params, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        coll.append(sum(counts[k] - c0[k] for k in counts))
        losses.append(float(lval))
        vs.append(aux["v"].tolist())
    peak = torch.cuda.max_memory_allocated() / 1e9
    t_send = time.perf_counter()
    named = named_param_leaves(params)
    if job.get("grad_only"):
        named = [(path, opt.grads[id(t)]) for path, t in named]
    sent = send_shards(job["name"], named, rules, mesh, send)
    t_end = time.perf_counter()
    row = dict(seconds=dict(setup=t_steps - t_start, steps=t_send - t_steps,
                            send=t_end - t_send),
               losses=losses, v=vs, launches_per_step=per_step,
               want_per_step=train_sp_want(job, cfg),
               ms_per_step=[1e3 * x for x in secs],
               collectives_per_step=coll, collectives=dict(counts),
               peak_gb=peak, leaves_sent=sent,
               k1=sum(c["k1"] for c in per_step),
               k2=sum(c["k2"] for c in per_step),
               k3=sum(c["k3"] for c in per_step))
    del params, opt, step, batch, named, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_train_sp(backend="gloo"):
    """Phase 20: the references here, then the four ranks run every job;
    every rank's losses equal, the losses within 1e-5 and each step's
    gradient norm within 1e-4 relative of the reference's, every leaf
    (or gradient) within 1e-4 relative L2, K1/K2/K3 launches per rank per
    step the plan's; the zigzag ring's output and gradients within K1's
    and K2/K3's fp32 limits of ``flash_attention`` on the whole sequence
    (bf16: ``ZIGZAG_BF16_REL_L2``); no kernel rebuilt."""
    import torch
    from nbdistributed_tpu_torch.parallel import zigzag_unshard

    ts = time.perf_counter()
    refs, finals = {}, {}
    for job in TRAIN_SP_JOBS:
        t0 = time.perf_counter()
        refs[job["name"]], finals[job["name"]] = train_sp_reference(job)
        refs[job["name"]]["seconds"] = time.perf_counter() - t0
        say("train_sp_reference", job=job["name"], **refs[job["name"]])
    acc, zz, compare_s = {}, {}, [0.0]

    def on_item(rank, item):
        t0 = time.perf_counter()
        if item[0] == "zigzag":
            _, name, key, tensors = item
            n = MESH_WORLD
            dname = key[0]
            want = finals[name][key]
            tols = [K1_TOL[dname]] + [K23_TOL[dname]] * 3
            zz[key] = {}
            for label, got, w, (atol, rtol) in zip(
                    ("out", "dq", "dk", "dv"), tensors, want, tols):
                got = zigzag_unshard(got, n)
                r = dict(max_abs_err=max_err(got, w), rel_l2=rel_l2(got, w),
                         tol_ratio=tol_ratio(got, w, atol, rtol))
                r["ok"] = (r["rel_l2"] <= ZIGZAG_BF16_REL_L2
                           if dname == "bfloat16" else r["tol_ratio"] <= 1)
                zz[key][label] = r
        else:
            _, name, path, split, arr = item
            ref = finals[name][path]
            for d, (n, idx) in enumerate(split):
                if n > 1:
                    w = ref.shape[d] // n
                    ref = ref.narrow(d, idx * w, w)
            check(arr.shape == ref.shape, f"{name} {path}: shard "
                  f"{tuple(arr.shape)} against {tuple(ref.shape)}")
            e = acc.setdefault(name, {}).setdefault(path, [0.0, 0.0, 0])
            e[0] += float(torch.linalg.vector_norm(arr - ref)) ** 2
            e[1] += float(torch.linalg.vector_norm(ref)) ** 2
            e[2] += arr.numel()
        compare_s[0] += time.perf_counter() - t0

    torch.cuda.empty_cache()
    t_ranks = time.perf_counter()
    ranks = run_mesh_ranks([dict(j, train_sp=True) for j in TRAIN_SP_JOBS],
                           backend, on_item)
    t_ranks = time.perf_counter() - t_ranks
    check(all(r["rebuilt"] == [] for r in ranks.values()),
          f"a mesh rank rebuilt kernels: "
          f"{[r['rebuilt'] for r in ranks.values()]}")
    rows = {}
    for job in TRAIN_SP_JOBS:
        name, ref = job["name"], refs[job["name"]]
        per = [ranks[r][name] for r in range(MESH_WORLD)]
        first = per[0]
        if job["model"] == "attention":
            runs = {f"{d}_window{w}": dict(first[f"{d}_window{w}"],
                                           errors=zz.get((d, w)))
                    for d, w in ZIGZAG_RUNS}
            rows[name] = dict(mesh=job["mesh"], seq=job["S"], runs=runs,
                              peak_gb_per_rank=[p["peak_gb"] for p in per],
                              reference_peak_gb=ref["peak_gb"],
                              k1_launches_rank0=sum(
                                  r["launches"]["k1"] for r in runs.values()),
                              k2_launches_rank0=sum(
                                  r["launches"]["k2"] for r in runs.values()),
                              k3_launches_rank0=sum(
                                  r["launches"]["k3"] for r in runs.values()),
                              backend=backend, note=MESH_NOTE[backend])
            say(name, **rows[name])
            for key, r in runs.items():
                check(all(p[key]["launches"] == r["want"] for p in per),
                      f"{name} {key}: launches "
                      f"{[p[key]['launches'] for p in per]}, want "
                      f"{r['want']}")
                check(r["errors"] is not None and all(
                    e["ok"] for e in r["errors"].values()),
                      f"{name} {key}: {r['errors']} over tolerance")
            continue
        loss_rel = [abs(a - b) / abs(b)
                    for a, b in zip(first["losses"], ref["losses"])]
        gnorm_rel = [abs(v[2] - g) / g for v, g in zip(first["v"],
                                                      ref["gnorms"])]
        leaf = {path: (e[0] / e[1]) ** 0.5 if e[1] else e[0] ** 0.5
                for path, e in acc.get(name, {}).items()}
        covered = {path: e[2] for path, e in acc.get(name, {}).items()}
        whole = {path: t.numel() for path, t in finals[name].items()}
        worst = max(leaf, key=leaf.get) if leaf else None
        want = first["want_per_step"]
        rows[name] = dict(
            mesh=job["mesh"], method=job["method"],
            rules=job.get("rules"), layers=train_sp_cfg(job).n_layers,
            batch=job["B"], seq=job["S"], steps=job["steps"],
            grad_only=bool(job.get("grad_only")),
            losses=first["losses"], reference_losses=ref["losses"],
            loss_rel_err=loss_rel, gnorm=[v[2] for v in first["v"]],
            reference_gnorm=ref["gnorms"], gnorm_rel_err=gnorm_rel,
            worst_leaf=worst, worst_leaf_rel_l2=leaf.get(worst),
            leaves=len(leaf),
            launches_per_step_rank0=first["launches_per_step"],
            want_per_step=want, k1_launches_rank0=first["k1"],
            k2_launches_rank0=first["k2"], k3_launches_rank0=first["k3"],
            ms_per_step_rank0=first["ms_per_step"],
            ms_per_step_per_rank=[p["ms_per_step"] for p in per],
            collectives_per_step_rank0=first["collectives_per_step"],
            collectives_rank0=first["collectives"],
            peak_gb_per_rank=[p["peak_gb"] for p in per],
            reference_peak_gb=ref["peak_gb"], seconds_rank0=first["seconds"],
            backend=backend, note=MESH_NOTE[backend])
        say(name, **rows[name])
        check(all(p["losses"] == first["losses"] for p in per),
              f"{name}: the ranks' losses differ: "
              f"{[p['losses'] for p in per]}")
        check(all(v[0] == 1.0 for p in per for v in p["v"]),
              f"{name}: a good step was skipped")
        check(max(loss_rel) <= TRAIN_MESH_LOSS_RTOL,
              f"{name}: losses {first['losses']} against {ref['losses']}")
        check(max(gnorm_rel) <= TRAIN_MESH_LEAF_RTOL,
              f"{name}: gradient norms {rows[name]['gnorm']} against "
              f"{ref['gnorms']}")
        check(covered == whole, f"{name}: leaves not covered by the "
              f"shards: {sorted(set(whole) - set(covered))}")
        check(leaf[worst] <= TRAIN_MESH_LEAF_RTOL,
              f"{name}: leaf {worst} {leaf[worst]} over "
              f"{TRAIN_MESH_LEAF_RTOL}")
        check(all(c == want for p in per for c in p["launches_per_step"]),
              f"{name}: launches per step "
              f"{[p['launches_per_step'] for p in per]}, want {want}")
    rows["seconds"] = time.perf_counter() - ts
    say("train_sp_seconds", seconds=rows["seconds"], ranks_s=t_ranks,
        compare_s=compare_s[0],
        references_s=sum(r["seconds"] for r in refs.values()))
    return rows


# ----------------------------------------------------------------------
# phase 21: pipeline-parallel training.  First the remat "dots" policy
# on the training shape here (single process).  Then phase 18's four
# ranks (gloo on the one card; NCCL, one card each, with --mesh-nccl)
# train each job below from seed 0 with the layer stack pipelined over
# pp, held to the single-process step on the whole tree and batch, run
# first here, as phase 19 holds its jobs; and time the ring-decomposed
# all-gather matmul against an all-gather and one product.  Every stage
# runs its layers' K1 forward and K2 + K3 backward per microbatch.

TRAIN_PP_S = 512
TRAIN_PP_LR = 1e-4
# Depth cut 32 -> 4 (one layer a stage) so that four ranks' fp32
# weights, gradients and AdamW moments fit one card beside the rest
# (PERF.md, phase 21); widths are the published ones.  SmolLM2 at full
# depth, 15 layers a stage.  Largest first, as in phase 19.
TRAIN_PP_JOBS = (
    dict(name="train_pp_gpipe_mistral_pp4", model="mistral",
         mesh={"pp": 4}, schedule="gpipe", B=16, M=16, steps=2),
    dict(name="train_pp_1f1b_mistral_pp4", model="mistral",
         mesh={"pp": 4}, schedule="1f1b", B=16, M=16, steps=2),
    dict(name="train_pp_1f1b_smol_dp2_pp2", model="smol",
         mesh={"dp": 2, "pp": 2}, schedule="1f1b", B=8, M=4, steps=2,
         batch_axis="dp"),
)
PP_LAYERS = {"mistral": 4}
# C4's yardstick: a Megatron column product of Mistral's MLP on tp4,
# each rank's 2048 rows of x (8192 in all) against its 14336/4 columns.
OVERLAP_JOB = dict(name="overlap_allgather_matmul_tp4", mesh={"tp": 4},
                   rows=2048, d_model=4096, cols=14336 // 4, iters=10)
DOTS_REL = 1e-6


def train_pp_cfg(job):
    import torch
    from nbdistributed_tpu_torch.models import (mistral_7b_config,
                                                smol_135m_config)
    if job["model"] == "mistral":
        return mistral_7b_config(dtype=torch.float32,
                                 n_layers=PP_LAYERS["mistral"])
    return smol_135m_config(dtype=torch.float32)


def train_pp_batch(job, cfg):
    """The job's tokens (the pipelined losses take no segments), the
    same in the parent and in every rank."""
    return {"tokens": packed_batch(cfg, job["B"], TRAIN_PP_S,
                                   TRAIN_MESH_BATCH_SEED)["tokens"]}


def train_pp_want(job, cfg, stage):
    """K1/K2/K3 a step on the rank of ``stage``: the stage's layers per
    microbatch; under 1F1B K1 twice (the forward sub-step and the
    backward's recompute) but on the last stage, whose forward and
    backward of a microbatch share one forward."""
    n = job["mesh"]["pp"]
    per = cfg.n_layers // n * job["M"]
    twice = job["schedule"] == "1f1b" and stage < n - 1
    return {"k1": per * (2 if twice else 1), "k2": per, "k3": per}


def train_pp_reference(job):
    """The single-process step (``loss_fn`` and AdamW) on the whole tree
    and batch: each step's loss and gradient norm, the final leaves on
    the host."""
    import gc

    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params, loss_fn,
                                                named_param_leaves)

    cfg = train_pp_cfg(job)
    params = init_params(cfg, 0)
    batch = train_pp_batch(job, cfg)
    named = named_param_leaves(params)
    leaves = [t.requires_grad_() for _, t in named]
    opt = AdamW(leaves, lr=TRAIN_PP_LR)
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms = [], []
    for _ in range(job["steps"]):
        for p in leaves:
            p.grad = None
        loss = loss_fn(params, batch, cfg)
        loss.backward()
        gnorms.append(float(torch.stack([p.grad.float().pow(2).sum()
                                         for p in leaves]).sum().sqrt()))
        opt.step()
        losses.append(float(loss.detach()))
    peak = torch.cuda.max_memory_allocated() / 1e9
    final = {path: t.detach().cpu() for path, t in named}
    del params, named, leaves, opt, batch, loss
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, gnorms=gnorms, peak_gb=peak), final


def train_pp_job(job, counts, send):
    """One pipelined job on this rank: the model from the seed, staged
    and cut to this rank's stage slice, the GPipe or 1F1B step through
    an AdamW that records each step's gradient norm (the stage leaves'
    squares summed over pp, the replicated leaves' once), counts reset
    just before the steps and read per step; then each leaf this rank is
    the first holder of goes to the parent, a stage slice as its rows of
    the ``(L, ...)`` stack."""
    import gc

    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                                make_pp_1f1b_train_step,
                                                make_pp_train_step,
                                                named_param_leaves,
                                                param_leaves,
                                                pp_apply_shardings,
                                                pp_stage_params)
    from nbdistributed_tpu_torch.parallel import P, make_mesh

    t_start = time.perf_counter()
    mesh = make_mesh(job["mesh"])
    cfg = train_pp_cfg(job)
    n, stage = mesh.size("pp"), mesh.index("pp")
    params = pp_apply_shardings(pp_stage_params(init_params(cfg, 0), n),
                                mesh)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    staged = {id(t) for path, t in named_param_leaves(params)
              if path.startswith("layers_pp/")}

    class NormAdamW(AdamW):
        def step(self):
            ps = [p for g in self.param_groups for p in g["params"]]
            sq = [torch.stack([p.grad.float().pow(2).sum() for p in ps
                               if (id(p) in staged) == s]).sum()
                  for s in (True, False)]
            self.gnorms.append(float((mesh.psum(sq[0], "pp")
                                      + sq[1]).sqrt()))
            return super().step()

    opt = NormAdamW(param_leaves(params), lr=TRAIN_PP_LR)
    opt.gnorms = []
    if job["schedule"] == "gpipe":
        step = make_pp_train_step(cfg, opt, mesh, n_microbatches=job["M"])
    else:
        step = make_pp_1f1b_train_step(cfg, opt, mesh,
                                       n_microbatches=job["M"],
                                       batch_axis=job.get("batch_axis"))
    batch = train_pp_batch(job, cfg)
    torch.cuda.synchronize()
    reset_launch_counts()
    for k in counts:
        counts[k] = 0
    losses, secs, per_step, coll = [], [], [], []
    t_steps = time.perf_counter()
    for _ in range(job["steps"]):
        before, c0 = launch_counts(), dict(counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(params, batch)))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        after = launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        coll.append(sum(counts[k] - c0[k] for k in counts))
    peak = torch.cuda.max_memory_allocated() / 1e9
    t_send = time.perf_counter()
    named = []
    for path, t in named_param_leaves(params):
        if path.startswith("layers_pp/"):
            path, t = "layers/" + path[len("layers_pp/"):], t[0]
        named.append((path, t))
    rules = {"layers": {path[len("layers/"):]: P("pp") for path, _ in named
                        if path.startswith("layers/")}}
    sent = send_shards(job["name"], named, rules, mesh, send)
    t_end = time.perf_counter()
    row = dict(seconds=dict(setup=t_steps - t_start, steps=t_send - t_steps,
                            send=t_end - t_send),
               stage=stage, losses=losses, gnorms=opt.gnorms,
               launches_per_step=per_step,
               want_per_step=train_pp_want(job, cfg, stage),
               ms_per_step=[1e3 * x for x in secs],
               collectives_per_step=coll, collectives=dict(counts),
               peak_gb=peak, leaves_sent=sent,
               k1=sum(c["k1"] for c in per_step),
               k2=sum(c["k2"] for c in per_step),
               k3=sum(c["k3"] for c in per_step))
    del params, opt, step, batch, named
    gc.collect()
    torch.cuda.empty_cache()
    return row


def overlap_job(job, counts, send):
    """C4's yardstick on this rank: ``allgather_matmul`` (each hop posted
    before the product of the rows it carries on) against
    ``all_gather`` then one ``torch.matmul``, bf16, timed in the order
    ring, gather, gather, ring (``iters`` calls each, between barriers),
    and the two results' relative L2."""
    import torch
    from nbdistributed_tpu_torch.parallel import allgather_matmul, make_mesh

    mesh = make_mesh(job["mesh"])
    g = torch.Generator(device="cuda").manual_seed(17 + mesh.index("tp"))
    x = torch.randn(job["rows"], job["d_model"], generator=g, device="cuda",
                    dtype=torch.bfloat16)
    w = torch.randn(job["d_model"], job["cols"], generator=g, device="cuda",
                    dtype=torch.bfloat16) / job["d_model"] ** 0.5
    fns = {"ring": lambda: allgather_matmul(x, w, mesh, "tp"),
           "gather_then_matmul": lambda: mesh.all_gather(x, "tp", 0) @ w}
    ms = {k: [] for k in fns}
    for name in ("ring", "gather_then_matmul", "gather_then_matmul",
                 "ring"):
        fns[name]()
        torch.cuda.synchronize()
        mesh.psum(torch.zeros(1, device="cuda"), "tp")
        t0 = time.perf_counter()
        for _ in range(job["iters"]):
            fns[name]()
        torch.cuda.synchronize()
        ms[name].append(1e3 * (time.perf_counter() - t0) / job["iters"])
    a, b = fns["ring"]().float(), fns["gather_then_matmul"]().float()
    return dict(ms=ms, rel_l2=float((a - b).norm() / b.norm()),
                shape=dict(x=[job["rows"], job["d_model"]],
                           w=[job["d_model"], job["cols"]]))


def phase_remat_dots(seed=0):
    """``remat_policy="dots"`` on the SmolLM2 training shape (bf16, B=4 x
    S=2048 packed documents, one AdamW step, one process) against full
    remat and none: the loss within ``DOTS_REL`` of full remat's, K1 60
    (the forward and the recompute of attention), K2 and K3 30; peak GB
    and ms of the step for each."""
    import gc

    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                                make_train_step,
                                                param_leaves,
                                                smol_135m_config)

    rows = {}
    for name, kw in (("none", {}), ("full", {"remat": True}),
                     ("dots", {"remat": True, "remat_policy": "dots"})):
        cfg = smol_135m_config(**kw)
        params = init_params(cfg, seed)
        batch = packed_batch(cfg, TRAIN_B, cfg.max_seq_len, TRAIN_BATCH_SEED)
        step = make_train_step(cfg, AdamW(param_leaves(params), lr=1e-3))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        loss = float(step(params, batch))
        torch.cuda.synchronize()
        rows[name] = dict(loss=loss, ms=1e3 * (time.perf_counter() - t0),
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                          launches=launch_counts())
        del params, batch, step
    L = N_LAYERS_SMOL
    want = {"k1": 2 * L, "k2": L, "k3": L}
    rel = abs(rows["dots"]["loss"] - rows["full"]["loss"]) / abs(
        rows["full"]["loss"])
    say("train_remat_dots_bf16", **rows, loss_rel_dots_vs_full=rel,
        want_dots=want)
    check(rel <= DOTS_REL, f"dots loss {rows['dots']['loss']} against full "
          f"remat's {rows['full']['loss']}")
    check(rows["dots"]["launches"] == want, f"dots launched "
          f"{rows['dots']['launches']}, want {want}")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rows, loss_rel_dots_vs_full=rel)


def phase_train_pp(backend="gloo"):
    """Phase 21: the references here, then the four ranks run every job
    and the overlap yardstick; every rank's losses equal, the losses
    within 1e-5 and each step's gradient norm within 1e-4 relative of the
    reference's, every leaf (the stage slices as rows of the stack)
    within 1e-4 relative L2, the 1F1B losses within 1e-5 of GPipe's, and
    K1/K2/K3 launches per rank per step the schedule's; no kernel
    rebuilt."""
    import torch

    ts = time.perf_counter()
    refs, finals, key_of = {}, {}, {}
    for job in TRAIN_PP_JOBS:
        key = (job["model"], job["B"], job["steps"])
        key_of[job["name"]] = key
        if key not in refs:
            t0 = time.perf_counter()
            refs[key], finals[key] = train_pp_reference(job)
            refs[key]["seconds"] = time.perf_counter() - t0
            say("train_pp_reference", job=job["name"], **refs[key])
    acc, compare_s = {}, [0.0]

    def on_item(rank, item):
        t0 = time.perf_counter()
        _, name, path, split, arr = item
        ref = finals[key_of[name]][path]
        for d, (n, idx) in enumerate(split):
            if n > 1:
                w = ref.shape[d] // n
                ref = ref.narrow(d, idx * w, w)
        check(arr.shape == ref.shape, f"{name} {path}: shard "
              f"{tuple(arr.shape)} against {tuple(ref.shape)}")
        e = acc.setdefault(name, {}).setdefault(path, [0.0, 0.0, 0])
        e[0] += float(torch.linalg.vector_norm(arr - ref)) ** 2
        e[1] += float(torch.linalg.vector_norm(ref)) ** 2
        e[2] += arr.numel()
        compare_s[0] += time.perf_counter() - t0

    torch.cuda.empty_cache()
    t_ranks = time.perf_counter()
    jobs = [dict(j, train_pp=True) for j in TRAIN_PP_JOBS]
    ranks = run_mesh_ranks(jobs + [dict(OVERLAP_JOB, overlap=True)],
                           backend, on_item)
    t_ranks = time.perf_counter() - t_ranks
    check(all(r["rebuilt"] == [] for r in ranks.values()),
          f"a mesh rank rebuilt kernels: "
          f"{[r['rebuilt'] for r in ranks.values()]}")
    rows = {}
    for job in TRAIN_PP_JOBS:
        name, ref = job["name"], refs[key_of[job["name"]]]
        per = [ranks[r][name] for r in range(MESH_WORLD)]
        first = per[0]
        loss_rel = [abs(a - b) / abs(b)
                    for a, b in zip(first["losses"], ref["losses"])]
        gnorm_rel = [abs(a - b) / b
                     for a, b in zip(first["gnorms"], ref["gnorms"])]
        leaf = {path: (e[0] / e[1]) ** 0.5 if e[1] else e[0] ** 0.5
                for path, e in acc.get(name, {}).items()}
        covered = {path: e[2] for path, e in acc.get(name, {}).items()}
        whole = {path: t.numel()
                 for path, t in finals[key_of[name]].items()}
        worst = max(leaf, key=leaf.get) if leaf else None
        rows[name] = dict(
            mesh=job["mesh"], schedule=job["schedule"],
            layers=train_pp_cfg(job).n_layers, batch=job["B"],
            seq=TRAIN_PP_S, microbatches=job["M"], steps=job["steps"],
            lr=TRAIN_PP_LR, losses=first["losses"],
            reference_losses=ref["losses"], loss_rel_err=loss_rel,
            gnorm=first["gnorms"], reference_gnorm=ref["gnorms"],
            gnorm_rel_err=gnorm_rel, worst_leaf=worst,
            worst_leaf_rel_l2=leaf.get(worst), leaves=len(leaf),
            stage_per_rank=[p["stage"] for p in per],
            launches_per_step_per_rank=[p["launches_per_step"]
                                        for p in per],
            want_per_step_per_rank=[p["want_per_step"] for p in per],
            k1_launches_rank0=first["k1"], k2_launches_rank0=first["k2"],
            k3_launches_rank0=first["k3"],
            ms_per_step_per_rank=[p["ms_per_step"] for p in per],
            collectives_per_step_rank0=first["collectives_per_step"],
            collectives_rank0=first["collectives"],
            peak_gb_per_rank=[p["peak_gb"] for p in per],
            reference_peak_gb=ref["peak_gb"], seconds_rank0=first["seconds"],
            backend=backend, note=MESH_NOTE[backend])
        say(name, **rows[name])
        check(all(p["losses"] == first["losses"] for p in per),
              f"{name}: the ranks' losses differ: "
              f"{[p['losses'] for p in per]}")
        check(all(p["gnorms"] == first["gnorms"] for p in per),
              f"{name}: the ranks' gradient norms differ")
        check(max(loss_rel) <= TRAIN_MESH_LOSS_RTOL,
              f"{name}: losses {first['losses']} against {ref['losses']}")
        check(max(gnorm_rel) <= TRAIN_MESH_LEAF_RTOL,
              f"{name}: gradient norms {first['gnorms']} against "
              f"{ref['gnorms']}")
        check(covered == whole, f"{name}: leaves not covered by the "
              f"shards: {sorted(set(whole) - set(covered))}")
        check(leaf[worst] <= TRAIN_MESH_LEAF_RTOL,
              f"{name}: leaf {worst} {leaf[worst]} over "
              f"{TRAIN_MESH_LEAF_RTOL}")
        check(all(c == p["want_per_step"] for p in per
                  for c in p["launches_per_step"]),
              f"{name}: launches per step "
              f"{[p['launches_per_step'] for p in per]}, want "
              f"{[p['want_per_step'] for p in per]}")
    g, f = (rows[n]["losses"] for n in ("train_pp_gpipe_mistral_pp4",
                                        "train_pp_1f1b_mistral_pp4"))
    gpipe_rel = max(abs(a - b) / abs(b) for a, b in zip(f, g))
    check(gpipe_rel <= TRAIN_MESH_LOSS_RTOL,
          f"1F1B losses {f} against GPipe's {g}")
    ov = {r: ranks[r][OVERLAP_JOB["name"]] for r in range(MESH_WORLD)}
    rows[OVERLAP_JOB["name"]] = dict(
        ms_per_rank={r: o["ms"] for r, o in ov.items()},
        rel_l2=max(o["rel_l2"] for o in ov.values()), shape=ov[0]["shape"],
        backend=backend, note=MESH_NOTE[backend])
    say(OVERLAP_JOB["name"], **rows[OVERLAP_JOB["name"]])
    rows["seconds"] = time.perf_counter() - ts
    say("train_pp_seconds", seconds=rows["seconds"], ranks_s=t_ranks,
        compare_s=compare_s[0], gpipe_vs_1f1b_loss_rel=gpipe_rel,
        references_s=sum(r["seconds"] for r in refs.values()))
    return rows


# ----------------------------------------------------------------------
# phase 22: the training guard and per-rank checkpoints.  SmolLM2-135M at
# full depth and width, bf16, remat, B=4 x S=2048 (phase 11's shape),
# AdamW, random init from seed 0.

GUARD_STEPS = 6
GUARD_LR = 1e-3
GUARD_BATCH_SEED = 21
# One bit of rank 1's attention query weights, at step 3: the audit at
# step 4 must name rank 1 and repair it from rank 0.  The leaf is named
# as ``jax.tree_util.keystr`` names it.
GUARD_CORRUPT = {"rank": 1, "step": 3, "name": "['layers']['wq']"}
GUARD_JOB = dict(name="train_guard_replicas_smol", guard=True)
# Job 2: an inf scaled into four lm_head weights at step 3 makes every
# later step non-finite until a blown skip budget (2) rolls back to the
# step-2 snapshot.
GUARD_POISON = {"rank": 0, "step": 3, "name": "['lm_head']",
                "mode": "scale", "scale": float("inf"), "count": 4}
GUARD_ROLLBACK_STEPS = 10
CKPT_DIR = ROOT / "build" / "guard_ckpt"


def guard_cfg():
    from nbdistributed_tpu_torch.models import smol_135m_config
    return smol_135m_config(remat=True)


def guard_batches(cfg, n):
    return [packed_batch(cfg, TRAIN_B, cfg.max_seq_len, GUARD_BATCH_SEED + i)
            for i in range(n)]


def guarded_step(cfg, opt):
    """The guarded DDP step (``make_ddp_step(guard=True)``) on a mesh of
    this rank alone."""
    from nbdistributed_tpu_torch.models import loss_fn
    from nbdistributed_tpu_torch.parallel import make_ddp_step, make_mesh
    from nbdistributed_tpu_torch.parallel.collectives import rank

    return make_ddp_step(lambda p, b: loss_fn(p, b, cfg), opt,
                         make_mesh({"dp": 1}, ranks=[rank()]), guard=True)


def state_bytes(params, opt):
    """Every byte of the params and of AdamW's ``mu`` and ``nu`` (uint8
    clones, so equality is bitwise, NaN and inf included) and the step
    counts."""
    import torch
    from nbdistributed_tpu_torch.models import param_leaves

    def raw(t):
        return t.detach().reshape(-1).view(torch.uint8).clone()

    leaves = param_leaves(params)
    st = [opt.state.get(p, {}) for p in leaves]
    return ([raw(p) for p in leaves]
            + [raw(s[k]) for s in st for k in ("mu", "nu") if k in s],
            [s.get("step") for s in st])


def same_state(a, b) -> bool:
    import torch
    return (a[1] == b[1] and len(a[0]) == len(b[0])
            and all(torch.equal(x, y) for x, y in zip(a[0], b[0])))


def guard_run(cfg, batches, corrupt):
    """One guarded run on this rank: the model from seed 0, the guard
    auditing and snapshotting every 2 steps, ``corrupt`` on the process
    fault plan, counts reset just before the steps and read per step."""
    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                                param_leaves)
    from nbdistributed_tpu_torch.resilience import faults
    from nbdistributed_tpu_torch.resilience.trainguard import (
        TrainGuard, leaf_fingerprint, tree_fingerprint)

    params = init_params(cfg, 0)
    opt = AdamW(param_leaves(params), lr=GUARD_LR)
    g = TrainGuard(guarded_step(cfg, opt), params, opt,
                   audit_every=2, snapshot_every=2, skip_budget=10,
                   checkpoint_every=0)
    faults.set_process_plan(None if corrupt is None else
                            faults.FaultPlan(seed=7, corrupt=[corrupt]))
    torch.cuda.synchronize()
    reset_launch_counts()
    losses, secs, per_step = [], [], []
    try:
        for b in batches:
            before = launch_counts()
            t0 = time.perf_counter()
            losses.append(float(g.step(b)))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            after = launch_counts()
            per_step.append({k: after[k] - before[k] for k in after})
        d = g.finish()
    finally:
        faults.set_process_plan(None)
    events = list(g._events)
    mm = [e for e in events if e["kind"] == "mismatch"]
    row = dict(fp=list(tree_fingerprint(params)),
               opt_fp=list(tree_fingerprint(opt)),
               leaf_fps=[leaf_fingerprint(p).tolist()
                         for p in param_leaves(params)],
               audits=[[e["step"], e["verdict"]] for e in events
                       if e["kind"] == "audit"],
               mismatches=d["mismatches"], repairs=d["repairs"],
               skips=d["skips"],
               minority=mm[0]["minority"] if mm else None,
               majority_rank=mm[0]["majority_rank"] if mm else None,
               corrupted=[e.get("leaf") for e in events
                          if e["kind"] == "corrupt"],
               kinds=sorted({e["kind"] for e in events}), losses=losses,
               launches_per_step=per_step,
               ms_per_step=[1e3 * x for x in secs])
    del g, opt, params
    return row


def guard_job(job, counts, send):
    """Job 1 on this rank: the fault-free guarded run, then the same run
    with ``GUARD_CORRUPT`` on the plan."""
    import gc

    import torch
    cfg = guard_cfg()
    batches = guard_batches(cfg, GUARD_STEPS)
    torch.cuda.reset_peak_memory_stats()
    out = {}
    for name, corrupt in (("ref", None), ("faulted", GUARD_CORRUPT)):
        t0 = time.perf_counter()
        out[name] = guard_run(cfg, batches, corrupt)
        out[name]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def phase_guard_replicas(backend="gloo"):
    """Job 1: four ranks, each training SmolLM2 on a mesh of its own
    with the same seed and batches (independent replicas, voting over
    the world).  Held: every fault-free audit ``ok`` on every rank; the
    faulted run's audit at step 4 names minority (1,) and root 0 with
    one repair on every rank; every rank's final params and moments
    bitwise the fault-free run's; K1/K2/K3 60/30/30 a rank a step."""
    ts = time.perf_counter()
    ranks = run_mesh_ranks([GUARD_JOB], backend)
    check(all(r["rebuilt"] == [] for r in ranks.values()),
          f"a guard rank rebuilt kernels: "
          f"{[r['rebuilt'] for r in ranks.values()]}")
    per = [ranks[r][GUARD_JOB["name"]] for r in range(MESH_WORLD)]
    ref, got = per[0]["ref"], per[0]["faulted"]
    want = {"k1": 2 * N_LAYERS_SMOL, "k2": N_LAYERS_SMOL,
            "k3": N_LAYERS_SMOL}
    row = dict(
        steps=GUARD_STEPS, batch=TRAIN_B, seq=guard_cfg().max_seq_len,
        corrupt=GUARD_CORRUPT, audits_ref=[p["ref"]["audits"] for p in per],
        audits_faulted=[p["faulted"]["audits"] for p in per],
        minority=[p["faulted"]["minority"] for p in per],
        majority_rank=[p["faulted"]["majority_rank"] for p in per],
        repairs=[p["faulted"]["repairs"] for p in per],
        skips_faulted=[p["faulted"]["skips"] for p in per],
        corrupted=[p["faulted"]["corrupted"] for p in per],
        fp_ref=ref["fp"], fp_faulted=[p["faulted"]["fp"] for p in per],
        losses_ref=ref["losses"], losses_faulted_rank1=per[1]["faulted"][
            "losses"],
        launches_per_step_rank0=ref["launches_per_step"][0],
        want_per_step=want,
        k1_launches_rank0=sum(c["k1"] for c in ref["launches_per_step"]),
        k2_launches_rank0=sum(c["k2"] for c in ref["launches_per_step"]),
        k3_launches_rank0=sum(c["k3"] for c in ref["launches_per_step"]),
        k1_launches_faulted_rank0=sum(
            c["k1"] for c in got["launches_per_step"]),
        k2_launches_faulted_rank0=sum(
            c["k2"] for c in got["launches_per_step"]),
        k3_launches_faulted_rank0=sum(
            c["k3"] for c in got["launches_per_step"]),
        ms_per_step_per_rank=[p["faulted"]["ms_per_step"] for p in per],
        seconds_per_run_rank0=[ref["seconds"], got["seconds"]],
        peak_gb_per_rank=[p["peak_gb"] for p in per],
        backend=backend, note=MESH_NOTE[backend])
    say("train_guard_replicas", **row)
    differ = {r: [i for i, (a, b) in enumerate(zip(p["ref"]["leaf_fps"],
                                                   ref["leaf_fps"]))
                  if a != b] for r, p in enumerate(per)}
    check(all(not v for v in differ.values()),
          f"the fault-free replicas differ (leaf indices by rank): {differ}")
    for r, p in enumerate(per):
        check([v for _, v in p["ref"]["audits"]] == ["ok", "ok"],
              f"rank {r}: fault-free audits {p['ref']['audits']}")
        f = p["faulted"]
        check(f["audits"][1] == [4, "repair:1"] and f["minority"] == [1]
              and f["majority_rank"] == 0 and f["repairs"] == 1
              and f["mismatches"] == 1,
              f"rank {r}: faulted audits {f['audits']}, minority "
              f"{f['minority']}, root {f['majority_rank']}, repairs "
              f"{f['repairs']}")
        check(f["fp"] == ref["fp"] and f["opt_fp"] == ref["opt_fp"],
              f"rank {r}: final params {f['fp']} / moments {f['opt_fp']} "
              f"against the fault-free {ref['fp']} / {ref['opt_fp']}")
        check(all(c == want for run in ("ref", "faulted")
                  for c in p[run]["launches_per_step"]),
              f"rank {r}: launches per step "
              f"{p['ref']['launches_per_step']} / "
              f"{f['launches_per_step']}, want {want}")
    check(per[1]["faulted"]["corrupted"] == [GUARD_CORRUPT["name"]]
          and all(not per[r]["faulted"]["corrupted"] for r in (0, 2, 3)),
          f"the flip fired on {row['corrupted']}")
    row["seconds"] = time.perf_counter() - ts
    return row


def guard_rollback(cfg):
    """Job 2, this process: ``GUARD_POISON`` makes steps 3-5 non-finite;
    each is skipped with the params, ``mu``, ``nu`` and AdamW's step
    bitwise unchanged on the card, the third blows the skip budget and
    rolls back to the step-2 snapshot bitwise, and steps 6-9 train on
    with finite losses."""
    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                                param_leaves)
    from nbdistributed_tpu_torch.resilience import faults
    from nbdistributed_tpu_torch.resilience.trainguard import TrainGuard

    params = init_params(cfg, 0)
    opt = AdamW(param_leaves(params), lr=GUARD_LR)
    inner = guarded_step(cfg, opt)
    calls, kept = [], {}

    def step(p, b):
        i = len(calls)
        before = state_bytes(params, opt)
        if i in (2, 6):
            kept[i] = before
        c0 = launch_counts()
        loss, aux = inner(p, b)
        ok, lossf, gnorm = aux["v"].tolist()
        c1 = launch_counts()
        calls.append(dict(ok=bool(ok), loss=lossf, gnorm=gnorm,
                          unchanged=same_state(before,
                                               state_bytes(params, opt)),
                          launches={k: c1[k] - c0[k] for k in c1}))
        return loss, aux

    g = TrainGuard(step, params, opt, audit_every=1, snapshot_every=2,
                   skip_budget=2, checkpoint_every=0)
    batch = packed_batch(cfg, TRAIN_B, cfg.max_seq_len, TRAIN_BATCH_SEED)
    faults.set_process_plan(faults.FaultPlan(seed=5, corrupt=[GUARD_POISON]))
    reset_launch_counts()
    try:
        for _ in range(GUARD_ROLLBACK_STEPS):
            g.step(batch)
        d = g.finish()
    finally:
        faults.set_process_plan(None)
    launches = launch_counts()
    kinds = [e["kind"] for e in g._events]
    rolled = same_state(kept[2], kept[6])
    row = dict(steps=GUARD_ROLLBACK_STEPS, poison=GUARD_POISON,
               ok=[c["ok"] for c in calls], losses=[c["loss"] for c in calls],
               skipped_unchanged=[c["unchanged"] for c in calls
                                  if not c["ok"]],
               rollback_bitwise_to_step_2=rolled, skips=d["skips"],
               rollbacks=d["rollbacks"], snapshot_steps=d["snapshot_steps"],
               events=kinds, launches=launches,
               launches_per_step=calls[0]["launches"])
    say("train_guard_rollback", **row)
    want = [True] * 3 + [False] * 3 + [True] * (GUARD_ROLLBACK_STEPS - 6)
    check(row["ok"] == want, f"guarded verdicts {row['ok']}, want {want}")
    check(row["skipped_unchanged"] == [True] * 3,
          f"a skipped step changed the state: {row['skipped_unchanged']}")
    check(d["skips"] == 3 and d["rollbacks"] == 1
          and "snapshot_dropped" in kinds and "rollback" in kinds,
          f"skips {d['skips']}, rollbacks {d['rollbacks']}, events {kinds}")
    check(rolled, "the rollback did not restore the step-2 state bitwise")
    check(all(abs(c["loss"]) < float("inf") for c in calls[6:]),
          f"losses after the rollback {row['losses'][6:]}")
    want_k = {"k1": 2 * N_LAYERS_SMOL, "k2": N_LAYERS_SMOL,
              "k3": N_LAYERS_SMOL}
    check(all(c["launches"] == want_k for c in calls),
          f"launches per step {[c['launches'] for c in calls]}")
    del g, params, opt, inner, kept
    return row


def guard_costs(cfg):
    """Report, not held: ``tree_fingerprint`` of the bf16 params beside
    its bound, a snapshot (a guard's construction takes one), the guarded
    step beside the unguarded one."""
    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                                make_train_step,
                                                param_leaves)
    from nbdistributed_tpu_torch.resilience.trainguard import (
        TrainGuard, tree_fingerprint)

    params = init_params(cfg, 0)
    opt = AdamW(param_leaves(params), lr=GUARD_LR)
    batch = packed_batch(cfg, TRAIN_B, cfg.max_seq_len, TRAIN_BATCH_SEED)
    nbytes = sum(p.numel() * p.element_size() for p in param_leaves(params))

    def wall_ms(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return out

    fp_ms = wall_ms(lambda: tree_fingerprint(params), 5)
    snap_ms = wall_ms(lambda: TrainGuard(
        guarded_step(cfg, opt), params, opt, audit_every=0,
        snapshot_every=1, checkpoint_every=0), 3)
    # The default cadences (50): no snapshot or audit in these steps.
    g = TrainGuard(guarded_step(cfg, opt), params, opt)
    plain = make_train_step(cfg, opt)
    fns = {"unguarded": lambda: float(plain(params, batch)),
           "guarded": lambda: float(g.step(batch))}
    for fn in fns.values():
        fn()
    step_ms = {k: [] for k in fns}
    for name in ("unguarded", "guarded", "guarded", "unguarded"):
        step_ms[name] += wall_ms(fns[name], 3)
    g.finish()
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    row = dict(param_bytes=nbytes, fingerprint_ms=fp_ms,
               fingerprint_ms_median=med(fp_ms),
               fingerprint_bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
               snapshot_ms=snap_ms, snapshot_ms_median=med(snap_ms),
               step_order="unguarded, guarded, guarded, unguarded; 3 "
                          "steps each after one of each",
               step_ms=step_ms,
               unguarded_step_ms_median=med(step_ms["unguarded"]),
               guarded_step_ms_median=med(step_ms["guarded"]))
    say("train_guard_costs", **row)
    del g, params, opt, plain
    return row


def flip_npz_byte(path, key):
    """Flip the last data byte of ``key``'s entry in ``path`` in place
    (``np.savez`` stores entries uncompressed): bit rot on disk."""
    import struct
    import zipfile
    with zipfile.ZipFile(path) as z:
        info = z.getinfo(key + ".npy")
    with open(path, "r+b") as f:
        f.seek(info.header_offset + 26)
        n, m = struct.unpack("<HH", f.read(4))
        pos = info.header_offset + 30 + n + m + info.compress_size - 1
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))


def guard_checkpoint(cfg):
    """Job 3, this process: two steps, ``save_async`` of the params and
    the optimizer, step 3 at once (in place, while the save drains) and
    step 4; the save restored into a fresh tree and optimizer equals the
    state after step 2 bitwise, and steps 3-4 from it give the
    uninterrupted run's losses and fingerprints exactly.  A byte flipped
    in ``arrays.npz`` is refused with its leaf named, nothing written.
    Rows: the save's and restore's GB/s, ``save_async``'s synchronous
    ms."""
    import shutil

    import torch
    from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                                make_train_step,
                                                param_leaves)
    from nbdistributed_tpu_torch.resilience.trainguard import \
        tree_fingerprint
    from nbdistributed_tpu_torch.runtime import checkpoint

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    path, again = str(CKPT_DIR / "async"), str(CKPT_DIR / "sync")
    params = init_params(cfg, 0)
    opt = AdamW(param_leaves(params), lr=GUARD_LR)
    step = make_train_step(cfg, opt)
    batches = guard_batches(cfg, 4)
    reset_launch_counts()
    losses = [float(step(params, b)) for b in batches[:2]]
    state2 = state_bytes(params, opt)
    ns = {"params": params, "opt": opt}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = checkpoint.save_async(path, ns, ["params", "opt"])
    async_ms = 1e3 * (time.perf_counter() - t0)
    losses += [float(step(params, b)) for b in batches[2:]]
    launches = launch_counts()
    fp4 = (tree_fingerprint(params), tree_fingerprint(opt))
    summary = h.wait(600)
    drained_s = time.perf_counter() - t0
    nbytes = sum(v["bytes"] for v in summary.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h2 = checkpoint.save_async(again, ns, ["params", "opt"])
    async2_ms = 1e3 * (time.perf_counter() - t0)
    h2.wait(600)
    t0 = time.perf_counter()
    checkpoint.save(again, ns, ["params", "opt"])
    save_s = time.perf_counter() - t0

    fresh = init_params(cfg, 1)
    fopt = AdamW(param_leaves(fresh), lr=GUARD_LR)
    fns = {"params": fresh, "opt": fopt}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.restore(path, fns)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    in_place = fns["params"] is fresh and fns["opt"] is fopt
    restored = same_state(state_bytes(fresh, fopt), state2)
    fstep = make_train_step(cfg, fopt)
    resumed = [float(fstep(fresh, b)) for b in batches[2:]]
    fp_resumed = (tree_fingerprint(fresh), tree_fingerprint(fopt))

    fp_before = tree_fingerprint(fresh)
    flip_npz_byte(f"{path}/rank_0/arrays.npz", "params.0")
    try:
        checkpoint.restore(path, fns)
        refused = ""
    except ValueError as e:
        refused = str(e)
    untouched = tree_fingerprint(fresh) == fp_before
    problems = checkpoint.verify_rank(path, 0)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    row = dict(losses=losses, resumed_losses=resumed,
               restored_bitwise=restored, restored_in_place=in_place,
               fingerprints=[list(x) for x in fp4],
               resumed_fingerprints=[list(x) for x in fp_resumed],
               checkpoint_bytes=nbytes, save_async_sync_ms=async_ms,
               save_async_sync_ms_second=async2_ms,
               save_async_drained_s=drained_s,
               save_gb_per_s=nbytes / save_s / 1e9, save_s=save_s,
               restore_gb_per_s=nbytes / restore_s / 1e9,
               restore_s=restore_s, refused=refused[:200],
               refusal_left_state=untouched, verify_rank=problems[:2],
               launches=launches)
    say("train_checkpoint", **row)
    check(in_place and restored, f"restore in place {in_place}, bitwise "
          f"the step-2 state {restored}")
    check(resumed == losses[2:] and fp_resumed == fp4,
          f"resumed losses {resumed} / {fp_resumed} against the "
          f"uninterrupted {losses[2:]} / {fp4}")
    check("params.0" in refused and "integrity" in refused and untouched,
          f"the flipped byte: {refused!r}, state left {untouched}")
    check(any("params.0" in p for p in problems), f"verify_rank: {problems}")
    del params, opt, fresh, fopt, step, fstep, state2
    return row


GUARD_WORKER_CELL = """
import chip_smoke as cs
from nbdistributed_tpu_torch.models import AdamW, init_params, param_leaves
from nbdistributed_tpu_torch.ops import _build
from nbdistributed_tpu_torch.resilience import trainguard
rebuilt = _build.build_all()
cfg = cs.guard_cfg()
params = init_params(cfg, 0, device=device)
opt = AdamW(param_leaves(params), lr=cs.GUARD_LR)
g = trainguard.TrainGuard(cs.guarded_step(cfg, opt), params, opt,
                          audit_every=0, snapshot_every=2)
batch = cs.packed_batch(cfg, 1, 512, 3)
cs.reset_launch_counts()
losses = [float(g.step(batch)) for _ in range(2)]
state = {"launched": cs.launch_counts(), "rebuilt": sorted(rebuilt),
         "losses": losses, "device": str(params["embed"].device),
         "fp": list(trainguard.tree_fingerprint(params)),
         "opt_fp": list(trainguard.tree_fingerprint(opt))}
"""


def phase_guard_worker():
    """Job 4: one GPU worker of the port's process manager, driven over
    its control plane: a guarded SmolLM2 run in a cell (CUDA tensors),
    the ``checkpoint`` request (save, a background save polled to done,
    restores written into the live tensors after a further step), the
    ``guard`` request (status, audit, off and on) and the ``tg`` field
    on its pings."""
    from nbdistributed_tpu_torch.manager import (ProcessManager,
                                                 wait_until_ready)
    from nbdistributed_tpu_torch.messaging.coordinator import \
        CommunicationManager

    ts = time.perf_counter()
    path, bg = str(CKPT_DIR / "worker"), str(CKPT_DIR / "worker_bg")
    comm = CommunicationManager(1, timeout=300)
    pm = ProcessManager()
    pm.add_death_callback(lambda rank, rc: comm.mark_worker_dead(rank))
    try:
        pm.start_workers(1, comm.port, backend="gpu")
        wait_until_ready(comm, pm, CLUSTER_READY_S, poll_s=0.5)
        cell(comm, GUARD_WORKER_CELL, timeout=600)
        state = fetch(comm, "state")
        names = {"names": ["params", "opt"]}
        saved = comm.send_to_rank(0, "checkpoint", {
            "action": "save", "path": path, **names}, timeout=300).data
        started = comm.send_to_rank(0, "checkpoint", {
            "action": "save", "path": bg, "background": True, **names},
            timeout=300).data
        polls, t0 = 0, time.perf_counter()
        while True:
            polled = comm.send_to_rank(0, "checkpoint",
                                       {"action": "status"}).data
            polls += 1
            if polled.get("status") != "pending":
                break
            check(time.perf_counter() - t0 < 300, "background save hangs")
            time.sleep(0.05)
        cell(comm, "g.step(batch); moved = list(trainguard.tree_fingerprint("
                   "params)) != state['fp']")
        restored = []
        for where in (path, bg):
            restored.append(comm.send_to_rank(0, "checkpoint", {
                "action": "restore", "path": where}, timeout=300).data)
            cell(comm, "back = [list(trainguard.tree_fingerprint(params)), "
                       "list(trainguard.tree_fingerprint(opt))]")
            restored[-1] = dict(restored[-1], back=fetch(comm, "back"))
        moved = fetch(comm, "moved")
        status = comm.send_to_rank(0, "guard", {"action": "status"}).data
        audit = comm.send_to_rank(0, "guard", {"action": "audit"}).data
        off = comm.send_to_rank(0, "guard", {"action": "off"}).data
        on = comm.send_to_rank(0, "guard", {"action": "on"}).data
        # A ping sent after the audit: its tg names the audit's step.
        t0 = time.perf_counter()
        while True:
            ping = comm.last_ping(0)
            if ping is not None and (ping[1] or {}).get("tg", {}).get(
                    "as") == status.get("step"):
                break
            check(time.perf_counter() - t0 < 60,
                  f"no ping carried the audit's tg: {ping}")
            time.sleep(0.1)
        comm.post([0], "shutdown")
    finally:
        pm.shutdown()
        comm.shutdown()
    want = {"k1": 4 * N_LAYERS_SMOL, "k2": 2 * N_LAYERS_SMOL,
            "k3": 2 * N_LAYERS_SMOL}
    row = dict(launched=state["launched"], want=want,
               rebuilt=state["rebuilt"], device=state["device"],
               losses=state["losses"], saved=saved.get("status"),
               saved_bytes={k: v["bytes"] for k, v in
                            saved.get("summary", {}).items()},
               background=started.get("status"),
               polled=polled.get("status"), polls=polls,
               restored=[r.get("status") for r in restored],
               restored_equal=[r["back"] == [state["fp"], state["opt_fp"]]
                               for r in restored], moved_after_step=moved,
               guard_status={k: status.get(k) for k in
                             ("enabled", "active", "step", "skips",
                              "snapshot_steps")},
               audit={k: audit.get(k) for k in ("status", "ok",
                                                "last_verdict")},
               off=off.get("enabled"), on=on.get("enabled"),
               tg=ping[1]["tg"], seconds=time.perf_counter() - ts)
    say("guard_worker", **row)
    check(state["rebuilt"] == [] and state["device"] == "cuda:0",
          f"worker: rebuilt {state['rebuilt']}, device {state['device']}")
    check(state["launched"] == want, f"worker launches {state['launched']}"
          f", want {want}")
    check(saved.get("status") == "save" and started.get("status")
          == "started" and polled.get("status") == "done",
          f"checkpoint requests: {saved}, {started}, {polled}")
    check(moved and all(r.get("status") == "restore" for r in restored)
          and all(row["restored_equal"]),
          f"restores: moved {moved}, {row['restored']}, "
          f"{row['restored_equal']}")
    check(status.get("active") and status.get("step") == 3
          and audit.get("status") == "audited" and audit.get("ok")
          and off.get("enabled") is False and on.get("enabled") is True,
          f"guard requests: {status}, {audit}, {off}, {on}")
    check(row["tg"].get("v") == "ok" and row["tg"].get("sk") == 0,
          f"ping tg {row['tg']}")
    return row


def phase_guard(backend="gloo"):
    """Phase 22: job 1 on four ranks, then (one card) jobs 2-4 and the
    costs in this process."""
    import torch

    ts = time.perf_counter()
    torch.cuda.empty_cache()
    rows = {"train_guard_replicas": phase_guard_replicas(backend)}
    if backend == "gloo":
        cfg = guard_cfg()
        torch.cuda.reset_peak_memory_stats()
        rows["train_guard_rollback"] = guard_rollback(cfg)
        torch.cuda.empty_cache()
        rows["train_guard_costs"] = guard_costs(cfg)
        torch.cuda.empty_cache()
        rows["train_checkpoint"] = guard_checkpoint(cfg)
        rows["peak_gb_in_process"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
        rows["guard_worker"] = phase_guard_worker()
    rows["seconds"] = time.perf_counter() - ts
    say("guard_seconds", seconds=rows["seconds"],
        replicas_s=rows["train_guard_replicas"]["seconds"])
    return rows


def smol_135m_config_fp32():
    import torch
    from nbdistributed_tpu_torch.models import smol_135m_config
    return smol_135m_config(dtype=torch.float32)


def hf_layout(params, cfg):
    """The port's parameters as a ``transformers`` state dict (Llama or
    Mixtral naming; torch ``nn.Linear`` weights are (out, in), so every
    projection is the transpose) and a config stand-in."""
    from types import SimpleNamespace

    L = params["layers"]
    sd = {"model.embed_tokens.weight": params["embed"],
          "lm_head.weight": params["lm_head"].T,
          "model.norm.weight": params["final_norm"]}
    conf = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
                num_hidden_layers=cfg.n_layers,
                num_attention_heads=cfg.n_heads,
                num_key_value_heads=cfg.n_kv_heads,
                intermediate_size=cfg.d_ff,
                max_position_embeddings=cfg.max_seq_len,
                rope_theta=cfg.rope_theta, rms_norm_eps=cfg.norm_eps,
                sliding_window=cfg.sliding_window)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = L["attn_norm"][i]
        sd[p + "post_attention_layernorm.weight"] = L["mlp_norm"][i]
        for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"),
                             ("wv", "v_proj"), ("wo", "o_proj")):
            sd[p + f"self_attn.{theirs}.weight"] = L[ours][i].T
        if "moe" in L:
            moe = L["moe"]
            sd[p + "block_sparse_moe.gate.weight"] = moe["router"][i].T
            for e in range(cfg.n_experts):
                for ours, theirs in (("w_gate", "w1"), ("w_up", "w3"),
                                     ("w_down", "w2")):
                    sd[p + f"block_sparse_moe.experts.{e}.{theirs}"
                           ".weight"] = moe[ours][i, e].T
        else:
            for ours, theirs in (("w_gate", "gate_proj"),
                                 ("w_up", "up_proj"),
                                 ("w_down", "down_proj")):
                sd[p + f"mlp.{theirs}.weight"] = L[ours][i].T
    if "moe" in L:
        conf.update(num_local_experts=cfg.n_experts,
                    num_experts_per_tok=cfg.top_k,
                    router_aux_loss_coef=cfg.lb_coef)
    return SimpleNamespace(config=SimpleNamespace(**conf),
                           state_dict=lambda: sd)


def _trees_equal(a, b):
    import torch
    if isinstance(a, dict):
        return set(a) == set(b) and all(_trees_equal(a[k], b[k]) for k in a)
    return (a.dtype == b.dtype and a.shape == b.shape
            and bool(torch.equal(a, b)))


def phase_hf(params):
    """HF interop on the card: SmolLM2-135M (``params``, bf16) and
    Mixtral-8x7B at 2 layers laid out as ``transformers`` state dicts,
    converted back by ``params_from_hf`` / ``moe_params_from_hf`` onto
    the GPU; the trees and the bf16 logits must equal the originals bit
    for bit.  ``load_hf_pretrained`` runs on a saved tiny model only
    where ``transformers`` imports."""
    import dataclasses as dc

    import torch
    from nbdistributed_tpu_torch.models import (forward, init_moe_model,
                                                moe_forward,
                                                smol_135m_config)
    from nbdistributed_tpu_torch.models import hf

    ts = time.perf_counter()
    tokens = torch.randint(0, 32000, (1, 256),
                           generator=torch.Generator().manual_seed(8))
    cfg = smol_135m_config()
    conv, ccfg = hf.params_from_hf(hf_layout(params, cfg),
                                   dtype=torch.bfloat16, device="cuda")
    smol_equal = _trees_equal(conv, params)
    check(smol_equal and ccfg == cfg,
          "SmolLM2 HF round trip changed the parameters")
    smol_logits = torch.equal(forward(conv, tokens, ccfg),
                              forward(params, tokens, ccfg))
    check(smol_logits, "SmolLM2 HF round trip: logits differ")
    del conv

    mcfg = mixtral_cfg()
    mparams = init_moe_model(mcfg, 0)
    mconv, mccfg = hf.moe_params_from_hf(hf_layout(mparams, mcfg),
                                         dtype=torch.bfloat16,
                                         device="cuda")
    mix_equal = _trees_equal(mconv, mparams)
    check(mix_equal and mccfg.capacity_factor == mcfg.n_experts /
          mcfg.top_k and dc.replace(
              mccfg, capacity_factor=mcfg.capacity_factor) == mcfg,
          "Mixtral HF round trip changed the parameters")
    a, aux_a = moe_forward(mconv, tokens[:, :64], mccfg)
    b, aux_b = moe_forward(mparams, tokens[:, :64], mccfg)
    mix_logits = bool(torch.equal(a, b) and torch.equal(aux_a, aux_b))
    check(mix_logits, "Mixtral HF round trip: logits differ")
    del mparams, mconv, a, b
    torch.cuda.empty_cache()

    try:
        import transformers  # noqa: F401  (not installed on every card)
        loaded = "ran"
    except ImportError:
        loaded = "skipped: transformers does not import here"
    if loaded == "ran":
        loaded = _hf_load_pretrained_tiny()
    row = dict(smol_params_equal=smol_equal, smol_logits_equal=smol_logits,
               mixtral_params_equal=mix_equal,
               mixtral_logits_equal=mix_logits,
               load_hf_pretrained=loaded,
               seconds=time.perf_counter() - ts)
    say("hf_interop", **row)
    return row


def _hf_load_pretrained_tiny():
    """``load_hf_pretrained`` on a tiny random Llama saved to a
    temporary directory, against converting the model in memory."""
    import tempfile

    import torch
    from nbdistributed_tpu_torch.models import hf
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=160,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        tie_word_embeddings=True)).eval()
    OUT_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as d:
        model.save_pretrained(d)
        got, _ = hf.load_hf_pretrained(d, dtype=torch.float32,
                                       device="cuda")
    want, _ = hf.params_from_hf(model, dtype=torch.float32, device="cuda")
    check(_trees_equal(got, want), "load_hf_pretrained: parameters differ")
    return "ran"


# ----------------------------------------------------------------------
# phase 16: timing

def sdpa(q, k, v, **kw):
    import torch.nn.functional as F
    try:
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
    except TypeError:                    # torch without enable_gqa
        rep = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1), **kw)


def time_k1(q, k, v, iters=30):
    """K1 (causal, scale 1/sqrt(D)) through the launcher its wrapper
    calls, beside its plain version and ``scaled_dot_product_attention``."""
    from nbdistributed_tpu_torch.ops import attention as A

    B, S, H, D = q.shape
    Hkv = k.shape[2]
    scale = 1.0 / D ** 0.5
    args = dict(causal=True, scale=scale, offsets=(0, 0), window=None,
                segment_ids=None, kv_segment_ids=None)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = cuda_ms(lambda: A._flash_forward_cuda(q, k, v, **args), iters)
    plain = cuda_ms(lambda: A._flash_forward_plain(q, k, v, **args), iters)
    lib = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True, scale=scale),
                  iters)
    pairs = B * H * S * (S + 1) // 2               # causal (q, k) pairs
    flops = 4 * pairs * D
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * Hkv * D) + 4 * B * H * S
    t_f, t_b = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=1e3 * max(t_f, t_b),
                bound_by="operations" if t_f >= t_b else "bytes",
                flops=flops, bytes=nbytes, causal_pairs=pairs,
                shape=dict(B=B, S=S, H=H, Hkv=Hkv, D=D))


def phase_timing():
    import torch

    rows = {}
    # Each kernel is timed through the launcher its wrapper calls, so
    # the wrapper's argument checks stay out of the kernel's time.
    # K1 at the forward's shape: B=1, S=512, H=9, Hkv=3, D=64, causal.
    rows["K1"] = time_k1(*k1_inputs(1, 512, 9, 3, 64, torch.bfloat16,
                                    seed=1))

    # K4 at the serving shape: B=8 slots, T=max_len=1024, positions as
    # the 16..232-token streams give them; and at the serving path's
    # full context: T=2048 (SmolLM2's max_seq_len), every slot at 2047.
    rows["K4"] = time_k4(serving_pos(8), 1024)
    rows["K4_full_context"] = time_k4(
        torch.full((8,), 2047, dtype=torch.int32, device="cuda"), 2048)
    # Mixtral's attention: K1 at S=2048 (the MoE train batch's length),
    # K4 at the MoE server's shape (8 slots, T=1024, Hkv=8, group 4).
    rows["K1_mixtral"] = time_k1(*k1_inputs(1, 2048, 32, 8, 128,
                                            torch.bfloat16, seed=4))
    rows["K4_mixtral"] = time_k4(serving_pos(8), 1024, Hkv=8, group=4,
                                 D=128)
    # K4 at the mesh phase's sp shard shape: a SmolLM2 dp x sp rank's 4
    # rows against its T/2 = 128-token slice, positions as the sp index
    # 0 rank sees them (its slice holds the first 128 of each row's).
    rows["K4_sp_shard"] = time_k4(serving_pos(4), MESH_MAX_LEN // 2, B=4)
    rows.update(time_train_shape())
    for name, row in rows.items():
        say("timing", kernel=name, **row)
    return rows


def time_k4(pos, T, B=8, Hkv=3, group=3, D=64):
    """K4 (bf16, no window) through the launcher its wrapper calls,
    beside its plain version and a masked ``scaled_dot_product_attention``,
    with one cache per layer so each launch finds its cache cold in L2,
    as a decode step does.  Each is timed on the device by CUDA-graph
    replay: a K4 call takes less device time than the host takes to
    issue it, so back-to-back launches time the host (``ms_eager``)."""
    import torch
    from nbdistributed_tpu_torch.ops import decode as K

    q, _, _, _, _, _ = k4_inputs(B, Hkv, group, D, 16, "bf16", seed=2)
    caches = [torch.randn(2, B, Hkv, T, D, device="cuda").to(torch.bfloat16)
              for _ in range(N_LAYERS_SMOL)]
    it = iter(range(10 ** 9))

    def kern():
        c = caches[next(it) % N_LAYERS_SMOL]
        return K._decode_cuda(q, c[0], c[1], pos, scale=0.125, window=None,
                              k_s=None, v_s=None, return_lse=False)[0]

    # What is timed is what phase 3 checked: hold one timed call's
    # output against the plain version too.
    ref, _ = K.decode_reference(q, caches[0][0], caches[0][1], pos,
                                scale=0.125)
    got = kern()
    err = max_err(got, ref)
    ratio = tol_ratio(got, ref, *K4_TOL["bfloat16"])
    check(ratio <= 1, f"K4 at the timing shape T={T}: tolerance ratio "
          f"{ratio}")

    def plain_fn():
        c = caches[next(it) % N_LAYERS_SMOL]
        K.decode_reference(q, c[0], c[1], pos, scale=0.125)

    valid = torch.arange(T, device="cuda")[None, :] <= pos.long()[:, None]
    mask = valid[:, None, None, :]                       # (B, 1, 1, T)
    q4 = q[:, :, None, :]                                # (B, H, 1, D)

    def lib_fn():
        c = caches[next(it) % N_LAYERS_SMOL]
        sdpa(q4, c[0], c[1], attn_mask=mask, scale=0.125)

    ms, plain, lib = graph_ms(kern), graph_ms(plain_fn), graph_ms(lib_fn)
    ms_eager = cuda_ms(kern, 90)
    n_valid = int(torch.clamp(pos.long() + 1, min=0, max=T).sum())
    nbytes = 2 * (2 * n_valid * Hkv * D + 2 * B * Hkv * group * D) + 4 * B
    flops = 4 * n_valid * Hkv * group * D
    t_f, t_b = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=1e3 * max(t_f, t_b),
                bound_by="operations" if t_f >= t_b else "bytes",
                ms_eager=ms_eager, max_abs_err=err, flops=flops, bytes=nbytes,
                valid_tokens=n_valid,
                nsplit_chunk=K._decode_splits(B * Hkv, T),
                shape=dict(B=B, Hkv=Hkv, group=group, D=D, T=T))


def time_train_shape():
    """K1, K2 and K3 at the train shape (B=4, S=2048, H=9, Hkv=3, D=64,
    bf16, causal; the kernels mask segments inside their tiles and skip
    none, so the batch's segments do not change their time), each
    through the launcher its wrapper calls.  K1 as in ``time_k1``; K2
    and K3 beside the plain backward (one call computes dq, dk and dv)
    and one library yardstick for the pair: the backward of
    ``scaled_dot_product_attention(..., enable_gqa=True)`` on the same
    inputs, timed as ``torch.autograd.grad`` on a retained graph."""
    import torch
    from nbdistributed_tpu_torch.ops import attention as A

    B, S, H, Hkv, D = TRAIN_B, 2048, 9, 3, 64
    q, k, v = k1_inputs(B, S, H, Hkv, D, torch.bfloat16, seed=21)
    g = torch.randn(B, S, H, D, device="cuda").to(torch.bfloat16)
    args = dict(causal=True, scale=0.125, offsets=(0, 0), window=None,
                segment_ids=None, kv_segment_ids=None)
    # What is timed is what phases 2 and 4 checked: hold K1's (out, lse)
    # to the plain forward before K2/K3 use them, then K2/K3 to the
    # plain backward.
    out, lse = A._flash_forward_cuda(q, k, v, **args)
    k1_err = check_k1("timing_train_shape", out, lse,
                      *A._flash_forward_plain(q, k, v, **args),
                      torch.bfloat16)
    delta = A._flash_bwd_prep(out, g)
    dq_ms = cuda_ms(lambda: A.flash_attention_bwd_dq(q, k, v, g, lse, delta,
                                                     **args), 20)
    dkv_ms = cuda_ms(lambda: A.flash_attention_bwd_dkv(q, k, v, g, lse,
                                                       delta, **args), 20)
    want = A._flash_backward_plain(q, k, v, out, lse, g, **args)
    got = (A.flash_attention_bwd_dq(q, k, v, g, lse, delta, **args),
           *A.flash_attention_bwd_dkv(q, k, v, g, lse, delta, **args))
    row = check_k23("timing_train_shape", got, want, torch.bfloat16)
    errs = {"K2": row["dq"]["max_abs_err"],
            "K3": max(row["dk"]["max_abs_err"], row["dv"]["max_abs_err"])}
    del want, got
    rows = {"K1_train": dict(time_k1(q, k, v, 20), max_abs_err=k1_err)}
    plain = cuda_ms(lambda: A._flash_backward_plain(q, k, v, out, lse, g,
                                                    **args), 5, 1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    o = sdpa(qt, kt, vt, is_causal=True, scale=0.125)
    go = g.transpose(1, 2)
    lib = cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), go,
                                              retain_graph=True), 20)

    pairs = B * H * S * (S + 1) // 2               # causal (q, k) pairs
    io_q = 2 * B * S * H * D                       # one bf16 (B, S, H, D)
    io_k = 2 * B * S * Hkv * D
    io_rows = 2 * 4 * B * H * S                    # lse + delta, fp32
    for name, ms, products, nbytes in (
            ("K2", dq_ms, 3, 3 * io_q + 2 * io_k + io_rows),
            ("K3", dkv_ms, 4, 2 * io_q + 4 * io_k + io_rows)):
        flops = products * 2 * D * pairs
        t_f, t_b = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        rows[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                          max_abs_err=errs[name],
                          library="sdpa backward (K2+K3 pair)",
                          bound_ms=1e3 * max(t_f, t_b),
                          bound_by="operations" if t_f >= t_b else "bytes",
                          flops=flops, bytes=nbytes, causal_pairs=pairs,
                          shape=dict(B=B, S=S, H=H, Hkv=Hkv, D=D))
    return rows


# ----------------------------------------------------------------------

# The kernel functions of each source, as ptxas names them.
KERNEL_FUNCTIONS = ("flash_fwd_wgmma_kernel", "flash_fwd_kernel",
                    "flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_kernel",
                    "flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_kernel",
                    "decode_split_kernel", "decode_combine_kernel")


def ptxas_report(log):
    """Registers, spills and static shared memory of every instantiation
    of ``KERNEL_FUNCTIONS``, from nvcc's ``-Xptxas -v`` output, keyed by
    the kernel's name and its mangled template arguments, as
    ``flash_fwd_wgmma_kernel<Li64E>`` (D = 64) or
    ``decode_split_kernel<13__nv_bfloat16aLi64E>`` (bf16 query, int8
    cache)."""
    import re
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            mangled = m.group(1)
            name = next((n for n in KERNEL_FUNCTIONS
                         if re.search(rf"\d{n}I", mangled)), None)
            # ...<len><name>I<template arguments>Ev<parameters>: every
            # kernel is a template returning void.
            args = (re.search(rf"\d{name}I(\w*?)Ev", mangled)
                    if name else None)
            cur = f"{name}<{args[1]}>" if args else None
            if cur:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[cur].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m[1])
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            out[cur]["static_smem_bytes"] = int(m[1])
    return out


def gpu_name_and_power():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main_mesh_nccl() -> int:
    """``--mesh-nccl``: phases 18, 19, 20 and 21's ranks, and phase 22's
    guarded replicas, alone on four cards, one NCCL rank each, against
    the references they compute first on card 0."""
    import torch
    from nbdistributed_tpu_torch.models import init_moe_model, init_params
    from nbdistributed_tpu_torch.ops import _build

    check(torch.cuda.device_count() >= MESH_WORLD,
          f"--mesh-nccl needs {MESH_WORLD} GPUs, found "
          f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60,
                           check=True).stdout.strip().splitlines()
    say("cards", cards=cards)
    smol = smol_135m_config_fp32()
    prompts = make_requests(smol)
    solo = solo_outputs(init_params(smol, 0), smol, prompts)
    mix = mixtral_cfg(dtype=torch.float32, capacity_factor=MOE_LOSSLESS)
    msolo = solo_outputs(init_moe_model(mix, 0), mix,
                         make_requests(mix)[:8])
    mesh = phase_mesh(prompts, solo, msolo, backend="nccl")
    train_mesh = phase_train_mesh(backend="nccl")
    train_sp = phase_train_sp(backend="nccl")
    train_pp = phase_train_pp(backend="nccl")
    guard = phase_guard(backend="nccl")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_mesh_nccl.json").write_text(json.dumps(
        {"cards": cards, "mesh": mesh, "train_mesh": train_mesh,
         "train_sp": train_sp, "train_pp": train_pp, "guard": guard},
        indent=1))
    print(cards[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:] == ["--mesh-nccl"]:
        return main_mesh_nccl()
    from nbdistributed_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    spent = _build.build_all()
    ptxas = {n: ptxas_report(_build.build_log(n)) for n in _build.KERNELS}
    card = gpu_name_and_power()
    say("build", seconds=time.perf_counter() - t0, per_kernel_s=spent,
        card=card, torch=torch.__version__, cuda=torch.version.cuda,
        ptxas=ptxas)

    k1_err = phase_k1()
    k4_err = phase_k4()
    k23_err = phase_k23()
    counts, prompts, params, dense = phase_main_path()
    profile_row = phase_profile(params)
    cluster = phase_cluster(prompts, dense)
    hf_row = phase_hf(params)
    params32, solo32 = phase_fp32(prompts)
    beyond, seconds = serving_beyond_dense(params, prompts, dense, params32,
                                           solo32)
    del params, params32
    torch.cuda.empty_cache()
    train, train_profile = phase_train()
    torch.cuda.empty_cache()
    train_fp32 = phase_train_fp32_vs_plain()
    torch.cuda.empty_cache()
    lora_losses = phase_lora()
    torch.cuda.empty_cache()
    moe = phase_moe()
    torch.cuda.empty_cache()
    mesh = phase_mesh(prompts, solo32, moe["fp32"]["solo"])
    train_mesh = phase_train_mesh()
    hop_err = phase_hop_kernels()
    train_sp = phase_train_sp()
    remat_dots = phase_remat_dots()
    train_pp = phase_train_pp()
    guard = phase_guard()
    timing = phase_timing()

    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def kernel(name, source, replaces, launches, err, key, design,
               functions, **extra):
        lib = source.removesuffix(".cu")
        return dict(name=name, route="cuda",
                    source=f"nbdistributed_tpu_torch/ops/csrc/{source}",
                    replaces=replaces, launches=launches, max_abs_err=err,
                    **{k: timing[key][k] for k in timed}, design=design,
                    ptxas={f: r for f, r in ptxas[lib].items()
                           if f.split("<")[0] in functions}, **extra)

    # K1 runs on the serving, training and MoE paths: its launches are
    # the runs' sum, its times the serving shape's, with the train
    # shape's and Mixtral's beside them.
    # K4's launches are every serving path's sum, its times the serving
    # shape's, with full context's beside them.  Each error is the worst
    # bf16 one of every check of the kernel.
    k4_paths = {"serve": counts["k4"],
                "cluster_serve": cluster["serve"]["k4_launches"],
                **{name: row["k4"] for name, row in beyond.items()},
                "serve_moe": moe["serve"]["k4_launches"]
                + moe["fp32"]["k4_serve"],
                "serve_moe_paged": moe["serve"]["k4_paged"],
                "serve_moe_speculative": moe["fp32"]["k4_speculative"],
                "serve_moe_int8": moe["serve"]["k4_int8"]
                + moe["fp32"]["k4_int8"],
                **{name: row["k4_launches_rank0"]
                   for name, row in mesh.items() if name != "seconds"}}
    k1_paths = {"serve": counts["k1"],
                "cluster_serve": cluster["serve"]["k1_launches"],
                "train": train["k1"],
                "moe_forward": moe["modes"]["k1_launches"],
                "train_moe": moe["train"]["k1"]}
    k2_paths = {"train": train["k2"], "train_moe": moe["train"]["k2"]}
    k3_paths = {"train": train["k3"], "train_moe": moe["train"]["k3"]}
    for k, paths in (("k1", k1_paths), ("k2", k2_paths), ("k3", k3_paths)):
        paths["train_remat_dots"] = remat_dots["dots"]["launches"][k]
    for name, row in {**train_mesh, **train_sp, **train_pp}.items():
        if name != "seconds" and not name.startswith("overlap"):
            k1_paths[name] = row["k1_launches_rank0"]
            k2_paths[name] = row["k2_launches_rank0"]
            k3_paths[name] = row["k3_launches_rank0"]
    # Phase 22: the guarded replicas' two runs (rank 0), the rollback
    # run, the checkpoint run and the worker's guarded steps.
    rep_row = guard["train_guard_replicas"]
    for k, paths in (("k1", k1_paths), ("k2", k2_paths), ("k3", k3_paths)):
        paths["train_guard_replicas"] = rep_row[f"{k}_launches_rank0"]
        paths["train_guard_replicas_faulted"] = \
            rep_row[f"{k}_launches_faulted_rank0"]
        paths["train_guard_rollback"] = \
            guard["train_guard_rollback"]["launches"][k]
        paths["train_checkpoint"] = guard["train_checkpoint"]["launches"][k]
        paths["cluster_guard"] = guard["guard_worker"]["launched"][k]
    tensor_cores = "wgmma bf16 / scalar fp32"
    split = "bf16 hi + lo operand"
    kernels = [
        kernel("flash_attention_fwd", "flash_attention.cu",
               "nbdistributed_tpu/ops/attention.py:405",
               sum(k1_paths.values()),
               max(k1_err, k23_err["k1"], hop_err["k1"],
                   timing["K1_train"]["max_abs_err"]),
               "K1", tensor_cores,
               ("flash_fwd_wgmma_kernel", "flash_fwd_kernel"),
               launches_by_path=k1_paths,
               train_shape={k: timing["K1_train"][k] for k in timed},
               mixtral_shape={k: timing["K1_mixtral"][k] for k in timed}),
        kernel("flash_attention_bwd_dq", "flash_attention_bwd.cu",
               "nbdistributed_tpu/ops/attention.py:688",
               sum(k2_paths.values()),
               max(k23_err["dq"], hop_err["dq"], timing["K2"]["max_abs_err"]),
               "K2",
               f"{tensor_cores} (dS as a {split})",
               ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_kernel"),
               launches_by_path=k2_paths),
        kernel("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
               "nbdistributed_tpu/ops/attention.py:747",
               sum(k3_paths.values()),
               max(k23_err["dkv"], hop_err["dkv"],
                   timing["K3"]["max_abs_err"]), "K3",
               f"{tensor_cores} (P and dS each as a {split})",
               ("flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_kernel"),
               launches_by_path=k3_paths),
        kernel("flash_decode", "flash_decode.cu",
               "nbdistributed_tpu/ops/decode.py:214", sum(k4_paths.values()),
               max(k4_err, timing["K4"]["max_abs_err"],
                   timing["K4_full_context"]["max_abs_err"],
                   timing["K4_mixtral"]["max_abs_err"],
                   timing["K4_sp_shard"]["max_abs_err"]),
               "K4", "split-T flash-decoding: (B*Hkv, nsplit) blocks, "
               "cp.async ring, warp-level dot products, lse combine kernel",
               ("decode_split_kernel", "decode_combine_kernel"),
               launches_by_path=k4_paths,
               full_context={k: timing["K4_full_context"][k]
                             for k in timed},
               mixtral_shape={k: timing["K4_mixtral"][k] for k in timed},
               sp_shard_shape={k: timing["K4_sp_shard"][k] for k in timed}),
    ]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels, "timing": timing,
         "counts": counts, "profile": profile_row, "train": train,
         "train_profile": train_profile, "train_fp32_vs_plain": train_fp32,
         "lora_losses": lora_losses, "ptxas": ptxas,
         "serving_beyond_dense": beyond,
         "serving_beyond_dense_seconds": seconds, "moe": moe,
         "cluster": cluster, "hf": hf_row, "mesh": mesh,
         "train_mesh": train_mesh, "hop_kernels": hop_err,
         "train_sp": train_sp, "remat_dots": remat_dots,
         "train_pp": train_pp, "guard": guard},
        indent=1))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
