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
   and the Mixtral server's shape (Hkv=8, group 4, D=128, T=1024) in
   bf16, int8 and fp32;
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
   context and at the Mixtral server's shape), beside its plain
   version, one PyTorch library call and the card's bound; K4 and its
   yardsticks on the device by CUDA-graph replay (a K4 call is shorter
   than the host's launch of it).

Phases 7-10 and 13-14 run each server with the launch counts reset
just before and K4's read just after, held to one per layer per decode
step (per round: the draft's launches), and their K4 launches join
phase 5's in the kernels line (``launches_by_path``), as the MoE
forward's and MoE training's K1/K2/K3 launches join the SmolLM2
paths'.

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
    T=1024) in bf16, int8 and fp32.  Returns the worst bf16 output
    error."""
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
              "fp32", "serving", None)]
    worst = 0.0
    for name, B, Hkv, group, D, T, window, cache, kind, qdt in cases:
        pos = {None: None, "past": past_valid_pos(B, T),
               "serving": serving_pos(B), "garbage": serving_pos(B),
               "full": torch.full((B,), T - 1, dtype=torch.int32,
                                  device="cuda")}[kind]
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
        empty = lo >= torch.clamp(valid, max=T)
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
        check((n_empty > 0) == (kind == "past"),
              f"K4 {name}: {n_empty} rows attend nothing")
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
                k4_int8=k4_int8)


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
    n_valid = int(torch.clamp(pos.long() + 1, max=T).sum())
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
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
                **{name: row["k4"] for name, row in beyond.items()},
                "serve_moe": moe["serve"]["k4_launches"]
                + moe["fp32"]["k4_serve"],
                "serve_moe_paged": moe["serve"]["k4_paged"],
                "serve_moe_speculative": moe["fp32"]["k4_speculative"],
                "serve_moe_int8": moe["serve"]["k4_int8"]
                + moe["fp32"]["k4_int8"]}
    k1_paths = {"serve": counts["k1"], "train": train["k1"],
                "moe_forward": moe["modes"]["k1_launches"],
                "train_moe": moe["train"]["k1"]}
    k2_paths = {"train": train["k2"], "train_moe": moe["train"]["k2"]}
    k3_paths = {"train": train["k3"], "train_moe": moe["train"]["k3"]}
    tensor_cores = "wgmma bf16 / scalar fp32"
    split = "bf16 hi + lo operand"
    kernels = [
        kernel("flash_attention_fwd", "flash_attention.cu",
               "nbdistributed_tpu/ops/attention.py:405",
               sum(k1_paths.values()),
               max(k1_err, k23_err["k1"], timing["K1_train"]["max_abs_err"]),
               "K1", tensor_cores,
               ("flash_fwd_wgmma_kernel", "flash_fwd_kernel"),
               launches_by_path=k1_paths,
               train_shape={k: timing["K1_train"][k] for k in timed},
               mixtral_shape={k: timing["K1_mixtral"][k] for k in timed}),
        kernel("flash_attention_bwd_dq", "flash_attention_bwd.cu",
               "nbdistributed_tpu/ops/attention.py:688",
               sum(k2_paths.values()),
               max(k23_err["dq"], timing["K2"]["max_abs_err"]), "K2",
               f"{tensor_cores} (dS as a {split})",
               ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_kernel"),
               launches_by_path=k2_paths),
        kernel("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
               "nbdistributed_tpu/ops/attention.py:747",
               sum(k3_paths.values()),
               max(k23_err["dkv"], timing["K3"]["max_abs_err"]), "K3",
               f"{tensor_cores} (P and dS each as a {split})",
               ("flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_kernel"),
               launches_by_path=k3_paths),
        kernel("flash_decode", "flash_decode.cu",
               "nbdistributed_tpu/ops/decode.py:214", sum(k4_paths.values()),
               max(k4_err, timing["K4"]["max_abs_err"],
                   timing["K4_full_context"]["max_abs_err"],
                   timing["K4_mixtral"]["max_abs_err"]),
               "K4", "split-T flash-decoding: (B*Hkv, nsplit) blocks, "
               "cp.async ring, warp-level dot products, lse combine kernel",
               ("decode_split_kernel", "decode_combine_kernel"),
               launches_by_path=k4_paths,
               full_context={k: timing["K4_full_context"][k]
                             for k in timed},
               mixtral_shape={k: timing["K4_mixtral"][k] for k in timed}),
    ]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels, "timing": timing,
         "counts": counts, "profile": profile_row, "train": train,
         "train_profile": train_profile, "train_fp32_vs_plain": train_fp32,
         "lora_losses": lora_losses, "ptxas": ptxas,
         "serving_beyond_dense": beyond,
         "serving_beyond_dense_seconds": seconds, "moe": moe},
        indent=1))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
