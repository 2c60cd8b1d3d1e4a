#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``nbdistributed_tpu_torch``) on one
NVIDIA GPU: builds the hand-written CUDA kernels from the checkout,
holds each against its plain PyTorch version, drives the serving slice
at the full width of SmolLM2-135M, and times each kernel.

    python3 chip_smoke.py

Phases (each prints one or more lines; any failure exits non-zero):

1. build the kernels (one ``nvcc`` per source, in parallel); the card's
   name and power limit;
2. K1, the flash-attention forward, called through its wrappers,
   against its plain version in bf16 (and one fp32 case) at the
   slice's shapes;
3. K4, flash-decode, called through its wrapper, against its plain
   version in bf16: per-row positions over [0, T-1], a window, an int8
   cache, the lse, and the serving path's own shape and positions;
4. the main path, with every launch count set to 0 just before and
   read just after: full-width ``forward`` (bf16, B=1, S=512) and a
   bf16 ``DecodeServer`` answering 12 staggered requests; K1 must have
   launched once per layer, K4 once per layer per decode step.  The
   kernel-path logits are then held against the plain path's, and the
   same requests are served in fp32 and held against solo ``generate``;
5. a profile of bf16 decode steps: device time per step against the
   host's wall time, and the kernels that take it;
6. timing of each kernel at the main path's shapes, beside its plain
   version, one PyTorch library call and the card's bound.

Then one JSON line listing the kernels, and as the last line
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


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def tol_ratio(got, want, atol, rtol):
    """Worst |got - want| / (atol + rtol * |want|) over the elements:
    within tolerance when it is at most 1 (``torch.allclose``'s test)."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


# Both sides of a kernel check compute in fp32 from the same inputs and
# round once to the output dtype, so a bf16 element may differ by one
# bf16 ulp (at most 2^-7 = 7.8e-3 of its magnitude) where the two fp32
# results straddle a rounding boundary, and by almost nothing else.
# K1 sums its keys in another order than the plain version (tile by
# tile, rescaled), so it gets a little more room than K4; the lse is
# fp32 on both sides.  Measured errors are in PERF.md beside each limit.
K1_TOL = {"bfloat16": (4e-3, 1e-2), "float32": (1e-5, 1e-5)}
K4_TOL = (1e-3, 8e-3)
LSE_TOL = 1e-4


# ----------------------------------------------------------------------
# phase 2: K1 against its plain version

def k1_inputs(B, S, H, Hkv, D, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(dtype)
    return q, k, v


def phase_k1():
    """K1 through the wrappers the path calls — ``flash_attention`` for
    the output, ``_flash_forward`` (the JAX counterpart's entry, which
    returns the lse) — against ``_flash_forward_plain``."""
    import torch
    from nbdistributed_tpu_torch.ops import attention as A

    cases = [("causal_S1024", 2, 1024, torch.bfloat16, None, False),
             ("causal_ragged_S1000", 2, 1000, torch.bfloat16, None, False),
             ("window256_S1024", 2, 1024, torch.bfloat16, 256, False),
             ("segments_S1024", 2, 1024, torch.bfloat16, None, True),
             ("forward_shape_S512", 1, 512, torch.bfloat16, None, False),
             ("fp32_ragged_S1000", 2, 1000, torch.float32, None, False)]
    worst = 0.0
    for name, B, S, dtype, window, segs in cases:
        q, k, v = k1_inputs(B, S, 9, 3, 64, dtype, seed=len(name))
        seg = None
        if segs:
            cuts = torch.tensor([0, 300, 301, 700, S])
            seg = torch.bucketize(torch.arange(S), cuts[1:-1], right=True)
            seg = seg[None].expand(B, S).to("cuda", torch.int32)
            seg = seg.contiguous()
        out = A.flash_attention(q, k, v, causal=True, scale=0.125,
                                window=window, segment_ids=seg)
        out2, lse = A._flash_forward(q, k, v, causal=True, scale=0.125,
                                     window=window, segment_ids=seg)
        torch.cuda.synchronize()
        ref, ref_lse = A._flash_forward_plain(
            q, k, v, causal=True, scale=0.125, window=window,
            segment_ids=seg, kv_segment_ids=seg)
        atol, rtol = K1_TOL[str(dtype).split(".")[-1]]
        e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
        ratio = tol_ratio(out, ref, atol, rtol)
        say("k1_vs_plain", case=name, max_abs_err=e_out, tol_ratio=ratio,
            atol=atol, rtol=rtol, lse_err=e_lse, lse_tol=LSE_TOL)
        check(torch.isfinite(out.float()).all().item(), f"K1 {name}: "
              f"non-finite output")
        check(torch.equal(out, out2), f"K1 {name}: flash_attention and "
              f"_flash_forward disagree")
        check(ratio <= 1 and e_lse <= LSE_TOL,
              f"K1 {name}: error {e_out} (ratio {ratio}) / lse {e_lse} "
              f"over tolerance")
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


def k4_inputs(B, Hkv, group, D, T, int8, seed, pos=None):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Hkv * group, D, generator=g,
                    device="cuda").to(torch.bfloat16)
    if int8:
        kc = torch.randint(-127, 128, (B, Hkv, T, D), generator=g,
                           device="cuda").to(torch.int8)
        vc = torch.randint(-127, 128, (B, Hkv, T, D), generator=g,
                           device="cuda").to(torch.int8)
        ks = torch.rand(B, Hkv, T, 1, generator=g, device="cuda") * 0.02
        vs = torch.rand(B, Hkv, T, 1, generator=g, device="cuda") * 0.02
    else:
        kc = torch.randn(B, Hkv, T, D, generator=g,
                         device="cuda").to(torch.bfloat16)
        vc = torch.randn(B, Hkv, T, D, generator=g,
                         device="cuda").to(torch.bfloat16)
        ks = vs = None
    if pos is None:
        pos = torch.linspace(0, T - 1, B).round().to("cuda", torch.int32)
    return q, kc, vc, ks, vs, pos


def phase_k4():
    """K4 through ``flash_decode_attention``, the wrapper the path
    calls, against ``decode_reference``: per-row positions over
    [0, T-1] at T=2048 with a window and int8 variants, and the main
    path's own shape (B=8 slots, T=max_len=1024, serving positions)."""
    import torch
    from nbdistributed_tpu_torch.ops import decode as K

    worst = 0.0
    atol, rtol = K4_TOL
    cases = [("pos_spread", 2048, None, False, None),
             ("window256", 2048, 256, False, None),
             ("int8_scales", 2048, None, True, None),
             ("int8_window256", 2048, 256, True, None),
             ("serving_shape_T1024", 1024, None, False, serving_pos(8))]
    for name, T, window, int8, pos in cases:
        q, kc, vc, ks, vs, pos = k4_inputs(8, 3, 3, 64, T, int8,
                                           seed=len(name), pos=pos)
        out, lse = K.flash_decode_attention(q, kc, vc, pos, scale=0.125,
                                            window=window, k_s=ks, v_s=vs,
                                            return_lse=True)
        out_nolse = K.flash_decode_attention(q, kc, vc, pos, scale=0.125,
                                             window=window, k_s=ks, v_s=vs)
        torch.cuda.synchronize()
        ref, ref_lse = K.decode_reference(q, kc, vc, pos, scale=0.125,
                                          window=window, k_s=ks, v_s=vs)
        e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
        ratio = tol_ratio(out, ref, atol, rtol)
        same = torch.equal(out, out_nolse)
        say("k4_vs_plain", case=name, max_abs_err=e_out, tol_ratio=ratio,
            atol=atol, rtol=rtol, lse_err=e_lse, lse_tol=LSE_TOL,
            lse_off_identical=same)
        check(torch.isfinite(out.float()).all().item(), f"K4 {name}: "
              f"non-finite output")
        check(ratio <= 1 and e_lse <= LSE_TOL and same,
              f"K4 {name}: error {e_out} (ratio {ratio}) / lse {e_lse} "
              f"over tolerance")
        worst = max(worst, e_out)
    return worst


# ----------------------------------------------------------------------
# phase 4: the main path

def make_requests(cfg, n=12, seed=11):
    import torch
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(16, 201, (n,), generator=g).tolist()
    return [torch.randint(0, cfg.vocab_size, (L,), generator=g).tolist()
            for L in lens]


def serve(params, cfg, prompts, max_new=32):
    """Serve ``prompts`` staggered; returns (outputs, decode steps,
    wall seconds, per-step seconds)."""
    import torch
    from nbdistributed_tpu_torch.models import DecodeServer

    srv = DecodeServer(params, cfg, max_batch=8, max_len=1024)
    waves = [prompts[:5], prompts[5:9], prompts[9:]]
    rids, steps, step_s = [], 0, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for wave in waves:
        rids += [srv.submit(p, max_new) for p in wave]
        for _ in range(3):
            ts = time.perf_counter()
            if srv.step():
                steps += 1
                step_s.append(time.perf_counter() - ts)
    while not srv.done():
        ts = time.perf_counter()
        if srv.step():
            steps += 1
            step_s.append(time.perf_counter() - ts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [srv.outputs[r] for r in rids], steps, wall, step_s


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

    flash_attention.launches = 0
    flash_decode_attention.launches = 0
    logits = forward(params, tokens, cfg)
    outputs, steps, wall, step_s = serve(params, cfg, prompts)
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
    return {"k1": k1, "k4": k4, "steps": steps}, prompts, params


def phase_profile(params, n_steps=8):
    """Where a bf16 decode step's time goes: ``torch.profiler`` over
    ``n_steps`` steps of a full 8-slot server (128-token prompts) —
    device kernel time per step against the host's wall time, and the
    kernels that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nbdistributed_tpu_torch.models import (DecodeServer,
                                                smol_135m_config)

    cfg = smol_135m_config()
    srv = DecodeServer(params, cfg, max_batch=8, max_len=1024)
    g = torch.Generator().manual_seed(13)
    for _ in range(8):
        srv.submit(torch.randint(0, cfg.vocab_size, (128,),
                                 generator=g).tolist(), n_steps + 4)
    srv.step()
    srv.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            srv.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels.append((us / 1e3 / n_steps, e.count / n_steps, e.key))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    row = dict(wall_ms_per_step=wall_ms,
               device_ms_per_step=busy if kernels else "not measured",
               idle_share=1 - busy / wall_ms if kernels else "not measured",
               kernels_per_step=sum(k[1] for k in kernels),
               top=[dict(name=k[2][:80], ms_per_step=k[0],
                         calls_per_step=k[1]) for k in kernels[:8]])
    say("profile_decode_step", **row)
    return row


def phase_fp32(prompts, seed=0):
    """fp32 forward kernel vs plain, and fp32 serving vs solo generate
    (a divergence is tolerated only at a near-tie of the solo run)."""
    import torch
    from nbdistributed_tpu_torch.models import (forward, forward_with_cache,
                                                generate, init_kv_cache,
                                                init_params,
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

    outputs, steps, _, _ = serve(params, cfg, prompts)
    near_ties, gaps = 0, []
    for prompt, got in zip(prompts, outputs):
        want = generate(params, [prompt], cfg, 32)[0, len(prompt):].tolist()
        j = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y),
                 None)
        if j is None:
            continue
        cache = init_kv_cache(cfg, 1, len(prompt) + j, device="cuda")
        logits, _ = forward_with_cache(params, [prompt + want[:j]], cache, 0,
                                       cfg, last_only=True)
        top2 = torch.topk(logits[0, -1], 2).values
        gap = float(top2[0] - top2[1])
        gaps.append(gap)
        check(gap < 1e-4, f"fp32 serving diverged from solo generate at "
              f"step {j} where the solo top-2 gap is {gap}")
        near_ties += 1
    say("serve_fp32_vs_solo", requests=len(prompts), decode_steps=steps,
        divergences_at_near_ties=near_ties, gaps=gaps)


# ----------------------------------------------------------------------
# phase 5: timing

def sdpa(q, k, v, **kw):
    import torch.nn.functional as F
    try:
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
    except TypeError:                    # torch without enable_gqa
        rep = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1), **kw)


def phase_timing():
    import torch
    from nbdistributed_tpu_torch.ops import attention as A
    from nbdistributed_tpu_torch.ops import decode as K

    rows = {}
    # Each kernel is timed through the launcher its wrapper calls, so
    # the wrapper's argument checks stay out of the kernel's time.
    # K1 at the forward's shape: B=1, S=512, H=9, Hkv=3, D=64, causal.
    B, S, H, Hkv, D = 1, 512, 9, 3, 64
    q, k, v = k1_inputs(B, S, H, Hkv, D, torch.bfloat16, seed=1)
    args = dict(causal=True, scale=0.125, offsets=(0, 0), window=None,
                segment_ids=None, kv_segment_ids=None)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = cuda_ms(lambda: A._flash_forward_cuda(q, k, v, **args))
    plain = cuda_ms(lambda: A._flash_forward_plain(q, k, v, **args))
    lib = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True, scale=0.125))
    pairs = B * H * S * (S + 1) // 2               # causal (q, k) pairs
    flops = 4 * pairs * D
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * Hkv * D) + 4 * B * H * S
    t_f, t_b = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    rows["K1"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                      bound_ms=1e3 * max(t_f, t_b),
                      bound_by="operations" if t_f >= t_b else "bytes",
                      flops=flops, bytes=nbytes,
                      shape=dict(B=B, S=S, H=H, Hkv=Hkv, D=D))

    # K4 at the serving shape: B=8 slots, T=max_len=1024, positions as
    # the 16..232-token streams give them; one cache per layer so each
    # launch finds its cache cold in L2, as a decode step does.
    B, Hkv, group, D, T = 8, 3, 3, 64, 1024
    pos = serving_pos(B)
    q, _, _, _, _, _ = k4_inputs(B, Hkv, group, D, 16, False, seed=2)
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
    ratio = tol_ratio(kern(), ref, *K4_TOL)
    check(ratio <= 1, f"K4 at the timing shape: tolerance ratio {ratio}")

    def plain_fn():
        c = caches[next(it) % N_LAYERS_SMOL]
        K.decode_reference(q, c[0], c[1], pos, scale=0.125)

    valid = torch.arange(T, device="cuda")[None, :] <= pos.long()[:, None]
    mask = valid[:, None, None, :]                       # (B, 1, 1, T)
    q4 = q[:, :, None, :]                                # (B, H, 1, D)

    def lib_fn():
        c = caches[next(it) % N_LAYERS_SMOL]
        sdpa(q4, c[0], c[1], attn_mask=mask, scale=0.125)

    ms, plain, lib = cuda_ms(kern, 90), cuda_ms(plain_fn, 90), \
        cuda_ms(lib_fn, 90)
    n_valid = int(torch.clamp(pos.long() + 1, max=T).sum())
    nbytes = 2 * (2 * n_valid * Hkv * D + 2 * B * Hkv * group * D) + 4 * B
    flops = 4 * n_valid * Hkv * group * D
    t_f, t_b = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    rows["K4"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                      bound_ms=1e3 * max(t_f, t_b),
                      bound_by="operations" if t_f >= t_b else "bytes",
                      flops=flops, bytes=nbytes, valid_tokens=n_valid,
                      shape=dict(B=B, Hkv=Hkv, group=group, D=D, T=T))
    for name, row in rows.items():
        say("timing", kernel=name, **row)
    return rows


# ----------------------------------------------------------------------

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
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln]
             for n in _build.KERNELS}
    card = gpu_name_and_power()
    say("build", seconds=time.perf_counter() - t0, per_kernel_s=spent,
        card=card, torch=torch.__version__, cuda=torch.version.cuda)

    k1_err = phase_k1()
    k4_err = phase_k4()
    counts, prompts, params = phase_main_path()
    profile_row = phase_profile(params)
    del params
    phase_fp32(prompts)
    timing = phase_timing()

    kernels = [
        dict(name="flash_attention_fwd", route="cuda",
             source="nbdistributed_tpu_torch/ops/csrc/flash_attention.cu",
             replaces="nbdistributed_tpu/ops/attention.py:405",
             launches=counts["k1"], max_abs_err=k1_err,
             **{k: timing["K1"][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}),
        dict(name="flash_decode", route="cuda",
             source="nbdistributed_tpu_torch/ops/csrc/flash_decode.cu",
             replaces="nbdistributed_tpu/ops/decode.py:214",
             launches=counts["k4"], max_abs_err=k4_err,
             **{k: timing["K4"][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}),
    ]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels, "timing": timing,
         "counts": counts, "profile": profile_row, "ptxas": ptxas},
        indent=1))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
