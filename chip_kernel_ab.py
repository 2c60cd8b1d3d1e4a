#!/usr/bin/env python3
"""Time the PyTorch port's K2 (flash-attention dQ) and K4 (flash-decode)
kernels of two checkouts of this repository on one NVIDIA GPU, in
turns, each run in a fresh process: old, new, new, old.

    python3 chip_kernel_ab.py OLD_ROOT NEW_ROOT

Each run imports ``nbdistributed_tpu_torch`` from its own root and
builds that root's kernels there.  Both call the wrappers' launchers,
whose signatures the two checkouts share, on the same seeded inputs:

* K2 at the train shape (B=4, S=2048, H=9, Hkv=3, D=64, bf16, causal);
* K4 at the serving shape (B=8 slots, Hkv=3, group 3, D=64, T=1024,
  positions 16..232) and at full context (T=2048, every slot at 2047),
  one cache per layer so each launch finds its cache cold in L2; timed
  on the device by CUDA-graph replay (``ms``) and as back-to-back
  launches from the host (``ms_eager``).

Each run holds its kernels' outputs to the plain versions before it
times them, with ``chip_smoke.py``'s timers (this checkout's).  Prints
the card's name and power limit, one JSON line per run, and a summary
line (the median of each side's two runs); writes everything to
``chiprun_out/kernel_ab.json``.  Exits non-zero when there is no CUDA
device.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

from chip_smoke import cuda_ms, graph_ms  # this checkout's, beside this file

N_LAYERS = 30


def rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def time_k2():
    import torch
    from nbdistributed_tpu_torch.ops import attention as A

    B, S, H, Hkv, D = 4, 2048, 9, 3, 64
    g = torch.Generator(device="cuda").manual_seed(21)
    q, go = (torch.randn(B, S, H, D, generator=g, device="cuda")
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    args = dict(causal=True, scale=0.125, offsets=(0, 0), window=None,
                segment_ids=None, kv_segment_ids=None)
    out, lse = A._flash_forward_cuda(q, k, v, **args)
    delta = A._flash_bwd_prep(out, go)
    got = A.flash_attention_bwd_dq(q, k, v, go, lse, delta, **args)
    want = A._flash_backward_plain(q, k, v, out, lse, go, **args)[0]
    err = rel_err(got, want)
    assert err < 2e-2, f"K2 disagrees with the plain backward: {err}"
    ms = cuda_ms(lambda: A.flash_attention_bwd_dq(q, k, v, go, lse, delta,
                                                  **args), 20)
    return dict(ms=ms, rel_err=err)


def time_k4(pos, T, B=8, Hkv=3, group=3, D=64):
    import torch
    from nbdistributed_tpu_torch.ops import decode as K

    g = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn(B, Hkv * group, D, generator=g,
                    device="cuda").to(torch.bfloat16)
    caches = [torch.randn(2, B, Hkv, T, D, generator=g,
                          device="cuda").to(torch.bfloat16)
              for _ in range(N_LAYERS)]
    it = iter(range(10 ** 9))

    def kern():
        c = caches[next(it) % N_LAYERS]
        return K._decode_cuda(q, c[0], c[1], pos, scale=0.125, window=None,
                              k_s=None, v_s=None, return_lse=False)[0]

    want, _ = K.decode_reference(q, caches[0][0], caches[0][1], pos,
                                 scale=0.125)
    err = rel_err(kern(), want)
    assert err < 2e-2, f"K4 disagrees with the plain version: {err}"
    return dict(ms=graph_ms(kern), ms_eager=cuda_ms(kern, 90), rel_err=err)


def child(root: str) -> dict:
    import torch
    sys.path.insert(0, root)
    from nbdistributed_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    gen = torch.Generator().manual_seed(3)
    serving = torch.randint(16, 233, (8,), generator=gen).to("cuda",
                                                             torch.int32)
    full = torch.full((8,), 2047, dtype=torch.int32, device="cuda")
    return {"K2_train": time_k2(), "K4_serving": time_k4(serving, 1024),
            "K4_full_context": time_k4(full, 2048)}


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--child":
        print(json.dumps(child(argv[2])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available() or len(argv) != 3:
        print("usage: chip_kernel_ab.py OLD_ROOT NEW_ROOT (needs an NVIDIA "
              "GPU)", file=sys.stderr)
        return 2
    roots = {"old": str(pathlib.Path(argv[1]).resolve()),
             "new": str(pathlib.Path(argv[2]).resolve())}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = []
    for side in ("old", "new", "new", "old"):
        res = subprocess.run([sys.executable, __file__, "--child",
                              roots[side]], capture_output=True, text=True,
                             timeout=900)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return 1
        row = {"side": side, **json.loads(res.stdout.strip().splitlines()[-1])}
        print(json.dumps(row), flush=True)
        runs.append(row)
    summary = {side: {name: {m: statistics.median(
        r[name][m] for r in runs if r["side"] == side)
        for m in ("ms", "ms_eager") if m in runs[0][name]}
        for name in ("K2_train", "K4_serving", "K4_full_context")}
        for side in ("old", "new")}
    out = pathlib.Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_ab.json").write_text(json.dumps(
        {"card": card, "roots": roots, "runs": runs, "median_ms": summary},
        indent=1))
    print(json.dumps({"card": card, "median_ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
