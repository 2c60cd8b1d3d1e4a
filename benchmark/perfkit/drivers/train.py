"""Training cells: the port's trainer step (``make_train_step`` with its
``AdamW``) on packed batches, steps back to back.

Set-up builds the one step object (model, optimizer state, step) and
drives it through the mix's ``checked_steps`` first steps with the
window's own call and feed; the program's readings are taken there: the
loss of each step, each leaf's first gradient as the optimizer got it
(its first moment after one step over ``1 - b1``), and each leaf's
change after those steps (the leaf made again from the seed).  The
window then steps the same object until ``--seconds`` have passed and
the device has finished; no host read happens inside it.  After the
window the program is freed and the plain reference
(:mod:`reference.dense`) takes the same first steps from the same
weights and batches.
"""

from __future__ import annotations

import torch

from .. import traffic, weights
from ..context import (Context, change_norms, check, passed, sq_norm,
                       worst_leaf_gap)
from ..port import build_config
from ..trace import profiled

CHIPS = (1,)


def _feed(ctx: Context, vocab: int, index: int, seed=None) -> dict:
    """Batch ``index`` of the run's seed (or of ``seed``) on the device."""
    b = traffic.train_batch(ctx.mix, ctx.seed if seed is None else seed,
                            index, vocab)
    out = {}
    for k, v in b.items():
        t = torch.from_numpy(v)
        if ctx.device.type == "cuda":
            t = t.pin_memory().to(ctx.device, non_blocking=True)
        out[k] = t.to(ctx.device)
    return out


def prepare(ctx: Context, cfg=None) -> dict:
    """The step object after its first steps, and the program's
    readings."""
    from nbdistributed_tpu_torch.models.transformer import (
        AdamW, make_train_step, param_leaves)
    cfg = build_config(ctx.cell.config) if cfg is None else cfg
    ctx.build_kernels()
    sizes = weights.sizes_of(cfg)
    params = weights.make(sizes, ctx.seed, ctx.device)
    ctx.log("weights made")
    o = ctx.mix["optimizer"]
    opt = AdamW(param_leaves(params), lr=o["lr"], b1=o["b1"], b2=o["b2"],
                eps=o["eps"], weight_decay=o["weight_decay"])
    if ctx.recorder is not None:
        ctx.recorder.install_method(opt, "step", "bench.adamw")
    step = make_train_step(cfg, opt)
    losses, grads, first = [], {}, {}
    for i in range(ctx.mix["checked_steps"]):
        losses.append(step(params, _feed(ctx, sizes["vocab_size"], i)))
        if i == 0:
            for path in weights.leaf_specs(sizes):
                st = opt.state.get(weights.get(params, path), {})
                grads[path] = (sq_norm(st["mu"]) ** 0.5 / (1 - o["b1"])
                               if "mu" in st else 0.0)
                # The first gradient as the optimizer got it, kept on the
                # host until the reference's own is there to compare.
                first[path] = (st["mu"].to("cpu", copy=True) if "mu" in st
                               else None)
    ctx.log("checked steps done")
    readings = {"losses": [float(x) for x in losses], "grad_norms": grads,
                "change_norms": change_norms(params, sizes, ctx.seed,
                                             ctx.device),
                "first_grad": first, "first_grad_scale": 1 / (1 - o["b1"])}
    ctx.sync()
    return {"cfg": cfg, "sizes": sizes, "params": params, "opt": opt,
            "step": step, "next": ctx.mix["checked_steps"],
            "readings": readings}


def window(ctx: Context, st: dict) -> dict:
    """Steps until ``ctx.seconds`` have passed.  The traced run profiles
    ``trace_steps`` of them a third of the way in, on the first batches
    of the mix's ``trace_seed``: the same rows whatever the run's seed
    and wherever the sub-window falls.  Returns the window's record."""
    step, params, vocab = st["step"], st["params"], st["sizes"]["vocab_size"]
    tokens_per_step = ctx.mix["batch"] * ctx.mix["seq_len"]
    losses, batches, segments, prof = [], [], [], {}
    t0 = ctx.now()
    seg_t0, seg_idx = t0, []
    while True:
        if ctx.trace and not prof and ctx.now() - t0 >= ctx.seconds / 3:
            ctx.sync()
            segments.append((seg_idx, ctx.now() - seg_t0))
            with profiled(ctx.recorder, prof, ctx.device):
                for j in range(ctx.mix["trace_steps"]):
                    batches.append(j)
                    losses.append(step(params, _feed(
                        ctx, vocab, j, ctx.mix["trace_seed"])))
            seg_t0, seg_idx = ctx.now(), []
        seg_idx.append(st["next"])
        losses.append(step(params, _feed(ctx, vocab, st["next"])))
        st["next"] += 1
        if ctx.now() - t0 >= ctx.seconds:
            break
    ctx.sync()
    t_end = ctx.now()
    segments.append((seg_idx, t_end - seg_t0))
    losses = torch.stack(losses).float().cpu()
    return {"window_s": t_end - t0,
            "steps": len(losses), "tokens_per_step": tokens_per_step,
            "failed": int((~torch.isfinite(losses)).sum()),
            "segments": segments, "profiled_batches": batches,
            "trace": prof.get("analysis"),
            "sizes": st["sizes"], "mix": ctx.mix, "seed": ctx.seed}


def reference(ctx: Context, sizes: dict, precision: str = "fp32",
              target_keep=None, against=(), keep: bool = False) -> dict:
    """The plain reference's readings over the same first steps.
    ``against``: readings of other runs (each with ``first_grad`` on the
    host); for each, ``grad_err[j]`` holds every leaf's norm of its first
    gradient minus the reference's.  ``keep``: the reference's own
    first gradient is kept on the host (bf16), as a run's would be."""
    from reference.adamw import AdamW as RefAdamW
    from reference.common import Precision, exact_float32
    from reference.dense import train_steps
    errs = [dict() for _ in against]
    mine: dict = {}

    def first_grad(path, layer, g):
        for j, other in enumerate(against):
            host = other["first_grad"].get(path)
            if host is None:
                errs[j][path] = errs[j].get(path, 0.0) + float(
                    (g.double() ** 2).sum())
                continue
            h = host if layer is None else host[layer]
            d = h.to(g.device).double() * other["first_grad_scale"] - g
            errs[j][path] = errs[j].get(path, 0.0) + float((d ** 2).sum())
        if keep:
            if layer is None:
                mine[path] = g.to(torch.bfloat16).cpu()
            else:
                if path not in mine:
                    shape = weights.leaf_specs(sizes)[path][0]
                    mine[path] = torch.empty(shape, dtype=torch.bfloat16)
                mine[path][layer] = g.to(torch.bfloat16).cpu()

    with exact_float32():
        w = weights.make(sizes, ctx.seed, ctx.device)
        o = ctx.mix["optimizer"]
        opt = RefAdamW(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                       weight_decay=o["weight_decay"])
        batches = [_feed(ctx, sizes["vocab_size"], i)
                   for i in range(ctx.mix["checked_steps"])]
        out = train_steps(w, sizes, batches, opt, Precision(precision),
                          target_keep, first_grad)
        del opt, batches
        out["change_norms"] = change_norms(w, sizes, ctx.seed, ctx.device)
    del w
    ctx.free()
    out["grad_err"] = [{k: v ** 0.5 for k, v in e.items()} for e in errs]
    if keep:
        out["first_grad"], out["first_grad_scale"] = mine, 1.0
    return out


def compare(prog: dict, ref: dict, limits: dict, j: int = 0) -> dict:
    """The numbers compared, each beside its limit; ``j`` picks the
    program's entry of ``ref["grad_err"]``.  Leaves whose reference
    gradient is under a thousandth of the median leaf's move by
    round-off alone and are left out of the change."""
    med = sorted(ref["grad_norms"].values())[len(ref["grad_norms"]) // 2]
    moved = {k for k, v in ref["grad_norms"].items() if v >= 1e-3 * med}
    loss = max(abs(a - b) / abs(b)
               for a, b in zip(prog["losses"], ref["losses"]))
    err = ref["grad_err"][j]
    zero = {k: 0.0 for k in err}
    return {
        "grad_err": check(worst_leaf_gap(err, {k: ref["grad_norms"][k]
                                               for k in err}, None, zero),
                          limits["grad_err"]),
        "loss_gap": check(loss, limits["loss_gap"]),
        "grad_gap": check(worst_leaf_gap(prog["grad_norms"],
                                         ref["grad_norms"]),
                          limits["grad_gap"]),
        "change_gap": check(worst_leaf_gap(prog["change_norms"],
                                           ref["change_norms"], moved),
                            limits["change_gap"]),
    }


def run(ctx: Context, cfg=None) -> dict:
    st = prepare(ctx, cfg)
    setup_s = ctx.now() - ctx.t_process
    rec = window(ctx, st)
    rec["setup_s"] = setup_s
    memory_peak = ctx.memory_peak()
    ctx.log(f"window done: {rec['steps']} steps in {rec['window_s']:.3f} s")
    prog, sizes = st["readings"], st["sizes"]
    st.clear()
    ctx.free()
    ref = reference(ctx, sizes, against=[prog])
    ctx.log("reference done")
    checks = compare(prog, ref, ctx.limits)
    return {"record": rec, "checks": checks,
            "correct": passed(checks) and rec["failed"] == 0,
            "attempted": rec["steps"], "failed": rec["failed"],
            "memory_peak_bytes": memory_peak,
            "readings": {"program": prog, "reference": ref}}
