"""The readings the limits of ``correct`` are set from, at a cell's own
size, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 1 2 3 --out <file.json>

For every seed: the program's numbers against the plain reference (the
lower readings), as a run of the cell takes them (training: set-up's
first steps; serving: a window of ``--seconds`` at the cell's load).
For each control seed also the control (the reference computed in fp8,
put in the program's place) and, for training, the half-batch fault
(the reference's loss over the first half of the targets only); their
numbers are the upper readings.  Training keeps up to three first
gradients on the host (about 15 GB each at Mistral-7B).  Not run by the benchmark itself.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

LOOSE = {"loss_gap": float("inf"), "grad_gap": float("inf"),
         "grad_err": float("inf"), "change_gap": float("inf"),
         "mean_logit_gap": float("inf")}


def values(checks: dict) -> dict:
    return {k: c["value"] for k, c in checks.items()}


def train_seed(ctx, control: bool) -> dict:
    from perfkit.drivers import train
    st = train.prepare(ctx)
    prog, sizes = st["readings"], st["sizes"]
    st.clear()
    ctx.free()
    runs = {"program": prog}
    if control:
        runs["control_fp8"] = train.reference(ctx, sizes, "fp8", keep=True)
        S = ctx.mix["seq_len"]

        def first_half(B, _S):
            import torch
            keep = torch.zeros((B, S - 1), dtype=torch.bool)
            keep[:, : (S - 1) // 2] = True
            return keep

        runs["fault_half_batch"] = train.reference(
            ctx, sizes, "fp32", target_keep=first_half, keep=True)
    names = list(runs)
    ref = train.reference(ctx, sizes, against=[runs[n] for n in names])
    out = {"losses": {n: r["losses"] for n, r in runs.items()},
           "reference_losses": ref["losses"],
           "reference_grad_norms": ref["grad_norms"]}
    for j, n in enumerate(names):
        out[n] = values(train.compare(runs[n], ref, LOOSE, j))
        out[n + "_leaves"] = {"grad_norms": runs[n]["grad_norms"],
                              "grad_err": ref["grad_err"][j],
                              "change_norms": runs[n]["change_norms"]}
    out["reference_change_norms"] = ref["change_norms"]
    return out


def serve_seed(ctx, control: bool) -> dict:
    from perfkit.drivers import serve
    st = serve.prepare(ctx)
    rec = serve.window(ctx, st)
    who = serve.in_window(rec)
    seqs = serve.served(st["srv"], serve.sample(rec, who["finished"],
                                                ctx.mix["check_requests"]))
    sizes = st["sizes"]
    st.clear()
    ctx.free()
    ref = serve.reference_logits(ctx, sizes, seqs)
    g = serve.gaps(ref, seqs)
    out = {"program": {"mean_logit_gap": serve.mean(g)},
           "checked_tokens": [len(s) for _, s in seqs],
           "stalled": len(who["stalled"]), "program_gaps": _gap_stats(g)}
    if control:
        low = serve.reference_logits(ctx, sizes, seqs, "fp8")
        gc = serve.gaps(ref, serve.top_tokens(low, seqs))
        out["control_fp8"] = {"mean_logit_gap": serve.mean(gc)}
        out["control_gaps"] = _gap_stats(gc)
    return out


def _gap_stats(gaps: list) -> dict:
    """Every served token's gap, summarised: how many, how many above
    zero, the mean, and the five largest."""
    gaps = sorted(gaps)
    return {"n": len(gaps), "above_zero": sum(g > 0 for g in gaps),
            "mean": sum(gaps) / max(len(gaps), 1), "top5": gaps[-5:]}


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=40.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch
    from perfkit import spec
    from perfkit.context import Context
    from perfkit.runner import finite, set_environment
    set_environment()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    one = train_seed if cell.mix["driver"] == "train" else serve_seed
    results = {"workload": cell.name,
               "device": torch.cuda.get_device_name(device), "seeds": {}}
    for seed in args.seeds:
        ctx = Context(cell=cell, seed=seed, seconds=args.seconds,
                      trace=False, device=device, t_process=T_PROCESS)
        ctx.log(f"seed {seed}")
        results["seeds"][str(seed)] = one(ctx, seed in args.control_seeds)
        ctx.free()
        ctx.log(json.dumps(finite(results["seeds"][str(seed)])))
        with open(args.out, "w") as f:
            json.dump(finite(results), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
