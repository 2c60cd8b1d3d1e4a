"""Serving cells: the port's ``DecodeServer`` (greedy) under a closed
loop of clients.

Each client sends its next request the moment its last one completes;
``DecodeServer.submit`` admits and prefills it at once (a slot is free,
since one just finished) and samples its first token.  So a request's
time to first token runs from the step that completed its client's
previous request, through the prefills sent before it in that moment,
to its own first token.  Set-up makes the weights, builds the server
and runs the loop for ``warmup_steps`` steps from a cold start (every
client sends at once); the window then runs the loop on until
``--seconds`` have passed.  Every step ends in the server's host read of
its tokens, so the host clock stamps what the client sees.

After the window a sample of the requests that finished in it, drawn
from the seed with the longest among them, is held to the plain
reference (:mod:`reference.served`): the mean, over every served token
of the sample, of the gap by which its reference logit lies below the
reference's best at its position.
"""

from __future__ import annotations

import torch

from .. import traffic, weights
from ..context import Context, check, passed
from ..port import build_config
from ..trace import profiled

CHIPS = (1,)


class Loop:
    """The closed loop: the server, the request stream and what each
    request saw."""

    def __init__(self, ctx: Context, srv, vocab: int):
        self.ctx, self.srv, self.vocab = ctx, srv, vocab
        self.next_index = 0
        self.req: dict[int, dict] = {}
        self.steps: list[tuple[float, float, int]] = []  # (start, wall, rows)

    def send(self, t_sent: float) -> None:
        r = traffic.request(self.ctx.mix, self.ctx.seed, self.next_index,
                            self.vocab)
        self.next_index += 1
        t0 = self.ctx.now()
        rid = self.srv.submit(r["prompt"], r["max_new"])
        t1 = self.ctx.now()
        self.req[rid] = {"prompt_len": len(r["prompt"]), "max_new":
                         r["max_new"], "sent": t_sent, "submit": (t0, t1),
                         "times": [t1] * len(self.srv.outputs[rid]),
                         "done": None}
        self._maybe_done(rid, t1)

    def _maybe_done(self, rid: int, t: float) -> None:
        rec = self.req[rid]
        if rec["done"] is None and len(rec["times"]) >= rec["max_new"]:
            rec["done"] = t
            self.send(t)

    def iterate(self) -> None:
        ts = self.ctx.now()
        rows = self.srv.n_active
        emitted = self.srv.step()
        te = self.ctx.now()
        self.steps.append((ts, te - ts, rows))
        for rid, toks in emitted.items():
            self.req[rid]["times"].extend([te] * len(toks))
        for rid in emitted:
            self._maybe_done(rid, te)


def _server(ctx: Context, cfg, params):
    from nbdistributed_tpu_torch.models.serving import DecodeServer
    s = ctx.mix["server"]
    return DecodeServer(params, cfg, max_batch=s["max_batch"],
                        max_len=s["max_len"], temperature=0.0)


def prepare(ctx: Context, cfg=None) -> dict:
    cfg = build_config(ctx.cell.config) if cfg is None else cfg
    ctx.build_kernels()
    sizes = weights.sizes_of(cfg)
    params = weights.make(sizes, ctx.seed, ctx.device)
    srv = _server(ctx, cfg, params)
    ctx.log("weights and server made")
    loop = Loop(ctx, srv, sizes["vocab_size"])
    t = ctx.now()
    for _ in range(ctx.mix["clients"]):
        loop.send(t)
    ctx.log("first prefills done")
    for _ in range(ctx.mix["warmup_steps"]):
        loop.iterate()
    ctx.log("warm-up done")
    return {"cfg": cfg, "sizes": sizes, "params": params, "srv": srv,
            "loop": loop}


def window(ctx: Context, st: dict) -> dict:
    from nbdistributed_tpu_torch.parallel import expert
    loop = st["loop"]
    prof = {}
    first_step = len(loop.steps)
    reads0 = expert._dropless_ffn.host_reads
    t0 = ctx.now()
    profiled_interval = None
    while ctx.now() - t0 < ctx.seconds:
        if ctx.trace and not prof and ctx.now() - t0 >= ctx.seconds / 3:
            tp0 = ctx.now()
            with profiled(ctx.recorder, prof, ctx.device):
                for _ in range(ctx.mix["trace_steps"]):
                    loop.iterate()
            profiled_interval = (tp0, ctx.now())
            continue
        loop.iterate()
    t_end = ctx.now()
    return {"t0": t0, "t_end": t_end,
            "window_s": t_end - t0, "requests": loop.req,
            "steps": loop.steps[first_step:],
            "profiled_interval": profiled_interval,
            "moe_host_reads": expert._dropless_ffn.host_reads - reads0,
            "trace": prof.get("analysis"),
            "sizes": st["sizes"], "mix": ctx.mix, "seed": ctx.seed}


def in_window(rec: dict) -> dict:
    """Requests by what fell inside the window: ``attempted`` (in flight
    at some time in it), ``finished`` (done in it), ``stalled`` (in
    flight at its close with no token in its last ``stall_steps``
    steps, though every step gives every live request one)."""
    t0, t1 = rec["t0"], rec["t_end"]
    n = rec["mix"]["stall_steps"]
    stall = rec["steps"][-n][0] if len(rec["steps"]) >= n else t0
    att, fin, stalled = [], [], []
    for rid, r in rec["requests"].items():
        if r["sent"] > t1 or (r["done"] is not None and r["done"] < t0):
            continue
        att.append(rid)
        if r["done"] is not None and r["done"] <= t1:
            fin.append(rid)
        elif r["times"][-1] < stall:
            stalled.append(rid)
    return {"attempted": att, "finished": fin, "stalled": stalled}


def sample(rec: dict, finished: list, n: int) -> list:
    """``n`` finished requests drawn from the seed, the longest first."""
    if not finished:
        return []
    reqs = rec["requests"]
    longest = max(finished, key=lambda r: (reqs[r]["prompt_len"]
                                           + reqs[r]["max_new"], r))
    rest = sorted(r for r in finished if r != longest)
    g = traffic.rng(rec["seed"], "check")
    pick = g.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def served(srv, rids: list) -> list:
    return [(srv.prompts[r], list(srv.outputs[r])) for r in rids]


def reference_logits(ctx: Context, sizes: dict, seqs: list,
                     precision: str = "fp32") -> list:
    from reference.common import Precision, exact_float32
    from reference.served import served_logits
    with exact_float32():
        w = weights.make(sizes, ctx.seed, ctx.device)
        out = served_logits(w, sizes, seqs, Precision(precision), ctx.device)
    del w
    ctx.free()
    return out


def gaps(logits: list, seqs: list) -> list[float]:
    """Every served token's gap: how far its reference logit lies below
    the reference's best at its position."""
    out = []
    for lg, (_, toks) in zip(logits, seqs):
        t = torch.tensor(toks, dtype=torch.long, device=lg.device)
        out += (lg.max(dim=1).values - lg.gather(1, t[:, None])[:, 0]).tolist()
    return out


def top_tokens(logits: list, seqs: list) -> list:
    """``seqs`` with the served tokens replaced by the ones ``logits`` put
    first (the control's choice at the same positions)."""
    return [(p, lg.argmax(dim=1).tolist()) for (p, _), lg in zip(seqs, logits)]


def mean(xs: list[float]) -> float:
    return sum(xs) / len(xs) if xs else float("inf")


def run(ctx: Context, cfg=None) -> dict:
    st = prepare(ctx, cfg)
    rec = window(ctx, st)
    rec["setup_s"] = rec["t0"] - ctx.t_process
    memory_peak = ctx.memory_peak()
    ctx.log(f"window done: {len(rec['steps'])} steps in "
            f"{rec['window_s']:.3f} s")
    who = in_window(rec)
    seqs = served(st["srv"], sample(rec, who["finished"],
                                    ctx.mix["check_requests"]))
    sizes = st["sizes"]
    st.clear()
    ctx.free()
    g = gaps(reference_logits(ctx, sizes, seqs), seqs) if seqs else []
    ctx.log("reference done")
    checks = {"mean_logit_gap": check(mean(g), ctx.limits["mean_logit_gap"])}
    failed = len(who["stalled"])
    return {"record": rec, "checks": checks,
            "correct": passed(checks) and failed == 0,
            "attempted": len(who["attempted"]), "failed": failed,
            "memory_peak_bytes": memory_peak,
            "readings": {"widest_logit_gap": max(g, default=float("inf")),
                         "checked": [len(s) for _, s in seqs]}}
