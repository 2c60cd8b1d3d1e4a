"""Model FLOPs of the traced run's steps outside the profiled
sub-window over their seconds, as a share of the card's bf16 peak: six
per non-embedding parameter (lm_head included) per token plus the
attention products of the pairs the window and documents allow;
recomputation not counted."""

from perfkit import counts, traffic


def read(run):
    r = run["record"]
    s, mix = r["sizes"], r["mix"]
    flops = seconds = 0.0
    for idx, wall in r["segments"]:
        seconds += wall
        for i in idx:
            lens = traffic.doc_lengths(mix, r["seed"], i)
            flops += counts.train_model_flops(
                s, mix["batch"] * mix["seq_len"],
                counts.pairs(lens, s["sliding_window"]))
    if seconds <= 0 or flops == 0:
        return None
    return 100.0 * flops / seconds / run["peak"]["bf16_flops"]
