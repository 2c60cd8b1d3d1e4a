"""Device milliseconds a step of the gradient accumulation of the
layer-stacked leaves: the work launched, on any thread, by autograd's
``select`` backward (each layer's slice comes back as a zero-filled
tensor the size of the whole stacked leaf and is added into the leaf's
input buffer) and by the accumulation into ``.grad``, where the launch
lies inside the program's ``train/backward`` span."""

import bisect

OPS = ("autograd::engine::evaluate_function: SelectBackward0",
       "autograd::engine::evaluate_function: "
       "torch::autograd::AccumulateGrad")
BACKWARD = "train/backward"


def _union(ivs) -> tuple[list, list]:
    """The union of intervals as (starts, ends), sorted."""
    starts, ends = [], []
    for a, b in sorted(ivs):
        if ends and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    return starts, ends


def _inside(union, t: float) -> bool:
    starts, ends = union
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ends[i]


def read(run):
    tr, n = run["trace"], len(run["record"]["profiled_batches"])
    if tr is None or n == 0 or not tr.device:
        return None
    backward = _union([iv for (name, _), ivs in tr.spans.items()
                       if name == BACKWARD for iv in ivs])
    if not backward[0]:
        return None
    by_tid = {}
    for a, b, name, tid in tr.host_ops:
        if name in OPS:
            by_tid.setdefault(tid, []).append((a, b))
    ops = {tid: _union(ivs) for tid, ivs in by_tid.items()}
    total = 0.0
    for a, b, _, corr in tr.device:
        launch = tr.launch.get(corr)
        if launch is None or launch[0] not in ops:
            continue
        tid, ts = launch
        if _inside(ops[tid], ts) and _inside(backward, ts):
            total += b - a
    return total * 1e-3 / n
