"""The port's async in-flight window (``messaging/pipeline.py``) against
the JAX package's, and the window on a 2-rank gloo cluster.

Part 1 drives the same submissions through both ``AsyncExecutor``s,
each over the fake comm of ``tests/unit/test_async_pipeline.py`` (hand-
fired handles, no sleeps), each executor fed the footprints its own
package's ``infer_effects`` records: the admission verdicts, the hold
reasons, the payloads, the completion order, the drain order and every
future's transitions must be equal.

Part 2 trains ``tiny_config`` on two gloo ranks through the port's
magics (``magics.magic.DistributedMagics`` on a stand-in shell), the
steps once as synchronous cells and once as ``%%distributed --async``
cells with proven-free cells between them: the losses are equal to the
last bit, the window held a free cell beside a training cell, and the
drain surfaces an errored cell once.
"""

import contextlib
import io
import threading

import pytest

from nbdistributed_tpu import analysis as jax_analysis
from nbdistributed_tpu.messaging import pipeline as jax_pipeline
from nbdistributed_tpu_torch import analysis
from nbdistributed_tpu_torch.messaging import pipeline

# ----------------------------------------------------------------------
# the fakes of tests/unit/test_async_pipeline.py


class FakeMsg:
    def __init__(self, data):
        self.data = data


class FakeHandle:
    def __init__(self, n):
        self.msg_id = f"fake-{n}"
        self.error = None
        self._result = None
        self._cbs = []
        self._ev = threading.Event()

    @property
    def results(self):
        return self._result

    def add_done_callback(self, cb):
        if self._ev.is_set():
            cb(self)
        else:
            self._cbs.append(cb)

    def fire(self, results=None, error=None):
        self.error = error
        self._result = {r: FakeMsg(d) for r, d in
                        (results or {}).items()}
        self._ev.set()
        for cb in list(self._cbs):
            cb(self)

    def wait(self, timeout=...):
        self._ev.wait(None if timeout in (..., None) else timeout)
        if self.error:
            raise self.error
        return self._result

    def pump(self, now=None):
        pass


class FakeLat:
    def __init__(self):
        self.freed = []

    def note_worker_free(self, msg_id, t=None):
        self.freed.append(msg_id)


class FakeComm:
    def __init__(self):
        self.handles = []
        self.payloads = []
        self.lat = FakeLat()

    def submit(self, ranks, msg_type, payload, on_done=None, **kw):
        h = FakeHandle(len(self.handles))
        self.handles.append(h)
        self.payloads.append(payload)
        if on_done is not None:
            h.add_done_callback(on_done)
        return h


OK = {0: {"output": "1", "status": "success"},
      1: {"output": "1", "status": "success"}}
RANK_ERROR = {0: {"output": "", "status": "success"},
              1: {"error": "ValueError: bad", "status": "error"}}

# One session: ("submit", cell, kwargs) probes the gate and submits
# when admissible; ("fire", k, results, error) completes the k-th wire
# request; ("drain",) empties the window once everything has fired.
SESSION = [
    ("submit", "a = 1", {}),
    ("submit", "b = 2", {}),
    ("submit", "c = a + 1", {}),                 # RAW on a: held
    ("fire", 0, OK, None),
    ("submit", "c = a + 1", {}),
    ("submit", "r = all_reduce(x)", {}),         # bearing
    ("submit", "s = all_reduce(y)", {}),         # one collective stream
    ("submit", "x = 5", {}),                     # WAR with r
    ("submit", "q = np.ones(3)", {"repeat": 3, "until": "q is None"}),
    ("submit", "z = 9", {}),                     # window full
    ("fire", 1, None, RuntimeError("worker 1 died")),
    ("fire", 2, RANK_ERROR, None),
    ("submit", "exec('w = 1')", {}),             # opaque: held
    ("submit", "z = 9", {}),
    ("fire", 3, OK, None),
    ("submit", "s = all_reduce(y)", {}),
    ("submit", "for i in range(3):\n    v = loss.item()", {}),
    ("fire", 4, OK, None),
    ("fire", 5, OK, None),
    ("fire", 6, OK, None),
    ("submit", "exec('w = 1')", {}),
    ("fire", 7, OK, None),
    ("submit", "exec('w = 1')", {}),
    ("fire", 8, OK, None),
    ("drain",),
]


def _record(ex, comm, infer):
    """Run SESSION on one executor; everything observable, in order."""
    log, futures, done_order = [], [], []
    ex.on_result = lambda cell: done_order.append(cell.future.seq)
    for op in SESSION:
        if op[0] == "submit":
            _, cell, kw = op
            entry = infer(cell).as_dict()
            reason = ex.try_admit(entry)
            log.append(("gate", cell, reason,
                        pipeline.classify_entry(entry)))
            if reason is None:
                futures.append(ex.submit_cell(cell, [0, 1], entry=entry,
                                              sha=f"s{len(futures)}",
                                              **kw))
        elif op[0] == "fire":
            comm.handles[op[1]].fire(op[2], op[3])
        else:
            drained = ex.drain()
            log.append(("drain", [f.seq for f in drained],
                        [f.state for f in drained]))
        snap = ex.snapshot()
        log.append(("state", [f.state for f in futures], snap["depth"],
                    snap["collective_holder"],
                    [c["collective"] for c in snap["cells"]],
                    snap["completed"], snap["errored"]))
    log.append(("done_order", done_order))
    log.append(("errors", [str(f.error) for f in futures]))
    log.append(("unconsumed", [f.seq for f in ex.unconsumed_errors()]))
    log.append(("payloads", comm.payloads))
    log.append(("freed", comm.lat.freed))
    return log


def test_both_executors_admit_hold_drain_and_resolve_alike():
    jcomm, tcomm = FakeComm(), FakeComm()
    want = _record(jax_pipeline.AsyncExecutor(jcomm, window=4), jcomm,
                   jax_analysis.infer_effects)
    got = _record(pipeline.AsyncExecutor(tcomm, window=4), tcomm,
                  analysis.infer_effects)
    assert got == want
    reasons = [e[2] for e in got if e[0] == "gate" and e[2]]
    # Every gate fired at least once in the session.
    for gate in ("hazard", "one-collective-stream", "window full",
                 "opaque"):
        assert any(gate in r for r in reasons), gate


@pytest.mark.parametrize("entry,cls", [
    (None, "unknown"), ({"parsed": False}, "unknown"),
    ({"parsed": True, "opaque": True}, "unknown"),
    ({"parsed": True, "collective_verdict": "none"}, "free"),
    ({"parsed": True, "collective_verdict": "exact"}, "bearing"),
    ({"parsed": True, "collective_verdict": "unknown"}, "unknown"),
])
def test_classify_entry_is_the_jax_packages(entry, cls):
    assert pipeline.classify_entry(entry) == cls
    assert jax_pipeline.classify_entry(entry) == cls


def test_held_submitter_is_admitted_by_a_completion():
    """A blocked ``submit_cell`` waits on the condition the IO thread
    notifies: its hold is reported once, and firing the predecessor
    lets it through — no sleeps, the hold is observed through the
    ``on_hold`` callback."""
    comm = FakeComm()
    held = threading.Event()
    ex = pipeline.AsyncExecutor(comm, window=4,
                                on_hold=lambda reason: held.set())
    entry = analysis.infer_effects("a = 1").as_dict()
    ex.submit_cell("a = 1", [0], entry=entry)
    got = []
    t = threading.Thread(target=lambda: got.append(ex.submit_cell(
        "b = a", [0], entry=analysis.infer_effects("b = a").as_dict())))
    t.start()
    assert held.wait(10)
    assert len(comm.handles) == 1
    comm.handles[0].fire(OK)
    t.join(10)
    assert not t.is_alive() and len(comm.handles) == 2
    comm.handles[1].fire(OK)
    assert got[0].state == "done" and ex.snapshot()["held_total"] == 1


def test_drain_returns_after_the_completion_hook():
    """The hook that prints an errored cell runs on whichever thread
    settles the handle; ``drain`` returns only once it has finished, so
    its print lies inside the drain (the JAX package's drain could
    return mid-hook, and the magic then printed the error a second
    time or after the cell).  The hook is held open from another
    thread; no sleeps."""
    comm = FakeComm()
    entered, release = threading.Event(), threading.Event()

    def hook(cell):
        entered.set()
        assert release.wait(10)

    ex = pipeline.AsyncExecutor(comm, window=4, on_result=hook)
    fut = ex.submit_cell("a = 1", [0],
                         entry=analysis.infer_effects("a = 1").as_dict())
    io = threading.Thread(target=comm.handles[0].fire, args=(OK,))
    io.start()
    assert entered.wait(10) and fut.state == "done"
    drained = []
    main = threading.Thread(target=lambda: drained.append(ex.drain()))
    main.start()
    main.join(0.3)
    assert main.is_alive() and not drained
    release.set()
    for t in (main, io):
        t.join(10)
        assert not t.is_alive()
    # Out of the window before the drain began: waited for, not listed.
    assert drained == [[]] and ex.depth == 0


# ----------------------------------------------------------------------
# the window on a 2-rank gloo cluster, through the magics

SETUP = """\
from nbdistributed_tpu_torch.models import (AdamW, init_params,
                                            make_train_step, param_leaves,
                                            tiny_config)
import time
cfg = tiny_config(dtype=torch.float32)
gen = torch.Generator().manual_seed(7 + rank)
batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                 generator=gen)}
def fresh():
    p = init_params(cfg, 0, device="cpu")
    return p, make_train_step(cfg, AdamW(param_leaves(p), lr=1e-3))
params, step = fresh()
"""
STEPS = 3


class Shell:
    """What the magics use of an IPython shell."""

    def __init__(self):
        self.user_ns = {}
        self.input_transformers_cleanup = []


@pytest.fixture(scope="module")
def nb():
    from nbdistributed_tpu_torch.magics.magic import DistributedMagics
    DistributedMagics.reset_class_state()
    magics = DistributedMagics(Shell())

    def run(fn, *args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ret = getattr(magics, fn)(*args)
        return buf.getvalue(), ret

    out, _ = run("dist_init", "-n 2 --backend cpu -t 120")
    assert "2 workers ready" in out, out
    try:
        yield run, magics
    finally:
        DistributedMagics.shutdown_all()
        DistributedMagics.reset_class_state()


def test_async_training_cells_equal_the_synchronous_ones(nb):
    run, magics = nb
    from nbdistributed_tpu_torch.magics.magic import DistributedMagics
    out, _ = run("distributed", "", SETUP)
    assert "❌" not in out, out
    for k in range(STEPS):
        run("distributed", "", f"loss_s{k} = float(step(params, batch))")
    run("distributed", "", "params, step = fresh()")
    depth_with_holder = 0
    for k in range(STEPS):
        out, fut = run("distributed", "--async",
                       f"loss_a{k} = float(step(params, batch))")
        assert fut is not None, out
        out, free = run("distributed", "--async",
                        f"free_{k} = torch.full((4,), {k}.0)")
        snap = DistributedMagics._async_exec.snapshot()
        if snap["collective_holder"] is not None:
            depth_with_holder = max(depth_with_holder, snap["depth"])
    out, _ = run("dist_wait", "")
    assert "✅ drained" in out and "errored" not in out, out
    # A proven-free cell ran beside a training cell holding the
    # collective stream (training cells are `unknown`: `step` is an
    # unvetted call), and the DAG draws no edge between them.
    assert depth_with_holder >= 2
    from nbdistributed_tpu_torch.analysis import preflight
    dag = preflight.deps_dag()
    names = {e["seq"]: e for e in dag["nodes"]}
    train = {s for s, e in names.items() if "loss_a0" in e["writes"]
             or "loss_a1" in e["writes"] or "loss_a2" in e["writes"]}
    free = {s for s, e in names.items()
            if any(w.startswith("free_") for w in e["writes"])}
    assert len(train) == STEPS and len(free) == STEPS
    assert not [e for e in dag["edges"]
                if {e["src"], e["dst"]} <= train | free]
    run("distributed", "",
        f"losses = ([loss_s{k} for k in range({STEPS})], "
        f"[loss_a{k} for k in range({STEPS})])")
    out, _ = run("dist_pull", "losses --all")
    losses = magics.shell.user_ns["losses"]
    for r in (0, 1):
        sync, asyn = losses[r]
        assert asyn == sync and len(sync) == STEPS, (r, losses[r])
    assert losses[0] != losses[1]          # each rank its own batch


def test_async_error_surfaces_once_at_the_drain(nb):
    run, _ = nb
    out, fut = run("distributed", "--async",
                   "time.sleep(0.3)\nraise ValueError('async boom')")
    assert "streamed to ranks [0, 1]" in out
    out, _ = run("dist_wait", "")
    assert out.count("✗ async cell") == 1, out
    assert "rank 1: async boom" in out and "1 errored" in out
    out, _ = run("distributed", "", "after_error = 1")
    assert "errored un-inspected" not in out


def test_sync_cell_drains_the_armed_window_first(nb, monkeypatch):
    run, _ = nb
    monkeypatch.setenv("NBD_ASYNC_WINDOW", "4")
    out, fut = run("distributed", "", "time.sleep(0.3)\nw1 = 1")
    assert "⧗ async cell" in out and fut is not None
    out, _ = run("distributed", "--sync", "w2 = 2")
    assert out.startswith("⧗ draining async window (1 in flight) — "
                          "synchronous cell"), out
    assert fut.state == "done"
