"""The notebook surface's stdlib modules, held exactly to the JAX
package's on the same inputs: rank specs (``magics/rankspec.py``), the
streamed display (``magics/display.py``), the timeline
(``magics/timeline.py``, times injected), the IDE proxies
(``magics/proxies.py``) and the notebook save hook
(``jupyter_hooks.py``).  Also the magics' argument splitting, against
IPython's own.
"""

import json
import random

import pytest
import torch

from nbdistributed_tpu import jupyter_hooks as jax_hooks
from nbdistributed_tpu.magics import display as jax_display
from nbdistributed_tpu.magics import proxies as jax_proxies
from nbdistributed_tpu.magics import rankspec as jax_rankspec
from nbdistributed_tpu.magics import timeline as jax_timeline
from nbdistributed_tpu.messaging import Message as JaxMessage
from nbdistributed_tpu_torch import jupyter_hooks as port_hooks
from nbdistributed_tpu_torch.magics import display as port_display
from nbdistributed_tpu_torch.magics import magic as port_magic
from nbdistributed_tpu_torch.magics import proxies as port_proxies
from nbdistributed_tpu_torch.magics import rankspec as port_rankspec
from nbdistributed_tpu_torch.magics import timeline as port_timeline
from nbdistributed_tpu_torch.messaging.codec import Message as PortMessage

# -- rank specs ---------------------------------------------------------

GOOD_SPECS = [("[0,1]", 4), ("[0-2]", 4), ("[0, 2-3, 1]", 8),
              ("[1,1,1-2]", 4), ("[3]", 4), ("[0-2, 1-3]", 8),
              ("[2, 0-2, 2-2]", 8), ("[1-1]", 4), ("[0-3]", 4),
              ("[00, 01]", 4), ("[ 0 - 2 ]", 8), (" [0] ", 1)]
BAD_SPECS = [("[1,5]", 4), ("[3-1]", 8), ("", 8), ("0,1", 8), ("[", 8),
             ("[]", 8), ("[a]", 8), ("[1;2]", 8), ("[-1]", 8),
             ("[1.5]", 8), ("[ ]", 8), ("[\t]", 8), ("[0,]", 8),
             ("[,1]", 8), ("[0,,1]", 8), ("[0 1]", 8), ("[1-]", 8),
             ("[-2]", 8), ("[2-5]", 4), ("[4]", 4)]


@pytest.mark.parametrize("spec,world", GOOD_SPECS)
def test_rank_specs_parse_as_in_jax(spec, world):
    assert port_rankspec.parse_ranks(spec, world) == \
        jax_rankspec.parse_ranks(spec, world)


@pytest.mark.parametrize("spec,world", BAD_SPECS)
def test_rank_spec_errors_match_jax(spec, world):
    with pytest.raises(jax_rankspec.RankSpecError) as want:
        jax_rankspec.parse_ranks(spec, world)
    with pytest.raises(port_rankspec.RankSpecError) as got:
        port_rankspec.parse_ranks(spec, world)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


# -- streamed display ---------------------------------------------------

_TEXTS = ["a\n", "partial", " line\n", "   \n", "",
          "<IPython.core.display.Javascript object>\n", "bar\r",
          "multi\nline\n", "window.require(x)\n", "z"]


def _feeds(seed: int):
    rng = random.Random(seed)
    return [(rng.randrange(3), rng.choice(_TEXTS),
             rng.choice(["stdout", "stderr"]), rng.random() < 0.3)
            for _ in range(60)]


def _render(mod, feeds):
    out = []
    d = mod.StreamDisplay(print_fn=out.append)
    drained = []
    for rank, text, stream, drain in feeds:
        d.feed(rank, {"text": text, "stream": stream})
        if drain:
            drained.append(d.drain())
    drained.append(d.drain())
    d.finalize()
    return out, drained, d.error_chunks()


@pytest.mark.parametrize("seed", range(4))
def test_stream_display_renders_as_in_jax(seed):
    assert _render(port_display, _feeds(seed)) == \
        _render(jax_display, _feeds(seed))


def test_rank_errors_print_as_in_jax():
    replies = {2: {"error": "boom", "traceback": "Traceback\n  x\n"},
               0: {"output": "1"}, 1: {"error": "no tb"},
               3: {"error": "tb no newline", "traceback": "Trace"}}
    got, want = [], []
    n_port = port_display.print_rank_errors(
        {r: PortMessage("response", d, rank=r) for r, d in replies.items()},
        print_fn=got.append)
    n_jax = jax_display.print_rank_errors(
        {r: JaxMessage("response", d, rank=r) for r, d in replies.items()},
        print_fn=want.append)
    assert (n_port, got) == (n_jax, want) and n_port == 3


# -- timeline -----------------------------------------------------------

def _timeline_run(mod, monkeypatch, tmp_path):
    clock = iter([100.0 + 0.25 * i for i in range(100)])
    monkeypatch.setattr(mod.time, "time", lambda: next(clock))
    tl = mod.Timeline()
    rec = tl.start("x = rank\nx", [0, 1])
    tl.finish(rec, {0: PortMessage("response", {"duration_s": 0.0123456789,
                                                "output": "0"}),
                    1: {"duration_s": 0.5, "error": "bad"}})
    tl.record_local("%dist_status", 99.5, 0.125)
    tl.record_local("1/0", 99.75, 0.0625, ok=False)
    rec = tl.start("%%rank [1]\n'one'", [1], kind="rank")
    rec.trace_id, rec.span_id = "t1", "s1"
    tl.finish(rec, None)
    path = tmp_path / f"{mod.__name__}.json"
    n = tl.save(str(path))
    return (tl.summary(), tl.debug_dump(), json.dumps(tl.payload()), n,
            json.loads(path.read_text()), mod.Timeline().summary())


def test_timeline_records_as_in_jax(monkeypatch, tmp_path):
    got = _timeline_run(port_timeline, monkeypatch, tmp_path)
    want = _timeline_run(jax_timeline, monkeypatch, tmp_path)
    assert got == want


# -- IDE proxies --------------------------------------------------------

_INFO_1 = {
    "w": {"kind": "array", "shape": [5, 6], "dtype": "float32",
          "sharding": None, "device": "cpu"},
    "h": {"kind": "array", "shape": [3], "dtype": "int64",
          "sharding": None, "device": "host"},
    "n": {"kind": "scalar", "type": "int", "repr": "42"},
    "s": {"kind": "scalar", "type": "str", "repr": "'hi'"},
    "f": {"kind": "callable", "signature": "(a, b=1)", "doc": "adds",
          "name": "f"},
    "Net": {"kind": "class", "name": "Net", "module": "models"},
    "xs": {"kind": "container", "type": "list", "len": 7},
    "obj": {"kind": "object", "type": "Thing", "repr": "<Thing 3>"},
    "json": {"kind": "module", "name": "json"},
    "ghost": {"kind": "module", "name": "no_such_module_xyz"},
    "mine": {"kind": "scalar", "type": "int", "repr": "1"},
    "rank": {"kind": "scalar", "type": "int", "repr": "0"},
    "world_size": {"kind": "scalar", "type": "int", "repr": "2"},
    "np": {"kind": "module", "name": "numpy"},
    "dist": {"kind": "module", "name": "json"},
    "_private": {"kind": "scalar", "type": "int", "repr": "3"},
}
# The second sync: ``n`` was re-bound by the user meanwhile, ``xs`` is
# gone from the workers, ``w`` changed shape.
_INFO_2 = {k: v for k, v in _INFO_1.items() if k != "xs"}
_INFO_2["w"] = {"kind": "array", "shape": [2], "dtype": "float64",
                "sharding": None, "device": "cpu"}


def _describe(value):
    """A proxy as a comparable record (an array proxy by its shape and
    dtype: a meta tensor in the port, a ShapeDtypeStruct in JAX)."""
    if hasattr(value, "shape") and hasattr(value, "dtype"):
        return ("array", tuple(value.shape),
                str(value.dtype).removeprefix("torch."))
    if callable(value) and not isinstance(value, type):
        return ("callable", value.__name__, value.__doc__)
    if isinstance(value, type):
        return ("class", value.__name__, value.__module__)
    if type(value).__name__ == "module":
        return ("module", value.__name__)
    if type(value).__name__ == "_ObjectProxy":
        return ("object", repr(value))
    return ("value", value)


def _sync_run(mod):
    user_ns = {"mine": "precious"}
    reg = {}
    counts = [mod.sync_namespace(user_ns, _INFO_1, reg)]
    first = {k: _describe(v) for k, v in user_ns.items()}
    user_ns["n"] = 7
    counts.append(mod.sync_namespace(user_ns, _INFO_2, reg))
    second = {k: _describe(v) for k, v in user_ns.items()}
    owned = sorted(reg)
    mod.remove_proxies(user_ns, reg)
    return counts, first, second, owned, sorted(user_ns), reg


def test_sync_namespace_as_in_jax():
    got, want = _sync_run(port_proxies), _sync_run(jax_proxies)
    assert got == want
    assert got[1]["mine"] == ("value", "precious")
    assert got[4] == ["mine", "n"]


def test_array_proxy_is_a_meta_tensor():
    p, ok = port_proxies.make_proxy("w", {"kind": "array", "shape": [4, 2],
                                          "dtype": "bfloat16"})
    assert ok and p.device.type == "meta" and p.dtype == torch.bfloat16
    assert tuple(p.shape) == (4, 2)
    p, ok = port_proxies.make_proxy("b", {"kind": "array", "shape": [3],
                                          "dtype": "bool"})
    assert ok and p.dtype == torch.bool


def _future_run(mod):
    out = []
    f = mod.CellFuture("x = 1", 3, [0, 1])
    out.append((repr(f), f.done, f.consumed))
    out.append(f.resolve({0: {"output": "1\n2"}, 1: {"output": ""}}))
    out.append(f.reject(RuntimeError("late")))
    out.append((repr(f), f.state, f.result(), f.consumed))
    g = mod.CellFuture("boom", 4, [1])
    g.resolve({1: {"error": "bad"}, 0: {"output": "ok"}})
    out.append((g.state, str(g.error), g.consumed))
    out.append(repr(g))
    with pytest.raises(RuntimeError) as e:
        g.raise_if_error()
    out.append(str(e.value))
    h = mod.CellFuture("t", 5, [0])
    with pytest.raises(TimeoutError) as e:
        h.result(timeout=0)
    out.append(str(e.value))
    return out


def test_cell_future_as_in_jax():
    assert _future_run(port_proxies) == _future_run(jax_proxies)


# -- the notebook save hook --------------------------------------------

def _hook_cases(tmp_path):
    nb = tmp_path / "nb.ipynb"
    nb.write_text("{}")
    sub = tmp_path / "root" / "sub"
    sub.mkdir(parents=True, exist_ok=True)
    (sub / "deep.ipynb").write_text("{}")
    payload = {"version": 1, "records": [{"index": 0, "code": "x"}]}
    for path in (str(nb), str(sub / "deep.ipynb")):
        with open(path + port_hooks.SIDECAR_SUFFIX, "w") as f:
            json.dump(payload, f)
    bad = tmp_path / "bad.ipynb"
    with open(str(bad) + port_hooks.SIDECAR_SUFFIX, "w") as f:
        f.write("{not json")
    norec = tmp_path / "norec.ipynb"
    with open(str(norec) + port_hooks.SIDECAR_SUFFIX, "w") as f:
        json.dump({"version": 1}, f)

    class CM:
        def _get_os_path(self, path):
            return str(tmp_path / "root" / path)

    def model():
        return {"type": "notebook",
                "content": {"metadata": {"kernelspec": {"name": "py"}},
                            "cells": []}}

    return [dict(model=model(), path=str(nb)),
            dict(model=model(), path=str(tmp_path / "none.ipynb")),
            dict(model=model(), path=str(bad)),
            dict(model=model(), path=str(norec)),
            dict(model={"type": "file", "content": "x"}, path=str(nb)),
            dict(model={"type": "notebook", "content": None},
                 path=str(nb)),
            dict(model=None, path=str(nb)),
            dict(model=model(), path="sub/deep.ipynb",
                 contents_manager=CM())]


def test_pre_save_hook_as_in_jax(tmp_path):
    got = _hook_cases(tmp_path)
    want = _hook_cases(tmp_path)
    for case in got:
        port_hooks.pre_save_hook(**case)
    for case in want:
        jax_hooks.pre_save_hook(**case)
    assert [c["model"] for c in got] == [c["model"] for c in want]
    assert got[0]["model"]["content"]["metadata"]["execution_timelines"]
    assert got[7]["model"]["content"]["metadata"]["execution_timelines"]
    assert "execution_timelines" not in \
        got[2]["model"]["content"]["metadata"]
    assert port_hooks.sidecar_path("a/b.ipynb") == \
        jax_hooks.sidecar_path("a/b.ipynb")
    assert port_hooks.METADATA_KEY == jax_hooks.METADATA_KEY


# -- argument splitting -------------------------------------------------

@pytest.mark.parametrize("line", [
    "-n 2 --backend cpu -t 120", "", "  x   y  ",
    "--until 'loss < 0.1'", "--until \"phase == 'done'\"",
    "--agents \"h=1.2.3.4:5,g=6.7.8.9:1\"", "a#b c", "path/with spaces",
    "name --as 'x y'", "-- --x"])
def test_arg_split_is_ipythons(line):
    from IPython.utils._process_common import arg_split
    assert port_magic.arg_split(line) == arg_split(line)


def test_magic_options_parse_as_ipython_parses_them():
    """Every magic's parser reads the JAX decorators' lines to the same
    values, on the options the two share."""
    from nbdistributed_tpu.magics.magic import DistributedMagics as Jax
    from IPython.core.magic_arguments import parse_argstring
    cases = [("dist_pull", "pull_me --rank 1 --as pulled --readonly"),
             ("dist_push", "pushed --ranks [0,1]"),
             ("dist_checkpoint", "/tmp/ck a b --background"),
             ("dist_restore", "/tmp/ck a --ship /tmp/local"),
             ("dist_logs", "--ranks [1] -n 5"),
             ("dist_mode", "-d"), ("dist_interrupt", "--ranks [0]"),
             ("timeline_save", "tl.json"),
             ("distributed", "--repeat 3 --until 'loss < 0.1'"),
             ("distributed", "--strict --async"),
             ("distributed", "--sync"),
             ("dist_lint", "deps --dot"), ("dist_lint", ""),
             ("dist_wait", "--timeout 5"),
             ("dist_chaos", "on --drop 0.1 --seed 7 --side worker "
                            "--kill-rank 1 --kill-at 3 --corrupt 'wq' "
                            "--corrupt-rank 0 --corrupt-mode scale "
                            "--link-hosts 'a,b' --link-loss 0.5 "
                            "--freeze-heartbeats --delay-p 0.2"),
             ("dist_chaos", "off"),
             ("dist_profile", "start --log-dir /tmp/p"),
             ("dist_trace", "save t.json"), ("dist_trace", ""),
             ("dist_metrics", "--prom --save m.json"),
             ("dist_lat", "--last 3 --save l.json"),
             ("dist_serve", "start --spec SPEC --tenant srv --max-batch 8 "
                            "--max-len 1024 --decode-ranks 2 "
                            "--kv-block-tokens 16 --kv-blocks 64 "
                            "--prefill-chunk 32 --kv-quantized --steps 4 "
                            "--queue-depth 3 --inflight 2 --eos 2"),
             ("dist_serve", "submit --prompt 1,2,3 --max-new 32 --wait "
                            "--priority 2"),
             ("dist_serve", "stream --rid r3 --from 7"),
             ("dist_serve", "lat --last 4"), ("dist_serve", "")]
    for name, line in cases:
        got = vars(port_magic._parse(name, line))
        want = vars(parse_argstring(getattr(Jax, name), line))
        assert got == {k: want[k] for k in got}, name
    with pytest.raises(port_magic.UsageError, match="unrecognized"):
        port_magic._parse("distributed", "--bogus")


def test_memory_totals_as_in_jax():
    """``%dist_top``'s per-rank memory sum and the trajectory peaks
    (``observability/telemetry.py``) read snapshots as the JAX
    package's do."""
    from nbdistributed_tpu.observability import telemetry as jax_tel
    from nbdistributed_tpu_torch.observability import telemetry as tel
    snaps = [None, {}, {"hbm": []},
             {"hbm": [{"id": 0, "in_use": 5, "peak": 9, "limit": 80}]},
             {"hbm": [{"id": 0, "in_use": 7, "peak": None, "limit": 80},
                      {"id": 1, "in_use": 2, "peak": 3, "limit": None}]}]
    for snap in snaps:
        assert tel.hbm_totals(snap) == jax_tel.hbm_totals(snap)
    assert tel.peak_hbm(snaps) == jax_tel.peak_hbm(snaps) == \
        {"0": 9, "1": 3}


def test_pool_migrate_options_parse_as_in_jax():
    from nbdistributed_tpu.magics.magic import DistributedMagics as Jax
    from IPython.core.magic_arguments import parse_argstring
    for line in ("migrate --tenant alice --to /tmp/b --force",
                 "migrate --tenant bob", "status --run-dir /tmp/a"):
        got = vars(port_magic._parse("dist_pool", line))
        want = vars(parse_argstring(Jax.dist_pool, line))
        # The one difference by design: a pool's ranks default to the
        # GPU, never to the CPU unasked.
        assert got.pop("backend") == "gpu"
        assert got == {k: want[k] for k in got}


def _serving_status(serving, run_dir):
    """A real ``ServingManager``'s status after a few served requests,
    over the fake comm of ``tests/unit/test_serving_plane.py``."""
    import jax_unit_cases
    pkg = ("torch" if serving.__name__.startswith("nbdistributed_tpu_torch")
           else "jax")
    comm = jax_unit_cases.load("test_serving_plane.py", pkg)["FakeComm"](
        num_workers=2, per_tick=2)
    clock = iter(range(10 ** 6))
    mgr = serving.ServingManager(
        comm, run_dir, world_size=2, max_batch=2, max_len=64, steps=2,
        step_timeout=5.0, queue_depth=4, inflight=4, decode_ranks=2,
        kv_block_tokens=8)
    mgr.obs._now = lambda: float(next(clock))
    for i in range(3):
        mgr.submit(f"t{i % 2}", [i + 1, 5, 9], 4)
    for _ in range(6):
        mgr._tick()
    st = {"status": "serving", **mgr.describe()}
    mgr.stop(close_workers=False)
    return st


def test_serve_status_and_lat_render_as_in_jax(tmp_path, capsys):
    """``%dist_serve status`` and ``lat`` print the same lines from the
    same status payload as the JAX magics do."""
    from nbdistributed_tpu.gateway import serving as jax_serving
    from nbdistributed_tpu.magics.magic import DistributedMagics as Jax
    from nbdistributed_tpu_torch.gateway import serving as port_serving
    (tmp_path / "a").mkdir()
    st = _serving_status(port_serving, str(tmp_path / "a"))
    (tmp_path / "b").mkdir()
    st_j = _serving_status(jax_serving, str(tmp_path / "b"))
    assert st["completed"] == st_j["completed"] == 3
    for render in ("_render_serve_status", "_render_serve_lat"):
        arg = st if render == "_render_serve_status" else st["lat"]
        kw = {} if render == "_render_serve_status" else {"last": 2}
        getattr(Jax, render)(arg, **kw)
        want = capsys.readouterr().out
        getattr(port_magic.DistributedMagics, render)(arg, **kw)
        got = capsys.readouterr().out
        assert got == want and got.strip()
    assert "serving[serve]" in want or "stage" in want
