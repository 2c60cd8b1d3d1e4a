"""The port's cell vetting (``nbdistributed_tpu_torch/analysis``) against
the JAX package's (``nbdistributed_tpu/analysis``).

A corpus of cells written in the vocabulary both packages share (the
bare functional collectives, ``dist.all_reduce/broadcast/barrier/...``,
``rank``, ``if``/``for``/``return``, ``.item()``/``.tolist()``, ``np``)
goes through both ``vet_cell``s, in the whole world and on a subset,
and both ``infer_effects``: the findings (rule, severity, line, column,
text) and the effect reports must be equal.  The cases mirror
``tests/unit/test_analysis.py``.

Then each adaptation to torch gets its own test: torch's collective
spellings, ``logits.gather`` and ``torch.gather`` not collectives,
``dist.get_rank()`` and ``gpu_id`` rank-dependent, ``.cpu()`` and
``torch.cuda.synchronize()`` host syncs, ``torch`` a safe module but
``torch.distributed`` not, and ``FRAMEWORK_NAMES`` a subset of what the
port worker seeds.
"""

import pytest
import torch

from nbdistributed_tpu import analysis as jax_analysis
from nbdistributed_tpu.analysis import effects as jax_effects
from nbdistributed_tpu.analysis import preflight as jax_preflight
from nbdistributed_tpu_torch import analysis
from nbdistributed_tpu_torch.analysis import cellcheck, effects, preflight

# (id, cell): every cell in the shared vocabulary.
CORPUS = [
    ("hang_cell", "a = all_reduce(np.ones(2))\n"
                  "if rank == 1:\n"
                  "    b = all_reduce(a)\n"
                  "'done-%d' % rank\n"),
    ("rank_if_dist", "if rank == 0:\n    dist.all_reduce(t)\n"),
    ("rank_while", "while rank < 1:\n    x = all_reduce(x)"),
    ("rank_ternary", "x = all_reduce(y) if rank == 0 else y"),
    ("rank_in_def_return", "def step():\n"
                           "    if rank == 0:\n"
                           "        return all_reduce(x)"),
    ("match_rank", "match rank:\n    case 0:\n        all_reduce(x)\n"
                   "    case _:\n        pass\n"),
    ("match_guard", "match mode:\n    case 'a' if rank == 0:\n"
                    "        barrier()\n"),
    ("match_uniform", "match mode:\n    case 'a':\n"
                      "        x = all_reduce(x)\n"),
    ("match_exit", "match rank:\n    case 0:\n"
                   "        raise ValueError('x')\n"
                   "y = all_reduce(x)\n"),
    ("uniform_if", "if step % 10 == 0:\n    x = all_reduce(x)"),
    ("collective_then_rank_print",
     "x = all_reduce(x)\nif rank == 0:\n    print('saved')"),
    ("rank_def_definition", "if rank == 0:\n"
                            "    def helper():\n"
                            "        return all_reduce(x)"),
    ("raise_before", "if rank == 0:\n    raise ValueError('x')\n"
                     "y = all_reduce(x)"),
    ("raise_after", "x = all_reduce(x)\nif rank == 0:\n"
                    "    raise ValueError(str(x))"),
    ("break_for", "for i in range(5):\n    if rank == 1:\n"
                  "        break\n    x = all_reduce(x)"),
    ("break_while", "while step < 10:\n    g = all_reduce(g)\n"
                    "    if rank == 0:\n        break"),
    ("continue_for_broadcast",
     "for i in range(3):\n    if rank == 0:\n        continue\n"
     "    dist.broadcast(t, 0)"),
    ("break_uniform", "for i in range(5):\n    if done:\n"
                      "        break\n    x = all_reduce(x)"),
    ("plain_collective", "y = all_reduce(x)"),
    ("bare_reference", "alias = all_reduce"),
    ("collective_in_def", "def f():\n    return all_reduce(x)"),
    ("dist_gather_rank", "if rank == 0:\n    dist.gather(t)"),
    ("dist_barrier", "dist.barrier()"),
    ("item_loop", "for i in range(10):\n    tot += loss.item()"),
    ("print_loop", "for i in range(3):\n    print(loss)"),
    ("tolist_loop", "for i in range(3):\n    vals = x.tolist()"),
    ("sync_outside_loop", "tot = loss.item()\nprint(loss)"),
    ("constant_print_loop", "for i in range(3):\n    print('step')"),
    ("comprehension_item", "xs = [v.item() for v in vals]"),
    ("shadow_rank", "rank = 5"),
    ("shadow_world_size", "world_size = 4"),
    ("del_collective", "del all_reduce"),
    ("import_shadow", "from mymod import rank"),
    ("def_shadow", "def all_reduce():\n    pass"),
    ("loop_shadow", "for rank in range(3):\n    pass"),
    ("reimport_np", "import numpy as np"),
    ("attribute_writes", "cfg.rank = 3\nstate['rank'] = 4"),
    ("unparseable", "def f(:"),
    ("ipython_lines", "%time x = 1\n!pip list\n"
                      "y = all_reduce(x) if rank==0 else 2"),
    ("nested_cell_magic", "%%time\nif rank == 0:\n    dist.barrier()\n"),
    ("non_python_cell_magic", "%%bash\necho hi\n"),
    ("exec", "exec('x=1')"),
    ("eval", "y = eval(s)"),
    ("globals_write", "globals()['q'] = 7"),
    ("vars_update", "vars().update(d)"),
    ("np_free", "x = np.ones(3)\ny = x * 2"),
    ("stdlib_free", "import math\nr = math.sqrt(2)\n"
                    "from math import sqrt\nq = sqrt(2)"),
    ("same_cell_def", "def g(v):\n    return all_reduce(v)\nz = g(x)"),
    ("nested_def_call", "def g(v):\n    return h(v)\nz = g(x)"),
    ("def_escapes", "def step(v):\n    return all_reduce(v)\n"
                    "out = list(map(step, data))"),
    ("lambda_assign", "f = lambda v: broadcast(v)\ny = f(x)"),
    ("ordered_sites", "x = all_reduce(x)\nb = broadcast(x)\nbarrier()"),
    ("loop_sites", "for i in range(4):\n    x = all_reduce(x)"),
    ("mutations", "history.append(loss)\nstate['k'] = 1\ndel tmp"),
    ("global_escape", "def f():\n    global counter\n    counter = 2\nf()"),
    ("rebound_builtin", "sum = 3\ny = sum([1])"),
    ("decorator", "@my_decorator\ndef f():\n    pass"),
    ("builtin_decorator", "@staticmethod\ndef f():\n    pass"),
    ("gather_then_tolist", "x = all_gather(y)\nprint(x.tolist())"),
    ("top_level_await", "await dist.barrier()"),
]

SUBSET = dict(ranks=[0], world=2)


def _findings(res):
    return [(f.rule, f.severity, f.line, f.col, f.message, f.snippet)
            for f in res.findings]


@pytest.mark.parametrize("cell", [c for _, c in CORPUS],
                         ids=[i for i, _ in CORPUS])
def test_shared_vocabulary_vets_and_infers_as_jax(cell):
    for ctx in ({}, SUBSET):
        want = jax_analysis.vet_cell(cell, **ctx)
        got = analysis.vet_cell(cell, **ctx)
        assert got.parsed == want.parsed
        assert _findings(got) == _findings(want), ctx
    want = jax_analysis.infer_effects(cell)
    got = analysis.infer_effects(cell)
    assert got.as_dict() == want.as_dict()
    assert (analysis.collective_class(got)
            == jax_analysis.collective_class(want))
    assert (effects.ambient_poison(got) - {"torch"}
            == jax_effects.ambient_poison(want) - {"jnp"})


def test_corpus_covers_every_rule_and_verdict():
    """The corpus is not vacuous: between its two contexts it raises
    every rule, and its reports carry every verdict and opacity."""
    rules, verdicts, opaque = set(), set(), False
    for _, cell in CORPUS:
        for ctx in ({}, SUBSET):
            rules |= {f.rule for f in analysis.vet_cell(cell, **ctx)
                      .findings}
        rep = analysis.infer_effects(cell)
        verdicts.add(rep.collective_verdict)
        opaque = opaque or rep.opaque
    assert rules == {"rank-conditional-collective", "subset-collective",
                     "subset-collective-ref", "rank-conditional-exit",
                     "host-sync-in-loop", "namespace-shadow"}
    assert verdicts == {"none", "exact", "unknown"} and opaque
    assert len(CORPUS) >= 30


def test_ipython_stripping_is_the_jax_packages():
    for _, cell in CORPUS:
        assert (analysis.strip_ipython(cell)
                == jax_analysis.strip_ipython(cell))


def test_session_dag_is_the_jax_packages():
    """The same footprints recorded in both preflight stores draw the
    same dependency DAG (RAW/WAR/WAW and opaque edges)."""
    preflight.clear()
    jax_preflight.clear()
    try:
        for i, (_, cell) in enumerate(CORPUS):
            preflight.note_effects(f"c{i}", analysis.infer_effects(cell))
            jax_preflight.note_effects(f"c{i}",
                                       jax_analysis.infer_effects(cell))
        got, want = preflight.deps_dag(), jax_preflight.deps_dag()
        assert got["edges"] == want["edges"] and got["edges"]
        assert preflight.dag_to_dot(got) == jax_preflight.dag_to_dot(want)
    finally:
        preflight.clear()
        jax_preflight.clear()


def test_preflight_note_and_lookup():
    preflight.clear()
    try:
        res = analysis.vet_cell("if rank == 0:\n    dist.barrier()")
        preflight.note("abc", res.findings)
        entry = preflight.lookup("abc")
        assert entry["rules"] == ["rank-conditional-collective"]
        assert entry["errors"] == 1 and "L2" in entry["summary"]
        assert preflight.lookup(None) is None
    finally:
        preflight.clear()


# ----------------------------------------------------------------------
# the torch vocabulary: one test for each adaptation


def _errors(cell, **ctx):
    return [f.rule for f in analysis.vet_cell(cell, **ctx).errors]


@pytest.mark.parametrize("call", [
    "dist.all_gather_into_tensor(out, t)",
    "dist.reduce_scatter_tensor(out, t)",
    "dist.all_to_all_single(out, t)",
    "dist.all_gather_object(objs, o)",
    "dist.broadcast_object_list(objs, 0)",
    "dist.gather_object(o, objs)",
    "dist.scatter_object_list(out, objs)",
    "dist.batch_isend_irecv(ops)",
    "dist.monitored_barrier()",
    "dist.send(t, 1)",
    "torch.distributed.irecv(t, 0)",
    "all_to_all_single(out, t)",
])
def test_torch_collective_spellings_count(call):
    """torch.distributed's own spellings are collectives in the port:
    under a rank branch they are errors, and their sites are exact."""
    cell = f"if rank == 0:\n    {call}\n"
    assert _errors(cell) == ["rank-conditional-collective"]
    rep = analysis.infer_effects(call)
    op = call.split("(")[0].split(".")[-1]
    assert [s.op for s in rep.collectives] == [op]
    assert rep.collective_verdict == "exact"


@pytest.mark.parametrize("cell", [
    "if rank == 0:\n    sock.send(b'x')",
    "if rank == 0:\n    q.recv()",
    "if rank == 0:\n    send(t, 1)",
])
def test_point_to_point_only_through_a_dist_root(cell):
    """``.send``/``.recv`` of a socket or a queue, and a bare ``send``
    (none is seeded), are not collectives."""
    assert _errors(cell) == []
    assert not analysis.infer_effects(cell).collectives


@pytest.mark.parametrize("cell", [
    "y = logits.gather(-1, labels)",
    "y = torch.gather(a, 0, idx)",
    "y = torch.scatter(a, 0, idx, b)",
    "y = functools.reduce(f, xs)",
    "y = torch.cuda.comm.broadcast(t, [0, 1])",
])
def test_tensor_and_torch_compute_are_not_collectives(cell):
    """A loss cell's ``logits.gather(-1, labels)``, ``torch.gather``
    and the other ``torch.``-rooted calls are compute: no finding under
    a rank branch or on a subset, and no collective site (the JAX
    package counts any attribute of these names)."""
    branch = "if rank == 0:\n    " + cell
    assert analysis.vet_cell(branch).findings == []
    assert analysis.vet_cell(cell, **SUBSET).findings == []
    rep = analysis.infer_effects(cell)
    assert not rep.collectives and rep.collective_verdict != "exact"
    if cell.startswith("y = logits"):
        # The documented difference from the JAX package.
        assert jax_analysis.vet_cell(branch).errors
        assert jax_analysis.infer_effects(cell).collective_verdict == \
            "exact"
    if cell.startswith("y = torch.gather"):
        assert rep.collective_verdict == "none"


@pytest.mark.parametrize("cell", [
    "if dist.get_rank() == 0:\n    dist.barrier()",
    "if gpu_id == 0:\n    barrier()",
    "x = broadcast(t) if torch.distributed.get_rank() else t",
])
def test_get_rank_and_gpu_id_are_rank_dependent(cell):
    """``dist.get_rank()`` is the torch counterpart of
    ``jax.process_index()``, and ``gpu_id`` differs by rank."""
    assert _errors(cell) == ["rank-conditional-collective"]
    assert not jax_analysis.vet_cell(cell).errors


@pytest.mark.parametrize("cell,verdict", [
    ("for i in range(3):\n    torch.cuda.synchronize()", "none"),
    ("for i in range(3):\n    v = loss.cpu()", "unknown"),
    ("for i in range(3):\n    v = loss.item()", "unknown"),
])
def test_torch_host_syncs_in_loops(cell, verdict):
    """``.cpu()`` and ``torch.cuda.synchronize()`` are host syncs; a
    synchronize is inert for the collective verdict, a tensor's
    ``.cpu()``/``.item()`` keeps the JAX package's conservative taint
    (a port tensor is rank-local, but the analyzer does not prove
    more than the JAX one)."""
    assert [f.rule for f in analysis.vet_cell(cell).findings] == \
        ["host-sync-in-loop"]
    rep = analysis.infer_effects(cell)
    assert rep.host_sync_in_loop and rep.collective_verdict == verdict
    assert "block_until_ready" not in cellcheck.HOST_SYNC_ATTRS


@pytest.mark.parametrize("cell,cls", [
    ("z = torch.randn(3, device=device) * 2", "free"),
    ("free_a = torch.full((4,), 2.0, device=device)", "free"),
    ("import torch.nn.functional as F\nq = F.relu(z)", "free"),
    ("from torch.nn import functional as F\nq = F.relu(z)", "free"),
    ("from torch import randn\nq = randn(3)", "free"),
    ("torch.distributed.new_group([0])", "unknown"),
    ("import torch.distributed as d2\nd2.new_group([0])", "unknown"),
    ("from torch import distributed\ndistributed.new_group([0])",
     "unknown"),
    ("m = torch.nn.parallel.DistributedDataParallel(model)", "unknown"),
    ("torch.cuda.nccl.all_reduce(ts)", "unknown"),
    ("torch.distributed.all_reduce(t)", "bearing"),
])
def test_torch_is_safe_but_not_its_distributed_packages(cell, cls):
    """``torch`` is a safe module root, so a compute cell is PROVEN
    collective-free (the async window may overlap it); under
    ``torch.distributed``, ``torch.nn.parallel`` and
    ``torch.cuda.nccl`` nothing is."""
    assert analysis.collective_class(analysis.infer_effects(cell)) == cls


def test_torch_cell_is_unknown_in_the_jax_package():
    """Why the safe root matters: the JAX package treats ``torch`` as
    an unvetted root, so the same compute cell is never free there."""
    cell = "z = torch.randn(3, device=device) * 2"
    assert jax_analysis.collective_class(
        jax_analysis.infer_effects(cell)) == "unknown"


def test_framework_names_are_seeded_by_the_port_worker():
    from nbdistributed_tpu_torch.runtime import worker as pworker
    w = pworker.DistributedWorker.__new__(pworker.DistributedWorker)
    w.rank, w.world_size, w.backend, w.gpu_id = 0, 1, "cpu", None
    w.device, w.namespace = torch.device("cpu"), {}
    w._seed_namespace()
    assert analysis.FRAMEWORK_NAMES <= set(w.namespace)
    assert not analysis.FRAMEWORK_NAMES & {"jax", "jnp", "devices",
                                           "NamedSharding"}
    # Every seeded collective name is a collective.
    seeded = {n for n in w.namespace if n in analysis.COLLECTIVE_NAMES}
    assert seeded == {"all_reduce", "all_gather", "broadcast", "barrier",
                      "reduce_scatter", "all_reduce_quantized", "scatter",
                      "gather", "reduce"}


@pytest.mark.parametrize("cell,rules", [
    ("import torch\nimport torch.distributed as dist\n"
     "from torch import distributed as dist\nimport numpy as np", []),
    ("torch = 1", ["namespace-shadow"]),
    ("gpu_id = 3", ["namespace-shadow"]),
    ("import os as dist", ["namespace-shadow"]),
    ("torch.backends.cuda.matmul.allow_tf32 = False\n"
     "state[rank] = 1\ndel np.x", []),
    ("(a, [rank, *dist]) = f()", ["namespace-shadow"] * 2),
])
def test_torch_names_shadowing(cell, rules):
    """Re-importing the module a framework name is seeded with is the
    idiomatic no-op; binding anything else over ``torch``, ``dist`` or
    ``gpu_id`` shadows it.  An attribute or subscript target mutates
    an object and binds no name (the JAX package warns on the Names
    inside such a target)."""
    assert [f.rule for f in analysis.vet_cell(cell).findings] == rules
    if cell.startswith("torch.backends"):
        assert [f.rule for f in jax_analysis.vet_cell(cell).findings] \
            == ["namespace-shadow"] * 2
