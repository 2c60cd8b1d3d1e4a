"""The training forwards cut the layer-stacked leaves once a forward
(``layer_slices``: one ``torch.unbind`` per stacked tensor), so the
backward assembles each stacked gradient once.  Held here against the
per-layer select they replace (``t[i]`` inside the layer loop, put back
by patching the cut), in float32 on the CPU: every stacked leaf's
gradient bitwise equal, for the dense forward with each remat setting,
the MoE forward and a pipeline stage; and the backward graph holds one
assembly node per stacked leaf and no per-layer select of one."""

import dataclasses

import pytest
import torch

from nbdistributed_tpu_torch.models import (init_params, loss_fn, moe,
                                            moe_loss_fn, pp, quant,
                                            tiny_config, tiny_moe_config,
                                            transformer)
from nbdistributed_tpu_torch.models.moe import init_moe_model

B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _per_layer_select(tree):
    """The replaced cut: layer i's tree as ``t[i]`` of every leaf, taken
    as the loop reaches layer i (so autograd orders each select's
    backward right after its layer's, as it did)."""
    first = tree
    while isinstance(first, dict):
        first = next(iter(first.values()))
    for i in range(first.shape[0]):
        yield transformer._slice_layer(tree, i)


def _select_path(monkeypatch):
    """Put the per-layer select back in every training forward."""
    monkeypatch.setattr(transformer, "layer_slices",
                        lambda params: _per_layer_select(params["layers"]))
    monkeypatch.setattr(moe, "layer_slices",
                        lambda params: _per_layer_select(params["layers"]))
    monkeypatch.setattr(pp, "_unbind_layers", _per_layer_select)


def _batch(seed=1):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(1, 512, (B, S), generator=g)
    segments = torch.cat([torch.zeros(B, S // 2, dtype=torch.long),
                          torch.ones(B, S - S // 2, dtype=torch.long)], 1)
    return {"tokens": tokens, "segments": segments}


def _leaves(params):
    return transformer.named_param_leaves(params["layers"], "layers/")


def _dense(remat, policy):
    cfg = tiny_config(dtype=torch.float32, remat=remat, remat_policy=policy)
    params = init_params(cfg, seed=3, device="cpu")
    return params, lambda p: loss_fn(p, _batch(), cfg)


def _moe():
    cfg = dataclasses.replace(tiny_moe_config(dtype=torch.float32),
                              moe_dispatch="dropless")
    params = init_moe_model(cfg, seed=4, device="cpu")
    return params, lambda p: moe_loss_fn(p, _batch(), cfg)


def _stage():
    """A pipeline stage over a two-layer stack (the stage's tree is the
    stacked ``layers``), its output reduced to a scalar."""
    cfg = tiny_config(dtype=torch.float32, n_layers=2)
    params = init_params(cfg, seed=5, device="cpu")
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(6))
    positions = torch.arange(S).expand(B, S)

    def loss(p):
        return (pp._stage_fn(cfg, positions)(p["layers"], x) ** 2).mean()

    return params, loss


CASES = {
    "dense": lambda: _dense(False, None),
    "dense_remat": lambda: _dense(True, None),
    "dense_dots": lambda: _dense(True, "dots"),
    "moe": _moe,
    "pp_stage": _stage,
}


def _grads(make, monkeypatch=None):
    if monkeypatch is not None:
        _select_path(monkeypatch)
    params, loss_of = make()
    for _, p in transformer.named_param_leaves(params):
        if p.is_floating_point():
            p.requires_grad_(True)
    loss_of(params).backward()
    return {name: p.grad for name, p in _leaves(params)
            if p.requires_grad}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stacked_grads_equal_the_per_layer_select_bitwise(case,
                                                          monkeypatch):
    got = _grads(CASES[case])
    with monkeypatch.context() as m:
        want = _grads(CASES[case], m)
    assert sorted(got) == sorted(want) and got
    for name in want:
        assert got[name] is not None and want[name] is not None, name
        assert torch.equal(got[name], want[name]), name


def _graph(root):
    seen, stack = set(), [root]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(fn for fn, _ in node.next_functions)
    return seen


@pytest.mark.parametrize("case", ["dense_remat", "moe", "pp_stage"])
def test_one_assembly_node_per_stacked_leaf_and_no_select(case):
    params, loss_of = CASES[case]()
    stacked = {id(p): name for name, p in _leaves(params)
               if p.is_floating_point()}
    for _, p in transformer.named_param_leaves(params):
        if p.is_floating_point():
            p.requires_grad_(True)
    nodes = _graph(loss_of(params).grad_fn)
    feeders = {}
    for node in nodes:
        for fn, _ in node.next_functions:
            var = getattr(fn, "variable", None)
            if var is not None and id(var) in stacked:
                feeders.setdefault(stacked[id(var)], []).append(node.name())
    assert sorted(feeders) == sorted(stacked.values())
    for name, names in feeders.items():
        assert names == ["UnbindBackward0"], (name, names)


TREES = {
    "dense": lambda: init_params(tiny_config(dtype=torch.float32), seed=7,
                                 device="cpu"),
    "int8": lambda: quant.quantize_params(TREES["dense"]()),
    "int4": lambda: quant.quantize_params4(TREES["dense"]()),
    "moe_int8": lambda: quant.quantize_moe_params(init_moe_model(
        tiny_moe_config(dtype=torch.float32), seed=8, device="cpu")),
}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_layer_slices_are_layer_params_views(tree):
    """Layer i of ``layer_slices`` holds ``layer_params(params, i)``'s
    leaves, quantized ``{"q8"|"q4", "s"}`` leaves and the ``moe`` group
    included, as views of the stacked tensors."""
    params = TREES[tree]()
    slices = transformer.layer_slices(params)
    L = tiny_config().n_layers
    assert len(slices) == L
    for i, layer in enumerate(slices):
        got = transformer.named_param_leaves(layer)
        want = transformer.named_param_leaves(
            transformer.layer_params(params, i))
        assert [n for n, _ in got] == [n for n, _ in want]
        for (name, a), (_, b) in zip(got, want):
            assert torch.equal(a, b) and a.dtype == b.dtype, (i, name)
            assert a.untyped_storage().data_ptr() == \
                b.untyped_storage().data_ptr(), (i, name)
