"""The port's HF interop (``nbdistributed_tpu_torch/models/hf.py``)
against the JAX package's (``nbdistributed_tpu/models/hf.py``) and
against ``transformers`` itself, on tiny random ``LlamaForCausalLM`` and
``MixtralForCausalLM`` models built in process (the shapes of
``tests/unit/test_hf.py``).

The converted parameters equal the JAX conversion's bit for bit in
float32 and bfloat16; the port's float32 forward matches HF's logits
within atol = rtol = 2e-4 (the JAX test's tolerance).
"""

import dataclasses
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from nbdistributed_tpu.models import hf as jhf
from nbdistributed_tpu_torch.models import forward, hf, moe_forward


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_hf_llama(tie=False, n_kv=2):
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=128, hidden_size=64,
                      intermediate_size=160, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=n_kv,
                      max_position_embeddings=256, rms_norm_eps=1e-5,
                      rope_theta=10000.0, tie_word_embeddings=tie,
                      attention_bias=False, mlp_bias=False)
    torch.manual_seed(0)
    return LlamaForCausalLM(cfg).eval()


def tiny_hf_mixtral():
    from transformers import MixtralConfig, MixtralForCausalLM
    torch.manual_seed(1)
    cfg = MixtralConfig(vocab_size=128, hidden_size=64,
                        intermediate_size=96, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2,
                        num_local_experts=4, num_experts_per_tok=2,
                        max_position_embeddings=128,
                        sliding_window=None, rope_theta=10000.0)
    return MixtralForCausalLM(cfg).eval()


_DTYPES = {"float32": (torch.float32, jnp.float32),
           "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _bits(leaf) -> np.ndarray:
    """A leaf's raw bits as unsigned integers (bf16 → uint16), from
    either package."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy().view(np.uint32)
    arr = np.asarray(leaf)
    return arr.view(np.uint16 if arr.dtype.itemsize == 2 else np.uint32)


def _assert_trees_bit_equal(port, ref, path=""):
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            _assert_trees_bit_equal(port[k], ref[k], f"{path}/{k}")
        return
    assert port.dtype == {"float32": torch.float32,
                          "bfloat16": torch.bfloat16}[str(ref.dtype)], path
    assert tuple(port.shape) == tuple(ref.shape), path
    np.testing.assert_array_equal(_bits(port), _bits(ref), err_msg=path)


def _cfg_fields(cfg) -> dict:
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k != "dtype"}


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("tie,n_kv", [(False, 2), (True, 2), (False, 1)])
def test_dense_params_bit_equal_jax(tie, n_kv, dtype):
    model = tiny_hf_llama(tie=tie, n_kv=n_kv)
    tdt, jdt = _DTYPES[dtype]
    got, cfg = hf.params_from_hf(model, dtype=tdt, device="cpu")
    want, jcfg = jhf.params_from_hf(model, dtype=jdt)
    _assert_trees_bit_equal(got, want)
    assert cfg.dtype == tdt and _cfg_fields(cfg) == _cfg_fields(jcfg)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_mixtral_params_bit_equal_jax(dtype):
    model = tiny_hf_mixtral()
    tdt, jdt = _DTYPES[dtype]
    got, cfg = hf.moe_params_from_hf(model, dtype=tdt, device="cpu")
    want, jcfg = jhf.moe_params_from_hf(model, dtype=jdt)
    _assert_trees_bit_equal(got, want)
    assert got["layers"]["moe"]["router"].dtype == torch.float32
    assert _cfg_fields(cfg) == _cfg_fields(jcfg)


@pytest.mark.parametrize("tie,n_kv", [(False, 2), (True, 2), (False, 1)])
def test_dense_forward_matches_hf(tie, n_kv):
    model = tiny_hf_llama(tie=tie, n_kv=n_kv)
    tokens = np.array([[3, 17, 94, 5, 62, 11], [88, 2, 45, 127, 0, 9]],
                      np.int64)
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens)).logits.numpy()
    params, cfg = hf.params_from_hf(model, dtype=torch.float32,
                                    device="cpu")
    with torch.no_grad():
        got = forward(params, torch.from_numpy(tokens), cfg).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)


def test_mixtral_forward_matches_hf():
    """Lossless capacity (the default): no token dropped, the routing
    math HF's (softmax -> top-k -> renormalize)."""
    model = tiny_hf_mixtral()
    tokens = np.array([[7, 3, 99, 12, 0, 64, 2]], np.int64)
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens)).logits.numpy()
    params, cfg = hf.moe_params_from_hf(model, dtype=torch.float32,
                                        device="cpu")
    with torch.no_grad():
        got, _aux = moe_forward(params, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("field,value,match", [
    ("rope_scaling", {"rope_type": "linear", "factor": 2.0},
     "rope_scaling"),
    ("attention_bias", True, "attention_bias"),
    ("mlp_bias", True, "mlp_bias"),
    ("head_dim", 32, "head_dim"),
])
def test_config_guards_raise_as_jax(field, value, match):
    model = tiny_hf_llama()
    setattr(model.config, field, value)
    with pytest.raises(ValueError, match=match):
        jhf.config_from_hf(model.config)
    with pytest.raises(ValueError, match=match):
        hf.config_from_hf(model.config)


def test_config_mapping_equals_jax():
    model = tiny_hf_llama()
    model.config.sliding_window = 64
    cfg = hf.config_from_hf(model.config)
    assert _cfg_fields(cfg) == _cfg_fields(jhf.config_from_hf(model.config))
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.sliding_window) == (64, 2, 4, 2, 64)


@pytest.mark.parametrize("rope_type,ok", [("default", True),
                                          ("linear", False)])
def test_config_reads_the_transformers5_rope_layout(rope_type, ok):
    """``transformers`` 5 configs carry the rotary base in
    ``rope_parameters`` and no ``rope_theta`` attribute (its
    ``rope_scaling`` mirrors the dict): the base is read from there,
    not defaulted, and a scaled type is refused as in 4.x."""
    c = tiny_hf_llama().config
    rope = {"rope_theta": 100000.0, "rope_type": rope_type}
    config = types.SimpleNamespace(
        vocab_size=c.vocab_size, hidden_size=c.hidden_size,
        num_hidden_layers=c.num_hidden_layers,
        num_attention_heads=c.num_attention_heads,
        num_key_value_heads=c.num_key_value_heads,
        intermediate_size=c.intermediate_size,
        max_position_embeddings=c.max_position_embeddings,
        rms_norm_eps=c.rms_norm_eps, rope_parameters=rope,
        rope_scaling=dict(rope))
    if not ok:
        with pytest.raises(ValueError, match="rope_scaling"):
            hf.config_from_hf(config)
        return
    assert hf.config_from_hf(config).rope_theta == 100000.0
    del config.rope_scaling
    assert hf.config_from_hf(config).rope_theta == 100000.0
    # The 4.x layout still maps as the JAX package maps it.
    c.rope_theta = 100000.0
    assert hf.config_from_hf(c).rope_theta == \
        jhf.config_from_hf(c).rope_theta == 100000.0


def test_moe_default_capacity_is_lossless():
    model = tiny_hf_mixtral()
    cfg = hf.moe_config_from_hf(model.config)
    assert cfg.capacity_factor == 4 / 2
    assert (cfg.capacity_factor
            == jhf.moe_config_from_hf(model.config).capacity_factor)
    assert hf.moe_config_from_hf(model.config,
                                 capacity_factor=1.25).capacity_factor == 1.25


def test_load_hf_pretrained_autodispatch(tmp_path):
    """Round-tripped through ``save_pretrained`` — the real
    ``from_pretrained`` path — Mixtral checkpoints take the MoE
    converter and Llama ones the dense converter, with the same
    parameters as converting the in-memory model."""
    mix = tiny_hf_mixtral()
    mix.save_pretrained(tmp_path / "mix")
    params, cfg = hf.load_hf_pretrained(str(tmp_path / "mix"),
                                        dtype=torch.float32, device="cpu")
    assert "moe" in params["layers"] and hasattr(cfg, "n_experts")
    want, _ = hf.moe_params_from_hf(mix, dtype=torch.float32, device="cpu")
    _assert_trees_bit_equal(params, jhf.moe_params_from_hf(
        mix, dtype=jnp.float32)[0])
    assert torch.equal(params["layers"]["moe"]["w_up"],
                       want["layers"]["moe"]["w_up"])

    dense = tiny_hf_llama()
    dense.save_pretrained(tmp_path / "dense")
    params, cfg = hf.load_hf_pretrained(str(tmp_path / "dense"),
                                        dtype=torch.float32, device="cpu")
    assert "w_gate" in params["layers"] and not hasattr(cfg, "n_experts")
    _assert_trees_bit_equal(params, jhf.params_from_hf(
        dense, dtype=jnp.float32)[0])


def test_stand_in_converts_without_transformers(monkeypatch):
    """Any object with ``.config`` and ``.state_dict()`` converts, with
    ``transformers`` unimportable (the card has none)."""
    model = tiny_hf_llama(n_kv=1)
    c = model.config
    config = types.SimpleNamespace(
        vocab_size=c.vocab_size, hidden_size=c.hidden_size,
        num_hidden_layers=c.num_hidden_layers,
        num_attention_heads=c.num_attention_heads,
        num_key_value_heads=c.num_key_value_heads,
        intermediate_size=c.intermediate_size,
        max_position_embeddings=c.max_position_embeddings,
        rope_theta=c.rope_theta, rms_norm_eps=c.rms_norm_eps)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    stand_in = types.SimpleNamespace(config=config, state_dict=lambda: sd)
    monkeypatch.setitem(sys.modules, "transformers", None)
    got, cfg = hf.params_from_hf(stand_in, dtype=torch.bfloat16,
                                 device="cpu")
    with pytest.raises(ImportError):
        hf.load_hf_pretrained("unused")
    monkeypatch.undo()
    want, _ = jhf.params_from_hf(model, dtype=jnp.bfloat16)
    _assert_trees_bit_equal(got, want)
    assert cfg.n_kv_heads == 1


def test_default_device_is_the_gpu():
    """Without ``device`` the conversion targets the GPU, and raises
    where there is none instead of landing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hf.params_from_hf(tiny_hf_llama())
