"""The Llama-family model stack of the serving slice (counterpart of
``nbdistributed_tpu/models``)."""

from .convert import params_from_jax, params_to_numpy
from .generate import (forward_with_cache, generate, init_kv_cache,
                       truncate_logits)
from .quant import dequantize_weight, quantize_weight
from .serving import DecodeServer
from .transformer import (TransformerConfig, forward, forward_hidden,
                          init_params, llama2_7b_config,
                          mistral_7b_config, smol_135m_config,
                          tiny_config, tinyllama_1b_config)

__all__ = ["DecodeServer", "TransformerConfig", "dequantize_weight",
           "forward", "forward_hidden", "forward_with_cache", "generate",
           "init_kv_cache", "init_params", "llama2_7b_config",
           "mistral_7b_config", "params_from_jax", "params_to_numpy",
           "quantize_weight", "smol_135m_config", "tiny_config",
           "tinyllama_1b_config", "truncate_logits"]
