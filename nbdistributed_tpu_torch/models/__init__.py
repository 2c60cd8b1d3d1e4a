"""The model stack of the serving and training slices: the Llama family
and the Mixtral-style MoE family (counterpart of
``nbdistributed_tpu/models``)."""

from .convert import (lora_from_jax, lora_to_numpy, params_from_jax,
                      params_to_numpy)
from .generate import (forward_with_cache, generate, init_kv_cache,
                       make_generate_fn, prefill_chunked, truncate_logits)
from .lora import (ALL_TARGETS, ATTN_TARGETS, lora_init, lora_merge,
                   lora_num_params, make_lora_train_step)
from .moe import (MoEConfig, init_moe_model, mixtral_8x7b_config,
                  moe_forward, moe_forward_hidden, moe_loss_fn,
                  tiny_moe_config)
from .quant import (DEFAULT_TARGETS, EXPERT_TARGETS, dequantize_weight,
                    dequantize_weight4, quantization_error,
                    quantize_moe_params, quantize_params, quantize_params4,
                    quantize_weight, quantize_weight4)
from .serving import DecodeServer
from .speculative import speculative_generate
from .transformer import (AdamW, TransformerConfig, apply_optimizer_updates,
                          forward, forward_hidden, init_params,
                          llama2_7b_config, loss_fn, make_layer_fn,
                          make_train_step, mistral_7b_config,
                          named_param_leaves, num_tokens_per_step,
                          packed_positions, param_leaves, qlinear,
                          shifted_xent, smol_135m_config, tiny_config,
                          tinyllama_1b_config)

__all__ = ["ALL_TARGETS", "ATTN_TARGETS", "AdamW", "DEFAULT_TARGETS",
           "DecodeServer", "EXPERT_TARGETS", "MoEConfig",
           "TransformerConfig", "apply_optimizer_updates",
           "dequantize_weight", "dequantize_weight4", "forward",
           "forward_hidden", "forward_with_cache", "generate",
           "init_kv_cache", "init_moe_model", "init_params",
           "llama2_7b_config", "lora_from_jax", "lora_init", "lora_merge",
           "lora_num_params", "lora_to_numpy", "loss_fn", "make_generate_fn",
           "make_layer_fn", "make_lora_train_step", "make_train_step",
           "mistral_7b_config", "mixtral_8x7b_config", "moe_forward",
           "moe_forward_hidden", "moe_loss_fn", "named_param_leaves",
           "num_tokens_per_step", "packed_positions", "param_leaves",
           "params_from_jax", "params_to_numpy", "prefill_chunked",
           "qlinear", "quantization_error", "quantize_moe_params",
           "quantize_params", "quantize_params4", "quantize_weight",
           "quantize_weight4", "shifted_xent", "smol_135m_config",
           "speculative_generate", "tiny_config", "tiny_moe_config",
           "tinyllama_1b_config", "truncate_logits"]
