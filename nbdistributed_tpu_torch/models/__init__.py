"""The model stack of the serving and training slices: the Llama family
and the Mixtral-style MoE family, and pipeline-parallel training of the
Llama family (counterpart of ``nbdistributed_tpu/models``)."""

from .convert import (lora_from_jax, lora_to_numpy, params_from_jax,
                      params_to_numpy)
from .generate import (forward_with_cache, generate, init_kv_cache,
                       kv_cache_shardings, make_generate_fn, prefill_chunked,
                       truncate_logits)
from .hf import (config_from_hf, load_hf_pretrained, moe_config_from_hf,
                 moe_params_from_hf, params_from_hf)
from .lora import (ALL_TARGETS, ATTN_TARGETS, lora_init, lora_merge,
                   lora_num_params, lora_shardings, make_lora_train_step)
from .moe import (MoEConfig, init_moe_model, mixtral_8x7b_config,
                  moe_forward, moe_forward_hidden, moe_loss_fn,
                  moe_model_shardings, tiny_moe_config)
from .quant import (DEFAULT_TARGETS, EXPERT_TARGETS, dequantize_weight,
                    dequantize_weight4, quantization_error,
                    quantize_moe_params, quantize_params, quantize_params4,
                    quantize_weight, quantize_weight4,
                    quantized_moe_shardings, quantized_shardings,
                    quantized_shardings4)
from .pp import (make_pp_1f1b_train_step, make_pp_train_step,
                 pp_apply_shardings, pp_gather_params, pp_loss_fn,
                 pp_stage_params, pp_unstage_params)
from .serving import DecodeServer
from .speculative import speculative_generate
from .transformer import (AdamW, SeqParallel, TransformerConfig,
                          apply_optimizer_updates,
                          forward, forward_hidden, fsdp_param_shardings,
                          init_params,
                          llama2_7b_config, loss_fn, make_layer_fn,
                          make_train_step, mistral_7b_config,
                          named_param_leaves, num_tokens_per_step,
                          packed_positions, param_leaves, param_shardings,
                          qlinear,
                          shifted_xent, smol_135m_config, tiny_config,
                          tinyllama_1b_config)

__all__ = ["ALL_TARGETS", "ATTN_TARGETS", "AdamW", "DEFAULT_TARGETS",
           "DecodeServer", "EXPERT_TARGETS", "MoEConfig", "SeqParallel",
           "TransformerConfig", "apply_optimizer_updates", "config_from_hf",
           "dequantize_weight", "dequantize_weight4", "forward",
           "forward_hidden", "forward_with_cache", "fsdp_param_shardings",
           "generate",
           "init_kv_cache", "init_moe_model", "init_params",
           "kv_cache_shardings",
           "llama2_7b_config", "load_hf_pretrained", "lora_from_jax", "lora_init", "lora_merge",
           "lora_num_params", "lora_shardings", "lora_to_numpy", "loss_fn",
           "make_generate_fn",
           "make_layer_fn", "make_lora_train_step", "make_train_step",
           "mistral_7b_config", "mixtral_8x7b_config", "moe_config_from_hf",
           "moe_forward",
           "moe_forward_hidden", "moe_loss_fn", "moe_model_shardings",
           "moe_params_from_hf",
           "named_param_leaves",
           "num_tokens_per_step", "packed_positions", "param_leaves",
           "param_shardings",
           "params_from_hf", "params_from_jax", "params_to_numpy",
           "make_pp_1f1b_train_step", "make_pp_train_step",
           "pp_apply_shardings", "pp_gather_params", "pp_loss_fn",
           "pp_stage_params", "pp_unstage_params", "prefill_chunked",
           "qlinear", "quantization_error", "quantize_moe_params",
           "quantize_params", "quantize_params4", "quantize_weight",
           "quantize_weight4", "quantized_moe_shardings",
           "quantized_shardings", "quantized_shardings4", "shifted_xent",
           "smol_135m_config",
           "speculative_generate", "tiny_config", "tiny_moe_config",
           "tinyllama_1b_config", "truncate_logits"]
