"""Compute ops: hand-written Hopper kernels with their plain PyTorch
versions (counterpart of ``nbdistributed_tpu/ops``)."""

from .attention import attention_reference, flash_attention
from .decode import decode_reference, flash_decode_attention

__all__ = ["attention_reference", "decode_reference", "flash_attention",
           "flash_decode_attention"]
