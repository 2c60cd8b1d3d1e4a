"""nbdistributed_tpu_torch: the PyTorch/CUDA port of ``nbdistributed_tpu``.

The JAX package beside this one is the reference.  This package carries
the serving and training slices of the model stack: the Llama-family
transformer with its loss, remat and AdamW train step
(:mod:`.models.transformer`), LoRA (:mod:`.models.lora`), the
chunked-vocab loss (:mod:`.ops.xent`), data sharding and packing
(:mod:`.utils.data`), KV-cache generation (:mod:`.models.generate`) and
the continuous-batching :class:`~.models.serving.DecodeServer`, with
the four TPU kernels on those paths (flash-attention forward, its dQ
and dK/dV backward, flash-decode) rewritten by hand in CUDA C++ for
Hopper (:mod:`.ops`).

It imports ``torch`` and never ``jax``.  Entry points run on the GPU
unless the caller passes ``device="cpu"``; on CPU tensors every kernel
wrapper takes its plain PyTorch version instead.
"""

__version__ = "0.1.0"
