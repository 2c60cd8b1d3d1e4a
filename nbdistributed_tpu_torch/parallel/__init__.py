"""Parallel layers of the port (counterpart of
``nbdistributed_tpu/parallel``): named-axis meshes over the
``torch.distributed`` process group (:mod:`.mesh`), placing parameter
trees on them (:mod:`.tensor_parallel`), the mixture-of-experts layer
with its ``ep`` axis (:mod:`.expert`), the functional collectives
(:mod:`.collectives`), and training on a mesh: the step
(:func:`.tensor_parallel.make_tp_train_step`), DDP (:mod:`.data_parallel`)
and ZeRO-1/2 (:mod:`.zero`); sequence parallelism: ring attention
(:mod:`.ring`), Ulysses (:mod:`.ulysses`) and the ring-decomposed
collective matmuls (:mod:`.overlap`); pipeline parallelism, GPipe and
1F1B over a ``pp`` axis (:mod:`.pipeline`); and :func:`.mesh.shard_map`."""

from .expert import (compute_capacity, init_moe_params, load_balance_loss,
                     make_dispatch, moe_ffn, moe_param_shardings,
                     sparse_slots, top_k_routing)
from .mesh import (Mesh, P, Posted, all_gather, axis_index, make_mesh, pmax,
                   psum, replicate, shard_batch, shard_map)
from .data_parallel import ddp_init, make_ddp_step
from .overlap import allgather_matmul, matmul_reducescatter, megatron_sp_block
from .pipeline import (make_pipeline_1f1b, make_pipeline_1f1b_full,
                       make_pipeline_loss, pipeline_forward,
                       shard_stage_params)
from .ring import (hop_plan, ring_attention, zigzag_order, zigzag_shard,
                   zigzag_unshard)
from .ulysses import ulysses_attention
from .tensor_parallel import (apply_shardings, make_tp_train_step,
                              sharding_tree)
from .zero import (make_zero1_train_step, make_zero2_train_step,
                   zero1_state_shardings, zero2_accum_rules)

__all__ = ["Mesh", "P", "Posted", "all_gather", "allgather_matmul",
           "apply_shardings", "axis_index", "compute_capacity", "ddp_init",
           "hop_plan", "init_moe_params", "load_balance_loss",
           "make_ddp_step", "make_dispatch", "make_mesh",
           "make_pipeline_1f1b", "make_pipeline_1f1b_full",
           "make_pipeline_loss",
           "make_tp_train_step", "make_zero1_train_step",
           "make_zero2_train_step", "matmul_reducescatter",
           "megatron_sp_block", "moe_ffn", "moe_param_shardings",
           "pipeline_forward", "pmax", "psum", "replicate",
           "ring_attention", "shard_batch", "shard_map",
           "shard_stage_params",
           "sharding_tree", "sparse_slots", "top_k_routing",
           "ulysses_attention", "zero1_state_shardings",
           "zero2_accum_rules", "zigzag_order", "zigzag_shard",
           "zigzag_unshard"]
