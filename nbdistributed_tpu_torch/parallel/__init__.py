"""Parallel layers of the port (counterpart of
``nbdistributed_tpu/parallel``): named-axis meshes over the
``torch.distributed`` process group (:mod:`.mesh`), placing parameter
trees on them (:mod:`.tensor_parallel`), the mixture-of-experts layer
with its ``ep`` axis (:mod:`.expert`), and the functional collectives
(:mod:`.collectives`).  Ring, Ulysses, pipeline and the data-parallel
training families are ROADMAP A5 and A8."""

from .expert import (compute_capacity, init_moe_params, load_balance_loss,
                     make_dispatch, moe_ffn, moe_param_shardings,
                     sparse_slots, top_k_routing)
from .mesh import (Mesh, P, all_gather, axis_index, make_mesh, pmax, psum,
                   replicate, shard_batch)
from .tensor_parallel import apply_shardings, sharding_tree

__all__ = ["Mesh", "P", "all_gather", "apply_shardings", "axis_index",
           "compute_capacity", "init_moe_params", "load_balance_loss",
           "make_dispatch", "make_mesh", "moe_ffn", "moe_param_shardings",
           "pmax", "psum", "replicate", "shard_batch", "sharding_tree",
           "sparse_slots", "top_k_routing"]
