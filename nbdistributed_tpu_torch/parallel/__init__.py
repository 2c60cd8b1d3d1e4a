"""Parallel layers of the port (counterpart of
``nbdistributed_tpu/parallel``): so far the mixture-of-experts layer on
one device; the mesh families wait for the process group (ROADMAP A5a)."""

from .expert import (compute_capacity, init_moe_params, load_balance_loss,
                     make_dispatch, moe_ffn, moe_param_shardings,
                     sparse_slots, top_k_routing)

__all__ = ["compute_capacity", "init_moe_params", "load_balance_loss",
           "make_dispatch", "moe_ffn", "moe_param_shardings",
           "sparse_slots", "top_k_routing"]
