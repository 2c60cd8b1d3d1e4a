"""Data-parallel training (counterpart of
``nbdistributed_tpu/parallel/data_parallel.py``).

DDP is the all-replicated case of the one step on a mesh: every rank
holds the whole tree, runs its rows of the batch, and the step takes
the mean of the ranks' losses and gradients over ``dp``
(:func:`.tensor_parallel.make_tp_train_step` with no rules).
"""

from __future__ import annotations

from . import mesh as mesh_mod
from .tensor_parallel import make_tp_train_step


def make_ddp_step(loss_fn, optimizer, mesh, *, dp_axis: str = "dp",
                  guard: bool = False):
    """``step(params, batch) -> loss`` (``data_parallel.py:16``): the
    whole tree on every rank, ``batch`` this rank's rows over
    ``dp_axis``, ``loss_fn(params, batch)`` this rank's loss; the
    gradient is the mean over ``dp``.  ``guard=True`` returns ``(loss,
    {"v": [ok, loss, gnorm]})`` and skips a non-finite step (see
    :func:`.tensor_parallel.make_tp_train_step`)."""
    return make_tp_train_step(loss_fn, optimizer, mesh, None,
                              dp_axis=dp_axis, guard=guard)


def ddp_init(params, opt_state, mesh):
    """The tree and optimizer state replicated over the mesh
    (``data_parallel.py:39``): every rank already holds its whole
    value, so both come back as they are."""
    return (mesh_mod.replicate(params, mesh),
            mesh_mod.replicate(opt_state, mesh))
