"""The port's Ulysses attention against the JAX package's, on the CPU:
a 4-rank gloo world of the port's workers (``test_torch_mesh_train.py``'s
cluster), each rank on its chunk of the sequence (and its dp rows and tp
heads), against ``nbdistributed_tpu.parallel.ulysses.ulysses_attention``
on 4 virtual CPU devices with the same numpy inputs: the output and
(dq, dk, dv) of ``sum(out * cot)`` gathered whole, within 1e-5, with the
local attention the plain reference or the flash path (the kernels'
plain versions on the CPU); and the refusals, message for message.
"""

import jax
import numpy as np
import pytest
import torch

from nbdistributed_tpu.parallel import mesh as jmesh
from nbdistributed_tpu.parallel import ulysses as julysses
from nbdistributed_tpu_torch.parallel import ulysses as pulysses
from nbdistributed_tpu_torch.parallel.mesh import Mesh
from test_torch_mesh_train import cluster  # noqa: F401
from test_torch_ring import check, inputs, jax_run, port_run

DEVS = jax.devices()[:4]

# (sizes, (B, S, H, Hkv), segments, keywords): both per-shard head counts
# divide the sp axis.
CASES = {
    "causal": ({"sp": 4}, (2, 32, 4, 4), False, {}),
    "noncausal": ({"sp": 4}, (2, 32, 4, 4), False, dict(causal=False)),
    "gqa2": ({"sp": 4}, (1, 32, 8, 4), False, {}),
    "window": ({"sp": 4}, (2, 32, 4, 4), False, dict(window=7)),
    "segments": ({"sp": 4}, (2, 32, 4, 4), True, {}),
    "dp2_sp2": ({"dp": 2, "sp": 2}, (2, 16, 4, 2), True,
                dict(batch_axis="dp")),
    "sp2_tp2": ({"sp": 2, "tp": 2}, (2, 16, 8, 4), True,
                dict(head_axis="tp")),
}


@pytest.mark.integration
@pytest.mark.parametrize("use_flash", [False, True],
                         ids=["reference", "flash"])
@pytest.mark.parametrize("case", list(CASES))
def test_ulysses_matches_jax(cluster, case, use_flash):  # noqa: F811
    sizes, (B, S, H, Hkv), seg, kw = CASES[case]
    A = inputs(B, S, H, Hkv, seg=seg, seed=10 + len(case))
    got = port_run(cluster, A, sizes, "ulysses_attention",
                   use_flash=use_flash, **kw)
    check(got, jax_run(A, sizes, julysses.ulysses_attention,
                       use_flash=False, **kw))


@pytest.mark.parametrize("H,Hkv,kw", [
    (6, 2, {}), (8, 2, {}), (4, 4, dict(window=0)),
    (4, 4, dict(window=3, causal=False))],
    ids=["heads", "kv_heads", "window_zero", "window_noncausal"])
def test_ulysses_refusals_equal_jax(H, Hkv, kw):
    """``ulysses.py:85-95``: JAX's messages, raised before any
    collective (rank 0's view of an sp axis of 4)."""
    S, n = 16, 4
    q = np.zeros((1, S, H, 8), np.float32)
    kv = np.zeros((1, S, Hkv, 8), np.float32)
    with pytest.raises(ValueError) as want:
        julysses.ulysses_attention(
            q, kv, kv, jmesh.make_mesh({"sp": n}, devices=DEVS), **kw)
    tq = torch.zeros((1, S // n, H, 8))
    tkv = torch.zeros((1, S // n, Hkv, 8))
    with pytest.raises(ValueError) as got:
        pulysses.ulysses_attention(tq, tkv, tkv,
                                   Mesh({"sp": n}, {"sp": 0}, {}, {}), **kw)
    assert str(got.value) == str(want.value)
