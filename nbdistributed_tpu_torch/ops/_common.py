"""Shared kernel constants and device policy for the port's ops
(counterpart of ``nbdistributed_tpu/ops/_common.py``)."""

from __future__ import annotations

import torch

NEG_INF = -1e30  # softmax mask value (finite: -inf breaks exp(-inf-m))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the GPU.

    Without CUDA, ``None`` (or an explicit CUDA device) raises instead
    of quietly running on the CPU — the CPU is used only when the
    caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def kernel_route(*tensors) -> str:
    """``"cpu"`` (the plain version) or ``"cuda"`` (the kernel) for a
    wrapper's inputs; anything else raises.  All inputs must agree."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"}:
        return "cuda"
    raise ValueError(f"kernel inputs must all be CPU tensors (plain "
                     f"version) or all CUDA tensors (kernel); got "
                     f"devices {sorted(kinds)}")


def check_contiguous(**tensors) -> None:
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA "
                             f"kernel (call .contiguous() first)")


# dtype codes of the kernels' C interface (ops/csrc/*.cu).
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
