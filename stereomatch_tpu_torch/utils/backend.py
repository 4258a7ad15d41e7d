"""Backend selection shared by every op that has a CUDA kernel.

Every such op has two implementations: a hand-written CUDA kernel
(``"cuda"``) and its plain PyTorch version (``"torch"``), which is the
kernel's oracle.  The device is never chosen here: it is the device of
the tensor the op was given.  ``"auto"`` takes the kernel for a CUDA
tensor and the plain version for a CPU tensor; an explicit ``"cuda"`` on
a CPU tensor raises instead of running something else.
"""

from __future__ import annotations

import torch

_VALID = ("cuda", "torch")


def resolve_backend(backend: str, tensor: torch.Tensor) -> str:
    """Resolve ``backend`` for an op whose input is ``tensor``.

    "auto" gives "cuda" for a CUDA tensor and "torch" for a CPU tensor;
    "cuda" on a tensor that is not on a CUDA device raises; "torch" runs
    the plain PyTorch version on the tensor's own device.
    """
    if backend == "auto":
        return "cuda" if tensor.is_cuda else "torch"
    if backend not in _VALID:
        raise ValueError(
            f"unknown backend {backend!r}; expected 'auto', 'cuda' or 'torch'")
    if backend == "cuda" and not tensor.is_cuda:
        raise ValueError(
            f"backend='cuda' needs CUDA tensors, got a tensor on "
            f"{tensor.device}")
    return backend
