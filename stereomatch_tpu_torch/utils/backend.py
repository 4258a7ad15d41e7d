"""Backend selection shared by every op that has a CUDA kernel.

Every such op has two implementations: a hand-written CUDA kernel
(``"cuda"``) and its plain PyTorch version (``"torch"``), which is the
kernel's oracle.  The device is never chosen here: it is the device of
the tensor the op was given.  ``"auto"`` takes the kernel for a CUDA
tensor whose shape the kernel serves, and the plain version, on the
same device, for a CPU tensor or a shape the kernel does not serve (a
disparity range or a window past its tiles); an explicit ``"cuda"`` on a
CPU tensor raises, and on a shape the kernel does not serve its launcher
raises, instead of running something else.

Whether a kernel serves a shape is a rule decided before the launch:
each launcher module states its limits as a predicate (``fits``), the
same limits its ``ValueError``s enforce.  No failure to build or launch
a kernel is caught here.
"""

from __future__ import annotations

import torch

_VALID = ("cuda", "torch")


def resolve_backend(backend: str, tensor: torch.Tensor,
                    fits: bool = True) -> str:
    """Resolve ``backend`` for an op whose input is ``tensor``.

    ``fits`` is the kernel's predicate on this call's shape (the launcher
    module's ``fits``).  "auto" gives "cuda" for a CUDA tensor that fits
    and "torch" otherwise; "cuda" on a tensor that is not on a CUDA
    device raises (on one that does not fit, the launcher raises);
    "torch" runs the plain PyTorch version on the tensor's own device.
    """
    if backend == "auto":
        return "cuda" if tensor.is_cuda and fits else "torch"
    if backend not in _VALID:
        raise ValueError(
            f"unknown backend {backend!r}; expected 'auto', 'cuda' or 'torch'")
    if backend == "cuda" and not tensor.is_cuda:
        raise ValueError(
            f"backend='cuda' needs CUDA tensors, got a tensor on "
            f"{tensor.device}")
    return backend
