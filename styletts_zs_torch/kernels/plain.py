"""Calls of the kernels' plain versions with CUDA tensors, by kernel, and
the backward calls that differentiate an op's twin.

On the card every op of ``dispatch`` launches its kernel; a plain version
that sees a CUDA tensor is either a comparison (``chip_smoke.py`` phase 3)
or a route that should not exist.  ``chip_smoke.py`` empties ``cuda_calls``
before each card path and fails unless it is still empty after it.

Where JAX has no backward kernel (full attention, the transposed conv, the
synthesis head, the standalone iSTFT), the op's ``autograd.Function`` takes
the gradient of its twin in ``ops/``, as JAX's custom VJPs do
(``dispatch.py:100-121``, ``:223-244``, ``:264-284``, ``:314-333``);
``twin_vjp`` counts those calls, on any device, in ``twin_vjp_calls``, apart
from ``cuda_calls``.
"""
from __future__ import annotations

import torch

cuda_calls: dict[str, int] = {}
twin_vjp_calls: dict[str, int] = {}


def note(name: str, x: torch.Tensor) -> None:
    """Count a call of ``name``'s plain version if ``x`` lies on the card."""
    if x.is_cuda:
        cuda_calls[name] = cuda_calls.get(name, 0) + 1


def twin_vjp(name: str, fn, inputs, g):
    """The gradients of ``fn(*inputs)`` against the cotangent ``g``: the
    backward of ``name`` through its twin; counted in ``twin_vjp_calls``."""
    twin_vjp_calls[name] = twin_vjp_calls.get(name, 0) + 1
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in inputs]
        out = fn(*xs)
    return torch.autograd.grad(out, xs, g)
