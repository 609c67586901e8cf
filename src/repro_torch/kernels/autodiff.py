"""Autograd wrappers making the hand-written kernels trainable (port of
``repro/kernels/autodiff.py``).

Forward runs the kernel; backward recomputes through the plain PyTorch
version under autograd — the flash-attention-style recompute pattern of the
reference, whose Pallas kernels have no backward kernel either.  A fused
backward kernel is later work (ROADMAP B); the recompute gives the plain
version's gradients and keeps the kernel's forward.
"""
from __future__ import annotations

import torch


class _KernelWithRefVjp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel_fn, ref_fn, *args):
        # autograd runs forward with grad mode off: the kernel records nothing
        ctx.ref_fn = ref_fn
        ctx.save_for_backward(*args)
        return kernel_fn(*args)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            args = [a.detach().requires_grad_(n) for a, n in zip(ctx.saved_tensors, need)]
            wrt = [a for a, n in zip(args, need) if n]
            grads = iter(torch.autograd.grad(ctx.ref_fn(*args), wrt, g) if wrt else ())
        return (None, None, *(next(grads) if n else None for n in need))


def kernel_with_ref_vjp(kernel_fn, ref_fn):
    """Differentiable op: ``kernel_fn`` forward, grads through ``ref_fn``.

    Both take the same positional tensor arguments; keyword arguments are
    bound by the caller with ``functools.partial`` before wrapping."""

    def op(*args):
        return _KernelWithRefVjp.apply(kernel_fn, ref_fn, *args)

    return op
