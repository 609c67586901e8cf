"""Public wrapper of the RG-LRU scan, dispatched by the tensor's device.  A
CPU tensor takes the plain doubling scan ``rglru_ref``; a CUDA tensor
launches the Hopper kernel or raises — there is no fallback between the two.

Differentiable, as the reference's ``linear_recurrence``: on the card the
kernel runs the forward and the backward recomputes through ``rglru_ref``
under autograd (``kernels/autodiff.py``).
"""
from __future__ import annotations

from repro_torch.kernels.autodiff import kernel_with_ref_vjp
from repro_torch.kernels.rglru.ref import rglru_ref
from repro_torch.kernels.rglru.rglru_scan import rglru_scan

_diff_op = kernel_with_ref_vjp(rglru_scan, rglru_ref)


def linear_recurrence(a, b, *, chunk: int = 64, block_w: int = 128,
                      interpret: bool = True):
    """a, b: (B, S, W).  Returns h with h_t = a_t·h_{t-1} + b_t.

    The signature and its checks are the reference's: ``S`` must be a
    multiple of ``chunk`` and ``W`` of ``min(block_w, W)``.  Both size the
    TPU kernel's tiles and ``interpret`` runs it on a CPU; the Hopper kernel
    picks its own split, so they are otherwise unused."""
    del interpret
    _, S, W = a.shape
    if S % chunk:
        raise ValueError(f"linear_recurrence: sequence {S} is not a multiple of "
                         f"chunk {chunk}")
    if W % min(block_w, W):
        raise ValueError(f"linear_recurrence: width {W} is not a multiple of "
                         f"block_w {min(block_w, W)}")
    if a.device.type == "cpu":
        return rglru_ref(a, b)
    return _diff_op(a, b)


def linear_recurrence_ref(a, b):
    return rglru_ref(a, b)
