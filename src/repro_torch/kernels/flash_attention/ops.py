"""Public wrapper: model layout (B, S, H, hd), dispatched by the tensor's
device.  A CPU tensor takes the plain version; a CUDA tensor launches the
Hopper kernel or raises — there is no fallback between the two.

Differentiable, as the reference's ``mha``: on the card the kernel runs the
forward and the backward recomputes through ``mha_ref`` under autograd
(``kernels/autodiff.py``); on the CPU autograd runs through ``mha_ref``.

``use_pallas`` on an ArchConfig routes ``models.attention`` through this op.
"""
from __future__ import annotations

import functools

from repro_torch.kernels.autodiff import kernel_with_ref_vjp
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


@functools.lru_cache(maxsize=2)
def _diff_op(causal: bool):
    return kernel_with_ref_vjp(functools.partial(flash_attention, causal=causal),
                               functools.partial(mha_ref, causal=causal))


def mha(q, k, v, *, causal: bool = True, block_q: int = 128,
        block_k: int = 128, interpret: bool = True):
    """q: (B, S, H, hd); k, v: (B, T, K, hd). Returns (B, S, H, hd).

    The signature is the reference's.  ``block_q``/``block_k`` size the TPU
    kernel's VMEM tiles and ``interpret`` runs it on a CPU; the Hopper
    kernel picks its own tiles, so all three are accepted and unused."""
    del block_q, block_k, interpret
    if q.device.type == "cpu":
        return mha_ref(q, k, v, causal=causal)
    return _diff_op(causal)(q, k, v)


def mha_ref(q, k, v, *, causal: bool = True):
    o = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      causal=causal)
    return o.transpose(1, 2)
