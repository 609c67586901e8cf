"""Public wrapper in the model layout (B, S, H, hd), dispatched by the
tensor's device.  A CPU tensor takes the plain chunked version; a CUDA tensor
launches the Hopper kernel or raises — there is no fallback between the two.

Differentiable, as the reference's ``time_mix_scan``: on the card the kernel
runs the forward and the backward recomputes through the chunked plain
version under autograd (``kernels/autodiff.py``).
"""
from __future__ import annotations

import functools

from repro_torch.kernels.autodiff import kernel_with_ref_vjp
from repro_torch.kernels.rwkv6.ref import rwkv6_chunked, rwkv6_ref
from repro_torch.kernels.rwkv6.rwkv6_scan import rwkv6_scan


@functools.lru_cache(maxsize=16)
def _diff_op(chunk: int):
    return kernel_with_ref_vjp(functools.partial(rwkv6_scan, chunk=chunk),
                               functools.partial(time_mix_chunked, chunk=chunk))


def time_mix_scan(r, k, v, lw, u, *, chunk: int = 32, interpret: bool = True):
    """r, k, v, lw: (B, S, H, hd); u: (H, hd).  Returns y (B, S, H, hd).

    The signature is the reference's; ``interpret`` runs the TPU kernel on a
    CPU there and is accepted and unused here."""
    del interpret
    if r.device.type == "cpu":
        return time_mix_chunked(r, k, v, lw, u, chunk=chunk)
    return _diff_op(chunk)(r, k, v, lw, u)


def _kernel_layout(*ts):
    return [t.transpose(1, 2) for t in ts]


def time_mix_chunked(r, k, v, lw, u, *, chunk: int = 32):
    return rwkv6_chunked(*_kernel_layout(r, k, v, lw), u, chunk=chunk).transpose(1, 2)


def time_mix_ref(r, k, v, lw, u):
    return rwkv6_ref(*_kernel_layout(r, k, v, lw), u).transpose(1, 2)
