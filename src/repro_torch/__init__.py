"""PyTorch/CUDA port of the compute half of ``repro``, for an NVIDIA H100.

It mirrors ``repro``'s module tree and names, imports ``torch`` and never
``jax`` or ``repro``, and keeps its own copies of the framework-free pieces
it needs.  Entry points run on the card unless the caller passes
``device="cpu"``; kernels dispatch by the tensor's device.
"""
