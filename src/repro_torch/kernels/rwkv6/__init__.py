"""K3: RWKV-6 chunked scan (port of ``repro.kernels.rwkv6``)."""
