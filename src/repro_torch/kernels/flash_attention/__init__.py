"""K1: flash attention (port of ``repro.kernels.flash_attention``)."""
