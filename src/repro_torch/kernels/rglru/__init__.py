"""K2: RG-LRU linear recurrence (port of ``repro.kernels.rglru``)."""
