from repro_torch.roofline.analysis import HW, Hardware, model_flops, roofline_terms  # noqa: F401
