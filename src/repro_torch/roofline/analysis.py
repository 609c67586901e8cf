"""Three-term roofline model — a copy of ``repro/roofline/analysis.py`` with
the card's figures as the default :class:`Hardware`.

Hardware constants (one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates):
    peak      989e12 FLOP/s bf16
    hbm_bw    3.35e12 B/s
    hbm_bytes 80e9 B
    link_bw   450e9 B/s (NVLink 4, per direction; nothing reads it on one card)

Terms:
    compute    = FLOPs / peak
    memory     = bytes / hbm_bw
    collective = collective bytes / link_bw

MODEL_FLOPS uses 6·N·D (train) or 2·N·D (inference forward).
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str = "h100-sxm"
    peak_flops: float = 989e12
    hbm_bw: float = 3.35e12
    link_bw: float = 450e9
    hbm_bytes: float = 80e9


HW = Hardware()


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: float, hw: Hardware = HW) -> Dict:
    compute = flops_per_device / hw.peak_flops
    memory = bytes_per_device / hw.hbm_bw
    collective = coll_bytes_per_device / hw.link_bw
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": collective}
    dom = max(terms, key=terms.get)
    bound = max(compute, memory, collective)
    terms.update({
        "dominant": dom.replace("_s", ""),
        "step_time_lb_s": bound,
        # fraction of the bound spent doing useful math = how close the cell
        # sits to its compute roofline
        "roofline_fraction": (compute / bound) if bound > 0 else 0.0,
    })
    return terms


def model_flops(n_params_active: int, tokens: int, kind: str = "train") -> float:
    """6·N·D for train (fwd+bwd), 2·N·D for inference forward."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens
