"""Plain PyTorch versions of the RG-LRU linear recurrence (port of
``repro/kernels/rglru/ref.py``), in the model layout (B, S, W).

    h_t = a_t ⊙ h_{t-1} + b_t,    h = 0 before the first step

- :func:`rglru_ref` — the oracle K2 is held against, and what K2's backward
  recomputes through: a log-depth doubling scan over time with the
  reference's ``associative_scan`` combine, ⌈log₂ S⌉ steps of a few whole-
  tensor ops each, so autograd through it stays a dozen ops per call where a
  loop over time would take S eager steps.
- :func:`rglru_sequential` — the plain time loop, a second oracle for tests
  at small S.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rglru_ref(a, b):
    """a, b: (B, S, W) → h (B, S, W) in ``a.dtype``, computed in fp32.

    Step ``o`` (1, 2, 4, …) combines each position with the one ``o``
    before it: ``b[:, o:] += a[:, o:]·b[:, :-o]`` then
    ``a[:, o:] *= a[:, :-o]``, out of place."""
    af, bf = a.float(), b.float()
    S = af.shape[1]
    o = 1
    while o < S:
        bf = bf + F.pad(af[:, o:] * bf[:, :-o], (0, 0, o, 0))
        if 2 * o < S:                        # the last step needs no decay product
            af = af * F.pad(af[:, :-o], (0, 0, o, 0), value=1.0)
        o *= 2
    return bf.to(a.dtype)


def rglru_sequential(a, b):
    """The same recurrence as a loop over time (tests only)."""
    af, bf = a.float(), b.float()
    h = torch.zeros_like(bf[:, 0])
    hs = []
    for t in range(af.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(a.dtype)
