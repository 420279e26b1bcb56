"""Plain PyTorch cross-entropy (Eq. 1): a transcription of
``repro.kernels.cross_entropy.ref``, and the plain version of K3's two
outputs.

``nll_and_lse`` is the CPU path of
:func:`repro_torch.kernels.cross_entropy.ops.nll_and_lse` and what the
tests and ``chip_smoke.py`` hold the CUDA kernel against."""
from __future__ import annotations

import torch


def cross_entropy(logits, labels):
    """logits [R, V], labels [R] int -> per-row NLL [R] (f32)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def nll_and_lse(logits, labels):
    """logits [R, V], labels [R] int -> (nll, lse), both f32 [R]:
    ``lse = log sum exp(x)`` and ``nll = lse - x[label]``."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    return lse - x.gather(-1, labels.long()[:, None])[:, 0], lse
