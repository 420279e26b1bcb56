"""Device selection and the float32 numerics the port runs under.

Entry points take ``device=None``, which means the card: the port runs on
the GPU unless the caller asks for the CPU by name.  There is no silent
fallback — a missing GPU raises instead of quietly running on the host.

Numerics, set once here for the whole process:

- ``cudnn.allow_tf32 = False``: cuDNN otherwise runs float32 convolutions in
  TF32 (about three decimal digits), which the reference never does.
- ``cuda.matmul.allow_tf32 = False``: full float32 matrix products (already
  PyTorch's default; stated so nothing depends on it).
- ``cudnn.deterministic = True`` and ``cudnn.benchmark = False``: the same
  convolution algorithm on every run, so two runs of one world on one card
  give the same bits.
"""
from __future__ import annotations

import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a usable GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
