"""PyTorch/CUDA port of the MAFL simulator (``repro``), for NVIDIA Hopper.

Module paths and names mirror ``repro``'s so each module's counterpart is
easy to find.  The package imports ``torch`` and numpy, never ``jax``, and
nothing of ``repro``.  Entry points run on the GPU unless the caller passes
``device="cpu"``; see :mod:`repro_torch.device`.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
