"""The kernels on ``meta`` tensors: shapes and operation counts, no data.

The dry run (``launch/dryrun.py``) runs whole steps on ``meta`` tensors.
There a wrapper neither launches its kernel (there is no card) nor runs
its plain version (which would count the plain version's products, not
the kernel's work): it calls the custom op below, whose fake kernel gives
the output's shape and dtype, and ``roofline.dispatch_count`` reads the
op's operation count from :data:`FLOPS`.  On a CUDA tensor a wrapper still
launches its kernel or raises; on a CPU tensor it runs its plain version.

The counts are the matrix-product operations each kernel does, as
``2 * m * n * k`` per product:

- K3 ``cross_entropy``: none (a row reduction; ``repro``'s dry run counts
  no dot in its ``log_softmax`` either);
- K4 ``decode_attention``: ``4 * B * H * S * hd``, q against every key of
  the ``S``-slot cache and the weights against every value (the decode
  shapes attend at ``pos = S - 1``);
- K5 ``swa_attention``: ``4 * B * H * hd * sum_i min(i + 1, window)``,
  each query row against the keys its causal window reaches.
"""
from __future__ import annotations

import torch


def _only_meta(name):
    raise RuntimeError(f"repro_torch::{name} runs on meta tensors only: the "
                       "card launches the kernel, the CPU its plain version")


@torch.library.custom_op("repro_torch::cross_entropy", mutates_args=())
def cross_entropy(logits: torch.Tensor,
                  labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    _only_meta("cross_entropy")


@cross_entropy.register_fake
def _(logits, labels):
    R = logits.shape[0]
    return (logits.new_empty((R,), dtype=torch.float32),
            logits.new_empty((R,), dtype=torch.float32))


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def decode_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    _only_meta("decode_attention")


@decode_attention.register_fake
def _(q, k, v):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::swa_attention", mutates_args=())
def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int) -> torch.Tensor:
    _only_meta("swa_attention")


@swa_attention.register_fake
def _(q, k, v, window):
    return torch.empty_like(q)


def _window_keys(S: int, W: int) -> int:
    """sum over i < S of min(i + 1, W)."""
    n = min(S, W)
    return n * (n + 1) // 2 + (S - n) * W


def _decode_flops(q, k, v):
    B, H, hd = q.shape
    return 4 * B * H * k.shape[1] * hd


def _swa_flops(q, k, v, window):
    B, S, H, hd = q.shape
    return 4 * B * H * hd * _window_keys(S, window)


# op -> operation count from its arguments (the dry run's counter)
FLOPS = {
    torch.ops.repro_torch.cross_entropy.default: lambda logits, labels: 0,
    torch.ops.repro_torch.decode_attention.default: _decode_flops,
    torch.ops.repro_torch.swa_attention.default: _swa_flops,
}
