"""Tests of the port that need an NVIDIA Hopper card.  They skip without
one; on the card run them with

    python -m pytest -q -m cuda tests/test_torch_card.py

The file imports neither jax nor repro, so it runs where only PyTorch is
installed."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.weighted_agg import ops, ref
from repro_torch.models.cnn import CNN_SHAPES

# mixing (1 - alpha, 1.0) and literal (beta, weight) scalar pairs
SCALARS = [(1.0 - 0.0734125, 1.0), (0.5, 0.8719), (0.3, 1.7)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    return torch.device("cuda", 0)


def _int_view(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_matches_plain_version_on_card(cuda_device, tdt):
    """The hand kernel against its plain version, bitwise, on the card."""
    kernels.reset_launches()
    shapes = list(CNN_SHAPES.values()) + [(12345,), (77,)]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for shape in shapes:
        for off in (0, 1):                   # aligned and misaligned views
            n = int(np.prod(shape))
            g, l = (torch.randn(n + off, generator=gen, device=cuda_device)
                    .to(tdt)[off:].view(shape) for _ in range(2))
            for beta, weight in SCALARS:
                out = ops.weighted_agg(g, l, beta, weight)
                want = ref.weighted_agg(g, l, beta, weight)
                torch.cuda.synchronize()
                assert torch.equal(_int_view(out), _int_view(want)), (
                    shape, off, beta, weight)
    assert ops.KERNEL.launches == len(shapes) * 2 * len(SCALARS)


@pytest.mark.cuda
def test_kernel_path_runs_or_raises_on_card(cuda_device):
    """On a CUDA tensor the wrapper launches the kernel (counted) and
    rejects a non-contiguous input instead of taking the plain version."""
    kernels.reset_launches()
    g = torch.randn(64, 33, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ops.weighted_agg(g.t(), g.t(), 0.5, 1.0)
    assert ops.KERNEL.launches == 0
    ops.weighted_agg(g, g, 0.5, 1.0)
    assert kernels.launch_counts() == {"weighted_agg": 1}


@pytest.mark.cuda
def test_slice_on_card_uses_the_kernel(cuda_device):
    """quick-k5 on the card: 8 launches (one per CNN leaf) per merge."""
    from repro_torch.core.scenarios import run_scenario
    kernels.reset_launches()
    res = run_scenario("quick-k5", rounds=4, use_kernel=True,
                       device=cuda_device)
    assert ops.KERNEL.launches == 8 * len(res.rounds) == 32
    assert all(v.is_cuda for v in res.final_params.values())
