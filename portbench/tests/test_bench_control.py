"""The control fails the comparison: the plain reference computed in the
nearest precision below the configuration's (TF32 for float32 with TF32
off) and put in the program's place reads above the cell's limits.

On the card the control runs at each cell's own size (``cuda`` marker; run
there with ``python3 -m pytest -m cuda portbench/tests``).  On the CPU,
which has no TF32, it runs at a tiny size with TF32's rounding of every
product's operands emulated, forward and backward (10 mantissa bits,
round to nearest even)."""
from __future__ import annotations

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from portbench.harness import cell as harness
from portbench.harness import spec

_aten = torch.ops.aten


def tf32(x):
    """``x`` rounded to TF32's 10 mantissa bits, to nearest even."""
    if not (isinstance(x, torch.Tensor) and x.dtype == torch.float32):
        return x
    i = x.contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return r.view(torch.float32).view(x.shape)


class TF32Products(TorchDispatchMode):
    """Rounds the operands of every convolution and matrix product, in the
    forward and the backward, as TF32 tensor cores take them."""
    OPS = {_aten.convolution.default, _aten.convolution_backward.default,
           _aten.mm.default, _aten.addmm.default, _aten.bmm.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.OPS:
            args = tuple(tf32(a) for a in args)
        return func(*args, **kwargs)


@pytest.mark.parametrize("name", ["cnn-tiny", "grid-tiny", "lm-tiny"])
def test_lower_precision_fails_on_the_cpu(tiny_root, one_thread, name):
    cell = spec.load_cell(name, tiny_root)
    ent, ref = spec.entry(cell, tiny_root), spec.reference(cell, tiny_root)
    run = ref.run_world if hasattr(ref, "run_world") else ref.run_episode
    orig = run

    def low(*a, **k):
        with TF32Products():
            return orig(*a, **k)
    if hasattr(ref, "run_world"):
        ref.run_world = low
        beta = cell.traffic.get("betas", [None])[0]
        prog = low(cell.config, cell.traffic["world"], 21,
                   torch.device("cpu"), eval_every=cell.traffic["eval_every"],
                   beta=beta)
        ref.run_world = orig
        numbers = ent.check(cell, [(21, beta, prog)], ref,
                            torch.device("cpu"))
    else:
        prog = low(cell.config, cell.traffic, 21, 21, torch.device("cpu"))
        numbers = ent.check(cell, [(21, 21, prog)], ref, torch.device("cpu"))
    assert harness.over(numbers[0], cell.traffic["limits"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs TF32 products")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cnn-fleet-k100-batched",
                                  "cnn-k100-beta-grid-w15",
                                  "lm-fl-qwen05b-s512"])
def test_control_fails_at_the_cell_size(card, name):
    cell = spec.load_cell(name)
    ent, ref = spec.entry(cell), spec.reference(cell)
    numbers = ent.control(cell, 2**31 + 5, card, ref)
    assert harness.over(numbers[0], cell.traffic["limits"])
