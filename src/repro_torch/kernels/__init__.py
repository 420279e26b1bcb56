"""Hand-written Hopper kernels of the port and their launch counts.

``KERNELS`` lists every kernel the port can launch; ``reset_launches``
zeroes their counts, so a run can show which kernels its path went
through.  Importing it registers the kernels' ``meta`` custom ops
(``kernels/meta.py``), which the wrappers call on ``meta`` tensors."""
from repro_torch.kernels import meta  # noqa: F401
from repro_torch.kernels.cross_entropy.ops import KERNEL as CROSS_ENTROPY
from repro_torch.kernels.decode_attention.ops import KERNEL as DECODE_ATTENTION
from repro_torch.kernels.swa_attention.ops import KERNEL as SWA_ATTENTION
from repro_torch.kernels.weighted_agg.ops import KERNEL as WEIGHTED_AGG
from repro_torch.kernels.weighted_agg.ops import RING_KERNEL as RING_AGG

KERNELS = (WEIGHTED_AGG, RING_AGG, DECODE_ATTENTION, SWA_ATTENTION,
           CROSS_ENTROPY)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}
