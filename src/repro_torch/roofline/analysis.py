"""Three-term roofline model of the dry run's records, the counterpart of
``repro.roofline.analysis``:

    compute    = FLOPs_per_device / peak_flops
    memory     = HBM_bytes_per_device / hbm_bw
    collective = collective_bytes_per_device / link_bw

The hardware is one NVIDIA H100 SXM5 80GB at its data sheet's figures
(the full 700 W power limit, dense bf16): 989 TFLOP/s, 80 GB of HBM3 at
3.35 TB/s, NVLink 450 GB/s each way.  These are published peaks, not
measurements: a record built from them is a prediction.  FLOPs and
collective bytes come from the per-device dispatch count
(``dispatch_count``); HBM bytes are reckoned from the step's memory:
every argument read once, outputs written once, temporaries written and
read once (2x), the streaming lower bound of one step.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float          # per device, bf16 dense
    hbm_bw: float              # bytes/s per device
    ici_bw: float              # bytes/s per link, each way
    hbm_bytes: float           # capacity per device


H100 = Hardware(name="nvidia_h100_sxm5_80gb_700w", peak_flops=989e12,
                hbm_bw=3.35e12, ici_bw=450e9, hbm_bytes=80e9)


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float          # 6*N*D (or 6*N_active*D) global
    useful_flops_ratio: float   # model_flops / (flops_per_device * n_chips)
    memory_per_device_bytes: float  # peak residency (fits check)
    fits_hbm: bool
    collective_breakdown: dict
    raw_cost_analysis_flops: float

    def to_dict(self):
        return asdict(self)


def roofline_terms(*, arch: str, shape: str, mesh_name: str, n_chips: int,
                   stats, memory_stats, cost_flops: float,
                   model_flops: float, tokens: int,
                   hw: Hardware = H100) -> RooflineTerms:
    """``stats``: ``dot_flops``, ``collective_bytes`` (by kind) and
    ``total_collective_bytes`` per device; ``memory_stats``: the byte
    fields of ``dispatch_count.MemoryStats``."""
    flops = stats.dot_flops
    coll = stats.total_collective_bytes
    arg_b = memory_stats.argument_size_in_bytes
    out_b = memory_stats.output_size_in_bytes
    tmp_b = memory_stats.temp_size_in_bytes
    alias_b = getattr(memory_stats, "alias_size_in_bytes", 0)
    hbm_traffic = arg_b + out_b + 2.0 * tmp_b
    # outputs written into their arguments' buffers live there
    resident = arg_b + (out_b - alias_b) + tmp_b

    compute_s = flops / hw.peak_flops
    memory_s = hbm_traffic / hw.hbm_bw
    collective_s = coll / hw.ici_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name,
        flops_per_device=flops,
        hbm_bytes_per_device=hbm_traffic,
        collective_bytes_per_device=coll,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_flops_ratio=(model_flops / (flops * n_chips)
                            if flops else 0.0),
        memory_per_device_bytes=resident,
        fits_hbm=resident <= hw.hbm_bytes,
        collective_breakdown=dict(stats.collective_bytes),
        raw_cost_analysis_flops=cost_flops,
    )


def model_flops_estimate(cfg, shape) -> float:
    """6*N*D for training, 2*N*D for inference (N = active params,
    D = tokens processed).  Decode processes global_batch tokens per step."""
    from repro_torch.models.transformer import param_count
    n_active = param_count(cfg, active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch      # one token per sequence
