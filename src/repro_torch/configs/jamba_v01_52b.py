"""jamba-v0.1-52b [arXiv:2403.19887]: a copy of
``repro.configs.jamba_v01_52b``.

Hybrid Mamba+attention, 1 attention layer per 8 (attn at offset 4 of each
period, matching the released interleave), MoE 16e top-2 on every other layer.
SSM layers make ``long_500k`` legal (decode state is O(1) for Mamba layers;
the sparse attention layers pay O(S) per step).
"""
from repro_torch.configs.base import ArchConfig, register


@register("jamba-v0.1-52b")
def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        source="arXiv:2403.19887",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        attn_every=8,
        scan_period=8,
        n_routed_experts=16,
        n_shared_experts=0,
        moe_top_k=2,
        moe_d_ff=14336,
        moe_every=2,
        mamba_d_state=16,
        mamba_d_conv=4,
        mamba_expand=2,
        notes="1:7 attn:mamba interleave; MoE every other layer",
    )
