"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E]: a copy of
``repro.configs.llama4_scout_17b_a16e``.

MoE 16 routed (top-1) + 1 shared expert on every layer; iRoPE-style local
chunked attention with one global-attention layer per 4 — which is what makes
``long_500k`` legal for this arch (DESIGN.md §Arch-applicability).
Dense path d_ff=16384, expert d_ff=8192 (assignment's d_ff=8192 is the expert
hidden size; the shared/dense MLP on Scout is 16384).
"""
from repro_torch.configs.base import ArchConfig, register


@register("llama4-scout-17b-a16e")
def config() -> ArchConfig:
    return ArchConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=202048,
        rope_theta=5e5,
        attn_chunk=8192,
        global_attn_every=4,
        n_routed_experts=16,
        n_shared_experts=1,
        moe_top_k=1,
        moe_d_ff=8192,
        moe_every=1,
        scan_period=4,          # chunked,chunked,chunked,global
        notes="early-fusion card; text backbone here, chunked attn => long_500k legal",
    )
