"""deepseek-v2-lite-16b [arXiv:2405.04434]: a copy of
``repro.configs.deepseek_v2_lite_16b``.

MLA (kv_lora_rank=512) + MoE.  The assignment line lists both "MoE 64e top-6"
and "2 shared+160 routed"; the released V2-Lite card is 2 shared + 64 routed
top-6 (160 routed is full V2) — we implement 64 routed and record the
discrepancy in DESIGN.md §Arch-applicability.
First layer dense (first_k_dense_replace=1), dense d_ff=10944, expert d_ff=1408.
"""
from repro_torch.configs.base import ArchConfig, register


@register("deepseek-v2-lite-16b")
def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        source="arXiv:2405.04434",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,
        vocab_size=102400,
        rope_theta=1e4,
        # MLA
        use_mla=True,
        kv_lora_rank=512,
        q_lora_rank=0,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        # MoE
        n_routed_experts=64,
        n_shared_experts=2,
        moe_top_k=6,
        moe_d_ff=1408,
        moe_every=1,
        first_k_dense=1,
        notes="MLA compressed KV cache; absorbed decode via variant(mla_absorb=True)",
    )
