"""rwkv6-1.6b (Finch) [arXiv:2404.05892]: a copy of
``repro.configs.rwkv6_1_6b``.

Attention-free: data-dependent-decay linear recurrence (time-mix) + squared
ReLU channel-mix.  O(1) decode state -> every input shape incl. ``long_500k``.
MAFL aggregation applies unchanged (structure-agnostic) — DESIGN.md
§Arch-applicability.
"""
from repro_torch.configs.base import ArchConfig, register


@register("rwkv6-1.6b")
def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-1.6b",
        family="ssm",
        source="arXiv:2404.05892",
        n_layers=24,
        d_model=2048,
        n_heads=32,            # time-mix heads = d_model / rwkv_head_size
        n_kv_heads=32,
        d_ff=7168,
        vocab_size=65536,
        rwkv_head_size=64,
        notes="attention-free; all four shapes legal",
    )
