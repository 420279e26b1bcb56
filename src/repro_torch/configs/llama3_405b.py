"""llama3-405b [arXiv:2407.21783]: a copy of ``repro.configs.llama3_405b``.

Dense GQA flagship.  Pure full attention -> ``long_500k`` skipped.  Its bf16
weights alone are ~810 GB, beyond one card (ROADMAP queue 1, item 13).
"""
from repro_torch.configs.base import ArchConfig, register


@register("llama3-405b")
def config() -> ArchConfig:
    return ArchConfig(
        name="llama3-405b",
        family="dense",
        source="arXiv:2407.21783",
        n_layers=126,
        d_model=16384,
        n_heads=128,
        n_kv_heads=8,
        head_dim=128,
        d_ff=53248,
        vocab_size=128256,
        rope_theta=5e5,
        notes="full attention; long_500k skipped per brief",
    )
