"""qwen1.5-4b [hf:Qwen/Qwen1.5-4B; the 0.5B card is cited for the family]:
a copy of ``repro.configs.qwen1_5_4b``.

Dense decoder with QKV bias; kv=20 with 20 heads => MHA.  Full attention ->
``long_500k`` skipped.
"""
from repro_torch.configs.base import ArchConfig, register


@register("qwen1.5-4b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-4b",
        family="dense",
        source="hf:Qwen/Qwen1.5-0.5B (family card)",
        n_layers=40,
        d_model=2560,
        n_heads=20,
        n_kv_heads=20,
        head_dim=128,
        d_ff=6912,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1e6,
        notes="QKV bias; MHA",
    )
