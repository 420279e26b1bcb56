"""internvl2-2b [arXiv:2404.16821]: a copy of ``repro.configs.internvl2_2b``.

InternLM2-1.8B language decoder consuming InternViT patch embeddings.  The
ViT and its projector are a stub (``models/frontends.py``): the caller
supplies ``n_frontend_tokens`` patch embeddings of shape (B, 256, d_model),
prepended to the text stream.  Full attention -> ``long_500k`` skipped.
"""
from repro_torch.configs.base import ArchConfig, register


@register("internvl2-2b")
def config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-2b",
        family="vlm",
        source="arXiv:2404.16821",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92553,
        rope_theta=1e6,
        frontend="vision",
        n_frontend_tokens=256,
        notes="InternViT stubbed; decoder = InternLM2-style GQA",
    )
