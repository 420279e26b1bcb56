"""musicgen-large [arXiv:2306.05284]: a copy of
``repro.configs.musicgen_large``.

Decoder-only transformer over EnCodec tokens (backbone only): the EnCodec
conv codec is a stub (``models/frontends.py``) whose codes arrive as
ordinary token ids.  kv=32 with 32 heads => MHA.  Full attention ->
``long_500k`` skipped.
"""
from repro_torch.configs.base import ArchConfig, register


@register("musicgen-large")
def config() -> ArchConfig:
    return ArchConfig(
        name="musicgen-large",
        family="audio",
        source="arXiv:2306.05284",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=2048,
        frontend="audio",
        n_frontend_tokens=0,   # EnCodec codes arrive as ordinary token ids
        notes="EnCodec frontend stubbed; decoder backbone only",
    )
