"""mistral-nemo-12b [hf:mistralai/Mistral-Nemo-Base-2407]: a copy of
``repro.configs.mistral_nemo_12b``.

Dense GQA decoder, 128k context.  The released model uses full attention; the
``long_500k`` decode shape is only legal under the sliding-window variant
(Mistral-family SWA), ``sliding_window_variant()`` below, whose layers keep
a ring cache of the last ``window`` positions.
"""
from repro_torch.configs.base import ArchConfig, register


@register("mistral-nemo-12b")
def config() -> ArchConfig:
    return ArchConfig(
        name="mistral-nemo-12b",
        family="dense",
        source="hf:mistralai/Mistral-Nemo-Base-2407",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        rope_theta=1e6,
        notes="128k ctx; long_500k via sliding_window_variant()",
    )


def sliding_window_variant(window: int = 4096) -> ArchConfig:
    return config().variant(sliding_window=window,
                            notes="SWA variant for long_500k")
