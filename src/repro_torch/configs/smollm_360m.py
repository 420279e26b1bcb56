"""smollm-360m [hf:HuggingFaceTB/SmolLM-360M; assignment cites the 135M card].

Llama-arch small dense model — the realistic "on-vehicle" FL client size and
the paper-representative hillclimb target (EXPERIMENTS.md §Perf).
Full attention -> ``long_500k`` skipped.
"""
from repro_torch.configs.base import ArchConfig, register


@register("smollm-360m")
def config() -> ArchConfig:
    return ArchConfig(
        name="smollm-360m",
        family="dense",
        source="hf:HuggingFaceTB/SmolLM-135M (family card)",
        n_layers=32,
        d_model=960,
        n_heads=15,
        n_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab_size=49152,
        rope_theta=1e4,
        tie_embeddings=True,
        notes="FL-client-scale dense model",
    )
